"""NaughtyTarget: deterministic fault injection for event delivery.

Wraps a live sender (``registry.set_sender(arn, NaughtyTarget(...))``)
and fails sends by PLAN, not by clock — the chaos matrix replays
bit-identically:

* ``fail_first=n``       — the first n sends raise (a 503 storm);
* ``offline_every=(k,m)``— every k-th send opens an m-send offline
  window (raises for the next m attempts);
* ``die_after_send=n``   — the n-th send DELIVERS, then raises
  (mid-POST death after the body landed: the retry re-sends and the
  consumer sees a duplicate — at-least-once, never lost).
"""

from __future__ import annotations

import threading


class NaughtyTargetError(ConnectionError):
    """The injected delivery failure."""


class NaughtyTarget:
    def __init__(self, inner, fail_first: int = 0,
                 offline_every: tuple[int, int] = (0, 0),
                 die_after_send: int = 0):
        self.inner = inner
        self.arn = getattr(inner, "arn", "")
        self.fail_first = fail_first
        self.offline_every = offline_every
        self.die_after_send = die_after_send
        self._mu = threading.Lock()
        self.attempts = 0
        self.delivered = 0
        self.failures = 0
        self._offline_left = 0

    def send(self, record: dict) -> None:
        with self._mu:
            self.attempts += 1
            attempt = self.attempts
            if attempt <= self.fail_first:
                self.failures += 1
                raise NaughtyTargetError(
                    f"injected 503 ({attempt}/{self.fail_first})")
            if self._offline_left > 0:
                self._offline_left -= 1
                self.failures += 1
                raise NaughtyTargetError("injected offline window")
            every, span = self.offline_every
            if every > 0 and attempt % every == 0:
                self._offline_left = span
            die = (self.die_after_send > 0
                   and attempt == self.die_after_send)
        self.inner.send(record)
        with self._mu:
            self.delivered += 1
        if die:
            # the body landed but the ack never arrived — the caller
            # must retry and the consumer must tolerate the duplicate
            raise NaughtyTargetError("injected mid-POST death "
                                     "(delivered, ack lost)")
