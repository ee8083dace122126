"""Self-tuning operation timeouts (cmd/dynamic-timeouts.go).

A copy of minio_tpu/utils/dyntimeout.py; nothing is left out.

Tracks the recent outcomes of timed operations; when >25% of a window
hit the deadline the timeout grows 25%, when >95% finish in under half
the deadline it shrinks 25%, clamped to [minimum, maximum].
"""

from __future__ import annotations

import threading

WINDOW = 16
GROW = 1.25
SHRINK = 0.75
TOO_SLOW_FRACTION = 0.25
FAST_FRACTION = 0.95


class DynamicTimeout:
    def __init__(self, timeout: float, minimum: float,
                 maximum: float = 0.0):
        self._timeout = timeout
        self.minimum = minimum
        self.maximum = maximum or timeout * 16
        self._mu = threading.Lock()
        self._entries: list[tuple[float, bool]] = []  # (duration, timedout)

    def timeout(self) -> float:
        with self._mu:
            return self._timeout

    def log_success(self, duration: float) -> None:
        self._log(duration, False)

    def log_failure(self) -> None:
        """The operation hit its deadline."""
        self._log(self._timeout, True)

    def _log(self, duration: float, timedout: bool) -> None:
        with self._mu:
            self._entries.append((duration, timedout))
            if len(self._entries) < WINDOW:
                return
            entries, self._entries = self._entries, []
            timeouts = sum(1 for _, t in entries if t)
            fast = sum(1 for d, t in entries
                       if not t and d < self._timeout / 2)
            if timeouts / len(entries) > TOO_SLOW_FRACTION:
                self._timeout = min(self._timeout * GROW, self.maximum)
            elif fast / len(entries) > FAST_FRACTION:
                self._timeout = max(self._timeout * SHRINK, self.minimum)
