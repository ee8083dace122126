"""Byte pacing: a token bucket and a reader paced through it.

Counterpart of the TokenBucket and PacedReader of
minio_tpu/utils/bandwidth.py: the tier transition worker's per-tier byte
pacing and the QoS plane's tenant budgets (s3/qos.py), with the bucket's
non-blocking probes (``try_take``, ``peek``) that the admission gate
refuses with. ``PacedReader.readinto`` is a port addition: the PUT loop
reads a paced body straight into its pinned staging ring through it
(object/hash_reader.py ``readinto_full``), charged as ``read()`` charges.
Left out: the per-bucket bandwidth monitor and its admin report.
"""

from __future__ import annotations

import threading
import time


class TokenBucket:
    """Thread-safe token bucket: `take(n)` blocks until `n` bytes of
    budget are available, refilled at `rate_bps` with `burst_s` seconds
    of burst. `rate_bps <= 0` means unlimited (take never blocks)."""

    def __init__(self, rate_bps: float, burst_s: float = 1.0):
        self.rate = float(rate_bps)
        self.burst = max(self.rate * burst_s, 1.0)
        self._mu = threading.Lock()
        self._tokens = self.burst
        self._last = time.monotonic()

    def set_rate(self, rate_bps: float, burst_s: float = 1.0) -> None:
        with self._mu:
            self.rate = float(rate_bps)
            self.burst = max(self.rate * burst_s, 1.0)
            self._tokens = min(self._tokens, self.burst)

    def take(self, n: int) -> float:
        """Block until `n` tokens were consumed; returns the seconds
        slept (0.0 when the budget was there at once)."""
        # grant in installments of at most one burst: a chunk larger than
        # the burst paces across refills instead of waiting for a level
        # the cap never reaches
        remaining = n
        waited = 0.0
        while remaining > 0:
            with self._mu:
                if self.rate <= 0:
                    return waited
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last)
                    * self.rate)
                self._last = now
                want = min(remaining, self.burst)
                if self._tokens >= want:
                    self._tokens -= want
                    remaining -= want
                    continue
                wait = (want - self._tokens) / self.rate
            wait = min(wait, 1.0)
            time.sleep(wait)
            waited += wait
        return waited

    def _refill_locked(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: int) -> float:
        """Non-blocking take: consume one burst-capped installment of `n`
        tokens if available now and return 0.0; otherwise consume nothing
        and return the seconds until that installment accrues (the
        Retry-After hint). Only the admission gate and the QoS plane
        call it."""
        if n <= 0:
            return 0.0
        with self._mu:
            if self.rate <= 0:
                return 0.0
            self._refill_locked()
            want = min(n, self.burst)
            if self._tokens >= want:
                self._tokens -= want
                return 0.0
            return (want - self._tokens) / self.rate

    def peek(self, n: int) -> float:
        """Like try_take but consumes nothing either way: 0.0 when one
        burst-capped installment of `n` is available now, else the
        seconds until it accrues. Admission refuses a payload whose byte
        budget is exhausted without double-charging the pacer that meters
        the admitted bytes."""
        if n <= 0:
            return 0.0
        with self._mu:
            if self.rate <= 0:
                return 0.0
            self._refill_locked()
            want = min(n, self.burst)
            if self._tokens >= want:
                return 0.0
            return (want - self._tokens) / self.rate

    def paced(self, stream, on_bytes=None, on_wait=None):
        """Wrap a chunk iterator: each chunk waits for budget before it
        flows; `on_bytes(n)` observes the paced bytes, `on_wait(seconds)`
        the throttle stalls."""
        def gen():
            for chunk in stream:
                waited = self.take(len(chunk))
                if waited > 0 and on_wait is not None:
                    on_wait(waited)
                if on_bytes is not None:
                    on_bytes(len(chunk))
                yield chunk
        return gen()


class PacedReader:
    """File-like wrapper pacing ``read()`` through a TokenBucket: bytes
    are paid for as they are delivered; ``on_bytes(n)`` observes them and
    ``on_wait(seconds)`` the stalls."""

    __slots__ = ("_inner", "_bucket", "_on_bytes", "_on_wait")

    def __init__(self, inner, bucket: TokenBucket,
                 on_bytes=None, on_wait=None):
        self._inner = inner
        self._bucket = bucket
        self._on_bytes = on_bytes
        self._on_wait = on_wait

    def read(self, n: int = -1) -> bytes:
        data = self._inner.read(n)
        if data:
            self._charge(len(data))
        return data

    def readinto(self, b) -> int:
        """Fill the caller's buffer from the inner stream (its own
        ``readinto`` where it has one, else one ``read`` and a copy), then
        pay for the bytes delivered, as ``read`` does."""
        inner = getattr(self._inner, "readinto", None)
        if inner is not None:
            n = inner(b) or 0
        else:
            data = self._inner.read(len(b))
            n = len(data)
            memoryview(b)[:n] = data
        if n:
            self._charge(n)
        return n

    def _charge(self, n: int) -> None:
        waited = self._bucket.take(n)
        if waited > 0 and self._on_wait is not None:
            self._on_wait(waited)
        if self._on_bytes is not None:
            self._on_bytes(n)

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()
