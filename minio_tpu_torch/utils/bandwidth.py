"""Byte pacing: a token bucket and a reader paced through it.

Counterpart of the TokenBucket and PacedReader of
minio_tpu/utils/bandwidth.py, the two pieces the tier transition
worker's per-tier byte pacing uses. Left out: the per-bucket bandwidth
monitor and its admin report, and the bucket's non-blocking probes
(``try_take``, ``peek``) of the admission plane's QoS budgets.
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
            waited = self._bucket.take(len(data))
            if waited > 0 and self._on_wait is not None:
                self._on_wait(waited)
            if self._on_bytes is not None:
                self._on_bytes(len(data))
        return data

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()
