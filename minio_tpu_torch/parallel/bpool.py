"""Bounded byte-buffer pool (reference pkg/bpool.BytePoolCap, fed to the
erasure encoder at cmd/erasure-sets.go:374).

Counterpart of minio_tpu/parallel/bpool.py. PUT streams stage each block
batch in a same-width buffer; pooling them caps allocation churn and puts
a hard bound on staging memory. get() blocks when the pool is exhausted:
that back-pressure is the admission control for raw block memory
(`waits` counts gets that had to block, `exhausted` gets that timed out).

On a pool for a CUDA engine every buffer is a pinned (page-locked) host
tensor, handed out as its uint8 numpy view: the PUT reads the object
straight into it and the codec copies it to the card asynchronously,
with no pageable bounce. A buffer must not be refilled while such a copy
still reads it, so the codec records an event after the copy
(`after_copy`) and `put()` waits on it before the buffer re-enters the
ring. On a CPU engine the buffers are ordinary memory.
"""

from __future__ import annotations

import queue
from typing import Optional

import numpy as np
import torch

from ..utils import lockcheck


class BytePoolExhausted(Exception):
    """get() timed out: every buffer is checked out and none returned
    within the deadline — the pipeline is stalled or the pool is
    undersized for the live stream count."""


# host address -> CUDA event recorded after an asynchronous copy that
# reads the memory there (see after_copy)
_copies: dict[int, object] = {}
_copies_mu = lockcheck.mutex("bpool.copies")


def _addr(arr: np.ndarray) -> int:
    return arr.__array_interface__["data"][0]


def after_copy(arr: np.ndarray, event) -> None:
    """Note that an asynchronous copy reads `arr` until `event` has
    completed: the pool buffer holding it is not recycled before."""
    with _copies_mu:
        _copies[_addr(arr)] = event


def _wait_copies(buf: np.ndarray) -> int:
    """Wait for every noted copy out of `buf`; returns how many."""
    lo = _addr(buf)
    hi = lo + buf.nbytes
    with _copies_mu:
        hits = [a for a in _copies if lo <= a < hi]
        events = [_copies.pop(a) for a in hits]
    for ev in events:
        ev.synchronize()
    return len(events)


class BytePool:
    def __init__(self, width: int, capacity: int, pinned: bool = False):
        self.width = width
        self.capacity = capacity
        self.pinned = pinned
        self.waits = 0          # get() calls that had to block
        self.exhausted = 0      # get() calls that timed out
        self._mu = lockcheck.mutex("bpool.created")
        self._created = 0       # buffers allocated so far (<= capacity)
        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=capacity)

    def _alloc(self) -> np.ndarray:
        if self.pinned:
            return torch.empty(self.width, dtype=torch.uint8,
                               pin_memory=True).numpy()
        return np.empty(self.width, dtype=np.uint8)

    def get(self, timeout: Optional[float] = None) -> np.ndarray:
        """A pooled buffer (uint8, `width` bytes); allocated lazily up to
        `capacity`, then blocks (up to `timeout` seconds, forever when
        None) while all buffers are checked out. Raises
        BytePoolExhausted on timeout. Its contents are undefined."""
        try:
            return self._q.get_nowait()
        except queue.Empty:
            pass
        with self._mu:
            grow = self._created < self.capacity
            if grow:
                self._created += 1
            else:
                self.waits += 1
        if grow:
            return self._alloc()
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            with self._mu:
                self.exhausted += 1
            raise BytePoolExhausted(
                f"no {self.width}-byte staging buffer freed within "
                f"{timeout}s (capacity {self.capacity})") from None

    def put(self, buf: np.ndarray) -> None:
        """Return a buffer; waits first for any noted copy out of it."""
        if len(buf) != self.width:
            # a foreign-width buffer returned here would poison a later
            # get() with a wrong-geometry staging buffer: caller bug
            raise ValueError(
                f"foreign buffer: width {len(buf)} != pool {self.width}")
        _wait_copies(buf)
        try:
            self._q.put_nowait(buf)
        except queue.Full:
            pass
