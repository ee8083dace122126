"""Background plane: the MRF heal queue.

Counterpart of minio_tpu/object/background.py:71-272. The MRF ("most
recently failed") heal queue (cmd/background-heal-ops.go +
maintainMRFList, cmd/erasure-sets.go:1641): writes that succeeded at
quorum but lost some drives, and reads that had to reconstruct, enqueue
the object for an immediate background heal, so degraded objects regain
full redundancy without waiting for the next scanner sweep.

Left out until the background plane is ported: the disk monitor and
reconnect/new-disk heal, the heal scanner and the data-usage crawler, and
the reference's event-log records and crash points. The lock is a plain
threading.Condition (lockcheck is not ported).

Knobs: MINIO_TPU_MRF_QUEUE_SIZE, MINIO_TPU_MRF_MAX_RETRIES,
MINIO_TPU_MRF_BACKOFF_BASE, MINIO_TPU_MRF_BACKOFF_MAX (the retry schedule
spans ~40 s with the defaults).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, Optional

from ..utils import backoff_delay, knobs
from . import api_errors

MRF_QUEUE_SIZE = knobs.get_int("MINIO_TPU_MRF_QUEUE_SIZE")
MRF_MAX_RETRIES = knobs.get_int("MINIO_TPU_MRF_MAX_RETRIES")
MRF_BACKOFF_BASE = knobs.get_float("MINIO_TPU_MRF_BACKOFF_BASE")
MRF_BACKOFF_MAX = knobs.get_float("MINIO_TPU_MRF_BACKOFF_MAX")


class MRFHealer:
    """Bounded background heal queue with retry + exponential backoff.

    Fed by the engine's degraded-read AND degraded-write hooks: an
    object written (or read) with fewer than N healthy drives enqueues
    `(bucket, object, version)` and a daemon drains entries through
    `heal_fn` immediately — the reference's healMRFRoutine
    (cmd/background-heal-ops.go) rather than waiting for the scanner.

    * entries dedup on (bucket, object, version) while queued/in-flight;
    * a failed heal requeues with capped exponential backoff up to
      `max_retries`, then counts as `failed` (the scanner's sweep is the
      backstop);
    * the queue is bounded: overflow drops the entry (`dropped` stat) —
      losing an MRF hint is safe, losing memory under a fault storm is
      not.
    """

    def __init__(self, heal_fn: Callable[[str, str, str], object],
                 maxsize: Optional[int] = None,
                 max_retries: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_max: Optional[float] = None):
        self.heal_fn = heal_fn
        # None means "env default"; explicit zeros are honored
        # (max_retries=0 = heal once, backoff_base=0 = retry instantly)
        self.maxsize = MRF_QUEUE_SIZE if maxsize is None else maxsize
        self.max_retries = (MRF_MAX_RETRIES if max_retries is None
                            else max_retries)
        self.backoff_base = (MRF_BACKOFF_BASE if backoff_base is None
                             else backoff_base)
        self.backoff_max = (MRF_BACKOFF_MAX if backoff_max is None
                            else backoff_max)
        self._cond = threading.Condition()
        self._heap: list[tuple] = []   # (ready_at, seq, b, o, v, attempt)
        self._seq = 0
        # keys currently queued in the heap (dedup)
        self._pending: set[tuple[str, str, str]] = set()
        # keys whose heal is RUNNING -> re-arm flag: a hint arriving
        # mid-heal (object re-degraded) requeues a fresh entry when the
        # running heal finishes, instead of being silently dropped
        self._inflight: dict[tuple[str, str, str], bool] = {}
        self._closed = False
        # stats (admin `mrf` endpoint / metrics)
        self.queued = 0
        self.healed = 0
        self.requeued = 0
        self.failed = 0
        self.dropped = 0
        self.skipped = 0               # object vanished before heal
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------

    def enqueue(self, bucket: str, object_name: str,
                version_id: str = "") -> bool:
        key = (bucket, object_name, version_id)
        with self._cond:
            if self._closed or key in self._pending:
                return False
            if key in self._inflight:
                # heal already running on possibly-stale state: re-arm
                # so it requeues once finished (the hint is preserved)
                self._inflight[key] = True
                return True
            return self._push(key, 0)

    def _push(self, key: tuple, attempt: int,
              delay: float = 0.0) -> bool:
        """Queue (or requeue) an entry; caller holds the lock."""
        if len(self._heap) >= self.maxsize:
            self.dropped += 1
            return False
        self._pending.add(key)
        self._seq += 1
        heapq.heappush(self._heap, (time.monotonic() + delay, self._seq,
                                    key[0], key[1], key[2], attempt))
        if attempt == 0:
            self.queued += 1
        else:
            self.requeued += 1
        # notify_all: drain() waiters share this condition — waking only
        # the FIFO-head waiter could wake a drainer instead of the
        # consumer loop and leave the new entry sitting unprocessed
        self._cond.notify_all()
        return True

    # -- consumer ----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if not self._heap:
                        self._cond.wait()     # idle: block until notify
                    else:
                        self._cond.wait(max(
                            self._heap[0][0] - time.monotonic(), 0.001))
                if self._closed:
                    return
                _, _, bucket, obj, vid, attempt = heapq.heappop(self._heap)
                key = (bucket, obj, vid)
                self._pending.discard(key)
                self._inflight[key] = False
            done = True
            try:
                res = self.heal_fn(bucket, obj, vid)
                if getattr(res, "missing_after", 0):
                    # partial heal: copies are STILL missing (a target
                    # drive stayed offline) — retry, don't count healed
                    done = self._retry(key, attempt)
                else:
                    with self._cond:
                        self.healed += 1
            except (api_errors.ObjectNotFound, api_errors.BucketNotFound,
                    api_errors.VersionNotFound):
                with self._cond:
                    self.skipped += 1   # deleted since: converged
            except Exception:  # noqa: BLE001 — background heal best-effort
                done = self._retry(key, attempt)
            finally:
                with self._cond:
                    rearm = self._inflight.pop(key, False)
                    if done and rearm and not self._closed:
                        # the object re-degraded while this heal ran:
                        # fresh entry so the new damage is covered
                        self._push(key, 0)
                    self._cond.notify_all()

    def _retry(self, key: tuple, attempt: int) -> bool:
        """Requeue with backoff; True when the entry is finished
        (retries exhausted)."""
        attempt += 1
        if attempt > self.max_retries:
            with self._cond:
                self.failed += 1
            return True
        backoff = backoff_delay(self.backoff_base, self.backoff_max,
                                attempt - 1)
        with self._cond:
            if self._closed:
                return True
            return not self._push(key, attempt, delay=backoff)

    def kick(self) -> int:
        """Make every queued entry ready NOW, collapsing pending retry
        backoffs — called when a drive is re-admitted so its objects
        heal immediately instead of waiting out the fixed retry window
        (DiskMonitor re-admission hook). Returns entries re-armed."""
        with self._cond:
            if not self._heap:
                return 0
            now = time.monotonic()
            self._heap = [(min(ready, now), seq, b, o, v, attempt)
                          for ready, seq, b, o, v, attempt in self._heap]
            heapq.heapify(self._heap)
            self._cond.notify_all()
            return len(self._heap)

    # -- observability / lifecycle ----------------------------------------

    def pending(self) -> int:
        with self._cond:
            return len(self._heap) + len(self._inflight)

    def stats(self) -> dict:
        with self._cond:
            return {"pending": len(self._heap) + len(self._inflight),
                    "queued": self.queued, "healed": self.healed,
                    "requeued": self.requeued, "failed": self.failed,
                    "dropped": self.dropped, "skipped": self.skipped}

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait for every queued entry to finish (healed, skipped, or
        retries exhausted). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._heap or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return not (self._heap or self._inflight)
                self._cond.wait(remaining)
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
