"""dsync — distributed quorum RW lock (pkg/dsync/drwmutex.go).

A lock over N lockers (one per node) is held when a quorum grants it:
    tolerance = N // 2
    quorum    = N - tolerance   (+1 when N is even and it's a write lock)
Acquisition broadcasts Lock/RLock to all lockers concurrently, waits for
responses, and on sub-quorum releases every partial grant
(drwmutex.go:213-380). Callers retry with jitter until their timeout
(lockBlocking, drwmutex.go:143).

A copy of minio_tpu/distributed/dsync.py: ``DistNSLockMap`` has the
``new_lock`` / ``get_lock`` / ``get_rlock`` / ``unlock`` / ``write_locked`` /
``read_locked`` interface of object/nslock.py, so the engine takes either.
Nothing is left out.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from typing import Optional, Protocol

RETRY_INTERVAL_MAX = 0.25      # jittered sleep between attempts
REFRESH_INTERVAL = 30.0        # LOCK_VALIDITY / 4: keep long holds alive

# Per-broadcast collect window, self-tuning: when lockers answer slowly
# the window grows instead of thrashing retries; when they answer fast
# it shrinks back (the reference runs dsync under a dynamicTimeout,
# cmd/dynamic-timeouts.go + cmd/namespace-lock.go).
from ..utils.dyntimeout import DynamicTimeout  # noqa: E402

ACQUIRE_TIMEOUT_DYN = DynamicTimeout(1.0, 0.25, 15.0)


class NetLocker(Protocol):
    """One node's lock endpoint (pkg/dsync/rpc-client-interface.go:39).
    LocalLocker satisfies this in-process; LockRPCClient over the wire."""

    def lock(self, uid: str, resources: list[str], owner: str,
             source: str) -> bool: ...
    def rlock(self, uid: str, resources: list[str], owner: str,
              source: str) -> bool: ...
    def unlock(self, uid: str, resources: list[str]) -> bool: ...
    def runlock(self, uid: str, resources: list[str]) -> bool: ...
    def refresh(self, uid: str, resources: list[str]) -> bool: ...


def quorum_for(n: int, write: bool) -> int:
    tolerance = n // 2
    q = n - tolerance
    if write and q == tolerance:
        q += 1   # even N: write quorum must exceed half
    return q


class DRWMutex:
    """Distributed RW mutex over a fixed locker list (one resource)."""

    def __init__(self, lockers: list[Optional[NetLocker]],
                 resources: list[str], owner: str = "dsync"):
        self.lockers = lockers
        self.resources = sorted(resources)
        self.owner = owner
        self._uid = ""
        self._write = False
        self._refresh_stop: Optional[threading.Event] = None
        self.lock_lost = False   # set by the refresh loop on quorum loss

    # -- public API (DRWMutex.GetLock / GetRLock / Unlock / RUnlock) -------

    def get_lock(self, timeout: float = 30.0, source: str = "") -> bool:
        return self._lock_blocking(True, timeout, source)

    def get_rlock(self, timeout: float = 30.0, source: str = "") -> bool:
        return self._lock_blocking(False, timeout, source)

    def unlock(self) -> None:
        if self._refresh_stop is not None:
            self._refresh_stop.set()
            self._refresh_stop = None
        self._release_all(self._uid, self._write)
        self._uid = ""

    runlock = unlock

    def check(self) -> bool:
        """One SYNCHRONOUS refresh round: True while a quorum of
        lockers still holds this grant. On quorum loss, `lock_lost`
        latches — the fencing gate a holder returning from a partition
        must consult before touching the protected resource, because
        its lease may have expired and been re-granted while it was
        away. The background refresh loop does the same every
        REFRESH_INTERVAL; this is the on-demand edition for
        commit-time fencing and tests."""
        if not self._uid or self.lock_lost:
            return False
        alive = 0
        for lk in self.lockers:
            if lk is None:
                continue
            try:
                if lk.refresh(self._uid, self.resources):
                    alive += 1
            except Exception:  # noqa: BLE001 — dead locker: no vote
                pass
        if alive < quorum_for(len(self.lockers), self._write):
            self.lock_lost = True
        return not self.lock_lost

    # -- internals ---------------------------------------------------------

    def _lock_blocking(self, write: bool, timeout: float,
                       source: str) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            # fresh uid per attempt: a straggler grant from a failed
            # attempt must never alias a later attempt's grant on the
            # same locker (its rollback would release both)
            uid = str(uuid.uuid4())
            if self._try_once(uid, write, source):
                self._uid, self._write = uid, write
                self._start_refresh(uid)
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(random.random() * RETRY_INTERVAL_MAX)

    def _start_refresh(self, uid: str) -> None:
        """Keep the held lock alive on every locker: a grant not refreshed
        within LOCK_VALIDITY is swept by the lockers' maintenance loop.
        When a quorum of lockers no longer knows the grant (force-unlock,
        partition-long sweep), stop refreshing and flag the lock as lost
        so the holder can abort its critical section (the reference's
        startContinousLockRefresh cancels the op context on quorum
        loss)."""
        stop = threading.Event()
        self._refresh_stop = stop
        self.lock_lost = False

        def run() -> None:
            n = len(self.lockers)
            while not stop.wait(REFRESH_INTERVAL):
                alive = 0
                for lk in self.lockers:
                    if lk is None:
                        continue
                    try:
                        if lk.refresh(uid, self.resources):
                            alive += 1
                    except Exception:  # noqa: BLE001 — dead locker: no vote
                        pass
                if alive < quorum_for(n, self._write):
                    self.lock_lost = True
                    return

        threading.Thread(target=run, daemon=True).start()

    def _try_once(self, uid: str, write: bool, source: str) -> bool:
        n = len(self.lockers)
        need = quorum_for(n, write)
        granted: list[Optional[bool]] = [None] * n
        aborted = threading.Event()
        pending = threading.Semaphore(0)

        def ask(i: int, lk: NetLocker) -> None:
            try:
                if write:
                    ok = lk.lock(uid, self.resources, self.owner, source)
                else:
                    ok = lk.rlock(uid, self.resources, self.owner, source)
            except Exception:  # noqa: BLE001 — a dead locker is a no-vote
                ok = False
            granted[i] = ok
            pending.release()
            # Straggler grant after the attempt already failed: the main
            # thread's rollback may have run before this grant landed, so
            # undo it here — otherwise it orphans the resource for up to
            # LOCK_VALIDITY.
            if ok and aborted.is_set():
                try:
                    if write:
                        lk.unlock(uid, self.resources)
                    else:
                        lk.runlock(uid, self.resources)
                except Exception:  # noqa: BLE001 — expiry sweep will reap it
                    pass

        live = 0
        for i, lk in enumerate(self.lockers):
            if lk is None:
                granted[i] = False
                pending.release()
                continue
            live += 1
            threading.Thread(target=ask, args=(i, lk), daemon=True).start()

        # collect answers up to the acquire window; stop early once the
        # outcome is decided either way
        window = ACQUIRE_TIMEOUT_DYN.timeout()
        t0 = time.monotonic()
        deadline = t0 + window
        answers = 0
        timed_out = False
        while answers < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                timed_out = True
                break
            if not pending.acquire(timeout=remaining):
                timed_out = True
                break
            answers += 1
            yes = sum(1 for g in granted if g)
            no = sum(1 for g in granted if g is False)
            if yes >= need or no > n - need:
                break
        if timed_out and answers < n:
            ACQUIRE_TIMEOUT_DYN.log_failure()
        else:
            ACQUIRE_TIMEOUT_DYN.log_success(time.monotonic() - t0)

        if sum(1 for g in granted if g) >= need:
            return True
        # sub-quorum: roll back whatever was granted; in-flight grant
        # threads see `aborted` and undo their own late grants
        aborted.set()
        self._release_all(uid, write)
        return False

    def _release_all(self, uid: str, write: bool) -> None:
        if not uid:
            return
        for lk in self.lockers:
            if lk is None:
                continue
            try:
                if write:
                    lk.unlock(uid, self.resources)
                else:
                    lk.runlock(uid, self.resources)
            except Exception:  # noqa: BLE001 — expiry sweep will reap it
                pass


class DistNSLockMap:
    """Distributed drop-in for object.nslock.NSLockMap: new_lock returns
    an RWLocker backed by DRWMutex over the cluster's lockers
    (cmd/namespace-lock.go distLockInstance)."""

    def __init__(self, lockers: list[Optional[NetLocker]],
                 owner: str = ""):
        self.lockers = lockers
        self.owner = owner or str(uuid.uuid4())

    def new_lock(self, *paths: str) -> "DistNSLock":
        return DistNSLock(DRWMutex(self.lockers,
                                   [p for p in paths if p], self.owner))


class DistNSLock:
    def __init__(self, dm: DRWMutex):
        self._dm = dm

    def get_lock(self, timeout: float = 30.0) -> bool:
        return self._dm.get_lock(timeout)

    def get_rlock(self, timeout: float = 30.0) -> bool:
        return self._dm.get_rlock(timeout)

    def unlock(self) -> None:
        self._dm.unlock()

    runlock = unlock

    def write_locked(self, timeout: float = 30.0):
        return _DistLockCtx(self, True, timeout)

    def read_locked(self, timeout: float = 30.0):
        return _DistLockCtx(self, False, timeout)


class _DistLockCtx:
    def __init__(self, lock: DistNSLock, write: bool, timeout: float):
        self._lock, self._write, self._timeout = lock, write, timeout

    def __enter__(self):
        ok = (self._lock.get_lock(self._timeout) if self._write
              else self._lock.get_rlock(self._timeout))
        if not ok:
            from ..object import api_errors
            raise api_errors.ObjectApiError(
                "distributed lock acquisition timed out")
        return self._lock

    def __exit__(self, *exc):
        self._lock.unlock()
        return False
