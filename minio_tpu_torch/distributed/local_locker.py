"""Local lock table — the per-node NetLocker (cmd/local-locker.go).

Holds lock grants for the resources this node is responsible for: a map
resource -> list of lockRequesterInfo {uid, owner, writer?, timestamp}.
Write locks are exclusive; read locks stack. Stale grants past the
expiry window are swept (the reference's lock-rest-server maintenance
loop, cmd/lock-rest-server.go lockMaintenance).

A copy of minio_tpu/distributed/local_locker.py; nothing is left out.
"""

from __future__ import annotations

import dataclasses
import threading
import time

LOCK_VALIDITY = 120.0      # seconds before an un-refreshed grant is stale


@dataclasses.dataclass
class LockInfo:
    uid: str
    owner: str
    source: str
    writer: bool
    timestamp: float


class LocalLocker:
    """NetLocker implementation backing both in-process dsync and the
    lock RPC server."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._map: dict[str, list[LockInfo]] = {}

    # -- NetLocker verbs ---------------------------------------------------

    def lock(self, uid: str, resources: list[str], owner: str = "",
             source: str = "") -> bool:
        """Exclusive write lock on all resources, all-or-nothing."""
        with self._mu:
            if any(self._map.get(r) for r in resources):
                return False
            now = time.time()
            for r in resources:
                self._map[r] = [LockInfo(uid, owner, source, True, now)]
            return True

    def rlock(self, uid: str, resources: list[str], owner: str = "",
              source: str = "") -> bool:
        """Shared read lock (single resource in practice)."""
        with self._mu:
            for r in resources:
                holders = self._map.get(r)
                if holders and holders[0].writer:
                    return False
            now = time.time()
            for r in resources:
                self._map.setdefault(r, []).append(
                    LockInfo(uid, owner, source, False, now))
            return True

    def unlock(self, uid: str, resources: list[str]) -> bool:
        with self._mu:
            ok = False
            for r in resources:
                holders = self._map.get(r, [])
                kept = [h for h in holders if h.uid != uid]
                if len(kept) != len(holders):
                    ok = True
                if kept:
                    self._map[r] = kept
                else:
                    self._map.pop(r, None)
            return ok

    runlock = unlock

    def force_unlock(self, resources: list[str]) -> bool:
        with self._mu:
            for r in resources:
                self._map.pop(r, None)
            return True

    # -- introspection / maintenance ---------------------------------------

    def dump(self) -> dict[str, list[dict]]:
        """Current grants (admin Top Locks)."""
        with self._mu:
            return {r: [dataclasses.asdict(h) for h in holders]
                    for r, holders in self._map.items()}

    def expire_old_locks(self, validity: float = LOCK_VALIDITY) -> int:
        """Sweep grants older than `validity`; returns count removed."""
        cutoff = time.time() - validity
        removed = 0
        with self._mu:
            for r in list(self._map):
                kept = [h for h in self._map[r] if h.timestamp >= cutoff]
                removed += len(self._map[r]) - len(kept)
                if kept:
                    self._map[r] = kept
                else:
                    self._map.pop(r, None)
        return removed

    def refresh(self, uid: str, resources: list[str]) -> bool:
        """Bump timestamps for a held lock (keeps long ops alive)."""
        now = time.time()
        ok = False
        with self._mu:
            for r in resources:
                for h in self._map.get(r, []):
                    if h.uid == uid:
                        h.timestamp = now
                        ok = True
        return ok
