"""Declarative registry of named crash/fault points.

Counterpart of minio_tpu/utils/crashpoint.py, the same registry. Crash-
consistency testing needs process death at NAMED points inside multi-step
commit windows — not random kill -9 storms whose coverage nobody can
enumerate. Every multi-file commit threads a ``crashpoint.hit("<name>")``
call through its window; the names are declared HERE, with their doc and
commit window. Points of windows the port has not ported yet stay
declared, so one registry serves both packages.

Arming is in-process: ``arm(name, nth=, action=)`` installs a callable
fired at the Nth hit — by default it raises :class:`CrashpointAbort`, so
the commit dies mid-window and the test inspects the wreckage; a custom
action may do damage through the ``ctx`` kwargs the hit site passes
(e.g. ``path=``/``data=`` on raw file commits). ``disarm()`` in the
test's finally. ``torn_write_action`` is such an action: it commits a
truncated copy to the final path before aborting. Left out: the
reference's ``MINIO_TPU_CRASHPOINT`` process arming (no port test spawns
a process to kill), ``arm_exit`` and the README table renderer.

``hit()`` is one ``is None`` check when nothing is armed — the hot paths
pay nothing.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

__all__ = [
    "Crashpoint", "CRASHPOINTS", "define", "names", "hit", "arm",
    "disarm", "hits", "torn_write_action", "CrashpointAbort",
]


class CrashpointAbort(Exception):
    """Raised by the default in-process action: the commit dies
    mid-window exactly where a crash would have, but the test process
    survives to inspect the wreckage."""

    def __init__(self, name: str):
        super().__init__(f"crashpoint {name} fired")
        self.name = name


class Crashpoint:
    """One declared point: name, one-line doc, the commit window it
    interrupts."""

    __slots__ = ("name", "doc", "window")

    def __init__(self, name: str, doc: str, window: str):
        self.name = name
        self.doc = doc
        self.window = window


CRASHPOINTS: Dict[str, Crashpoint] = {}


def define(name: str, doc: str, window: str) -> Crashpoint:
    assert name not in CRASHPOINTS, f"crashpoint {name} declared twice"
    cp = Crashpoint(name, doc, window)
    CRASHPOINTS[name] = cp
    return cp


def names() -> List[str]:
    return list(CRASHPOINTS)


# ---------------------------------------------------------------------------
# the registry — grouped by commit window
# ---------------------------------------------------------------------------

_W = "PUT commit (engine._commit)"
define("put.shards.before_meta",
       "after the shard fan-out completes, before the staged xl.meta "
       "write — shards exist in tmp, no metadata anywhere", _W)
define("put.meta.before_rename",
       "after the staged xl.meta lands in tmp, before the rename_data "
       "fan-out — a fully staged but uncommitted write", _W)
define("put.rename.partial",
       "inside the per-disk rename fan-out (one hit per disk; arm "
       ":<nth> to die after n-1 disks committed) — a torn commit "
       "below/at write quorum", _W)

_W = "Drive commit (xl_storage.rename_data)"
define("storage.rename_data.before_meta",
       "on ONE drive, after the data dir moved into place, before "
       "that drive's xl.meta write — an unreferenced data dir the "
       "fsck orphan sweep must reclaim", _W)
define("storage.write_all.commit",
       "inside every raw-file temp-write→rename commit (one hit per "
       "call, arm :<nth>); in-process actions receive path=/data= — "
       "the torn-write injector", _W)

_W = "Multipart (multipart.py)"
define("multipart.part.before_rename",
       "after a part's shards staged in tmp, before the rename into "
       "the session data dir — the session journal never saw the "
       "part", _W)
define("multipart.complete.before_rename",
       "after the final session meta write, before the commit "
       "rename_data fan-out — session intact, object absent", _W)
define("multipart.complete.rename.partial",
       "inside complete's per-disk rename fan-out (one hit per disk, "
       "arm :<nth>)", _W)

_W = "Metacache persist (object/metacache.py)"
define("metacache.persist.segment",
       "after each persisted index segment write (one hit per "
       "segment, arm :<nth>) — segments without a manifest", _W)
define("metacache.persist.before_manifest",
       "after every segment landed, before the manifest write — the "
       "orphan-segment window", _W)
define("metacache.journal.drain",
       "in the journal drainer, before a claimed delta batch applies "
       "— acked writes whose index deltas die with the process", _W)

_W = "Registry epoch writes"
define("topology.save.pool",
       "inside TopologyStore.save's per-pool loop (one hit per pool, "
       "arm :<nth>) — pools disagree on the topology epoch", _W)
define("tier.save.pool",
       "inside TierManager.save's per-pool loop (arm :<nth>) — pools "
       "disagree on the tier-config epoch", _W)
define("replicate.registry.save.pool",
       "inside TargetRegistry.save's per-pool loop (arm :<nth>) — "
       "pools disagree on the replication-target epoch", _W)
define("qos.save.pool",
       "inside QoSRegistry.save's per-pool loop (arm :<nth>) — pools "
       "disagree on the tenant-budget epoch", _W)
define("notify.registry.save.pool",
       "inside NotifyTargetRegistry.save's per-pool loop (arm :<nth>) "
       "— pools disagree on the notification-target epoch", _W)

_W = "Background checkpoints"
define("rebalance.checkpoint",
       "inside the drain's per-pool checkpoint write (arm :<nth>) — "
       "resume must tolerate a stale/torn checkpoint", _W)
define("resync.checkpoint",
       "inside the resync walker's per-pool checkpoint write (arm "
       ":<nth>) — resume must re-cover the un-checkpointed tail", _W)

_W = "Queues and drains"
define("replicate.push.before_apply",
       "in the sync worker, after spooling the source version, before "
       "the target apply — the push must survive as a retry, never a "
       "half-applied replica", _W)
define("mrf.drain.before_heal",
       "in the MRF drainer, after dequeuing an entry, before its heal "
       "runs — a crashed drain loses only retries, never objects", _W)
define("notify.queue.persist",
       "after one event record lands in a target's durable queue, "
       "before its delivery attempt — a restart must redrive exactly "
       "this entry (at-least-once, never lost)", _W)

_W = "Event journal (utils/eventlog.py)"
define("eventlog.persist.segment",
       "in the journal flusher, before a segment's temp-write→rename "
       "commit — a crash here must leave the prior segment set "
       "readable (restart serves the surviving prefix)", _W)

del _W


# ---------------------------------------------------------------------------
# arming + firing
# ---------------------------------------------------------------------------

class _Armed:
    __slots__ = ("name", "nth", "action", "count")

    def __init__(self, name: str, nth: int, action: Callable[..., None]):
        self.name = name
        self.nth = max(int(nth), 1)
        self.action = action
        self.count = 0


_mu = threading.Lock()
_armed: Optional[_Armed] = None


def arm(name: str, nth: int = 1,
        action: Optional[Callable[..., None]] = None) -> None:
    """``action(name, **ctx)`` runs at the Nth hit; None means the
    default: raise CrashpointAbort (the commit dies mid-window, the
    process survives)."""
    global _armed
    if name not in CRASHPOINTS:
        raise KeyError(f"unregistered crashpoint {name!r} — declare it "
                       "in minio_tpu_torch/utils/crashpoint.py")
    with _mu:
        _armed = _Armed(name, nth, action or _raise_abort)


def disarm() -> None:
    global _armed
    with _mu:
        _armed = None


def hits(name: str) -> int:
    """How many times the armed point has been hit (0 when another —
    or no — point is armed)."""
    a = _armed
    if a is None or a.name != name:
        return 0
    return a.count


def _raise_abort(name: str, **ctx) -> None:
    raise CrashpointAbort(name)


def torn_write_action(fraction: float = 0.5) -> Callable[..., None]:
    """An action for hit sites that pass ``path=``/``data=`` context
    (raw file commits): writes a truncated copy straight to the FINAL
    path, then aborts — the torn-file state a power cut mid-commit
    without fsync discipline leaves behind."""
    def act(name: str, **ctx) -> None:
        path, data = ctx.get("path"), ctx.get("data")
        if path is not None and data is not None:
            with open(path, "wb") as f:
                f.write(bytes(data)[: max(int(len(data) * fraction), 1)])
        raise CrashpointAbort(name)
    return act


def hit(name: str, **ctx) -> None:
    """Fire-if-armed. Call this AT the named instruction inside the
    commit window the registry describes. Near-free when disarmed."""
    a = _armed
    if a is None or a.name != name:
        return
    with _mu:
        a.count += 1
        fire = a.count == a.nth
    if fire:
        a.action(name, **ctx)
