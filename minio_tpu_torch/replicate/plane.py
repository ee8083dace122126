"""The active-active replication plane: bidirectional site sync.
Counterpart of minio_tpu/replicate/plane.py. Nothing here is a device
program: the plane's work on the card is the GETs it pushes from (a
degraded read decodes there) and the replica writes it causes at the
target (each encodes there).

One listener on the engines' namespace-change feed (wired by
``ErasureServerSets.attach_replication`` — the lint gate's
hook-coverage rule proves every mutation verb reaches this queue), a
bounded dedup queue of ``(bucket, key)`` sync tasks, and a worker pool
that CONVERGES each touched key against every registered target:

  * **push** — every local version the target lacks replays with full
    fidelity (multipart part boundaries, delete markers, transitioned
    stubs as metadata) carrying its ORIGIN site id in version
    metadata;
  * **loop suppression** — a version that originated AT the target is
    never pushed back (the replica-origin marker, so an A→B replica
    write at B re-fires B's feed but syncs to A as a no-op: no
    ping-pong, proven by a flat replica-write counter);
  * **conflict resolution** — deterministic: the higher
    ``(mod_time, version_id)`` wins the unversioned slot, applied
    identically at push AND apply side, so two sites that saw
    concurrent writes converge to identical listings;
  * **prune** — replicas of THIS site's versions that no longer exist
    here are deleted at the target (versioned deletes and bulk deletes
    converge without per-operation plumbing);
  * failed syncs feed an MRF-style retry queue (the fault plane's
    ``MRFHealer`` with the replication sync as its heal fn) with
    capped exponential backoff — a 503 storm or target-offline window
    drains clean on recovery;
  * pushes throttle off the shared foreground-pressure probe and pace
    through per-target token-bucket bandwidth budgets
    (``utils/bandwidth.py``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ..object import api_errors
from ..object.background import MRFHealer
from ..object.engine import GetOptions
from ..object.faithful import spec_of
from ..utils import crashpoint, knobs, telemetry
from ..utils.bandwidth import TokenBucket
from ..utils.pressure import ForegroundPressure
from .client import (ReplClientError, ReplTargetClient,
                     unversioned_conflict_keep)
from .targets import (REPL_ORIGIN_KEY, SiteTarget, TargetRegistry,
                      origin_of)

WORKERS = knobs.get_int("MINIO_TPU_REPL_WORKERS")
QUEUE_SIZE = knobs.get_int("MINIO_TPU_REPL_QUEUE")
BACKOFF_S = knobs.get_float("MINIO_TPU_REPL_BACKOFF_S")
BACKOFF_MAX_S = knobs.get_float("MINIO_TPU_REPL_BACKOFF_MAX_S")
BACKOFF_TRIES = knobs.get_int("MINIO_TPU_REPL_BACKOFF_TRIES")

_LAG_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 300)


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_repl_synced_total",
                    "Object versions pushed to replication targets"),
        reg.counter("minio_tpu_repl_failed_total",
                    "Key syncs that failed (fed to the replication "
                    "MRF queue, retried with backoff)"),
        reg.counter("minio_tpu_repl_pruned_total",
                    "Replica versions deleted at targets after their "
                    "origin version was removed here"),
        reg.histogram("minio_tpu_repl_lag_seconds",
                      "Replication lag: push completion minus the "
                      "version's mod time", buckets=_LAG_BUCKETS),
    )


class ReplicationPlane:
    """One site's replication engine (queue + workers + retry)."""

    def __init__(self, object_layer, registry: TargetRegistry,
                 bucket_meta=None,
                 workers: Optional[int] = None,
                 queue_size: Optional[int] = None,
                 busy_fn=None, throttle_s: Optional[float] = None):
        self.obj = object_layer
        self.registry = registry
        # optional bucket metadata system: when present AND a bucket
        # carries a replication XML config, its rules gate which keys
        # replicate (the legacy per-bucket surface); registry targets
        # alone replicate everything under their prefix
        self.bucket_meta = bucket_meta
        self._pressure = ForegroundPressure(object_layer, busy_fn=busy_fn)
        self._throttle_base = BACKOFF_S if throttle_s is None \
            else throttle_s
        self.queue_size = QUEUE_SIZE if queue_size is None else queue_size
        self._cond = threading.Condition()
        self._queue: deque = deque()    # (bucket, key, enqueued_at)
        self._pending: set[tuple[str, str]] = set()
        self._inflight = 0
        # per-target admin surface (ROADMAP item 4 remainder): queue
        # depth + oldest-pending age are derived from the live queue on
        # demand; synced/failed/last-sync/last-lag update as workers
        # push — the JSON twin of minio_tpu_repl_lag_seconds{target}
        self._target_stats: dict[str, dict] = {}
        self._stop = threading.Event()
        self._buckets: dict[str, TokenBucket] = {}
        # optional BandwidthMonitor: the port has none yet (it comes
        # with the admin bandwidth route), so the boot leaves this None
        # and no egress is recorded per bucket
        self.bandwidth = None
        # stats (admin surface / tests)
        self.queued = 0
        self.synced = 0
        self.skipped = 0
        self.failed_syncs = 0
        self.pruned = 0
        self.dropped = 0
        # failed target syncs retry here with capped exponential
        # backoff — the fault plane's queue, the replication sync as
        # its heal fn (the version slot carries the target ARN)
        self.mrf = MRFHealer(heal_fn=self._mrf_retry)
        self._resyncer = None
        self._threads = []
        for i in range(WORKERS if workers is None else workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"repl-sync-{i}")
            t.start()
            self._threads.append(t)

    # -- admin/metrics compat (the legacy pool's counter names) ---------

    @property
    def replicated(self) -> int:
        return self.synced

    @property
    def failed(self) -> int:
        return self.failed_syncs

    @property
    def targets(self) -> dict:
        return self.registry.targets

    def mount_target_entry(self, entry: dict) -> str:
        return self.registry.mount_target_entry(entry)

    def remove_target(self, arn: str) -> None:
        self.registry.remove(arn)

    # -- the namespace-feed listener ------------------------------------

    def on_namespace_change(self, bucket: str, key: str) -> None:
        """Enqueue one key sync; never blocks (bounded queue, overflow
        drops + counts — the resync verb is the backstop)."""
        if bucket.startswith(".") or not key:
            return
        if not self.registry.for_bucket(bucket):
            return
        with self._cond:
            if self._stop.is_set() or (bucket, key) in self._pending:
                return
            if len(self._queue) >= self.queue_size:
                self.dropped += 1
                return
            self._pending.add((bucket, key))
            self._queue.append((bucket, key, time.time()))
            self.queued += 1
            self._cond.notify_all()

    # -- lifecycle / observability --------------------------------------

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._resyncer is not None:
            self._resyncer.stop()
        self.mrf.close()

    def stats(self) -> dict:
        with self._cond:
            out = {"pending": len(self._queue) + self._inflight,
                   "queued": self.queued, "synced": self.synced,
                   "skipped": self.skipped, "failed": self.failed_syncs,
                   "pruned": self.pruned, "dropped": self.dropped}
        out["retry"] = self.mrf.stats()
        return out

    def _target_entry(self, arn: str) -> dict:
        # caller holds self._cond
        entry = self._target_stats.get(arn)
        if entry is None:
            entry = self._target_stats[arn] = {
                "synced": 0, "failed": 0,
                "last_sync": 0.0, "last_lag_s": None}
        return entry

    def target_status(self) -> dict:
        """Per-target replication health for the admin plane: live
        queue depth + oldest-pending age (matching keys still waiting
        in the sync queue), last successful push timestamp, last
        observed lag, cumulative synced/failed. The histogram twin is
        ``minio_tpu_repl_lag_seconds{target}``."""
        now = time.time()
        with self._cond:
            queue_snapshot = list(self._queue)
            entries = {arn: dict(st)
                       for arn, st in self._target_stats.items()}
        out: dict = {}
        for target in list(self.registry.targets.values()):
            st = entries.get(target.arn) or {
                "synced": 0, "failed": 0,
                "last_sync": 0.0, "last_lag_s": None}
            matching = [t for b, k, t in queue_snapshot
                        if b == target.bucket and target.matches(k)]
            st["queue_depth"] = len(matching)
            st["oldest_pending_s"] = round(now - min(matching), 3) \
                if matching else 0.0
            st["bucket"] = target.bucket
            out[target.arn] = st
        return out

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until the sync queue AND the retry queue are empty.
        Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return not (self._queue or self._inflight)
                self._cond.wait(remaining)
        return self.mrf.drain(max(deadline - time.monotonic(), 0.001))

    # -- resync management ----------------------------------------------

    def start_resync(self, arn: str, **kw):
        """Seed (or re-seed) one target from the namespace feed with
        checkpointed resume — see replicate/resync.py."""
        from .resync import Resyncer
        if self._resyncer is not None and self._resyncer.running():
            raise ReplClientError(
                f"a resync of {self._resyncer.arn} is already running")
        self.registry.get(arn)          # must exist
        self._resyncer = Resyncer(self.obj, self.registry, arn,
                                  plane=self, **kw)
        self._resyncer.start()
        return self._resyncer

    def resync_status(self) -> Optional[dict]:
        if self._resyncer is None:
            return None
        return self._resyncer.status()

    def cancel_resync(self) -> bool:
        if self._resyncer is None:
            return False
        return self._resyncer.stop()

    # -- workers ---------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stop.is_set() and not self._queue:
                    self._cond.wait()
                if self._stop.is_set():
                    return
                bucket, key, _enq = self._queue.popleft()
                self._pending.discard((bucket, key))
                self._inflight += 1
            try:
                self._pressure.throttle(self._stop, self._throttle_base,
                                        BACKOFF_MAX_S, BACKOFF_TRIES)
                if not self._stop.is_set():
                    self._sync_key_targets(bucket, key)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _sync_key_targets(self, bucket: str, key: str) -> None:
        _synced_c, failed_c, _pruned_c, _lag_h = _metrics()
        for target in self.registry.for_bucket(bucket):
            if not target.matches(key) or \
                    not self._rules_allow(bucket, key, target):
                continue
            with telemetry.trace("replicate.sync", bucket=bucket,
                                 object=key, target=target.arn):
                try:
                    self.sync_key(bucket, key, target)
                except Exception:  # noqa: BLE001 — per-target isolation;
                    # the retry queue re-drives with backoff
                    with self._cond:
                        self.failed_syncs += 1
                        self._target_entry(target.arn)["failed"] += 1
                    failed_c.inc()
                    self.mrf.enqueue(bucket, key, target.arn)

    def _mrf_retry(self, bucket: str, key: str, arn: str) -> None:
        """The retry queue's heal fn: re-sync one (key, target); an
        exception requeues with backoff, MRF-style."""
        try:
            target = self.registry.get(arn)
        except api_errors.ObjectApiError:
            return                      # target removed: converged
        self.sync_key(bucket, key, target)

    def _rules_allow(self, bucket: str, key: str,
                     target: SiteTarget) -> bool:
        """Legacy per-bucket replication XML, when present, gates keys
        (rule prefix must match); buckets without a config replicate
        everything the target's own prefix admits."""
        if self.bucket_meta is None:
            return True
        try:
            xml = self.bucket_meta.get(bucket).replication_xml
        except Exception:  # noqa: BLE001 — meta unavailable: no gate
            return True
        if not xml:
            return True
        from ..features.replication import ReplicationConfig
        try:
            cfg = ReplicationConfig.from_xml(xml)
        except Exception:  # noqa: BLE001 — malformed config: no gate
            return True
        return cfg.rule_for(key) is not None

    # -- the convergence step --------------------------------------------

    def _target_site(self, target: SiteTarget,
                     client: ReplTargetClient) -> str:
        if not target.site:
            target.site = client.remote_site()
        return target.site

    def _pacer(self, target: SiteTarget) -> TokenBucket:
        rate = target.bw_bps or knobs.get_int("MINIO_TPU_REPL_BW_BPS")
        with self._cond:
            tb = self._buckets.get(target.arn)
            if tb is None:
                tb = self._buckets[target.arn] = TokenBucket(rate)
            elif tb.rate != rate:
                # a re-registered target (or a flipped env knob) takes
                # effect on the NEXT push, not at process restart
                tb.set_rate(rate)
        return tb

    def _reader_factory(self, bucket: str, key: str, version_id: str,
                        target: SiteTarget):
        pacer = self._pacer(target)
        monitor = getattr(self, "bandwidth", None)

        def factory():
            # spool the version FULLY (RAM below 32 MiB, disk past it)
            # and CLOSE the source stream before the target apply runs:
            # a GET stream holds this site's per-key READ lock, and two
            # sites pushing the same key at each other while holding
            # their local read locks deadlock on the peers' write locks
            # (found live by the two-cluster concurrent-writer test)
            import tempfile
            # the null slot must be read by its SENTINEL: an empty
            # version id resolves to "latest", which under a versioned
            # history is a DIFFERENT version — pushing the null spec
            # with the latest version's bytes would corrupt the replica
            _info, stream = self.obj.get_object(
                bucket, key,
                opts=GetOptions(version_id=version_id or "null"))

            def on_bytes(n: int) -> None:
                if monitor is not None:
                    monitor.record(bucket, "tx", n)

            spool = tempfile.SpooledTemporaryFile(max_size=32 << 20)
            try:
                for chunk in pacer.paced(stream, on_bytes=on_bytes):
                    spool.write(chunk)
            finally:
                try:
                    stream.close()
                except Exception:  # noqa: BLE001 — release best-effort
                    pass
            spool.seek(0)
            return spool

        return factory

    def sync_key(self, bucket: str, key: str, target: SiteTarget,
                 resync: bool = False) -> int:
        """Converge ONE key at one target: push what it lacks, prune
        replicas of our deleted versions. `resync` pushes EVERY version
        the target lacks (disaster reseed — even versions that
        originated at the target) and never prunes. Returns versions
        pushed. Raises on any target failure (callers feed the retry
        queue)."""
        synced_c, _failed_c, pruned_c, lag_h = _metrics()
        client = self.registry.client(target.arn)
        target_site = "" if resync else self._target_site(target, client)
        my = self.registry.site_id
        local = self.obj.object_versions(bucket, key)
        if getattr(client, "push_only", False) and local:
            # generic S3 target: mirror the LATEST state only (the
            # legacy one-way semantics) — re-pushing the whole history
            # per mutation would scale bandwidth with version count
            local = [max(local,
                         key=lambda o: (o.mod_time or 0,
                                        o.version_id or "",
                                        o.etag or ""))]
        remote = client.key_versions(key)
        remote_vids = {v.version_id for v in remote if v.version_id}
        remote_null = next((v for v in remote if not v.version_id), None)
        pushed = 0
        # oldest first: relative history order survives at the target
        # wherever mod times tie
        for oi in sorted(local, key=lambda o: (o.mod_time or 0,
                                               o.version_id or "")):
            md = oi.user_defined or {}
            origin = origin_of(md, my)
            if not resync and origin == target_site:
                continue                # loop suppression: never echo
            spec = spec_of(oi)
            spec.metadata[REPL_ORIGIN_KEY] = origin
            if spec.version_id:
                if spec.version_id in remote_vids:
                    continue
            elif unversioned_conflict_keep(remote_null, spec):
                continue                # remote's unversioned slot wins
            factory = None
            if not spec.delete_marker and not spec.transitioned_stub:
                factory = self._reader_factory(bucket, key,
                                               spec.version_id, target)
            try:
                # spooled and ready, the target has not seen it: a
                # crash here must leave a retryable queue entry, never
                # a half-applied replica
                crashpoint.hit("replicate.push.before_apply")
                result = client.apply_version(key, spec, factory)
            except api_errors.ObjectApiError:
                # the version vanished locally between list and read
                # (raced a delete): the prune below converges it
                with self._cond:
                    self.skipped += 1
                continue
            if result == "applied":
                pushed += 1
                lag = max(time.time() - (oi.mod_time or 0), 0.0)
                with self._cond:
                    self.synced += 1
                    entry = self._target_entry(target.arn)
                    entry["synced"] += 1
                    entry["last_sync"] = time.time()
                    entry["last_lag_s"] = round(lag, 3)
                synced_c.inc()
                lag_h.observe(lag, target=target.arn)
            else:
                with self._cond:
                    self.skipped += 1
        if resync:
            return pushed
        # prune: replicas of OUR versions the target still holds but we
        # no longer do (versioned deletes / bulk deletes converge).
        # Guard: an empty local read must be a PROVEN deletion, not a
        # degraded quorum read — get_object_info distinguishes them.
        local_vids = {oi.version_id for oi in local}
        prunable = [v for v in remote
                    if origin_of(v.metadata, "") == my
                    and (v.version_id not in local_vids
                         if v.version_id
                         else not any(not vid for vid in local_vids))]
        if prunable and not local:
            try:
                self.obj.get_object_info(bucket, key)
            except api_errors.ObjectNotFound:
                pass                    # truly gone: prune is safe
            except api_errors.ObjectApiError as e:
                raise ReplClientError(
                    f"degraded local read, prune deferred: {e!r}") from e
        for v in prunable:
            client.delete_version(key, v.version_id)
            with self._cond:
                self.pruned += 1
            pruned_c.inc()
        return pushed
