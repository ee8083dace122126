"""Background pool rebalancer: drain a pool's objects into the active
pools while serving traffic.

Counterpart of minio_tpu/object/rebalance.py. Upstream's decommission
(cmd/erasure-server-pool-decom.go) walks every bucket of the draining
pool, re-PUTs each version through the regular object path into the
surviving pools, and deletes the source copy only after the target write
succeeded; progress is checkpointed so a restart resumes instead of
rescanning. This is that walker, wired to the port's planes:

  * moves ride the target pool's regular put_object (the pipelined
    encode: on the card above the codec's size gate) and the engine's
    reconstructing reads, so a degraded source object (dead drives <=
    parity) decodes on the card on the fly;
  * failed moves feed the source pool's MRF heal queue (heal first,
    move on the next pass) and count in
    ``minio_tpu_rebalance_failed_total``;
  * the walker THROTTLES itself off the batch formers' occupancy and the
    staging rings' waits (utils/pressure.py): foreground traffic always
    wins, the drain takes the idle cycles;
  * the checkpoint (bucket + name marker + counters) persists in the
    hidden config bucket of every ACTIVE pool after every
    ``MINIO_TPU_REBALANCE_CHECKPOINT_EVERY`` objects: a kill mid-drain
    resumes from the marker.

Knobs: MINIO_TPU_REBALANCE_CHECKPOINT_EVERY (16 objects between
checkpoints), _PAGE (256, listing page size), _MPU_GRACE_S (30 s),
_BACKOFF_S (0.05), _BACKOFF_MAX_S (1.0), _BACKOFF_TRIES (8).

Left out: the ``rebalance.move`` and ``rebalance.migrate_mpu`` spans and
the ``rebalance.checkpoint`` event-log record (the tracing and incident
planes are not ported); the crashpoint of the same name is kept.
"""

from __future__ import annotations

import json
import threading
import time
from typing import TYPE_CHECKING, Optional

from ..storage.xl_storage import MINIO_META_BUCKET
from ..utils import atomicfile, crashpoint, knobs, telemetry
from ..utils.pressure import ForegroundPressure
from ..utils.streams import IterStream as _IterStream
from . import api_errors
from .engine import GetOptions, PutOptions
from .topology import POOL_DRAINING, TOPOLOGY_PREFIX

if TYPE_CHECKING:  # pragma: no cover — typing only
    from .server_sets import ErasureServerSets

CHECKPOINT_EVERY = knobs.get_int("MINIO_TPU_REBALANCE_CHECKPOINT_EVERY")
PAGE = knobs.get_int("MINIO_TPU_REBALANCE_PAGE")
MPU_GRACE_S = knobs.get_float("MINIO_TPU_REBALANCE_MPU_GRACE_S")
BACKOFF_S = knobs.get_float("MINIO_TPU_REBALANCE_BACKOFF_S")
BACKOFF_MAX_S = knobs.get_float("MINIO_TPU_REBALANCE_BACKOFF_MAX_S")
BACKOFF_TRIES = knobs.get_int("MINIO_TPU_REBALANCE_BACKOFF_TRIES")

# meta-bucket prefixes that must NOT migrate: per-pool internals (tmp
# staging, live multipart sessions, bucket metadata replicated per
# pool) and the topology/checkpoint/tier-config docs themselves
# (written to every pool on purpose)
META_SKIP_PREFIXES = ("tmp/", "multipart/", "buckets/", TOPOLOGY_PREFIX,
                      "tier/", "replicate/", "qos/")


def _checkpoint_object(pool: int) -> str:
    return f"{TOPOLOGY_PREFIX}rebalance-{pool}.json"


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_rebalance_objects_total",
                    "Object versions moved off draining pools"),
        reg.counter("minio_tpu_rebalance_bytes_total",
                    "Bytes moved off draining pools"),
        reg.counter("minio_tpu_rebalance_failed_total",
                    "Object moves that failed (fed to MRF, retried "
                    "next pass)"),
        reg.gauge("minio_tpu_rebalance_active",
                  "1 while a pool drain is running"),
    )


class Rebalancer:
    """One pool drain: a daemon thread walking the source pool and
    moving every object version into the active pools."""

    def __init__(self, server_sets: "ErasureServerSets", source: int,
                 resume: bool = False,
                 checkpoint_every: Optional[int] = None,
                 page: Optional[int] = None,
                 busy_fn=None, throttle_s: Optional[float] = None,
                 mpu_grace_s: Optional[float] = None):
        self.obj = server_sets
        self.source = source
        self.checkpoint_every = checkpoint_every or CHECKPOINT_EVERY
        self.page = page or PAGE
        # live multipart sessions idle less than this keep their grace;
        # past it the drain migrates them to an active pool instead of
        # waiting them out (ROADMAP carried-over item 6)
        self.mpu_grace_s = MPU_GRACE_S if mpu_grace_s is None \
            else mpu_grace_s
        # busy probe override (tests); default samples the live
        # scheduler queue + staging-ring waits (utils/pressure.py —
        # shared with the tier transition worker)
        self._pressure = ForegroundPressure(server_sets, busy_fn=busy_fn)
        self._throttle_base = BACKOFF_S if throttle_s is None \
            else throttle_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self.state = {
            "pool": source, "status": "pending",
            "bucket": "", "marker": "",
            "objects_moved": 0, "bytes_moved": 0, "objects_failed": 0,
            "mpu_migrated": 0, "mpu_failed": 0,
            "passes": 0, "started": time.time(), "updated": time.time(),
        }
        if resume:
            doc = self.load_checkpoint(server_sets, source)
            if doc is not None and doc.get("status") not in ("complete",):
                for k in ("bucket", "marker", "objects_moved",
                          "bytes_moved", "objects_failed", "passes"):
                    if k in doc:
                        self.state[k] = doc[k]
                self.state["resumed"] = True

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "Rebalancer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"rebalance-p{self.source}")
        self._thread.start()
        return self

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout: float = 10.0) -> bool:
        """Signal + join the drain thread; True when it actually
        stopped (callers reactivating the pool must not proceed while
        a move is still in flight)."""
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout)
        return not self.running()

    def status(self) -> dict:
        with self._mu:
            out = dict(self.state)
        out["running"] = self.running()
        return out

    # ------------------------------------------------------------------
    # the drain loop
    # ------------------------------------------------------------------

    def _run(self) -> None:
        objects_c, bytes_c, failed_c, active_g = _metrics()
        active_g.set(1)
        self._set(status="draining")
        try:
            while not self._stop.is_set():
                moved, failed, remaining = self.run_pass()
                with self._mu:
                    self.state["passes"] += 1
                if self._stop.is_set():
                    break
                if moved == 0 and remaining == 0 and failed == 0:
                    self._set(status="complete", bucket="", marker="")
                    self._save_checkpoint()
                    return
                # stragglers (failed moves healing through MRF, late
                # multipart commits): next pass sweeps again from the top
                self._set(bucket="", marker="")
                if moved == 0:
                    # nothing progressed: wait for MRF heals before the
                    # next sweep instead of spinning the listing
                    self._stop.wait(1.0)
            self._set(status="stopped")
            self._save_checkpoint()
        except Exception as e:  # noqa: BLE001 — surfaced via status
            self._set(status="failed", error=repr(e))
            self._save_checkpoint()
        finally:
            active_g.set(0)

    def run_pass(self, restart: bool = False) -> tuple[int, int, int]:
        """One sweep of the source pool from the current checkpoint
        (`restart=True` sweeps from the top — what the drain loop does
        between passes). Returns (moved, failed, remaining-at-end)."""
        if restart:
            self._set(bucket="", marker="")
        src = self.obj.server_sets[self.source]
        moved = failed = 0
        # lexically sorted INCLUDING the hidden config bucket (config/
        # IAM objects migrate too): iteration order must match the
        # checkpoint's `bucket < start_bucket` resume comparison
        buckets = sorted([v.name for v in src.list_buckets()]
                         + [MINIO_META_BUCKET])
        start_bucket = self.state["bucket"]
        for bucket in buckets:
            if self._stop.is_set():
                break
            if start_bucket and bucket < start_bucket:
                continue
            marker = self.state["marker"] \
                if bucket == start_bucket else ""
            m, f = self._drain_bucket(src, bucket, marker)
            moved += m
            failed += f
        if not self._stop.is_set():
            # actively drain LIVE multipart sessions (bounded grace,
            # then migrate) instead of waiting for clients to finish
            m, f = self._drain_multipart(src)
            moved += m
            failed += f
        remaining = 0 if self._stop.is_set() else self._remaining(src)
        return moved, failed, remaining

    def _drain_multipart(self, src) -> tuple[int, int]:
        """Migrate the source pool's in-flight multipart sessions to an
        active pool once their grace expired (``initiated`` tracks the
        session journal's last write, so an actively-uploading client
        keeps renewing its grace — but its own next part-write migrates
        the session anyway via the server-sets draining guard). Failed
        migrations count + feed the source MRF queue and retry next
        pass."""
        moved = failed = 0
        now = time.time()
        try:
            # ONE scan of the shared multipart volume per pass (each
            # entry carries its owning bucket) — the per-bucket lister
            # reads every session's xl.meta just to filter
            uploads = src.list_all_multipart_uploads()
        except api_errors.ObjectApiError:
            return 0, 0
        for up in uploads:
            if self._stop.is_set():
                return moved, failed
            if now - up.get("initiated", 0) < self.mpu_grace_s:
                continue                # bounded in-flight grace
            self._throttle()
            try:
                self.obj.migrate_upload(up["bucket"], up["object"],
                                        up["upload_id"],
                                        source=self.source)
            except api_errors.InvalidUploadID:
                # the session vanished under us (client completed or
                # aborted, or a consumed leftover was purged):
                # converged, nothing to count
                moved += 1
            except Exception:  # noqa: BLE001 — per-session isolation;
                failed += 1    # MRF heals, the next pass retries
                with self._mu:
                    self.state["mpu_failed"] += 1
                self._on_move_failed(up["bucket"], up["object"])
            else:
                moved += 1
                with self._mu:
                    self.state["mpu_migrated"] += 1
        return moved, failed

    def _drain_bucket(self, src, bucket: str, marker: str
                      ) -> tuple[int, int]:
        moved = failed = since_ckpt = 0
        for name, versions in self._bucket_groups(src, bucket, marker):
            if self._stop.is_set():
                break
            self._throttle()
            try:
                moved_bytes = self._move_object(bucket, name, versions)
            except Exception:  # noqa: BLE001 — per-object isolation
                failed += 1
                self._on_move_failed(bucket, name)
            else:
                moved += 1
                with self._mu:
                    self.state["objects_moved"] += 1
                    self.state["bytes_moved"] += moved_bytes
                objects_c, bytes_c, _, _ = _metrics()
                objects_c.inc(len(versions), pool=str(self.source))
                bytes_c.inc(moved_bytes, pool=str(self.source))
            self._set(bucket=bucket, marker=name)
            since_ckpt += 1
            if since_ckpt >= self.checkpoint_every:
                self._save_checkpoint()
                since_ckpt = 0
        if since_ckpt:
            self._save_checkpoint()
        return moved, failed

    def _bucket_groups(self, src, bucket: str, marker: str):
        """(name, source-pool versions) groups in name order after
        `marker`. The metacache index (when attached) supplies the
        NAMES — the drain rides the one amortized walk instead of
        re-walking the namespace per pass — while the version list
        stays the SOURCE POOL's own quorum read (the index is
        cluster-wide; only pool-local truth may drive a pool drain).
        Falls back to marker-paged pool-local version listing, carrying
        a page-cut group across pages so an object's versions always
        move together."""
        feed = None
        mc = getattr(self.obj, "metacache", None)
        if mc is not None and bucket != MINIO_META_BUCKET:
            feed = mc.namespace_feed(bucket, versions=True,
                                     consumer="rebalance")
        if feed is not None:
            for name, _cluster_versions in feed:
                if self._stop.is_set():
                    return
                if marker and name <= marker:
                    continue
                try:
                    vs = src.object_versions(bucket, name)
                except api_errors.ObjectApiError:
                    continue
                if vs:
                    yield name, vs
            return
        from .metacache import walks_counter
        walks_counter().inc(consumer="rebalance", source="merge")
        vid_marker = ""
        carry_name = None
        carry: list = []
        while not self._stop.is_set():
            try:
                page, _pfx, nkm, nvm, trunc = src.list_object_versions(
                    bucket, "", marker, self.page, vid_marker)
            except api_errors.ObjectApiError:
                return                  # bucket vanished mid-drain
            for oi in page:
                if bucket == MINIO_META_BUCKET and \
                        oi.name.startswith(META_SKIP_PREFIXES):
                    continue
                if carry_name is not None and oi.name != carry_name:
                    yield carry_name, carry
                    carry = []
                carry_name = oi.name
                carry.append(oi)
            if not trunc:
                break
            marker, vid_marker = nkm, nvm
        if carry_name is not None and carry and not self._stop.is_set():
            yield carry_name, carry

    def _group(self, page, bucket: str) -> list[tuple[str, list]]:
        """Page of version ObjectInfos -> [(name, versions)] in listing
        order, meta-bucket internals filtered out."""
        groups: list[tuple[str, list]] = []
        for oi in page:
            if bucket == MINIO_META_BUCKET and \
                    oi.name.startswith(META_SKIP_PREFIXES):
                continue
            if groups and groups[-1][0] == oi.name:
                groups[-1][1].append(oi)
            else:
                groups.append((oi.name, [oi]))
        return groups

    def _remaining(self, src) -> int:
        """Movable objects still on the source pool (completion probe).
        Live multipart sessions count too: the drain is not complete
        until every session migrated (young ones ride their grace
        through another pass)."""
        remaining = 0
        buckets = [v.name for v in src.list_buckets()] \
            + [MINIO_META_BUCKET]
        for bucket in buckets:
            try:
                page, _, _, _, _ = src.list_object_versions(
                    bucket, "", "", self.page)
            except api_errors.ObjectApiError:
                continue
            remaining += len(self._group(page, bucket))
        try:
            remaining += len(src.list_all_multipart_uploads())
        except api_errors.ObjectApiError:
            pass
        return remaining

    # ------------------------------------------------------------------
    # one object
    # ------------------------------------------------------------------

    def _move_object(self, bucket: str, name: str, versions: list) -> int:
        """Copy every version (oldest first, so relative order is
        preserved wherever mod times tie) into an active pool, then
        delete the source copies. Source deletion happens only after
        EVERY version committed at target write quorum — a crash in
        between leaves the object readable in both pools (newest-wins)
        and the next pass's idempotency check finishes the job."""
        src = self.obj.server_sets[self.source]
        moved_bytes = 0
        for oi in sorted(versions, key=lambda o: o.mod_time or 0):
            if self._version_in_active_pool(bucket, name, oi):
                continue            # crash-window leftover: done
            moved_bytes += self._copy_version(src, bucket, name, oi)
        if self._stop.is_set():
            # canceled mid-move: leave the source intact — the
            # copies are idempotent leftovers the next drain (or a
            # client overwrite after reactivation) supersedes;
            # purging here could race a write to the re-activated
            # pool
            return moved_bytes
        # a client DELETE that raced the copy must win: versions
        # gone from the source since we listed them were deleted
        # (the purge scanned the target before our copy committed),
        # so roll their fresh target copies back instead of
        # resurrecting them
        try:
            still = {v.version_id
                     for v in src.object_versions(bucket, name)}
        except api_errors.ObjectApiError:
            still = set()
        for oi in sorted(versions, key=lambda o: o.mod_time or 0):
            try:
                if oi.version_id not in still:
                    self._rollback_target_copy(bucket, name, oi)
                elif oi.version_id:
                    src.delete_object(bucket, name,
                                      version_id=oi.version_id)
                else:
                    src.delete_object(bucket, name)
            except api_errors.ObjectNotFound:
                pass                # already gone (raced a delete)
        return moved_bytes

    def _rollback_target_copy(self, bucket: str, name: str, oi) -> None:
        for i in self.obj.topology.write_pools():
            if i == self.source:
                continue
            z = self.obj.server_sets[i]
            try:
                if oi.version_id:
                    z.delete_object(bucket, name,
                                    version_id=oi.version_id)
                elif z.has_object_versions(bucket, name):
                    z.delete_object(bucket, name)
            except api_errors.ObjectApiError:
                pass

    def _version_in_active_pool(self, bucket: str, name: str, oi) -> bool:
        for i in self.obj.topology.write_pools():
            if i == self.source:
                continue
            z = self.obj.server_sets[i]
            try:
                if oi.delete_marker or oi.version_id:
                    # direct per-name read: O(versions of this object),
                    # not O(bucket), and never blind past a page cut
                    for v in z.object_versions(bucket, name):
                        if v.version_id == oi.version_id:
                            return True
                else:
                    got = z.get_object_info(bucket, name)
                    if got.etag == oi.etag and \
                            got.mod_time == oi.mod_time:
                        return True
            except api_errors.ObjectApiError:
                continue
        return False

    def _copy_version(self, src, bucket: str, name: str, oi) -> int:
        from ..storage.datatypes import is_restored, is_transitioned
        if oi.delete_marker:
            idx = self._target_pool(bucket, name, 1 << 20)
            self.obj.server_sets[idx].put_delete_marker(
                bucket, name, oi.version_id, oi.mod_time)
            return 0
        if is_transitioned(oi.user_defined or {}) \
                and not is_restored(oi.user_defined or {}):
            # a tiered zero-data stub: there are no local shards to
            # move and GET would refuse (InvalidObjectState) — copy the
            # xl.meta pointer alone, like a delete marker (the remote
            # copy stays where it is)
            idx = self._target_pool(bucket, name, 1 << 20)
            self.obj.server_sets[idx].put_stub_version(bucket, name, oi)
            return 0
        info, stream = src.get_object(
            bucket, name, opts=GetOptions(version_id=oi.version_id))
        metadata = dict(info.user_defined)
        if info.etag:
            metadata["etag"] = info.etag
        if info.content_type:
            metadata["content-type"] = info.content_type
        if info.content_encoding:
            metadata["content-encoding"] = info.content_encoding
        idx = self._target_pool(bucket, name, info.size)
        opts = PutOptions(metadata=metadata,
                          version_id=info.version_id,
                          versioned=bool(info.version_id),
                          mod_time=info.mod_time)
        reader = _IterStream(stream)
        try:
            self.obj.server_sets[idx].put_object(bucket, name, reader,
                                                 info.size, opts)
        finally:
            reader.close()
        return info.size

    def _target_pool(self, bucket: str, name: str, size: int) -> int:
        """Active pool for one moved version: keep affinity with an
        active pool already holding the object's history, else weighted
        free space — never the source."""
        for i in self.obj.topology.write_pools():
            if i != self.source and \
                    self.obj.server_sets[i].has_object_versions(bucket,
                                                                name):
                return i
        idx = self.obj.get_available_zone_idx(max(size, 1) * 2)
        if idx < 0 or idx == self.source:
            raise api_errors.InsufficientWriteQuorum(
                "no active pool has room for the rebalance target")
        return idx

    def _on_move_failed(self, bucket: str, name: str) -> None:
        with self._mu:
            self.state["objects_failed"] += 1
        _, _, failed_c, _ = _metrics()
        failed_c.inc(pool=str(self.source))
        # heal-first: a move that failed on a degraded source heals
        # through the MRF queue, then the next sweep retries the move
        src = self.obj.server_sets[self.source]
        mrf = getattr(src, "mrf", None)
        if mrf is not None:
            mrf.enqueue(bucket, name)

    # ------------------------------------------------------------------
    # throttle: foreground traffic always wins
    # ------------------------------------------------------------------

    def _busy(self) -> bool:
        return self._pressure.busy()

    def _throttle(self) -> None:
        # still busy after the cap: proceed at the slow cadence anyway
        # so a permanently-loaded cluster still drains
        self._pressure.throttle(self._stop, self._throttle_base,
                                BACKOFF_MAX_S, BACKOFF_TRIES)

    # ------------------------------------------------------------------
    # checkpoint persistence
    # ------------------------------------------------------------------

    def _set(self, **kw) -> None:
        with self._mu:
            self.state.update(kw)
            self.state["updated"] = time.time()

    def _save_checkpoint(self) -> None:
        with self._mu:
            doc = dict(self.state)
        payload = json.dumps(doc).encode()
        # every ACTIVE pool gets a copy: the checkpoint must survive the
        # source pool's removal
        for i in self.obj.topology.write_pools():
            if i == self.source:
                continue
            try:
                # one hit per pool (arm :<nth>): resume must tolerate
                # a stale checkpoint (idempotent re-pass) or a torn one
                crashpoint.hit("rebalance.checkpoint")
                self.obj.server_sets[i].put_object(
                    MINIO_META_BUCKET, _checkpoint_object(self.source),
                    payload)
            except Exception:  # noqa: BLE001 — best-effort per pool
                pass

    @staticmethod
    def load_checkpoint(server_sets: "ErasureServerSets",
                        pool: int) -> Optional[dict]:
        best: Optional[dict] = None
        for z in server_sets.server_sets:
            try:
                _, stream = z.get_object(MINIO_META_BUCKET,
                                         _checkpoint_object(pool))
                # a crash inside the checkpoint write can leave torn
                # JSON (or a truncated valid-JSON prefix of the wrong
                # type): treat it as absent, fall back to the previous
                # pool's copy / a fresh pass
                doc = atomicfile.load_json_doc(b"".join(stream))
            except api_errors.ObjectApiError:
                continue
            if doc is None:
                continue
            if best is None or doc.get("updated", 0) > \
                    best.get("updated", 0):
                best = doc
        return best
