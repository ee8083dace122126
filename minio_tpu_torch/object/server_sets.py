"""ErasureServerSets — pools ("server sets") for cluster expansion.

Counterpart of minio_tpu/object/server_sets.py. The reference's top
ObjectLayer (cmd/erasure-server-sets.go): several independent ErasureSets
groups. A PUT goes to the pool already holding the object, else to a pool
chosen at random weighted by its free space (getZoneIdx:195,
getAvailableZoneIdx:122); GET/HEAD/DELETE scan the pools and the NEWEST
version wins (delete markers included); listings merge across pools. A
persisted topology map (object/topology.py) gives every pool a state:
new writes route only to ``active`` pools.

Every pool's sets may share one batch former, so the blocks of concurrent
PUTs and part uploads in different pools coalesce into one fused device
dispatch (BASELINE config 5's cross-set shard batching).

One namespace-change feed, many listeners: every pool's engines report
their mutations to ``_dispatch_namespace_change``, which fans out to the
attached bucket metacache (object/metacache.py: its delta journal) and
read cache (object/cache.py: invalidation). With a metacache attached,
``list_objects`` and ``list_object_versions`` are cut from the index, and
fall back to the merge-walk across pools where it declines (off, not
built, invalidated); ``delete_bucket`` purges the bucket's persisted
index.

The topology plane's verbs: online expansion (``add_pool``),
decommission through the background rebalancer (object/rebalance.py:
``start_decommission``, ``resume_rebalance_if_pending``,
``rebalance_status``, ``cancel_rebalance``), and live-session migration
off a pool that takes no writes (``migrate_upload``: a part upload or
complete of such a session moves it to an active pool first, with its
uploadID). The replication and notification planes' attach hooks are
here; nothing attaches them until those planes are ported.
"""

from __future__ import annotations

import contextlib
import random
import time
from typing import Optional

from . import api_errors
from .sets import ErasureSets, merge_listings, merge_version_listings
from .topology import (POOL_ACTIVE, POOL_DRAINING, TopologyError,
                       TopologyMap, TopologyStore)

DISK_FILL_FRACTION = 0.95  # reference diskFillFraction


class ErasureServerSets:
    def __init__(self, server_sets: list[ErasureSets],
                 topology: Optional[TopologyMap] = None,
                 load_topology: bool = True):
        if not server_sets:
            raise ValueError("no server sets")
        self.server_sets = server_sets
        self._rebalancer = None        # live Rebalancer (rebalance.py)
        # persisted bucket index (object/metacache.py): when attached,
        # listings serve from it (merge-walk fallback) and the engines'
        # namespace-change hooks feed its delta journal
        self.metacache = None
        # hot-object read cache (object/cache.py): attached at boot,
        # invalidated off the same namespace feed
        self.read_cache = None
        # the replication and notification planes: listeners on the same
        # feed once attached (not ported yet, so nothing attaches them)
        self.replication = None
        self.notifications = None
        self._ns_listeners: list = []
        if topology is None and load_topology:
            # recover the newest persisted map (highest epoch across
            # pools); a fresh cluster starts all-active at epoch 0
            topology = TopologyStore.load(self)
        self.topology = topology or TopologyMap(len(server_sets))

    def _dispatch_namespace_change(self, bucket: str,
                                   object_name: str) -> None:
        """Fan one engine namespace delta out to every listener; a
        broken listener never blocks the others (or the write path)."""
        for fn in self._ns_listeners:
            try:
                fn(bucket, object_name)
            except Exception:  # noqa: BLE001 — feed is best-effort
                pass

    def register_namespace_listener(self, fn) -> None:
        """Subscribe `fn(bucket, object_name)` to the engines' mutation
        feed and (re)wire every pool's hook at the dispatcher."""
        if fn not in self._ns_listeners:
            self._ns_listeners.append(fn)
        for z in self.server_sets:
            z.on_namespace_change = self._dispatch_namespace_change

    def attach_metacache(self, manager) -> None:
        """Wire the MetacacheManager: every pool's engines journal
        namespace deltas into it, and the listing paths consult it
        first (None = fall back to the merge-walk)."""
        self.metacache = manager
        self.register_namespace_listener(manager.record)

    def attach_read_cache(self, cache) -> None:
        """Wire the hot-object read cache's invalidation into the
        namespace feed (the serving side wraps this layer — see the
        boot)."""
        self.read_cache = cache
        self.register_namespace_listener(cache.on_namespace_change)

    def attach_replication(self, plane) -> None:
        """Wire the active-active replication plane into the one
        namespace feed: every engine mutation reaches its queue through
        this listener."""
        self.replication = plane
        self.register_namespace_listener(plane.on_namespace_change)

    def attach_notifications(self, plane) -> None:
        """Wire the bucket event notification plane into the one
        namespace feed: every engine mutation reaches its queue through
        this listener."""
        self.notifications = plane
        self.register_namespace_listener(plane.on_namespace_change)

    def single_zone(self) -> bool:
        return len(self.server_sets) == 1

    @property
    def supports_sse_device(self) -> bool:
        """Every pool can run the fused SSE PUT (the handlers' probe)."""
        return all(getattr(z, "supports_sse_device", False)
                   for z in self.server_sets)

    @property
    def device(self):
        """Where the pools' device steps run."""
        return self.server_sets[0].device

    @property
    def scheduler(self):
        """The pools' batch former (None without one)."""
        return self.server_sets[0].scheduler

    # ------------------------------------------------------------------
    # zone choice
    # ------------------------------------------------------------------

    def _available_space(self, size: int) -> list[int]:
        """Per-zone available bytes after the write, 0 when it would cross
        the fill watermark (getServerSetsAvailableSpace,
        cmd/erasure-server-sets.go:143-190) — and 0 for every pool the
        topology excludes from new writes (draining/suspended)."""
        writable = set(self.topology.write_pools())
        out = []
        for i, z in enumerate(self.server_sets):
            if i not in writable:
                out.append(0)
                continue
            info = z.storage_info()
            total, available = info["total"], info["free"]
            if available < size:
                available = 0
            if available > 0:
                available -= size
                want_left = int(total * (1.0 - DISK_FILL_FRACTION))
                if available <= want_left:
                    available = 0
            out.append(available)
        return out

    def get_available_zone_idx(self, size: int) -> int:
        spaces = self._available_space(max(size, 0))
        total = sum(spaces)
        if total == 0:
            return -1
        choose = random.randrange(total)
        at = 0
        for i, a in enumerate(spaces):
            at += a
            if at > choose and a > 0:
                return i
        return -1

    def get_zone_idx(self, bucket: str, object_name: str, size: int) -> int:
        """Zone for a PUT: the ACTIVE zone holding ANY version of the
        object (including a delete marker — version history must stay
        together) wins; else weighted free space among active zones
        (getZoneIdx, cmd/erasure-server-sets.go:195). A holder that is
        draining or suspended does NOT get the write — new versions land
        in an active pool and the newest-wins read keeps them visible
        while the rebalancer catches the old ones up."""
        if self.single_zone():
            return 0
        for i, z in enumerate(self.server_sets):
            if self.topology.can_write(i) and \
                    z.has_object_versions(bucket, object_name):
                return i
        idx = self.get_available_zone_idx(size * 2)  # ×2 for parity
        if idx < 0:
            raise api_errors.to_object_err(
                api_errors.InsufficientWriteQuorum(), bucket, object_name)
        return idx

    # ------------------------------------------------------------------
    # bucket ops
    # ------------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        for z in self.server_sets:
            z.make_bucket(bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        if not force:
            objs, pfx, _ = self.list_objects(bucket, max_keys=1)
            if objs or pfx:
                raise api_errors.BucketNotEmpty(bucket)
        for z in self.server_sets:
            z.delete_bucket(bucket, force=True)
        if self.metacache is not None:
            # purge: the persisted index lives in .minio.sys and would
            # otherwise be reloaded by a recreated same-name bucket
            self.metacache.drop_bucket(bucket, purge=True)

    def bucket_exists(self, bucket: str) -> bool:
        return self.server_sets[0].bucket_exists(bucket)

    def get_bucket_info(self, bucket: str):
        return self.server_sets[0].get_bucket_info(bucket)

    def list_buckets(self):
        return self.server_sets[0].list_buckets()

    def heal_bucket(self, bucket: str) -> None:
        for z in self.server_sets:
            z.heal_bucket(bucket)

    # ------------------------------------------------------------------
    # object ops
    # ------------------------------------------------------------------

    def put_object(self, bucket, object_name, reader, size=-1, opts=None):
        idx = self.get_zone_idx(bucket, object_name,
                                max(size, 0) if size else 0)
        return self.server_sets[idx].put_object(bucket, object_name,
                                                reader, size, opts)

    def _first_zone_with(self, fn, bucket, object_name):
        last: Optional[Exception] = None
        for z in self.server_sets:
            try:
                return fn(z)
            except api_errors.ObjectNotFound as e:
                last = e
        raise last or api_errors.ObjectNotFound(bucket, object_name)

    def _zone_for_read(self, bucket: str, object_name: str):
        """(index, FileInfo) of the zone holding the NEWEST version
        (delete markers included) — the dual-read rule that keeps GETs
        correct while an object exists in two pools (mid-rebalance, or
        overwritten while its old home drains). A pool that cannot
        answer (offline mid-drain) is skipped so surviving pools still
        serve; its error only surfaces when NO pool holds the object."""
        best_i = -1
        best_fi = None
        nf: Optional[Exception] = None
        hard: Optional[Exception] = None
        for i, z in enumerate(self.server_sets):
            try:
                fi = z.latest_file_info(bucket, object_name)
            except api_errors.ObjectNotFound as e:
                nf = e
                continue
            except api_errors.ObjectApiError as e:
                hard = e
                continue
            if best_fi is None or (fi.mod_time or 0) > \
                    (best_fi.mod_time or 0):
                best_i, best_fi = i, fi
        if best_i < 0:
            raise hard or nf or api_errors.ObjectNotFound(bucket,
                                                          object_name)
        return best_i, best_fi

    def _read_newest(self, bucket, object_name, fn,
                     marker_is_found: bool = False):
        """Run `fn(zone)` on the newest-holding zone, re-picking when
        the copy moved between the pick and the read (a rebalance
        deletes the source copy only AFTER the target committed, so a
        re-pick always lands on a live copy; a true concurrent delete
        converges to ObjectNotFound)."""
        last: Optional[Exception] = None
        for _ in range(3):
            idx, fi = self._zone_for_read(bucket, object_name)
            if fi.deleted and not marker_is_found:
                raise api_errors.ObjectNotFound(bucket, object_name)
            try:
                return fn(self.server_sets[idx])
            except api_errors.ObjectNotFound as e:
                last = e            # moved mid-read: re-pick
        raise last or api_errors.ObjectNotFound(bucket, object_name)

    def get_object(self, bucket, object_name, offset=0, length=-1,
                   opts=None):
        if not self.single_zone() and not getattr(opts, "version_id", ""):
            return self._read_newest(
                bucket, object_name,
                lambda z: z.get_object(bucket, object_name, offset,
                                       length, opts))
        return self._first_zone_with(
            lambda z: z.get_object(bucket, object_name, offset, length,
                                   opts), bucket, object_name)

    def get_object_info(self, bucket, object_name, opts=None):
        if not self.single_zone() and not getattr(opts, "version_id", ""):
            return self._read_newest(
                bucket, object_name,
                lambda z: z.get_object_info(bucket, object_name, opts))
        return self._first_zone_with(
            lambda z: z.get_object_info(bucket, object_name, opts),
            bucket, object_name)

    def delete_object(self, bucket, object_name, version_id="",
                      versioned=False):
        self.get_bucket_info(bucket)  # missing bucket must not 204
        if self.single_zone():
            return self.server_sets[0].delete_object(
                bucket, object_name, version_id, versioned)
        if versioned and not version_id:
            # a versioned delete WRITES a marker: it must land in an
            # ACTIVE pool (writes never target draining/suspended
            # pools); when the newest holder is active, keep affinity
            # so version history stays together
            try:
                idx, _ = self._zone_for_read(bucket, object_name)
            except api_errors.ObjectNotFound:
                idx = -1
            if idx < 0 or not self.topology.can_write(idx):
                idx = self.get_available_zone_idx(1 << 20)
                if idx < 0:
                    raise api_errors.InsufficientWriteQuorum()
            return self.server_sets[idx].delete_object(
                bucket, object_name, version_id, versioned)
        if version_id:
            # remove one specific version from whichever pool holds it
            last: Optional[Exception] = None
            for z in self.server_sets:
                if not z.has_object_versions(bucket, object_name):
                    continue
                try:
                    return z.delete_object(bucket, object_name,
                                           version_id, versioned)
                except (api_errors.ObjectNotFound,
                        api_errors.VersionNotFound) as e:
                    last = e
            raise last or api_errors.ObjectNotFound(bucket, object_name)
        # unversioned delete: purge EVERY pool's copy — an object that
        # transiently exists in two pools (mid-rebalance) must not
        # resurrect from the copy a single-zone delete missed
        out = None
        found = False
        for z in self.server_sets:
            if not z.has_object_versions(bucket, object_name):
                continue
            out = z.delete_object(bucket, object_name, version_id,
                                  versioned)
            found = True
        if not found:
            raise api_errors.ObjectNotFound(bucket, object_name)
        return out

    def delete_objects(self, bucket, objects):
        if self.single_zone():
            self.get_bucket_info(bucket)
            return self.server_sets[0].delete_objects(bucket, objects)
        out = []
        for o in objects:
            try:
                self.delete_object(bucket, o)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — per-key result list
                out.append(e)
        return out

    def heal_object(self, bucket, object_name, version_id="",
                    deep_scan=False, dry_run=False):
        return self._first_zone_with(
            lambda z: z.heal_object(bucket, object_name, version_id,
                                    deep_scan, dry_run),
            bucket, object_name)

    def update_object_metadata(self, bucket, object_name, metadata,
                               version_id=""):
        if not self.single_zone() and not version_id:
            # in-place update must hit the copy reads serve (newest),
            # not the first zone that happens to hold a shadowed copy
            # (marker_is_found: the engine answers MethodNotAllowed for
            # markers itself, matching its single-zone semantics)
            return self._read_newest(
                bucket, object_name,
                lambda z: z.update_object_metadata(bucket, object_name,
                                                   metadata, version_id),
                marker_is_found=True)
        return self._first_zone_with(
            lambda z: z.update_object_metadata(bucket, object_name,
                                               metadata, version_id),
            bucket, object_name)

    def transition_object(self, bucket, object_name, version_id="",
                          tier="", remote_object="", remote_version="",
                          expect_etag="", expect_mod_time=None):
        """Stub-rewrite one version in the pool that holds it (the tier
        transition and reclaim commit). A version-targeted call tries
        every pool holding the name, as a version delete does; the
        latest-version form hits the newest holder, as reads do."""
        if not self.single_zone() and version_id:
            last: Optional[Exception] = None
            for z in self.server_sets:
                if not z.has_object_versions(bucket, object_name):
                    continue
                try:
                    return z.transition_object(
                        bucket, object_name, version_id, tier,
                        remote_object, remote_version, expect_etag,
                        expect_mod_time)
                except (api_errors.ObjectNotFound,
                        api_errors.VersionNotFound) as e:
                    last = e
            raise last or api_errors.ObjectNotFound(bucket, object_name)
        if not self.single_zone():
            return self._read_newest(
                bucket, object_name,
                lambda z: z.transition_object(bucket, object_name,
                                              version_id, tier,
                                              remote_object,
                                              remote_version,
                                              expect_etag,
                                              expect_mod_time))
        return self.server_sets[0].transition_object(
            bucket, object_name, version_id, tier, remote_object,
            remote_version, expect_etag, expect_mod_time)

    # ------------------------------------------------------------------
    # version-faithful writes (replication apply / rebalance copy)
    # ------------------------------------------------------------------

    def put_delete_marker(self, bucket, object_name, version_id="",
                          mod_time=None, metadata=None):
        """Write a delete marker with explicit identity into an ACTIVE
        pool (affinity with the pool holding the object's history, like
        every other write) — the replication-apply marker path."""
        idx = self.get_zone_idx(bucket, object_name, 1 << 20)
        return self.server_sets[idx].put_delete_marker(
            bucket, object_name, version_id, mod_time, metadata)

    def put_stub_version(self, bucket, object_name, info,
                         if_none_newer=False):
        """Write a transitioned zero-data stub from its ObjectInfo into
        an ACTIVE pool (the remote tier copy is never touched)."""
        idx = self.get_zone_idx(bucket, object_name, 1 << 20)
        return self.server_sets[idx].put_stub_version(bucket, object_name,
                                                      info, if_none_newer)

    def latest_file_info(self, bucket, object_name):
        """Cross-pool newest version's FileInfo, markers included."""
        _idx, fi = self._zone_for_read(bucket, object_name)
        return fi

    # ------------------------------------------------------------------
    # multipart: session created in the chosen PUT zone; subsequent calls
    # find the zone owning the uploadID
    # ------------------------------------------------------------------

    def new_multipart_upload(self, bucket, object_name, opts=None):
        idx = self.get_zone_idx(bucket, object_name, 1 << 30)
        return self.server_sets[idx].new_multipart_upload(
            bucket, object_name, opts)

    def _zone_of_upload(self, bucket, object_name, upload_id):
        return self.server_sets[
            self._zone_index_of_upload(bucket, object_name, upload_id)]

    def _zone_index_of_upload(self, bucket, object_name,
                              upload_id) -> int:
        """Owning pool of a session. A crash mid-migration can leave
        the session resolvable in TWO pools (the draining source and
        its migration target); the first WRITABLE holder wins — at
        most one exists, so the probe returns at the first writable
        hit (the common all-active case keeps the old first-resolver
        cost) and only a drained-out session scans the full list."""
        first = -1
        for i, z in enumerate(self.server_sets):
            try:
                z.list_object_parts(bucket, object_name, upload_id,
                                    max_parts=1)
            except api_errors.InvalidUploadID:
                continue
            if self.topology.can_write(i):
                return i
            if first < 0:
                first = i
        if first < 0:
            raise api_errors.InvalidUploadID(upload_id)
        return first

    def _writable_upload_zone(self, bucket, object_name,
                              upload_id) -> int:
        """The session's pool — migrated to an active pool first when
        its current home is draining/suspended (decommission stops
        accepting NEW parts on the leaving pool; the client's uploadID
        keeps resolving because the migration preserves it)."""
        idx = self._zone_index_of_upload(bucket, object_name, upload_id)
        if self.topology.can_write(idx) or self.single_zone():
            return idx
        return self.migrate_upload(bucket, object_name, upload_id,
                                   source=idx)

    def put_object_part(self, bucket, object_name, upload_id, part_number,
                        reader, size=-1):
        idx = self._writable_upload_zone(bucket, object_name, upload_id)
        try:
            return self.server_sets[idx].put_object_part(
                bucket, object_name, upload_id, part_number, reader,
                size)
        except api_errors.InvalidUploadID:
            # the drain migrated the session between our zone choice
            # and the write (no bytes consumed yet: the session check
            # precedes the encode) — re-resolve once
            z = self._zone_of_upload(bucket, object_name, upload_id)
            return z.put_object_part(bucket, object_name, upload_id,
                                     part_number, reader, size)

    def migrate_upload(self, bucket: str, object_name: str,
                       upload_id: str,
                       source: Optional[int] = None) -> int:
        """Move one LIVE multipart session onto an active pool —
        session metadata, every uploaded part (decoded through the
        verified GET readers, re-encoded in the target's geometry) and
        the client-held uploadID all survive. The whole copy+abort
        holds the SOURCE engine's session write lock (the one
        put_object_part takes), so a racing part-write either lands
        before the snapshot or blocks and then re-resolves to the
        target; a racing second migration loses the lock and returns
        the converged home. A crash between copy and abort leaves the
        session in both pools: clients continue on the writable target
        (_zone_index_of_upload prefers it) and the re-run copies only
        parts the target LACKS — target parts are authoritative, a
        stale source copy can never overwrite a newer client write.
        Returns the target pool index."""
        from ..utils.streams import IterStream
        from .engine import PutOptions
        from .hash_reader import HashReader
        if source is None:
            source = self._zone_index_of_upload(bucket, object_name,
                                                upload_id)
        src = self.server_sets[source]
        src_engine = src.get_hashed_set(object_name)
        with contextlib.ExitStack() as stack:
            # per-pool namespace maps in every current assembly; if
            # pools ever shared one map this same-named lock would
            # self-deadlock against the dst part-writes below, so gate
            # on identity
            if not any(src_engine.ns is z.get_hashed_set(object_name).ns
                       for i, z in enumerate(self.server_sets)
                       if i != source):
                stack.enter_context(src_engine.ns.new_lock(
                    f"{bucket}/{object_name}/{upload_id}"
                ).write_locked())
            try:
                session_meta = src.get_multipart_info(
                    bucket, object_name, upload_id)
            except api_errors.InvalidUploadID:
                # lost a migration race: the winner already moved (and
                # aborted) the source session — converge on its home
                return self._zone_index_of_upload(bucket, object_name,
                                                  upload_id)
            parts = src.list_object_parts(bucket, object_name,
                                          upload_id, 0, 10000)
            # a crashed earlier migration may have left the session's
            # twin on SOME other pool — resume THERE, never re-choose
            # (re-choosing would mistake the surviving twin for a
            # consumed upload, or fork the session across three pools)
            idx = -1
            have: dict[int, str] = {}
            for i, z in enumerate(self.server_sets):
                if i == source:
                    continue
                try:
                    have = {p.part_number: p.etag
                            for p in z.list_object_parts(
                                bucket, object_name, upload_id,
                                0, 10000)}
                    idx = i
                    break
                except api_errors.ObjectApiError:
                    continue
            if idx < 0:
                if session_meta.get("x-minio-internal-migrated"):
                    # the marker is written only AFTER the target
                    # session exists; no twin anywhere now means the
                    # client completed/aborted the migrated upload —
                    # the source copy is a consumed leftover: purge,
                    # NEVER resurrect a finished upload as a zombie
                    src.abort_multipart_upload(bucket, object_name,
                                               upload_id)
                    raise api_errors.InvalidUploadID(upload_id)
                total = sum(p.size for p in parts)
                idx = self.get_available_zone_idx(
                    max(total, 1 << 20) * 2)
                if idx < 0 or idx == source:
                    raise api_errors.InsufficientWriteQuorum(
                        "no active pool has room for the session "
                        "migration")
                versioned = session_meta.get(
                    "x-minio-internal-versioned") == "true"
                user_meta = {k: v for k, v in session_meta.items()
                             if not k.startswith("x-minio-internal-")}
                self.server_sets[idx].new_multipart_upload(
                    bucket, object_name,
                    opts=PutOptions(metadata=user_meta,
                                    versioned=versioned),
                    upload_id=upload_id)
                # marker AFTER the target session exists, BEFORE the
                # parts copy: a crash from here on re-runs into the
                # resume-at-twin path above
                src.mark_multipart_session(
                    bucket, object_name, upload_id,
                    {"x-minio-internal-migrated": "1"})
            dst = self.server_sets[idx]
            for p in parts:
                if p.part_number in have:
                    continue        # crash-window leftover: dst wins
                info, stream = src.read_multipart_part(
                    bucket, object_name, upload_id, p.part_number)
                reader = IterStream(stream)
                try:
                    out = dst.put_object_part(
                        bucket, object_name, upload_id, p.part_number,
                        HashReader(reader, p.size,
                                   actual_size=p.actual_size), p.size)
                finally:
                    reader.close()
                if out.etag != p.etag:
                    # never silently swap bytes under a client-held
                    # etag: leave the source authoritative for this
                    # part and surface the fault (next sweep retries)
                    raise api_errors.ObjectApiError(
                        f"migrated part {p.part_number} etag mismatch "
                        f"({out.etag} != {p.etag})")
            src.abort_multipart_upload(bucket, object_name, upload_id)
        return idx

    def list_object_parts(self, bucket, object_name, upload_id,
                          part_marker=0, max_parts=1000):
        z = self._zone_of_upload(bucket, object_name, upload_id)
        return z.list_object_parts(bucket, object_name, upload_id,
                                   part_marker, max_parts)

    def list_multipart_uploads(self, bucket, object_name=""):
        out = []
        for z in self.server_sets:
            out.extend(z.list_multipart_uploads(bucket, object_name))
        out.sort(key=lambda u: (u["object"], u["upload_id"]))
        return out

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        z = self._zone_of_upload(bucket, object_name, upload_id)
        return z.abort_multipart_upload(bucket, object_name, upload_id)

    def get_multipart_info(self, bucket, object_name, upload_id):
        z = self._zone_of_upload(bucket, object_name, upload_id)
        return z.get_multipart_info(bucket, object_name, upload_id)

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts, version_id="", mod_time=None,
                                  if_none_newer=False):
        # a commit is a new write: a session still homed on a draining
        # pool migrates first so the object lands in an ACTIVE pool
        # instead of being drained again right after the commit
        idx = self._writable_upload_zone(bucket, object_name, upload_id)
        return self.server_sets[idx].complete_multipart_upload(
            bucket, object_name, upload_id, parts, version_id, mod_time,
            if_none_newer)

    # ------------------------------------------------------------------
    # listing (merge across pools)
    # ------------------------------------------------------------------

    def list_objects(self, bucket, prefix="", marker="", delimiter="",
                     max_keys=1000):
        t0 = time.monotonic()
        if self.metacache is not None:
            page = self.metacache.serve_list_objects(
                bucket, prefix, marker, delimiter, max_keys)
            if page is not None:
                self._observe_listing("list", "index", t0)
                return page
        per_zone = [z.list_objects(bucket, prefix, marker, delimiter,
                                   max_keys)
                    for z in self.server_sets]
        out = merge_listings(per_zone, max_keys)
        self._observe_listing("list", "walk", t0)
        return out

    def list_object_versions(self, bucket, prefix="", marker="",
                             max_keys=1000, version_marker="",
                             delimiter=""):
        t0 = time.monotonic()
        if self.metacache is not None:
            page = self.metacache.serve_list_object_versions(
                bucket, prefix, marker, max_keys, version_marker,
                delimiter)
            if page is not None:
                self._observe_listing("versions", "index", t0)
                return page
        per_zone = [z.list_object_versions(bucket, prefix, marker,
                                           max_keys, version_marker,
                                           delimiter)
                    for z in self.server_sets]
        out = merge_version_listings(per_zone, max_keys)
        self._observe_listing("versions", "walk", t0)
        return out

    def object_versions(self, bucket, name):
        """Cross-pool quorum-merged versions of one object (dedup by
        version id, newest first)."""
        out = []
        seen = set()
        for z in self.server_sets:
            try:
                for oi in z.object_versions(bucket, name):
                    if oi.version_id not in seen:
                        seen.add(oi.version_id)
                        out.append(oi)
            except api_errors.ObjectApiError:
                continue
        # (mod time, version id) newest first — the deterministic
        # conflict order shared with the engine quorum merge
        out.sort(key=lambda o: (o.mod_time or 0, o.version_id or ""),
                 reverse=True)
        return out

    @staticmethod
    def _observe_listing(verb: str, source: str, t0: float) -> None:
        from .metacache import listing_histogram
        listing_histogram().observe(time.monotonic() - t0, verb=verb,
                                    source=source)

    def storage_info(self) -> dict:
        zones = [z.storage_info() for z in self.server_sets]
        for i, z in enumerate(zones):
            z["pool_state"] = self.topology.state(i)
        return {"total": sum(z["total"] for z in zones),
                "free": sum(z["free"] for z in zones),
                "used": sum(z["used"] for z in zones),
                "online_disks": sum(z["online_disks"] for z in zones),
                "offline_disks": sum(z["offline_disks"] for z in zones),
                "topology_epoch": self.topology.epoch,
                "zones": zones}

    # ------------------------------------------------------------------
    # topology plane: expansion, decommission, rebalance control
    # ------------------------------------------------------------------

    def add_pool(self, sets: ErasureSets) -> int:
        """Online expansion: append one pool, replicate existing bucket
        namespace onto it, bump+persist the placement epoch. Returns
        the new pool index."""
        for vol in self.list_buckets():
            try:
                sets.make_bucket(vol.name)
            except api_errors.BucketExists:
                pass
        self.server_sets.append(sets)
        if self._ns_listeners:
            # the new pool's engines must feed the listeners like
            # boot-time pools, or its writes would be invisible to the
            # index/cache until reconcile
            sets.on_namespace_change = self._dispatch_namespace_change
        # boot-time RE-attach must not forget a persisted state: the
        # map loaded at boot was truncated to the CLI drive list's pool
        # count, so a node that crashed mid-drain and reboots with
        # --pool would re-register the draining pool as active and
        # silently abandon the drain (found by the crash harness).
        # Adopt the persisted doc's state for this index when it has
        # one; genuinely new pools still default to active.
        state = POOL_ACTIVE
        persisted = TopologyStore.load(self)
        idx = len(self.server_sets) - 1
        if persisted is not None and len(persisted.states) > idx \
                and persisted.epoch >= self.topology.epoch:
            state = persisted.states[idx]
        self.topology.add_pool(state)
        TopologyStore.save(self, self.topology)
        # a drain parked for lack of target capacity — or adopted as
        # still-draining above — can proceed now
        self.resume_rebalance_if_pending()
        return len(self.server_sets) - 1

    def set_pool_state(self, pool: int, state: str) -> int:
        """Persisted state transition (suspend/resume a pool for
        writes). Durable BEFORE it takes effect: the epoch doc is
        written first, so a crash mid-transition replays it."""
        prev = self.topology.state(pool) \
            if 0 <= pool < len(self.server_sets) else None
        epoch = self.topology.set_state(pool, state)
        try:
            TopologyStore.save(self, self.topology)
        except TopologyError:
            if prev is not None:        # roll back the in-memory map
                self.topology.set_state(pool, prev)
            raise
        return epoch


    def start_decommission(self, pool: int, **rebalance_kw) -> dict:
        """Mark `pool` draining and start the background rebalancer
        moving its objects into the remaining active pools."""
        from .rebalance import Rebalancer
        if self._rebalancer is not None and self._rebalancer.running():
            raise TopologyError(
                f"a rebalance of pool {self._rebalancer.source} is "
                "already running")
        if self.topology.state(pool) != POOL_DRAINING:
            self.set_pool_state(pool, POOL_DRAINING)
        # honor a persisted checkpoint by default (a canceled drain
        # restarted via the admin API continues where it stopped; the
        # drain loop's final full sweeps still catch earlier names)
        rebalance_kw.setdefault("resume", True)
        self._rebalancer = Rebalancer(self, pool, **rebalance_kw)
        self._rebalancer.start()
        return {"pool": pool, "epoch": self.topology.epoch,
                "status": "draining"}

    def resume_rebalance_if_pending(self) -> bool:
        """Boot hook (re-armed by add_pool): a pool left in `draining`
        state (process died mid-drain) resumes its rebalance from the
        persisted checkpoint instead of restarting from scratch. A
        drain with no active pool to move INTO stays parked until
        capacity attaches — every move would fail its target choice."""
        from .rebalance import Rebalancer
        if self._rebalancer is not None and self._rebalancer.running():
            return False
        targets = self.topology.write_pools()
        for pool in self.topology.draining_pools():
            if not any(t != pool for t in targets):
                continue
            self._rebalancer = Rebalancer(self, pool, resume=True)
            self._rebalancer.start()
            return True
        return False

    def rebalance_status(self) -> dict:
        out = {"topology": self.topology.to_dict()}
        if self._rebalancer is not None:
            out["rebalance"] = self._rebalancer.status()
        else:
            # a drain may have finished in a previous process: surface
            # the persisted checkpoint so status survives restarts
            from .rebalance import Rebalancer
            for pool in range(len(self.server_sets)):
                doc = Rebalancer.load_checkpoint(self, pool)
                if doc is not None:
                    out.setdefault("checkpoints", []).append(doc)
        return out

    def cancel_rebalance(self) -> dict:
        """Stop the drain and return the pool to active service; the
        checkpoint is kept so a later decommission resumes where this
        one stopped. The pool is reactivated only once the walker has
        ACTUALLY stopped — flipping it active with a move in flight
        would let the walker's source purge race a client write."""
        if self._rebalancer is None:
            raise TopologyError("no rebalance is running")
        reb = self._rebalancer
        if not reb.stop():
            return {"pool": reb.source, "status": "stopping",
                    "epoch": self.topology.epoch}
        if self.topology.state(reb.source) == POOL_DRAINING:
            self.set_pool_state(reb.source, POOL_ACTIVE)
        return {"pool": reb.source, "status": "canceled",
                "epoch": self.topology.epoch}

    # ------------------------------------------------------------------
    # MRF heal queue (per-zone queues, aggregated view)
    # ------------------------------------------------------------------

    def drain_mrf(self, timeout: float = 10.0) -> bool:
        # one shared deadline: N wedged zones must not stack N timeouts
        deadline = time.monotonic() + timeout
        ok = True
        for z in self.server_sets:
            ok = z.drain_mrf(max(0.0, deadline - time.monotonic())) and ok
        return ok

    def mrf_stats(self) -> dict:
        zones = [z.mrf_stats() for z in self.server_sets]
        keys = ("pending", "queued", "healed", "requeued", "failed",
                "dropped", "skipped")
        out = {k: sum(z.get(k, 0) for z in zones) for k in keys}
        out["zones"] = zones
        return out

    def close(self) -> None:
        if self._rebalancer is not None:
            self._rebalancer.stop()
            self._rebalancer = None
        if self.metacache is not None:
            self.metacache.close()
            self.metacache = None
        for z in self.server_sets:
            z.close()


def open_server_sets(pools: list[list[str]], set_drive_count: int,
                     parity: int, **kw) -> ErasureServerSets:
    """Open (formatting fresh drives, healing the format of fresh
    replacements) one ErasureSets per list of local drive paths, each of
    len(paths) // set_drive_count sets, as the pools of one
    ErasureServerSets — the layout minio_tpu writes, so this opens its
    pools too. kw reaches ErasureSets.from_drives (block_size,
    enable_mrf) and every engine (bitrot_algo, device, scheduler)."""
    return ErasureServerSets([
        ErasureSets.from_drives(paths, len(paths) // set_drive_count,
                                set_drive_count, parity, **kw)
        for paths in pools])
