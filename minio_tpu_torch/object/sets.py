"""ErasureSets — S = setCount × setDriveCount drives, object→set routing.

Counterpart of minio_tpu/object/sets.py. The reference's erasureSets
layer (cmd/erasure-sets.go): each object maps
to exactly one erasure set by SipHash-2-4 of its name keyed by the
deployment ID (sipHashMod:590); bucket operations fan out to every set;
listings merge across sets. Includes the MRF ("most recently failed")
heal queue fed by degraded reads (maintainMRFList:1641, healMRFRoutine)
and the format bootstrap (waitForFormatErasure semantics,
cmd/prepare-storage.go).

Set routing is static routing on the host. The device work of every set
can share one batch former (pass ``scheduler=`` through the engine
keywords): the former keys its buckets by geometry, not by set, so the
blocks of concurrent writes to different sets coalesce into one fused
dispatch.

Every set's namespace-change hook reports up through this layer's
``on_namespace_change`` (object/server_sets.py points it at its
dispatcher). The tier plane's verbs (``transition_object``,
``put_stub_version``) route by object name like every other write.
"""

from __future__ import annotations

import dataclasses
import uuid as _uuid
from typing import Optional

from ..storage import errors as serr
from ..storage.datatypes import ObjectInfo, last_version_marker
from ..storage.format import (DISTRIBUTION_ALGO_V2, DISTRIBUTION_ALGO_V3,
                              FormatErasureV3, get_format_in_quorum,
                              new_format_erasure_v3)
from ..storage.xl_storage import XLStorage
from ..utils.siphash import crc_hash_mod, sip_hash_mod
from . import ErasureSetObjects, api_errors
from .background import MRFHealer
from .nslock import NSLockMap


class ErasureSets:
    """Routes the ObjectLayer surface over `set_count` erasure sets."""

    def __init__(self, sets: list[ErasureSetObjects], deployment_id: str,
                 distribution_algo: str = DISTRIBUTION_ALGO_V3,
                 enable_mrf: bool = True,
                 format_ref: Optional[FormatErasureV3] = None,
                 slot_sources: Optional[list] = None,
                 mrf_options: Optional[dict] = None):
        self.sets = sets
        self.deployment_id = deployment_id
        self.distribution_algo = distribution_algo
        # topology reference (the sets x drives UUID matrix the drives are
        # ordered by) + per-slot drive sources (root path or live
        # StorageAPI), set-major order — the disk monitor's map of what
        # belongs where (reference erasure-sets endpoints)
        self.format_ref = format_ref
        self.slot_sources = slot_sources
        self._id16 = _uuid.UUID(deployment_id).bytes
        self.mrf: Optional[MRFHealer] = None
        # the engines report namespace mutations up through this layer;
        # server_sets (or a test) points it at its dispatcher
        self.on_namespace_change = None
        for s in self.sets:
            s.on_namespace_change = self._notify_namespace
        if enable_mrf:
            self.mrf = MRFHealer(self._heal_mrf_entry, **(mrf_options or {}))
            for s in self.sets:
                # degraded READS (reconstruction/bitrot) and degraded
                # WRITES (quorum met but drives lost) both feed the MRF
                # queue (reference maintainMRFList + healMRFRoutine)
                s.on_degraded_read = self._queue_mrf_heal
                s.on_degraded_write = self._queue_mrf_heal

    @property
    def supports_sse_device(self) -> bool:
        """Every set can run the fused SSE PUT (the handlers' probe)."""
        return all(getattr(s, "supports_sse_device", False)
                   for s in self.sets)

    @property
    def device(self):
        """Where the sets' device steps run (the handlers' GET decipher
        runs there too)."""
        return self.sets[0].device

    @property
    def scheduler(self):
        """The batch former the sets share (None without one): the
        handlers' GET decipher goes through it too."""
        return self.sets[0].scheduler

    # ------------------------------------------------------------------
    # construction from drives (format bootstrap)
    # ------------------------------------------------------------------

    @classmethod
    def from_drives(cls, drive_roots: list[str], set_count: int,
                    set_drive_count: int, parity: int,
                    block_size: int = 1 << 22,
                    ns_lock: Optional[NSLockMap] = None,
                    **engine_kw) -> "ErasureSets":
        """Open (formatting if fresh) setCount×setDriveCount local drives
        (reference waitForFormatErasure + newErasureSets,
        cmd/prepare-storage.go / cmd/erasure-sets.go:337). engine_kw
        reaches every set's engine (bitrot_algo, device, scheduler, ...)."""
        # a faulty drive becomes a None slot, never a bootstrap abort
        # (reference: sets open with offline slots)
        drives: list = []
        for r in drive_roots:
            try:
                drives.append(XLStorage(r))
            except serr.StorageError:
                drives.append(None)
        return cls.from_storage(drives, set_count, set_drive_count, parity,
                                block_size=block_size, ns_lock=ns_lock,
                                sources=list(drive_roots), **engine_kw)

    @classmethod
    def from_storage(cls, drives: list, set_count: int,
                     set_drive_count: int, parity: int,
                     block_size: int = 1 << 22,
                     ns_lock: Optional[NSLockMap] = None,
                     create_format: bool = True,
                     sources: Optional[list] = None,
                     **engine_kw) -> "ErasureSets":
        """Assemble sets over StorageAPI drives, local XLStorage and/or
        RemoteStorage (None: an offline slot; reference newErasureSets,
        cmd/erasure-sets.go:337-430). Fresh drives are formatted; a drive
        without a format in an otherwise formatted cluster is healed: it
        gets the format of its slot. create_format=False makes an
        unformatted cluster an error instead of a fresh format write
        (non-first nodes of a distributed boot wait for the first node
        to format, cmd/prepare-storage.go waitForFormatErasure).
        `sources` (default: the drives themselves) names each input
        position's drive source for the disk monitor's slot_sources."""
        from ..storage.format import read_format_from, write_format_to
        if len(drives) != set_count * set_drive_count:
            raise ValueError(f"{len(drives)} drives for {set_count} sets "
                             f"of {set_drive_count}")
        enable_mrf = engine_kw.pop("enable_mrf", True)
        mrf_options = engine_kw.pop("mrf_options", None)
        formats: list[Optional[FormatErasureV3]] = []
        for d in drives:
            if d is None:
                formats.append(None)
                continue
            try:
                formats.append(read_format_from(d))
            except serr.StorageError:
                formats.append(None)

        if all(f is None for f in formats):
            if all(d is None for d in drives):
                raise serr.DiskNotFound("no usable drives")
            if not create_format:
                raise serr.UnformattedDisk(
                    "cluster not formatted yet (waiting for first node)")
            fresh = new_format_erasure_v3(set_count, set_drive_count)
            for i in range(set_count):
                for j in range(set_drive_count):
                    d = drives[i * set_drive_count + j]
                    if d is None:
                        continue
                    try:
                        write_format_to(d, fresh[i][j])
                        formats[i * set_drive_count + j] = \
                            read_format_from(d)
                    except serr.StorageError:
                        pass
        else:
            ref = get_format_in_quorum(formats)
            # heal drives with missing format (fresh replacements)
            for idx, f in enumerate(formats):
                if f is None and drives[idx] is not None:
                    # the slot's expected UUID is position-derived
                    si, di = idx // set_drive_count, idx % set_drive_count
                    nf = dataclasses.replace(
                        ref, this=ref.sets[si][di])
                    try:
                        write_format_to(drives[idx], nf)
                        formats[idx] = read_format_from(drives[idx])
                    except serr.StorageError:
                        pass

        deployment_id = next(f.id for f in formats if f is not None)
        ref_sets = next(f.sets for f in formats if f is not None)

        # order drives by their position in the format's sets matrix
        by_uuid = {}
        src_by_uuid = {}
        if sources is None:
            sources = list(drives)
        for idx, (d, f) in enumerate(zip(drives, formats)):
            if d is not None and f is not None:
                by_uuid[f.this] = d
                src_by_uuid[f.this] = sources[idx]
        from ..storage.diskid_check import DiskIDCheck
        ns = ns_lock or NSLockMap()
        sets = []
        slot_sources = []
        for i in range(set_count):
            # every drive is identity-guarded: a swap/reformat behind a
            # running set reads as DiskStale, never as wrong shards
            # (cmd/xl-storage-disk-id-check.go)
            set_drives = [
                DiskIDCheck(by_uuid[ref_sets[i][j]], ref_sets[i][j])
                if ref_sets[i][j] in by_uuid else None
                for j in range(set_drive_count)]
            # per-slot source: the drive that attested the slot's UUID,
            # else the position-derived input (the heuristic the format
            # heal above uses for fresh replacements)
            slot_sources.append([
                src_by_uuid.get(ref_sets[i][j],
                                sources[i * set_drive_count + j])
                for j in range(set_drive_count)])
            sets.append(ErasureSetObjects(
                set_drives, set_drive_count - parity, parity,
                block_size=block_size, ns_lock=ns, set_index=i,
                **engine_kw))
        fmt_ref = FormatErasureV3(id=deployment_id,
                                  sets=[list(s) for s in ref_sets])
        return cls(sets, deployment_id, enable_mrf=enable_mrf,
                   format_ref=fmt_ref, slot_sources=slot_sources,
                   mrf_options=mrf_options)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def get_hashed_set_index(self, object_name: str) -> int:
        if self.distribution_algo == DISTRIBUTION_ALGO_V2:
            return crc_hash_mod(object_name, len(self.sets))
        return sip_hash_mod(object_name, len(self.sets), self._id16)

    def get_hashed_set(self, object_name: str) -> ErasureSetObjects:
        return self.sets[self.get_hashed_set_index(object_name)]

    # ------------------------------------------------------------------
    # MRF heal queue (cmd/erasure-sets.go:1641-1711 + background-heal-ops)
    # ------------------------------------------------------------------

    def _queue_mrf_heal(self, bucket: str, object_name: str,
                        version_id: str = "") -> None:
        if self.mrf is not None:
            self.mrf.enqueue(bucket, object_name, version_id)

    def _notify_namespace(self, bucket: str, object_name: str) -> None:
        cb = self.on_namespace_change
        if cb is not None:
            cb(bucket, object_name)

    def _heal_mrf_entry(self, bucket: str, object_name: str,
                        version_id: str = ""):
        # the HealResultItem must flow back: MRFHealer retries while
        # result.missing_after > 0 (partial heal, a drive still gone)
        return self.get_hashed_set(object_name).heal_object(
            bucket, object_name, version_id)

    def drain_mrf(self, timeout: float = 10.0) -> bool:
        """Wait for queued MRF heals to COMPLETE (not just dequeue)."""
        if self.mrf is None:
            return True
        return self.mrf.drain(timeout)

    def mrf_stats(self) -> dict:
        return self.mrf.stats() if self.mrf is not None else {}

    def close(self) -> None:
        if self.mrf is not None:
            self.mrf.close()

    # ------------------------------------------------------------------
    # bucket ops (fan out to every set)
    # ------------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        done = []
        try:
            for s in self.sets:
                s.make_bucket(bucket)
                done.append(s)
        except api_errors.BucketExists:
            raise
        except Exception:
            for s in done:  # undo partial create (reference undoMakeBucket)
                try:
                    s.delete_bucket(bucket, force=True)
                except Exception:  # noqa: BLE001
                    pass
            raise

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self.get_bucket_info(bucket)
        if not force:
            objs, _, _ = self.list_objects(bucket, max_keys=1)
            if objs:
                raise api_errors.BucketNotEmpty(bucket)
        for s in self.sets:
            s.delete_bucket(bucket, force=True)

    def bucket_exists(self, bucket: str) -> bool:
        return self.sets[0].bucket_exists(bucket)

    def get_bucket_info(self, bucket: str):
        return self.sets[0].get_bucket_info(bucket)

    def list_buckets(self):
        return self.sets[0].list_buckets()

    def heal_bucket(self, bucket: str) -> None:
        for s in self.sets:
            s.heal_bucket(bucket)

    # ------------------------------------------------------------------
    # object ops (route by hash)
    # ------------------------------------------------------------------

    def put_object(self, bucket, object_name, reader, size=-1, opts=None):
        return self.get_hashed_set(object_name).put_object(
            bucket, object_name, reader, size, opts)

    def get_object(self, bucket, object_name, offset=0, length=-1,
                   opts=None):
        return self.get_hashed_set(object_name).get_object(
            bucket, object_name, offset, length, opts)

    def get_object_info(self, bucket, object_name, opts=None):
        return self.get_hashed_set(object_name).get_object_info(
            bucket, object_name, opts)

    def delete_object(self, bucket, object_name, version_id="",
                      versioned=False):
        return self.get_hashed_set(object_name).delete_object(
            bucket, object_name, version_id, versioned)

    def delete_objects(self, bucket, objects):
        """Bulk delete grouped by erasure set: each set's batch goes to
        its engine's one-call-per-drive path."""
        by_set: dict[int, list[int]] = {}
        for j, o in enumerate(objects):
            by_set.setdefault(self.get_hashed_set_index(o), []).append(j)
        out: list = [None] * len(objects)
        for si, idxs in by_set.items():
            errs = self.sets[si].delete_objects(
                bucket, [objects[j] for j in idxs])
            for j, e in zip(idxs, errs):
                out[j] = e
        return out

    def heal_object(self, bucket, object_name, version_id="",
                    deep_scan=False, dry_run=False):
        return self.get_hashed_set(object_name).heal_object(
            bucket, object_name, version_id, deep_scan, dry_run)

    def update_object_metadata(self, bucket, object_name, metadata,
                               version_id=""):
        return self.get_hashed_set(object_name).update_object_metadata(
            bucket, object_name, metadata, version_id)

    def transition_object(self, bucket, object_name, version_id="",
                          tier="", remote_object="", remote_version="",
                          expect_etag="", expect_mod_time=None):
        return self.get_hashed_set(object_name).transition_object(
            bucket, object_name, version_id, tier, remote_object,
            remote_version, expect_etag, expect_mod_time)

    def put_stub_version(self, bucket, object_name, info,
                         if_none_newer=False):
        return self.get_hashed_set(object_name).put_stub_version(
            bucket, object_name, info, if_none_newer)

    def has_object_versions(self, bucket, object_name) -> bool:
        return self.get_hashed_set(object_name).has_object_versions(
            bucket, object_name)

    def latest_file_info(self, bucket, object_name):
        return self.get_hashed_set(object_name).latest_file_info(
            bucket, object_name)

    def put_delete_marker(self, bucket, object_name, version_id="",
                          mod_time=None, metadata=None):
        return self.get_hashed_set(object_name).put_delete_marker(
            bucket, object_name, version_id, mod_time, metadata)

    # ------------------------------------------------------------------
    # multipart (route by object name)
    # ------------------------------------------------------------------

    def new_multipart_upload(self, bucket, object_name, opts=None,
                             upload_id=None):
        return self.get_hashed_set(object_name).new_multipart_upload(
            bucket, object_name, opts, upload_id=upload_id)

    def put_object_part(self, bucket, object_name, upload_id, part_number,
                        reader, size=-1):
        return self.get_hashed_set(object_name).put_object_part(
            bucket, object_name, upload_id, part_number, reader, size)

    def read_multipart_part(self, bucket, object_name, upload_id,
                            part_number):
        return self.get_hashed_set(object_name).read_multipart_part(
            bucket, object_name, upload_id, part_number)

    def list_object_parts(self, bucket, object_name, upload_id,
                          part_marker=0, max_parts=1000):
        return self.get_hashed_set(object_name).list_object_parts(
            bucket, object_name, upload_id, part_marker, max_parts)

    def list_multipart_uploads(self, bucket, object_name=""):
        if object_name:
            return self.get_hashed_set(object_name).list_multipart_uploads(
                bucket, object_name)
        out = []
        for s in self.sets:
            out.extend(s.list_multipart_uploads(bucket))
        out.sort(key=lambda u: (u["object"], u["upload_id"]))
        return out

    def list_all_multipart_uploads(self):
        out = []
        for s in self.sets:
            out.extend(s.list_all_multipart_uploads())
        out.sort(key=lambda u: (u["bucket"], u["object"],
                                u["upload_id"]))
        return out

    def mark_multipart_session(self, bucket, object_name, upload_id,
                               extra):
        return self.get_hashed_set(object_name).mark_multipart_session(
            bucket, object_name, upload_id, extra)

    def abort_multipart_upload(self, bucket, object_name, upload_id):
        return self.get_hashed_set(object_name).abort_multipart_upload(
            bucket, object_name, upload_id)

    def get_multipart_info(self, bucket, object_name, upload_id):
        return self.get_hashed_set(object_name).get_multipart_info(
            bucket, object_name, upload_id)

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts, version_id="", mod_time=None,
                                  if_none_newer=False):
        return self.get_hashed_set(object_name).complete_multipart_upload(
            bucket, object_name, upload_id, parts, version_id, mod_time,
            if_none_newer)

    # ------------------------------------------------------------------
    # listing (merge across sets; cmd/erasure-sets.go merge walks)
    # ------------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000
                     ) -> tuple[list[ObjectInfo], list[str], bool]:
        per_set = [s.list_objects(bucket, prefix, marker, delimiter,
                                  max_keys)
                   for s in self.sets]
        return merge_listings(per_set, max_keys)

    def list_object_versions(self, bucket, prefix="", marker="",
                             max_keys=1000, version_marker="",
                             delimiter=""):
        per_set = [s.list_object_versions(bucket, prefix, marker,
                                          max_keys, version_marker,
                                          delimiter)
                   for s in self.sets]
        return merge_version_listings(per_set, max_keys)

    def object_versions(self, bucket: str, name: str):
        """Quorum-merged versions of one object (newest first) from the
        set that owns it — the pool-local per-name read of the
        rebalance/metacache feed paths."""
        return self.get_hashed_set(name).object_versions(bucket, name)

    # ------------------------------------------------------------------
    # info / usage
    # ------------------------------------------------------------------

    def storage_info(self) -> dict:
        """Aggregate drive capacity (reference StorageInfo)."""
        total = free = online = offline = 0
        for s in self.sets:
            for d in s.disks:
                if d is None or not d.is_online():
                    offline += 1
                    continue
                try:
                    di = d.disk_info()
                    total += di.total
                    free += di.free
                    online += 1
                except serr.StorageError:
                    offline += 1
        return {"total": total, "free": free, "used": total - free,
                "online_disks": online, "offline_disks": offline,
                "sets": len(self.sets),
                "drives_per_set": len(self.sets[0].disks)}

def merge_version_listings(per_layer: list[tuple], max_keys: int
                           ) -> tuple[list[ObjectInfo], list[str], str,
                                      str, bool]:
    """Merge per-set/per-zone version pages into one `(versions,
    common_prefixes, next_key_marker, next_version_id_marker,
    is_truncated)` page — the single home of the cross-layer version
    paging rules. Duplicate (name, version_id) pairs (one object
    transiently in two pools mid-rebalance) collapse to the first
    layer's copy; order is (name asc, mod_time desc), stable within
    ties; rolled-up prefixes interleave lexically with the keys and
    each count one entry toward max_keys (S3 semantics)."""
    seen: set[tuple[str, str]] = set()
    by_name: dict[str, list[ObjectInfo]] = {}
    prefixes: set[str] = set()
    any_truncated = False
    for versions, pfx, _nkm, _nvm, trunc in per_layer:
        any_truncated = any_truncated or trunc
        prefixes.update(pfx)
        for o in versions:
            key = (o.name, o.version_id)
            if key not in seen:
                seen.add(key)
                by_name.setdefault(o.name, []).append(o)
    # one lexical entry stream: keys (carrying their version lists)
    # interleaved with rolled-up prefixes, like merge_listings
    entries = sorted([(n, False) for n in by_name]
                     + [(p, True) for p in prefixes])
    out_vers: list[ObjectInfo] = []
    out_pfx: list[str] = []
    count = 0
    truncated = any_truncated
    for name, is_pfx in entries:
        if count >= max_keys:
            truncated = True
            break
        if is_pfx:
            out_pfx.append(name)
            count += 1
            continue
        # mod time then version id, newest first — the same
        # deterministic order the engine's quorum merge uses (the
        # active-active conflict rule: two sites holding one version
        # set must page it identically, mod-time ties included)
        vers = sorted(by_name[name],
                      key=lambda o: (o.mod_time or 0, o.version_id or ""),
                      reverse=True)
        for o in vers:
            if count >= max_keys:
                truncated = True
                break
            out_vers.append(o)
            count += 1
    if truncated and (out_vers or out_pfx):
        nkm, nvm = last_version_marker(out_vers, out_pfx)
        return out_vers, out_pfx, nkm, nvm, True
    return out_vers, out_pfx, "", "", truncated


def merge_listings(per_layer: list[tuple[list[ObjectInfo], list[str], bool]],
                   max_keys: int
                   ) -> tuple[list[ObjectInfo], list[str], bool]:
    """Merge per-set/per-zone listing pages into one lexically sorted page
    (the single home of the merge-walk truncation rules)."""
    objects: dict[str, ObjectInfo] = {}
    prefixes: set[str] = set()
    any_truncated = False
    for objs, pfx, trunc in per_layer:
        for o in objs:
            objects.setdefault(o.name, o)
        prefixes.update(pfx)
        any_truncated = any_truncated or trunc
    merged = sorted([(n, False) for n in objects]
                    + [(p, True) for p in prefixes])
    out_objs: list[ObjectInfo] = []
    out_pfx: list[str] = []
    truncated = any_truncated
    for name, is_pfx in merged:
        if len(out_objs) + len(out_pfx) >= max_keys:
            truncated = True
            break
        if is_pfx:
            out_pfx.append(name)
        else:
            out_objs.append(objects[name])
    return out_objs, out_pfx, truncated
