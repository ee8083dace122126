"""Object healing (reference cmd/erasure-healing.go; counterpart of
minio_tpu/object/healing.py).

heal_object: find drives whose copy of an object is missing, stale, or
bitrot-corrupt; rebuild exactly the missing shards from the healthy ones
and commit them to the outdated drives via the same tmp→rename 2-phase
commit as PUT (healObject, cmd/erasure-healing.go:220-489).

Reconstruction uses the *recover matrix* — decode and re-encode collapsed
into one GF(2⁸) matmul producing only the lost shard rows (the device form
of erasure-lowlevel-heal.go's decode→pipe→encode). Blocks are read in
groups of HEAL_BATCH_BLOCKS and every block sharing an erasure pattern
goes through one fused verify+recover+rehash dispatch
(codec.verify_and_recover_batch over models/pipeline.heal_step; the
batch former's ``recover`` verb when the engine has one).

Departure from the reference: minio_tpu/object/healing.py:385-393 catches
any exception of the fused dispatch and rebuilds on the host. Here a
failure on the card raises: the heal fails and the MRF queue retries it.
The host rebuild stays only where a survivor's digest MISMATCHES (bitrot
found): that block is re-read with inline verification and rebuilt on the
host.

Departure from the reference: under a whole-file bitrot algorithm a
healed drive's xl.meta records the digests of its own rebuilt files;
minio_tpu copies another drive's, so the healed shards read as bitrot.

A transitioned zero-data stub heals like a delete marker (reference
:97-105): its data lives in the remote tier, so only the xl.meta is
copied to the drives that miss it, with no dispatch.
"""

from __future__ import annotations

import copy
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import bitrot as bitrot_mod
from ..storage import errors as serr
from ..storage.api import StorageAPI
from ..storage.datatypes import FileInfo, is_restored, is_transitioned
from ..storage.xl_storage import MINIO_META_TMP_BUCKET
from ..utils import knobs
from . import api_errors, bitrot_io, metadata as meta
from .engine import ErasureObjects

HEAL_BATCH_BLOCKS = knobs.get_int("MINIO_TPU_HEAL_BATCH")


@dataclass
class HealResultItem:
    """Summary of one heal operation (madmin HealResultItem shape)."""
    bucket: str = ""
    object: str = ""
    version_id: str = ""
    disks_total: int = 0
    disks_healed: int = 0
    missing_before: int = 0
    missing_after: int = 0
    healed_drives: list[str] = field(default_factory=list)
    dangling_removed: bool = False


class HealMixin(ErasureObjects):
    def heal_bucket(self, bucket: str) -> None:
        """Create the bucket volume on drives that miss it
        (healBucket, cmd/erasure-healing.go)."""
        def mk(i, d):
            try:
                d.stat_vol(bucket)
            except serr.VolumeNotFound:
                d.make_vol(bucket)

        _, errs = meta.for_each_disk(self.disks, mk)
        err = meta.reduce_write_quorum_errs(
            errs, meta.OBJECT_OP_IGNORED_ERRS, len(self.disks) // 2 + 1)
        if err is not None:
            raise api_errors.to_object_err(err, bucket)

    def heal_object(self, bucket: str, object_name: str,
                    version_id: str = "", deep_scan: bool = False,
                    dry_run: bool = False) -> HealResultItem:
        with self.ns.new_lock(f"{bucket}/{object_name}").write_locked():
            return self._heal_object(bucket, object_name, version_id,
                                     deep_scan, dry_run)

    def _heal_object(self, bucket, object_name, version_id, deep_scan,
                     dry_run) -> HealResultItem:
        res = HealResultItem(bucket=bucket, object=object_name,
                             version_id=version_id,
                             disks_total=len(self.disks))
        metas, errs = meta.read_all_file_info(self.disks, bucket,
                                              object_name, version_id)
        # quorum geometry of the latest copy
        try:
            read_quorum, write_quorum = meta.object_quorum_from_meta(
                metas, errs, self.parity_shards)
        except (api_errors.InsufficientReadQuorum, serr.StorageError):
            # maybe dangling (too few copies to ever reconstruct):
            n_meta = sum(1 for fi in metas if fi is not None)
            if 0 < n_meta < len(self.disks) - self.parity_shards:
                self._remove_dangling(bucket, object_name, version_id)
                res.dangling_removed = True
                return res
            raise api_errors.to_object_err(
                api_errors.InsufficientReadQuorum(), bucket,
                object_name) from None

        fi = meta.pick_valid_file_info(metas, read_quorum)
        if fi.deleted or (is_transitioned(fi.metadata)
                          and not is_restored(fi.metadata)):
            # delete markers and transitioned zero-data stubs need only
            # metadata replication (a stub has no local shards)
            missing = [i for i, m in enumerate(metas)
                       if m is None or m.mod_time != fi.mod_time]
            res.missing_before = len(missing)
            if not dry_run and missing:
                for i in missing:
                    d = self.disks[i]
                    if d is None:
                        continue
                    try:
                        d.write_metadata(bucket, object_name,
                                         copy.deepcopy(fi))
                        res.disks_healed += 1
                    except serr.StorageError:
                        pass
                if res.disks_healed == 0:
                    # nothing replicated: fail like the data path does
                    # ('heal wrote no shards') so the MRF queue retries
                    # instead of counting an offline drive as healed
                    raise api_errors.HealFailed(
                        f"{bucket}/{object_name}: "
                        "heal wrote no delete markers")
            res.missing_after = res.missing_before - res.disks_healed
            return res

        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        shuffled = meta.shuffle_disks(self.disks, fi.erasure.distribution)
        smeta = meta.shuffle_parts_metadata(metas, fi.erasure.distribution)

        # classify each shard-slot: healthy (latest meta + parts verify) or
        # outdated (reference disksWithAllParts,
        # cmd/erasure-healing-common.go:158)
        healthy: list[Optional[StorageAPI]] = [None] * len(shuffled)
        outdated: list[Optional[StorageAPI]] = [None] * len(shuffled)
        for i, d in enumerate(shuffled):
            if d is None:
                continue
            fi_i = smeta[i]
            if fi_i is None or fi_i.mod_time != fi.mod_time or \
                    fi_i.data_dir != fi.data_dir:
                outdated[i] = d
                continue
            try:
                d.check_parts(bucket, object_name, fi_i)
                if deep_scan:
                    d.verify_file(bucket, object_name, fi_i)
                healthy[i] = d
            except serr.StorageError:
                outdated[i] = d

        n_healthy = sum(1 for d in healthy if d is not None)
        res.missing_before = len(shuffled) - n_healthy
        if n_healthy < k:
            raise api_errors.InsufficientReadQuorum(
                f"heal: only {n_healthy} healthy shards < k={k}")
        to_heal = [i for i in range(len(shuffled))
                   if outdated[i] is not None]

        # metadata-only divergence: a drive that missed an in-place
        # update_object_metadata (tags/user metadata) still matches on
        # mod_time/data_dir, so the shard classification calls it
        # healthy — converge its xl.meta to the metadata a STRICT
        # majority of healthy copies agree on (quorum metadata writes
        # always leave a majority; an ambiguous split heals nothing)
        meta_stale: list[int] = []
        want_meta: Optional[dict] = None
        fingerprints = [tuple(sorted(smeta[i].metadata.items()))
                        if healthy[i] is not None else None
                        for i in range(len(shuffled))]
        counts: dict[tuple, int] = {}
        for fp in fingerprints:
            if fp is not None:
                counts[fp] = counts.get(fp, 0) + 1
        if len(counts) > 1:
            top = max(counts, key=counts.get)
            if counts[top] > n_healthy // 2:
                want_meta = dict(top)
                meta_stale = [i for i in range(len(shuffled))
                              if fingerprints[i] is not None
                              and fingerprints[i] != top]
                # fi's fingerprint ignores metadata, so the quorum pick
                # may BE a stale copy — rebuilt drives must get the
                # majority metadata, not the stale dict
                fi.metadata = dict(want_meta)
        res.missing_before += len(meta_stale)

        if dry_run:
            res.missing_after = res.missing_before
            return res

        for i in meta_stale:
            f = copy.deepcopy(smeta[i])
            f.metadata = dict(want_meta)
            try:
                shuffled[i].write_metadata(bucket, object_name, f)
                res.disks_healed += 1
            except serr.StorageError:
                pass

        if not to_heal:
            res.missing_after = res.missing_before - res.disks_healed
            if res.missing_after > 0:
                # copies missing on offline slots (or a stale-metadata
                # write failed): nothing more repairable THIS attempt —
                # fail so MRF retries instead of counting a no-op healed
                raise api_errors.HealFailed(
                    f"{bucket}/{object_name}: {res.missing_after} "
                    "copies still missing, no healable drive online")
            return res

        tmp_id = str(_uuid.uuid4())
        codec = self.codec(k, m)
        try:
            written, file_digests = self._reconstruct_shards(
                bucket, object_name, fi, healthy, smeta, to_heal,
                shuffled, tmp_id, codec)
            # write healed xl.meta + rename into place — only on drives
            # whose shard files were fully written (a writer that failed
            # mid-stream must not get committing metadata)
            heal_fi = copy.deepcopy(fi)
            for i in to_heal:
                d = shuffled[i]
                if d is None or i not in written:
                    continue
                f = copy.deepcopy(heal_fi)
                f.erasure.index = i + 1
                if not self.bitrot_algo.streaming:
                    # the rebuilt files' own whole-file digests (the
                    # reference keeps another drive's)
                    for c in f.erasure.checksums:
                        c.hash = file_digests.get((i, c.part_number), b"")
                try:
                    # a wiped drive may have lost the bucket dir itself —
                    # recreate it before renaming in (reference heals the
                    # bucket before the object, cmd/erasure-healing.go
                    # healBucket)
                    try:
                        d.make_vol(bucket)
                    except serr.VolumeExists:
                        pass
                    d.write_metadata(MINIO_META_TMP_BUCKET, tmp_id, f)
                    d.rename_data(MINIO_META_TMP_BUCKET, tmp_id,
                                  fi.data_dir, bucket, object_name)
                    res.disks_healed += 1
                    res.healed_drives.append(str(d))
                except serr.StorageError:
                    pass
        finally:
            self._cleanup_tmp(shuffled, tmp_id)

        if res.disks_healed == 0:
            # nothing was actually repaired: surface it so callers (MRF
            # queue, admin heal) retry instead of counting it healed —
            # the reference heals with write quorum 1, so zero successes
            # is a failure (cmd/erasure-lowlevel-heal.go:28). Raised as
            # an ObjectApiError so per-object sweep handlers skip, not
            # abort, the pass.
            raise api_errors.HealFailed(
                f"{bucket}/{object_name}: heal wrote no shards")
        res.missing_after = res.missing_before - res.disks_healed
        return res

    def _reconstruct_shards(self, bucket, object_name, fi: FileInfo,
                            healthy, smeta, to_heal, shuffled, tmp_id,
                            codec) -> tuple[set[int], dict]:
        """Per part: batched recover-matrix matmul over all blocks,
        streaming results into bitrot writers for the outdated drives.
        Returns the indices whose shard files were fully written — a
        writer that errors (drive died again mid-heal) is dropped, not
        fatal (the reference heals with write quorum 1,
        cmd/erasure-lowlevel-heal.go:28) — and each written file's
        digest by (index, part number): the whole-file digest under a
        whole-file algorithm, else b""."""
        n = len(shuffled)
        k = fi.erasure.data_blocks
        shard_size = fi.erasure.shard_size()
        written = set(to_heal)
        file_digests: dict[tuple[int, int], bytes] = {}

        def drop(i: int, writers: dict) -> None:
            written.discard(i)
            w = writers.pop(i, None)
            if w is not None:
                try:
                    w.close()
                except serr.StorageError:
                    pass

        for part in fi.parts:
            if part.size == 0:
                # empty part: just create the empty framed file
                for i in to_heal:
                    d = shuffled[i]
                    if d is not None and i in written:
                        try:
                            w = bitrot_io.new_bitrot_writer(
                                d, MINIO_META_TMP_BUCKET,
                                f"{tmp_id}/{fi.data_dir}/part.{part.number}",
                                -1, self.bitrot_algo, shard_size)
                            w.close()
                            file_digests[(i, part.number)] = w.digest()
                        except serr.StorageError:
                            written.discard(i)
                continue
            path = f"{object_name}/{fi.data_dir}/part.{part.number}"
            till = fi.erasure.shard_file_offset(0, part.size, part.size)
            readers: list[Optional[object]] = [None] * n
            for i, d in enumerate(healthy):
                if d is None:
                    continue
                csum = smeta[i].erasure.get_checksum_info(part.number)
                algo = (bitrot_mod.BitrotAlgorithm.from_string(
                    csum.algorithm) if csum else self.bitrot_algo)
                readers[i] = bitrot_io.new_bitrot_reader(
                    d, bucket, path, till, algo,
                    csum.hash if csum else b"", shard_size)
            writers: dict[int, object] = {}
            for i in to_heal:
                d = shuffled[i]
                if d is None or i not in written:
                    continue
                try:
                    writers[i] = bitrot_io.new_bitrot_writer(
                        d, MINIO_META_TMP_BUCKET,
                        f"{tmp_id}/{fi.data_dir}/part.{part.number}",
                        -1, self.bitrot_algo, shard_size)
                except serr.StorageError:
                    written.discard(i)

            from ..ops import rs_matrix
            # device-routed heals defer survivor verification into the
            # fused verify+recover+rehash program (pipeline.heal_step);
            # CPU-routed heals verify inline at read time as before.
            # Deferral needs every reader on ONE streaming device-kernel
            # algorithm (the frames' own algorithm, which may differ
            # from the server's current bitrot config).
            algos = {r.algo for r in readers if r is not None}
            part_algo = algos.pop() if len(algos) == 1 else None
            defer_verify = (
                part_algo is not None and part_algo.streaming
                and codec._device_hash_kernel(part_algo) is not None
                and codec._route(HEAL_BATCH_BLOCKS * k * shard_size)
                == "device")
            verify_algo = part_algo or self.bitrot_algo
            n_blocks = -(-part.size // fi.erasure.block_size)
            bn = 0
            while bn < n_blocks:
                ge = min(bn + HEAL_BATCH_BLOCKS, n_blocks)
                group = []
                for b in range(bn, ge):
                    block_len = min(fi.erasure.block_size,
                                    part.size - b * fi.erasure.block_size)
                    shard_len = -(-block_len // k)
                    shards, digests, _ = self._read_block_shards_raw(
                        readers, b, shard_size, shard_len, k, n,
                        collect_digests=defer_verify)
                    group.append((b, shard_len, shards, digests))
                # rebuild exactly the writer rows, batched per erasure
                # pattern: many blocks -> ONE fused device program
                # (verify survivors + recover rows + digest the rebuilt
                # shards for their new bitrot frames), or one host
                # recover matmul when CPU-routed
                rebuilt: dict[int, dict[int, tuple]] = {}
                buckets: dict[tuple[int, int], list[int]] = {}
                for gi, (_b, sl, shards, _dg) in enumerate(group):
                    mask = sum(1 << i for i in range(n)
                               if shards[i] is not None)
                    buckets.setdefault((mask, sl), []).append(gi)
                # submit every bucket's fused dispatch before resolving
                # any: each bucket's grace window then overlaps
                # same-pattern buckets from concurrent heals/GETs on
                # the shared former (same key -> one fused launch)
                staged: list[tuple] = []
                for (mask, sl), gis in buckets.items():
                    _, used, _missing = rs_matrix.recover_matrix(
                        k, self.parity_shards, mask)
                    stacked = np.stack([
                        np.stack([group[gi][2][u] for u in used])
                        for gi in gis])
                    # fuse hashing only when digests were deferred;
                    # inline-verified survivors need just the matmul
                    want_fused = any(group[gi][3][u] is not None
                                     for gi in gis for u in used)
                    fut = None
                    if want_fused and self.scheduler is not None:
                        fut = self.scheduler.submit_recover(
                            codec, stacked, mask, set(writers.keys()),
                            sl, verify_algo)
                    staged.append((mask, sl, gis, used, stacked,
                                   want_fused, fut))
                for mask, sl, gis, used, stacked, want_fused, fut \
                        in staged:
                    if fut is not None:
                        # a dispatch failure on the card raises: the
                        # heal fails and the MRF queue retries it
                        fused = fut.result()
                    elif want_fused:
                        fused = codec.verify_and_recover_batch(
                            stacked, mask, set(writers.keys()), sl,
                            verify_algo)
                    else:
                        fused = None
                    if fused is not None:
                        out, idxs, sdig, odig = fused
                        for row_i, gi in enumerate(gis):
                            digests = group[gi][3]
                            bad = False
                            for col, u in enumerate(used):
                                exp = digests[u]
                                if exp is None:
                                    continue
                                if sdig[row_i, col].tobytes() != exp:
                                    readers[u] = None
                                    group[gi][2][u] = None
                                    bad = True
                                else:
                                    digests[u] = None  # verified
                            if bad:
                                rebuilt[gi] = None  # host rebuild below
                            else:
                                rebuilt[gi] = {
                                    idx: (out[row_i][r],
                                          odig[row_i][r].tobytes())
                                    for r, idx in enumerate(idxs)}
                    else:
                        # deferred digests stay set: the host batch
                        # verify below still covers these survivors —
                        # a declined fused bucket must NOT skip
                        # verification (else bitrot would be laundered
                        # into freshly-digested healed shards)
                        out, idxs = codec.recover_stacked(
                            stacked, mask, set(writers.keys()))
                        for row_i, gi in enumerate(gis):
                            rebuilt[gi] = {idx: (out[row_i][r], None)
                                           for r, idx in enumerate(idxs)}

                # host batch verify of every survivor the fused program
                # didn't cover (declined buckets, hedged extras)
                pend: dict[int, list[tuple[int, int]]] = {}
                for gi, (_b, _sl, shards, digests) in enumerate(group):
                    for i in range(n):
                        if digests[i] is not None and \
                                shards[i] is not None:
                            pend.setdefault(
                                len(shards[i]), []).append((gi, i))
                for _sl, items in pend.items():
                    stacked = np.stack(
                        [group[gi][2][i] for gi, i in items])
                    got = bitrot_mod.hash_shards_batch(stacked,
                                                       verify_algo)
                    for row, (gi, i) in enumerate(items):
                        if got[row].tobytes() != group[gi][3][i]:
                            readers[i] = None
                            group[gi][2][i] = None
                            rebuilt[gi] = None  # host rebuild below
                        else:
                            group[gi][3][i] = None

                # corrupt survivor found after deferral: re-read the
                # block with inline verification and rebuild on host
                for gi in range(len(group)):
                    if rebuilt.get(gi, {}) is None:
                        rebuilt[gi] = self._host_rebuild_block(
                            readers, codec, group[gi][0], shard_size,
                            group[gi][1], k, n, set(writers.keys()))

                for gi, (_b, shard_len, shards, _dg) in enumerate(group):
                    rows = rebuilt.get(gi, {})
                    for i, w in list(writers.items()):
                        src, dg = rows.get(i, (None, None))
                        if src is None and shards[i] is not None:
                            src = shards[i]   # shard readable elsewhere
                        if src is None:
                            drop(i, writers)
                            continue
                        try:
                            block = np.ascontiguousarray(
                                src[:shard_len]).tobytes()
                            # a precomputed frame digest is only valid
                            # when the writer frames use the same
                            # algorithm it was computed with
                            if dg is not None and \
                                    self.bitrot_algo.streaming and \
                                    verify_algo == self.bitrot_algo:
                                w.write_with_digest(block, dg)
                            else:
                                w.write(block)
                        except serr.StorageError:
                            drop(i, writers)
                bn = ge
            for r in readers:
                if r is not None:
                    r.close()
            for i, w in list(writers.items()):
                try:
                    w.close()
                    file_digests[(i, part.number)] = w.digest()
                except serr.StorageError:
                    drop(i, writers)
        return written, file_digests

    def _host_rebuild_block(self, readers, codec, block_num: int,
                            shard_size: int, shard_len: int, k: int,
                            n: int, rows: set[int]) -> dict:
        """Rare path after a deferred-verify digest mismatch: the corrupt
        reader is already dead, so re-read the block with inline
        verification and rebuild the requested rows on host. Returns
        {shard_idx: (array, None)} (no precomputed frame digest)."""
        shards, _digests, _he = self._read_block_shards_raw(
            readers, block_num, shard_size, shard_len, k, n)
        full = codec.reconstruct(shards, rows=set(rows))
        return {i: (full[i], None) for i in rows
                if i < len(full) and full[i] is not None}

    def _remove_dangling(self, bucket, object_name, version_id) -> None:
        """Too few copies survive to ever reconstruct: purge the remnants
        (reference dangling-object GC, cmd/erasure-healing.go:311-325)."""
        fi = FileInfo(volume=bucket, name=object_name,
                      version_id=version_id)

        def rm(i, d):
            try:
                d.delete_version(bucket, object_name, fi)
            except serr.StorageError:
                pass

        meta.for_each_disk(self.disks, rm)
