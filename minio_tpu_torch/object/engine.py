"""ErasureObjects — object CRUD on one erasure set.

The per-set object engine (reference erasureObjects, cmd/erasure-object.go
+ cmd/erasure.go; counterpart of minio_tpu/object/engine.py): N = k+m
drives, every object's shards distributed by hashOrder, xl.meta written to
all drives, quorum-checked reads and writes, 2-phase commit through
.minio.sys/tmp.

The PUT hot loop batches up to ENCODE_BATCH_BLOCKS full blocks and
encodes and digests them in one fused device step (models/pipeline.put_step)
when the batch passes the codec's size gate. Two forms
(MINIO_TPU_PIPELINE, default on): the pipelined loop
(_encode_stream_pipelined, minio_tpu/object/engine.py:414-636) overlaps
ingest, encode+digest and shard writes across a ring of staging buffers
that are pinned host memory on a CUDA engine, so the object is read
straight into memory the card copies from asynchronously; the serial loop
runs them in turn. With a batch former (parallel/scheduler.py) concurrent
PUTs, degraded GETs and heals share fused device dispatches.

Degraded GETs read GET_BATCH_BLOCKS blocks per group, with a one-group
lookahead that reads group N+1 (across part boundaries) while group N
verifies and decodes, and verify + reconstruct every block sharing an
erasure pattern in one fused device step (get_step); healthy blocks
verify on the host. A failure of a fused device dispatch raises to the
caller: no path retries it on the host.

MRF hooks: on_degraded_write(bucket, object, version_id) fires when a
write met quorum but some drives missed it; on_degraded_read(bucket,
object) when a GET had to reconstruct or found bitrot.

Whole-file bitrot algorithms (sha256, blake2b, highwayhash256) store one
digest per drive in that drive's xl.meta: the commit takes each writer's
digest, and readers verify the whole shard file against it.

SSE (PutOptions.sse_spec, a features/crypto.DeviceSSE): the reader carries
PLAINTEXT and each batch of full blocks is ciphered, encoded and digested
in one fused device step (models/pipeline.sse_put_step); the host tags the
returned ciphertext and appends the Poly1305 trailer at stream end. A
batch the codec's size gate keeps on the host is ciphered there; a failed
dispatch raises (the reference ciphers that batch on the host instead).

Every successful namespace mutation (PUT, metadata update, delete,
delete marker, bulk delete, multipart commit) reports (bucket, object) on
``on_namespace_change`` (hidden buckets skipped), the feed of the bucket
metacache and of the read cache's invalidation (object/server_sets.py).
Every read stream through the shard-read/verify/decode path counts on
``minio_tpu_erasure_get_streams_total`` (the read cache's hits do not).

Tier transitions (reference :1021-1160): ``transition_object`` rewrites
one version's xl.meta into a zero-data stub carrying the tier name and
remote key, and frees the local shards once the stub is at write quorum;
``put_stub_version`` writes such a stub from its ObjectInfo. A GET of a
stub with no restored copy answers InvalidObjectState.

A request's tree holds the reference's spans: ``engine.put_object``,
``pipeline.encode`` (with the batch former's ``sched.dispatch`` under it),
``pipeline.shard_write``, ``disk.shard_write``, ``engine.get_object``
(a ``traced_iter``, never current across a yield), ``pipeline.read_group``,
``disk.shard_read`` and ``pipeline.verify_decode``.

The gray-failure plane (utils/healthtrack.py): GET shard reads race a
spare read against a reader past the adaptive hedge deadline or one that
failed, avoid suspect drives capacity permitting, and reconstruct the
shards the plan skipped without flagging a heal; PUT shard writes and the
commit's close, meta and rename fan-outs ack at write quorum and abandon
laggards past the write-stall grace to MRF.
"""

from __future__ import annotations

import contextlib
import copy
import heapq
import io
import threading
import time
import uuid as _uuid
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import wait as _fwait
from typing import Iterator, Optional

import numpy as np

from .. import bitrot as bitrot_mod
from .. import device as device_mod
from ..storage import errors as serr
from ..storage.api import StorageAPI
from ..storage.datatypes import (BLOCK_SIZE_V1, RESTORE_EXPIRY_KEY,
                                 RESTORE_KEY, TRANSITION_COMPLETE,
                                 TRANSITION_STATUS_KEY, TRANSITION_TIER_KEY,
                                 TRANSITIONED_OBJECT_KEY,
                                 TRANSITIONED_VERSION_KEY, ChecksumInfo,
                                 FileInfo, ObjectInfo, is_restored,
                                 is_transitioned, last_version_marker,
                                 new_file_info, now)
from ..storage.format import (FormatErasureV3, get_format_in_quorum,
                              new_format_erasure_v3, read_format_from,
                              write_format_to)
from ..storage.xl_storage import (MINIO_META_BUCKET, MINIO_META_TMP_BUCKET,
                                  XLStorage)
from ..utils import crashpoint, healthtrack, knobs, stagetimer, telemetry
from . import api_errors, bitrot_io, metadata as meta
from .codec import Codec
from .hash_reader import HashReader
from .nslock import NSLockMap

# blocks fused per PUT encode+digest step / per GET verify+decode step
ENCODE_BATCH_BLOCKS = knobs.get_int("MINIO_TPU_ENCODE_BATCH")
GET_BATCH_BLOCKS = knobs.get_int("MINIO_TPU_GET_BATCH")

# Reserved bucket names an S3 client can't touch.
RESERVED_BUCKETS = (MINIO_META_BUCKET,)


GET_STREAMS = telemetry.REGISTRY.counter(
    "minio_tpu_erasure_get_streams_total",
    "Object read streams served through the erasure "
    "shard-read/verify/decode path")


def _sse_pkg() -> int:
    """features/crypto.PKG_SIZE, imported at call time: crypto imports
    this package's hash reader."""
    from ..features.crypto import PKG_SIZE
    return PKG_SIZE


class PutOptions:
    def __init__(self, metadata: Optional[dict] = None,
                 version_id: str = "", versioned: bool = False,
                 parity: Optional[int] = None,
                 mod_time: Optional[float] = None,
                 if_none_newer: bool = False, sse_spec=None):
        self.metadata = dict(metadata or {})
        self.version_id = version_id
        self.versioned = versioned
        # parity shards of this object (default: the set's)
        self.parity = parity
        # explicit mod time (server-side copies keep the original
        # Last-Modified instead of stamping the copy time)
        self.mod_time = mod_time
        # commit only when no existing version of the same slot is
        # (mod_time, version_id, etag)-newer, evaluated inside the
        # per-key write lock (the replication apply's last-writer-wins)
        self.if_none_newer = if_none_newer
        # features/crypto.DeviceSSE for the fused cipher+encode+digest
        # PUT: the reader then carries PLAINTEXT and the engine ciphers
        # in-batch, appending the Poly1305 tag trailer at stream end
        # (None: any cipher ran as a reader transform)
        self.sse_spec = sse_spec


class GetOptions:
    def __init__(self, version_id: str = ""):
        self.version_id = version_id


class ErasureObjects:
    """One erasure set over `disks` (k data + m parity).

    device: where the fused steps run; None means the card ("cuda"), and
    raises when there is none. Tests pass "cpu". scheduler: an optional
    cross-request batch former (parallel/scheduler.BatchScheduler)."""

    def __init__(self, disks: list[Optional[StorageAPI]],
                 data_shards: int, parity_shards: int,
                 block_size: int = BLOCK_SIZE_V1,
                 ns_lock: Optional[NSLockMap] = None,
                 bitrot_algo: bitrot_mod.BitrotAlgorithm =
                 bitrot_mod.DEFAULT_BITROT_ALGORITHM,
                 set_index: int = 0, device=None, scheduler=None):
        if len(disks) != data_shards + parity_shards:
            raise ValueError(f"{len(disks)} drives for "
                             f"{data_shards}+{parity_shards}")
        self.disks = disks
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.block_size = block_size
        self.bitrot_algo = bitrot_algo
        self.ns = ns_lock or NSLockMap()
        self.set_index = set_index
        self.device = device_mod.resolve(device)
        self.scheduler = scheduler
        self._codec_cache: dict[tuple[int, int], Codec] = {}
        self._codec_mu = threading.Lock()
        # MRF hooks (reference :126-147): called (bucket, object) when a
        # GET had to reconstruct or hit bitrot, and (bucket, object,
        # version_id) when a write met quorum but some drives missed it
        self.on_degraded_read = None
        self.on_degraded_write = None
        # namespace hook (reference :149-153): called (bucket, object)
        # after every successful namespace mutation; the receiver only
        # appends to a bounded journal and never blocks
        self.on_namespace_change = None

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def codec(self, k: int, m: int) -> Codec:
        with self._codec_mu:
            c = self._codec_cache.get((k, m))
            if c is None:
                c = self._codec_cache[(k, m)] = Codec(
                    k, m, self.block_size, device=self.device)
            return c

    @property
    def supports_sse_device(self) -> bool:
        """Whether this set can run the fused cipher+encode+digest PUT
        (PutOptions.sse_spec): the package stream must tile the erasure
        blocks exactly, so full blocks carry whole ChaCha20 packages."""
        return self.block_size % _sse_pkg() == 0

    def _default_quorums(self, parity: Optional[int] = None
                         ) -> tuple[int, int, int, int]:
        """(data, parity, readQuorum, writeQuorum) for a fresh object
        (cmd/erasure-object.go:536-547)."""
        m = self.parity_shards if parity is None else parity
        k = len(self.disks) - m
        return k, m, k, meta.write_quorum_for(k, m)

    # ------------------------------------------------------------------
    # bucket ops (cmd/erasure-bucket.go)
    # ------------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        if bucket in RESERVED_BUCKETS or not bucket:
            raise api_errors.BucketNameInvalid(bucket)
        _, errs = meta.for_each_disk(
            self.disks, lambda i, d: d.make_vol(bucket))
        write_quorum = len(self.disks) // 2 + 1
        exists = sum(1 for e in errs if isinstance(e, serr.VolumeExists))
        if exists >= write_quorum:
            raise api_errors.BucketExists(bucket)
        ok = sum(1 for e in errs
                 if e is None or isinstance(e, serr.VolumeExists))
        if ok < write_quorum:
            err = meta.reduce_write_quorum_errs(
                errs, meta.OBJECT_OP_IGNORED_ERRS + (serr.VolumeExists,),
                write_quorum)
            raise api_errors.to_object_err(
                err or api_errors.InsufficientWriteQuorum(), bucket)

    def bucket_exists(self, bucket: str) -> bool:
        try:
            self.get_bucket_info(bucket)
            return True
        except api_errors.BucketNotFound:
            return False

    def get_bucket_info(self, bucket: str):
        results, errs = meta.for_each_disk(
            self.disks, lambda i, d: d.stat_vol(bucket))
        read_quorum = len(self.disks) // 2
        err = meta.reduce_read_quorum_errs(
            errs, meta.OBJECT_OP_IGNORED_ERRS, read_quorum)
        if err is not None:
            raise api_errors.to_object_err(err, bucket)
        for r in results:
            if r is not None:
                return r
        raise api_errors.BucketNotFound(bucket)

    def list_buckets(self):
        """Quorum-merged bucket listing: a bucket counts when at least
        read quorum (n//2) of the answering drives hold its volume, so a
        drive that missed a make_bucket or kept a deleted bucket while
        offline can neither hide nor resurrect it."""
        counts: dict[str, int] = {}
        infos: dict[str, object] = {}
        answered = 0
        for d in self.disks:
            if d is None:
                continue
            try:
                vols = d.list_vols()
            except serr.StorageError:
                continue
            answered += 1
            for v in vols:
                if v.name.startswith("."):
                    continue
                counts[v.name] = counts.get(v.name, 0) + 1
                prev = infos.get(v.name)
                if prev is None or v.created < prev.created:
                    infos[v.name] = v
        if answered == 0:
            return []
        quorum = min(answered, max(1, len(self.disks) // 2))
        return sorted((infos[n] for n, c in counts.items()
                       if c >= quorum), key=lambda v: v.name)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        def rm(i, d):
            try:
                d.delete_vol(bucket, force)
            except serr.VolumeNotFound:
                pass

        _, errs = meta.for_each_disk(self.disks, rm)
        write_quorum = len(self.disks) // 2 + 1
        err = meta.reduce_write_quorum_errs(
            errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
        if err is not None:
            raise api_errors.to_object_err(err, bucket)

    # ------------------------------------------------------------------
    # PUT (cmd/erasure-object.go:521-703 + cmd/erasure-encode.go)
    # ------------------------------------------------------------------

    def put_object(self, bucket: str, object_name: str, reader,
                   size: int = -1, opts: Optional[PutOptions] = None
                   ) -> ObjectInfo:
        with telemetry.span("engine.put_object", bucket=bucket,
                            object=object_name, size=size):
            return self._put_object(bucket, object_name, reader, size,
                                    opts)

    def _put_object(self, bucket: str, object_name: str, reader,
                    size: int = -1, opts: Optional[PutOptions] = None
                    ) -> ObjectInfo:
        opts = opts or PutOptions()
        if isinstance(reader, (bytes, bytearray)):
            size = len(reader)
            reader = HashReader(io.BytesIO(reader), size)
        elif not isinstance(reader, HashReader):
            reader = HashReader(reader, size)

        k, m, _, write_quorum = self._default_quorums(opts.parity)
        fi = new_file_info(f"{bucket}/{object_name}", k, m)
        fi.erasure.block_size = self.block_size
        fi.volume, fi.name = bucket, object_name
        fi.data_dir = str(_uuid.uuid4())
        if opts.versioned:
            fi.version_id = opts.version_id or str(_uuid.uuid4())

        shuffled = meta.shuffle_disks(self.disks, fi.erasure.distribution)
        tmp_id = str(_uuid.uuid4())
        part_path = f"{tmp_id}/{fi.data_dir}/part.1"
        codec = self.codec(k, m)
        writers: list = [
            None if d is None else bitrot_io.new_bitrot_writer(
                d, MINIO_META_TMP_BUCKET, part_path, -1, self.bitrot_algo,
                codec.shard_size)
            for d in shuffled]

        try:
            try:
                total = self._encode_stream(reader, codec, writers,
                                            write_quorum, sse=opts.sse_spec)
                with stagetimer.stage("put.hash_verify"):
                    reader.verify()
            finally:
                reader.close()  # stop the async hasher even on failure
            etag = opts.metadata.pop("etag", "") or reader.md5_current_hex()

            fi.size = total
            fi.mod_time = opts.mod_time if opts.mod_time else now()
            fi.metadata = dict(opts.metadata)
            fi.metadata["etag"] = etag
            fi.add_object_part(1, etag, total,
                               reader.actual_size
                               if reader.actual_size >= 0 else total)
            fi.erasure.checksums = [
                ChecksumInfo(1, self.bitrot_algo.value, b"")]
            with stagetimer.stage("put.lock+commit"):
                with self.ns.new_lock(
                        f"{bucket}/{object_name}").write_locked():
                    if opts.if_none_newer:
                        self._check_none_newer(bucket, object_name, fi)
                    lost = self._commit(shuffled, writers, tmp_id, fi,
                                        bucket, object_name, write_quorum)
        except Exception:
            self._cleanup_tmp(shuffled, tmp_id)
            raise
        if lost:
            # quorum met but some drives missed the write: queue an MRF
            # heal so the object converges back to full redundancy
            self._notify_degraded(bucket, object_name, fi.version_id)
        self._notify_namespace(bucket, object_name)
        return fi.to_object_info(bucket, object_name)

    def _check_none_newer(self, bucket: str, object_name: str,
                          fi: FileInfo) -> None:
        """The if_none_newer commit gate (caller holds the write lock):
        an existing version of the same slot that wins the
        (mod_time, version_id, etag) order aborts the commit."""
        for cur in self._merged_versions(bucket, object_name):
            if (cur.version_id or "") != (fi.version_id or ""):
                continue
            cur_key = (cur.mod_time or 0, cur.version_id or "",
                       cur.metadata.get("etag", ""))
            new_key = (fi.mod_time or 0, fi.version_id or "",
                       fi.metadata.get("etag", ""))
            if cur_key >= new_key:
                raise api_errors.PreConditionFailed(
                    f"{bucket}/{object_name}: existing version is newer")
            return

    def _encode_stream(self, reader, codec: Codec, writers,
                       write_quorum: int, sse=None) -> int:
        """The PUT hot loop: read blocks, batch-encode, batch-hash,
        fan-out framed writes. Returns total bytes. Streams that fit in
        ONE encode batch stay serial even with the pipeline on: a single
        batch has nothing to overlap.

        With `sse` (a features/crypto.DeviceSSE) the reader carries
        PLAINTEXT: full blocks are ciphered in their encode dispatch, the
        short tail on the host, the Poly1305 tag trailer (computed on the
        host over the ciphertext) lands at stream end, and the returned
        total is the STORED size (ciphertext + trailer)."""
        from ..parallel import pipeline as pl
        size = getattr(reader, "size", -1)
        if pl.ENABLED and (size < 0
                           or size > ENCODE_BATCH_BLOCKS * self.block_size):
            return self._encode_stream_pipelined(reader, codec, writers,
                                                 write_quorum, sse)
        return self._encode_stream_serial(reader, codec, writers,
                                          write_quorum, sse)

    def _encode_stream_pipelined(self, reader, codec: Codec, writers,
                                 write_quorum: int, sse=None) -> int:
        """The PUT hot loop, overlapped (reference :414-636): a ring of
        BytePool-backed (B, k*S) staging buffers, pinned on a CUDA
        engine, carries three concurrent stages —

          * this thread reads batch N+1 straight into a ring buffer (and
            submits its fused dispatch to the batch former, when there is
            one, without waiting for it),
          * the encode stage resolves batch N's encode+digest,
          * the write stage fans batch N-1's framed shard writes out, then
            returns its buffer to the ring.

        Bounded stage queues and the shared ring are the memory bound.
        Same bytes on disk as the serial loop: the pad tail
        [block_size:k*S] of every row is re-zeroed each time a buffer is
        taken from the ring. The stage threads start on the FIRST full
        batch, so a stream that fits one batch encodes inline."""
        from ..parallel import pipeline as pl
        k, s_len = codec.k, codec.shard_size
        bs = self.block_size
        cap = ENCODE_BATCH_BLOCKS
        known_size = getattr(reader, "size", -1)
        pool = pl.staging_pool(cap * k * s_len,
                               pinned=self.device.type == "cuda")
        # per-stage wall seconds [ingest, encode, write]; each slot is
        # written by exactly one thread
        stage_s = [0.0, 0.0, 0.0]
        batches = 0
        t_start = time.perf_counter()

        def recycle(item) -> None:
            buf = item.get("buf")
            if buf is not None:
                item["buf"] = None
                pool.put(buf)

        def encode_stage(item):
            t0 = time.perf_counter()
            fut, data = item.get("fut"), item.get("data")
            # the SSE stream end ciphers its tail on the host: no encode
            span = contextlib.nullcontext() if "sse_finish" in item else \
                telemetry.span("pipeline.encode", blocks=data.shape[0])
            with stagetimer.stage("put.encode+digest"), span:
                if "sse_finish" in item:
                    # stream end under SSE: runs on this FIFO stage, so
                    # every earlier batch has been absorbed
                    item["rows_multi"] = self._sse_finish_rows(
                        codec, sse, item["tail"], item["sse_finish"])
                elif sse is not None:
                    item["rows"] = self._sse_encode(codec, data, item, fut,
                                                    sse)
                else:
                    fused = fut.result() if fut is not None else \
                        codec.encode_and_hash_batch(data, self.bitrot_algo)
                    item["rows"] = self._unpack_fused(codec, data, fused)
            stage_s[1] += time.perf_counter() - t0
            return item

        def write_stage(item):
            t0 = time.perf_counter()
            try:
                with stagetimer.stage("put.shard_write"), \
                        telemetry.span("pipeline.shard_write"):
                    for rows in item.get("rows_multi", [item.get("rows")]):
                        self._write_shards_batch(*rows, writers,
                                                 write_quorum)
            finally:
                recycle(item)
                stage_s[2] += time.perf_counter() - t0

        pipe = None

        def feed(data) -> None:
            """Hand the CURRENT buffer (if any) plus `data` to the
            pipeline, starting the stage threads on first use. Buffer
            ownership moves to the item BEFORE submit: if submit raises
            a pending stage error, on_drop recycles the item's buffer and
            the caller's finally must not recycle it again."""
            nonlocal batches, buf, pipe, enc_off
            if pipe is None:
                pipe = pl.StagePipeline([encode_stage, write_stage],
                                        depth=pl.DEPTH, name="put-pipe",
                                        on_drop=recycle)
            owned, buf = buf, None
            item = {"buf": owned, "data": data}
            if sse is not None:
                item["sse_kn"] = sse.batch_params(enc_off, data.shape[0], bs)
                item["sse_off"] = enc_off
                enc_off += data.shape[0] * bs
            item["fut"] = self._submit_encode(codec, data, item)
            pipe.submit(item)
            batches += 1

        def acquire():
            t0 = time.perf_counter()
            b = pool.get(timeout=pl.POOL_TIMEOUT_S)
            stage_s[0] += time.perf_counter() - t0
            a = b.reshape(cap, k * s_len)
            if k * s_len > bs:
                # a reused buffer: the pad tail must read as zeros for
                # klauspost-identical shards
                a[:, bs:] = 0
            return b, a

        total = 0
        buf = None
        enc_off = 0       # plaintext stream offset of the next sse batch
        tail_pt = b""     # short last block (plaintext) under sse
        try:
            buf, arr = acquire()
            nb = 0
            while True:
                t0 = time.perf_counter()
                with stagetimer.stage("put.read_stream"):
                    n = _read_full_into(reader, arr[nb][:bs])
                stage_s[0] += time.perf_counter() - t0
                if n == 0:
                    break
                total += n
                if n == bs:
                    nb += 1
                    if nb == cap:
                        feed(arr[:nb].reshape(nb, k, s_len))
                        nb = 0
                        if 0 <= known_size == total:
                            # exact batch multiple: EOF is certain, so
                            # take no buffer the stream never fills
                            break
                        buf, arr = acquire()
                elif sse is not None:
                    # short last block under SSE: it joins the tag
                    # trailer in the finish batches, after the pending
                    # full rows
                    tail_pt = bytes(arr[nb][:n])
                    break
                else:
                    # short last block: its shard length differs — flush
                    # the pending full rows first, then the short block
                    # alone (split copies it out of the ring)
                    with stagetimer.stage("put.split"):
                        data = codec.split(arr[nb][:n])[None, ...]
                    if pipe is None:
                        if nb:
                            self._encode_write(
                                codec, arr[:nb].reshape(nb, k, s_len),
                                writers, write_quorum)
                        self._encode_write(codec, data, writers,
                                           write_quorum)
                    else:
                        if nb:
                            feed(arr[:nb].reshape(nb, k, s_len))
                        feed(data)
                    nb = 0
                    break
            if nb:
                if pipe is None:
                    self._encode_write(codec,
                                       arr[:nb].reshape(nb, k, s_len),
                                       writers, write_quorum, sse, enc_off)
                    enc_off += nb * bs
                else:
                    feed(arr[:nb].reshape(nb, k, s_len))
            if sse is not None:
                if pipe is None:
                    for rows in self._sse_finish_rows(codec, sse, tail_pt,
                                                      enc_off):
                        self._write_shards_batch(*rows, writers,
                                                 write_quorum)
                else:
                    pipe.submit({"sse_finish": enc_off, "tail": tail_pt})
            if pipe is not None:
                pipe.close()    # join; re-raises the first stage error
        except BaseException:
            if pipe is not None:
                pipe.close(abort=True)
            raise
        finally:
            if buf is not None:
                pool.put(buf)
        if pipe is not None:
            wall = time.perf_counter() - t_start
            pl.STATS.record_put(wall, sum(stage_s), batches)
            stagetimer.add_overlap("put.pipeline", wall, sum(stage_s))
        return total if sse is None else _encrypted_size(total)

    def _encode_stream_serial(self, reader, codec: Codec, writers,
                              write_quorum: int, sse=None) -> int:
        """The serial PUT loop (MINIO_TPU_PIPELINE=off, and streams of one
        batch): blocks are read straight into a padded (B, k*S) buffer so
        the shard split is a reshape VIEW, the data shards are written
        from that same buffer, and only parity is newly allocated.
        Returns total bytes."""
        total = 0
        k, s_len = codec.k, codec.shard_size
        bs = self.block_size
        cap = ENCODE_BATCH_BLOCKS
        # zero-initialized: the pad tail (k*S - block_size bytes) must
        # read as zeros for klauspost-identical shard bytes, and full
        # blocks never write into it
        buf = np.zeros((cap, k * s_len), dtype=np.uint8)
        nb = 0
        enc_off = 0
        tail_pt = b""

        def flush_full(n_rows: int) -> None:
            nonlocal enc_off
            if n_rows:
                self._encode_write(codec,
                                   buf[:n_rows].reshape(n_rows, k, s_len),
                                   writers, write_quorum, sse, enc_off)
                enc_off += n_rows * bs

        while True:
            row = buf[nb]
            with stagetimer.stage("put.read_stream"):
                n = _read_full_into(reader, row[:bs])
            if n == 0:
                break
            total += n
            if n == bs:
                nb += 1
                if nb == cap:
                    flush_full(nb)
                    nb = 0
            elif sse is not None:
                # short last block under SSE: it joins the tag trailer in
                # the finish batches (after flush_full below)
                tail_pt = bytes(row[:n])
                break
            else:
                # short last block: its shard length differs — encode
                # the pending full rows first, then it alone
                flush_full(nb)
                nb = 0
                with stagetimer.stage("put.split"):
                    data = codec.split(row[:n])[None, ...]
                self._encode_write(codec, data, writers, write_quorum)
                break
        flush_full(nb)
        if sse is None:
            return total
        for rows in self._sse_finish_rows(codec, sse, tail_pt, enc_off):
            self._write_shards_batch(*rows, writers, write_quorum)
        return _encrypted_size(total)

    def _unpack_fused(self, codec: Codec, data: np.ndarray, fused
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        """(data_rows, parity, data_digests, parity_digests) from one
        fused encode+digest result, or the host path when the batch did
        not route to the device (`fused` is None)."""
        if fused is not None:
            parity, digests = fused
            return (data, parity, digests[:, :codec.k],
                    digests[:, codec.k:])
        b_ = data.shape[0]
        parity = codec.encode_parity_batch(data)
        dd = bitrot_mod.hash_shards_batch(
            data.reshape(b_ * codec.k, -1), self.bitrot_algo
        ).reshape(b_, codec.k, -1)
        if codec.m:
            dp = bitrot_mod.hash_shards_batch(
                parity.reshape(b_ * codec.m, -1), self.bitrot_algo
            ).reshape(b_, codec.m, -1)
        else:
            dp = np.zeros((b_, 0, dd.shape[-1]), dtype=np.uint8)
        return data, parity, dd, dp

    def _submit_encode(self, codec: Codec, data: np.ndarray, item: dict):
        """The batch's fused dispatch on the batch former (None without
        one); under SSE its key and nonce words (item["sse_kn"]) ride
        along."""
        if self.scheduler is None:
            return None
        if "sse_kn" not in item:
            return self.scheduler.submit(codec, data, self.bitrot_algo)
        keys, nonces = item["sse_kn"]
        return self.scheduler.submit(codec, data, self.bitrot_algo,
                                     sse=(keys, nonces, _sse_pkg()))

    def _encode_write(self, codec: Codec, data: np.ndarray, writers,
                      write_quorum: int, sse=None, sse_off: int = 0
                      ) -> None:
        """Encode+digest one (B, k, S) batch — through the batch former
        when there is one, which coalesces concurrent PUT streams into
        shared dispatches — and fan the framed shard writes out; data
        rows go to the writers as views of `data`. With `sse` the rows
        are PLAINTEXT full blocks at stream offset `sse_off`, ciphered in
        the same dispatch."""
        with stagetimer.stage("put.encode+digest"), \
                telemetry.span("pipeline.encode", blocks=data.shape[0]):
            item: dict = {}
            if sse is not None:
                item = {"sse_kn": sse.batch_params(sse_off, data.shape[0],
                                                   self.block_size),
                        "sse_off": sse_off}
            fut = self._submit_encode(codec, data, item)
            if sse is not None:
                rows = self._sse_encode(codec, data, item, fut, sse)
            else:
                fused = fut.result() if fut is not None else \
                    codec.encode_and_hash_batch(data, self.bitrot_algo)
                rows = self._unpack_fused(codec, data, fused)
        with stagetimer.stage("put.shard_write"), \
                telemetry.span("pipeline.shard_write"):
            self._write_shards_batch(*rows, writers, write_quorum)

    def _sse_encode(self, codec: Codec, data: np.ndarray, item, fut,
                    sse) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
        """Resolve one SSE batch: the fused device cipher+encode+digest
        result or, when the codec's size gate keeps the batch on the host,
        the in-place host cipher followed by the host encode (the same
        bytes). A failed dispatch raises. Always absorbs the ciphertext
        into the Poly1305 tag trailer in stream order (the caller runs
        batches FIFO), so the tags cover the bytes actually committed."""
        bs = self.block_size
        k = codec.k
        if fut is not None:
            fused = fut.result()
        else:
            keys, nonces = item["sse_kn"]
            fused = codec.encrypt_encode_and_hash_batch(
                data, keys, nonces, _sse_pkg(), self.bitrot_algo)
        if fused is None:
            sse.cpu_encrypt_rows(data.reshape(data.shape[0], -1)[:, :bs],
                                 item["sse_off"])
            rows = self._unpack_fused(codec, data, None)
        else:
            full, digests = fused
            rows = (full[:, :k], full[:, k:], digests[:, :k],
                    digests[:, k:])
        for blk in rows[0]:
            sse.absorb(np.ascontiguousarray(blk).reshape(-1)[:bs])
        return rows

    def _sse_finish_rows(self, codec: Codec, sse, tail_pt: bytes,
                         off: int) -> list:
        """Close an SSE stream: cipher the short plaintext tail on the host
        (partial blocks never ride the device), absorb it, close the tag
        trailer, and chunk ct_tail‖trailer into block-size erasure batches
        ready for _write_shards_batch (the trailer can exceed one block
        for huge objects, hence a list)."""
        if tail_pt:
            arr = np.frombuffer(bytearray(tail_pt), dtype=np.uint8)
            sse.cpu_encrypt_tail(arr, off)
            sse.absorb(arr)
            stream = arr.tobytes() + sse.trailer()
        else:
            stream = sse.trailer()
        bs = self.block_size
        return [self._unpack_fused(
            codec, codec.split(stream[at:at + bs])[None, ...], None)
            for at in range(0, len(stream), bs)]

    def _write_shards_batch(self, data: np.ndarray, parity: np.ndarray,
                            dd: np.ndarray, dp: np.ndarray,
                            writers, write_quorum: int) -> None:
        """parallelWriter.Write, batched: writer i gets ALL B of its
        [digest‖block] frames in one task (cmd/erasure-encode.go:38-72)."""
        B, k = data.shape[0], data.shape[1]

        def write(i: int, w) -> None:
            rows, digs, j = (data, dd, i) if i < k else \
                (parity, dp, i - k)
            t0 = time.perf_counter()
            with telemetry.span("disk.shard_write", disk=i, blocks=B):
                for bi in range(B):
                    w.write_with_digest(rows[bi, j].data,
                                        digs[bi, j].data)
            healthtrack.observe_disk(w.disk, "write",
                                     time.perf_counter() - t0)

        # quorum-ack lane: once write-quorum writers are durable, a laggard
        # past the stall grace is dropped from the fan-out (and from every
        # later batch via writers[i] = None below); its missing shard heals
        # through MRF instead of setting p99
        _, errs = meta.for_each_disk_quorum(
            list(writers), write, write_quorum,
            stall_s=healthtrack.write_stall_s(), stage="shard_write")
        for i, e in enumerate(errs):
            if e is not None:
                writers[i] = None
        live = sum(1 for w in writers if w is not None)
        if live < write_quorum:
            raise api_errors.InsufficientWriteQuorum(
                f"{live} live writers < quorum {write_quorum}")

    def _commit(self, shuffled, writers, tmp_id: str, fi: FileInfo,
                bucket: str, object_name: str, write_quorum: int) -> int:
        """2-phase commit: close the shard writers, stage per-drive
        xl.meta in tmp, then rename into place at write quorum. Returns
        how many drives MISSED the commit (offline slot, dropped writer,
        or failed rename): the MRF degraded-write signal."""
        def close_writer(i, d):
            w = writers[i]
            if w is None:
                raise serr.DiskNotFound(f"writer {i}")
            w.close()  # flushes remaining frames (empty file for 0-byte)

        # the whole commit window rides the quorum-ack lane: a drive
        # stalling at close/meta/rename must not hold the client ack once
        # quorum is durable; it is counted into the return value and the
        # object converges back through MRF
        stall = healthtrack.write_stall_s()
        with stagetimer.stage("put.commit.close_writers"):
            _, errs = meta.for_each_disk_quorum(shuffled, close_writer,
                                                write_quorum, stall_s=stall,
                                                stage="close")
        for i, e in enumerate(errs):
            if e is not None:
                writers[i] = None

        metas = [fi.light_copy() for _ in range(len(shuffled))]
        if not self.bitrot_algo.streaming:
            # whole-file digests are per drive (each shard differs)
            for i, w in enumerate(writers):
                if w is not None:
                    for c in metas[i].erasure.checksums:
                        c.hash = w.digest()
        disks_for_meta = [d if writers[i] is not None else None
                          for i, d in enumerate(shuffled)]
        # shards staged in tmp, no metadata yet: a crash here leaves the
        # previous version untouched and only tmp garbage
        crashpoint.hit("put.shards.before_meta")
        with stagetimer.stage("put.commit.write_meta"):
            meta.write_unique_file_info(disks_for_meta,
                                        MINIO_META_TMP_BUCKET, tmp_id,
                                        metas, write_quorum, stall_s=stall)
        # fully staged, uncommitted: the renames are the point of no
        # return
        crashpoint.hit("put.meta.before_rename")

        def rename(i, d):
            # one hit per drive: arm :<nth> to die with n-1 drives renamed
            crashpoint.hit("put.rename.partial", disk=i)
            d.rename_data(MINIO_META_TMP_BUCKET, tmp_id, fi.data_dir,
                          bucket, object_name)

        def renamed_late(_i: int) -> None:
            # an abandoned rename that lands late may have laid an older
            # version over a commit made after this PUT acked: re-queue
            # the MRF check now that it settled
            self._notify_degraded(bucket, object_name, fi.version_id)

        with stagetimer.stage("put.commit.rename"):
            _, errs = meta.for_each_disk_quorum(disks_for_meta, rename,
                                                write_quorum, stall_s=stall,
                                                stage="rename",
                                                on_settle=renamed_late)
        err = meta.reduce_write_quorum_errs(
            errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
        if err is not None:
            raise api_errors.to_object_err(err, bucket, object_name)
        return sum(1 for i in range(len(shuffled))
                   if disks_for_meta[i] is None or errs[i] is not None)

    def _notify_degraded(self, bucket: str, object_name: str,
                         version_id: str) -> None:
        """Best-effort on_degraded_write invocation (reference
        :1712-1722)."""
        if self.on_degraded_write is None:
            return
        try:
            self.on_degraded_write(bucket, object_name, version_id)
        except Exception:  # noqa: BLE001 — heal queueing is best-effort
            pass

    def _notify_namespace(self, bucket: str, object_name: str) -> None:
        """Best-effort on_namespace_change invocation (reference
        :1723-1735). Hidden meta buckets never feed it: the index's own
        segment writes land there."""
        if self.on_namespace_change is None or bucket.startswith("."):
            return
        try:
            self.on_namespace_change(bucket, object_name)
        except Exception:  # noqa: BLE001 — indexing is best-effort
            pass

    def _flag_degraded_delete(self, bucket: str, object_name: str,
                              version_id: str, errs) -> None:
        """Queue an MRF heal when a quorum-successful delete or marker
        write left stale state on some drive; a drive answering
        not-found has already converged."""
        if any(e is not None
               and not isinstance(e, serr.OBJECT_NOT_FOUND_ERRS)
               for e in errs):
            self._notify_degraded(bucket, object_name, version_id)

    def _cleanup_tmp(self, disks, tmp_id: str) -> None:
        def rm(i, d):
            try:
                d.delete_file(MINIO_META_TMP_BUCKET, tmp_id, recursive=True)
            except serr.StorageError:
                pass
        meta.for_each_disk(disks, rm)

    # ------------------------------------------------------------------
    # GET (cmd/erasure-object.go:124-323 + cmd/erasure-decode.go)
    # ------------------------------------------------------------------

    def _object_file_info(self, bucket: str, object_name: str,
                          version_id: str = ""
                          ) -> tuple[FileInfo, list[Optional[FileInfo]],
                                     list[Optional[StorageAPI]]]:
        metas, errs = meta.read_all_file_info(self.disks, bucket,
                                              object_name, version_id)
        try:
            read_quorum, _ = meta.object_quorum_from_meta(
                metas, errs, self.parity_shards)
        except (api_errors.InsufficientReadQuorum, serr.StorageError):
            err = meta.reduce_read_quorum_errs(
                errs, meta.OBJECT_OP_IGNORED_ERRS,
                len(self.disks) - self.parity_shards)
            raise api_errors.to_object_err(
                err or api_errors.InsufficientReadQuorum(),
                bucket, object_name) from None
        err = meta.reduce_read_quorum_errs(errs, meta.OBJECT_OP_IGNORED_ERRS,
                                           read_quorum)
        if err is not None:
            raise api_errors.to_object_err(err, bucket, object_name)
        fi = meta.pick_valid_file_info(metas, read_quorum)
        online, _ = meta.list_online_disks(self.disks, metas, errs)
        return fi, metas, online

    def has_object_versions(self, bucket: str, object_name: str) -> bool:
        """True when any version, a delete marker included, exists: the
        pool-affinity probe (cmd/erasure-server-sets.go:195-220)."""
        try:
            self._object_file_info(bucket, object_name)
            return True
        except api_errors.ObjectApiError:
            return False

    def latest_file_info(self, bucket: str, object_name: str) -> FileInfo:
        """The latest version's FileInfo, delete markers included: the
        newest-wins probe across pools."""
        fi, _, _ = self._object_file_info(bucket, object_name)
        return fi

    def update_object_metadata(self, bucket: str, object_name: str,
                               metadata: dict, version_id: str = ""
                               ) -> ObjectInfo:
        """Metadata-only update of an existing version in place: no data
        rewrite, no new version (the etag is kept)."""
        with self.ns.new_lock(f"{bucket}/{object_name}").write_locked():
            fi, metas, online = self._object_file_info(
                bucket, object_name, version_id)
            if fi.deleted:
                raise api_errors.MethodNotAllowed(
                    f"{bucket}/{object_name} is a delete marker")
            new_meta = dict(metadata)
            new_meta["etag"] = fi.metadata.get("etag", "")

            def upd(i, d):
                m = metas[i]
                if m is None:
                    raise serr.FileNotFound(object_name)
                m.metadata = dict(new_meta)
                d.write_metadata(bucket, object_name, m)

            _, errs = meta.for_each_disk(online, upd)
            _, write_quorum = meta.object_quorum_from_meta(
                metas, [None] * len(metas), self.parity_shards)
            err = meta.reduce_write_quorum_errs(
                errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
            if err is not None:
                raise api_errors.to_object_err(err, bucket, object_name)
            fi.metadata = new_meta
        if any(e is not None for e in errs):
            self._notify_degraded(bucket, object_name, version_id)
        self._notify_namespace(bucket, object_name)
        return fi.to_object_info(bucket, object_name)

    def transition_object(self, bucket: str, object_name: str,
                          version_id: str = "", tier: str = "",
                          remote_object: str = "",
                          remote_version: str = "",
                          expect_etag: str = "",
                          expect_mod_time: Optional[float] = None
                          ) -> ObjectInfo:
        """Rewrite one version's xl.meta into a zero-data stub carrying
        the tier name and remote key, then free its local shards (the
        reference's TransitionObject commit). The caller has verified the
        remote copy; the shards go only after the stub is at write
        quorum, so a crash before that leaves the object readable.

        Also the restore-expiry reclaim: re-stubbing a restored copy
        passes the same tier and remote key back, and drops the restore
        state.

        expect_etag / expect_mod_time pin the version's identity inside
        the write lock: an unversioned overwrite that raced the remote
        upload aborts the commit (PreConditionFailed)."""
        with self.ns.new_lock(f"{bucket}/{object_name}").write_locked():
            fi, metas, online = self._object_file_info(
                bucket, object_name, version_id)
            if fi.deleted:
                raise api_errors.MethodNotAllowed(
                    f"{bucket}/{object_name} is a delete marker")
            if (expect_etag
                    and fi.metadata.get("etag", "") != expect_etag) or \
                    (expect_mod_time is not None
                     and fi.mod_time != expect_mod_time):
                raise api_errors.PreConditionFailed(
                    f"{bucket}/{object_name} changed since the remote "
                    "copy was written")
            data_dir = fi.data_dir
            new_meta = dict(fi.metadata)
            new_meta[TRANSITION_STATUS_KEY] = TRANSITION_COMPLETE
            new_meta[TRANSITION_TIER_KEY] = tier
            new_meta[TRANSITIONED_OBJECT_KEY] = remote_object
            if remote_version:
                new_meta[TRANSITIONED_VERSION_KEY] = remote_version
            else:
                new_meta.pop(TRANSITIONED_VERSION_KEY, None)
            new_meta.pop(RESTORE_KEY, None)
            new_meta.pop(RESTORE_EXPIRY_KEY, None)

            def upd(i, d):
                m = metas[i]
                if m is None:
                    raise serr.FileNotFound(object_name)
                m.metadata = dict(new_meta)
                m.data_dir = ""        # zero-data stub
                d.write_metadata(bucket, object_name, m)

            _, errs = meta.for_each_disk(online, upd)
            _, write_quorum = meta.object_quorum_from_meta(
                metas, [None] * len(metas), self.parity_shards)
            err = meta.reduce_write_quorum_errs(
                errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
            if err is not None:
                raise api_errors.to_object_err(err, bucket, object_name)
            # the stub is at quorum: now the shards go, from every drive
            # (a stale copy must not bring the data directory back)
            if data_dir:
                def rm(i, d):
                    try:
                        d.delete_file(bucket, f"{object_name}/{data_dir}",
                                      recursive=True)
                    except serr.FileNotFound:
                        pass

                meta.for_each_disk(self.disks, rm)
            fi.metadata = new_meta
            fi.data_dir = ""
        if any(e is not None for e in errs):
            self._notify_degraded(bucket, object_name, fi.version_id)
        self._notify_namespace(bucket, object_name)
        return fi.to_object_info(bucket, object_name)

    def put_stub_version(self, bucket: str, object_name: str,
                         info: ObjectInfo,
                         if_none_newer: bool = False) -> ObjectInfo:
        """Write a transitioned zero-data stub version from its ObjectInfo
        (a stub's copy between pools: only the xl.meta pointer travels).
        The identity (version id, mod time, etag, parts, metadata with
        the tier pointers) is kept; the erasure geometry is this set's."""
        md = dict(info.user_defined or {})
        if md.get(TRANSITION_STATUS_KEY) != TRANSITION_COMPLETE:
            raise api_errors.InvalidObjectState(
                f"{bucket}/{object_name} is not a transitioned stub")
        k, m, _, write_quorum = self._default_quorums()
        fi = new_file_info(f"{bucket}/{object_name}", k, m)
        fi.erasure.block_size = self.block_size
        fi.volume, fi.name = bucket, object_name
        fi.data_dir = ""
        fi.version_id = info.version_id or ""
        fi.size = info.size
        fi.mod_time = info.mod_time
        md["etag"] = info.etag
        if info.content_type:
            md["content-type"] = info.content_type
        if info.content_encoding:
            md["content-encoding"] = info.content_encoding
        fi.metadata = md
        for p in (info.parts or []):
            fi.add_object_part(p.number, p.etag, p.size, p.actual_size)
        if not fi.parts:
            fi.add_object_part(1, info.etag, info.size, info.size)
        with self.ns.new_lock(f"{bucket}/{object_name}").write_locked():
            if if_none_newer:
                self._check_none_newer(bucket, object_name, fi)
            metas = [fi.light_copy() for _ in range(len(self.disks))]
            online = meta.write_unique_file_info(
                self.disks, bucket, object_name, metas, write_quorum)
        if any(d is None for d in online):
            self._notify_degraded(bucket, object_name, fi.version_id)
        self._notify_namespace(bucket, object_name)
        return fi.to_object_info(bucket, object_name)

    def get_object_info(self, bucket: str, object_name: str,
                        opts: Optional[GetOptions] = None) -> ObjectInfo:
        opts = opts or GetOptions()
        with self.ns.new_lock(f"{bucket}/{object_name}").read_locked():
            fi, _, _ = self._object_file_info(bucket, object_name,
                                              opts.version_id)
        if fi.deleted:
            if opts.version_id:
                return fi.to_object_info(bucket, object_name)
            raise api_errors.ObjectNotFound(bucket, object_name)
        return fi.to_object_info(bucket, object_name)

    def get_object(self, bucket: str, object_name: str,
                   offset: int = 0, length: int = -1,
                   opts: Optional[GetOptions] = None
                   ) -> tuple[ObjectInfo, Iterator[bytes]]:
        """Returns (info, chunk iterator). Reads are verified (streaming
        bitrot) and reconstructed on the fly when shards are missing. The
        namespace read lock is held until the iterator is exhausted or
        closed."""
        opts = opts or GetOptions()
        lock = self.ns.new_lock(f"{bucket}/{object_name}")
        if not lock.get_rlock(30.0):
            raise api_errors.ObjectApiError("read lock timeout")
        try:
            fi, metas, online = self._object_file_info(
                bucket, object_name, opts.version_id)
            if fi.deleted:
                if opts.version_id:
                    raise api_errors.MethodNotAllowed(
                        f"{bucket}/{object_name} is a delete marker")
                raise api_errors.ObjectNotFound(bucket, object_name)
            if is_transitioned(fi.metadata) \
                    and not is_restored(fi.metadata):
                # the data lives in a remote tier and no restored copy
                # exists: InvalidObjectState until a RestoreObject
                raise api_errors.InvalidObjectState(
                    f"{bucket}/{object_name} is archived in tier "
                    f"{fi.metadata.get(TRANSITION_TIER_KEY, '?')!r}; "
                    "restore it first")
            oi = fi.to_object_info(bucket, object_name)
            if length < 0:
                length = fi.size - offset
            if offset < 0 or length < 0 or offset + length > fi.size:
                if not (fi.size == 0 and offset == 0 and length <= 0):
                    raise api_errors.InvalidRange(offset, length, fi.size)
        except Exception:
            lock.unlock()
            raise

        # a drive that is present but lacks the latest copy needs heal
        # even when no shard read will fail (its shard may be parity)
        flagged = False
        if self.on_degraded_read is not None and any(
                online[i] is None and self.disks[i] is not None
                for i in range(len(online))):
            flagged = True
            try:
                self.on_degraded_read(bucket, object_name)
            except Exception:  # noqa: BLE001 — heal queueing is best-effort
                pass

        released = [False]

        def release() -> None:
            if not released[0]:
                released[0] = True
                lock.unlock()

        def gen() -> Iterator[bytes]:
            try:
                if fi.size == 0 or length == 0:
                    return
                # traced_iter, not a plain span: the span is current only
                # while the read code runs, never across a yield into the
                # consumer
                yield from telemetry.traced_iter(
                    "engine.get_object",
                    self._read_object_stream(
                        bucket, object_name, fi, metas, online, offset,
                        length, suppress_heal_flag=flagged),
                    bucket=bucket, object=object_name, length=length)
            finally:
                release()

        return oi, _UnlockOnClose(gen(), release)

    def _read_object_stream(self, bucket, object_name, fi: FileInfo,
                            metas, online, offset: int, length: int,
                            suppress_heal_flag: bool = False
                            ) -> Iterator[bytes]:
        """Per-part block loop (getObjectWithFileInfo,
        cmd/erasure-object.go:217-323), with cross-part lookahead: while
        part N's last group verifies and decodes, part N+1's first group
        is already reading on the prefetch pool."""
        from ..parallel import pipeline as pl
        # every erasure read stream counts: a read-cache hit shows as no
        # new stream across the GET (object/cache.py)
        GET_STREAMS.inc()
        shuffled_disks = meta.shuffle_disks(online, fi.erasure.distribution)
        shuffled_meta = meta.shuffle_parts_metadata(metas,
                                                    fi.erasure.distribution)
        codec = self.codec(fi.erasure.data_blocks, fi.erasure.parity_blocks)
        part_idx, part_off = fi.object_to_part_offset(offset)
        remaining = length
        plans: list[_PartReadPlan] = []
        for pi in range(part_idx, len(fi.parts)):
            if remaining <= 0:
                break
            part = fi.parts[pi]
            part_read_off = part_off if pi == part_idx else 0
            part_read_len = min(remaining, part.size - part_read_off)
            if part_read_len > 0:
                plans.append(_PartReadPlan(
                    self, bucket, object_name, fi, shuffled_disks,
                    shuffled_meta, codec, part, part_read_off,
                    part_read_len, suppress_heal_flag))
            remaining -= part_read_len
        try:
            for i, plan in enumerate(plans):
                nxt = plans[i + 1] if pl.ENABLED \
                    and i + 1 < len(plans) else None
                yield from plan.stream(next_plan=nxt)
        finally:
            for plan in plans:
                plan.close()

    def _read_part(self, bucket, object_name, fi: FileInfo, disks, smeta,
                   codec: Codec, part, offset: int, length: int,
                   suppress_heal_flag: bool = False) -> Iterator[bytes]:
        """One part's verified (and, where shards are missing,
        reconstructed) bytes: one read plan, no cross-part prefetch."""
        plan = _PartReadPlan(self, bucket, object_name, fi, disks, smeta,
                             codec, part, offset, length,
                             suppress_heal_flag)
        try:
            yield from plan.stream()
        finally:
            plan.close()

    def _verify_and_reconstruct_group(self, codec: Codec, group, k: int,
                                      n: int, readers, shard_size: int,
                                      algo: bitrot_mod.BitrotAlgorithm,
                                      io_lock: Optional[threading.Lock]
                                      = None,
                                      reader_gen: Optional[tuple] = None,
                                      benign_missing: frozenset
                                      = frozenset()) -> bool:
        """Verify deferred frame digests AND reconstruct the degraded
        blocks of a read group. Degraded blocks sharing one (present-mask,
        shard-length) pattern go through one fused verify+decode device
        dispatch (models/pipeline.get_step; through the batch former when
        there is one) when they pass the size gate; shards the fused step
        did not cover batch-verify in one host call. A digest mismatch
        drops the corrupt shard's reader and re-reads the block with
        inline verification. Group entries are [b, off, blen, shard_len,
        shards, digests] lists, mutated in place. Returns True when any
        block needed reconstruction or had bitrot; a block whose missing
        data shards are all in `benign_missing` (readers the read plan
        skipped or a latency hedge out-raced) is reconstructed but does
        not count: its shards are on disk and nothing needs healing."""
        from ..ops import rs_matrix
        heal = False
        corrupt: set[int] = set()
        if io_lock is None:
            io_lock = threading.Lock()   # uncontended when no prefetch

        def drop_reader(u: int) -> None:
            """Condemn the reader a corrupt frame came from — unless a
            lookahead rebuilt the readers list since this group was read,
            in which case index u names a fresh reader."""
            with io_lock:
                if reader_gen is None or \
                        reader_gen[0][0] == reader_gen[1]:
                    readers[u] = None

        # 1) degraded buckets: fused verify+decode, or a host matmul
        buckets: dict[tuple[int, int], list[int]] = {}
        for gi, entry in enumerate(group):
            shards = entry[4]
            if all(shards[i] is not None for i in range(k)):
                continue
            mask = sum(1 << i for i in range(n) if shards[i] is not None)
            buckets.setdefault((mask, entry[3]), []).append(gi)
        # submit every bucket's fused dispatch before resolving any, so
        # each bucket's grace window overlaps concurrent requests'
        # same-pattern buckets
        staged: list[tuple] = []
        for (mask, shard_len), idxs in buckets.items():
            # a reconstruct forced by the read plan (quarantine skip,
            # latency-hedge loser) is not damage: only a miss the plan
            # cannot account for flags the degraded-read heal
            if not {i for i in range(k)
                    if not (mask >> i) & 1} <= benign_missing:
                heal = True
            _dm, used, _missing = rs_matrix.missing_data_matrix(
                k, codec.m, mask)
            stacked = np.stack([np.stack([group[gi][4][u] for u in used])
                                for gi in idxs])              # (G', k, S)
            # fuse hashing only when digests were actually deferred
            want_fused = any(group[gi][5][u] is not None
                             for gi in idxs for u in used)
            fut = None
            if want_fused and self.scheduler is not None:
                fut = self.scheduler.submit_decode(codec, stacked, mask,
                                                   shard_len, algo)
            staged.append((mask, shard_len, idxs, used, stacked,
                           want_fused, fut))
        for mask, shard_len, idxs, used, stacked, want_fused, fut \
                in staged:
            if fut is not None:
                fused = fut.result()      # a dispatch failure raises
            elif want_fused:
                fused = codec.verify_and_decode_batch(
                    stacked, mask, shard_len, algo)
            else:
                fused = None
            if fused is not None:
                out, missing_idx, sdig = fused
                for row, gi in enumerate(idxs):
                    shards, digests = group[gi][4], group[gi][5]
                    bad = False
                    for col, u in enumerate(used):
                        exp = digests[u]
                        if exp is None:
                            continue
                        if sdig[row, col].tobytes() != exp:
                            shards[u] = None
                            drop_reader(u)
                            bad = True
                        else:
                            digests[u] = None  # verified on the device
                    if bad:
                        corrupt.add(gi)
                    else:
                        for r_i, mi in enumerate(missing_idx):
                            shards[mi] = out[row][r_i]
            else:
                out, idxs_rows = codec.recover_stacked(
                    stacked, mask, set(range(k)))
                for row, gi in enumerate(idxs):
                    shards = group[gi][4]
                    for r_i, mi in enumerate(idxs_rows):
                        shards[mi] = out[row][r_i]

        # 2) batch-verify every shard the fused step did not cover
        pend: dict[int, list[tuple[int, int]]] = {}
        for gi, entry in enumerate(group):
            if gi in corrupt:
                continue
            shards, digests = entry[4], entry[5]
            for i in range(n):
                if digests[i] is not None and shards[i] is not None:
                    pend.setdefault(len(shards[i]), []).append((gi, i))
        for _sl, items in pend.items():
            stacked = np.stack([group[gi][4][i] for gi, i in items])
            got = bitrot_mod.hash_shards_batch(stacked, algo)
            for row, (gi, i) in enumerate(items):
                if got[row].tobytes() != group[gi][5][i]:
                    group[gi][4][i] = None
                    drop_reader(i)
                    corrupt.add(gi)
                else:
                    group[gi][5][i] = None

        # 3) corrupt blocks: re-read with inline verification and host
        #    reconstruct — the corrupt reader is dead, so spares replace it
        for gi in sorted(corrupt):
            heal = True
            b, _off, _blen, shard_len, _shards, _dg = group[gi]
            with io_lock:   # a GET lookahead may hold the readers
                new_shards, _digests, _he = self._read_block_shards_raw(
                    readers, b, shard_size, shard_len, k, n)
            if any(new_shards[i] is None for i in range(k)):
                new_shards = codec.reconstruct(new_shards, data_only=True)
            group[gi][4] = new_shards
            group[gi][5] = [None] * n
        return heal

    def _read_group_shards_raw(self, readers, blocks: list,
                               shard_size: int, shard_lens: list,
                               k: int, n: int,
                               collect_digests: bool = False,
                               avoid: frozenset = frozenset(),
                               benign_sink: Optional[set] = None) -> list:
        """k-of-n shard reads for a group of blocks (parallelReader,
        cmd/erasure-decode.go:102-184): one pool task per reader streams
        every block of the group. Returns [(shards, digests, had_errors)]
        per block (missing entries None).

        This is the hedged-read state machine (reference :1464-1614): k
        primaries launch (data readers first, parity next), and a spare
        shard read races any primary that either fails (error hedge) or
        outlives the adaptive latency deadline from the health tracker
        (healthtrack.read_hedge_s: healthy read p95 x K, clamped; re-armed
        after each hedge). First k wins; the losers are condemned (their
        stateful streams must never serve a later group) and closed when
        their abandoned read settles.

        `avoid` holds reader indices the plan deprioritizes (slow-drive
        quarantine): they sort behind every healthy candidate and are
        touched only when nothing else can reach k. `benign_sink` collects
        indices whose shards are missing for plan reasons (avoided, or
        out-raced on latency) rather than damage: the verify step flags no
        heal for those.

        With collect_digests, readers skip per-frame host verification and
        return each frame's stored digest instead (digests[i] is None when
        the shard was verified at read time) — the deferred-verify feed
        for the fused device step."""
        nb = len(blocks)
        per_reader: list = [None] * n
        had_errors = False
        errored: set = set()

        def read_one(i: int, r) -> list:
            out = []
            t0 = time.perf_counter()
            with telemetry.span("disk.shard_read", disk=i, blocks=nb):
                for b, sl in zip(blocks, shard_lens):
                    off = b * shard_size
                    if collect_digests:
                        frames = r.read_frames(off, sl)
                        out.append((frames[0][1] if frames else b"",
                                    frames[0][0] if frames else None))
                    else:
                        out.append((r.read_at(off, sl), None))
            healthtrack.observe_disk(r.disk, "read",
                                     time.perf_counter() - t0)
            return out

        # candidate order: data rows first (their shards join without a
        # decode), parity next, avoided (suspect/probation) drives last —
        # the capacity rule by construction: they re-enter only when
        # nothing healthier can reach k
        candidates = [i for i in range(n) if readers[i] is not None]
        candidates.sort(key=lambda i: (i in avoid, 0 if i < k else 1, i))
        spares = candidates[k:]
        inflight: dict = {}

        def launch(i: int) -> None:
            inflight[meta.submit_disk_task(read_one, i, readers[i])] = i

        for i in candidates[:k]:
            launch(i)
        hedge_s = healthtrack.read_hedge_s()
        deadline = None if hedge_s is None \
            else time.monotonic() + hedge_s
        while inflight:
            got = sum(1 for p in per_reader if p is not None)
            if got >= k:
                break
            timeout = None
            if deadline is not None and spares:
                timeout = max(deadline - time.monotonic(), 0.0)
            done, _ = _fwait(set(inflight), timeout=timeout,
                             return_when=FIRST_COMPLETED)
            if not done:
                # latency hedge: every still-missing slot gets a spare
                # racing it; the deadline re-arms so a second level of
                # stalls hedges again (spares permitting)
                need = k - sum(1 for p in per_reader if p is not None)
                fresh, spares = spares[:need], spares[need:]
                for i in fresh:
                    launch(i)
                    healthtrack.note_hedge("latency")
                deadline = time.monotonic() + (hedge_s or 0.0)
                continue
            for f in done:
                i = inflight.pop(f)
                try:
                    per_reader[i] = f.result(timeout=0)
                except Exception:  # noqa: BLE001 — reader condemned
                    readers[i] = None
                    errored.add(i)
                    had_errors = True
                    if spares:
                        j = spares.pop(0)
                        launch(j)
                        healthtrack.note_hedge("error")
        got = sum(1 for p in per_reader if p is not None)
        if got >= k and inflight:
            # first k wins: condemn the losers so no later group reads
            # their (stateful) streams, and close each one when its
            # abandoned task settles on the pool
            for f, i in inflight.items():
                loser = readers[i]
                readers[i] = None

                def _close(_f, r=loser):
                    try:
                        r.close()
                    except Exception:  # noqa: BLE001 — abandoned
                        pass
                f.add_done_callback(_close)
        if got < k:
            raise api_errors.InsufficientReadQuorum(
                f"{got} readable shards < k={k}")
        # shards missing because the plan skipped or out-raced their
        # reader (not because it failed) are benign: decode reconstructs
        # them, but nothing on disk needs healing. The caller may pre-seed
        # benign_sink with earlier groups' benign misses (a reader
        # condemned on latency stays out for the whole part)
        benign = {i for i in candidates
                  if per_reader[i] is None and i not in errored}
        if benign_sink is not None:
            benign_sink.update(benign)
            # a reader that really errored in this group loses any benign
            # standing it carried in: that miss is damage
            benign_sink.difference_update(errored)
            benign = set(benign_sink)
        missing_data = {i for i in range(k) if per_reader[i] is None}
        if missing_data and not missing_data <= benign:
            had_errors = True      # a data shard must be reconstructed
        out = []
        for bi in range(nb):
            shards: list = [None] * n
            digests: list = [None] * n
            for i in range(n):
                if per_reader[i] is not None:
                    shards[i] = np.frombuffer(per_reader[i][bi][0],
                                              dtype=np.uint8)
                    digests[i] = per_reader[i][bi][1]
            out.append((shards, digests, had_errors))
        return out

    def _read_block_shards_raw(self, readers, block_num: int,
                               shard_size: int, shard_len: int, k: int,
                               n: int, collect_digests: bool = False,
                               avoid: frozenset = frozenset(),
                               benign_sink: Optional[set] = None
                               ) -> tuple[list, list, bool]:
        """k-of-n shard reads of one block (reference :1616-1638): returns
        (shards, expected_digests, had_errors), raw shards (missing
        entries None, at least k present) without reconstructing. The
        single-block form of _read_group_shards_raw, so the heal and
        rebalance readers that call it ride the same hedged state
        machine."""
        return self._read_group_shards_raw(
            readers, [block_num], shard_size, [shard_len], k, n,
            collect_digests=collect_digests, avoid=avoid,
            benign_sink=benign_sink)[0]

    # ------------------------------------------------------------------
    # DELETE (cmd/erasure-object.go:727-820)
    # ------------------------------------------------------------------

    def delete_object(self, bucket: str, object_name: str,
                      version_id: str = "", versioned: bool = False
                      ) -> ObjectInfo:
        _k, _m, _, write_quorum = self._default_quorums()
        with self.ns.new_lock(f"{bucket}/{object_name}").write_locked():
            if versioned and not version_id:
                # versioned delete without a version: write a delete marker
                fi = FileInfo(volume=bucket, name=object_name,
                              version_id=str(_uuid.uuid4()), deleted=True,
                              mod_time=now())
                _, errs = meta.for_each_disk(
                    self.disks,
                    lambda i, d: d.write_metadata(bucket, object_name, fi))
                err = meta.reduce_write_quorum_errs(
                    errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
                if err is not None:
                    raise api_errors.to_object_err(err, bucket, object_name)
                oi = fi.to_object_info(bucket, object_name)
                self._flag_degraded_delete(bucket, object_name,
                                           fi.version_id, errs)
                self._notify_namespace(bucket, object_name)
                return oi

            fi = FileInfo(volume=bucket, name=object_name,
                          version_id=version_id)
            _, errs = meta.for_each_disk(
                self.disks,
                lambda i, d: d.delete_version(bucket, object_name, fi))
            # not-found is counted (not ignored) so a missing object maps
            # to ObjectNotFound rather than a quorum failure
            err = meta.reduce_write_quorum_errs(
                errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
            if err is not None:
                raise api_errors.to_object_err(err, bucket, object_name)
        self._flag_degraded_delete(bucket, object_name, version_id, errs)
        self._notify_namespace(bucket, object_name)
        return ObjectInfo(bucket=bucket, name=object_name,
                          version_id=version_id)

    def put_delete_marker(self, bucket: str, object_name: str,
                          version_id: str = "",
                          mod_time: Optional[float] = None,
                          metadata: Optional[dict] = None) -> ObjectInfo:
        """A delete marker with an explicit version id and mod time (the
        copy path between pools keeps a marker's identity; delete_object
        always mints fresh ones)."""
        _k, _m, _, write_quorum = self._default_quorums()
        fi = FileInfo(volume=bucket, name=object_name,
                      version_id=version_id or str(_uuid.uuid4()),
                      deleted=True, mod_time=mod_time or now(),
                      metadata=dict(metadata or {}))
        with self.ns.new_lock(f"{bucket}/{object_name}").write_locked():
            _, errs = meta.for_each_disk(
                self.disks,
                lambda i, d: d.write_metadata(bucket, object_name, fi))
            err = meta.reduce_write_quorum_errs(
                errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
            if err is not None:
                raise api_errors.to_object_err(err, bucket, object_name)
        self._flag_degraded_delete(bucket, object_name, fi.version_id,
                                   errs)
        self._notify_namespace(bucket, object_name)
        return fi.to_object_info(bucket, object_name)

    def delete_objects(self, bucket: str, objects: list[str]
                       ) -> list[Optional[Exception]]:
        """Bulk delete: one storage call per drive for the whole batch
        (reference DeleteObjects, cmd/erasure-object.go:772), with a
        quorum verdict per key."""
        if not objects:
            return []
        _k, _m, _, write_quorum = self._default_quorums()
        fis = [FileInfo(volume=bucket, name=o) for o in objects]
        with self.ns.new_lock(
                *[f"{bucket}/{o}" for o in objects]).write_locked():
            results, disk_errs = meta.for_each_disk(
                self.disks, lambda i, d: d.delete_versions(
                    bucket, [copy.deepcopy(f) for f in fis]))
        out: list[Optional[Exception]] = []
        for j, o in enumerate(objects):
            per_disk: list[Optional[Exception]] = []
            for res, derr in zip(results, disk_errs):
                if derr is not None:
                    per_disk.append(derr)      # whole drive failed
                elif res is not None and j < len(res):
                    per_disk.append(res[j])
                else:
                    per_disk.append(serr.DiskNotFound("no result"))
            err = meta.reduce_write_quorum_errs(
                per_disk, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
            out.append(None if err is None
                       else api_errors.to_object_err(err, bucket, o))
            if err is None:
                self._flag_degraded_delete(bucket, o, "", per_disk)
                self._notify_namespace(bucket, o)
        return out

    # ------------------------------------------------------------------
    # LIST (merge-walk across drives; cmd/erasure-sets.go:888-1081)
    # ------------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000
                     ) -> tuple[list[ObjectInfo], list[str], bool]:
        """Returns (objects, common_prefixes, is_truncated)."""
        self.get_bucket_info(bucket)  # existence + quorum check

        def read_latest(name: str):
            try:
                fi = self._read_one(bucket, name)
            except api_errors.ObjectApiError:
                return None
            if fi.deleted:
                return None
            return fi.to_object_info(bucket, name)

        return paginate_objects(self._merged_names(bucket, prefix, marker),
                                read_latest, prefix, marker, delimiter,
                                max_keys)

    def list_object_versions(self, bucket: str, prefix: str = "",
                             marker: str = "", max_keys: int = 1000,
                             version_marker: str = "",
                             delimiter: str = ""
                             ) -> tuple[list[ObjectInfo], list[str],
                                        str, str, bool]:
        """One page of the bucket's version history: (versions,
        common_prefixes, next_key_marker, next_version_id_marker,
        is_truncated). `version_marker` resumes after that version of
        `marker`."""
        self.get_bucket_info(bucket)
        names = self._merged_names(bucket, prefix, marker,
                                   inclusive=bool(version_marker))
        return paginate_versions(
            names, lambda n: self.object_versions(bucket, n),
            prefix, marker, version_marker, delimiter, max_keys)

    def object_versions(self, bucket: str, name: str) -> list[ObjectInfo]:
        """Quorum-merged versions of one object, newest first."""
        return [fi.to_object_info(bucket, name)
                for fi in self._merged_versions(bucket, name)]

    def _merged_versions(self, bucket: str, name: str) -> list[FileInfo]:
        """Quorum-merge the per-drive version journals of one object: a
        version counts when at least read quorum (k) drives agree on its
        (version id, mod time, kind). Newest first by (mod time, version
        id)."""
        results, _errs = meta.for_each_disk(
            self.disks, lambda i, d: d.read_versions(bucket, name))
        counts: dict[tuple, int] = {}
        picks: dict[tuple, FileInfo] = {}
        for vers in results:
            if vers is None:
                continue
            for fi in vers:
                key = (fi.version_id, fi.mod_time, fi.deleted)
                counts[key] = counts.get(key, 0) + 1
                picks.setdefault(key, fi)
        merged = [picks[key] for key, c in counts.items()
                  if c >= self.data_shards]
        merged.sort(key=lambda fi: (fi.mod_time or 0, fi.version_id or ""),
                    reverse=True)
        return merged

    def _merged_names(self, bucket: str, prefix: str,
                      marker: str = "",
                      inclusive: bool = False) -> Iterator[str]:
        """Lazy lexical merge-walk of object names across the first three
        live drives (the reference's startMergeWalks, which asks 3 drives
        per set). Yields names > marker (>= marker when `inclusive`)
        matching prefix, in order."""
        # narrow the walk to the deepest directory of the prefix
        dir_part = prefix.rsplit("/", 1)[0] if "/" in prefix else ""
        # drive walks yield strictly > their marker; one char shorter
        # re-admits the marker name itself
        walk_marker = marker[:-1] if (inclusive and marker) else marker

        def drive_names(d) -> Iterator[str]:
            try:
                for fi in d.walk(bucket, dir_part, walk_marker):
                    yield fi.name
            except serr.StorageError:
                return              # drive died mid-walk: its names drop

        iters = [drive_names(d) for d in self.disks if d is not None][:3]
        last = None
        for name in heapq.merge(*iters):
            if name == last:
                continue
            last = name
            if name.startswith(prefix):
                yield name
            elif name > prefix:
                return              # sorted: nothing later can match

    def _read_one(self, bucket: str, object_name: str) -> FileInfo:
        fi, _, _ = self._object_file_info(bucket, object_name)
        return fi


def paginate_objects(names, read_latest, prefix: str, marker: str,
                     delimiter: str, max_keys: int
                     ) -> tuple[list[ObjectInfo], list[str], bool]:
    """The object-listing page: delimiter grouping, marker skips and
    max_keys truncation over a sorted prefix-matching name stream.
    `read_latest(name)` returns the listable ObjectInfo or None (no
    quorum, or a delete marker)."""
    objects: list[ObjectInfo] = []
    prefixes: list[str] = []
    seen_prefix: set[str] = set()
    truncated = False
    for name in names:
        if marker and name <= marker:
            continue
        if delimiter:
            rest = name[len(prefix):]
            di = rest.find(delimiter)
            if di >= 0:
                p = prefix + rest[:di + len(delimiter)]
                if marker and p <= marker:
                    continue  # prefix page already returned
                if p not in seen_prefix:
                    seen_prefix.add(p)
                    prefixes.append(p)
                    if len(objects) + len(prefixes) >= max_keys + 1:
                        truncated = True
                        prefixes = prefixes[:max_keys - len(objects)]
                        break
                continue
        oi = read_latest(name)
        if oi is None:
            continue
        objects.append(oi)
        if len(objects) + len(prefixes) >= max_keys + 1:
            truncated = True
            objects = objects[:max_keys - len(prefixes)]
            break
    return objects, prefixes, truncated


def paginate_versions(names, versions_of, prefix: str, marker: str,
                      version_marker: str, delimiter: str, max_keys: int
                      ) -> tuple[list[ObjectInfo], list[str], str, str,
                                 bool]:
    """The versions-listing page: delimiter grouping, key and version-id
    marker resume, and max_keys truncation (versions and prefixes each
    count one entry). Returns (versions, common_prefixes,
    next_key_marker, next_version_id_marker, is_truncated); a cut may
    fall inside one key's versions. `versions_of(name)` returns the key's
    versions newest first."""
    out: list[ObjectInfo] = []
    prefixes: list[str] = []
    seen_prefix: set[str] = set()
    if max_keys <= 0:
        return [], [], "", "", False
    for name in names:
        if marker:
            if name < marker or (not version_marker and name == marker):
                continue
        if delimiter:
            rest = name[len(prefix):]
            di = rest.find(delimiter)
            if di >= 0:
                p = prefix + rest[:di + len(delimiter)]
                if marker and p <= marker:
                    continue  # prefix page already returned
                if p not in seen_prefix:
                    seen_prefix.add(p)
                    if len(out) + len(prefixes) >= max_keys:
                        nkm, nvm = last_version_marker(out, prefixes)
                        return out, prefixes, nkm, nvm, True
                    prefixes.append(p)
                continue
        vers = versions_of(name)
        if version_marker and name == marker:
            # "null" is the wire form of the empty version id
            vm = "" if version_marker == "null" else version_marker
            idx = next((i for i, v in enumerate(vers)
                        if v.version_id == vm), None)
            if idx is not None:
                vers = vers[idx + 1:]
        for oi in vers:
            if len(out) + len(prefixes) >= max_keys:
                nkm, nvm = last_version_marker(out, prefixes)
                return out, prefixes, nkm, nvm, True
            out.append(oi)
    return out, prefixes, "", "", False


class _UnlockOnClose:
    """GET stream wrapper whose close() releases the namespace read lock
    even when the stream was never started (closing an unstarted generator
    skips its ``finally``)."""

    def __init__(self, gen, release):
        self._gen = gen
        self._release = release

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        try:
            self._gen.close()
        finally:
            self._release()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


class _PartReadPlan:
    """One part's GET read state: the bitrot readers, the precomputed
    group walk, and the one-group lookahead (reference :2088-2330).
    Blocks are read in groups of GET_BATCH_BLOCKS so a degraded part
    reconstructs many blocks per device step instead of one per block;
    while group N verifies and decodes, group N+1 is already reading on
    the prefetch pool, and at the last group the lookahead crosses into
    the next part (prime()).

    Every reader I/O (group reads, the corrupt-block re-reads inside
    verify) serializes on ``io_lock``: the bitrot readers are stateful
    streams shared with the lookahead thread. ``reader_gen`` counts
    in-place rebuilds of the readers list, so a verdict formed against
    the old readers cannot condemn a fresh one by index.

    Suspect or probation drives (slow-drive quarantine) sort behind every
    healthy reader (``avoid``), capacity permitting; ``benign_hist``
    carries the readers whose shards went missing for plan reasons in any
    earlier group, so later groups keep treating their absence as benign
    rather than as damage to heal."""

    def __init__(self, eng: ErasureObjects, bucket: str, object_name: str,
                 fi: FileInfo, disks, smeta, codec: Codec, part,
                 offset: int, length: int,
                 suppress_heal_flag: bool = False):
        self.eng = eng
        self.bucket, self.object_name = bucket, object_name
        self.fi, self.disks, self.smeta = fi, disks, smeta
        self.codec, self.part = codec, part
        self.offset, self.length = offset, length
        self.suppress_heal_flag = suppress_heal_flag
        self.n = len(disks)
        self.k = fi.erasure.data_blocks
        self.shard_size = fi.erasure.shard_size()
        self.till = fi.erasure.shard_file_offset(offset, length, part.size)
        self.path = f"{object_name}/{fi.data_dir}/part.{part.number}"
        self.readers: Optional[list] = None
        self.part_algo = None
        self.defer_verify = False
        self.avoid: frozenset = frozenset()
        # cleared on a quorum-loss rebuild, which mints fresh readers
        self.benign_hist: set = set()
        self.io_lock = threading.Lock()
        self.reader_gen = [0]
        self.heal_required = False
        self._pending = None           # live lookahead future
        self._primed = False           # _pending holds OUR group 0
        self.specs: list[tuple[list, list]] = []
        bn = offset // fi.erasure.block_size
        end_block = (offset + length - 1) // fi.erasure.block_size
        while bn <= end_block:
            group_end = min(bn + GET_BATCH_BLOCKS - 1, end_block)
            blocks = list(range(bn, group_end + 1))
            geoms = []
            for b in blocks:
                block_off = b * fi.erasure.block_size
                block_len = min(fi.erasure.block_size,
                                part.size - block_off)
                geoms.append((b, block_off, block_len,
                              -(-block_len // self.k)))
            self.specs.append((blocks, geoms))
            bn = group_end + 1

    def _make_readers(self) -> list:
        out: list = [None] * self.n
        for i, d in enumerate(self.disks):
            if d is None or self.smeta[i] is None:
                continue
            csum = self.smeta[i].erasure.get_checksum_info(self.part.number)
            algo = (bitrot_mod.BitrotAlgorithm.from_string(csum.algorithm)
                    if csum else self.eng.bitrot_algo)
            out[i] = bitrot_io.new_bitrot_reader(
                d, self.bucket, self.path, self.till, algo,
                csum.hash if csum else b"", self.shard_size)
        return out

    def _ensure_readers(self) -> None:
        if self.readers is not None:
            return
        self.readers = self._make_readers()
        # slow-drive quarantine: suspect/probation drives fall to the back
        # of the candidate order (out of primaries and hedge targets), but
        # only capacity permitting: with fewer than k healthy readers the
        # plan keeps everyone in play
        if healthtrack.quarantine_enabled():
            sus = {i for i, r in enumerate(self.readers)
                   if r is not None and healthtrack.is_suspect_disk(r.disk)}
            if sus and sum(1 for r in self.readers
                           if r is not None) - len(sus) >= self.k:
                self.avoid = frozenset(sus)
        # device-routed groups defer per-frame bitrot verification into
        # the fused verify+decode step; small groups verify inline at read
        # time. Deferral needs every reader on one streaming algorithm the
        # device hashes (the digests must be compared under the algorithm
        # the frames were written with; a whole-file reader verifies the
        # whole shard file when it first reads it).
        algos = {r.algo for r in self.readers if r is not None}
        self.part_algo = algos.pop() if len(algos) == 1 else None
        self.defer_verify = (
            self.part_algo is not None and self.part_algo.streaming
            and self.codec._device_hash_kernel(self.part_algo) is not None
            and self.codec._route(GET_BATCH_BLOCKS * self.k
                                  * self.shard_size) == "device")

    def read_group(self, blocks: list, geoms: list
                   ) -> tuple[list, bool, float, frozenset]:
        """One group's raw shard reads; when the group loses read quorum
        (distinct readers failing at distinct blocks), the readers are
        rebuilt and the group is read block by block. Returns (per-block
        reads, degraded, read seconds, benign-missing reader indices:
        plan-caused misses the verify step flags no heal for)."""
        t0 = time.perf_counter()
        degraded = False
        # pre-seeded with earlier groups' plan-caused misses
        benign: set = set(self.benign_hist)
        with self.io_lock, telemetry.span("pipeline.read_group",
                                          blocks=len(blocks)):
            readers = self.readers
            try:
                reads = self.eng._read_group_shards_raw(
                    readers, blocks, self.shard_size,
                    [g[3] for g in geoms], self.k, self.n,
                    collect_digests=self.defer_verify,
                    avoid=self.avoid, benign_sink=benign)
                self.benign_hist = set(benign)
            except api_errors.InsufficientReadQuorum:
                for r in readers:
                    if r is not None:
                        r.close()
                readers[:] = self._make_readers()
                self.reader_gen[0] += 1
                degraded = True
                benign.clear()      # recovery mode: flag everything
                self.benign_hist = set()
                reads = [self.eng._read_block_shards_raw(
                    readers, g[0], self.shard_size, g[3], self.k, self.n,
                    collect_digests=self.defer_verify) for g in geoms]
        return reads, degraded, time.perf_counter() - t0, \
            frozenset(benign)

    def _submit(self, spec):
        """Queue one group's reads on the prefetch pool, carrying the
        caller's span context so the reads attach to the request tree."""
        from ..parallel import pipeline as pl
        cctx = telemetry.propagating_context()
        if cctx is not None:
            return pl.PREFETCH_POOL.submit(cctx.run, self.read_group,
                                           *spec)
        return pl.PREFETCH_POOL.submit(self.read_group, *spec)

    def prime(self) -> None:
        """Issue this part's FIRST group read on the prefetch pool —
        called by the previous part when it reaches its last group."""
        if self._pending is not None or self._primed or not self.specs:
            return
        self._ensure_readers()
        self._pending = self._submit(self.specs[0])
        self._primed = True

    def stream(self, next_plan: Optional["_PartReadPlan"] = None
               ) -> Iterator[bytes]:
        from ..parallel import pipeline as pl
        self._ensure_readers()
        readers = self.readers
        k, n = self.k, self.n
        offset, length = self.offset, self.length
        for si, (blocks, geoms) in enumerate(self.specs):
            group = []
            with stagetimer.stage("get.read_shards"):
                lookahead = self._pending
                self._pending = None
                if lookahead is not None and lookahead.cancel():
                    # still queued behind other streams' prefetch tasks:
                    # reading inline is faster than waiting for it
                    lookahead = None
                    self._primed = False
                if lookahead is not None:
                    t0 = time.perf_counter()
                    reads, degraded, read_s, benign = lookahead.result()
                    pl.STATS.record_get_group(
                        True, time.perf_counter() - t0, read_s)
                else:
                    reads, degraded, _, benign = self.read_group(blocks,
                                                                 geoms)
                    pl.STATS.record_get_group(False)
            gen_at_read = self.reader_gen[0]
            self.heal_required = self.heal_required or degraded
            # issue the NEXT group's reads before this group's
            # verify+decode; at the last group, the next part's first
            if pl.ENABLED and si + 1 < len(self.specs):
                self._pending = self._submit(self.specs[si + 1])
            elif si + 1 == len(self.specs) and next_plan is not None:
                next_plan.prime()
            for (b, block_off, block_len, shard_len), \
                    (shards, digests, had_errors) in zip(geoms, reads):
                self.heal_required = self.heal_required or had_errors
                group.append([b, block_off, block_len, shard_len,
                              shards, digests])
            with stagetimer.stage("get.verify+decode"), \
                    telemetry.span("pipeline.verify_decode",
                                   blocks=len(blocks)):
                if self.eng._verify_and_reconstruct_group(
                        self.codec, group, k, n, readers, self.shard_size,
                        self.part_algo or self.eng.bitrot_algo,
                        io_lock=self.io_lock,
                        reader_gen=(self.reader_gen, gen_at_read),
                        benign_missing=benign):
                    self.heal_required = True
            with stagetimer.stage("get.join"):
                out = []
                for b, block_off, block_len, shard_len, shards, _dg \
                        in group:
                    data = np.concatenate([s[:shard_len]
                                           for s in shards[:k]])
                    begin = max(offset - block_off, 0)
                    end = min(offset + length - block_off, block_len)
                    out.append(data[begin:end].tobytes())
            yield from out
        if self.heal_required and not self.suppress_heal_flag \
                and self.eng.on_degraded_read is not None:
            try:
                self.eng.on_degraded_read(self.bucket, self.object_name)
            except Exception:  # noqa: BLE001 — heal is best-effort
                pass

    def close(self) -> None:
        """Settle any in-flight lookahead, then close the readers (an
        abandoned generator must not leave a pool thread racing closed
        streams)."""
        if self._pending is not None and not self._pending.cancel():
            try:
                self._pending.result()
            except Exception:  # noqa: BLE001 — abandoned read
                pass
        self._pending = None
        if self.readers is not None:
            for r in self.readers:
                if r is not None:
                    r.close()
            self.readers = None


def _encrypted_size(n: int) -> int:
    from ..features.crypto import encrypted_size
    return encrypted_size(n)


def _read_full_into(reader, view: np.ndarray) -> int:
    """io.ReadFull into a caller buffer: fills `view` (a uint8 array
    slice) unless EOF; returns bytes read. Uses the reader's zero-copy
    readinto_full when it has one (HashReader), else read()+copy."""
    fn = getattr(reader, "readinto_full", None)
    if fn is not None:
        return fn(memoryview(view))
    n = len(view)
    got = 0
    while got < n:
        chunk = reader.read(n - got)
        if not chunk:
            break
        view[got:got + len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
        got += len(chunk)
    return got


# ---------------------------------------------------------------------------
# opening a set of local drives
# ---------------------------------------------------------------------------

def from_reference_layout(disk_paths: list[str], k: int, m: int,
                          cls=None, **engine_kw) -> ErasureObjects:
    """Open one erasure set of local drives in the on-disk layout that
    minio_tpu writes (format.json v3, xl.meta v2, bitrot-framed shards).

    Drives that minio_tpu (or this package) formatted are ordered by their
    position in the format's sets matrix, as minio_tpu's ErasureSets
    orders them, so both packages place every shard on the same drive.
    Fresh drives are formatted first. Returns a `cls` (default
    ErasureObjects; object.ErasureSetObjects adds heal) built with
    engine_kw (block_size, device, scheduler, ...)."""
    if len(disk_paths) != k + m:
        raise ValueError(f"{len(disk_paths)} drives for {k}+{m}")
    drives = [XLStorage(p) for p in disk_paths]
    formats: list[Optional[FormatErasureV3]] = []
    for d in drives:
        try:
            formats.append(read_format_from(d))
        except serr.StorageError:
            formats.append(None)
    if all(f is None for f in formats):
        fresh = new_format_erasure_v3(1, k + m)[0]
        for d, f in zip(drives, fresh):
            write_format_to(d, f)
        formats = list(fresh)
    ref = get_format_in_quorum(formats)
    if len(ref.sets) != 1 or len(ref.sets[0]) != k + m:
        raise serr.CorruptedFormat(
            f"format holds {[len(s) for s in ref.sets]} drives per set, "
            f"expected one set of {k + m}")
    by_uuid = {f.this: d for d, f in zip(drives, formats) if f is not None}
    ordered = [by_uuid.get(u) for u in ref.sets[0]]
    return (cls or ErasureObjects)(ordered, k, m, **engine_kw)

