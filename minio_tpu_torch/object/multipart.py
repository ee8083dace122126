"""Multipart upload sessions (reference cmd/erasure-multipart.go;
counterpart of minio_tpu/object/multipart.py).

Sessions live under ``.minio.sys/multipart/<sha256(bucket/object)>/
<uploadID>/`` — a flat v3-format hierarchy: the session's xl.meta holds
the user metadata + the parts recorded so far; each part is separately
erasure-coded into ``<dataDir>/part.N`` with bitrot framing
(PutObjectPart encodes exactly like PutObject, cmd/erasure-multipart.go:430).
CompleteMultipartUpload validates the client's part list, freezes the
final FileInfo, and commits the whole session dir with the same
rename_data 2-phase commit PUT uses.

Departure from the reference: under a whole-file bitrot algorithm
(sha256, blake2b, highwayhash256) each drive's xl.meta records the digest
of that drive's own part file, as MinIO's PutObjectPart does
(cmd/erasure-multipart.go, AddChecksumInfo per drive), and reads verify
it. minio_tpu records an empty digest for every multipart part, so its
multipart objects are read unverified. Streaming
algorithms store no digest in xl.meta, and there the journals are the
reference's byte for byte.

Each part's blocks go through the same PUT loop as a single-part object,
so concurrent part uploads share the batch former's fused device
dispatches (models/pipeline.put_step) with every other PUT of the set and
of every set that shares the former.

Crash safety: a session is resumable by uploadID at any point — parts
already uploaded survive process restarts because they live on the
drives.
"""

from __future__ import annotations

import copy
import hashlib
import uuid as _uuid
from typing import Optional

from ..utils import crashpoint, healthtrack
from ..storage import errors as serr
from ..storage.datatypes import (NULL_VERSION_ID, ChecksumInfo, FileInfo,
                                 ObjectInfo, now)
from ..storage.xl_storage import (MINIO_META_MULTIPART_BUCKET,
                                  MINIO_META_TMP_BUCKET)
from . import api_errors, bitrot_io, metadata as meta
from .engine import ErasureObjects, PutOptions
from .hash_reader import HashReader

MIN_PART_SIZE = 5 << 20  # S3: every part but the last >= 5 MiB


class CompletePart:
    def __init__(self, part_number: int, etag: str):
        self.part_number = part_number
        self.etag = etag


class PartInfo:
    def __init__(self, part_number: int, etag: str, size: int,
                 actual_size: int, last_modified: float):
        self.part_number = part_number
        self.etag = etag
        self.size = size
        self.actual_size = actual_size
        self.last_modified = last_modified


class MultipartMixin(ErasureObjects):
    # -- paths -------------------------------------------------------------

    @staticmethod
    def _mp_sha_dir(bucket: str, object_name: str) -> str:
        return hashlib.sha256(
            f"{bucket}/{object_name}".encode()).hexdigest()

    def _upload_dir(self, bucket: str, object_name: str,
                    upload_id: str) -> str:
        return f"{self._mp_sha_dir(bucket, object_name)}/{upload_id}"

    def _check_upload_exists(self, bucket: str, object_name: str,
                             upload_id: str) -> FileInfo:
        return self._read_session(bucket, object_name, upload_id)[0]

    def _read_session(self, bucket: str, object_name: str,
                      upload_id: str) -> tuple[FileInfo, list]:
        """(the session's quorum FileInfo, every drive's own journal or
        None): each drive's journal holds its own part digests."""
        path = self._upload_dir(bucket, object_name, upload_id)
        metas, errs = meta.read_all_file_info(
            self.disks, MINIO_META_MULTIPART_BUCKET, path)
        live = [fi for fi in metas if fi is not None]
        if not live:
            raise api_errors.InvalidUploadID(upload_id)
        k = live[0].erasure.data_blocks
        try:
            return meta.pick_valid_file_info(metas, max(1, k)), metas
        except api_errors.InsufficientReadQuorum:
            raise api_errors.InvalidUploadID(upload_id) from None

    def _part_digests(self, writers, distribution) -> list[bytes]:
        """Per drive (disk order), the whole-file digest of the part file
        it was written, b"" for a streaming algorithm or a lost writer."""
        out = [b""] * len(self.disks)
        if self.bitrot_algo.streaming:
            return out
        for j in range(len(self.disks)):
            w = writers[distribution[j] - 1] if distribution else writers[j]
            if w is not None:
                out[j] = w.digest()
        return out

    def get_multipart_info(self, bucket: str, object_name: str,
                           upload_id: str) -> dict:
        """Session metadata of an in-progress upload (SSE seals etc.)."""
        fi = self._check_upload_exists(bucket, object_name, upload_id)
        return dict(fi.metadata)

    # -- session lifecycle -------------------------------------------------

    def new_multipart_upload(self, bucket: str, object_name: str,
                             opts: Optional[PutOptions] = None,
                             upload_id: Optional[str] = None) -> str:
        """`upload_id` reuses a caller-held id instead of minting one:
        the decommission drain migrates a LIVE session between pools
        and the client's id must keep resolving across the move."""
        opts = opts or PutOptions()
        self.get_bucket_info(bucket)
        k, m, _, write_quorum = self._default_quorums(opts.parity)
        upload_id = upload_id or str(_uuid.uuid4())
        path = self._upload_dir(bucket, object_name, upload_id)

        from ..storage.datatypes import new_file_info
        fi = new_file_info(f"{bucket}/{object_name}", k, m)
        fi.erasure.block_size = self.block_size
        fi.volume = MINIO_META_MULTIPART_BUCKET
        fi.name = path
        fi.data_dir = str(_uuid.uuid4())
        fi.mod_time = now()
        fi.metadata = dict(opts.metadata)
        # the sha-dir layout loses bucket + object name; keep them in the
        # session metadata so bucket-wide upload listings can report real
        # keys and never leak another bucket's uploads (the multipart
        # meta volume is shared by ALL buckets)
        fi.metadata["x-minio-internal-bucket"] = bucket
        fi.metadata["x-minio-internal-object-name"] = object_name
        if opts.versioned:
            fi.metadata["x-minio-internal-versioned"] = "true"

        metas = [fi.light_copy() for _ in self.disks]
        meta.write_unique_file_info(self.disks, MINIO_META_MULTIPART_BUCKET,
                                    path, metas, write_quorum)
        return upload_id

    def put_object_part(self, bucket: str, object_name: str,
                        upload_id: str, part_number: int, reader,
                        size: int = -1) -> PartInfo:
        if not (1 <= part_number <= 10000):
            raise api_errors.InvalidPart(part_number)
        if isinstance(reader, (bytes, bytearray)):
            import io as _io
            size = len(reader)
            reader = HashReader(_io.BytesIO(reader), size)
        elif not isinstance(reader, HashReader):
            reader = HashReader(reader, size)

        with self.ns.new_lock(
                f"{bucket}/{object_name}/{upload_id}").write_locked():
            session_fi, session_metas = self._read_session(
                bucket, object_name, upload_id)
            k = session_fi.erasure.data_blocks
            m = session_fi.erasure.parity_blocks
            write_quorum = meta.write_quorum_for(k, m)
            codec = self.codec(k, m)
            path = self._upload_dir(bucket, object_name, upload_id)
            shuffled = meta.shuffle_disks(self.disks,
                                          session_fi.erasure.distribution)

            tmp_id = str(_uuid.uuid4())
            tmp_part = f"{tmp_id}/part.{part_number}"
            writers: list[Optional[object]] = []
            for d in shuffled:
                writers.append(None if d is None else
                               bitrot_io.new_bitrot_writer(
                                   d, MINIO_META_TMP_BUCKET, tmp_part, -1,
                                   self.bitrot_algo, codec.shard_size))
            try:
                total = self._encode_stream(reader, codec, writers,
                                            write_quorum)
                reader.verify()
                etag = reader.md5_current_hex()

                def close_writer(i, d):
                    w = writers[i]
                    if w is None:
                        raise serr.DiskNotFound(f"writer {i}")
                    w.close()

                # quorum-ack: the part upload, like the single-part
                # PUT, must not wait out a gray drive once quorum is
                # durable — the laggard's missing shard surfaces as a
                # rename error at complete and heals through MRF
                stall = healthtrack.write_stall_s()
                _, errs = meta.for_each_disk_quorum(
                    shuffled, close_writer, write_quorum,
                    stall_s=stall, stage="close")
                for i, e in enumerate(errs):
                    if e is not None:
                        writers[i] = None
                digests = self._part_digests(
                    writers, session_fi.erasure.distribution)

                # move the staged part into the session's data dir
                dst = f"{path}/{session_fi.data_dir}/part.{part_number}"

                # staged shards exist, the session journal has never
                # seen the part — a crash here loses only tmp garbage
                crashpoint.hit("multipart.part.before_rename")

                def rename(i, d):
                    if writers[i] is None:
                        raise serr.DiskNotFound(f"writer {i}")
                    d.rename_file(MINIO_META_TMP_BUCKET, tmp_part,
                                  MINIO_META_MULTIPART_BUCKET, dst)

                _, errs = meta.for_each_disk_quorum(
                    shuffled, rename, write_quorum, stall_s=stall,
                    stage="rename")
                err = meta.reduce_write_quorum_errs(
                    errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
                if err is not None:
                    raise api_errors.to_object_err(err, bucket, object_name)
            finally:
                reader.close()  # stop the async hasher even on failure
                self._cleanup_tmp(shuffled, tmp_id)

            # record the part in the session journal
            session_fi.add_object_part(part_number, etag, total,
                                       reader.actual_size
                                       if reader.actual_size >= 0 else total)
            session_fi.mod_time = now()
            metas = []
            for j in range(len(self.disks)):
                # each drive keeps its own digests of the earlier parts; a
                # drive that lost its journal gets none for them
                own = session_metas[j]
                prev = own.erasure.checksums if own is not None else [
                    ChecksumInfo(c.part_number, c.algorithm, b"")
                    for c in session_fi.erasure.checksums]
                m_j = session_fi.light_copy()
                m_j.erasure.checksums = [
                    ChecksumInfo(c.part_number, c.algorithm, c.hash)
                    for c in prev if c.part_number != part_number]
                m_j.erasure.checksums.append(ChecksumInfo(
                    part_number, self.bitrot_algo.value, digests[j]))
                metas.append(m_j)
            meta.write_unique_file_info(
                self.disks, MINIO_META_MULTIPART_BUCKET, path, metas,
                write_quorum)
            # actual_size = client (plaintext) bytes; total = stored
            # bytes (ciphertext under SSE) — keep the returned PartInfo
            # consistent with the session journal entry above
            return PartInfo(part_number, etag, total,
                            reader.actual_size
                            if reader.actual_size >= 0 else total, now())

    def list_object_parts(self, bucket: str, object_name: str,
                          upload_id: str, part_marker: int = 0,
                          max_parts: int = 1000) -> list[PartInfo]:
        fi = self._check_upload_exists(bucket, object_name, upload_id)
        out = [PartInfo(p.number, p.etag, p.size, p.actual_size, fi.mod_time)
               for p in fi.parts if p.number > part_marker]
        return out[:max_parts]

    def read_multipart_part(self, bucket: str, object_name: str,
                            upload_id: str, part_number: int):
        """Decode ONE uncommitted session part back into plaintext —
        the read half of a live-session migration (decommission drains
        in-flight uploads instead of waiting them out). Returns
        (PartInfo, chunk iterator); the same verified/reconstructing
        group readers the GET path uses, pointed at the session's
        ``part.N`` files under the multipart meta volume."""
        path = self._upload_dir(bucket, object_name, upload_id)
        metas, _errs = meta.read_all_file_info(
            self.disks, MINIO_META_MULTIPART_BUCKET, path)
        live = [fi for fi in metas if fi is not None]
        if not live:
            raise api_errors.InvalidUploadID(upload_id)
        k = live[0].erasure.data_blocks
        try:
            fi = meta.pick_valid_file_info(metas, max(1, k))
        except api_errors.InsufficientReadQuorum:
            raise api_errors.InvalidUploadID(upload_id) from None
        part = next((p for p in fi.parts if p.number == part_number),
                    None)
        if part is None:
            raise api_errors.InvalidPart(part_number)
        disks = meta.shuffle_disks(self.disks, fi.erasure.distribution)
        smeta = meta.shuffle_parts_metadata(metas,
                                            fi.erasure.distribution)
        codec = self.codec(fi.erasure.data_blocks,
                           fi.erasure.parity_blocks)
        info = PartInfo(part.number, part.etag, part.size,
                        part.actual_size, fi.mod_time)
        stream = self._read_part(MINIO_META_MULTIPART_BUCKET, path, fi,
                                 disks, smeta, codec, part, 0, part.size)
        return info, stream

    def _scan_multipart_sessions(self, sha_dirs=None):
        """(owner_bucket, object, upload_id, fi) for every session the
        first healthy disk can list (shared by the per-bucket lister
        and the decommission sweep — ONE scan implementation to keep
        in sync). `sha_dirs` narrows the walk to known sha prefixes."""
        for d in self.disks:
            if d is None:
                continue
            try:
                dirs = sha_dirs if sha_dirs is not None else \
                    d.list_dir(MINIO_META_MULTIPART_BUCKET, "")
                for sha in dirs:
                    try:
                        ids = d.list_dir(MINIO_META_MULTIPART_BUCKET,
                                         sha.rstrip("/"))
                    except serr.StorageError:
                        continue
                    for uid in ids:
                        uid = uid.rstrip("/")
                        path = f"{sha.rstrip('/')}/{uid}"
                        try:
                            fi = d.read_version(
                                MINIO_META_MULTIPART_BUCKET, path)
                        except serr.StorageError:
                            continue
                        yield (fi.metadata.get(
                            "x-minio-internal-bucket", ""),
                            fi.metadata.get(
                                "x-minio-internal-object-name", ""),
                            uid, fi)
                return
            except serr.StorageError:
                continue

    def list_multipart_uploads(self, bucket: str, object_name: str = ""
                               ) -> list[dict]:
        """Uploads in progress (for `object_name` if given): each entry is
        {"object", "upload_id", "initiated"} read from the session
        xl.meta (cmd/erasure-multipart.go ListMultipartUploads)."""
        sha_dirs = [self._mp_sha_dir(bucket, object_name) + "/"] \
            if object_name else None
        out: list[dict] = []
        for owner, obj, uid, fi in \
                self._scan_multipart_sessions(sha_dirs):
            # shared volume holds ALL buckets; ownerless (pre-layout)
            # sessions count toward the requested bucket
            if (owner or bucket) != bucket:
                continue
            out.append({"object": obj or object_name,
                        "upload_id": uid, "initiated": fi.mod_time})
        out.sort(key=lambda u: (u["object"], u["upload_id"]))
        return out

    def list_all_multipart_uploads(self) -> list[dict]:
        """Every live session in the shared multipart meta volume,
        each entry carrying its owning ``bucket`` — ONE volume scan
        for the decommission sweep instead of a full rescan per
        bucket."""
        out = [{"bucket": owner, "object": obj, "upload_id": uid,
                "initiated": fi.mod_time}
               for owner, obj, uid, fi in self._scan_multipart_sessions()
               if owner]               # pre-layout session: no owner
        out.sort(key=lambda u: (u["bucket"], u["object"],
                                u["upload_id"]))
        return out

    def mark_multipart_session(self, bucket: str, object_name: str,
                               upload_id: str,
                               extra: dict[str, str]) -> None:
        """Merge `extra` into the session journal's metadata (the
        migration-progress marker). Caller holds the session write
        lock — this writes the journal raw, exactly like the part
        recorder above."""
        fi = self._check_upload_exists(bucket, object_name, upload_id)
        fi.metadata.update(extra)
        k, m = fi.erasure.data_blocks, fi.erasure.parity_blocks
        path = self._upload_dir(bucket, object_name, upload_id)
        metas = [fi.light_copy() for _ in self.disks]
        meta.write_unique_file_info(
            self.disks, MINIO_META_MULTIPART_BUCKET, path, metas,
            meta.write_quorum_for(k, m))

    def abort_multipart_upload(self, bucket: str, object_name: str,
                               upload_id: str) -> None:
        self._check_upload_exists(bucket, object_name, upload_id)
        path = self._upload_dir(bucket, object_name, upload_id)

        def rm(i, d):
            try:
                d.delete_file(MINIO_META_MULTIPART_BUCKET, path,
                              recursive=True)
            except serr.FileNotFound:
                pass

        meta.for_each_disk(self.disks, rm)

    def complete_multipart_upload(self, bucket: str, object_name: str,
                                  upload_id: str,
                                  parts: list[CompletePart],
                                  version_id: str = "",
                                  mod_time: Optional[float] = None,
                                  if_none_newer: bool = False
                                  ) -> ObjectInfo:
        """`version_id`/`mod_time` are the version-faithful replay form
        (replication apply + tier restore): the committed object keeps
        the SOURCE version's identity instead of minting fresh ones, so
        a multipart object crosses sites with its part boundaries AND
        its multipart etag intact. `if_none_newer` applies the same
        atomic unversioned conflict gate the single-part replay uses
        (PutOptions.if_none_newer). S3 handlers never pass any of
        them."""
        with self.ns.new_lock(
                f"{bucket}/{object_name}/{upload_id}").write_locked():
            session_fi, session_metas = self._read_session(
                bucket, object_name, upload_id)
            k = session_fi.erasure.data_blocks
            m = session_fi.erasure.parity_blocks
            write_quorum = meta.write_quorum_for(k, m)
            path = self._upload_dir(bucket, object_name, upload_id)

            by_number = {p.number: p for p in session_fi.parts}
            total = 0
            md5_concat = b""
            final_parts = []
            for idx, cp in enumerate(parts):
                have = by_number.get(cp.part_number)
                if have is None or have.etag != cp.etag.strip('"'):
                    raise api_errors.InvalidPart(
                        cp.part_number, cp.etag,
                        have.etag if have else "missing")
                if (idx != len(parts) - 1
                        and have.size < MIN_PART_SIZE):
                    raise api_errors.PartTooSmall(cp.part_number, have.size)
                total += have.size
                md5_concat += bytes.fromhex(have.etag)
                final_parts.append(have)

            etag = (hashlib.md5(md5_concat).hexdigest()
                    + f"-{len(parts)}")

            fi = copy.deepcopy(session_fi)
            fi.volume, fi.name = bucket, object_name
            fi.size = total
            fi.mod_time = mod_time if mod_time else now()
            fi.parts = final_parts
            fi.metadata["etag"] = etag
            versioned_session = fi.metadata.pop(
                "x-minio-internal-versioned", "")
            if version_id:
                fi.version_id = version_id
            elif versioned_session:
                fi.version_id = str(_uuid.uuid4())
            fi.erasure.checksums = [
                ChecksumInfo(p.number, self.bitrot_algo.value, b"")
                for p in final_parts]

            # drop uncommitted parts' shard files
            keep = {p.number for p in final_parts}
            extra = [p for p in session_fi.parts if p.number not in keep]

            def drop_extra(i, d):
                for p in extra:
                    try:
                        d.delete_file(
                            MINIO_META_MULTIPART_BUCKET,
                            f"{path}/{fi.data_dir}/part.{p.number}")
                    except serr.StorageError:
                        pass

            if extra:
                meta.for_each_disk(self.disks, drop_extra)

            metas = []
            for j in range(len(self.disks)):
                own = {c.part_number: c.hash
                       for c in (session_metas[j].erasure.checksums
                                 if session_metas[j] is not None else [])}
                m_j = fi.light_copy()
                for c in m_j.erasure.checksums:
                    c.hash = own.get(c.part_number, b"")
                metas.append(m_j)
            with self.ns.new_lock(f"{bucket}/{object_name}").write_locked():
                if if_none_newer:
                    # the replication apply's atomic last-writer-wins,
                    # inside the same lock the commit holds (the
                    # single-part path's PutOptions.if_none_newer gate)
                    self._check_none_newer(bucket, object_name, fi)
                meta.write_unique_file_info(
                    self.disks, MINIO_META_MULTIPART_BUCKET, path, metas,
                    write_quorum)
                # final session meta written, object not yet renamed
                # into the namespace: the session must survive intact
                crashpoint.hit("multipart.complete.before_rename")

                def rename(i, d):
                    # one hit per drive (arm :<nth>): a torn complete
                    crashpoint.hit("multipart.complete.rename.partial",
                                   disk=i)
                    # name the committed version: the session meta also
                    # holds the placeholder entry, and a version-
                    # faithful replay's preserved mod time can sort
                    # behind it ("latest" would commit the placeholder)
                    d.rename_data(MINIO_META_MULTIPART_BUCKET, path,
                                  fi.data_dir, bucket, object_name,
                                  fi.version_id or NULL_VERSION_ID)

                # quorum-ack commit: a drive stalling mid-rename must
                # not hold the CompleteMultipartUpload response once
                # quorum is durable — the laggard lands in `errs` and
                # feeds MRF below exactly like a failed rename; when an
                # abandoned rename settles LATE it may have laid an
                # older version over a newer commit, so it re-queues
                # the MRF check against then-current quorum state
                _, errs = meta.for_each_disk_quorum(
                    self.disks, rename, write_quorum,
                    stall_s=healthtrack.write_stall_s(), stage="rename",
                    on_settle=lambda _i: self._notify_degraded(
                        bucket, object_name, fi.version_id))
                err = meta.reduce_write_quorum_errs(
                    errs, meta.OBJECT_OP_IGNORED_ERRS, write_quorum)
                if err is not None:
                    raise api_errors.to_object_err(err, bucket, object_name)
            if any(e is not None for e in errs):
                # commit met quorum but some drives missed the rename:
                # the completed object is degraded on those drives —
                # feed the MRF heal queue exactly like a degraded PUT
                self._notify_degraded(bucket, object_name, fi.version_id)
            self._notify_namespace(bucket, object_name)
            return fi.to_object_info(bucket, object_name)
