"""XLStorage — one local POSIX drive.

The local implementation of StorageAPI (reference: cmd/xl-storage.go;
counterpart of minio_tpu/storage/xl_storage.py). The on-disk layout is the
reference's, and minio_tpu's, exactly:

    <root>/.minio.sys/format.json          drive identity + topology
    <root>/<bucket>/<object>/xl.meta       version journal (xl_meta.py)
    <root>/<bucket>/<object>/<dataDir>/part.N   bitrot-framed shards
    <root>/.minio.sys/tmp/<uuid>/...       staged writes (2-phase commit)
    <root>/.minio.sys/multipart/<sha>/<uploadID>/  multipart sessions

Writes are staged in tmp and committed with an atomic os.replace-based
rename (reference RenameData, cmd/xl-storage.go:2041).

append_file, create_file, read_file and rename_data each run in the
reference's ``disk.*`` span.

Left out: O_DIRECT shard writes and legacy xl.json migration.
"""

from __future__ import annotations

import io
import os
import shutil
import threading
from typing import BinaryIO, Iterator, Optional

from .. import bitrot as bitrot_mod
from ..utils import atomicfile, crashpoint, telemetry
from . import errors
from .api import BitrotVerifier, StorageAPI
from .datatypes import DiskInfo, FileInfo, VolInfo
from .format import FORMAT_CONFIG_FILE, MINIO_META_BUCKET, FormatErasureV3
from .xl_meta import XLMetaV2

XL_STORAGE_FORMAT_FILE = "xl.meta"
MINIO_META_TMP_BUCKET = MINIO_META_BUCKET + "/tmp"
MINIO_META_MULTIPART_BUCKET = MINIO_META_BUCKET + "/multipart"
MAX_PATH_LEN = 4096


def _check_path_length(p: str) -> None:
    if len(p) > MAX_PATH_LEN:
        raise errors.FileNameTooLong(p)
    for comp in p.split("/"):
        if len(comp) > 255:
            raise errors.FileNameTooLong(comp)


def _check_path_safe(p: str) -> None:
    """Reject path components that would escape the drive root — S3 keys
    may legally contain '..' (the reference rejects these at the storage
    layer too; see cmd/xl-storage.go path checks)."""
    if p.startswith("/") or p.startswith("\\"):
        raise errors.FileAccessDenied(p)
    for comp in p.replace("\\", "/").split("/"):
        if comp == "..":
            raise errors.FileAccessDenied(p)


class _SyncedAppender:
    """Buffered append handle that fsyncs at close — the shard-write
    barrier when atomicfile.fsync_enabled() (a shard referenced by a committed
    xl.meta must not evaporate in a power cut)."""

    def __init__(self, f):
        self._f = f

    def write(self, data) -> int:
        return self._f.write(data)

    def close(self) -> None:
        try:
            atomicfile.fsync_file(self._f)
        finally:
            self._f.close()


class XLStorage(StorageAPI):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        try:
            os.makedirs(self.root, exist_ok=True)
        except PermissionError as e:
            raise errors.DiskAccessDenied(str(e)) from e
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        if not os.access(self.root, os.W_OK):
            raise errors.DiskAccessDenied(self.root)
        self._disk_id = ""
        self._lock = threading.Lock()
        self._online = True
        self._healing = False

    # -- identity ----------------------------------------------------------

    def __str__(self) -> str:
        return self.root

    def is_online(self) -> bool:
        return self._online

    def is_local(self) -> bool:
        return True

    def endpoint(self) -> str:
        return self.root

    def close(self) -> None:
        pass

    def get_disk_id(self) -> str:
        """The drive UUID from format.json (cached)."""
        with self._lock:
            if self._disk_id:
                return self._disk_id
            fmt_path = os.path.join(self.root, MINIO_META_BUCKET,
                                    FORMAT_CONFIG_FILE)
            try:
                with open(fmt_path, "rb") as f:
                    fmt = FormatErasureV3.from_json(f.read())
            except FileNotFoundError:
                raise errors.UnformattedDisk(self.root) from None
            except OSError as e:
                raise errors.FaultyDisk(str(e)) from e
            self._disk_id = fmt.this
            return self._disk_id

    def set_disk_id(self, disk_id: str) -> None:
        # a local drive's ID comes from its format.json (reference
        # xlStorage.SetDiskID is a no-op too)
        pass

    def healing(self) -> bool:
        return self._healing

    def disk_info(self) -> DiskInfo:
        try:
            st = os.statvfs(self.root)
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        disk_id = ""
        try:
            disk_id = self.get_disk_id()
        except errors.StorageError:
            pass
        return DiskInfo(total=total, free=free, used=total - free,
                        fs_type="posix", endpoint=self.root,
                        mount_path=self.root, disk_id=disk_id,
                        healing=self._healing)

    # -- format ------------------------------------------------------------

    def read_format(self) -> FormatErasureV3:
        data = self.read_all(MINIO_META_BUCKET, FORMAT_CONFIG_FILE)
        return FormatErasureV3.from_json(data)

    def write_format(self, fmt: FormatErasureV3) -> None:
        self.make_vol_bulk(MINIO_META_BUCKET, MINIO_META_TMP_BUCKET,
                           MINIO_META_MULTIPART_BUCKET,
                           MINIO_META_BUCKET + "/buckets")
        self.write_all(MINIO_META_BUCKET, FORMAT_CONFIG_FILE,
                       fmt.to_json().encode())
        with self._lock:
            self._disk_id = fmt.this

    # -- paths -------------------------------------------------------------

    def _vol_dir(self, volume: str) -> str:
        if not volume or volume == "." or volume == "..":
            raise errors.VolumeNotFound(volume)
        _check_path_safe(volume)
        return os.path.join(self.root, volume)

    def _file_path(self, volume: str, path: str) -> str:
        _check_path_safe(path)
        p = os.path.join(self._vol_dir(volume), path)
        _check_path_length(p)
        return p

    # -- volumes -----------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        vdir = self._vol_dir(volume)
        if os.path.isdir(vdir):
            raise errors.VolumeExists(volume)
        try:
            os.makedirs(vdir)
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def make_vol_bulk(self, *volumes: str) -> None:
        for v in volumes:
            os.makedirs(self._vol_dir(v), exist_ok=True)

    def list_vols(self) -> list[VolInfo]:
        out = []
        try:
            for name in sorted(os.listdir(self.root)):
                full = os.path.join(self.root, name)
                if os.path.isdir(full) and name != MINIO_META_BUCKET:
                    out.append(VolInfo(name=name,
                                       created=os.stat(full).st_ctime))
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        return out

    def delete_vol(self, volume: str, force: bool = False) -> None:
        vdir = self._vol_dir(volume)
        try:
            if force:
                shutil.rmtree(vdir)
            else:
                os.rmdir(vdir)
        except FileNotFoundError:
            raise errors.VolumeNotFound(volume) from None
        except OSError as e:
            if os.path.isdir(vdir) and os.listdir(vdir):
                raise errors.VolumeNotEmpty(volume) from e
            raise errors.FaultyDisk(str(e)) from e

    def stat_vol(self, volume: str) -> VolInfo:
        vdir = self._vol_dir(volume)
        try:
            st = os.stat(vdir)
        except FileNotFoundError:
            raise errors.VolumeNotFound(volume) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        return VolInfo(name=volume, created=st.st_ctime)

    # -- raw files ---------------------------------------------------------

    def read_all(self, volume: str, path: str) -> bytes:
        fp = self._file_path(volume, path)
        try:
            with open(fp, "rb") as f:
                return f.read()
        except FileNotFoundError:
            if not os.path.isdir(self._vol_dir(volume)):
                raise errors.VolumeNotFound(volume) from None
            raise errors.FileNotFound(path) from None
        except IsADirectoryError:
            raise errors.FileNotFound(path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        fp = self._file_path(volume, path)
        try:
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            # torn-write injection for in-process crash tests: an armed
            # action receives path= and data= and may commit a truncated
            # copy to the final name before aborting
            crashpoint.hit("storage.write_all.commit", path=fp,
                           data=data)
            atomicfile.write_atomic(fp, data)
        except NotADirectoryError:
            raise errors.FileParentIsFile(fp) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def append_file(self, volume: str, path: str, buf: bytes) -> None:
        """Append one buffered batch of shard frames (the remote shard
        write: the storage RPC server lands a peer's appendfile here)."""
        with telemetry.span("disk.append_file", bytes=len(buf)):
            self._append_file(volume, path, buf)

    def _append_file(self, volume: str, path: str, buf: bytes) -> None:
        if not os.path.isdir(self._vol_dir(volume)):
            raise errors.VolumeNotFound(volume)
        fp = self._file_path(volume, path)
        try:
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            with open(fp, "ab") as f:
                f.write(buf)
                # remote drives stream shards through this verb (the RPC
                # client has no appender), so the shard-durable-before-
                # meta-commit barrier lives here too
                atomicfile.fsync_file(f)
        except NotADirectoryError:
            raise errors.FileParentIsFile(fp) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def has_appender(self) -> bool:
        """Capability probe for open_appender (the identity guard
        delegates it, so the probe reflects the backend)."""
        return True

    def open_appender(self, volume: str, path: str):
        """Persistent append handle for the shard-write hot path: the
        bitrot writer streams [digest‖block] frames straight into the
        OS file. Local drives only: remote drives take buffered batches
        through append_file."""
        if not os.path.isdir(self._vol_dir(volume)):
            raise errors.VolumeNotFound(volume)
        fp = self._file_path(volume, path)
        try:
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            f = open(fp, "ab")
            # shard files must be durable BEFORE the xl.meta commit
            # references them: sync at close under the discipline
            return _SyncedAppender(f) if atomicfile.fsync_enabled() else f
        except NotADirectoryError:
            raise errors.FileParentIsFile(fp) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def create_file(self, volume: str, path: str, size: int,
                    reader: BinaryIO) -> None:
        """Stream `size` bytes (exactly) from reader into a fresh file
        (reference CreateFile, cmd/xl-storage.go:1664; errLessData /
        errMoreData on a mismatch)."""
        with telemetry.span("disk.create_file", size=size):
            self._create_file(volume, path, size, reader)

    def _create_file(self, volume: str, path: str, size: int,
                    reader: BinaryIO) -> None:
        fp = self._file_path(volume, path)
        if not os.path.isdir(self._vol_dir(volume)):
            raise errors.VolumeNotFound(volume)
        try:
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            with open(fp, "wb") as f:
                remaining = size
                while True:
                    chunk = reader.read(min(1 << 20, remaining)
                                        if size >= 0 else 1 << 20)
                    if not chunk:
                        break
                    if size >= 0 and len(chunk) > remaining:
                        raise errors.MoreData(path)
                    f.write(chunk)
                    remaining -= len(chunk)
                    if size >= 0 and remaining == 0:
                        if reader.read(1):
                            raise errors.MoreData(path)
                        break
                if size >= 0 and remaining > 0:
                    raise errors.LessData(path)
                atomicfile.fsync_file(f)
        except NotADirectoryError:
            raise errors.FileParentIsFile(fp) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def read_file(self, volume: str, path: str, offset: int, length: int,
                  verifier: Optional[BitrotVerifier] = None) -> bytes:
        """`length` bytes at `offset`; with a verifier, the whole file is
        hashed and checked against its expected digest first."""
        with telemetry.span("disk.read_file", length=length):
            return self._read_file(volume, path, offset, length, verifier)

    def _read_file(self, volume: str, path: str, offset: int, length: int,
                  verifier: Optional[BitrotVerifier] = None) -> bytes:
        fp = self._file_path(volume, path)
        try:
            with open(fp, "rb") as f:
                if verifier is not None:
                    whole = f.read()
                    digest = bitrot_mod.hash_shard(
                        whole, bitrot_mod.BitrotAlgorithm.from_string(
                            verifier.algorithm))
                    if digest != verifier.digest:
                        raise errors.BitrotHashMismatch(
                            verifier.digest.hex(), digest.hex())
                    return whole[offset:offset + length]
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError:
            if not os.path.isdir(self._vol_dir(volume)):
                raise errors.VolumeNotFound(volume) from None
            raise errors.FileNotFound(path) from None
        except IsADirectoryError:
            raise errors.IsNotRegular(path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int):
        fp = self._file_path(volume, path)
        try:
            f = open(fp, "rb")
        except FileNotFoundError:
            if not os.path.isdir(self._vol_dir(volume)):
                raise errors.VolumeNotFound(volume) from None
            raise errors.FileNotFound(path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        f.seek(offset)
        return _LimitedReader(f, length)

    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None:
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        try:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.replace(src, dst)
        except FileNotFoundError:
            raise errors.FileNotFound(src_path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        atomicfile.fsync_dir(os.path.dirname(dst))
        self._cleanup_empty_parents(src_volume, os.path.dirname(src))

    def delete_file(self, volume: str, path: str,
                    recursive: bool = False) -> None:
        fp = self._file_path(volume, path)
        try:
            if os.path.isdir(fp):
                if recursive:
                    shutil.rmtree(fp)
                else:
                    os.rmdir(fp)
            else:
                os.unlink(fp)
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        self._cleanup_empty_parents(volume, os.path.dirname(fp))

    def _cleanup_empty_parents(self, volume: str, dirpath: str) -> None:
        """Remove now-empty parent dirs up to (not incl.) the volume root
        (reference deleteFile parent sweep)."""
        vol = self._vol_dir(volume)
        while dirpath.startswith(vol) and dirpath != vol:
            try:
                os.rmdir(dirpath)
            except OSError:
                return
            dirpath = os.path.dirname(dirpath)

    def check_file(self, volume: str, path: str) -> None:
        fp = self._file_path(volume, path)
        if not os.path.isfile(os.path.join(fp, XL_STORAGE_FORMAT_FILE)):
            raise errors.FileNotFound(path)

    def list_dir(self, volume: str, dir_path: str,
                 count: int = -1) -> list[str]:
        """Sorted entries; directories get a trailing slash (reference
        ListDir/readDirN semantics)."""
        vdir = self._vol_dir(volume)
        if not os.path.isdir(vdir):
            raise errors.VolumeNotFound(volume)
        full = os.path.join(vdir, dir_path) if dir_path else vdir
        try:
            names = sorted(os.listdir(full))
        except (FileNotFoundError, NotADirectoryError):
            raise errors.FileNotFound(dir_path) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        out = []
        for n in names:
            out.append(n + "/" if os.path.isdir(os.path.join(full, n))
                       else n)
            if 0 < count <= len(out):
                break
        return out

    # -- metadata ----------------------------------------------------------

    def _read_xl_meta(self, volume: str, path: str) -> XLMetaV2:
        return XLMetaV2.loads(self.read_all(
            volume, os.path.join(path, XL_STORAGE_FORMAT_FILE)))

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        """Append fi as a version into xl.meta (creating it if absent) —
        reference WriteMetadata (cmd/xl-storage.go:1219)."""
        try:
            meta = self._read_xl_meta(volume, path)
        except errors.FileNotFound:
            meta = XLMetaV2()
        meta.add_version(fi)
        self.write_all(volume, os.path.join(path, XL_STORAGE_FORMAT_FILE),
                       meta.dumps())

    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo:
        meta = self._read_xl_meta(volume, path)
        return meta.to_file_info(volume, path, version_id)

    def read_versions(self, volume: str, path: str) -> list[FileInfo]:
        return self._read_xl_meta(volume, path).list_file_infos(volume,
                                                                path)

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        """Drop one version; purge its data dir; remove xl.meta (and the
        object dir) when the journal empties (reference DeleteVersion,
        cmd/xl-storage.go:1147)."""
        meta = self._read_xl_meta(volume, path)
        data_dir, last = meta.delete_version(fi)
        if data_dir:
            try:
                self.delete_file(volume, os.path.join(path, data_dir),
                                 recursive=True)
            except errors.FileNotFound:
                pass
        if last:
            try:
                self.delete_file(volume,
                                 os.path.join(path, XL_STORAGE_FORMAT_FILE))
            except errors.FileNotFound:
                pass
        else:
            self.write_all(volume,
                           os.path.join(path, XL_STORAGE_FORMAT_FILE),
                           meta.dumps())

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Every part file must exist with its exact shard-file size
        (reference CheckParts, cmd/xl-storage.go)."""
        for part in fi.parts:
            pp = os.path.join(path, fi.data_dir, f"part.{part.number}")
            csum = fi.erasure.get_checksum_info(part.number)
            algo = (bitrot_mod.BitrotAlgorithm.from_string(csum.algorithm)
                    if csum else bitrot_mod.DEFAULT_BITROT_ALGORITHM)
            want = bitrot_mod.bitrot_shard_file_size(
                fi.erasure.shard_file_size(part.size),
                fi.erasure.shard_size(), algo)
            try:
                st = os.stat(self._file_path(volume, pp))
            except FileNotFoundError:
                raise errors.FileNotFound(pp) from None
            except OSError as e:
                raise errors.FaultyDisk(str(e)) from e
            if st.st_size < want:
                raise errors.FileCorrupt(
                    f"{pp}: size {st.st_size} < expected {want}")

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Full bitrot scan of every part (reference VerifyFile,
        cmd/xl-storage.go:2410): streaming algorithms verify each
        [digest||block] frame; whole-file algorithms hash the entire shard
        against the digest in xl.meta."""
        for part in fi.parts:
            pp = os.path.join(path, fi.data_dir, f"part.{part.number}")
            csum = fi.erasure.get_checksum_info(part.number)
            algo = (bitrot_mod.BitrotAlgorithm.from_string(csum.algorithm)
                    if csum else bitrot_mod.DEFAULT_BITROT_ALGORITHM)
            try:
                f = open(self._file_path(volume, pp), "rb")
            except FileNotFoundError:
                raise errors.FileNotFound(pp) from None
            except OSError as e:
                raise errors.FaultyDisk(str(e)) from e
            with f:
                if algo.streaming:
                    self._verify_streaming(f, fi, part.size, algo, pp)
                    continue
                h = bitrot_mod.new_hasher(algo)
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    h.update(chunk)
                if csum and csum.hash and h.digest() != csum.hash:
                    raise errors.BitrotHashMismatch(csum.hash.hex(),
                                                    h.digest().hex())

    @staticmethod
    def _verify_streaming(f, fi: FileInfo, part_size: int, algo,
                          pp: str) -> None:
        shard_size = fi.erasure.shard_size()
        remaining = fi.erasure.shard_file_size(part_size)
        while remaining > 0:
            want = f.read(algo.digest_size)
            n = min(shard_size, remaining)
            block = f.read(n)
            if len(want) != algo.digest_size or len(block) != n:
                raise errors.FileCorrupt(f"{pp}: truncated bitrot frame")
            got = bitrot_mod.hash_shard(block, algo)
            if got != want:
                raise errors.BitrotHashMismatch(want.hex(), got.hex())
            remaining -= n

    def rename_data(self, src_volume: str, src_path: str, data_dir: str,
                    dst_volume: str, dst_path: str,
                    version_id: str = "") -> None:
        """Commit a staged write: merge the staged version of src's
        xl.meta into dst's journal, move the data dir, drop src
        (reference RenameData, cmd/xl-storage.go:2041). `version_id`
        names the version committed: a multipart session's staged meta
        also holds the session's own entry, so "latest" may be the wrong
        one; without it the latest is taken."""
        with telemetry.span("disk.rename_data"):
            self._rename_data(src_volume, src_path, data_dir,
                              dst_volume, dst_path, version_id)

    def _rename_data(self, src_volume: str, src_path: str, data_dir: str,
                    dst_volume: str, dst_path: str,
                    version_id: str = "") -> None:
        src_meta = self._read_xl_meta(src_volume, src_path)
        fi = src_meta.to_file_info(dst_volume, dst_path, version_id)
        try:
            dst_meta = self._read_xl_meta(dst_volume, dst_path)
        except errors.FileNotFound:
            dst_meta = XLMetaV2()
        dst_meta.add_version(fi)

        if data_dir:
            src_data = self._file_path(src_volume,
                                       os.path.join(src_path, data_dir))
            dst_data = self._file_path(dst_volume,
                                       os.path.join(dst_path, data_dir))
            try:
                os.makedirs(os.path.dirname(dst_data), exist_ok=True)
                if os.path.isdir(dst_data):
                    shutil.rmtree(dst_data)
                os.replace(src_data, dst_data)
            except FileNotFoundError:
                raise errors.FileNotFound(src_path) from None
            except OSError as e:
                raise errors.FaultyDisk(str(e)) from e
            atomicfile.fsync_dir(os.path.dirname(dst_data))

        # the single-drive torn window: data dir in place, xl.meta not
        # yet rewritten
        crashpoint.hit("storage.rename_data.before_meta")
        self.write_all(dst_volume,
                       os.path.join(dst_path, XL_STORAGE_FORMAT_FILE),
                       dst_meta.dumps())
        try:
            self.delete_file(src_volume, src_path, recursive=True)
        except errors.FileNotFound:
            pass


    # -- walk --------------------------------------------------------------

    def walk(self, volume: str, dir_path: str = "", marker: str = "",
             recursive: bool = True) -> Iterator[FileInfo]:
        """Lexically sorted stream of latest-version FileInfos under a
        prefix (reference Walk, cmd/xl-storage.go:1015)."""
        vdir = self._vol_dir(volume)
        if not os.path.isdir(vdir):
            raise errors.VolumeNotFound(volume)

        def _walk(rel: str) -> Iterator[FileInfo]:
            full = os.path.join(vdir, rel) if rel else vdir
            try:
                entries = sorted(os.listdir(full))
            except OSError:
                return
            if XL_STORAGE_FORMAT_FILE in entries:
                if rel and (not marker or rel > marker):
                    try:
                        yield self.read_version(volume, rel)
                    except errors.StorageError:
                        pass
                return
            for e in entries:
                sub = os.path.join(rel, e) if rel else e
                subfull = os.path.join(full, e)
                if not os.path.isdir(subfull):
                    continue
                if recursive:
                    yield from _walk(sub)
                elif os.path.isfile(
                        os.path.join(subfull, XL_STORAGE_FORMAT_FILE)):
                    # flat object: yield it, not a pseudo-prefix
                    if not marker or sub > marker:
                        try:
                            yield self.read_version(volume, sub)
                        except errors.StorageError:
                            pass
                elif not marker or sub > marker:
                    yield FileInfo(volume=volume, name=sub + "/")

        yield from _walk(dir_path)

    def walk_versions(self, volume: str, dir_path: str = "",
                      marker: str = "", recursive: bool = True
                      ) -> Iterator[list[FileInfo]]:
        for fi in self.walk(volume, dir_path, marker, recursive):
            if fi.name.endswith("/"):
                continue
            try:
                yield self.read_versions(volume, fi.name)
            except errors.StorageError:
                pass


class _LimitedReader(io.RawIOBase):
    """Reads at most `length` bytes from an underlying file, closing it
    on exhaustion (reference ReadFileStream's LimitReader)."""

    def __init__(self, f, length: int):
        self._f = f
        self._remaining = length

    def read(self, n: int = -1) -> bytes:
        if self._remaining <= 0:
            return b""
        if n is None or n < 0:
            n = self._remaining
        data = self._f.read(min(n, self._remaining))
        self._remaining -= len(data)
        if not data:
            self._remaining = 0
        return data

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            super().close()
