"""XLStorage — one local POSIX drive.

The local implementation of StorageAPI (reference: cmd/xl-storage.go),
trimmed to the verbs of the erasure-coded PUT, GET, DELETE and heal
(check_parts, verify_file). The on-disk
layout is the reference's, and minio_tpu's, exactly:

    <root>/.minio.sys/format.json          drive identity + topology
    <root>/<bucket>/<object>/xl.meta       version journal (xl_meta.py)
    <root>/<bucket>/<object>/<dataDir>/part.N   bitrot-framed shards
    <root>/.minio.sys/tmp/<uuid>/...       staged writes (2-phase commit)

Writes are staged in tmp and committed with an atomic os.replace-based
rename (reference RenameData, cmd/xl-storage.go:2041).
"""

from __future__ import annotations

import io
import os
import shutil
import threading

from .. import bitrot as bitrot_mod
from ..utils import atomicfile
from . import errors
from .api import StorageAPI
from .datatypes import FileInfo, VolInfo
from .format import FORMAT_CONFIG_FILE, MINIO_META_BUCKET, FormatErasureV3
from .xl_meta import XLMetaV2

XL_STORAGE_FORMAT_FILE = "xl.meta"
MINIO_META_TMP_BUCKET = MINIO_META_BUCKET + "/tmp"
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
    barrier when atomicfile.FSYNC is on (a shard referenced by a committed
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

    def __str__(self) -> str:
        return self.root

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
            atomicfile.write_atomic(fp, data)
        except NotADirectoryError:
            raise errors.FileParentIsFile(fp) from None
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def open_appender(self, volume: str, path: str):
        """Persistent append handle for the shard-write hot path: the
        bitrot writer streams [digest‖block] frames straight into the
        OS file."""
        if not os.path.isdir(self._vol_dir(volume)):
            raise errors.VolumeNotFound(volume)
        fp = self._file_path(volume, path)
        try:
            os.makedirs(os.path.dirname(fp), exist_ok=True)
            f = open(fp, "ab")
            # shard files must be durable BEFORE the xl.meta commit
            # references them: sync at close under the discipline
            return _SyncedAppender(f) if atomicfile.FSYNC else f
        except NotADirectoryError:
            raise errors.FileParentIsFile(fp) from None
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
        cmd/xl-storage.go:2410): each [digest||block] frame of the
        streaming framing is hashed on the host."""
        for part in fi.parts:
            pp = os.path.join(path, fi.data_dir, f"part.{part.number}")
            csum = fi.erasure.get_checksum_info(part.number)
            algo = (bitrot_mod.BitrotAlgorithm.from_string(csum.algorithm)
                    if csum else bitrot_mod.DEFAULT_BITROT_ALGORITHM)
            if not algo.streaming:
                raise NotImplementedError(
                    f"bitrot algorithm {algo.value!r}: only streaming "
                    "framing is ported")
            try:
                f = open(self._file_path(volume, pp), "rb")
            except FileNotFoundError:
                raise errors.FileNotFound(pp) from None
            except OSError as e:
                raise errors.FaultyDisk(str(e)) from e
            shard_size = fi.erasure.shard_size()
            remaining = fi.erasure.shard_file_size(part.size)
            with f:
                while remaining > 0:
                    want = f.read(algo.digest_size)
                    n = min(shard_size, remaining)
                    block = f.read(n)
                    if len(want) != algo.digest_size or len(block) != n:
                        raise errors.FileCorrupt(
                            f"{pp}: truncated bitrot frame")
                    got = bitrot_mod.hash_shard(block, algo)
                    if got != want:
                        raise errors.BitrotHashMismatch(want.hex(),
                                                        got.hex())
                    remaining -= n

    def rename_data(self, src_volume: str, src_path: str, data_dir: str,
                    dst_volume: str, dst_path: str) -> None:
        """Commit a staged write: merge the staged version of src's
        xl.meta into dst's journal, move the data dir, drop src
        (reference RenameData, cmd/xl-storage.go:2041)."""
        src_meta = self._read_xl_meta(src_volume, src_path)
        fi = src_meta.to_file_info(dst_volume, dst_path)
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

        self.write_all(dst_volume,
                       os.path.join(dst_path, XL_STORAGE_FORMAT_FILE),
                       dst_meta.dumps())
        try:
            self.delete_file(src_volume, src_path, recursive=True)
        except errors.FileNotFound:
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
