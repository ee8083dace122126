"""Disk-identity guard wrapper (cmd/xl-storage-disk-id-check.go;
counterpart of minio_tpu/storage/diskid_check.py).

Wraps a StorageAPI and verifies the drive still carries the expected
format UUID before letting calls through — a drive swapped or reformatted
behind a running set must read as DiskStale, never serve wrong shards.
The check is cached and re-validated on an interval (and after any
failure), not per call.
"""

from __future__ import annotations

import threading
import time

from . import errors
from .api import StorageAPI
from .datatypes import DiskInfo

CHECK_INTERVAL = 10.0


class DiskIDCheck(StorageAPI):
    def __init__(self, inner: StorageAPI, expected_id: str,
                 interval: float = CHECK_INTERVAL):
        self.inner = inner
        self.expected = expected_id
        self.interval = interval
        self._mu = threading.Lock()
        self._checked_at = 0.0
        self._ok = False

    # -- the guard ---------------------------------------------------------

    def _verify(self) -> None:
        now = time.monotonic()
        with self._mu:
            if self._ok and now - self._checked_at < self.interval:
                return
        try:
            # read the format itself, not get_disk_id: local drives cache
            # their ID in memory and would mask an on-disk swap
            from .format import read_format_from
            got = read_format_from(self.inner).this
        except errors.StorageError:
            with self._mu:
                self._ok = False
            raise
        if got != self.expected:
            with self._mu:
                self._ok = False
            raise errors.DiskStale(
                f"disk id {got!r} != expected {self.expected!r}")
        with self._mu:
            self._ok = True
            self._checked_at = now

    def _invalidate(self) -> None:
        with self._mu:
            self._ok = False

    def _call(self, fn, *args, **kw):
        self._verify()
        try:
            return fn(*args, **kw)
        except errors.DiskNotFound:
            self._invalidate()
            raise

    # -- identity ----------------------------------------------------------

    def __getattr__(self, name):
        # passthrough for backend-specific attributes (e.g. XLStorage
        # .root, .read_format) — only called when not found on self
        return getattr(self.inner, name)

    def __str__(self) -> str:
        return str(self.inner)

    def is_online(self) -> bool:
        return self.inner.is_online()

    def is_local(self) -> bool:
        return self.inner.is_local()

    def hostname(self) -> str:
        return self.inner.hostname()

    def endpoint(self) -> str:
        return self.inner.endpoint()

    def close(self) -> None:
        self.inner.close()

    def get_disk_id(self) -> str:
        return self.inner.get_disk_id()

    def set_disk_id(self, disk_id: str) -> None:
        self.expected = disk_id
        self._invalidate()
        self.inner.set_disk_id(disk_id)

    def disk_info(self) -> DiskInfo:
        return self._call(self.inner.disk_info)

    # -- delegated verbs ---------------------------------------------------

    def make_vol(self, volume):
        return self._call(self.inner.make_vol, volume)

    def make_vol_bulk(self, *volumes):
        return self._call(self.inner.make_vol_bulk, *volumes)

    def list_vols(self):
        return self._call(self.inner.list_vols)

    def stat_vol(self, volume):
        return self._call(self.inner.stat_vol, volume)

    def delete_vol(self, volume, force=False):
        return self._call(self.inner.delete_vol, volume, force)

    def write_metadata(self, volume, path, fi):
        return self._call(self.inner.write_metadata, volume, path, fi)

    def read_version(self, volume, path, version_id=""):
        return self._call(self.inner.read_version, volume, path,
                          version_id)

    def read_versions(self, volume, path):
        return self._call(self.inner.read_versions, volume, path)

    def delete_version(self, volume, path, fi):
        return self._call(self.inner.delete_version, volume, path, fi)

    def delete_versions(self, volume, versions):
        return self._call(self.inner.delete_versions, volume, versions)

    def rename_data(self, src_volume, src_path, data_dir, dst_volume,
                    dst_path, version_id=""):
        return self._call(self.inner.rename_data, src_volume, src_path,
                          data_dir, dst_volume, dst_path, version_id)

    def list_dir(self, volume, dir_path, count=-1):
        return self._call(self.inner.list_dir, volume, dir_path, count)

    def read_file(self, volume, path, offset, length, verifier=None):
        return self._call(self.inner.read_file, volume, path, offset,
                          length, verifier)

    def append_file(self, volume, path, buf):
        return self._call(self.inner.append_file, volume, path, buf)

    def open_appender(self, volume, path):
        # identity-guarded like every other write verb: the shard-write
        # hot path must not stream frames onto a swapped drive (callers
        # probe has_appender() first, delegated via __getattr__)
        return self._call(self.inner.open_appender, volume, path)

    def create_file(self, volume, path, size, reader):
        return self._call(self.inner.create_file, volume, path, size,
                          reader)

    def read_file_stream(self, volume, path, offset, length):
        return self._call(self.inner.read_file_stream, volume, path,
                          offset, length)

    def rename_file(self, src_volume, src_path, dst_volume, dst_path):
        return self._call(self.inner.rename_file, src_volume, src_path,
                          dst_volume, dst_path)

    def check_parts(self, volume, path, fi):
        return self._call(self.inner.check_parts, volume, path, fi)

    def check_file(self, volume, path):
        return self._call(self.inner.check_file, volume, path)

    def delete_file(self, volume, path, recursive=False):
        return self._call(self.inner.delete_file, volume, path,
                          recursive=recursive)

    def verify_file(self, volume, path, fi):
        return self._call(self.inner.verify_file, volume, path, fi)

    def write_all(self, volume, path, data):
        return self._call(self.inner.write_all, volume, path, data)

    def read_all(self, volume, path):
        return self._call(self.inner.read_all, volume, path)

    def walk(self, volume, dir_path="", marker="", recursive=True):
        self._verify()
        return self.inner.walk(volume, dir_path, marker, recursive)
