"""StorageAPI — the per-drive verb interface.

The seam between the object engine and a drive (reference:
cmd/storage-interface.go:25-82), trimmed to the verbs the erasure-coded
PUT, GET, DELETE and heal paths call. Synchronous methods; the object engine fans
out over drives with a thread pool.
"""

from __future__ import annotations

import abc
from typing import BinaryIO

from .datatypes import FileInfo, VolInfo


class StorageAPI(abc.ABC):
    """One drive's verb set."""

    @abc.abstractmethod
    def __str__(self) -> str: ...

    @abc.abstractmethod
    def get_disk_id(self) -> str: ...

    # -- volumes -----------------------------------------------------------

    @abc.abstractmethod
    def make_vol(self, volume: str) -> None: ...

    @abc.abstractmethod
    def stat_vol(self, volume: str) -> VolInfo: ...

    # -- metadata ----------------------------------------------------------

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo: ...

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, data_dir: str,
                    dst_volume: str, dst_path: str) -> None:
        """Commit a staged write (2-phase commit finish)."""

    @abc.abstractmethod
    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Every part file exists at its full shard-file size."""

    @abc.abstractmethod
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Every bitrot frame of every part verifies."""

    # -- files -------------------------------------------------------------

    @abc.abstractmethod
    def open_appender(self, volume: str, path: str): ...

    @abc.abstractmethod
    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int) -> BinaryIO: ...

    @abc.abstractmethod
    def delete_file(self, volume: str, path: str,
                    recursive: bool = False) -> None: ...

    @abc.abstractmethod
    def write_all(self, volume: str, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def read_all(self, volume: str, path: str) -> bytes: ...
