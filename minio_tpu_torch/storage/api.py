"""StorageAPI — the per-drive verb interface.

The seam between the object engine and a drive, local or remote
(reference: cmd/storage-interface.go:25-82; counterpart of
minio_tpu/storage/api.py): XLStorage (POSIX, xl_storage.py), RemoteStorage
(the storage RPC client, distributed/storage_rpc.py) and the identity
guard (diskid_check.py) speak these verbs, so quorum logic and healing are
implementation-agnostic. Synchronous methods; the object engine fans out
over drives with a thread pool.

Shard frames reach a drive one of two ways (object/bitrot_io.py): a drive
whose ``has_appender()`` says so (a local XLStorage) takes them through
``open_appender``, a persistent append handle; any other (a remote drive)
takes buffered batches through ``append_file``, one call per flush.
"""

from __future__ import annotations

import abc
from typing import BinaryIO, Iterator, Optional

from .datatypes import DiskInfo, FileInfo, VolInfo


class BitrotVerifier:
    """Expected whole-file digest, checked during ReadFile
    (reference BitrotVerifier, cmd/bitrot.go)."""

    def __init__(self, algorithm: str, digest: bytes):
        self.algorithm = algorithm
        self.digest = digest


class StorageAPI(abc.ABC):
    """One drive's verb set."""

    # -- identity / health -------------------------------------------------

    @abc.abstractmethod
    def __str__(self) -> str: ...

    @abc.abstractmethod
    def is_online(self) -> bool: ...

    @abc.abstractmethod
    def is_local(self) -> bool: ...

    def hostname(self) -> str:
        return ""

    @abc.abstractmethod
    def endpoint(self) -> str: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    @abc.abstractmethod
    def get_disk_id(self) -> str: ...

    @abc.abstractmethod
    def set_disk_id(self, disk_id: str) -> None: ...

    def healing(self) -> bool:
        return False

    @abc.abstractmethod
    def disk_info(self) -> DiskInfo: ...

    # -- volumes -----------------------------------------------------------

    @abc.abstractmethod
    def make_vol(self, volume: str) -> None: ...

    def make_vol_bulk(self, *volumes: str) -> None:
        for v in volumes:
            try:
                self.make_vol(v)
            except Exception:
                pass

    @abc.abstractmethod
    def list_vols(self) -> list[VolInfo]: ...

    @abc.abstractmethod
    def stat_vol(self, volume: str) -> VolInfo: ...

    @abc.abstractmethod
    def delete_vol(self, volume: str, force: bool = False) -> None: ...

    # -- metadata ----------------------------------------------------------

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo: ...

    @abc.abstractmethod
    def read_versions(self, volume: str, path: str) -> list[FileInfo]: ...

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None: ...

    def delete_versions(self, volume: str,
                        versions: list[FileInfo]
                        ) -> list[Optional[Exception]]:
        """Bulk version delete: ONE call per drive for N objects
        (reference DeleteVersions, cmd/storage-rest-common.go). The
        default loops locally; the storage-RPC client overrides it with
        a single wire round-trip."""
        out: list[Optional[Exception]] = []
        for fi in versions:
            try:
                self.delete_version(volume, fi.name, fi)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — per-item result
                out.append(e)
        return out

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, data_dir: str,
                    dst_volume: str, dst_path: str,
                    version_id: str = "") -> None:
        """Commit a staged write. `version_id` names the version being
        committed (empty = legacy latest-pick) — version-faithful
        replays stage versions whose mod time sorts behind the
        session placeholder, so "latest" is not "the one"."""
        ...

    # -- files -------------------------------------------------------------

    @abc.abstractmethod
    def list_dir(self, volume: str, dir_path: str,
                 count: int = -1) -> list[str]: ...

    @abc.abstractmethod
    def read_file(self, volume: str, path: str, offset: int, length: int,
                  verifier: Optional[BitrotVerifier] = None) -> bytes: ...

    @abc.abstractmethod
    def append_file(self, volume: str, path: str, buf: bytes) -> None: ...

    def open_appender(self, volume: str, path: str):
        """Persistent append handle (write, close) for shard frames; only
        drives whose ``has_appender()`` is true have one."""
        raise NotImplementedError

    @abc.abstractmethod
    def create_file(self, volume: str, path: str, size: int,
                    reader: BinaryIO) -> None: ...

    @abc.abstractmethod
    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int) -> BinaryIO: ...

    @abc.abstractmethod
    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None: ...

    @abc.abstractmethod
    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def check_file(self, volume: str, path: str) -> None: ...

    @abc.abstractmethod
    def delete_file(self, volume: str, path: str,
                    recursive: bool = False) -> None: ...

    @abc.abstractmethod
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def write_all(self, volume: str, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def read_all(self, volume: str, path: str) -> bytes: ...

    # -- listing / crawling ------------------------------------------------

    @abc.abstractmethod
    def walk(self, volume: str, dir_path: str = "", marker: str = "",
             recursive: bool = True) -> Iterator[FileInfo]: ...

    def walk_versions(self, volume: str, dir_path: str = "",
                      marker: str = "", recursive: bool = True
                      ) -> Iterator[list[FileInfo]]:
        raise NotImplementedError

