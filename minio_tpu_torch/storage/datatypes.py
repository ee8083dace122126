"""Core storage datatypes: FileInfo / ErasureInfo / checksums / volumes.

The shapes mirror the reference's wire/metadata structs
(cmd/storage-datatypes.go:61-116, cmd/xl-storage-format-v1.go:86-137) so
that xl.meta serialization (xl_meta.py) emits the same field names as the
reference and as minio_tpu, whose drives this package reads and writes.
"""

from __future__ import annotations

import dataclasses
import time as _time
import zlib
from typing import Optional

ERASURE_ALGORITHM = "rs-vandermonde"  # cmd/erasure-metadata.go:34
BLOCK_SIZE_V1 = 1 << 22               # 4 MiB, cmd/object-api-common.go:31
NULL_VERSION_ID = "null"


# tier-transition / restore metadata keys (reference
# minio_tpu/storage/datatypes.py:24-33; set by tier/transition.py)
TRANSITION_STATUS_KEY = "X-Minio-Internal-transition-status"
TRANSITION_TIER_KEY = "X-Minio-Internal-transition-tier"
TRANSITIONED_OBJECT_KEY = "X-Minio-Internal-transitioned-object"
TRANSITIONED_VERSION_KEY = "X-Minio-Internal-transitioned-versionID"
TRANSITION_COMPLETE = "complete"
# RestoreObject state: the S3 header value, and the absolute unix expiry
# of the restored copy that the reclaim sweep reads
RESTORE_KEY = "x-amz-restore"
RESTORE_EXPIRY_KEY = "X-Minio-Internal-restore-expiry"
RESTORE_ONGOING = 'ongoing-request="true"'


def is_transitioned(metadata: dict) -> bool:
    """True when this version's data lives in a remote tier."""
    return metadata.get(TRANSITION_STATUS_KEY) == TRANSITION_COMPLETE


def is_restored(metadata: dict) -> bool:
    """True when a transitioned version currently has a live local
    restored copy (restore finished, not yet reclaimed)."""
    v = metadata.get(RESTORE_KEY, "")
    return bool(v) and RESTORE_ONGOING not in v


@dataclasses.dataclass
class ChecksumInfo:
    """Bitrot checksum of one part on one drive
    (cmd/xl-storage-format-v1.go:132)."""
    part_number: int
    algorithm: str          # bitrot algorithm string name
    hash: bytes             # empty for streaming algorithms


@dataclasses.dataclass
class ObjectPartInfo:
    """One completed part (cmd/xl-storage-format-v1.go:124)."""
    number: int
    size: int
    actual_size: int = -1   # pre-compression size; -1 = same as size
    etag: str = ""


@dataclasses.dataclass
class ErasureInfo:
    """Erasure geometry + placement for one object version
    (cmd/xl-storage-format-v1.go:86)."""
    algorithm: str = ERASURE_ALGORITHM
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = BLOCK_SIZE_V1
    index: int = 0                      # 1-based index of this drive
    distribution: list[int] = dataclasses.field(default_factory=list)
    checksums: list[ChecksumInfo] = dataclasses.field(default_factory=list)

    def shard_size(self) -> int:
        """Bytes of one shard of one full block (ceil split)."""
        return -(-self.block_size // self.data_blocks)

    def shard_file_size(self, total_length: int) -> int:
        """Final erasure-shard size for an object of total_length bytes
        (cmd/erasure-coding.go:120-131)."""
        if total_length == 0:
            return 0
        if total_length < 0:
            return -1
        full = total_length // self.block_size
        last = total_length % self.block_size
        last_shard = -(-last // self.data_blocks)
        return full * self.shard_size() + last_shard

    def shard_file_offset(self, start: int, length: int, total: int) -> int:
        """Read-until offset in the shard file for a ranged read
        (cmd/erasure-coding.go:134-143)."""
        shard_size = self.shard_size()
        sfs = self.shard_file_size(total)
        end = ((start + length) // self.block_size) * shard_size + shard_size
        return min(end, sfs)

    def get_checksum_info(self, part_number: int) -> Optional[ChecksumInfo]:
        for c in self.checksums:
            if c.part_number == part_number:
                return c
        return None


@dataclasses.dataclass
class FileInfo:
    """Stat + metadata of one object version on one drive
    (cmd/storage-datatypes.go:61-116)."""
    volume: str = ""
    name: str = ""
    version_id: str = ""
    is_latest: bool = True
    deleted: bool = False               # delete marker
    data_dir: str = ""
    mod_time: float = 0.0               # unix seconds (float, ns precision)
    size: int = 0
    metadata: dict[str, str] = dataclasses.field(default_factory=dict)
    parts: list[ObjectPartInfo] = dataclasses.field(default_factory=list)
    erasure: ErasureInfo = dataclasses.field(default_factory=ErasureInfo)

    def add_object_part(self, number: int, etag: str, size: int,
                        actual_size: int) -> None:
        """Insert/replace a part, keeping parts sorted by number
        (cmd/erasure-metadata.go AddObjectPart semantics)."""
        new = ObjectPartInfo(number=number, etag=etag, size=size,
                             actual_size=actual_size)
        for i, p in enumerate(self.parts):
            if p.number == number:
                self.parts[i] = new
                return
        self.parts.append(new)
        self.parts.sort(key=lambda p: p.number)

    def object_to_part_offset(self, offset: int) -> tuple[int, int]:
        """(part index, offset inside part) for a global object offset
        (cmd/erasure-metadata.go ObjectToPartOffset)."""
        if offset == 0:
            return 0, 0
        remaining = offset
        for i, part in enumerate(self.parts):
            if remaining < part.size:
                return i, remaining
            remaining -= part.size
        raise ValueError(f"offset {offset} beyond object size")

    def light_copy(self) -> "FileInfo":
        """Per-drive copy for writeUniqueFileInfo: drives differ only in
        erasure.index and (whole-file bitrot) per-drive checksum hashes,
        so share the payload (metadata dict, parts list) and copy just
        the erasure branch — a full deepcopy per drive was the PUT
        commit path's largest host cost."""
        e = self.erasure
        new_e = dataclasses.replace(
            e, distribution=list(e.distribution),
            checksums=[dataclasses.replace(c) for c in e.checksums])
        return dataclasses.replace(self, erasure=new_e)

    def to_object_info(self, bucket: str, object_name: str) -> "ObjectInfo":
        actual = int(self.metadata.get("X-Minio-Internal-actual-size",
                                       self.size))
        return ObjectInfo(
            bucket=bucket, name=object_name, mod_time=self.mod_time,
            size=self.size, actual_size=actual,
            etag=self.metadata.get("etag", ""),
            version_id=self.version_id or "",
            is_latest=self.is_latest, delete_marker=self.deleted,
            content_type=self.metadata.get("content-type", ""),
            content_encoding=self.metadata.get("content-encoding", ""),
            user_defined={k: v for k, v in self.metadata.items()
                          if k not in ("etag", "content-type",
                                       "content-encoding")},
            parts=list(self.parts),
            data_blocks=self.erasure.data_blocks,
            parity_blocks=self.erasure.parity_blocks,
        )


@dataclasses.dataclass
class ObjectInfo:
    """API-facing object metadata (the reference's ObjectInfo,
    cmd/object-api-datatypes.go)."""
    bucket: str = ""
    name: str = ""
    mod_time: float = 0.0
    size: int = 0
    actual_size: int = 0
    is_dir: bool = False
    etag: str = ""
    version_id: str = ""
    is_latest: bool = True
    delete_marker: bool = False
    content_type: str = ""
    content_encoding: str = ""
    expires: float = 0.0
    storage_class: str = "STANDARD"
    user_defined: dict[str, str] = dataclasses.field(default_factory=dict)
    parts: list[ObjectPartInfo] = dataclasses.field(default_factory=list)
    data_blocks: int = 0
    parity_blocks: int = 0


@dataclasses.dataclass
class VolInfo:
    name: str
    created: float


def hash_order(key: str, cardinality: int) -> list[int]:
    """Consistent 1-based shard distribution order, identical to the
    reference (crc32-IEEE seeded rotation, cmd/erasure-metadata-utils.go:100).
    Placement compatibility requires bit-identity here."""
    if cardinality <= 0:
        return []
    key_crc = zlib.crc32(key.encode())
    start = key_crc % cardinality
    return [1 + ((start + i) % cardinality) for i in range(1, cardinality + 1)]


def new_file_info(object_name: str, data_blocks: int,
                  parity_blocks: int) -> FileInfo:
    """Fresh FileInfo with erasure geometry + hashOrder distribution
    (cmd/storage-datatypes.go:107)."""
    fi = FileInfo()
    fi.erasure = ErasureInfo(
        algorithm=ERASURE_ALGORITHM,
        data_blocks=data_blocks,
        parity_blocks=parity_blocks,
        block_size=BLOCK_SIZE_V1,
        distribution=hash_order(object_name, data_blocks + parity_blocks),
    )
    return fi


def now() -> float:
    return _time.time()


@dataclasses.dataclass
class DiskInfo:
    """Capacity/health snapshot of one drive (cmd/storage-datatypes.go
    DiskInfo)."""
    total: int = 0
    free: int = 0
    used: int = 0
    fs_type: str = ""
    root_disk: bool = False
    healing: bool = False
    endpoint: str = ""
    mount_path: str = ""
    disk_id: str = ""
    error: str = ""


def last_version_marker(versions, prefixes) -> tuple[str, str]:
    """Resume markers at a versions-page cut — THE single home of the
    rule (engine.paginate_versions, sets.merge_version_listings, and
    single_version_page all derive their markers here): the lexically
    LAST entry emitted (a version or a rolled-up CommonPrefix) is
    where the next page re-enters. A prefix cut carries no version-id
    marker — resume starts at the first key after the prefix (a
    prefix-only page with an empty marker would loop the pager
    forever). A null version id rides as the "null" sentinel: an
    empty marker reads as NO marker on resume and would skip the
    key's remaining versions."""
    last_v = versions[-1].name if versions else ""
    last_p = prefixes[-1] if prefixes else ""
    if last_p > last_v:
        return last_p, ""
    return last_v, versions[-1].version_id or "null"


def single_version_page(objs, truncated, prefixes=None):
    """The list_object_versions 5-tuple for single-version backends
    (FS): one "version" per key, paged on the key marker alone — the
    erasure layer's (versions, CommonPrefixes, NextKeyMarker,
    NextVersionIdMarker, is_truncated) contract; the backend's
    list_objects skips prefixes <= marker on resume."""
    prefixes = prefixes or []
    if truncated and (objs or prefixes):
        nkm, nvm = last_version_marker(objs, prefixes)
        return objs, prefixes, nkm, nvm, True
    return objs, prefixes, "", "", truncated
