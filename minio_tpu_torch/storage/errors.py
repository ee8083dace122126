"""Storage-layer error taxonomy.

Mirrors the reference's typed storage errors (cmd/storage-errors.go) so the
object layer's quorum reduction can count and classify per-drive failures
the same way (reduceReadQuorumErrs / reduceWriteQuorumErrs semantics,
cmd/erasure-metadata-utils.go:72-98).
"""

from __future__ import annotations


class StorageError(Exception):
    """Base class of every per-drive error."""


class DiskNotFound(StorageError):
    """Drive is offline / unreachable (errDiskNotFound)."""


class NetworkStorageError(DiskNotFound):
    """Transport-level failure talking to a REMOTE drive (connection
    refused/reset, timeout, mid-stream disconnect) — distinct from the
    remote reporting a storage error. Subclasses DiskNotFound so quorum
    logic tolerates it like any gone drive, but callers that retry or
    hedge can tell 'the wire broke' from 'the drive said no'."""


class UnformattedDisk(StorageError):
    """Drive has no format.json yet (errUnformattedDisk)."""


class CorruptedFormat(StorageError):
    """format.json unreadable/invalid (errCorruptedFormat)."""


class DiskAccessDenied(StorageError):
    """Drive root not writable (errDiskAccessDenied)."""


class FaultyDisk(StorageError):
    """I/O error talking to the drive (errFaultyDisk)."""


class DiskFull(StorageError):
    """No space left (errDiskFull)."""


class VolumeNotFound(StorageError):
    """Bucket/volume missing on this drive (errVolumeNotFound)."""


class VolumeExists(StorageError):
    """MakeVol on an existing volume (errVolumeExists)."""


class FileNotFound(StorageError):
    """Object/file missing on this drive (errFileNotFound)."""


class FileVersionNotFound(StorageError):
    """Requested versionID not present in xl.meta (errFileVersionNotFound)."""


class FileNameTooLong(StorageError):
    """Path component too long (errFileNameTooLong)."""


class FileAccessDenied(StorageError):
    """Path is a directory where a file is expected, or perms
    (errFileAccessDenied)."""


class FileCorrupt(StorageError):
    """xl.meta / shard data fails to parse or verify (errFileCorrupt)."""


class FileParentIsFile(StorageError):
    """A parent path component is a regular file (errFileParentIsFile)."""


class PathNotFound(StorageError):
    """Generic missing path (errPathNotFound)."""


class BitrotHashMismatch(StorageError):
    """Bitrot verification failed: stored digest != computed
    (hashMismatchError, cmd/storage-errors.go)."""

    def __init__(self, expected: str = "", got: str = ""):
        super().__init__(f"bitrot hash mismatch: expected {expected}, got {got}")
        self.expected = expected
        self.got = got


class UnexpectedError(StorageError):
    """Catch-all (errUnexpected)."""


class StorageStalled(StorageError):
    """Drive op abandoned by the quorum-ack lane: it outlived the
    write-straggler grace after write quorum was already durable. The
    op keeps running on the background lane — this error only records
    that the commit stopped waiting (the caller's quorum reduce counts
    it as a missed write, feeding the MRF degraded-write queue)."""


class VolumeNotEmpty(StorageError):
    """DeleteVol on a non-empty volume (errVolumeNotEmpty)."""


class IsNotRegular(StorageError):
    """Expected a regular file (errIsNotRegular)."""


class LessData(StorageError):
    """Reader gave fewer bytes than promised (errLessData)."""


class MoreData(StorageError):
    """Reader gave more bytes than promised (errMoreData)."""


class DiskStale(StorageError):
    """diskID in request doesn't match the drive (errDiskStale) — the
    analog of xlStorageDiskIDCheck rejections."""


# Errors counted as "object may exist elsewhere, keep looking" by the
# quorum reducer (objectErrs in the reference).
OBJECT_NOT_FOUND_ERRS = (FileNotFound, FileVersionNotFound, VolumeNotFound)
