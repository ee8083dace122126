"""ObjectLayer-level errors (the reference's typed object-API errors,
cmd/object-api-errors.go), produced by quorum reduction over per-drive
StorageErrors (to_object_err == the reference's toObjectErr)."""

from __future__ import annotations

from ..storage import errors as storage_errors


class ObjectApiError(Exception):
    pass


class BucketNotFound(ObjectApiError):
    def __init__(self, bucket: str = ""):
        super().__init__(f"bucket not found: {bucket}")
        self.bucket = bucket


class BucketExists(ObjectApiError):
    def __init__(self, bucket: str = ""):
        super().__init__(f"bucket exists: {bucket}")
        self.bucket = bucket


class BucketNameInvalid(ObjectApiError):
    def __init__(self, bucket: str = ""):
        super().__init__(f"invalid bucket name: {bucket}")
        self.bucket = bucket


class ObjectNotFound(ObjectApiError):
    def __init__(self, bucket: str = "", object: str = ""):
        super().__init__(f"object not found: {bucket}/{object}")
        self.bucket, self.object = bucket, object


class VersionNotFound(ObjectApiError):
    def __init__(self, bucket: str = "", object: str = "",
                 version_id: str = ""):
        super().__init__(
            f"version not found: {bucket}/{object} ({version_id})")
        self.bucket, self.object, self.version_id = bucket, object, version_id


class ObjectNameInvalid(ObjectApiError):
    def __init__(self, bucket: str = "", object: str = ""):
        super().__init__(f"invalid object name: {bucket}/{object}")
        self.bucket, self.object = bucket, object


class InsufficientReadQuorum(ObjectApiError):
    """Not enough live drives to read (errErasureReadQuorum)."""


class InsufficientWriteQuorum(ObjectApiError):
    """Not enough live drives to write (errErasureWriteQuorum)."""


class HealFailed(ObjectApiError):
    """A heal attempt made no progress (target drives offline or every
    repair write failed) — the object is still degraded; retry later
    (the MRF queue's backoff). An ObjectApiError so per-object heal
    sweeps skip it instead of aborting."""


class InvalidRange(ObjectApiError):
    def __init__(self, start: int = 0, length: int = 0, size: int = 0):
        super().__init__(f"invalid range {start}+{length} of {size}")
        self.start, self.length, self.size = start, length, size


class IncompleteBody(ObjectApiError):
    pass


class InvalidETag(ObjectApiError):
    pass


class MethodNotAllowed(ObjectApiError):
    """e.g. GET on a delete marker."""


class SignatureDoesNotMatch(ObjectApiError):
    pass


class BucketNotEmpty(ObjectApiError):
    def __init__(self, bucket: str = ""):
        super().__init__(f"bucket not empty: {bucket}")
        self.bucket = bucket


class InvalidUploadID(ObjectApiError):
    def __init__(self, upload_id: str = ""):
        super().__init__(f"invalid upload id: {upload_id}")
        self.upload_id = upload_id


class InvalidPart(ObjectApiError):
    def __init__(self, part_number: int = 0, exp: str = "", got: str = ""):
        super().__init__(
            f"invalid part {part_number}: expected etag {exp}, got {got}")
        self.part_number = part_number


class PartTooSmall(ObjectApiError):
    def __init__(self, part_number: int = 0, part_size: int = 0):
        super().__init__(f"part {part_number} too small: {part_size}")
        self.part_number, self.part_size = part_number, part_size


class PreConditionFailed(ObjectApiError):
    pass


class InvalidObjectState(ObjectApiError):
    """GET of a transitioned (tiered) version with no restored local
    copy: the client must POST ?restore first (S3 InvalidObjectState)."""


class TierNotFound(ObjectApiError):
    """A lifecycle rule or restore named a tier that is not in the tier
    registry."""


def to_object_err(err: Exception, bucket: str = "",
                  object: str = "") -> Exception:
    """Map a per-drive/quorum StorageError to the object-level error the
    API returns (reference toObjectErr, cmd/object-api-errors.go:34-112)."""
    if isinstance(err, ObjectApiError):
        return err
    if isinstance(err, storage_errors.VolumeNotEmpty):
        return BucketNotEmpty(bucket)
    if isinstance(err, storage_errors.VolumeNotFound):
        return BucketNotFound(bucket)
    if isinstance(err, storage_errors.VolumeExists):
        return BucketExists(bucket)
    if isinstance(err, storage_errors.FileVersionNotFound):
        return VersionNotFound(bucket, object)
    if isinstance(err, (storage_errors.FileNotFound,
                        storage_errors.PathNotFound)):
        return ObjectNotFound(bucket, object)
    if isinstance(err, storage_errors.FileNameTooLong):
        return ObjectNameInvalid(bucket, object)
    if isinstance(err, storage_errors.DiskFull):
        return InsufficientWriteQuorum()
    return err
