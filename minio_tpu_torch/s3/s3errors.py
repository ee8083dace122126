"""S3 API error registry (counterpart of minio_tpu/s3/s3errors.py).

The reference keeps a giant table of APIError structs
(cmd/api-errors.go); here the registry maps code name -> (http status,
default message), S3Error carries one code, and ``api_error_from``
converts the port's object-layer, storage and signature exceptions into
an S3Error for the XML error response writer. The reference's mapping
rows for exceptions the port never raises (object-lock state, tiers,
size limits of the object layer, directory collisions) are left out.
"""

from __future__ import annotations

from ..object import api_errors as oerr
from ..storage import errors as serr
from .signature import SigError

# code -> (http status, message)
ERROR_TABLE: dict[str, tuple[int, str]] = {
    "AccessDenied": (403, "Access Denied."),
    "BadDigest": (400, "The Content-Md5 you specified did not match what "
                       "we received."),
    "EntityTooSmall": (400, "Your proposed upload is smaller than the "
                            "minimum allowed object size."),
    "EntityTooLarge": (400, "Your proposed upload exceeds the maximum "
                            "allowed object size."),
    "IncompleteBody": (400, "You did not provide the number of bytes "
                            "specified by the Content-Length HTTP header."),
    "InternalError": (500, "We encountered an internal error, please try "
                           "again."),
    "InvalidAccessKeyId": (403, "The Access Key Id you provided does not "
                                "exist in our records."),
    "InvalidArgument": (400, "Invalid Argument"),
    "InvalidBucketName": (400, "The specified bucket is not valid."),
    "InvalidDigest": (400, "The Content-Md5 you specified is not valid."),
    "InvalidRange": (416, "The requested range is not satisfiable"),
    "InvalidPart": (400, "One or more of the specified parts could not be "
                         "found."),
    "InvalidPartOrder": (400, "The list of parts was not in ascending "
                              "order."),
    "InvalidObjectState": (403, "The operation is not valid for the "
                                "current state of the object."),
    "MalformedXML": (400, "The XML you provided was not well-formed or "
                          "did not validate against our published schema."),
    "MalformedDate": (400, "Invalid date format header."),
    "MalformedPOSTRequest": (400, "The body of your POST request is not "
                                  "well-formed multipart/form-data."),
    "MissingContentLength": (411, "You must provide the Content-Length "
                                  "HTTP header."),
    "MissingDateHeader": (400, "AWS authentication requires a valid Date "
                               "or x-amz-date header"),
    "NoSuchBucket": (404, "The specified bucket does not exist"),
    "NoSuchBucketPolicy": (404, "The bucket policy does not exist"),
    "NoSuchKey": (404, "The specified key does not exist."),
    "NoSuchUpload": (404, "The specified multipart upload does not exist. "
                          "The upload ID may be invalid, or the upload may "
                          "have been aborted or completed."),
    "NoSuchVersion": (404, "The specified version does not exist."),
    "NotImplemented": (501, "A header you provided implies functionality "
                            "that is not implemented"),
    "PreconditionFailed": (412, "At least one of the pre-conditions you "
                                "specified did not hold"),
    "XAmzContentSHA256Mismatch": (400, "The provided 'x-amz-content-sha256' "
                                       "header does not match what was "
                                       "computed."),
    "RequestTimeTooSkewed": (403, "The difference between the request time "
                                  "and the server's time is too large."),
    "SignatureDoesNotMatch": (403, "The request signature we calculated "
                                   "does not match the signature you "
                                   "provided. Check your key and signing "
                                   "method."),
    "MethodNotAllowed": (405, "The specified method is not allowed against "
                              "this resource."),
    "BucketAlreadyOwnedByYou": (409, "Your previous request to create the "
                                     "named bucket succeeded and you "
                                     "already own it."),
    "BucketAlreadyExists": (409, "The requested bucket name is not "
                                 "available."),
    "BucketNotEmpty": (409, "The bucket you tried to delete is not empty"),
    "AuthorizationHeaderMalformed": (400, "The authorization header is "
                                          "malformed."),
    "SignatureVersionNotSupported": (400, "The requested signature version "
                                          "is not supported."),
    "CredMalformed": (400, "The credential is malformed."),
    "UnsignedHeaders": (400, "There were headers present in the request "
                             "which were not signed"),
    "InvalidQueryParams": (400, "Query-string authentication requires "
                                "X-Amz-Algorithm, X-Amz-Credential, "
                                "X-Amz-Signature, X-Amz-Date, "
                                "X-Amz-SignedHeaders and X-Amz-Expires "
                                "parameters"),
    "MalformedExpires": (400, "Malformed expires value, should be "
                              "non-negative"),
    "NegativeExpires": (400, "X-Amz-Expires must be non-negative"),
    "MaximumExpires": (400, "X-Amz-Expires must be less than a week"),
    "ExpiredPresignRequest": (403, "Request has expired"),
    "RequestNotReadyYet": (403, "Request is not valid yet"),
    "SlowDown": (503, "Resource requested is unreadable, please reduce "
                      "your request rate"),
    "EntityTooSmallPart": (400, "Your proposed upload is smaller than the "
                                "minimum allowed object size."),
    "InvalidRequest": (400, "Invalid Request"),
    "KeyTooLongError": (400, "Your key is too long"),
    "NoSuchLifecycleConfiguration": (404, "The lifecycle configuration "
                                          "does not exist"),
    "RestoreAlreadyInProgress": (409, "Object restore is already in "
                                      "progress"),
    "XMinioAdminTierNotFound": (404, "The remote tier specified does "
                                     "not exist"),
    "XMinioAdminTierAlreadyExists": (409, "The remote tier specified "
                                          "already exists"),
    "XMinioAdminTierBackendInUse": (409, "The remote tier is referenced "
                                         "by a lifecycle rule or "
                                         "transitioned object"),
    "NoSuchTagSet": (404, "The TagSet does not exist"),
    "NoSuchObjectLockConfiguration": (404, "The specified object does not "
                                           "have a ObjectLock "
                                           "configuration"),
    "ObjectLocked": (400, "Object is WORM protected and cannot be "
                          "overwritten"),
    "ReplicationConfigurationNotFoundError": (
        404, "The replication configuration was not found"),
    "ServerSideEncryptionConfigurationNotFoundError": (
        404, "The server side encryption configuration was not found"),
    "InvalidEncryptionAlgorithmError": (
        400, "The Encryption request you specified is not valid. "
             "Supported value: AES256."),
    "NoSuchCORSConfiguration": (404, "The CORS configuration does not "
                                     "exist"),
    "NotificationNotFound": (404, "The notification configuration does "
                                  "not exist"),
    "QuotaExceeded": (409, "Bucket quota exceeded"),
    "AdminInvalidArgument": (400, "Invalid arguments specified"),
    "XMinioInvalidObjectName": (400, "Object name contains unsupported "
                                     "characters."),
    "StorageFull": (507, "Storage backend has reached its minimum free "
                         "disk threshold."),
    "XMinioServerNotInitialized": (503, "Server not initialized, please "
                                        "try again."),
    "InvalidTokenId": (403, "The security token included in the request "
                            "is invalid"),
    "ExpiredToken": (400, "The provided token has expired."),
    "MissingFields": (400, "Missing fields in request."),
    "InvalidTagKey": (400, "The TagKey you have provided is invalid"),
    "InvalidTagValue": (400, "The TagValue you have provided is invalid"),
    "OperationTimedOut": (503, "A timeout occurred while trying to lock a "
                               "resource, please reduce your request rate"),
    "InvalidRegion": (400, "Region does not match."),
    "MalformedPolicy": (400, "Policy has invalid resource."),
    "InvalidPolicyDocument": (400, "The content of the form does not meet "
                                   "the conditions specified in the policy "
                                   "document."),
}


class S3Error(Exception):
    """An error carrying an explicit S3 error code (raised in handlers)."""

    def __init__(self, code: str, message: str = ""):
        status, default_msg = ERROR_TABLE.get(code, (500, code))
        super().__init__(message or default_msg)
        self.code = code
        self.status = status
        self.message = message or default_msg


def api_error_from(exc: Exception) -> S3Error:
    """Map any exception from the stack below into an S3Error
    (reference toAPIErrorCode, cmd/api-errors.go:1721-)."""
    if isinstance(exc, S3Error):
        return exc
    if isinstance(exc, SigError):
        return S3Error(exc.code if exc.code in ERROR_TABLE
                       else "AccessDenied", str(exc))
    mapping = [
        (oerr.BucketNotFound, "NoSuchBucket"),
        (oerr.BucketNotEmpty, "BucketNotEmpty"),
        (oerr.BucketExists, "BucketAlreadyOwnedByYou"),
        (oerr.BucketNameInvalid, "InvalidBucketName"),
        (oerr.VersionNotFound, "NoSuchVersion"),
        (oerr.ObjectNotFound, "NoSuchKey"),
        (oerr.ObjectNameInvalid, "XMinioInvalidObjectName"),
        (oerr.InvalidUploadID, "NoSuchUpload"),
        (oerr.InvalidPart, "InvalidPart"),
        (oerr.PartTooSmall, "EntityTooSmallPart"),
        (oerr.InsufficientReadQuorum, "SlowDown"),
        (oerr.InsufficientWriteQuorum, "SlowDown"),
        (oerr.InvalidRange, "InvalidRange"),
        (oerr.IncompleteBody, "IncompleteBody"),
        (oerr.PreConditionFailed, "PreconditionFailed"),
        (oerr.InvalidObjectState, "InvalidObjectState"),
        (oerr.TierNotFound, "XMinioAdminTierNotFound"),
        (oerr.InvalidETag, "InvalidDigest"),
        (oerr.MethodNotAllowed, "MethodNotAllowed"),
        (oerr.SignatureDoesNotMatch, "SignatureDoesNotMatch"),
        (serr.VolumeNotFound, "NoSuchBucket"),
        (serr.FileNotFound, "NoSuchKey"),
        (serr.DiskFull, "StorageFull"),
    ]
    for etype, code in mapping:
        if isinstance(exc, etype):
            return S3Error(code)
    return S3Error("InternalError", str(exc))
