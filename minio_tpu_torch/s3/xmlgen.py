"""S3 XML response marshaling (reference cmd/api-response.go).

Hand-rolled writer (like the reference's encoding/xml structs) producing
the exact S3 dialect: ListAllMyBucketsResult, ListBucketResult (V1/V2),
ListVersionsResult, multipart responses, DeleteResult, CopyObjectResult,
Error.
"""

from __future__ import annotations

import datetime
import urllib.parse
from typing import Iterable, Optional
from xml.sax.saxutils import escape

from ..storage.datatypes import ObjectInfo

S3_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


def _ts(t: float) -> str:
    """RFC3339 with millis, UTC (the reference's amazon time format)."""
    dt = datetime.datetime.fromtimestamp(t or 0, datetime.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


class X:
    """Tiny XML builder."""

    def __init__(self):
        self.parts: list[str] = ['<?xml version="1.0" encoding="UTF-8"?>']

    def open(self, tag: str, **attrs) -> "X":
        a = "".join(f' {k}="{escape(v)}"' for k, v in attrs.items())
        self.parts.append(f"<{tag}{a}>")
        return self

    def close(self, tag: str) -> "X":
        self.parts.append(f"</{tag}>")
        return self

    def elem(self, tag: str, value) -> "X":
        self.parts.append(f"<{tag}>{escape(str(value))}</{tag}>")
        return self

    def empty(self, tag: str) -> "X":
        self.parts.append(f"<{tag}/>")
        return self

    def bytes(self) -> bytes:
        return "".join(self.parts).encode()


def _maybe_encode(s: str, encoding_type: str) -> str:
    if encoding_type == "url":
        return urllib.parse.quote(s, safe="/")
    return s


def error_response(code: str, message: str, resource: str,
                   request_id: str, host_id: str = "") -> bytes:
    x = X()
    x.open("Error")
    x.elem("Code", code).elem("Message", message)
    x.elem("Resource", resource).elem("RequestId", request_id)
    x.elem("HostId", host_id)
    x.close("Error")
    return x.bytes()


def list_buckets_response(owner_id: str, buckets) -> bytes:
    x = X()
    x.open("ListAllMyBucketsResult", xmlns=S3_XMLNS)
    x.open("Owner").elem("ID", owner_id).elem("DisplayName", owner_id)
    x.close("Owner")
    x.open("Buckets")
    for b in buckets:
        x.open("Bucket").elem("Name", b.name)
        x.elem("CreationDate", _ts(b.created)).close("Bucket")
    x.close("Buckets").close("ListAllMyBucketsResult")
    return x.bytes()


def _write_object_entry(x: X, o: ObjectInfo, encoding_type: str,
                        fetch_owner: bool = True,
                        owner_id: str = "minio") -> None:
    x.open("Contents")
    x.elem("Key", _maybe_encode(o.name, encoding_type))
    x.elem("LastModified", _ts(o.mod_time))
    x.elem("ETag", f'"{o.etag}"' if o.etag else "")
    x.elem("Size", o.size)
    x.elem("StorageClass", o.storage_class or "STANDARD")
    if fetch_owner:
        x.open("Owner").elem("ID", owner_id)
        x.elem("DisplayName", owner_id).close("Owner")
    x.close("Contents")


def _write_prefixes(x: X, prefixes: Iterable[str],
                    encoding_type: str) -> None:
    for p in prefixes:
        x.open("CommonPrefixes")
        x.elem("Prefix", _maybe_encode(p, encoding_type))
        x.close("CommonPrefixes")


def list_objects_v1_response(bucket: str, prefix: str, marker: str,
                             delimiter: str, max_keys: int,
                             encoding_type: str, objects: list[ObjectInfo],
                             prefixes: list[str], is_truncated: bool,
                             next_marker: str = "") -> bytes:
    x = X()
    x.open("ListBucketResult", xmlns=S3_XMLNS)
    x.elem("Name", bucket)
    x.elem("Prefix", _maybe_encode(prefix, encoding_type))
    x.elem("Marker", _maybe_encode(marker, encoding_type))
    x.elem("MaxKeys", max_keys)
    if delimiter:
        x.elem("Delimiter", _maybe_encode(delimiter, encoding_type))
    if encoding_type:
        x.elem("EncodingType", encoding_type)
    x.elem("IsTruncated", "true" if is_truncated else "false")
    if is_truncated and next_marker:
        x.elem("NextMarker", _maybe_encode(next_marker, encoding_type))
    for o in objects:
        _write_object_entry(x, o, encoding_type)
    _write_prefixes(x, prefixes, encoding_type)
    x.close("ListBucketResult")
    return x.bytes()


def list_objects_v2_response(bucket: str, prefix: str, delimiter: str,
                             max_keys: int, encoding_type: str,
                             start_after: str, token: str,
                             next_token: str, objects: list[ObjectInfo],
                             prefixes: list[str], is_truncated: bool,
                             fetch_owner: bool) -> bytes:
    x = X()
    x.open("ListBucketResult", xmlns=S3_XMLNS)
    x.elem("Name", bucket)
    x.elem("Prefix", _maybe_encode(prefix, encoding_type))
    if start_after:
        x.elem("StartAfter", _maybe_encode(start_after, encoding_type))
    if token:
        x.elem("ContinuationToken", token)
    if next_token:
        x.elem("NextContinuationToken", next_token)
    x.elem("KeyCount", len(objects) + len(prefixes))
    x.elem("MaxKeys", max_keys)
    if delimiter:
        x.elem("Delimiter", _maybe_encode(delimiter, encoding_type))
    if encoding_type:
        x.elem("EncodingType", encoding_type)
    x.elem("IsTruncated", "true" if is_truncated else "false")
    for o in objects:
        _write_object_entry(x, o, encoding_type, fetch_owner)
    _write_prefixes(x, prefixes, encoding_type)
    x.close("ListBucketResult")
    return x.bytes()


def list_versions_response(bucket: str, prefix: str, key_marker: str,
                           version_marker: str, delimiter: str,
                           max_keys: int, encoding_type: str,
                           versions: list[ObjectInfo],
                           prefixes: list[str],
                           is_truncated: bool,
                           next_key_marker: str = "",
                           next_version_marker: str = "") -> bytes:
    x = X()
    x.open("ListVersionsResult", xmlns=S3_XMLNS)
    x.elem("Name", bucket)
    x.elem("Prefix", _maybe_encode(prefix, encoding_type))
    x.elem("KeyMarker", key_marker)
    x.elem("VersionIdMarker", version_marker)
    x.elem("MaxKeys", max_keys)
    if delimiter:
        x.elem("Delimiter", _maybe_encode(delimiter, encoding_type))
    x.elem("IsTruncated", "true" if is_truncated else "false")
    if is_truncated and next_key_marker:
        x.elem("NextKeyMarker",
               _maybe_encode(next_key_marker, encoding_type))
        x.elem("NextVersionIdMarker", next_version_marker or "null")
    for o in versions:
        tag = "DeleteMarker" if o.delete_marker else "Version"
        x.open(tag)
        x.elem("Key", _maybe_encode(o.name, encoding_type))
        x.elem("VersionId", o.version_id or "null")
        x.elem("IsLatest", "true" if o.is_latest else "false")
        x.elem("LastModified", _ts(o.mod_time))
        if not o.delete_marker:
            x.elem("ETag", f'"{o.etag}"')
            x.elem("Size", o.size)
            x.elem("StorageClass", o.storage_class or "STANDARD")
        x.open("Owner").elem("ID", "minio")
        x.elem("DisplayName", "minio").close("Owner")
        x.close(tag)
    _write_prefixes(x, prefixes, encoding_type)
    x.close("ListVersionsResult")
    return x.bytes()


def location_response(region: str) -> bytes:
    x = X()
    if region:
        x.open("LocationConstraint", xmlns=S3_XMLNS)
        x.parts.append(escape(region))
        x.close("LocationConstraint")
    else:
        x.parts.append(f'<LocationConstraint xmlns="{S3_XMLNS}"/>')
    return x.bytes()


def initiate_multipart_response(bucket: str, key: str,
                                upload_id: str) -> bytes:
    x = X()
    x.open("InitiateMultipartUploadResult", xmlns=S3_XMLNS)
    x.elem("Bucket", bucket).elem("Key", key).elem("UploadId", upload_id)
    x.close("InitiateMultipartUploadResult")
    return x.bytes()


def complete_multipart_response(location: str, bucket: str, key: str,
                                etag: str) -> bytes:
    x = X()
    x.open("CompleteMultipartUploadResult", xmlns=S3_XMLNS)
    x.elem("Location", location).elem("Bucket", bucket)
    x.elem("Key", key).elem("ETag", f'"{etag}"')
    x.close("CompleteMultipartUploadResult")
    return x.bytes()


def list_parts_response(bucket: str, key: str, upload_id: str,
                        part_marker: int, next_marker: int, max_parts: int,
                        is_truncated: bool, parts) -> bytes:
    x = X()
    x.open("ListPartsResult", xmlns=S3_XMLNS)
    x.elem("Bucket", bucket).elem("Key", key).elem("UploadId", upload_id)
    x.open("Initiator").elem("ID", "minio")
    x.elem("DisplayName", "minio").close("Initiator")
    x.open("Owner").elem("ID", "minio")
    x.elem("DisplayName", "minio").close("Owner")
    x.elem("StorageClass", "STANDARD")
    x.elem("PartNumberMarker", part_marker)
    x.elem("NextPartNumberMarker", next_marker)
    x.elem("MaxParts", max_parts)
    x.elem("IsTruncated", "true" if is_truncated else "false")
    for p in parts:
        x.open("Part")
        x.elem("PartNumber", p.part_number)
        x.elem("LastModified", _ts(getattr(p, "mod_time", 0.0)))
        x.elem("ETag", f'"{p.etag}"')
        x.elem("Size", p.size)
        x.close("Part")
    x.close("ListPartsResult")
    return x.bytes()


def list_multipart_uploads_response(bucket: str, key_marker: str,
                                    upload_id_marker: str, prefix: str,
                                    delimiter: str, max_uploads: int,
                                    is_truncated: bool, uploads,
                                    next_key_marker: str = "",
                                    next_upload_id_marker: str = ""
                                    ) -> bytes:
    x = X()
    x.open("ListMultipartUploadsResult", xmlns=S3_XMLNS)
    x.elem("Bucket", bucket)
    x.elem("KeyMarker", key_marker)
    x.elem("UploadIdMarker", upload_id_marker)
    if is_truncated and next_key_marker:
        x.elem("NextKeyMarker", next_key_marker)
        x.elem("NextUploadIdMarker", next_upload_id_marker)
    x.elem("Prefix", prefix)
    if delimiter:
        x.elem("Delimiter", delimiter)
    x.elem("MaxUploads", max_uploads)
    x.elem("IsTruncated", "true" if is_truncated else "false")
    for u in uploads:
        x.open("Upload")
        x.elem("Key", u["object"])
        x.elem("UploadId", u["upload_id"])
        x.open("Initiator").elem("ID", "minio")
        x.elem("DisplayName", "minio").close("Initiator")
        x.open("Owner").elem("ID", "minio")
        x.elem("DisplayName", "minio").close("Owner")
        x.elem("StorageClass", "STANDARD")
        x.elem("Initiated", _ts(u.get("initiated", 0.0)))
        x.close("Upload")
    x.close("ListMultipartUploadsResult")
    return x.bytes()


def delete_objects_response(deleted: list[dict],
                            errors: list[dict]) -> bytes:
    x = X()
    x.open("DeleteResult", xmlns=S3_XMLNS)
    for d in deleted:
        x.open("Deleted").elem("Key", d["key"])
        if d.get("version_id"):
            x.elem("VersionId", d["version_id"])
        if d.get("delete_marker"):
            x.elem("DeleteMarker", "true")
            x.elem("DeleteMarkerVersionId", d.get("delete_marker_version",
                                                  ""))
        x.close("Deleted")
    for e in errors:
        x.open("Error").elem("Key", e["key"])
        x.elem("Code", e["code"]).elem("Message", e["message"])
        x.close("Error")
    x.close("DeleteResult")
    return x.bytes()


def copy_object_response(etag: str, mod_time: float) -> bytes:
    x = X()
    x.open("CopyObjectResult", xmlns=S3_XMLNS)
    x.elem("LastModified", _ts(mod_time))
    x.elem("ETag", f'"{etag}"')
    x.close("CopyObjectResult")
    return x.bytes()


def versioning_response(status: str) -> bytes:
    x = X()
    x.open("VersioningConfiguration", xmlns=S3_XMLNS)
    if status:
        x.elem("Status", status)
    x.close("VersioningConfiguration")
    return x.bytes()


def tagging_response(tags: dict[str, str]) -> bytes:
    x = X()
    x.open("Tagging", xmlns=S3_XMLNS).open("TagSet")
    for k, v in tags.items():
        x.open("Tag").elem("Key", k).elem("Value", v).close("Tag")
    x.close("TagSet").close("Tagging")
    return x.bytes()
