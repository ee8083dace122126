"""BucketMetadataSys — one durable metadata blob per bucket.

The reference persists a single msgpack blob per bucket at
`.minio.sys/buckets/<bucket>/.metadata.bin` holding policy, lifecycle,
SSE config, tagging, quota, versioning, object-lock, notification and
replication configs, with an in-memory cluster-wide cache
(cmd/bucket-metadata.go, cmd/bucket-metadata-sys.go). Here the blob is
JSON, stored erasure-coded through the object layer itself so it gets
quorum + healing for free. A distributed node wires ``on_change`` to the
peers' ``reload-bucket-metadata`` verb, whose handler calls ``reload``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ..storage.xl_storage import MINIO_META_BUCKET
from . import api_errors

BUCKET_METADATA_FILE = ".metadata.bin"
BUCKET_METADATA_FORMAT = 1


class BucketMetadata:
    """All per-bucket configuration (reference BucketMetadata struct)."""

    FIELDS = ("policy_json", "versioning", "tagging", "quota",
              "lifecycle_xml", "sse_config_xml", "object_lock_xml",
              "notification_xml", "replication_xml",
              "replication_targets")

    def __init__(self, name: str):
        self.name = name
        self.created = time.time()
        self.policy_json: str = ""           # bucket policy (JSON doc)
        self.versioning: str = ""            # "" | "Enabled" | "Suspended"
        self.tagging: dict[str, str] = {}
        self.quota: dict = {}                # {"quota": bytes, "type": ...}
        self.lifecycle_xml: str = ""
        self.sse_config_xml: str = ""
        self.object_lock_xml: str = ""
        self.notification_xml: str = ""
        self.replication_xml: str = ""
        # remote-target registry (cmd/bucket-targets.go): [{arn, host,
        # port, bucket, access_key, secret_key, region, secure}]
        self.replication_targets: list[dict] = []

    def versioning_enabled(self) -> bool:
        return self.versioning == "Enabled"

    def versioning_suspended(self) -> bool:
        return self.versioning == "Suspended"

    def to_bytes(self) -> bytes:
        d = {"format": BUCKET_METADATA_FORMAT, "name": self.name,
             "created": self.created}
        for f in self.FIELDS:
            d[f] = getattr(self, f)
        return json.dumps(d).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BucketMetadata":
        d = json.loads(raw.decode())
        bm = cls(d.get("name", ""))
        bm.created = d.get("created", 0.0)
        for f in cls.FIELDS:
            if f in d:
                setattr(bm, f, d[f])
        return bm


class BucketMetadataSys:
    """In-memory cache over the persisted per-bucket blobs
    (cmd/bucket-metadata-sys.go)."""

    def __init__(self, object_layer):
        self.obj = object_layer
        self._cache: dict[str, BucketMetadata] = {}
        self._mu = threading.Lock()
        # Cluster hook: called with the bucket name after every persisted
        # change so peers drop their caches (the reference broadcasts
        # LoadBucketMetadata via NotificationSys after each update).
        self.on_change = None

    def _meta_path(self, bucket: str) -> str:
        return f"buckets/{bucket}/{BUCKET_METADATA_FILE}"

    def get(self, bucket: str) -> BucketMetadata:
        with self._mu:
            bm = self._cache.get(bucket)
        if bm is not None:
            return bm
        try:
            _, stream = self.obj.get_object(MINIO_META_BUCKET,
                                            self._meta_path(bucket))
            raw = b"".join(stream)
            bm = BucketMetadata.from_bytes(raw)
        except (api_errors.ObjectNotFound, api_errors.BucketNotFound):
            # never-configured bucket -> defaults; any OTHER failure
            # (quorum loss, IO) must propagate — caching defaults there
            # would silently drop versioning/policy until restart
            bm = BucketMetadata(bucket)
        with self._mu:
            self._cache[bucket] = bm
        return bm

    def set(self, bucket: str, bm: BucketMetadata) -> None:
        self.obj.put_object(MINIO_META_BUCKET, self._meta_path(bucket),
                            bm.to_bytes())
        with self._mu:
            self._cache[bucket] = bm
        self._notify(bucket)

    def _notify(self, bucket: str) -> None:
        if self.on_change is not None:
            try:
                self.on_change(bucket)
            except Exception:  # noqa: BLE001 — peers reload lazily anyway
                pass

    def update(self, bucket: str, **fields) -> BucketMetadata:
        bm = self.get(bucket)
        for k, v in fields.items():
            if k not in BucketMetadata.FIELDS:
                raise ValueError(f"unknown bucket metadata field {k}")
            setattr(bm, k, v)
        self.set(bucket, bm)
        return bm

    def delete(self, bucket: str) -> None:
        try:
            self.obj.delete_object(MINIO_META_BUCKET,
                                   self._meta_path(bucket))
        except api_errors.ObjectApiError:
            pass
        with self._mu:
            self._cache.pop(bucket, None)
        self._notify(bucket)

    def reload(self, bucket: str) -> None:
        """Drop the cache entry (peer-notified metadata change)."""
        with self._mu:
            self._cache.pop(bucket, None)

    # convenience accessors -------------------------------------------------
    def versioning_enabled(self, bucket: str) -> bool:
        return self.get(bucket).versioning_enabled()

    def versioning_suspended(self, bucket: str) -> bool:
        return self.get(bucket).versioning_suspended()

    def get_quota(self, bucket: str) -> Optional[dict]:
        q = self.get(bucket).quota
        return q or None
