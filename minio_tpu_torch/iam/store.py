"""IAM persistence (reference cmd/iam-object-store.go).

Counterpart of minio_tpu/iam/store.py: ``ObjectIAMStore`` keeps JSON
blobs under ``.minio.sys/config/iam/`` through the object layer itself,
so every record is a small erasure-coded object whose shards are encoded
and hashed on the card like any other PUT, and survives drive loss. Its
listing of ``.minio.sys`` is the layer's merge-walk: the bucket metacache
indexes user buckets (server_sets.py says why). Left out: the etcd store
(``EtcdIAMStore``), which waits for distributed/etcd.py.

Transient backend trouble raises ``IAMStoreError`` — callers must be
able to distinguish "the record is gone" (None) from "the backend
hiccuped" (exception), or a network blip would read as a user
deletion.
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Optional

IAM_PREFIX = "config/iam"
MINIO_META_BUCKET = ".minio.sys"


class IAMStoreError(Exception):
    """Transient persistence failure (quorum blip, etcd unreachable)."""


def entity_path(prefix: str, name: str) -> str:
    """Relative record path; the entity name is percent-encoded so
    federated subjects like 'oidc:a/b' can never collide with 'oidc:a_b'
    and decode back exactly on load."""
    return (f"{IAM_PREFIX}/{prefix}/"
            f"{urllib.parse.quote(name, safe='')}.json")


class ObjectIAMStore:
    def __init__(self, obj):
        self.obj = obj

    def save(self, path: str, payload: dict) -> None:
        from ..object import api_errors
        try:
            self.obj.put_object(MINIO_META_BUCKET, path,
                                json.dumps(payload).encode())
        except api_errors.ObjectApiError as e:
            raise IAMStoreError(str(e)) from e

    def delete(self, path: str) -> None:
        from ..object import api_errors
        try:
            self.obj.delete_object(MINIO_META_BUCKET, path)
        except api_errors.ObjectNotFound:
            pass
        except api_errors.ObjectApiError as e:
            # a failed revocation must surface — the refresh loop would
            # otherwise resurrect the "deleted" credential from the
            # record that never left the store
            raise IAMStoreError(str(e)) from e

    def read_all(self, prefix: str) -> dict[str, dict]:
        from ..object import api_errors
        out: dict[str, dict] = {}
        try:
            objs, _, _ = self.obj.list_objects(
                MINIO_META_BUCKET, prefix=f"{IAM_PREFIX}/{prefix}/",
                max_keys=10000)
        except api_errors.ObjectApiError as e:
            # a listing failure is backend trouble, not an empty store
            # — returning {} here would wipe the caller's cache
            raise IAMStoreError(str(e)) from e
        for oi in objs:
            if not oi.name.endswith(".json"):
                continue
            name = urllib.parse.unquote(
                oi.name[len(f"{IAM_PREFIX}/{prefix}/"):-len(".json")])
            try:
                _, stream = self.obj.get_object(MINIO_META_BUCKET,
                                                oi.name)
                out[name] = json.loads(b"".join(stream).decode())
            except (api_errors.ObjectApiError, ValueError):
                continue
        return out

    def read_one(self, prefix: str, name: str) -> Optional[dict]:
        from ..object import api_errors
        try:
            _, stream = self.obj.get_object(
                MINIO_META_BUCKET, entity_path(prefix, name))
            return json.loads(b"".join(stream).decode())
        except (api_errors.ObjectNotFound, ValueError):
            return None
        except api_errors.ObjectApiError as e:
            raise IAMStoreError(str(e)) from e
