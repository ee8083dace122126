"""Replication target clients: how one site writes at another.
Counterpart of minio_tpu/replicate/client.py; the wire (the spec header,
the admin replicate/key JSON, the purge DELETE) is the reference's, so a
port site and a reference site push to each other alike.

One small verb surface so the sync worker and the resync walker stay
transport-agnostic (the reference's TargetClient, cmd/bucket-targets.go
+ the x-minio-source-* internal replication headers its peers honor):

  * :class:`LayerReplClient` — any in-process ObjectLayer (the
    two-cluster test harness, and same-process site pairs);
  * :class:`HTTPReplClient`  — a remote minio_tpu or minio_tpu_torch
    endpoint over SigV4,
    carrying the version-faithful spec in one internal header the S3
    PUT handler honors for owner credentials;
  * :class:`NaughtyReplClient` — deterministic fault wrapper (chaos
    tests: per-verb errors, 503 storms, offline windows, mid-stream
    death on the push body).

Verbs:

  ``remote_site()``            the target cluster's site id
  ``ensure_bucket()``          create the destination bucket if absent
  ``key_versions(key)``        every version of one key, as VersionSpecs
  ``apply_version(key, spec, reader_factory)``  idempotent faithful
      write — returns "applied" or "skipped" (conflict rule: for the
      unversioned slot the higher (mod_time, version_id) wins)
  ``delete_version(key, vid)`` purge one version (replica prune)
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import json
import threading
import time
import urllib.parse
from typing import Callable, List, Optional

from ..object import api_errors
from ..object.faithful import VersionSpec, replay_version, spec_of
from ..utils import telemetry
from .targets import SiteTarget

_REPL_SPEC_HEADER = "x-minio-tpu-repl-spec"
_REPL_PURGE_HEADER = "x-minio-tpu-repl-purge"


class ReplClientError(Exception):
    """Target I/O failed (network, upstream 5xx, short stream)."""


class ReplTargetOffline(ReplClientError):
    """The target did not answer at all (connection-level failure)."""


_REPLICA_WRITES = None


def replica_writes_counter():
    """Replica versions WRITTEN at a site (the apply side). A flat
    count at the origin across repeated sync cycles is the loop-
    suppression proof: a replicated write is never pushed back."""
    global _REPLICA_WRITES
    if _REPLICA_WRITES is None:
        _REPLICA_WRITES = telemetry.REGISTRY.counter(
            "minio_tpu_repl_replica_writes_total",
            "Replica versions applied at this site, by site id")
    return _REPLICA_WRITES


class ReplTargetClient:
    """Minimal replication-target verb surface."""

    # push-only targets (generic S3 endpoints) cannot list versions:
    # the sync sends only the key's LATEST state instead of diffing
    # the whole history (re-pushing every version per mutation would
    # scale bandwidth with version count)
    push_only = False

    def remote_site(self) -> str:
        raise NotImplementedError

    def ensure_bucket(self) -> None:
        raise NotImplementedError

    def key_versions(self, key: str) -> List[VersionSpec]:
        raise NotImplementedError

    def apply_version(self, key: str, spec: VersionSpec,
                      reader_factory: Optional[Callable] = None) -> str:
        raise NotImplementedError

    def delete_version(self, key: str, version_id: str) -> None:
        raise NotImplementedError


def unversioned_conflict_keep(existing: Optional[VersionSpec],
                              incoming: VersionSpec) -> bool:
    """True when the EXISTING unversioned slot wins the deterministic
    conflict rule — (mod_time, version_id, etag) descending. The etag
    tie-break is load-bearing: two sites writing DIFFERENT bytes with
    identical mod times (explicit PutOptions.mod_time, coarse clocks)
    must still converge on ONE copy, and only content identity breaks
    that tie the same way on both sides. A full tie means identical
    content — keeping either copy converges."""
    if existing is None:
        return False
    return (existing.mod_time, existing.version_id, existing.etag) >= \
        (incoming.mod_time, incoming.version_id, incoming.etag)


class LayerReplClient(ReplTargetClient):
    """Adapter: an in-process ObjectLayer as a replication target."""

    def __init__(self, layer, bucket: str, site_id: str):
        self.layer = layer
        self.bucket = bucket
        self.site_id = site_id

    def remote_site(self) -> str:
        return self.site_id

    def ensure_bucket(self) -> None:
        try:
            self.layer.make_bucket(self.bucket)
        except api_errors.BucketExists:
            pass

    def key_versions(self, key: str) -> List[VersionSpec]:
        try:
            return [spec_of(oi)
                    for oi in self.layer.object_versions(self.bucket, key)]
        except api_errors.BucketNotFound:
            return []
        except api_errors.ObjectApiError as e:
            raise ReplClientError(f"target versions read: {e!r}") from e

    def apply_version(self, key: str, spec: VersionSpec,
                      reader_factory: Optional[Callable] = None) -> str:
        try:
            # versioned applies need no pre-read: writing a version id
            # the journal already holds replaces the identical entry
            # (idempotent), and the caller's diff already filtered the
            # common case — re-listing here made a V-version resync
            # O(V^2) quorum reads. The unversioned slot keeps its
            # cheap pre-check; the ENGINE's in-lock if_none_newer gate
            # is the authoritative race-proof decision either way.
            if not spec.version_id:
                have = next((v for v in self.key_versions(key)
                             if not v.version_id), None)
                if unversioned_conflict_keep(have, spec):
                    return "skipped"
            replay_version(self.layer, self.bucket, key, spec,
                           reader_factory=reader_factory)
        except api_errors.PreConditionFailed:
            # the engine's in-lock conflict gate: an equal-or-newer
            # version already occupies the slot — converged
            return "skipped"
        except ReplClientError:
            raise
        except api_errors.ObjectApiError as e:
            raise ReplClientError(f"target apply: {e!r}") from e
        replica_writes_counter().inc(site=self.site_id)
        return "applied"

    def delete_version(self, key: str, version_id: str) -> None:
        try:
            self.layer.delete_object(self.bucket, key,
                                     version_id=version_id,
                                     versioned=False)
        except (api_errors.ObjectNotFound, api_errors.VersionNotFound):
            return
        except api_errors.ObjectApiError as e:
            raise ReplClientError(f"target delete: {e!r}") from e


class HTTPReplClient(ReplTargetClient):
    """SigV4 wire client against a remote site of either package. The
    version spec rides ONE internal header on an ordinary S3 PUT
    (honored only for the owner credential — see handlers.put_object),
    version listings ride the admin replicate/key endpoint."""

    def __init__(self, target: SiteTarget, timeout: float = 30.0):
        p = target.params
        self.host = p["host"]
        self.port = int(p.get("port", 9000))
        self.bucket = target.dest_bucket
        self.access_key = p.get("access_key", "")
        self.secret_key = p.get("secret_key", "")
        self.region = p.get("region", "us-east-1")
        self.timeout = timeout
        self._site: Optional[str] = None

    # -- plumbing ------------------------------------------------------

    def _request(self, method: str, path: str,
                 query: Optional[dict] = None, body: object = b"",
                 headers: Optional[dict] = None,
                 body_sha: Optional[str] = None,
                 content_length: Optional[int] = None
                 ) -> tuple[int, bytes]:
        """`body` may be bytes or a seekable file-like (streamed by
        http.client); a file body needs its `body_sha` pre-computed
        and `content_length` set (http.client cannot stat a spool)."""
        from ..s3 import signature as sig
        from ..s3.credentials import Credentials
        query = {k: [v] for k, v in (query or {}).items()}
        qs = urllib.parse.urlencode({k: v[0] for k, v in query.items()})
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        hdrs["host"] = f"{self.host}:{self.port}"
        if content_length is not None:
            hdrs["content-length"] = str(content_length)
        if body_sha is None:
            body_sha = hashlib.sha256(
                body if isinstance(body, (bytes, bytearray)) else b""
            ).hexdigest()
        hdrs = sig.sign_v4(method, urllib.parse.quote(path), query, hdrs,
                           body_sha,
                           Credentials(self.access_key, self.secret_key),
                           self.region)
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout)
            conn.request(method,
                         urllib.parse.quote(path) + (f"?{qs}" if qs
                                                     else ""),
                         body=body, headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
        except OSError as e:
            raise ReplTargetOffline(f"{self.host}:{self.port}: {e}") from e
        return resp.status, data

    # -- verbs ---------------------------------------------------------

    def remote_site(self) -> str:
        if self._site is None:
            status, data = self._request(
                "GET", "/minio/admin/v3/replicate")
            if status != 200:
                raise ReplClientError(f"replicate status: HTTP {status}")
            self._site = str(json.loads(data.decode()).get("site", ""))
        return self._site

    def ensure_bucket(self) -> None:
        status, _ = self._request("PUT", f"/{self.bucket}")
        if status not in (200, 409):
            raise ReplClientError(f"make bucket: HTTP {status}")

    def key_versions(self, key: str) -> List[VersionSpec]:
        status, data = self._request(
            "GET", "/minio/admin/v3/replicate/key",
            query={"bucket": self.bucket, "key": key})
        if status == 404:
            return []
        if status != 200:
            raise ReplClientError(f"key versions: HTTP {status}")
        doc = json.loads(data.decode())
        return [VersionSpec.from_dict(d)
                for d in doc.get("versions", [])]

    def apply_version(self, key: str, spec: VersionSpec,
                      reader_factory: Optional[Callable] = None) -> str:
        body: object = b""
        body_sha = None
        content_length = None
        if not spec.delete_marker and not spec.transitioned_stub:
            content_length = spec.size
            if reader_factory is None:
                raise ReplClientError("data version push needs a reader")
            reader = reader_factory()
            # hash in one streaming pass, then send the reader ITSELF
            # as the request body (the plane hands us a seekable spool:
            # RAM below 32 MiB, disk past it) — joining the chunks
            # into one bytes object doubled the resident size of every
            # large push
            h = hashlib.sha256()
            total = 0
            while True:
                chunk = reader.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
                total += len(chunk)
            if total != spec.size:
                raise ReplClientError(
                    f"short push stream: {total} of {spec.size}")
            if hasattr(reader, "seek"):
                reader.seek(0)
                body, body_sha = reader, h.hexdigest()
            else:                       # non-seekable: re-read fully
                reader = reader_factory()
                body = reader.read(-1) or b""
                body_sha = hashlib.sha256(body).hexdigest()
        hdr = base64.urlsafe_b64encode(
            json.dumps(spec.to_dict()).encode()).decode()
        status, data = self._request(
            "PUT", f"/{self.bucket}/{key}", body=body,
            body_sha=body_sha, content_length=content_length,
            headers={_REPL_SPEC_HEADER: hdr})
        if status != 200:
            raise ReplClientError(f"apply: HTTP {status} "
                                  f"{data[:200]!r}")
        try:
            return json.loads(data.decode()).get("result", "applied")
        except ValueError:
            return "applied"

    def delete_version(self, key: str, version_id: str) -> None:
        query = {"versionId": version_id} if version_id else None
        status, data = self._request(
            "DELETE", f"/{self.bucket}/{key}", query=query,
            headers={_REPL_PURGE_HEADER: "true"})
        if status not in (200, 204, 404):
            raise ReplClientError(f"delete: HTTP {status} {data[:200]!r}")


class NaughtyReplClient(ReplTargetClient):
    """Deterministic fault wrapper over a real target client — the
    NaughtyDisk/NaughtyTierClient model applied to the replication
    wire:

      * ``fail_verbs[verb] = exc``      fail EVERY call of a verb
      * ``verb_errors[verb][n] = exc``  fail exactly the n-th call
        (1-based per verb)
      * ``offline_until_call[verb] = n``  every call before the n-th
        raises ReplTargetOffline (a target-offline window that heals)
      * ``latency_s``                   sleep before every verb
      * ``die_midstream``               apply's reader dies after half
        the first chunk (push killed mid-body)

    Verbs: site, bucket, versions, apply, delete."""

    VERBS = ("site", "bucket", "versions", "apply", "delete")

    def __init__(self, inner: ReplTargetClient,
                 fail_verbs: Optional[dict] = None,
                 verb_errors: Optional[dict] = None,
                 offline_until_call: Optional[dict] = None,
                 latency_s: float = 0.0,
                 die_midstream: bool = False):
        self.inner = inner
        self.fail_verbs = dict(fail_verbs or {})
        self.verb_errors = {v: dict(m)
                            for v, m in (verb_errors or {}).items()}
        self.offline_until_call = dict(offline_until_call or {})
        self.latency_s = latency_s
        self.die_midstream = die_midstream
        self._mu = threading.Lock()
        self.calls: dict[str, int] = {v: 0 for v in self.VERBS}
        self.stats = {"errors": 0, "offline": 0, "midstream_deaths": 0}

    def clear_faults(self) -> None:
        with self._mu:
            self.fail_verbs.clear()
            self.verb_errors.clear()
            self.offline_until_call.clear()
            self.die_midstream = False

    def _enter(self, verb: str) -> None:
        with self._mu:
            self.calls[verb] += 1
            n = self.calls[verb]
            until = self.offline_until_call.get(verb, 0)
            err = self.fail_verbs.get(verb) \
                or self.verb_errors.get(verb, {}).get(n)
            lat = self.latency_s
        if lat:
            time.sleep(lat)
        if until and n < until:
            self.stats["offline"] += 1
            raise ReplTargetOffline(f"{verb}: offline window")
        if err is not None:
            self.stats["errors"] += 1
            raise err

    def remote_site(self) -> str:
        self._enter("site")
        return self.inner.remote_site()

    def ensure_bucket(self) -> None:
        self._enter("bucket")
        self.inner.ensure_bucket()

    def key_versions(self, key: str) -> List[VersionSpec]:
        self._enter("versions")
        return self.inner.key_versions(key)

    def apply_version(self, key: str, spec: VersionSpec,
                      reader_factory: Optional[Callable] = None) -> str:
        self._enter("apply")
        if self.die_midstream and reader_factory is not None:
            outer = self

            def dying_factory():
                reader = reader_factory()

                class _Dying:
                    def __init__(self):
                        self.fed = 0

                    def read(self, n: int = -1) -> bytes:
                        chunk = reader.read(n)
                        if self.fed + len(chunk) > max(spec.size // 2, 1):
                            outer.stats["midstream_deaths"] += 1
                            raise ReplClientError(
                                "connection died mid-stream")
                        self.fed += len(chunk)
                        return chunk

                return _Dying()

            return self.inner.apply_version(key, spec, dying_factory)
        return self.inner.apply_version(key, spec, reader_factory)

    def delete_version(self, key: str, version_id: str) -> None:
        self._enter("delete")
        self.inner.delete_version(key, version_id)


class PushS3ReplClient(ReplTargetClient):
    """One-way push to a GENERIC S3 endpoint (AWS, reference MinIO) —
    the legacy bucket-metadata remote targets' semantics carried into
    the plane: no peer admin surface, no version listing, no identity
    preservation. Every sync re-pushes the key's versions oldest-first
    (the remote converges on the latest state, like the old
    ReplicationPool's fire-and-forget copier); markers become plain
    DELETEs; transitioned stubs are skipped (a generic remote cannot
    hold a metadata-only version)."""

    push_only = True

    def __init__(self, target: SiteTarget):
        from ..features.replication import (ReplicationTarget,
                                            _S3MiniClient)
        p = target.params
        self._mini = _S3MiniClient(ReplicationTarget(
            arn=target.arn, host=p["host"],
            port=int(p.get("port", 9000)),
            bucket=target.dest_bucket,
            access_key=p.get("access_key", ""),
            secret_key=p.get("secret_key", ""),
            region=p.get("region", "us-east-1"),
            secure=bool(p.get("secure", False))))

    def remote_site(self) -> str:
        return ""                       # not a peer: no site identity

    def ensure_bucket(self) -> None:
        pass                            # remote bucket pre-exists

    def key_versions(self, key: str) -> List[VersionSpec]:
        return []                       # no diff surface (push_only)

    def apply_version(self, key: str, spec: VersionSpec,
                      reader_factory: Optional[Callable] = None) -> str:
        try:
            if spec.delete_marker:
                if not self._mini.delete_object(key):
                    raise ReplClientError(f"remote DELETE {key} failed")
                return "applied"
            if spec.transitioned_stub:
                return "skipped"        # unrepresentable remotely
            if reader_factory is None:
                raise ReplClientError("data push needs a reader")
            reader = reader_factory()
            body = reader.read(-1) or b""
            md = {k: v for k, v in spec.metadata.items()
                  if not k.lower().startswith("x-minio-internal")}
            if not self._mini.put_object(key, body, md):
                raise ReplClientError(f"remote PUT {key} failed")
            return "applied"
        except OSError as e:
            raise ReplTargetOffline(str(e)) from e

    def delete_version(self, key: str, version_id: str) -> None:
        try:
            self._mini.delete_object(key)
        except OSError as e:
            raise ReplTargetOffline(str(e)) from e


def new_repl_client(target: SiteTarget) -> ReplTargetClient:
    """Client factory from a persisted target entry ("s3" = a
    minio_tpu or minio_tpu_torch peer over the internal wire form, "push" = a generic
    S3 endpoint, one-way; "layer" targets are injected live via
    registry.set_client)."""
    if target.type == "s3":
        return HTTPReplClient(target)
    if target.type == "push":
        return PushS3ReplClient(target)
    raise ValueError(f"unknown replication target type {target.type!r}")
