"""Warm-tier clients: where transitioned object data lives.

Counterpart of minio_tpu/tier/client.py. One small verb surface
(put/get/head/delete) keeps the transition worker and the restore path
backend-agnostic (the reference's WarmBackend, cmd/warm-backend-*.go):

  * :class:`FSTierClient`       — a local directory (a NAS mount, tests)
  * :class:`GatewayTierClient`  — any object layer pinned to one bucket
    and prefix
  * :class:`NaughtyTierClient`  — a deterministic fault wrapper (errors,
    latency, short reads on restore)

Remote keys are opaque strings minted by the tier manager; a client
tolerates `/` in keys.

Departure: the ``s3``, ``azure``, ``gcs`` and ``hdfs`` tier types reach
their backends through the reference's gateway plane (gateway/*), which
this port does not serve; ``new_tier_client`` refuses them with a
TierClientError that names it. ``fs`` is the type one node can back.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import uuid as _uuid
from typing import Iterator, Optional

_CHUNK = 1 << 20

# tier types whose clients the reference builds over its gateway plane
GATEWAY_TYPES = ("s3", "azure", "gcs", "hdfs")


class TierClientError(Exception):
    """Remote tier I/O failed (network, upstream 5xx, short object), or
    the tier's type cannot be served."""


class TierObjectNotFound(TierClientError):
    """The remote copy is gone (never written, or already freed)."""


class TierClient:
    """The warm-backend verb surface."""

    def put(self, key: str, reader, size: int) -> str:
        """Store `size` bytes from `reader` (file-like .read) under
        `key`; returns the backend's etag or version token ("" if
        none)."""
        raise NotImplementedError

    def get(self, key: str, offset: int = 0,
            length: int = -1) -> Iterator[bytes]:
        raise NotImplementedError

    def head(self, key: str) -> int:
        """Size of the remote copy; raises TierObjectNotFound."""
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Free the remote copy (a missing key is a no-op)."""
        raise NotImplementedError


class FSTierClient(TierClient):
    """Filesystem tier: one directory, keys as relative paths. Writes are
    staged and atomically renamed, so a crashed transition never leaves a
    short remote copy that `head` would then "verify"."""

    def __init__(self, path: str):
        self.root = os.path.abspath(path)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        fp = os.path.abspath(os.path.join(self.root, key))
        if not fp.startswith(self.root + os.sep):
            raise TierClientError(f"tier key escapes root: {key!r}")
        return fp

    def put(self, key: str, reader, size: int) -> str:
        fp = self._path(key)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        tmp = f"{fp}.tmp-{_uuid.uuid4().hex}"
        h = hashlib.md5()
        got = 0
        try:
            with open(tmp, "wb") as f:
                while size < 0 or got < size:
                    want = _CHUNK if size < 0 else min(_CHUNK, size - got)
                    chunk = reader.read(want)
                    if not chunk:
                        break
                    f.write(chunk)
                    h.update(chunk)
                    got += len(chunk)
            if 0 <= size != got:
                raise TierClientError(
                    f"short tier write: {got} of {size} bytes")
            os.replace(tmp, fp)
        except OSError as e:
            raise TierClientError(f"tier write failed: {e}") from e
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return h.hexdigest()

    def get(self, key: str, offset: int = 0,
            length: int = -1) -> Iterator[bytes]:
        fp = self._path(key)
        try:
            f = open(fp, "rb")
        except FileNotFoundError:
            raise TierObjectNotFound(key) from None
        except OSError as e:
            raise TierClientError(f"tier read failed: {e}") from e

        def gen() -> Iterator[bytes]:
            with f:
                f.seek(offset)
                remaining = length
                while remaining != 0:
                    want = _CHUNK if remaining < 0 \
                        else min(_CHUNK, remaining)
                    chunk = f.read(want)
                    if not chunk:
                        return
                    if remaining > 0:
                        remaining -= len(chunk)
                    yield chunk

        return gen()

    def head(self, key: str) -> int:
        try:
            return os.path.getsize(self._path(key))
        except FileNotFoundError:
            raise TierObjectNotFound(key) from None
        except OSError as e:
            raise TierClientError(f"tier head failed: {e}") from e

    def delete(self, key: str) -> None:
        fp = self._path(key)
        try:
            os.unlink(fp)
        except FileNotFoundError:
            return
        except OSError as e:
            raise TierClientError(f"tier delete failed: {e}") from e
        # prune the key's now-empty directories back up to the root
        d = os.path.dirname(fp)
        while d.startswith(self.root + os.sep):
            try:
                os.rmdir(d)
            except OSError:
                return
            d = os.path.dirname(d)


class GatewayTierClient(TierClient):
    """Any object layer pinned to one bucket and key prefix as a warm
    tier (the reference wraps its gateway layers; here any port layer,
    an ErasureServerSets of another node's drives for one)."""

    def __init__(self, layer, bucket: str, prefix: str = ""):
        self.layer = layer
        self.bucket = bucket
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def _map(self, e: Exception, key: str) -> Exception:
        from ..object import api_errors
        if isinstance(e, (api_errors.ObjectNotFound,
                          api_errors.VersionNotFound)):
            return TierObjectNotFound(key)
        return TierClientError(f"tier backend error: {e!r}")

    def put(self, key: str, reader, size: int) -> str:
        from ..object import api_errors
        try:
            info = self.layer.put_object(self.bucket, self._key(key),
                                         reader, size)
        except api_errors.ObjectApiError as e:
            raise self._map(e, key) from None
        return getattr(info, "etag", "") or ""

    def get(self, key: str, offset: int = 0,
            length: int = -1) -> Iterator[bytes]:
        from ..object import api_errors
        try:
            _, stream = self.layer.get_object(self.bucket, self._key(key),
                                              offset, length)
        except api_errors.ObjectApiError as e:
            raise self._map(e, key) from None
        return stream

    def head(self, key: str) -> int:
        from ..object import api_errors
        try:
            return self.layer.get_object_info(self.bucket,
                                              self._key(key)).size
        except api_errors.ObjectApiError as e:
            raise self._map(e, key) from None

    def delete(self, key: str) -> None:
        from ..object import api_errors
        try:
            self.layer.delete_object(self.bucket, self._key(key))
        except (api_errors.ObjectNotFound, api_errors.VersionNotFound):
            return
        except api_errors.ObjectApiError as e:
            raise self._map(e, key) from None


class NaughtyTierClient(TierClient):
    """Deterministic fault wrapper over a real tier client:

      * ``fail_verbs[verb] = exc``       fail EVERY call of a verb
      * ``verb_errors[verb][n] = exc``   fail exactly the n-th call
        (1-based per verb)
      * ``latency_s``                    sleep before every call
      * ``short_read_verbs``             truncate the returned stream
        (a restore sees fewer bytes than head promised)

    ``stats`` counts what was injected."""

    VERBS = ("put", "get", "head", "delete")

    def __init__(self, inner: TierClient,
                 fail_verbs: Optional[dict] = None,
                 verb_errors: Optional[dict] = None,
                 latency_s: float = 0.0,
                 short_read_verbs: tuple = ()):
        self.inner = inner
        self.fail_verbs = dict(fail_verbs or {})
        self.verb_errors = {v: dict(m)
                            for v, m in (verb_errors or {}).items()}
        self.latency_s = latency_s
        self.short_read_verbs = tuple(short_read_verbs)
        self._mu = threading.Lock()
        self.calls: dict[str, int] = {v: 0 for v in self.VERBS}
        self.stats = {"errors": 0, "latency": 0, "short_reads": 0}

    def clear_faults(self) -> None:
        with self._mu:
            self.fail_verbs.clear()
            self.verb_errors.clear()
            self.short_read_verbs = ()

    def _enter(self, verb: str) -> None:
        with self._mu:
            self.calls[verb] += 1
            n = self.calls[verb]
            err = self.fail_verbs.get(verb) \
                or self.verb_errors.get(verb, {}).get(n)
            lat = self.latency_s
        if lat:
            self.stats["latency"] += 1
            time.sleep(lat)
        if err is not None:
            self.stats["errors"] += 1
            raise err

    def put(self, key: str, reader, size: int) -> str:
        self._enter("put")
        return self.inner.put(key, reader, size)

    def get(self, key: str, offset: int = 0,
            length: int = -1) -> Iterator[bytes]:
        self._enter("get")
        stream = self.inner.get(key, offset, length)
        if "get" not in self.short_read_verbs:
            return stream

        def truncated() -> Iterator[bytes]:
            first = next(iter(stream), b"")
            if first:
                self.stats["short_reads"] += 1
                yield first[:max(1, len(first) // 2)]

        return truncated()

    def head(self, key: str) -> int:
        self._enter("head")
        return self.inner.head(key)

    def delete(self, key: str) -> None:
        self._enter("delete")
        self.inner.delete(key)


def gateway_refusal(type_: str) -> TierClientError:
    return TierClientError(
        f"tier type {type_!r} needs the gateway plane (gateway/*), which "
        "this port does not serve; fs is the type one node can back")


def new_tier_client(type_: str, params: dict) -> TierClient:
    """Client factory from a persisted tier config entry."""
    if type_ == "fs":
        path = params.get("path", "")
        if not path:
            raise TierClientError("fs tier needs a 'path'")
        return FSTierClient(path)
    if type_ in GATEWAY_TYPES:
        raise gateway_refusal(type_)
    raise TierClientError(f"unknown tier type {type_!r} "
                          "(supported: fs, s3, azure, gcs, hdfs)")
