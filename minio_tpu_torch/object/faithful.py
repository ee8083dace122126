"""Version-faithful object writes through the public layer verbs.

Counterpart of minio_tpu/object/faithful.py: replay one version EXACTLY,
as the tier restore does over its own stub.

  * identity (version id, mod time, etag) is kept through the engine's
    explicit-identity writes (``PutOptions.mod_time``,
    ``put_delete_marker``, ``complete_multipart_upload``'s
    version-faithful keywords);
  * **part boundaries survive**: a multipart object replays through a
    real multipart session (one ``put_object_part`` per recorded part),
    so the committed part list equals the source's and the recomputed
    multipart etag (md5 of the part md5s, ``-N``) equals the source's;
  * a transitioned zero-data stub replays as METADATA
    (``put_stub_version``), never as a 0-byte data object;
  * delete markers replay with their version id, mod time and metadata.

``VersionSpec`` round-trips through a plain dict (the reference's
replication client carries it in one header).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..storage.datatypes import (ObjectInfo, ObjectPartInfo,
                                 is_restored, is_transitioned)
from . import api_errors
from .engine import PutOptions
from .multipart import CompletePart


@dataclasses.dataclass
class VersionSpec:
    """Everything needed to re-create one object version, the bytes
    aside."""
    version_id: str = ""
    mod_time: float = 0.0
    etag: str = ""
    size: int = 0
    delete_marker: bool = False
    # user metadata + content-type/content-encoding, internal keys
    # (transition pointers) included
    metadata: dict = dataclasses.field(default_factory=dict)
    # [(number, size, actual_size, etag)]: empty or one entry = one part
    parts: list = dataclasses.field(default_factory=list)

    @property
    def transitioned_stub(self) -> bool:
        return is_transitioned(self.metadata) \
            and not is_restored(self.metadata)

    def to_dict(self) -> dict:
        return {"v": self.version_id, "t": self.mod_time, "e": self.etag,
                "s": self.size, "dm": self.delete_marker,
                "md": dict(self.metadata),
                "p": [list(p) for p in self.parts]}

    @classmethod
    def from_dict(cls, d: dict) -> "VersionSpec":
        return cls(version_id=str(d.get("v", "") or ""),
                   mod_time=float(d.get("t", 0.0) or 0.0),
                   etag=str(d.get("e", "") or ""),
                   size=int(d.get("s", 0) or 0),
                   delete_marker=bool(d.get("dm", False)),
                   metadata=dict(d.get("md") or {}),
                   parts=[tuple(p) for p in (d.get("p") or [])])


def spec_of(info: ObjectInfo) -> VersionSpec:
    """The replayable identity of one version's ObjectInfo."""
    md = dict(info.user_defined or {})
    if info.content_type:
        md["content-type"] = info.content_type
    if info.content_encoding:
        md["content-encoding"] = info.content_encoding
    parts = [(p.number, p.size,
              p.actual_size if p.actual_size >= 0 else p.size, p.etag)
             for p in (info.parts or [])]
    return VersionSpec(version_id=info.version_id or "",
                       mod_time=info.mod_time, etag=info.etag,
                       size=info.size,
                       delete_marker=bool(info.delete_marker),
                       metadata=md, parts=parts)


class _SegmentReader:
    """Exactly `limit` bytes of an underlying reader as one part's stream
    (the multipart replay cuts the source stream at the recorded part
    boundaries)."""

    def __init__(self, inner, limit: int):
        self.inner = inner
        self.remaining = limit

    def read(self, n: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        want = self.remaining if n < 0 else min(n, self.remaining)
        chunk = self.inner.read(want)
        self.remaining -= len(chunk)
        return chunk


def stub_object_info(bucket: str, name: str, spec: VersionSpec
                     ) -> ObjectInfo:
    """The ObjectInfo of a transitioned stub spec: put_stub_version's
    input (the target set mints the geometry)."""
    md = dict(spec.metadata)
    return ObjectInfo(
        bucket=bucket, name=name, mod_time=spec.mod_time,
        size=spec.size, etag=spec.etag, version_id=spec.version_id,
        content_type=md.pop("content-type", ""),
        content_encoding=md.pop("content-encoding", ""),
        user_defined=md,
        parts=[ObjectPartInfo(number=n, size=s, actual_size=a, etag=e)
               for n, s, a, e in spec.parts])


class ReplayEtagMismatch(api_errors.ObjectApiError):
    """Replayed bytes don't hash to the source version's etag."""


def replay_version(layer, bucket: str, name: str, spec: VersionSpec,
                   reader=None,
                   reader_factory: Optional[Callable] = None,
                   conflict_gate: Optional[bool] = None) -> ObjectInfo:
    """Write one version at `layer` with its full identity. `reader` (or
    the lazily called `reader_factory`) gives a data version's stored
    bytes; markers and stubs need none.

    `conflict_gate` is the unversioned last-writer-wins commit gate
    (PutOptions.if_none_newer): None applies it to every unversioned
    data replay; a caller rewriting the same identity in place (the
    restore over its own stub) passes False. Raises ReplayEtagMismatch
    when a replay's recomputed etag differs from the spec's."""
    gate = (not spec.version_id) if conflict_gate is None \
        else conflict_gate
    md = dict(spec.metadata)
    if spec.delete_marker:
        return layer.put_delete_marker(bucket, name, spec.version_id,
                                       spec.mod_time, md)
    if spec.transitioned_stub:
        return layer.put_stub_version(bucket, name,
                                      stub_object_info(bucket, name, spec),
                                      if_none_newer=gate)
    if reader is None:
        if reader_factory is None:
            raise ValueError("data version replay needs a reader")
        reader = reader_factory()
    if len(spec.parts) > 1:
        return _replay_multipart(layer, bucket, name, spec, reader, md,
                                 gate)
    opts = PutOptions(metadata={**md, "etag": spec.etag},
                      version_id=spec.version_id,
                      versioned=bool(spec.version_id),
                      mod_time=spec.mod_time, if_none_newer=gate)
    return layer.put_object(bucket, name, reader, spec.size, opts)


def _replay_multipart(layer, bucket: str, name: str, spec: VersionSpec,
                      reader, md: dict, gate: bool = False) -> ObjectInfo:
    opts = PutOptions(metadata=md, versioned=bool(spec.version_id))
    upload_id = layer.new_multipart_upload(bucket, name, opts)
    try:
        completes = []
        for number, size, _actual, part_etag in sorted(spec.parts):
            pi = layer.put_object_part(bucket, name, upload_id, number,
                                       _SegmentReader(reader, size), size)
            if part_etag and pi.etag != part_etag:
                raise ReplayEtagMismatch(
                    f"{bucket}/{name} part {number}: got {pi.etag}, "
                    f"want {part_etag}")
            completes.append(CompletePart(number, pi.etag))
        info = layer.complete_multipart_upload(
            bucket, name, upload_id, completes,
            version_id=spec.version_id, mod_time=spec.mod_time,
            if_none_newer=gate)
    except Exception:
        try:
            layer.abort_multipart_upload(bucket, name, upload_id)
        except api_errors.ObjectApiError:
            pass
        raise
    if spec.etag and info.etag != spec.etag:
        raise ReplayEtagMismatch(
            f"{bucket}/{name}: multipart etag {info.etag} != source "
            f"{spec.etag}")
    return info
