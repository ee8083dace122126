"""xl.meta v2 — the per-object version journal, msgpack-encoded.

Wire-compatible with the reference's format (cmd/xl-storage-format-v2.go):
8-byte header ``XL2 1   `` followed by a msgpack map with the same field
names/types the reference's msgp codegen emits
({"Versions": [{"Type": t, "V2Obj"/"DelObj": {...}}]}); UUIDs as 16-byte
bins, mod-times as int64 unix-nanos, EcDist as a byte string. A reference
binary, and minio_tpu, read this package's xl.meta and vice versa.

The journal holds every version of one object: regular objects
(ObjectType), delete markers (DeleteType); the most recently modified
entry is the latest version.
"""

from __future__ import annotations

import uuid as _uuid

import msgpack

from . import errors
from .datatypes import (ChecksumInfo, ErasureInfo, FileInfo, ObjectPartInfo,
                        NULL_VERSION_ID)

XL_HEADER = b"XL2 "
XL_VERSION = b"1   "

# VersionType (cmd/xl-storage-format-v2.go:92-98)
OBJECT_TYPE = 1
DELETE_TYPE = 2
LEGACY_TYPE = 3

# ErasureAlgo / ChecksumAlgo enums (ibid :104-138)
EC_REED_SOLOMON = 1
CSUM_HIGHWAYHASH = 1

RESERVED_METADATA_PREFIX = "x-minio-internal-"
BITROT_SIDECAR_KEY = "x-minio-internal-bitrot-checksums"

_ZERO_UUID = b"\x00" * 16


def _uuid_bytes(s: str) -> bytes:
    if not s or s == NULL_VERSION_ID:
        return _ZERO_UUID
    return _uuid.UUID(s).bytes


def _uuid_str(b: bytes) -> str:
    if b == _ZERO_UUID:
        return ""
    return str(_uuid.UUID(bytes=bytes(b)))


def is_xl2_v1_format(buf: bytes) -> bool:
    return (len(buf) > 8 and buf[:4] == XL_HEADER and buf[4:8] == XL_VERSION)


class XLMetaV2:
    """In-memory journal; versions is a list of raw msgpack-shaped dicts."""

    def __init__(self) -> None:
        self.versions: list[dict] = []

    # -- serialization ----------------------------------------------------

    def dumps(self) -> bytes:
        body = msgpack.packb({"Versions": self.versions}, use_bin_type=True)
        return XL_HEADER + XL_VERSION + body

    @classmethod
    def loads(cls, buf: bytes) -> "XLMetaV2":
        if not is_xl2_v1_format(buf):
            raise errors.FileCorrupt("xl.meta: bad XL2 header")
        z = cls()
        try:
            doc = msgpack.unpackb(buf[8:], raw=False, strict_map_key=False)
        except Exception as e:
            raise errors.FileCorrupt(f"xl.meta: msgpack decode: {e}") from e
        z.versions = list(doc.get("Versions") or [])
        return z

    # -- journal ops ------------------------------------------------------

    def add_version(self, fi: FileInfo) -> None:
        """Append/replace a version (reference AddVersion,
        cmd/xl-storage-format-v2.go:230-364): an existing entry with the
        same version ID is updated in place."""
        version_id = fi.version_id or NULL_VERSION_ID
        uv = _uuid_bytes(version_id)

        if fi.deleted:
            entry = {"Type": DELETE_TYPE,
                     "DelObj": {"ID": uv,
                                "MTime": int(fi.mod_time * 1e9)}}
            if fi.metadata:
                # the reference v2 DeleteMarker carries MetaSys for
                # exactly this: replication state riding on markers
                # (the replica-origin key) — absent for plain deletes
                entry["DelObj"]["MetaSys"] = {
                    k: v.encode() for k, v in fi.metadata.items()}
        else:
            meta_sys: dict[str, bytes] = {}
            meta_user: dict[str, str] = {}
            for k, v in fi.metadata.items():
                if k.lower().startswith(RESERVED_METADATA_PREFIX):
                    meta_sys[k] = v.encode()
                else:
                    meta_user[k] = v
            # v2 natively encodes only HighwayHash256S (CSumAlgo); other
            # bitrot algorithms + whole-file digests ride in MetaSys
            # (reference v2 is streaming-HH-only; this is our extension)
            if any(c.algorithm != "highwayhash256S" or c.hash
                   for c in fi.erasure.checksums):
                import json as _json
                meta_sys[BITROT_SIDECAR_KEY] = _json.dumps({
                    str(c.part_number): [c.algorithm, c.hash.hex()]
                    for c in fi.erasure.checksums}).encode()
            obj = {
                "ID": uv,
                "DDir": _uuid_bytes(fi.data_dir),
                "EcAlgo": EC_REED_SOLOMON,
                "EcM": fi.erasure.data_blocks,
                "EcN": fi.erasure.parity_blocks,
                "EcBSize": fi.erasure.block_size,
                "EcIndex": fi.erasure.index,
                "EcDist": bytes(fi.erasure.distribution),
                "CSumAlgo": CSUM_HIGHWAYHASH,
                "PartNums": [p.number for p in fi.parts],
                "PartETags": [p.etag for p in fi.parts],
                "PartSizes": [p.size for p in fi.parts],
                "PartASizes": [p.actual_size for p in fi.parts],
                "Size": fi.size,
                "MTime": int(fi.mod_time * 1e9),
                "MetaSys": meta_sys,
                "MetaUsr": meta_user,
            }
            entry = {"Type": OBJECT_TYPE, "V2Obj": obj}

        for i, v in enumerate(self.versions):
            if self._version_id_of(v) == uv:
                self.versions[i] = entry
                return
        self.versions.append(entry)

    def delete_version(self, fi: FileInfo) -> tuple[str, bool]:
        """Remove the version with fi.version_id.

        Returns (data_dir to purge — "" if none, last_version). Mirrors
        reference DeleteVersion (cmd/xl-storage-format-v2.go:428-).
        """
        version_id = fi.version_id or NULL_VERSION_ID
        uv = _uuid_bytes(version_id)
        for i, v in enumerate(self.versions):
            if self._version_id_of(v) != uv:
                continue
            data_dir = ""
            if v.get("Type") == OBJECT_TYPE:
                data_dir = _uuid_str(v["V2Obj"].get("DDir", _ZERO_UUID))
            del self.versions[i]
            return data_dir, len(self.versions) == 0
        raise errors.FileVersionNotFound(version_id)

    # -- queries ----------------------------------------------------------

    @staticmethod
    def _version_id_of(v: dict) -> bytes:
        t = v.get("Type")
        if t == OBJECT_TYPE:
            return bytes(v["V2Obj"]["ID"])
        if t == DELETE_TYPE:
            return bytes(v["DelObj"]["ID"])
        return b"\xff" * 16

    @staticmethod
    def _mod_time_of(v: dict) -> int:
        t = v.get("Type")
        if t == OBJECT_TYPE:
            return v["V2Obj"]["MTime"]
        if t == DELETE_TYPE:
            return v["DelObj"]["MTime"]
        return 0

    def sorted_versions(self) -> list[dict]:
        """Versions newest-first: (ModTime, version id) descending —
        the version-id tie-break is the active-active replication
        plane's deterministic conflict order. Two sites holding the
        same version set (same-instant writes replicated both ways)
        must resolve "latest" identically, and mod-time-only ordering
        would fall back to per-site journal insertion order."""
        return sorted(
            self.versions,
            key=lambda v: (self._mod_time_of(v),
                           _uuid_str(self._version_id_of(v))),
            reverse=True)

    def to_file_info(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo:
        """Resolve one version (default: latest) to a FileInfo
        (reference ToFileInfo, cmd/xl-storage-format-v2.go:366-423)."""
        if not self.versions:
            raise errors.FileNotFound(path)
        ordered = self.sorted_versions()
        if version_id and version_id != NULL_VERSION_ID:
            want = _uuid_bytes(version_id)
        else:
            want = None
        for i, v in enumerate(ordered):
            vid = self._version_id_of(v)
            if want is None:
                if version_id == NULL_VERSION_ID and vid != _ZERO_UUID:
                    continue
                return self._entry_to_fi(v, volume, path, is_latest=(i == 0))
            if vid == want:
                return self._entry_to_fi(v, volume, path, is_latest=(i == 0))
        raise errors.FileVersionNotFound(version_id or path)

    def list_file_infos(self, volume: str, path: str) -> list[FileInfo]:
        """Every version, newest first."""
        return [self._entry_to_fi(v, volume, path, is_latest=(i == 0))
                for i, v in enumerate(self.sorted_versions())]

    def _entry_to_fi(self, v: dict, volume: str, path: str,
                     is_latest: bool) -> FileInfo:
        t = v.get("Type")
        if t == DELETE_TYPE:
            d = v["DelObj"]
            md = {k: (val.decode() if isinstance(val, (bytes, bytearray))
                      else str(val))
                  for k, val in (d.get("MetaSys") or {}).items()}
            return FileInfo(
                volume=volume, name=path,
                version_id=_uuid_str(bytes(d["ID"])),
                is_latest=is_latest, deleted=True,
                mod_time=d["MTime"] / 1e9, metadata=md)
        if t != OBJECT_TYPE:
            raise errors.FileCorrupt(f"xl.meta: unsupported version type {t}")
        o = v["V2Obj"]
        parts = [ObjectPartInfo(number=n, etag=e, size=s, actual_size=a)
                 for n, e, s, a in zip(o["PartNums"], o["PartETags"],
                                       o["PartSizes"],
                                       o.get("PartASizes") or o["PartSizes"])]
        metadata: dict[str, str] = dict(o.get("MetaUsr") or {})
        for k, val in (o.get("MetaSys") or {}).items():
            if k.lower().startswith(RESERVED_METADATA_PREFIX):
                metadata[k] = (val.decode()
                               if isinstance(val, (bytes, bytearray)) else val)
        sidecar = metadata.pop(BITROT_SIDECAR_KEY, "")
        if sidecar:
            import json as _json
            side = _json.loads(sidecar)
            checksums = [ChecksumInfo(part_number=int(n), algorithm=a,
                                      hash=bytes.fromhex(h))
                         for n, (a, h) in side.items()]
        else:
            checksums = [ChecksumInfo(part_number=p.number,
                                      algorithm="highwayhash256S", hash=b"")
                         for p in parts]
        ei = ErasureInfo(
            algorithm="rs-vandermonde",
            data_blocks=o["EcM"], parity_blocks=o["EcN"],
            block_size=o["EcBSize"], index=o["EcIndex"],
            distribution=list(bytes(o["EcDist"])),
            checksums=checksums)
        return FileInfo(
            volume=volume, name=path,
            version_id=_uuid_str(bytes(o["ID"])),
            is_latest=is_latest, deleted=False,
            data_dir=_uuid_str(bytes(o["DDir"])),
            mod_time=o["MTime"] / 1e9, size=o["Size"],
            metadata=metadata, parts=parts, erasure=ei)
