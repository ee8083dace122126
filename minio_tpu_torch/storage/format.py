"""format.json v3 — per-drive identity and erasure topology.

JSON-compatible with the reference (cmd/format-erasure.go:106-127):

    {"version": "1", "format": "xl", "id": <deploymentID>,
     "xl": {"version": "3", "this": <diskUUID>,
            "sets": [[uuid, ...], ...], "distributionAlgo": "SIPMOD"}}

Every drive stores the full sets×drives UUID matrix, so any quorum of
drives can re-derive the cluster topology (getFormatErasureInQuorum,
cmd/format-erasure.go:585).
"""

from __future__ import annotations

import dataclasses
import json
import uuid as _uuid
from collections import Counter

from . import errors

FORMAT_CONFIG_FILE = "format.json"
MINIO_META_BUCKET = ".minio.sys"
DISTRIBUTION_ALGO_V2 = "CRCMOD"
DISTRIBUTION_ALGO_V3 = "SIPMOD"


@dataclasses.dataclass
class FormatErasureV3:
    version: str = "1"
    format: str = "xl"
    id: str = ""                       # deployment ID
    erasure_version: str = "3"
    this: str = ""                     # this drive's UUID
    sets: list[list[str]] = dataclasses.field(default_factory=list)
    distribution_algo: str = DISTRIBUTION_ALGO_V3

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "format": self.format,
            "id": self.id,
            "xl": {
                "version": self.erasure_version,
                "this": self.this,
                "sets": self.sets,
                "distributionAlgo": self.distribution_algo,
            },
        })

    @classmethod
    def from_json(cls, data: str | bytes) -> "FormatErasureV3":
        try:
            d = json.loads(data)
        except Exception as e:
            raise errors.CorruptedFormat(str(e)) from e
        if d.get("format") != "xl":
            raise errors.CorruptedFormat(
                f"unsupported backend format {d.get('format')!r}")
        xl = d.get("xl") or {}
        if xl.get("version") != "3":
            raise errors.CorruptedFormat(
                f"unsupported xl format version {xl.get('version')!r}")
        return cls(version=d.get("version", "1"), format="xl",
                   id=d.get("id", ""), erasure_version="3",
                   this=xl.get("this", ""), sets=xl.get("sets", []),
                   distribution_algo=xl.get("distributionAlgo",
                                            DISTRIBUTION_ALGO_V3))


def new_format_erasure_v3(num_sets: int, set_drive_count: int,
                          deployment_id: str = "") -> list[list[FormatErasureV3]]:
    """Fresh formats for numSets×setDriveCount drives
    (reference newFormatErasureV3, cmd/format-erasure.go:106-127)."""
    deployment_id = deployment_id or str(_uuid.uuid4())
    sets = [[str(_uuid.uuid4()) for _ in range(set_drive_count)]
            for _ in range(num_sets)]
    out: list[list[FormatErasureV3]] = []
    for i in range(num_sets):
        row = []
        for j in range(set_drive_count):
            row.append(FormatErasureV3(
                id=deployment_id, this=sets[i][j],
                sets=[list(s) for s in sets]))
        out.append(row)
    return out


def get_format_in_quorum(formats: list[FormatErasureV3 | None]
                         ) -> FormatErasureV3:
    """Pick the topology attested by a strict majority of drives
    (reference getFormatErasureInQuorum, cmd/format-erasure.go:585):
    formats are grouped by their sets-matrix; the largest group must
    exceed N/2."""
    live = [f for f in formats if f is not None]
    if not live:
        raise errors.UnformattedDisk("no formatted drives")
    counts: Counter[str] = Counter()
    for f in live:
        counts[json.dumps(f.sets)] += 1
    key, n = counts.most_common(1)[0]
    if n <= len(formats) // 2:
        raise errors.CorruptedFormat(
            f"no format quorum: best {n} of {len(formats)}")
    for f in live:
        if json.dumps(f.sets) == key:
            ref = dataclasses.replace(f, this="")
            return ref
    raise errors.CorruptedFormat("unreachable")


def read_format_from(disk) -> FormatErasureV3:
    """Read format.json through the StorageAPI surface (works for local
    AND remote drives — the remote bootstrap path)."""
    data = disk.read_all(MINIO_META_BUCKET, FORMAT_CONFIG_FILE)
    return FormatErasureV3.from_json(data)


def write_format_to(disk, fmt: FormatErasureV3) -> None:
    """Write format.json through the StorageAPI surface, creating the
    meta volumes (reference initFormatErasure per-disk work)."""
    for vol in (MINIO_META_BUCKET, MINIO_META_BUCKET + "/buckets",
                MINIO_META_BUCKET + "/tmp", MINIO_META_BUCKET + "/multipart"):
        try:
            disk.make_vol(vol)
        except errors.VolumeExists:
            pass
    disk.write_all(MINIO_META_BUCKET, FORMAT_CONFIG_FILE,
                   fmt.to_json().encode())
    try:
        disk.set_disk_id(fmt.this)
    except errors.StorageError:
        pass
