"""Remote-site target registry: where active-active replication goes.

The reference keeps per-bucket remote targets in bucket metadata
(cmd/bucket-targets.go); this registry promotes them to a first-class
persisted document — ``.minio.sys/replicate/targets.json`` written to
EVERY pool and recovered highest-epoch-wins, exactly the durability
rule the topology and tier planes use: any surviving subset of pools
recovers the newest registry, so replication targets keep working
through decommission and pool expansion.

The document also carries this cluster's own ``site_id`` — the
identity stamped (as the replica-origin metadata key) onto every
version this site pushes, which is what makes loop suppression and
replica pruning possible without any per-version status writes.

Counterpart of minio_tpu/replicate/targets.py: a target added or looked
up with no injected client builds its wire client (``client.py``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import uuid as _uuid
from typing import Optional

from ..object import api_errors
from ..utils import atomicfile, crashpoint, regfence
from ..storage.xl_storage import MINIO_META_BUCKET

REPL_PREFIX = "replicate/"
TARGETS_OBJECT = REPL_PREFIX + "targets.json"

# version metadata key: the site id of the cluster where this version
# was ORIGINALLY written. Absent = a native write of the local site.
# The X-Minio-Internal- prefix rides xl.meta and never leaks to clients.
REPL_ORIGIN_KEY = "X-Minio-Internal-replication-origin"

_SECRET_PARAMS = ("secret_key",)


def origin_of(metadata: Optional[dict], self_site: str) -> str:
    """The site a version originated at (the local site when the
    version carries no replica marker)."""
    return (metadata or {}).get(REPL_ORIGIN_KEY, "") or self_site


def is_replica(metadata: Optional[dict]) -> bool:
    return bool((metadata or {}).get(REPL_ORIGIN_KEY, ""))


class ReplTargetError(api_errors.ObjectApiError):
    """Invalid replication-target operation (duplicate ARN, unknown
    ARN, bad spec)."""


@dataclasses.dataclass
class SiteTarget:
    """One replication destination for one source bucket."""
    arn: str
    bucket: str                    # source bucket on THIS site
    dest_bucket: str               # bucket at the remote site
    site: str = ""                 # remote site id (loop suppression)
    type: str = "s3"               # "s3" (wire) | "layer" (in-process)
    prefix: str = ""               # only keys under this replicate
    bw_bps: int = 0                # per-target budget; 0 = knob default
    params: dict = dataclasses.field(default_factory=dict)

    def matches(self, key: str) -> bool:
        return key.startswith(self.prefix) if self.prefix else True

    def to_dict(self, redact: bool = False) -> dict:
        params = dict(self.params)
        if redact:
            for k in _SECRET_PARAMS:
                if params.get(k):
                    params[k] = "REDACTED"
        return {"arn": self.arn, "bucket": self.bucket,
                "dest_bucket": self.dest_bucket, "site": self.site,
                "type": self.type, "prefix": self.prefix,
                "bw_bps": self.bw_bps, "params": params}

    @classmethod
    def from_dict(cls, d: dict) -> "SiteTarget":
        arn = str(d.get("arn", "")).strip()
        bucket = str(d.get("bucket", "")).strip()
        if not arn or not bucket:
            raise ReplTargetError("target needs an arn and a bucket")
        return cls(arn=arn, bucket=bucket,
                   dest_bucket=str(d.get("dest_bucket") or bucket),
                   site=str(d.get("site", "")),
                   type=str(d.get("type", "s3")),
                   prefix=str(d.get("prefix", "")),
                   bw_bps=int(d.get("bw_bps", 0) or 0),
                   params=dict(d.get("params") or {}))


def new_arn(dest_bucket: str) -> str:
    return f"arn:minio:replication::{_uuid.uuid4().hex[:12]}:{dest_bucket}"


class TargetRegistry:
    """The live target map + client cache. Every mutation bumps
    ``epoch`` and persists BEFORE it takes effect (the TierManager
    discipline: a crash mid-add replays, never forgets a target a
    resync already references)."""

    def __init__(self, object_layer=None, site_id: str = ""):
        self.obj = object_layer
        self._mu = threading.Lock()
        self.epoch = 0
        self.updated = time.time()
        self.site_id = site_id or _uuid.uuid4().hex[:12]
        self.targets: dict[str, SiteTarget] = {}
        self._clients: dict[str, object] = {}
        # lineage fencing: every epoch commit chains a hash of
        # (parent lineage, epoch, writer) — see utils/regfence.py
        self.writer = ""
        self.parent_lineage = ""
        self.lineage = ""

    def _advance_lineage(self) -> None:
        """Chain the fencing hash for the epoch just committed (caller
        holds ``_mu``)."""
        self.parent_lineage = self.lineage
        self.writer = regfence.default_writer()
        self.lineage = regfence.lineage(self.parent_lineage,
                                        self.epoch, self.writer)

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def add(self, target: SiteTarget, client=None,
            update: bool = False) -> int:
        """Register (or with `update` replace) a target. A wire ("s3")
        target verifies its client constructs before the registry
        mutates; in-process ("layer") targets must inject `client`.
        Returns the new epoch."""
        if client is None:
            if target.type == "layer":
                raise ReplTargetError(
                    "'layer' targets need an injected client")
            from .client import new_repl_client
            try:
                client = new_repl_client(target)
            except (KeyError, ValueError) as e:
                raise ReplTargetError(f"bad target spec: {e}") from None
        with self._mu:
            if not update and target.arn in self.targets:
                raise ReplTargetError(
                    f"target {target.arn!r} already exists")
            prev = self.targets.get(target.arn)
            self.targets[target.arn] = target
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:              # roll back the in-memory map
                if prev is None:
                    self.targets.pop(target.arn, None)
                else:
                    self.targets[target.arn] = prev
            raise
        with self._mu:
            self._clients[target.arn] = client
        return epoch

    def remove(self, arn: str) -> int:
        with self._mu:
            if arn not in self.targets:
                raise ReplTargetError(f"unknown target {arn!r}")
            prev = self.targets.pop(arn)
            self._clients.pop(arn, None)
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:
                self.targets[arn] = prev
            raise
        return epoch

    def list(self, redact: bool = True) -> list[dict]:
        with self._mu:
            return [t.to_dict(redact=redact)
                    for t in sorted(self.targets.values(),
                                    key=lambda t: t.arn)]

    def get(self, arn: str) -> SiteTarget:
        with self._mu:
            t = self.targets.get(arn)
        if t is None:
            raise ReplTargetError(f"unknown target {arn!r}")
        return t

    def for_bucket(self, bucket: str) -> list[SiteTarget]:
        with self._mu:
            return [t for t in self.targets.values() if t.bucket == bucket]

    def buckets(self) -> set[str]:
        with self._mu:
            return {t.bucket for t in self.targets.values()}

    def client(self, arn: str):
        with self._mu:
            c = self._clients.get(arn)
            t = self.targets.get(arn)
        if c is not None:
            return c
        if t is None:
            raise ReplTargetError(f"unknown target {arn!r}")
        if t.type == "layer":
            raise ReplTargetError(
                f"target {arn!r} has no live client (re-inject with "
                "set_client after a restart)")
        from .client import new_repl_client
        c = new_repl_client(t)
        with self._mu:
            self._clients.setdefault(arn, c)
        return c

    def set_client(self, arn: str, client) -> None:
        """Swap the live client of a registered target (chaos tests
        wrap the real client in a NaughtyReplClient; in-process layer
        targets re-inject after a registry reload)."""
        self.get(arn)
        with self._mu:
            self._clients[arn] = client

    def mount_target_entry(self, entry: dict) -> str:
        """Back-compat: register a bucket-metadata remote-target dict
        (the legacy admin set-remote-target on-disk shape). Mounted as
        a one-way "push" target — the legacy entries point at GENERIC
        S3 endpoints with no peer wire surface; pairing two minio_tpu_torch
        sites uses the replicate/target admin verb (type "s3") instead.
        Returns the ARN. Already-known ARNs refresh in place."""
        target = SiteTarget(
            arn=entry.get("arn") or new_arn(entry.get("bucket", "")),
            bucket=entry.get("source_bucket") or entry.get("bucket", ""),
            dest_bucket=entry.get("bucket", ""),
            site=entry.get("site", ""),
            type="push",
            params={"host": entry.get("host", ""),
                    "port": int(entry.get("port", 9000)),
                    "access_key": entry.get("access_key", ""),
                    "secret_key": entry.get("secret_key", ""),
                    "region": entry.get("region", "us-east-1"),
                    "secure": bool(entry.get("secure", False))})
        self.add(target, update=True)
        return target.arn

    # ------------------------------------------------------------------
    # persistence (every pool, highest epoch wins)
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        with self._mu:
            return {"epoch": self.epoch, "updated": self.updated,
                    "site_id": self.site_id,
                    "targets": [t.to_dict()
                                for t in self.targets.values()],
                    "writer": self.writer,
                    "parent_lineage": self.parent_lineage,
                    "lineage": self.lineage}

    def _pools(self):
        if self.obj is None:
            return []
        return getattr(self.obj, "server_sets", None) or [self.obj]

    def save(self) -> int:
        """Write the registry to every pool; at least one copy must
        land or the mutation is rejected (caller rolls back)."""
        pools = self._pools()
        if not pools:
            return 0
        payload = json.dumps(self.to_dict()).encode()
        landed = 0
        last: Optional[Exception] = None
        for z in pools:
            try:
                # one hit per pool (arm :<nth>)
                crashpoint.hit("replicate.registry.save.pool")
                z.put_object(MINIO_META_BUCKET, TARGETS_OBJECT, payload)
                landed += 1
            except Exception as e:  # noqa: BLE001 — per-pool durability
                last = e
        need = regfence.write_quorum(len(pools))
        if landed < need:
            # refusing a minority-side epoch bump (caller rolls back)
            raise ReplTargetError(
                f"replication targets epoch {self.epoch} persisted to "
                f"{landed} of {len(pools)} pool(s), need {need}: "
                f"{last!r}")
        return landed

    def load(self) -> bool:
        """Recover the newest persisted registry (highest epoch across
        pools); returns True when a doc was found. Live clients reset —
        wire targets reconstruct lazily, layer targets need
        set_client."""
        docs: list[dict] = []
        for z in self._pools():
            try:
                _, stream = z.get_object(MINIO_META_BUCKET, TARGETS_OBJECT)
                doc = atomicfile.load_json_doc(b"".join(stream))
            except api_errors.ObjectApiError:
                continue
            if doc is None:     # torn/truncated copy: other pools win
                continue
            docs.append(doc)
        # deterministic winner; same-epoch/different-lineage copies are
        # a fork fsck surfaces — load never coin-flips between them
        best = regfence.pick_best(docs)
        if best is None:
            return False
        targets = {}
        for d in best.get("targets", []):
            try:
                t = SiteTarget.from_dict(d)
            except ReplTargetError:
                continue
            targets[t.arn] = t
        with self._mu:
            self.epoch = int(best.get("epoch", 0))
            self.updated = float(best.get("updated", time.time()))
            self.site_id = str(best.get("site_id", "")) or self.site_id
            self.targets = targets
            self.writer = str(best.get("writer", ""))
            self.parent_lineage = str(best.get("parent_lineage", ""))
            self.lineage = str(best.get("lineage", ""))
            self._clients.clear()
        return True
