"""Persisted tier registry: named remote tiers, epoch-versioned.

Counterpart of minio_tpu/tier/config.py. The registry is one JSON
document, ``.minio.sys/tier/config.json``, written to EVERY pool and
recovered highest-epoch-wins (the topology map's durability rule): any
surviving pool recovers the newest registry, and pools that missed an
update converge on the next save. The documents are byte-for-byte the
reference's, so a registry saved by either package loads in the other.

Departure: a registry holding a tier of a gateway type (s3, azure, gcs,
hdfs; tier/client.py) still loads whole, so that the next save keeps
those entries, but ``load`` then raises TierClientError naming the
gateway plane, which this port does not serve, and ``add`` refuses such
a tier. Left out with the admin router: the admin tier routes and the
in-use check of a tier's removal.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import uuid as _uuid
from typing import Optional

from ..object import api_errors
from ..storage.xl_storage import MINIO_META_BUCKET
from ..utils import atomicfile, crashpoint, regfence
from .client import (GATEWAY_TYPES, TierClient, TierClientError,
                     gateway_refusal, new_tier_client)

TIER_PREFIX = "tier/"
TIER_CONFIG_OBJECT = TIER_PREFIX + "config.json"

# params whose values never leave the server (a listing redacts them)
_SECRET_PARAMS = ("secret_key", "key_b64", "credentials_json")


class TierConfigError(api_errors.ObjectApiError):
    """Invalid tier operation (duplicate name, unknown name, bad spec)."""


@dataclasses.dataclass
class TierConfig:
    """One named remote tier: a type tag and the backend's params
    (fs: path)."""
    name: str
    type: str
    params: dict = dataclasses.field(default_factory=dict)

    def to_dict(self, redact: bool = False) -> dict:
        params = dict(self.params)
        if redact:
            for k in _SECRET_PARAMS:
                if params.get(k):
                    params[k] = "REDACTED"
        return {"name": self.name, "type": self.type, "params": params}

    @classmethod
    def from_dict(cls, d: dict) -> "TierConfig":
        name = str(d.get("name", "")).strip()
        type_ = str(d.get("type", "")).strip()
        if not name or not type_:
            raise TierConfigError("tier needs a name and a type")
        return cls(name=name, type=type_, params=dict(d.get("params") or {}))


class TierManager:
    """The live registry and its client cache. Thread-safe; every
    mutation bumps ``epoch`` and persists BEFORE it takes effect."""

    def __init__(self, object_layer=None):
        self.obj = object_layer
        self._mu = threading.Lock()
        self.epoch = 0
        self.updated = time.time()
        self.tiers: dict[str, TierConfig] = {}
        self._clients: dict[str, TierClient] = {}
        # lineage fencing: every epoch commit chains a hash of
        # (parent lineage, epoch, writer), utils/regfence.py
        self.writer = ""
        self.parent_lineage = ""
        self.lineage = ""

    def _advance_lineage(self) -> None:
        """Chain the fencing hash of the epoch just committed (caller
        holds ``_mu``)."""
        self.parent_lineage = self.lineage
        self.writer = regfence.default_writer()
        self.lineage = regfence.lineage(self.parent_lineage,
                                        self.epoch, self.writer)

    # -- registry CRUD -----------------------------------------------------

    def add(self, cfg: TierConfig, update: bool = False) -> int:
        """Register (with ``update``, replace) a tier once its client
        constructs. Returns the new epoch."""
        try:
            client = new_tier_client(cfg.type, cfg.params)
        except (TierClientError, KeyError, ValueError) as e:
            raise TierConfigError(f"bad tier spec: {e}") from None
        with self._mu:
            if not update and cfg.name in self.tiers:
                raise TierConfigError(f"tier {cfg.name!r} already exists")
            prev = self.tiers.get(cfg.name)
            self.tiers[cfg.name] = cfg
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:          # roll the in-memory registry back
                if prev is None:
                    self.tiers.pop(cfg.name, None)
                else:
                    self.tiers[cfg.name] = prev
            raise
        with self._mu:
            self._clients[cfg.name] = client
        return epoch

    def remove(self, name: str) -> int:
        with self._mu:
            if name not in self.tiers:
                raise api_errors.TierNotFound(name)
            prev = self.tiers.pop(name)
            self._clients.pop(name, None)
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:
                self.tiers[name] = prev
            raise
        return epoch

    def list(self, redact: bool = True) -> list[dict]:
        with self._mu:
            return [t.to_dict(redact=redact)
                    for t in sorted(self.tiers.values(),
                                    key=lambda t: t.name)]

    def get(self, name: str) -> TierConfig:
        with self._mu:
            cfg = self.tiers.get(name)
        if cfg is None:
            raise api_errors.TierNotFound(name)
        return cfg

    def client(self, name: str) -> TierClient:
        with self._mu:
            c = self._clients.get(name)
            cfg = self.tiers.get(name)
        if c is not None:
            return c
        if cfg is None:
            raise api_errors.TierNotFound(name)
        c = new_tier_client(cfg.type, cfg.params)
        with self._mu:
            self._clients.setdefault(name, c)
        return c

    def set_client(self, name: str, client: TierClient) -> None:
        """Swap the live client of a registered tier (fault tests wrap
        the real one in a NaughtyTierClient)."""
        self.get(name)
        with self._mu:
            self._clients[name] = client

    @staticmethod
    def remote_key(bucket: str, object_name: str, version_id: str) -> str:
        """The remote key of one transitioned version: unique per version
        (it must survive local renames and never collide on overwrite)."""
        vid = version_id or "null"
        return f"{bucket}/{object_name}/{vid}/{_uuid.uuid4().hex}"

    # -- persistence (every pool, highest epoch wins) ----------------------

    def to_dict(self) -> dict:
        with self._mu:
            return {"epoch": self.epoch, "updated": self.updated,
                    "tiers": [t.to_dict() for t in self.tiers.values()],
                    "writer": self.writer,
                    "parent_lineage": self.parent_lineage,
                    "lineage": self.lineage}

    def _pools(self):
        if self.obj is None:
            return []
        return getattr(self.obj, "server_sets", None) or [self.obj]

    def save(self) -> int:
        """Write the registry to every pool; fewer than the write quorum
        of copies rejects the mutation (the caller rolls back)."""
        pools = self._pools()
        if not pools:
            return 0
        payload = json.dumps(self.to_dict()).encode()
        landed = 0
        last: Optional[Exception] = None
        for z in pools:
            try:
                crashpoint.hit("tier.save.pool")
                z.put_object(MINIO_META_BUCKET, TIER_CONFIG_OBJECT,
                             payload)
                landed += 1
            except Exception as e:  # noqa: BLE001 — per-pool durability
                last = e
        need = min(regfence.WRITE_QUORUM, len(pools))
        if landed < need:
            raise TierConfigError(
                f"tier config epoch {self.epoch} persisted to {landed} "
                f"of {len(pools)} pool(s), need {need}: {last!r}")
        return landed

    def load(self) -> bool:
        """Recover the newest persisted registry (highest epoch across
        pools); True when a document was found. Raises TierClientError,
        after the registry is installed, when it names tiers of a
        gateway type."""
        docs: list[dict] = []
        for z in self._pools():
            try:
                _, stream = z.get_object(MINIO_META_BUCKET,
                                         TIER_CONFIG_OBJECT)
                doc = atomicfile.load_json_doc(b"".join(stream))
            except api_errors.ObjectApiError:
                continue
            if doc is None:     # a torn copy: other pools win
                continue
            docs.append(doc)
        best = regfence.pick_best(docs)
        if best is None:
            return False
        tiers = {}
        for d in best.get("tiers", []):
            try:
                cfg = TierConfig.from_dict(d)
            except TierConfigError:
                continue
            tiers[cfg.name] = cfg
        with self._mu:
            self.epoch = int(best.get("epoch", 0))
            self.updated = float(best.get("updated", time.time()))
            self.tiers = tiers
            self.writer = str(best.get("writer", ""))
            self.parent_lineage = str(best.get("parent_lineage", ""))
            self.lineage = str(best.get("lineage", ""))
            self._clients.clear()
        unserved = sorted(c.name for c in tiers.values()
                          if c.type in GATEWAY_TYPES)
        if unserved:
            e = gateway_refusal(tiers[unserved[0]].type)
            raise TierClientError(f"tier(s) {', '.join(unserved)}: {e}")
        return True
