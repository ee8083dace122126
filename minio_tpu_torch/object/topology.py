"""Topology plane: versioned pool placement map ("placement epochs").

Counterpart of minio_tpu/object/topology.py.

Upstream MinIO freezes the pool list at boot; decommission
(cmd/erasure-server-pool-decom.go) bolts a persisted "pool is
draining" state onto it so the router can exclude a pool from new
writes while a background walker moves its data off. CRUSH-style
systems (Ceph) solve the same problem with placement *epochs*: every
topology change bumps a monotonically increasing version, the change
is durable before it takes effect, and data migration happens in the
background against the previous epoch's placement.

This module is that state machine for :class:`ErasureServerSets`:

  * every pool ("zone"/"server set") carries one of three states —

      ``active``     reads + new writes
      ``draining``   reads only; a rebalancer is moving its data off
      ``suspended``  reads only; writes excluded (maintenance), no drain

  * the whole map is one JSON document with an ``epoch`` counter,
    persisted in the hidden config bucket (``.minio.sys``) of EVERY
    pool — any subset of pools that survives a restart can recover the
    newest map (highest epoch wins, the same dual-read rule the data
    path uses mid-migration);

  * transitions go through :meth:`TopologyMap.set_state`, which bumps
    the epoch; callers persist via :class:`TopologyStore` BEFORE acting
    on the new map, so a crash mid-transition replays, never forgets.

The data-path consequences (write routing excludes non-active pools,
reads scan every pool newest-wins) live in ``server_sets.py``. The
background migration (the reference's ``rebalance.py``) is not ported.
"""

from __future__ import annotations

import json
import threading
import time
from typing import TYPE_CHECKING, Optional

from ..storage.xl_storage import MINIO_META_BUCKET
from ..utils import atomicfile, crashpoint, regfence
from . import api_errors

if TYPE_CHECKING:  # pragma: no cover — typing only
    from .server_sets import ErasureServerSets

POOL_ACTIVE = "active"
POOL_DRAINING = "draining"
POOL_SUSPENDED = "suspended"
POOL_STATES = (POOL_ACTIVE, POOL_DRAINING, POOL_SUSPENDED)

# the persisted map + per-pool rebalance checkpoints live under this
# prefix of the hidden config bucket; the rebalancer must never migrate
# them (they are deliberately written to every pool)
TOPOLOGY_PREFIX = "topology/"
TOPOLOGY_OBJECT = TOPOLOGY_PREFIX + "pools.json"


class TopologyError(api_errors.ObjectApiError):
    """Invalid topology transition (unknown pool, last active pool)."""


class TopologyMap:
    """The versioned pool-state map. Thread-safe; every mutation bumps
    ``epoch`` so observers (and the persisted doc) can order maps."""

    def __init__(self, n_pools: int, epoch: int = 0,
                 states: Optional[list[str]] = None):
        self._mu = threading.Lock()
        self.epoch = epoch
        if states is None:
            states = [POOL_ACTIVE] * n_pools
        # reopened with a different pool count than the persisted doc:
        # extra live pools default to active (expansion), surplus doc
        # entries drop (pool physically removed after its drain)
        states = list(states[:n_pools])
        states += [POOL_ACTIVE] * (n_pools - len(states))
        self.states = states
        self.updated = time.time()
        # lineage fencing (split-brain detection): every epoch commit
        # chains a hash of (parent lineage, epoch, writer) — equal
        # epochs from divergent histories are a detectable fork
        self.writer = ""
        self.parent_lineage = ""
        self.lineage = ""

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.states)

    def state(self, idx: int) -> str:
        with self._mu:
            if idx < 0 or idx >= len(self.states):
                raise TopologyError(f"no pool {idx}")
            return self.states[idx]

    def can_write(self, idx: int) -> bool:
        with self._mu:
            return self.states[idx] == POOL_ACTIVE

    def write_pools(self) -> list[int]:
        """Pool indices eligible for NEW writes."""
        with self._mu:
            return [i for i, s in enumerate(self.states)
                    if s == POOL_ACTIVE]

    def draining_pools(self) -> list[int]:
        with self._mu:
            return [i for i, s in enumerate(self.states)
                    if s == POOL_DRAINING]

    # -- transitions -------------------------------------------------------

    def set_state(self, idx: int, state: str) -> int:
        """Transition pool `idx`; returns the new epoch. Refuses to
        demote the LAST active pool — a cluster with no write target
        would fail every PUT with no way back through the data path."""
        if state not in POOL_STATES:
            raise TopologyError(f"unknown pool state {state!r}")
        with self._mu:
            if idx < 0 or idx >= len(self.states):
                raise TopologyError(f"no pool {idx}")
            if state != POOL_ACTIVE and \
                    all(s != POOL_ACTIVE or i == idx
                        for i, s in enumerate(self.states)):
                raise TopologyError(
                    f"pool {idx} is the last active pool; "
                    "add capacity before draining it")
            if self.states[idx] == state:
                return self.epoch
            self.states[idx] = state
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            return self.epoch

    def add_pool(self, state: str = POOL_ACTIVE) -> int:
        """Register one appended pool (online expansion); returns the
        new epoch."""
        with self._mu:
            self.states.append(state)
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            return self.epoch

    def _advance_lineage(self) -> None:
        """Chain the fencing hash for the epoch just committed (caller
        holds ``_mu``)."""
        self.parent_lineage = self.lineage
        self.writer = regfence.default_writer()
        self.lineage = regfence.lineage(self.parent_lineage,
                                        self.epoch, self.writer)

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict:
        with self._mu:
            return {"epoch": self.epoch, "pools": list(self.states),
                    "updated": self.updated, "writer": self.writer,
                    "parent_lineage": self.parent_lineage,
                    "lineage": self.lineage}

    @classmethod
    def from_dict(cls, doc: dict, n_pools: int) -> "TopologyMap":
        states = [s if s in POOL_STATES else POOL_ACTIVE
                  for s in doc.get("pools", [])]
        tm = cls(n_pools, epoch=int(doc.get("epoch", 0)), states=states)
        tm.updated = float(doc.get("updated", time.time()))
        tm.writer = str(doc.get("writer", ""))
        tm.parent_lineage = str(doc.get("parent_lineage", ""))
        tm.lineage = str(doc.get("lineage", ""))
        return tm


class TopologyStore:
    """Durability for the map: one JSON object in the hidden config
    bucket of every pool.

    * ``save`` writes the doc to EVERY pool (each write is itself
      erasure-coded at write quorum inside that pool) — at least one
      copy must land or the transition is rejected;
    * ``load`` reads from every pool and keeps the highest epoch —
      pools that missed an update (offline during the transition)
      converge on the next save.
    """

    @staticmethod
    def save(server_sets: "ErasureServerSets", tmap: TopologyMap) -> int:
        payload = json.dumps(tmap.to_dict()).encode()
        landed = 0
        last: Optional[Exception] = None
        for z in server_sets.server_sets:
            try:
                # one hit per pool (arm :<nth>): pools left disagreeing
                # on the epoch must converge on load (highest wins)
                crashpoint.hit("topology.save.pool")
                z.put_object(MINIO_META_BUCKET, TOPOLOGY_OBJECT, payload)
                landed += 1
            except Exception as e:  # noqa: BLE001 — per-pool durability
                last = e
        need = regfence.WRITE_QUORUM
        if landed < need:
            # refusing a minority-side epoch bump: a partitioned node
            # must not commit a registry version most pools never saw
            raise TopologyError(
                f"topology epoch {tmap.epoch} persisted to {landed} of "
                f"{len(server_sets.server_sets)} pool(s), need {need}: "
                f"{last!r}")
        return landed

    @staticmethod
    def load(server_sets: "ErasureServerSets") -> Optional[TopologyMap]:
        docs: list[dict] = []
        for z in server_sets.server_sets:
            try:
                _, stream = z.get_object(MINIO_META_BUCKET,
                                         TOPOLOGY_OBJECT)
                doc = atomicfile.load_json_doc(b"".join(stream))
            except api_errors.ObjectApiError:
                continue
            if doc is None:     # torn/truncated copy: other pools win
                continue
            docs.append(doc)
        # deterministic winner across pool copies; same-epoch docs with
        # different lineage are a FORK — fsck surfaces + repairs it,
        # load never coin-flips (pick_best ranks identically everywhere)
        best = regfence.pick_best(docs)
        if best is None:
            return None
        return TopologyMap.from_dict(best, len(server_sets.server_sets))
