"""Peer membership with boot-generation fencing.

Every process mints a *boot generation* — a number that changes on
every restart. Internode RPC carries the local (node id, generation)
both ways (request headers on the client side, response headers on the
server side), so each end positively detects when a peer it has talked
to before comes back as a NEW incarnation: restarted, or partitioned
away long enough to have been replaced.

Why it matters: per-peer state accumulated against the OLD incarnation
— healthtrack latency windows, transport offline markers, replication
target client caches — is evidence about a process that no longer
exists. Left in place it poisons the new incarnation (a restarted peer
inherits its predecessor's "slow" conviction, a returning lock holder
acts on leases its previous self owned). On a generation change the
tracker fires registered listeners that reset exactly that state; it
never carries stale judgments across an incarnation boundary.

The reference encodes the same idea as the deployment ID + node uptime
checks in cmd/bootstrap-peer-server.go; here the generation is explicit
and fencing is an event, not a side effect of a failed handshake.

A copy of minio_tpu/distributed/membership.py; a generation change emits
the ``membership.generation`` journal record. Left out: the tests' reset.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils import eventlog, telemetry

# request/response header names carrying (node id, generation)
NODE_HEADER = "x-ntpu-node"
GEN_HEADER = "x-ntpu-gen"

_GEN_CHANGES = telemetry.REGISTRY.counter(
    "minio_tpu_peer_generation_changes_total",
    "Peer incarnation changes detected (restart or partition-and-"
    "replace) — each one resets that peer's stale local state")
_GEN_PEERS = telemetry.REGISTRY.gauge(
    "minio_tpu_peer_generation_peers",
    "Peers whose boot generation this node currently tracks")


def mint_generation() -> int:
    """Unique-per-boot integer: wall-clock millis with random low bits
    so two restarts inside the same millisecond still differ.
    Ordering between generations is not relied on — only inequality."""
    return (int(time.time() * 1000) << 12) | (
        int.from_bytes(os.urandom(2), "big") & 0xFFF)


class _PeerGen:
    __slots__ = ("generation", "node_id", "changes", "since")

    def __init__(self, generation: int, node_id: str):
        self.generation = generation
        self.node_id = node_id
        self.changes = 0
        self.since = time.time()


class MembershipTracker:
    """Process-global (peer addr -> boot generation) table.

    `observe` is fed by the transport on every exchange that carried
    identity headers; a changed generation fires every registered
    listener with (peer, old_gen, new_gen) OUTSIDE the lock."""

    def __init__(self):
        self._mu = threading.Lock()
        self.local_generation = mint_generation()
        self._local_node = ""
        self._peers: Dict[str, _PeerGen] = {}
        self._listeners: List[Callable[[str, int, int], None]] = []

    # -- local identity ----------------------------------------------------

    def set_local_node(self, addr: str) -> None:
        with self._mu:
            self._local_node = addr

    def local_node(self) -> str:
        with self._mu:
            return self._local_node

    # -- peer observations -------------------------------------------------

    def observe(self, peer: str, generation: int,
                node_id: str = "") -> bool:
        """Record the peer's advertised generation; True (and listener
        fan-out) when this is a NEW incarnation of a known peer. The
        first observation of a peer is not a change — there is no stale
        state to reset."""
        if not peer or not generation:
            return False
        with self._mu:
            cur = self._peers.get(peer)
            if cur is None:
                self._peers[peer] = _PeerGen(generation, node_id)
                _GEN_PEERS.set(len(self._peers))
                return False
            if cur.generation == generation:
                return False
            old = cur.generation
            cur.generation = generation
            cur.node_id = node_id or cur.node_id
            cur.changes += 1
            cur.since = time.time()
            listeners = list(self._listeners)
        _GEN_CHANGES.inc()
        eventlog.emit("membership.generation", peer=peer,
                      generation=generation)
        for fn in listeners:
            try:
                fn(peer, old, generation)
            except Exception:  # noqa: BLE001 — one listener must not
                pass           # block the fencing fan-out to the rest
        return True

    def generation_of(self, peer: str) -> Optional[int]:
        with self._mu:
            g = self._peers.get(peer)
            return g.generation if g is not None else None

    def snapshot(self) -> dict:
        """Membership table (the incident recorder's provider)."""
        with self._mu:
            return {
                "local_node": self._local_node,
                "local_generation": self.local_generation,
                "peers": {
                    addr: {"generation": g.generation,
                           "node_id": g.node_id,
                           "changes": g.changes,
                           "since": g.since}
                    for addr, g in self._peers.items()},
            }

    def add_listener(self, fn: Callable[[str, int, int], None]) -> None:
        """fn(peer_addr, old_generation, new_generation) — called on
        every detected incarnation change; must be fast and must not
        raise (exceptions are swallowed)."""
        with self._mu:
            self._listeners.append(fn)


TRACKER = MembershipTracker()


def set_local_node(addr: str) -> None:
    TRACKER.set_local_node(addr)


def local_node() -> str:
    return TRACKER.local_node()


def local_generation() -> int:
    return TRACKER.local_generation
