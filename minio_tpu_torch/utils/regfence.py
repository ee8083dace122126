"""Lineage fencing for the epoch-versioned registries.

Counterpart of minio_tpu/utils/regfence.py. The topology and tier
registries persist one JSON doc to EVERY pool and load "highest epoch
wins"; fencing makes the commit history a hash chain instead of a bare
counter. Every epoch commit records its ``writer`` (the committing node),
its ``parent_lineage`` and its ``lineage`` = sha256(parent_lineage ":"
epoch ":" writer), so two documents claiming the same epoch with
different lineage can only come from divergent histories: a fork, which
``find_forks`` reports and fsck repairs (``registry_epoch_fork``). Load
picks the deterministic winner (highest (epoch, writer, lineage)).

Writes are quorum-gated: ``write_quorum(n_pools)`` reads
``MINIO_TPU_REGISTRY_WRITE_QUORUM`` (a count, or ``majority``); a save
that lands on fewer pools refuses. The default ("1") is the reference's.

Single node: the port has no distributed plane, so the writer is always
the local placeholder the reference uses outside a cluster. Left out: the
fork finder's event-log record (the incident plane is not ported).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

from . import knobs


def lineage(parent: str, epoch: int, writer: str) -> str:
    """Lineage hash of an epoch commit: chains the parent's lineage so
    equal epochs from divergent histories can never collide."""
    return hashlib.sha256(
        f"{parent}:{epoch}:{writer}".encode()).hexdigest()[:16]


def default_writer() -> str:
    """The committing node's identity: the reference's cluster address of
    a booted node, else "local"; a single-node store is always "local"."""
    return "local"


def stamp(doc: dict, epoch: int, writer: str, parent: str) -> dict:
    """Attach the fencing fields to a registry doc in place."""
    doc["writer"] = writer
    doc["parent_lineage"] = parent
    doc["lineage"] = lineage(parent, epoch, writer)
    return doc


def _rank(doc: dict) -> Tuple[int, str, str]:
    return (int(doc.get("epoch", 0)), str(doc.get("writer", "")),
            str(doc.get("lineage", "")))


def pick_best(docs: List[dict]) -> Optional[dict]:
    """Deterministic winner across pool copies: highest
    (epoch, writer, lineage). Identical on every node, fork or not: the
    fork is reported (``find_forks``, fsck), never merged."""
    best = None
    for d in docs:
        if isinstance(d, dict) and (best is None
                                    or _rank(d) > _rank(best)):
            best = d
    return best


def find_forks(docs: List[dict]) -> List[Tuple[dict, dict]]:
    """Pairs of documents claiming the SAME epoch with DIFFERENT
    lineage — divergent histories. Docs predating the fencing fields
    (no lineage) cannot be distinguished and are not flagged."""
    out: List[Tuple[dict, dict]] = []
    by_epoch: dict = {}
    for d in docs:
        if not isinstance(d, dict) or not d.get("lineage"):
            continue
        e = int(d.get("epoch", 0))
        seen = by_epoch.setdefault(e, {})
        lin = str(d["lineage"])
        if lin in seen:
            continue
        for other in seen.values():
            out.append((other, d))
        seen[lin] = d
    return out


def write_quorum(n_pools: int) -> int:
    """Pools a registry write must land on before the epoch bump is
    acked. `MINIO_TPU_REGISTRY_WRITE_QUORUM`: a count (clamped to
    [1, n_pools]) or `majority` (n//2 + 1)."""
    raw = knobs.get_str("MINIO_TPU_REGISTRY_WRITE_QUORUM").strip()
    if raw.lower() == "majority":
        return n_pools // 2 + 1
    try:
        want = int(raw)
    except ValueError:
        want = 1
    return max(1, min(want, n_pools))


def check_write_quorum(landed: int, n_pools: int, what: str) -> None:
    """Refuse a minority-side registry commit: raises ValueError when
    fewer than the configured quorum of pools took the write. Callers
    roll the in-memory epoch bump back on the way out."""
    need = write_quorum(n_pools)
    if landed < need:
        raise ValueError(
            f"{what}: write quorum not met — doc landed on {landed} of "
            f"{n_pools} pool(s), need {need}; refusing a minority-side "
            "epoch bump (MINIO_TPU_REGISTRY_WRITE_QUORUM)")
