"""Lineage fencing for the epoch-versioned topology registry.

Counterpart of minio_tpu/utils/regfence.py. The topology map persists one
JSON doc to EVERY pool and loads "highest epoch wins"; fencing makes the
commit history a hash chain instead of a bare counter. Every epoch commit
records its ``writer`` (the committing node), its ``parent_lineage`` and
its ``lineage`` = sha256(parent_lineage ":" epoch ":" writer), so two
documents claiming the same epoch with different lineage can only come
from divergent histories. Load picks the deterministic winner (highest
(epoch, writer, lineage)).

Single node: the port has no distributed plane, so the writer is always
the local placeholder the reference uses outside a cluster, and a
registry write is acked once it lands on one pool (the reference's
default ``MINIO_TPU_REGISTRY_WRITE_QUORUM``). Left out: that knob and its
``majority`` form, the fork finder and its journal event (fsck is not
ported).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple


def lineage(parent: str, epoch: int, writer: str) -> str:
    """Lineage hash of an epoch commit: chains the parent's lineage so
    equal epochs from divergent histories can never collide."""
    return hashlib.sha256(
        f"{parent}:{epoch}:{writer}".encode()).hexdigest()[:16]


def default_writer() -> str:
    """The committing node's identity: the reference's cluster address of
    a booted node, else "local"; a single-node store is always "local"."""
    return "local"


def _rank(doc: dict) -> Tuple[int, str, str]:
    return (int(doc.get("epoch", 0)), str(doc.get("writer", "")),
            str(doc.get("lineage", "")))


def pick_best(docs: List[dict]) -> Optional[dict]:
    """Deterministic winner across pool copies: highest
    (epoch, writer, lineage)."""
    best = None
    for d in docs:
        if isinstance(d, dict) and (best is None
                                    or _rank(d) > _rank(best)):
            best = d
    return best


# pools a registry write must land on before the epoch bump is acked:
# one, the reference's default
WRITE_QUORUM = 1
