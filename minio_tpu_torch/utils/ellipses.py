"""Ellipses expansion + erasure-set sizing for CLI drive/endpoint args.

The reference's `minio server /data/d{1...16}` syntax (pkg/ellipses +
cmd/endpoint-ellipses.go): every `{a...b}` range in an argument expands
multiplicatively, and the total drive count is divided into erasure sets
of 4..16 drives preferring the largest symmetric divisor
(possibleSetCountsWithSymmetry / commonSetDriveCount,
cmd/endpoint-ellipses.go:67-91).
"""

from __future__ import annotations

import re

_ELLIPSIS = re.compile(r"\{(\d+)\.\.\.(\d+)\}")

SET_SIZES = tuple(range(4, 17))  # valid set drive counts (4..16)


def has_ellipses(*args: str) -> bool:
    return any(_ELLIPSIS.search(a) for a in args)


def expand_arg(arg: str) -> list[str]:
    """Expand every {a...b} range in `arg` (cartesian, left-to-right).

    Numbers keep their zero-padding width ({01...04} -> 01 02 03 04).
    """
    m = _ELLIPSIS.search(arg)
    if not m:
        return [arg]
    lo, hi = m.group(1), m.group(2)
    start, end = int(lo), int(hi)
    if end < start:
        raise ValueError(f"bad ellipsis range in {arg!r}")
    width = len(lo) if lo.startswith("0") else 0
    out = []
    for v in range(start, end + 1):
        s = str(v).rjust(width, "0") if width else str(v)
        out.extend(expand_arg(arg[:m.start()] + s + arg[m.end():]))
    return out


def expand_args(args: list[str]) -> list[str]:
    out: list[str] = []
    for a in args:
        out.extend(expand_arg(a))
    return out


def greatest_set_size(total: int, node_counts: list[int] | None = None
                      ) -> int:
    """Pick the erasure-set drive count: the largest divisor of `total`
    in 4..16 that also keeps per-node symmetry when node drive counts are
    given (every node's drive count must divide evenly into sets — the
    reference's possibleSetCountsWithSymmetry intent).
    """
    candidates = [s for s in SET_SIZES if total % s == 0]
    if node_counts:
        n_nodes = len(node_counts)
        sym = []
        for s in candidates:
            # symmetric when each set's drives spread evenly over nodes
            # (s divisible by node count) or each node contributes whole
            # sets (node drive count divisible by s)
            if s % n_nodes == 0 or all(c % s == 0 for c in node_counts):
                sym.append(s)
        if sym:
            candidates = sym
    if not candidates:
        raise ValueError(
            f"drive count {total} is not divisible into erasure sets of "
            f"4..16 drives")
    return max(candidates)


def divide_into_sets(total: int, node_counts: list[int] | None = None
                     ) -> tuple[int, int]:
    """(set_count, set_drive_count) for `total` drives."""
    size = greatest_set_size(total, node_counts)
    return total // size, size
