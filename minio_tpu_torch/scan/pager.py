"""Page former: tokenized records -> fixed-shape typed column pages.

The host-side half of the scan plane: the decoded object's records
(the SAME row dicts the CPU evaluator iterates — produced by
``s3select.select._rows_csv`` / ``_rows_json``) are tokenized into
padded, fixed-shape buffers the kernels consume:

  per referenced column slot, per row:
    num    f8   the cell's float value (CPU ``_num`` semantics)
    ok     bool the cell parses as a number
    null   bool the cell is missing / JSON null
    sbytes u8[W] the cell's ``str(value)`` form, UTF-8, zero-padded
    slen   i4   real byte length of sbytes

Pages are (page_rows, ...) blocks padded to a fixed row count and a
fixed string width (rounded up through _WIDTHS) so concurrent requests
with the same plan signature and page shape land in the same scheduler
bucket and coalesce into one device launch.

Data the kernels cannot type exactly — nested JSON values, booleans,
strings wider than the cap or containing NUL (zero is the pad byte and
the lexicographic sentinel) — raises :class:`~.plan.Decline`; the
request falls back to the CPU evaluator mid-flight with identical
output, because nothing has been emitted yet.

A copy of minio_tpu/scan/pager.py. The arrays stay numpy on the host: the
scan verb packs each page into one byte row for a single copy onto the
card (ops/scan_cuda.pack_pages).
"""

from __future__ import annotations


import numpy as np

from ..utils import knobs
from .plan import Decline, ScanPlan

#: rows per page (fixed shape -> coalescable pages)
PAGE_ROWS = max(64, knobs.get_int("MINIO_TPU_SCAN_PAGE_ROWS"))
#: string width buckets; cells wider than the last decline
_WIDTHS = (8, 16, 32, 64,
           max(64, knobs.get_int("MINIO_TPU_SCAN_MAX_STR")))


def resolve_cell(row: dict, name: str):
    """Mirror of ``sql.evaluate``'s Col lookup: exact key, then
    case-insensitive, then positional ``_N``; missing -> None."""
    if name in row:
        return row[name]
    low = name.lower()
    for k, v in row.items():
        if k.lower() == low:
            return v
    if low.startswith("_") and low[1:].isdigit():
        idx = int(low[1:]) - 1
        vals = list(row.values())
        return vals[idx] if 0 <= idx < len(vals) else None
    return None


def _num_of(v):
    """CPU ``sql._num`` verbatim (bool is NOT numeric there)."""
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class Pages:
    """One request's typed pages, ready for the batch former."""

    __slots__ = ("plan", "n_rows", "n_pages", "width", "arrays")

    def __init__(self, plan: ScanPlan, n_rows: int, n_pages: int,
                 width: int, arrays: dict):
        self.plan = plan
        self.n_rows = n_rows          # real (unpadded) rows
        self.n_pages = n_pages
        self.width = width
        # arrays: num f8[B,R,C]  ok/null bool[B,R,C]  sb u8[B,R,C,W]
        #         slen i4[B,R,C]  rowvalid bool[B,R]
        self.arrays = arrays

    def shape_key(self) -> tuple:
        """Everything shape-relevant for the scheduler bucket (the
        page count B varies per request and is NOT part of the key —
        pages from different requests stack along B)."""
        return (PAGE_ROWS, max(1, len(self.plan.columns)), self.width)


def build_pages(rows: list, plan: ScanPlan) -> Pages:
    """Tokenize `rows` into fixed-shape pages for `plan`. Raises
    Decline when any referenced cell can't be typed exactly."""
    R = PAGE_ROWS
    n = len(rows)
    B = max(1, -(-n // R))
    C = max(1, len(plan.columns))

    # first pass: resolve + type every referenced cell, find the width
    cells = []                    # (null, ok, num, sbytes) per row/col
    max_w = 1
    for row in rows:
        rcells = []
        for name in plan.columns:
            v = resolve_cell(row, name)
            if v is None:
                rcells.append((True, False, 0.0, b""))
                continue
            if isinstance(v, bool) or isinstance(v, (dict, list)):
                raise Decline("nested" if isinstance(v, (dict, list))
                              else "cell-type")
            nv = _num_of(v)
            sb = str(v).encode("utf-8")
            if b"\x00" in sb:
                raise Decline("cell-nul")
            if b"\n" in sb and len(rcells) in plan.like_cols:
                # the CPU LIKE is a ^..$-anchored re.match: '.' stops
                # at a newline and '$' matches before a trailing one —
                # the kernel's byte compares reproduce neither
                raise Decline("like-newline")
            if len(sb) > max_w:
                max_w = len(sb)
            rcells.append((False, nv is not None,
                           nv if nv is not None else 0.0, sb))
        cells.append(rcells)

    width = next((w for w in _WIDTHS if w >= max_w), None)
    if width is None:
        raise Decline("wide-string")

    # arithmetic comparisons are numeric-only on device: every cell of
    # a column they touch must be numeric or null, else the CPU would
    # take the string-compare path the kernel doesn't implement
    for j in plan.arith_cols:
        for rcells in cells:
            null, ok, _nv, _sb = rcells[j]
            if not (null or ok):
                raise Decline("mixed-arith")

    num = np.zeros((B, R, C), np.float64)
    ok = np.zeros((B, R, C), bool)
    null = np.ones((B, R, C), bool)      # pad rows read as null
    sb = np.zeros((B, R, C, width), np.uint8)
    slen = np.zeros((B, R, C), np.int32)
    rowvalid = np.zeros((B, R), bool)
    for i, rcells in enumerate(cells):
        b, r = divmod(i, R)
        rowvalid[b, r] = True
        for j, (cnull, cok, cnum, csb) in enumerate(rcells):
            null[b, r, j] = cnull
            ok[b, r, j] = cok
            num[b, r, j] = cnum
            if csb:
                sb[b, r, j, :len(csb)] = np.frombuffer(csb, np.uint8)
                slen[b, r, j] = len(csb)
    return Pages(plan, n, B, width,
                 {"num": num, "ok": ok, "null": null, "sb": sb,
                  "slen": slen, "rowvalid": rowvalid})
