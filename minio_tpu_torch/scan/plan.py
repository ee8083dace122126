"""Scan-plan compiler: SQL AST -> a device-executable predicate program.

Compiles the WHERE tree of a parsed :class:`~..s3select.sql.Query` into
a small typed program that ops/scan_program.py flattens into the postfix
code of the card's predicate interpreter (csrc/scan_eval.cu), with

  * column references resolved to page SLOTS (the pager materializes
    one typed column buffer per slot),
  * literals baked into the program as constants — a numeric literal
    needs its STRING form too (the evaluator string-compares it
    against non-numeric cells), so literal values are part of the
    bucket signature: concurrent IDENTICAL queries coalesce into one
    device launch, differing literals flatten into separate programs.

Anything outside the supported subset raises :class:`Decline` with a
stable reason label; the caller falls back to the CPU evaluator, which
is also the byte-identity oracle. The compiler is deliberately
conservative: a construct is supported only when the kernel can
reproduce the CPU evaluator's semantics EXACTLY (the per-row
numeric-else-string coercion of ``sql._coerce_pair`` included).

Supported predicate grammar:
    cmp        := side (=|!=|<>|<|<=|>|>=) side
    side       := column | literal | arithmetic over columns/literals
    membership := column/literal [NOT] IN (literals)
                | column/literal [NOT] BETWEEN literal AND literal
    null test  := column IS [NOT] NULL
    pattern    := column [NOT] LIKE 'lit' | 'lit%' | '%lit' | '%lit%'
    boolean    := AND / OR / NOT over the above

Aggregates: COUNT(*) and COUNT(column) map to mask reductions; every
other aggregate declines (reason ``aggregate``).

A copy of minio_tpu/scan/plan.py.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from ..s3select import sql as _sql

#: comparison operators in CPU-evaluator semantics
_CMP_OPS = ("=", "!=", "<>", "<", "<=", ">", ">=")
_ARITH_OPS = ("+", "-", "*", "/", "%")


class Decline(Exception):
    """The plan (or a page of data) cannot ride the device path; the
    caller must fall back to the CPU evaluator. ``reason`` is a stable
    low-cardinality label for minio_tpu_scan_fallbacks_total."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


# -- program nodes ----------------------------------------------------------
# Plain tuples keep the program trivially serializable for the bucket
# signature: ("and", a, b) / ("or", a, b) / ("not", x)
# ("cmp", op, side_a, side_b)
# ("in", side, (literal_side, ...), negate)
# ("between", side, lo_side, hi_side, negate)
# ("isnull", slot, negate)
# ("like", slot, kind, needle_bytes, negate)  kind: exact|prefix|suffix|
#                                             contains|any
# sides: ("col", slot) | ("nlit", float_value, str_form_bytes)
#        | ("slit", bytes) | ("arith", op, side, side)
# ("true",) — no WHERE clause: every (real) row passes.


class ScanPlan:
    """Compiled device plan for one query shape."""

    def __init__(self):
        self.columns: list[str] = []     # referenced column names (slots)
        self.prog: tuple = ("true",)
        # columns referenced by a comparison that has an arithmetic
        # side: every cell of these must be numeric-or-null, or the
        # page former declines (CPU would string-compare the formatted
        # arithmetic result — not worth reproducing on device)
        self.arith_cols: set[int] = set()
        # columns referenced by any LIKE: the page former declines
        # their cells containing '\n' — the CPU pattern is a
        # ^..$-anchored re.match where '.' stops at a newline and '$'
        # matches before a trailing one, neither of which the kernel's
        # byte compares reproduce
        self.like_cols: set[int] = set()
        # aggregate surface: None = row query; else a list mirroring
        # q.projections where each entry is "star" (COUNT(*)),
        # a slot index (COUNT(col)) or None (non-aggregate projection,
        # which the CPU Aggregator reports as None)
        self.counts: Optional[list] = None
        self.signature: str = ""

    def slot(self, name: str) -> int:
        try:
            return self.columns.index(name)
        except ValueError:
            self.columns.append(name)
            return len(self.columns) - 1

    def seal(self) -> "ScanPlan":
        """Freeze the bucket signature: everything trace-relevant —
        program shape, literal constants, column count, aggregate
        layout."""
        def enc(o):
            if isinstance(o, bytes):
                return ["b", o.hex()]
            if isinstance(o, tuple):
                return [enc(x) for x in o]
            return o
        blob = json.dumps({
            "prog": enc(self.prog), "ncols": len(self.columns),
            "arith": sorted(self.arith_cols),
            "counts": [c if c is None else str(c)
                       for c in (self.counts or [])] or None,
        }, separators=(",", ":"))
        self.signature = hashlib.sha1(blob.encode()).hexdigest()[:16]
        return self


# -- LIKE pattern recovery --------------------------------------------------

def _like_shape(pat) -> tuple[str, bytes]:
    """Recover (kind, needle) from the parser's compiled LIKE regex
    (sql._like_regex builds '^' + parts + '$' where '%' -> '.*',
    '_' -> '.', other chars re.escape'd). Declines '_' wildcards and
    '%' anywhere but the ends."""
    src = pat.pattern
    if not (src.startswith("^") and src.endswith("$")):
        raise Decline("like-pattern")
    body = src[1:-1]
    toks: list[str] = []         # "%" or one literal char
    i = 0
    while i < len(body):
        c = body[i]
        if body.startswith(".*", i):
            toks.append("%")
            i += 2
        elif c == ".":
            raise Decline("like-pattern")        # '_' wildcard
        elif c == "\\" and i + 1 < len(body):
            toks.append(body[i + 1])
            i += 2
        else:
            toks.append(c)
            i += 1
    lead = bool(toks) and toks[0] == "%"
    trail = len(toks) > (1 if lead else 0) and toks[-1] == "%"
    mid = toks[1 if lead else 0:len(toks) - (1 if trail else 0)]
    if "%" in mid:
        raise Decline("like-pattern")            # inner wildcard
    needle = "".join(mid).encode("utf-8")
    if b"\x00" in needle:
        raise Decline("like-pattern")
    if not needle:
        if not toks:
            # LIKE '' is regex ^$: only the empty cell matches —
            # mapping it to "any" matched every non-null row
            return "exact", b""
        return "any", b""                        # '%', '%%'
    if lead and trail:
        return "contains", needle
    if lead:
        return "suffix", needle
    if trail:
        return "prefix", needle
    return "exact", needle


# -- compilation ------------------------------------------------------------

def _compile_side(plan: ScanPlan, node, alias: str,
                  cols_touched: set[int]) -> tuple:
    """A comparison side: column, literal, or arithmetic over both."""
    if isinstance(node, _sql.Col):
        name = node.name
        if name.lower() == alias:
            raise Decline("row-ref")     # whole-row reference
        slot = plan.slot(name)
        cols_touched.add(slot)
        return ("col", slot)
    if isinstance(node, _sql.Lit):
        v = node.v
        if isinstance(v, bool) or v is None:
            # CPU compares via str(True)/None-propagation corner
            # cases; not worth reproducing for a construct this rare
            raise Decline("literal-type")
        if isinstance(v, (int, float)):
            # the string form is what the evaluator compares against
            # non-numeric cells (str(5) = "5", str(5.5) = "5.5")
            return ("nlit", float(v), str(v).encode("utf-8"))
        if isinstance(v, str):
            b = v.encode("utf-8")
            if b"\x00" in b:
                raise Decline("literal-type")
            return ("slit", b)
        raise Decline("literal-type")
    if isinstance(node, _sql.Unary) and node.op == "neg":
        v = node.x.v if isinstance(node.x, _sql.Lit) else None
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            # constant-fold a negated numeric literal: the evaluator's
            # neg returns -float(v), whose str() form is what a mixed
            # compare sees — folding keeps '-1' usable as an IN item
            # or BETWEEN bound instead of declining as arithmetic
            nv = -float(v)
            return ("nlit", nv, str(nv).encode("utf-8"))
        inner = _compile_side(plan, node.x, alias, cols_touched)
        # -x == 0 - x under the evaluator's float arithmetic
        return ("arith", "-", ("nlit", 0.0, b"0"), inner)
    if isinstance(node, _sql.Bin) and node.op in _ARITH_OPS:
        a = _compile_side(plan, node.a, alias, cols_touched)
        b = _compile_side(plan, node.b, alias, cols_touched)
        return ("arith", node.op, a, b)
    raise Decline("term")


def _has_arith(side: tuple) -> bool:
    return side[0] == "arith"


def _compile_bool(plan: ScanPlan, node, alias: str) -> tuple:
    """A boolean predicate node. Only nodes whose CPU evaluation is a
    real bool are supported (bare columns/literals would go through
    ``_truthy`` on arbitrary values — decline)."""
    if isinstance(node, _sql.Bin) and node.op in ("and", "or"):
        return (node.op, _compile_bool(plan, node.a, alias),
                _compile_bool(plan, node.b, alias))
    if isinstance(node, _sql.Unary) and node.op == "not":
        return ("not", _compile_bool(plan, node.x, alias))
    if isinstance(node, _sql.Bin) and node.op in _CMP_OPS:
        touched: set[int] = set()
        a = _compile_side(plan, node.a, alias, touched)
        b = _compile_side(plan, node.b, alias, touched)
        if _has_arith(a) or _has_arith(b):
            if a[0] == "slit" or b[0] == "slit":
                # CPU string-compares the FORMATTED arithmetic result
                # against the literal — not reproduced on device
                raise Decline("term")
            plan.arith_cols |= touched
        return ("cmp", node.op, a, b)
    if isinstance(node, _sql.In):
        touched: set[int] = set()
        x = _compile_side(plan, node.x, alias, touched)
        if _has_arith(x):
            raise Decline("term")
        items = []
        for item in node.items:
            s = _compile_side(plan, item, alias, touched)
            if s[0] not in ("nlit", "slit"):
                raise Decline("term")    # IN over columns: decline
            items.append(s)
        return ("in", x, tuple(items), bool(node.negate))
    if isinstance(node, _sql.Between):
        touched: set[int] = set()
        x = _compile_side(plan, node.x, alias, touched)
        lo = _compile_side(plan, node.lo, alias, touched)
        hi = _compile_side(plan, node.hi, alias, touched)
        if _has_arith(x) or lo[0] not in ("nlit", "slit") \
                or hi[0] not in ("nlit", "slit"):
            raise Decline("term")
        return ("between", x, lo, hi, bool(node.negate))
    if isinstance(node, _sql.IsNull):
        if not isinstance(node.x, _sql.Col) \
                or node.x.name.lower() == alias:
            raise Decline("term")
        return ("isnull", plan.slot(node.x.name), bool(node.negate))
    if isinstance(node, _sql.Like):
        if not isinstance(node.x, _sql.Col) \
                or node.x.name.lower() == alias:
            raise Decline("term")
        kind, needle = _like_shape(node.pat)
        slot = plan.slot(node.x.name)
        plan.like_cols.add(slot)
        return ("like", slot, kind, needle, bool(node.negate))
    raise Decline("predicate")


def compile_plan(q: "_sql.Query", input_format: str,
                 json_type: str = "LINES") -> ScanPlan:
    """Compile one parsed query for `input_format` ("CSV"|"JSON").
    Raises Decline for anything the kernel path cannot reproduce."""
    if input_format == "JSON":
        if json_type != "LINES":
            raise Decline("json-document")
    elif input_format != "CSV":
        raise Decline("input-format")    # Parquet etc.
    plan = ScanPlan()
    if q.is_aggregate:
        counts: list = []
        for e, _alias in q.projections:
            if not isinstance(e, _sql.Agg):
                counts.append(None)       # CPU Aggregator reports None
            elif e.name != "count":
                raise Decline("aggregate")
            elif e.arg is None:
                counts.append("star")
            elif isinstance(e.arg, _sql.Col) \
                    and e.arg.name.lower() != q.alias:
                counts.append(plan.slot(e.arg.name))
            else:
                raise Decline("aggregate")
        plan.counts = counts
    if q.where is not None:
        plan.prog = _compile_bool(plan, q.where, q.alias)
    return plan.seal()
