"""Seeded inputs for the scan plane's checks: random corpora and queries,
and a TPC-H ``lineitem`` table as CSV.

The random generator is a port of tests/test_scan.py's (:40-155): four
columns of numbers, short words, numeric-looking strings, multi-byte
UTF-8, newlines and missing cells, and queries over every predicate the
plan compiles (comparisons with arithmetic sides, IN, BETWEEN, IS NULL,
LIKE, AND / OR / NOT) with projections, COUNTs and LIMITs. Options add
the cells whose numbers are IEEE corners (``EDGE_CELLS``: nan, inf, -0,
1e400 and strings Python's float() reads or refuses), a long word that
lifts the page width to a chosen bucket, and literals longer than the
page width. tests/test_torch_scan.py, tests/test_torch_cuda.py and
chip_smoke.py draw from it.

``lineitem_csv`` generates TPC-H's lineitem with the column domains of the
TPC-H specification (3.0.1, section 4.2.3): order keys sparse as dbgen
makes them (the first 8 of every 32), 1-7 lines an order, L_SUPPKEY and
L_EXTENDEDPRICE derived from L_PARTKEY by the spec's formulas, dates from
O_ORDERDATE, the return flag and line status from CURRENTDATE
(1995-06-17), and L_COMMENT of 10-43 characters of dbgen's word grammar.
Fields are comma-separated with a header row (S3 Select's CSV with
FileHeaderInfo USE); dbgen's own output is '|'-separated.
"""

from __future__ import annotations

import csv as _csv
import datetime as _dt
import io
import json
import random

from fractions import Fraction

import numpy as np

from ..ops import scan_program
from ..s3select import SelectRequest
from ..s3select import select as sel
from ..s3select import sql
from ..scan import pager
from ..scan.plan import Decline, compile_plan

COLS = ("a", "b", "c", "d")
WORDS = ("", "x", "zz", "abc", "x y", "Par", "10", "-3", "0.5", "9", "bé",
         "Z", "a\nb", "Z\n")
NUMS = (0, 1, -3, 25, 30, 2.5, -0.5, 10)
# cells whose number is an IEEE corner or whose float() parse is a corner
EDGE_CELLS = ("nan", "inf", "-inf", "1_0", " 5", "-0", "1e400", "0x10",
              "1e308", "-0.0", "1e-320")
LONG_LITS = ("abcdefghijklmnopqrstuvwxyz", "x" * 40, "Par" * 50,
             "9" * 30)


def _cell(rng: random.Random, edge: bool):
    r = rng.random()
    if edge and r < 0.15:
        return rng.choice(EDGE_CELLS)
    if r < 0.45:
        return rng.choice(NUMS)
    if r < 0.9:
        return rng.choice(WORDS)
    return None                              # missing / JSON null


def _wide(rng: random.Random, width: int) -> str:
    return "".join(rng.choice("abcxyzP0 ") for _ in range(width))


def csv_corpus(rng: random.Random, rows: int, edge: bool = False,
               width: int = 0) -> bytes:
    """CSV with a header row; `width` > 0 gives one row a cell of that
    many bytes in every column (the page width follows it, whichever
    columns a query reads)."""
    out = io.StringIO()
    w = _csv.writer(out)
    w.writerow(COLS)
    for i in range(rows):
        cells = [_cell(rng, edge) for _ in COLS]
        if width and i == rows // 2:
            cells = [_wide(rng, width) for _ in COLS]
        w.writerow(["" if v is None else v for v in cells])
    return out.getvalue().encode()


def json_corpus(rng: random.Random, rows: int, edge: bool = False,
                width: int = 0) -> bytes:
    """JSON Lines with missing keys and nulls; `width` as csv_corpus."""
    lines = []
    for i in range(rows):
        row = {}
        for c in COLS:
            if rng.random() < 0.15:
                continue                     # missing key
            row[c] = _cell(rng, edge)
        if width and i == rows // 2:
            row = {c: _wide(rng, width) for c in COLS}
        lines.append(json.dumps(row))
    return ("\n".join(lines) + "\n").encode()


def _lit(rng: random.Random, long_lits: bool) -> str:
    if long_lits and rng.random() < 0.15:
        return "'" + rng.choice(LONG_LITS) + "'"
    if rng.random() < 0.5:
        return str(rng.choice(NUMS))
    return "'" + rng.choice(WORDS).replace("'", "") + "'"


def _side(rng: random.Random, long_lits: bool) -> str:
    r = rng.random()
    if r < 0.45:
        return rng.choice(COLS)
    if r < 0.75:
        return _lit(rng, long_lits)
    # arithmetic over a column and a numeric literal
    op = rng.choice("+-*/%")
    return f"({rng.choice(COLS)} {op} {rng.choice(NUMS)})"


def pred(rng: random.Random, depth: int, long_lits: bool = False) -> str:
    if depth > 0 and rng.random() < 0.4:
        kind = rng.choice(("and", "or", "not"))
        if kind == "not":
            return f"NOT ({pred(rng, depth - 1, long_lits)})"
        return (f"({pred(rng, depth - 1, long_lits)}) {kind.upper()} "
                f"({pred(rng, depth - 1, long_lits)})")
    kind = rng.random()
    col = rng.choice(COLS)
    if kind < 0.40:
        op = rng.choice(("=", "!=", "<>", "<", "<=", ">", ">="))
        return f"{_side(rng, long_lits)} {op} {_side(rng, long_lits)}"
    if kind < 0.55:
        items = ", ".join(_lit(rng, long_lits)
                          for _ in range(rng.randint(1, 3)))
        neg = "NOT " if rng.random() < 0.3 else ""
        return f"{col} {neg}IN ({items})"
    if kind < 0.70:
        neg = "NOT " if rng.random() < 0.3 else ""
        return (f"{col} {neg}BETWEEN {_lit(rng, long_lits)} AND "
                f"{_lit(rng, long_lits)}")
    if kind < 0.85:
        neg = " NOT" if rng.random() < 0.3 else ""
        return f"{col} IS{neg} NULL"
    needle = rng.choice(("x", "zz", "ab", "P", "0"))
    if long_lits and rng.random() < 0.2:
        needle = rng.choice(LONG_LITS)
    pat = rng.choice((needle, f"{needle}%", f"%{needle}",
                      f"%{needle}%", "%"))
    neg = "NOT " if rng.random() < 0.3 else ""
    return f"{col} {neg}LIKE '{pat}'"


def query(rng: random.Random, long_lits: bool = False) -> str:
    r = rng.random()
    if r < 0.25:
        proj = "*"
    elif r < 0.5:
        proj = ", ".join(rng.sample(COLS, rng.randint(1, 3)))
    elif r < 0.65:
        proj = f"{rng.choice(COLS)} AS v, {rng.choice(COLS)}"
    else:
        proj = rng.choice(("COUNT(*)",
                           f"COUNT({rng.choice(COLS)})",
                           f"COUNT(*), COUNT({rng.choice(COLS)})"))
    q = f"SELECT {proj} FROM S3Object"
    if rng.random() < 0.8:
        q += f" WHERE {pred(rng, 2, long_lits)}"
    if rng.random() < 0.25:
        q += f" LIMIT {rng.randint(1, 40)}"
    return q


def request(expr: str, fmt: str = "CSV", out: str = "CSV",
            json_type: str = "LINES",
            compression: str = "NONE") -> SelectRequest:
    r = SelectRequest()
    r.expression = expr
    r.input_format = fmt
    r.csv_header = "USE"
    r.output_format = out
    r.json_type = json_type
    r.compression = compression
    return r


def select_xml(expr: str, fmt: str = "CSV", out: str = "CSV",
               compression: str = "NONE") -> bytes:
    """The SelectObjectContent request body of `expr` (CSV input with a
    header row, or JSON Lines)."""
    inp = ("<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"
           if fmt == "CSV" else "<JSON><Type>LINES</Type></JSON>")
    expr = (expr.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))
    return ('<?xml version="1.0" encoding="UTF-8"?>'
            "<SelectObjectContentRequest>"
            f"<Expression>{expr}</Expression>"
            "<ExpressionType>SQL</ExpressionType>"
            f"<InputSerialization><CompressionType>{compression}"
            f"</CompressionType>{inp}</InputSerialization>"
            f"<OutputSerialization><{out}/></OutputSerialization>"
            "</SelectObjectContentRequest>").encode()


def rows_of(data: bytes, fmt: str) -> list:
    """The row dicts the evaluator iterates for `data` (CSV with a header
    row, or JSON Lines)."""
    req = request("SELECT * FROM S3Object", fmt)
    return list(sel._rows_csv(data, req) if fmt == "CSV"
                else sel._rows_json(data, req))


def page_cases(fmt: str, width: int, seed: int, n_queries: int,
               rows: int = 300, edge: bool = True) -> list:
    """`n_queries` (expr, program, pages, query, rows) over one seeded
    corpus whose pages are `width` wide (0: the narrow words only): the
    generator's queries with long literals that the plan, the flattener
    and the pager all accept."""
    rng = random.Random(seed)
    corpus = csv_corpus if fmt == "CSV" else json_corpus
    rdicts = rows_of(corpus(rng, rows, edge=edge, width=width), fmt)
    out = []
    while len(out) < n_queries:
        expr = query(rng, long_lits=True)
        q = sql.parse(expr)
        try:
            plan = compile_plan(q, fmt)
            program = scan_program.program_for(plan)
            pages = pager.build_pages(rdicts, plan)
        except Decline:
            continue
        out.append((expr, program, pages, q, rdicts))
    return out


def tile_pages(arrays: dict, B: int, ragged: int) -> dict:
    """The pages repeated along the batch axis to B pages, the last one
    holding only its first `ragged` real rows (a request's last page)."""
    idx = np.arange(B) % arrays["num"].shape[0]
    out = {k: np.ascontiguousarray(v[idx]) for k, v in arrays.items()}
    out["rowvalid"][-1, ragged:] = False
    return out


def fma_case(seed: int = 5) -> tuple[bytes, str]:
    """A one-column CSV and a query that one FMA contraction would flip:
    for the cell a, (a * 3) + 1 rounds twice to a value the fused
    multiply-add (one rounding) does not give."""
    rng = random.Random(seed)
    while True:
        a = float(f"0.{rng.randrange(10 ** 15):015d}")
        twice = a * 3 + 1
        if float(Fraction(a) * 3 + 1) != twice:
            return (f"a\n{a!r}\n".encode(),
                    f"SELECT COUNT(*) FROM S3Object WHERE (a * 3) + 1 = "
                    f"{twice!r}")


def wide_numeric_case(C: int, n_rows: int, seed: int) -> tuple[bytes, str]:
    """A CSV of C columns and a numeric-only WHERE over all of them (each
    column against a number, ORed), over cells that parse, do not, and are
    empty: wide enough a read set that a tile holds fewer rows than a
    block has threads."""
    rng = random.Random(seed)
    data = ",".join(f"c{i}" for i in range(C)) + "\n" + "".join(
        ",".join(rng.choice(["1", "7", "-3", "2.5", "", "x"])
                 for _ in range(C)) + "\n" for _ in range(n_rows))
    where = " OR ".join(f"c{i} {'<>'[i % 2]} {i % 5}" for i in range(C))
    return (data.encode(),
            f"SELECT COUNT(*), COUNT(c1) FROM S3Object WHERE {where}")


# -- a fixed corpus and fixed predicates over every node kind --------------

_ORACLE_CELLS = ("nan", "inf", "-inf", "1_0", " 5", "-0", "1e400", "0x10",
                 "1e308", "10", "-3", "2.5", "", "x", "abc", "Par", "bé",
                 "zz", "9", "0.5", "-0.0", "x y")
_ORACLE_NUMS = ("nan", "inf", "-inf", "1_0", " 5", "-0", "1e400", "1e308",
                "10", "-3", "2.5", "-0.5", "0", "1e-320", "7", "3")


def oracle_csv() -> bytes:
    """64 rows of columns a, b (any cell), n, m (numbers and IEEE corners
    only, for arithmetic: a subnormal, overflow to inf, nan, -0, spellings
    float() reads), s (words, one past the 8-byte width bucket); some rows
    short, so their last cells are missing (null)."""
    lines = ["a,b,n,m,s"]
    cells, nums = _ORACLE_CELLS, _ORACLE_NUMS
    for i in range(64):
        row = [cells[i % len(cells)], cells[(i * 7 + 3) % len(cells)],
               nums[i % len(nums)], nums[(i * 5 + 1) % len(nums)],
               ("Par", "zz", "abc", "Parisian", "xbx", "", "P")[i % 7]]
        if i % 9 == 4:
            row = row[:3]
        lines.append(",".join(f'"{c}"' if c.startswith(" ") else c
                              for c in row))
    return ("\n".join(lines) + "\n").encode()


#: WHERE clauses over oracle_csv(): every comparison, arithmetic operator
#: (zero and infinite divisors, negative floor-mod, overflow), IN,
#: BETWEEN, IS NULL, the LIKE forms, literals longer than the width, and
#: AND / OR / NOT
ORACLE_WHERE = (
    "a = b", "a != b", "a <> b", "a < b", "a <= b", "a > b", "a >= b",
    "a < 'x'", "a >= '1_0'", "a = 10", "a = 'inf'", "a > -1",
    "n < 1e300", "n = n", "n != n", "n >= m",
    "(n + 1) > 2", "(n - m) < 0", "(n * 2) = m", "(n / m) > 1",
    "(n / 0) = 1", "(n % 3) = 1", "(n % -2) < 0", "(m % 2.5) >= 1",
    "(n * 1e308) > 0", "-n < 0", "(n % m) > 0", "(n / m) < (m % n)",
    "((n * 3) + 1) > 7", "(n % -0.5) = 0",
    "a IN (10, 'x', -3)", "a NOT IN ('abc', 2.5)", "s IN ('Par', 'zz')",
    "s NOT IN ('Par', 'x')", "m NOT IN (7, 3)",
    "a BETWEEN -1 AND 20", "a NOT BETWEEN 'a' AND 'z'",
    "n BETWEEN -5 AND 5", "s NOT BETWEEN 'P' AND 'Q'",
    "s IS NULL", "s IS NOT NULL", "NOT (s > 'P')",
    "s LIKE 'Par'", "s LIKE 'P%'", "s LIKE '%z'", "s LIKE '%b%'",
    "s LIKE '%'", "s NOT LIKE '%b%'", "s LIKE ''",
    "s LIKE 'abcdefghijklmnopqrstuvwxyz%'", "s NOT LIKE 'Par'",
    "s < 'abcdefghijklmnopqrstuvwxyz0123456789'",
    "s >= 'Parisian and more than sixteen bytes'",
    "(a > 1 AND b < 5) OR NOT (s = 'x')",
)


def node_kinds(prog: tuple, out: set | None = None) -> set:
    """The node kinds of a plan's program, arithmetic operators and LIKE
    forms spelled out ("arith%", "like-suffix")."""
    out = set() if out is None else out
    kind = prog[0]
    if kind == "arith":
        out.add(f"arith{prog[1]}")
        node_kinds(prog[2], out)
        node_kinds(prog[3], out)
        return out
    if kind in ("col", "nlit", "slit"):
        return out
    out.add(f"like-{prog[2]}" if kind == "like" else kind)
    if kind == "cmp":
        out.add(f"cmp{prog[1]}")
        for side in prog[2:]:
            node_kinds(side, out)
    elif kind in ("and", "or", "not"):
        for sub in prog[1:]:
            node_kinds(sub, out)
    elif kind in ("in", "between"):
        if prog[-1]:
            out.add(f"not-{kind}")
    elif kind == "like" and prog[-1]:
        out.add("not-like")
    return out


def needs(program, arrays: dict, mask: np.ndarray) -> dict:
    """What scan_eval must read of the pager's `arrays` (numpy, B pages)
    to run `program` (an ops/scan_program.Program) whose result mask is
    `mask`, cell by cell, counted from this data: a real row (rowvalid)
    reads a slot's ok where a comparison or arithmetic reads the slot, its
    number only where that side is a number (both sides of a comparison
    parse), its null where a string compare, NOT NULL, IS NULL, LIKE or a
    COUNT of the slot needs it, its W string bytes where a comparison falls
    to the string order (neither side parses nor is null), and for LIKE
    its length and the needle's bytes or, for contains, the cell's bytes up
    to its length. -> {"num", "ok", "null", "slen": bool [B, R, C];
    "sb_bytes": int64 [B, R, C], the string bytes a cell must give (the
    most any use needs); "sb_lo", "sb_hi": int64 [B, R, C], the hull of
    the byte offsets those uses read}."""
    num, ok, null = arrays["num"], arrays["ok"], arrays["null"]
    slen, rv = arrays["slen"], arrays["rowvalid"].astype(bool)
    B, R, C, W = arrays["sb"].shape
    need = {k: np.zeros((B, R, C), bool) for k in ("num", "ok", "null",
                                                   "slen")}
    sb_bytes = np.zeros((B, R, C), np.int64)
    sb_lo = np.full((B, R, C), W, np.int64)
    sb_hi = np.zeros((B, R, C), np.int64)

    def lit_ok(b: bytes) -> bool:
        try:
            float(b.decode("utf-8"))
            return True
        except ValueError:
            return False

    def reads(s: int, where, lo, hi):
        """Slot s's cells in `where` give their bytes lo .. hi - 1."""
        where = where & (hi > lo)
        sb_bytes[..., s] = np.where(where, np.maximum(sb_bytes[..., s],
                                                      hi - lo),
                                    sb_bytes[..., s])
        sb_lo[..., s] = np.where(where, np.minimum(sb_lo[..., s], lo),
                                 sb_lo[..., s])
        sb_hi[..., s] = np.where(where, np.maximum(sb_hi[..., s], hi),
                                 sb_hi[..., s])

    def side(sd, numeric_only: bool):
        """(ok, null, slot or None) of a side over the rows; marks the
        leaves' ok and, where it parses, their number."""
        kind = sd[0]
        if kind == "col":
            s = sd[1]
            need["ok"][..., s] |= rv
            if numeric_only:
                need["num"][..., s] |= rv & ok[..., s]
            return ok[..., s].astype(bool), null[..., s].astype(bool), s
        if kind in ("nlit", "slit"):
            v = True if kind == "nlit" else lit_ok(sd[1])
            return np.full((B, R), v), np.zeros((B, R), bool), None
        xo, _xn, _ = side(sd[2], True)
        yo, _yn, _ = side(sd[3], True)
        valid = xo & yo
        if sd[1] in ("/", "%"):
            d = _side_num(sd[3], num)
            valid &= d != 0
        return valid, ~valid, "arith"

    def cmp(a, b):
        arith = a[0] == "arith" or b[0] == "arith"
        xo, xn, xs = side(a, arith)
        yo, yn, ys = side(b, arith)
        both = xo & yo
        for s in (xs, ys):
            if not isinstance(s, int):
                continue
            need["num"][..., s] |= rv & both
            if arith:
                continue
            need["null"][..., s] |= rv & ~both
            reads(s, rv & ~both & ~(xn | yn), 0, W)

    def walk(node):
        kind = node[0]
        if kind in ("and", "or"):
            walk(node[1])
            walk(node[2])
        elif kind == "not":
            walk(node[1])
        elif kind == "cmp":
            cmp(node[2], node[3])
        elif kind == "in":
            for item in node[2]:
                cmp(node[1], item)
        elif kind == "between":
            if node[1][0] == "col":
                need["null"][..., node[1][1]] |= rv
            cmp(node[1], node[2])
            cmp(node[1], node[3])
        elif kind == "isnull":
            need["null"][..., node[1]] |= rv
        elif kind == "like":
            s, lkind, needle = node[1], node[2], node[3]
            need["null"][..., s] |= rv
            L = len(needle)
            if lkind == "any" or L > W:
                return
            live = rv & ~null[..., s].astype(bool)
            need["slen"][..., s] |= live
            n = slen[..., s].astype(np.int64)
            if lkind == "exact":
                reads(s, live & (n == L), 0, L)
            elif lkind == "prefix":
                reads(s, live & (n >= L), 0, L)
            elif lkind == "suffix":
                reads(s, live & (n >= L), n - L, n)
            else:
                reads(s, live & (n >= L), 0, np.minimum(n, W))

    walk(program.prog)
    passed = rv & mask.astype(bool)
    for c in program.cspec:
        if c >= 0:
            need["null"][..., c] |= passed
    return {**need, "sb_bytes": sb_bytes, "sb_lo": sb_lo, "sb_hi": sb_hi}


def must_move_bytes(program, arrays: dict, mask: np.ndarray) -> int:
    """The bytes scan_eval must move to run `program` over the pager's
    `arrays` whose result mask is `mask`: each page array a row of the
    program needs (`needs`), read once, rowvalid for every row, and the
    mask and counts written once."""
    need = needs(program, arrays, mask)
    B, R = arrays["rowvalid"].shape
    return int(8 * need["num"].sum() + need["ok"].sum()
               + need["null"].sum() + 4 * need["slen"].sum()
               + need["sb_bytes"].sum() + 2 * B * R
               + 4 * B * len(program.cspec) + program.blob.nbytes)


def sector_floor_bytes(program, arrays: dict, mask: np.ndarray) -> int:
    """The bytes of the 32-byte sectors of device memory that hold what
    `program` needs of `arrays` (`needs`), the pages packed as the former
    packs them (ops/scan_cuda.pack_pages, the batch at a 32-byte aligned
    address), read once, rowvalid for every row, and the mask and counts
    written once: the least a kernel reading this layout can move. A
    cell's string bytes count as the hull of the offsets its uses read."""
    from ..ops import scan_cuda
    need = needs(program, arrays, mask)
    B, R, C, W = arrays["sb"].shape
    layout, P = scan_cuda.page_layout(R, C, W)
    touched = np.zeros(-(-B * P // 32) + 1, bool)
    page = np.arange(B, dtype=np.int64)[:, None, None] * P
    cell = np.arange(R * C, dtype=np.int64).reshape(1, R, C)
    for name, size in (("num", 8), ("slen", 4), ("ok", 1), ("null", 1)):
        addr = page + layout[name][0] + cell * size
        touched[addr[need[name]] >> 5] = True
    touched[(np.arange(B, dtype=np.int64)[:, None] * P
             + layout["rowvalid"][0] + np.arange(R)).reshape(-1) >> 5] = True
    lo, hi = need["sb_lo"], need["sb_hi"]
    some = hi > lo
    start = (page + layout["sb"][0] + cell * W)[some]
    lo, hi = lo[some], hi[some]
    for k in range(-(-W // 32) + 1):
        at = np.minimum(lo + 32 * k, hi - 1)
        touched[(start + at) >> 5] = True
    return int(32 * touched.sum() + B * R + 4 * B * len(program.cspec)
               + program.blob.nbytes)


def _side_num(sd, num: np.ndarray):
    """A side's number over the rows (what the divisor of `/` and `%`
    is), with the evaluator's float arithmetic."""
    kind = sd[0]
    if kind == "col":
        return num[..., sd[1]]
    if kind == "nlit":
        return np.float64(sd[1])
    if kind == "slit":
        try:
            return np.float64(float(sd[1].decode("utf-8")))
        except ValueError:
            return np.float64(0.0)
    x, y = _side_num(sd[2], num), _side_num(sd[3], num)
    with np.errstate(all="ignore"):
        if sd[1] == "+":
            return x + y
        if sd[1] == "-":
            return x - y
        if sd[1] == "*":
            return x * y
        d = np.where(y == 0, 1.0, y)
        return x / d if sd[1] == "/" else np.mod(x, d)


ALL_KINDS = {"true", "and", "or", "not", "cmp", "in", "between", "isnull",
             "not-in", "not-between", "not-like", "like-exact",
             "like-prefix", "like-suffix", "like-contains", "like-any",
             "arith+", "arith-", "arith*", "arith/", "arith%",
             *(f"cmp{op}" for op in ("=", "!=", "<>", "<", "<=", ">",
                                     ">="))}


# -- TPC-H lineitem ------------------------------------------------------------

LINEITEM_COLS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                 "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_commitdate", "l_receiptdate", "l_shipinstruct",
                 "l_shipmode", "l_comment")
#: TPC-H Q6 (section 2.4.6) with its default substitution parameters, as
#: an S3 Select pushdown runs it
Q6_WHERE = ("s.l_shipdate >= '1994-01-01' AND s.l_shipdate < '1995-01-01' "
            "AND s.l_discount BETWEEN 0.05 AND 0.07 AND s.l_quantity < 24")
Q6_COUNT = f"SELECT COUNT(*) FROM S3Object s WHERE {Q6_WHERE}"
Q6_ROWS = (f"SELECT s.l_orderkey, s.l_extendedprice FROM S3Object s "
           f"WHERE {Q6_WHERE}")
LIKE_QUERY = ("SELECT s.l_orderkey FROM S3Object s "
              "WHERE s.l_comment LIKE '%furiously%'")
SUM_QUERY = (f"SELECT SUM(s.l_extendedprice) FROM S3Object s "
             f"WHERE {Q6_WHERE}")

_INSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
_MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
# dbgen's text grammar (dists.dss): sentences of these parts of speech
_NOUNS = ("foxes ideas theodolites pinto beans instructions dependencies "
          "excuses platelets asymptotes courts dolphins multipliers "
          "sauternes warthogs frets dinos attainments somas Tiresias "
          "patterns forges braids hockey players frays warhorses dugouts "
          "notornis epitaphs pearls tithes waters orbits gifts sheaves "
          "depths sentiments decoys realms pains grouches escapades "
          "accounts deposits packages requests").split()
_VERBS = ("sleep wake are cajole haggle nag use boost affix detect "
          "integrate maintain nod was lose sublate solve thrash promise "
          "engage hinder print x-ray breach eat grow impress mold poach "
          "serve run dazzle snooze doze unwind kindle play hang believe "
          "doubt").split()
_ADJECTIVES = ("furious sly careful blithe quick fluffy slow quiet ruthless "
               "thin close dogged daring brave stealthy permanent enticing "
               "idle busy regular final ironic even bold silent pending "
               "express special unusual").split()
_ADVERBS = ("sometimes always never furiously slyly carefully blithely "
            "quickly fluffily slowly quietly ruthlessly thinly closely "
            "doggedly daringly bravely stealthily permanently enticingly "
            "idly busily regularly finally ironically evenly boldly "
            "silently").split()
_PREPS = ("about above according to across after against along among "
          "around at atop before behind beneath beside besides between "
          "beyond by despite during except for from inside into near of "
          "on outside over past since through throughout to toward under "
          "until up upon without with within").split()


def _text_pool(rng: np.random.Generator, n_chars: int) -> str:
    """dbgen's text pool: sentences 'adverb verb the adjective noun
    preposition the noun' and shorter forms, joined by spaces."""
    parts, have = [], 0
    while have < n_chars:
        form = rng.integers(0, 3)
        words = [_ADVERBS[rng.integers(len(_ADVERBS))],
                 _VERBS[rng.integers(len(_VERBS))]]
        if form:
            words += ["the", _ADJECTIVES[rng.integers(len(_ADJECTIVES))],
                      _NOUNS[rng.integers(len(_NOUNS))]]
        if form == 2:
            words += [_PREPS[rng.integers(len(_PREPS))], "the",
                      _NOUNS[rng.integers(len(_NOUNS))]]
        s = " ".join(words) + rng.choice([".", ";", ":", "?", "!", " --"])
        parts.append(s)
        have += len(s) + 1
    return " ".join(parts)


def lineitem_csv(n_rows: int, seed: int, scale: float = 1.0) -> bytes:
    """`n_rows` lines of TPC-H lineitem at scale factor `scale` (the key
    domains), as CSV with a header row, from `seed`."""
    rng = np.random.default_rng(seed)
    # orders of 1-7 lines each until n_rows lines
    per = rng.integers(1, 8, size=n_rows)
    ends = np.cumsum(per)
    n_orders = int(np.searchsorted(ends, n_rows)) + 1
    per = per[:n_orders]
    per[-1] -= int(ends[n_orders - 1]) - n_rows
    order = np.repeat(np.arange(n_orders), per)
    linenumber = np.arange(n_rows) - np.repeat(np.cumsum(per) - per, per) + 1
    orderkey = (order // 8) * 32 + order % 8 + 1
    n_parts = int(200_000 * scale)
    n_supp = int(10_000 * scale)
    partkey = rng.integers(1, n_parts + 1, size=n_rows)
    i = rng.integers(0, 4, size=n_rows)
    suppkey = (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)) \
        % n_supp + 1
    quantity = rng.integers(1, 51, size=n_rows)
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000))
    extended = quantity * retail                      # in cents
    discount = rng.integers(0, 11, size=n_rows)       # in hundredths
    tax = rng.integers(0, 9, size=n_rows)
    start = _dt.date(1992, 1, 1).toordinal()
    end = _dt.date(1998, 12, 31).toordinal() - 151
    orderdate = np.repeat(rng.integers(start, end + 1, size=n_orders), per)
    ship = orderdate + rng.integers(1, 122, size=n_rows)
    commit = orderdate + rng.integers(30, 91, size=n_rows)
    receipt = ship + rng.integers(1, 31, size=n_rows)
    current = _dt.date(1995, 6, 17).toordinal()
    flag = np.where(receipt <= current,
                    np.where(rng.integers(0, 2, size=n_rows) == 0, "R", "A"),
                    "N")
    status = np.where(ship > current, "O", "F")
    instruct = rng.integers(0, len(_INSTRUCT), size=n_rows)
    mode = rng.integers(0, len(_MODES), size=n_rows)
    pool = _text_pool(rng, 1 << 20)
    c_len = rng.integers(10, 44, size=n_rows)
    c_off = rng.integers(0, len(pool) - 44, size=n_rows)
    dates: dict[int, str] = {}

    def day(o: int) -> str:
        s = dates.get(o)
        if s is None:
            s = dates[o] = _dt.date.fromordinal(o).isoformat()
        return s

    lines = [",".join(LINEITEM_COLS)]
    for j in range(n_rows):
        disc = "0.10" if discount[j] == 10 else f"0.0{discount[j]}"
        comment = pool[c_off[j]:c_off[j] + c_len[j]].strip()
        lines.append(
            f"{orderkey[j]},{partkey[j]},{suppkey[j]},{linenumber[j]},"
            f"{quantity[j]},{extended[j] // 100}.{extended[j] % 100:02d},"
            f"{disc},0.0{tax[j]},{flag[j]},{status[j]},{day(ship[j])},"
            f"{day(commit[j])},{day(receipt[j])},"
            f"{_INSTRUCT[instruct[j]]},{_MODES[mode[j]]},{comment}")
    return ("\n".join(lines) + "\n").encode()
