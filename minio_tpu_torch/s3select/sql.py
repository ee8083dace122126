"""SQL subset for S3 Select (reference pkg/s3select/sql — hand-written
parser + evaluator).

Grammar:
    SELECT projection FROM table [WHERE expr] [LIMIT n]
    projection := * | expr [AS name] ("," expr [AS name])*
    table      := S3Object[.path] [[AS] alias]
    expr       := OR-chains of AND-chains of comparisons over terms
    comparison := term (=|!=|<>|<|<=|>|>=) term | term [NOT] LIKE str
                  | term [NOT] IN (lit, ...) | term [NOT] BETWEEN a AND b
                  | term IS [NOT] NULL
    term       := literal | column | alias.column | _N | -term
                  | term (+|-|*|/|%) term | (expr)
                  | COUNT(*) | SUM/AVG/MIN/MAX/COUNT(expr)
                  | LOWER/UPPER/LENGTH/CHAR_LENGTH(expr)
                  | TRIM([[LEADING|TRAILING|BOTH] [chars] FROM] s)
                  | SUBSTRING(s FROM a [FOR n]) | SUBSTRING(s, a[, n])
                  | COALESCE(a, ...) | NULLIF(a, b)
                  | EXTRACT(part FROM ts) | UTCNOW()
                  | DATE_ADD(part, qty, ts) | DATE_DIFF(part, t1, t2)
                  | TO_TIMESTAMP(s) | TO_STRING(ts, 'pattern')
                  | CAST(expr AS type)   -- incl. TIMESTAMP

Values are Python str/float/int/bool/None/datetime; comparisons coerce
numerics like the reference's typed values; timestamp semantics mirror
pkg/s3select/sql/{funceval,timestampfuncs,stringfuncs}.go (TO_STRING /
TO_TIMESTAMP are implemented here although the reference returns
errNotImplemented for them, funceval.go:140).

A copy of minio_tpu/s3select/sql.py: the evaluator that decides every
byte of a Select response, and the oracle the scan plane is held to.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Any, Optional


class SQLError(Exception):
    pass


# -- SQL timestamps ---------------------------------------------------------
# The reference's accepted layouts (pkg/s3select/sql/timestampfuncs.go:23):
# 2006T | 2006-01T | 2006-01-02T | ..T15:04Z07:00 | ..:05 | ..05.frac

_TS_PATTERNS = [
    re.compile(r"^(\d{4})T$"),
    re.compile(r"^(\d{4})-(\d{2})T$"),
    re.compile(r"^(\d{4})-(\d{2})-(\d{2})T$"),
    re.compile(r"^(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2})"
               r"(?::(\d{2})(\.\d+)?)?(Z|[+-]\d{2}:\d{2})$"),
]


def parse_sql_timestamp(s: str) -> _dt.datetime:
    s = s.strip()
    for rx in _TS_PATTERNS:
        m = rx.match(s)
        if not m:
            continue
        g = m.groups()
        if len(g) <= 3:                        # date-only layouts
            y = int(g[0])
            mo = int(g[1]) if len(g) > 1 else 1
            d = int(g[2]) if len(g) > 2 else 1
            return _dt.datetime(y, mo, d, tzinfo=_dt.timezone.utc)
        y, mo, d, hh, mm = (int(x) for x in g[:5])
        ss = int(g[5]) if g[5] else 0
        # microseconds from the DIGITS (float math truncates .000249
        # into 248 µs); digits past µs precision are dropped
        micro = int(g[6][1:7].ljust(6, "0")) if g[6] else 0
        tz = g[7]
        if tz == "Z":
            tzinfo = _dt.timezone.utc
        else:
            sign = 1 if tz[0] == "+" else -1
            tzinfo = _dt.timezone(sign * _dt.timedelta(
                hours=int(tz[1:3]), minutes=int(tz[4:6])))
        return _dt.datetime(y, mo, d, hh, mm, ss, micro, tzinfo=tzinfo)
    raise SQLError(f"invalid timestamp {s!r}")


def format_sql_timestamp(t: _dt.datetime) -> str:
    """Reference FormatSQLTimestamp: shortest layout that keeps every
    nonzero component (timestampfuncs.go:54)."""
    off = t.utcoffset() or _dt.timedelta(0)

    def tzs() -> str:
        if not off:
            return "Z"
        total = int(off.total_seconds())
        sign = "+" if total >= 0 else "-"
        total = abs(total)
        return f"{sign}{total // 3600:02d}:{total % 3600 // 60:02d}"

    if t.microsecond:
        frac = f"{t.microsecond / 1e6:.9f}"[2:].rstrip("0")
        return (f"{t.year:04d}-{t.month:02d}-{t.day:02d}T"
                f"{t.hour:02d}:{t.minute:02d}:{t.second:02d}"
                f".{frac}{tzs()}")
    if t.second:
        return (f"{t.year:04d}-{t.month:02d}-{t.day:02d}T"
                f"{t.hour:02d}:{t.minute:02d}:{t.second:02d}{tzs()}")
    if t.hour or t.minute or off:
        return (f"{t.year:04d}-{t.month:02d}-{t.day:02d}T"
                f"{t.hour:02d}:{t.minute:02d}{tzs()}")
    if t.day != 1:
        return f"{t.year:04d}-{t.month:02d}-{t.day:02d}T"
    if t.month != 1:
        return f"{t.year:04d}-{t.month:02d}T"
    return f"{t.year:04d}T"


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><>|<=|>=|!=|=|<|>|\(|\)|,|\*|/|\+|-|%|\.)
""", re.VERBOSE)

_KEYWORDS = {
    "select", "from", "where", "limit", "as", "and", "or", "not", "like",
    "in", "between", "is", "null", "true", "false", "escape", "cast",
}


def tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    i = 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise SQLError(f"bad character {src[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws":
            continue
        if kind == "ident" and text.lower() in _KEYWORDS:
            out.append(("kw", text.lower()))
        elif kind == "string":
            out.append(("str", text[1:-1].replace("''", "'")))
        elif kind == "qident":
            out.append(("ident", text[1:-1].replace('""', '"')))
        else:
            out.append((kind, text))
    out.append(("eof", ""))
    return out


# -- AST --------------------------------------------------------------------

class Node:
    pass


class Lit(Node):
    def __init__(self, v):
        self.v = v


class Col(Node):
    def __init__(self, name: str):
        self.name = name


class Unary(Node):
    def __init__(self, op, x):
        self.op, self.x = op, x


class Bin(Node):
    def __init__(self, op, a, b):
        self.op, self.a, self.b = op, a, b


class Like(Node):
    def __init__(self, x, pat, negate):
        self.x, self.pat, self.negate = x, pat, negate


class In(Node):
    def __init__(self, x, items, negate):
        self.x, self.items, self.negate = x, items, negate


class Between(Node):
    def __init__(self, x, lo, hi, negate):
        self.x, self.lo, self.hi, self.negate = x, lo, hi, negate


class IsNull(Node):
    def __init__(self, x, negate):
        self.x, self.negate = x, negate


class Func(Node):
    def __init__(self, name, args):
        self.name, self.args = name, args


class Agg(Node):
    def __init__(self, name, arg):
        self.name, self.arg = name, arg   # arg None = COUNT(*)


class Query:
    def __init__(self):
        self.projections: list[tuple[Node, Optional[str]]] = []
        self.star = False
        self.alias = "s3object"
        self.where: Optional[Node] = None
        self.limit: Optional[int] = None

    @property
    def is_aggregate(self) -> bool:
        return any(isinstance(e, Agg) for e, _ in self.projections)


_AGG_FUNCS = {"count", "sum", "avg", "min", "max"}
_SCALAR_FUNCS = {"lower", "upper", "length", "char_length",
                 "character_length", "trim", "abs", "coalesce",
                 "nullif", "utcnow", "to_timestamp", "to_string"}
_DATE_PARTS = {"year", "month", "day", "hour", "minute", "second",
               "timezone_hour", "timezone_minute"}


class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_kw(self, kw):
        k, v = self.next()
        if k != "kw" or v != kw:
            raise SQLError(f"expected {kw.upper()}, got {v!r}")

    def accept_kw(self, kw) -> bool:
        k, v = self.peek()
        if k == "kw" and v == kw:
            self.i += 1
            return True
        return False

    def accept_op(self, op) -> bool:
        k, v = self.peek()
        if k == "op" and v == op:
            self.i += 1
            return True
        return False

    # -- grammar ----------------------------------------------------------

    def parse(self) -> Query:
        q = Query()
        self.expect_kw("select")
        if self.accept_op("*"):
            q.star = True
        else:
            while True:
                e = self.expr()
                alias = None
                if self.accept_kw("as"):
                    k, v = self.next()
                    if k not in ("ident", "str"):
                        raise SQLError("bad alias")
                    alias = v
                q.projections.append((e, alias))
                if not self.accept_op(","):
                    break
        self.expect_kw("from")
        k, v = self.next()
        if k != "ident" or v.lower() not in ("s3object", "s3objects"):
            raise SQLError(f"FROM must be S3Object, got {v!r}")
        while self.accept_op("."):
            self.next()                      # S3Object.path: ignored
        k, v = self.peek()
        if k == "ident":
            q.alias = v.lower()
            self.next()
        elif self.accept_kw("as"):
            k, v = self.next()
            q.alias = v.lower()
        if self.accept_kw("where"):
            q.where = self.expr()
        if self.accept_kw("limit"):
            k, v = self.next()
            if k != "number":
                raise SQLError("LIMIT needs a number")
            q.limit = int(float(v))
        k, v = self.peek()
        if k != "eof":
            raise SQLError(f"unexpected trailing {v!r}")
        return q

    def expr(self) -> Node:
        return self.or_expr()

    def or_expr(self) -> Node:
        left = self.and_expr()
        while self.accept_kw("or"):
            left = Bin("or", left, self.and_expr())
        return left

    def and_expr(self) -> Node:
        left = self.not_expr()
        while self.accept_kw("and"):
            left = Bin("and", left, self.not_expr())
        return left

    def not_expr(self) -> Node:
        if self.accept_kw("not"):
            return Unary("not", self.not_expr())
        return self.comparison()

    def comparison(self) -> Node:
        left = self.additive()
        negate = self.accept_kw("not")
        k, v = self.peek()
        if k == "op" and v in ("=", "!=", "<>", "<", "<=", ">", ">="):
            if negate:
                raise SQLError("NOT before comparison operator")
            self.next()
            return Bin(v, left, self.additive())
        if self.accept_kw("like"):
            k, pat = self.next()
            if k != "str":
                raise SQLError("LIKE needs a string pattern")
            esc = ""
            if self.accept_kw("escape"):
                k2, esc = self.next()
                if k2 != "str" or len(esc) != 1:
                    raise SQLError("ESCAPE needs a 1-char string")
            return Like(left, _like_regex(pat, esc), negate)
        if self.accept_kw("in"):
            if not self.accept_op("("):
                raise SQLError("IN needs a list")
            items = []
            while True:
                items.append(self.additive())
                if not self.accept_op(","):
                    break
            if not self.accept_op(")"):
                raise SQLError("unclosed IN list")
            return In(left, items, negate)
        if self.accept_kw("between"):
            lo = self.additive()
            self.expect_kw("and")
            hi = self.additive()
            return Between(left, lo, hi, negate)
        if self.accept_kw("is"):
            neg = self.accept_kw("not")
            self.expect_kw("null")
            return IsNull(left, neg)
        if negate:
            raise SQLError("dangling NOT")
        return left

    def additive(self) -> Node:
        left = self.multiplicative()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                left = Bin(v, left, self.multiplicative())
            else:
                return left

    def multiplicative(self) -> Node:
        left = self.unary()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.next()
                left = Bin(v, left, self.unary())
            else:
                return left

    def unary(self) -> Node:
        if self.accept_op("-"):
            return Unary("neg", self.unary())
        if self.accept_op("+"):
            return self.unary()
        return self.primary()

    def primary(self) -> Node:
        k, v = self.next()
        if k == "number":
            f = float(v)
            return Lit(int(f) if f.is_integer() and "." not in v
                       and "e" not in v.lower() else f)
        if k == "str":
            return Lit(v)
        if k == "kw" and v in ("true", "false"):
            return Lit(v == "true")
        if k == "kw" and v == "null":
            return Lit(None)
        if k == "kw" and v == "cast":
            if not self.accept_op("("):
                raise SQLError("CAST needs (")
            e = self.expr()
            self.expect_kw("as")
            k2, typ = self.next()
            if not self.accept_op(")"):
                raise SQLError("unclosed CAST")
            return Func("cast_" + typ.lower(), [e])
        if k == "op" and v == "(":
            e = self.expr()
            if not self.accept_op(")"):
                raise SQLError("unclosed (")
            return e
        if k == "ident":
            name = v
            if self.accept_op("("):
                fname = name.lower()
                if fname == "count" and self.accept_op("*"):
                    if not self.accept_op(")"):
                        raise SQLError("unclosed COUNT(*)")
                    return Agg("count", None)
                if fname == "substring":
                    return self._substring()
                if fname == "extract":
                    return self._extract()
                if fname == "trim":
                    return self._trim()
                if fname in ("date_add", "date_diff"):
                    return self._date_fn(fname)
                args = []
                if not self.accept_op(")"):
                    while True:
                        args.append(self.expr())
                        if not self.accept_op(","):
                            break
                    if not self.accept_op(")"):
                        raise SQLError("unclosed function call")
                if fname in _AGG_FUNCS:
                    if len(args) != 1:
                        raise SQLError(f"{fname} takes one argument")
                    return Agg(fname, args[0])
                if fname in _SCALAR_FUNCS:
                    return Func(fname, args)
                raise SQLError(f"unknown function {name}")
            # alias.column / column / _N
            if self.accept_op("."):
                k2, v2 = self.next()
                if k2 not in ("ident", "number"):
                    raise SQLError("bad column reference")
                return Col(str(v2))
            return Col(name)
        raise SQLError(f"unexpected token {v!r}")


    # -- special function forms (reference funceval.go grammar) ------------

    def _accept_ident(self, *names: str) -> Optional[str]:
        k, v = self.peek()
        if k == "ident" and v.lower() in names:
            self.next()
            return v.lower()
        return None

    def _close(self, what: str) -> None:
        if not self.accept_op(")"):
            raise SQLError(f"unclosed {what}")

    def _substring(self) -> Node:
        """SUBSTRING(s FROM start [FOR len]) | SUBSTRING(s, start
        [, len]) — both forms, like the reference
        (funceval.go:281)."""
        s = self.expr()
        args = [s]
        if self.accept_kw("from"):
            args.append(self.additive())
            if self._accept_ident("for"):
                args.append(self.additive())
        else:
            if not self.accept_op(","):
                raise SQLError("SUBSTRING needs FROM or ','")
            args.append(self.additive())
            if self.accept_op(","):
                args.append(self.additive())
        self._close("SUBSTRING")
        return Func("substring", args)

    def _extract(self) -> Node:
        """EXTRACT(part FROM timestamp)."""
        k, part = self.next()
        if k != "ident" or part.lower() not in _DATE_PARTS:
            raise SQLError(f"bad EXTRACT part {part!r}")
        self.expect_kw("from")
        e = self.expr()
        self._close("EXTRACT")
        return Func(f"extract_{part.lower()}", [e])

    def _trim(self) -> Node:
        """TRIM([[LEADING|TRAILING|BOTH] [chars] FROM] s)."""
        where = self._accept_ident("leading", "trailing", "both")
        if self.accept_kw("from"):              # TRIM(LEADING FROM s)
            e = self.expr()
            self._close("TRIM")
            return Func("trim_full",
                        [Lit(where or "both"), Lit(None), e])
        first = self.expr()
        if self.accept_kw("from"):              # TRIM([pos] chars FROM s)
            e = self.expr()
            self._close("TRIM")
            return Func("trim_full",
                        [Lit(where or "both"), first, e])
        if where is not None:
            raise SQLError("TRIM with position needs FROM")
        self._close("TRIM")
        return Func("trim", [first])

    def _date_fn(self, fname: str) -> Node:
        """DATE_ADD(part, qty, ts) / DATE_DIFF(part, ts1, ts2)."""
        k, part = self.next()
        if k != "ident" or part.lower() not in _DATE_PARTS:
            raise SQLError(f"bad {fname.upper()} date part {part!r}")
        if not self.accept_op(","):
            raise SQLError(f"{fname.upper()} needs 3 arguments")
        a = self.expr()
        if not self.accept_op(","):
            raise SQLError(f"{fname.upper()} needs 3 arguments")
        b = self.expr()
        self._close(fname.upper())
        return Func(f"{fname}_{part.lower()}", [a, b])


def _like_regex(pat: str, esc: str) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if esc and c == esc and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def parse(sql: str) -> Query:
    return Parser(tokenize(sql)).parse()


# -- evaluation -------------------------------------------------------------

def _num(v) -> Optional[float]:
    if isinstance(v, bool) or v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _aware(t: _dt.datetime) -> _dt.datetime:
    """Naive datetimes (e.g. pyarrow timestamps without a zone) compare
    as UTC instants — mixing naive and aware must never TypeError."""
    return t.replace(tzinfo=_dt.timezone.utc) if t.tzinfo is None \
        else t


def _try_ts(v) -> Optional[_dt.datetime]:
    if isinstance(v, _dt.datetime):
        return _aware(v)
    if isinstance(v, str):
        try:
            return parse_sql_timestamp(v)
        except SQLError:
            return None
    return None


def _coerce_pair(a, b):
    """Numeric comparison when both sides look numeric; a datetime on
    either side compares as an INSTANT (the other side is parsed as a
    SQL timestamp — '...T10:30Z' equals '...T12:30+02:00'); else
    string."""
    if isinstance(a, _dt.datetime) or isinstance(b, _dt.datetime):
        ta, tb = _try_ts(a), _try_ts(b)
        if ta is not None and tb is not None:
            return ta, tb
        if isinstance(a, _dt.datetime):
            a = format_sql_timestamp(_aware(a))
        if isinstance(b, _dt.datetime):
            b = format_sql_timestamp(_aware(b))
    na, nb = _num(a), _num(b)
    if na is not None and nb is not None:
        return na, nb
    if a is None or b is None:
        return a, b
    return str(a), str(b)


def evaluate(node: Node, row: dict, alias: str) -> Any:
    if isinstance(node, Lit):
        return node.v
    if isinstance(node, Col):
        name = node.name
        if name.lower() == alias:
            return row
        if name in row:
            return row[name]
        # case-insensitive fallback + positional _N
        low = name.lower()
        for k, v in row.items():
            if k.lower() == low:
                return v
        if low.startswith("_") and low[1:].isdigit():
            idx = int(low[1:]) - 1
            vals = list(row.values())
            return vals[idx] if 0 <= idx < len(vals) else None
        return None
    if isinstance(node, Unary):
        v = evaluate(node.x, row, alias)
        if node.op == "not":
            return not _truthy(v)
        n = _num(v)
        return -n if n is not None else None
    if isinstance(node, Bin):
        if node.op == "and":
            return _truthy(evaluate(node.a, row, alias)) and \
                _truthy(evaluate(node.b, row, alias))
        if node.op == "or":
            return _truthy(evaluate(node.a, row, alias)) or \
                _truthy(evaluate(node.b, row, alias))
        a = evaluate(node.a, row, alias)
        b = evaluate(node.b, row, alias)
        if node.op in ("+", "-", "*", "/", "%"):
            na, nb = _num(a), _num(b)
            if na is None or nb is None:
                return None
            try:
                if node.op == "+":
                    r = na + nb
                elif node.op == "-":
                    r = na - nb
                elif node.op == "*":
                    r = na * nb
                elif node.op == "/":
                    r = na / nb
                else:
                    r = na % nb
            except ZeroDivisionError:
                return None
            return int(r) if float(r).is_integer() else r
        a, b = _coerce_pair(a, b)
        if a is None or b is None:
            return False
        if node.op == "=":
            return a == b
        if node.op in ("!=", "<>"):
            return a != b
        if node.op == "<":
            return a < b
        if node.op == "<=":
            return a <= b
        if node.op == ">":
            return a > b
        if node.op == ">=":
            return a >= b
    if isinstance(node, Like):
        v = evaluate(node.x, row, alias)
        ok = v is not None and bool(node.pat.match(str(v)))
        return ok != node.negate
    if isinstance(node, In):
        v = evaluate(node.x, row, alias)
        hit = False
        for item in node.items:
            a, b = _coerce_pair(v, evaluate(item, row, alias))
            if a is not None and a == b:
                hit = True
                break
        return hit != node.negate
    if isinstance(node, Between):
        v = evaluate(node.x, row, alias)
        lo = evaluate(node.lo, row, alias)
        hi = evaluate(node.hi, row, alias)
        a, l2 = _coerce_pair(v, lo)
        a2, h2 = _coerce_pair(v, hi)
        ok = (a is not None and l2 is not None and h2 is not None
              and l2 <= a and a2 <= h2)
        return ok != node.negate
    if isinstance(node, IsNull):
        v = evaluate(node.x, row, alias)
        return (v is None) != node.negate
    if isinstance(node, Func):
        args = [evaluate(a, row, alias) for a in node.args]
        return _scalar_fn(node.name, args)
    if isinstance(node, Agg):
        raise SQLError("aggregate in row context")
    raise SQLError(f"cannot evaluate {node!r}")


def _truthy(v) -> bool:
    return bool(v) and v is not None


def _as_timestamp(v) -> _dt.datetime:
    if isinstance(v, _dt.datetime):
        return v
    if isinstance(v, str):
        return parse_sql_timestamp(v)
    raise SQLError(f"expected a timestamp, got {v!r}")


def _add_months(t: _dt.datetime, months: int) -> _dt.datetime:
    """Month arithmetic with Go time.AddDate's overflow semantics
    (Jan 31 + 1 month normalizes into March, not clamps to Feb 28)."""
    total = (t.year * 12 + t.month - 1) + months
    y, m = divmod(total, 12)
    base = _dt.datetime(y, m + 1, 1, t.hour, t.minute, t.second,
                        t.microsecond, tzinfo=t.tzinfo)
    return base + _dt.timedelta(days=t.day - 1)


def _date_diff(part: str, t1: _dt.datetime, t2: _dt.datetime) -> int:
    """Reference dateDiff (timestampfuncs.go:146): years/months/days
    compare calendar fields; hours/minutes/seconds compare the exact
    duration."""
    if t2 < t1:
        return -_date_diff(part, t2, t1)
    if part == "year":
        dy = t2.year - t1.year
        if (t2.month, t2.day) >= (t1.month, t1.day):
            return dy
        return dy - 1
    if part == "month":
        months = 12 * (t2.year - t1.year)
        if t2.month >= t1.month:
            months += t2.month - t1.month
        else:
            months += 12 + t2.month - t1.month
        if t2.day < t1.day:
            months -= 1
        return months
    if part == "day":
        return (t2.date() - t1.date()).days
    secs = (t2 - t1).total_seconds()
    if part == "hour":
        return int(secs // 3600)
    if part == "minute":
        return int(secs // 60)
    if part == "second":
        return int(secs)
    raise SQLError(f"DATE_DIFF does not support {part.upper()}")


_TO_STRING_RX = re.compile(
    r"yyyy|yy|y|MMMM|MMM|MM|M|dd|d|HH|H|hh|h|mm|m|ss|s|SSS|a|XXX|X"
    r"|'(?:[^']|'')*'|.")

_MONTHS = ["January", "February", "March", "April", "May", "June",
           "July", "August", "September", "October", "November",
           "December"]


def _to_string(t: _dt.datetime, fmt: str) -> str:
    """TO_STRING(ts, pattern) with the Ion/java-style tokens the S3
    Select docs describe (y/M/d/H/h/m/s/a/X, quoted literals). The
    reference leaves TO_STRING unimplemented (funceval.go:140) — this
    implements the documented surface."""
    def off_str(colon: bool) -> str:
        off = t.utcoffset() or _dt.timedelta(0)
        if not off:
            return "Z"
        total = int(off.total_seconds())
        sign = "+" if total >= 0 else "-"
        total = abs(total)
        sep = ":" if colon else ""
        return f"{sign}{total // 3600:02d}{sep}{total % 3600 // 60:02d}"

    out = []
    for tok in _TO_STRING_RX.findall(fmt):
        if tok == "yyyy":
            out.append(f"{t.year:04d}")
        elif tok == "yy":
            out.append(f"{t.year % 100:02d}")
        elif tok == "y":
            out.append(str(t.year))
        elif tok == "MMMM":
            out.append(_MONTHS[t.month - 1])
        elif tok == "MMM":
            out.append(_MONTHS[t.month - 1][:3])
        elif tok == "MM":
            out.append(f"{t.month:02d}")
        elif tok == "M":
            out.append(str(t.month))
        elif tok == "dd":
            out.append(f"{t.day:02d}")
        elif tok == "d":
            out.append(str(t.day))
        elif tok == "HH":
            out.append(f"{t.hour:02d}")
        elif tok == "H":
            out.append(str(t.hour))
        elif tok in ("hh", "h"):
            h12 = t.hour % 12 or 12
            out.append(f"{h12:02d}" if tok == "hh" else str(h12))
        elif tok == "mm":
            out.append(f"{t.minute:02d}")
        elif tok == "m":
            out.append(str(t.minute))
        elif tok == "ss":
            out.append(f"{t.second:02d}")
        elif tok == "s":
            out.append(str(t.second))
        elif tok == "SSS":
            out.append(f"{t.microsecond // 1000:03d}")
        elif tok == "a":
            out.append("AM" if t.hour < 12 else "PM")
        elif tok == "XXX":
            out.append(off_str(True))
        elif tok == "X":
            out.append(off_str(False))
        elif tok.startswith("'"):
            out.append(tok[1:-1].replace("''", "'"))
        else:
            out.append(tok)
    return "".join(out)


def _scalar_fn(name: str, args: list):
    a = args[0] if args else None
    if name == "lower":
        return str(a).lower() if a is not None else None
    if name == "upper":
        return str(a).upper() if a is not None else None
    if name in ("length", "char_length", "character_length"):
        return len(str(a)) if a is not None else None
    if name == "trim":
        return str(a).strip() if a is not None else None
    if name == "trim_full":
        where, chars, s = args
        if s is None:
            return None
        s = str(s)
        cutset = str(chars) if chars is not None else " "
        if where == "leading":
            return s.lstrip(cutset)
        if where == "trailing":
            return s.rstrip(cutset)
        return s.strip(cutset)
    if name == "abs":
        n = _num(a)
        return abs(n) if n is not None else None
    if name == "substring":
        # reference evalSQLSubstring (stringfuncs.go:144): 1-based,
        # start < 1 clamps to 1, start past the end yields "", a
        # negative length errors, an oversized one clamps
        if a is None:
            return None
        s = str(a)
        try:
            start = int(_num(args[1]))
        except (TypeError, ValueError):
            raise SQLError("SUBSTRING start must be a number") from None
        length = None
        if len(args) > 2:
            try:
                length = int(_num(args[2]))
            except (TypeError, ValueError):
                raise SQLError(
                    "SUBSTRING length must be a number") from None
            if length < 0:
                raise SQLError("negative SUBSTRING length")
        start = max(start, 1)
        if start > len(s):
            return ""
        i = start - 1
        return s[i:] if length is None else s[i:i + length]
    if name == "coalesce":
        for v in args:
            if v is not None:
                return v
        return None
    if name == "nullif":
        v1, v2 = (args + [None, None])[:2]
        if v1 is None or v2 is None:
            return v1
        a2, b2 = _coerce_pair(v1, v2)
        return None if a2 == b2 else v1
    if name == "utcnow":
        if args:
            raise SQLError("UTCNOW takes no arguments")
        return _dt.datetime.now(_dt.timezone.utc)
    if name == "to_timestamp":
        return None if a is None else _as_timestamp(a)
    if name == "to_string":
        if a is None:
            return None
        if len(args) != 2 or not isinstance(args[1], str):
            raise SQLError("TO_STRING(ts, 'pattern')")
        return _to_string(_as_timestamp(a), args[1])
    if name.startswith("extract_"):
        part = name[len("extract_"):]
        if a is None:
            return None
        t = _as_timestamp(a)
        if part in ("timezone_hour", "timezone_minute"):
            # Go's / and % truncate toward zero: -05:30 extracts
            # hour -5, minute -30 (timestampfuncs.go:105-110)
            total = int((t.utcoffset()
                         or _dt.timedelta(0)).total_seconds())
            hours = int(total / 3600)
            if part == "timezone_hour":
                return hours
            return int((total - hours * 3600) / 60)
        return getattr(t, part)
    if name.startswith("date_add_"):
        part = name[len("date_add_"):]
        qty_v, ts_v = args
        qty = _num(qty_v)
        if qty is None:
            raise SQLError("DATE_ADD quantity must be a number")
        t = _as_timestamp(ts_v)
        qty = int(qty)
        if part == "year":
            return _add_months(t, 12 * qty)
        if part == "month":
            return _add_months(t, qty)
        if part == "day":
            return t + _dt.timedelta(days=qty)
        if part == "hour":
            return t + _dt.timedelta(hours=qty)
        if part == "minute":
            return t + _dt.timedelta(minutes=qty)
        if part == "second":
            return t + _dt.timedelta(seconds=qty)
        raise SQLError(f"DATE_ADD does not support {part.upper()}")
    if name.startswith("date_diff_"):
        part = name[len("date_diff_"):]
        return _date_diff(part, _as_timestamp(args[0]),
                          _as_timestamp(args[1]))
    if name.startswith("cast_"):
        typ = name[5:]
        if a is None:
            return None
        if typ in ("int", "integer"):
            try:
                return int(float(a))
            except (TypeError, ValueError):
                raise SQLError(f"cannot cast {a!r} to int") from None
        if typ in ("float", "double", "decimal", "numeric"):
            n = _num(a)
            if n is None:
                raise SQLError(f"cannot cast {a!r} to float")
            return n
        if typ in ("string", "varchar", "char", "text"):
            if isinstance(a, _dt.datetime):
                return format_sql_timestamp(a)
            return str(a)
        if typ in ("bool", "boolean"):
            return str(a).lower() in ("true", "1")
        if typ == "timestamp":
            return _as_timestamp(a)
        raise SQLError(f"unknown cast type {typ}")
    raise SQLError(f"unknown function {name}")


class Aggregator:
    """Accumulates aggregate projections over the row stream."""

    def __init__(self, query: Query):
        self.q = query
        self.state = []
        for e, _ in query.projections:
            if isinstance(e, Agg):
                self.state.append({"n": 0, "sum": 0.0, "min": None,
                                   "max": None})
            else:
                self.state.append(None)

    def feed(self, row: dict) -> None:
        for (e, _), st in zip(self.q.projections, self.state):
            if not isinstance(e, Agg):
                continue
            if e.arg is None:                  # COUNT(*)
                st["n"] += 1
                continue
            v = evaluate(e.arg, row, self.q.alias)
            if v is None:
                continue
            st["n"] += 1
            if e.name == "count":
                # COUNT needs no min/max/sum — tracking them over a
                # mixed numeric/string column raised TypeError below
                continue
            if isinstance(v, _dt.datetime):
                v = _aware(v)       # MIN/MAX over mixed-zone rows
            n = _num(v)
            if n is not None:
                st["sum"] += n
            cur = v if n is None else n
            if st["min"] is None or cur < st["min"]:
                st["min"] = cur
            if st["max"] is None or cur > st["max"]:
                st["max"] = cur

    def result(self) -> dict:
        out = {}
        for i, ((e, alias), st) in enumerate(
                zip(self.q.projections, self.state)):
            name = alias or f"_{i + 1}"
            if not isinstance(e, Agg):
                out[name] = None
                continue
            if e.name == "count":
                v = st["n"]
            elif e.name == "sum":
                v = st["sum"] if st["n"] else None
            elif e.name == "avg":
                v = st["sum"] / st["n"] if st["n"] else None
            elif e.name == "min":
                v = st["min"]
            else:
                v = st["max"]
            if isinstance(v, float) and v.is_integer():
                v = int(v)
            out[name] = v
        return out
