"""The scan kernel's plain PyTorch version: the plan's tree walk.

Counterpart of minio_tpu/scan/kernels.py:77-289 (`_Val`, `_const_str`,
`_pad_w`, `_str_cmp`, `_num_cmp`, `_eval_side`, `_eval_cmp`,
`_eval_like`, `_eval_prog`): the same element-wise walk of the predicate
tree (scan/plan.py), on float64 / uint8 / bool tensors of any device.
The wrapper (ops/scan_cuda.scan_eval) takes it for tensors on the CPU, and
chip_smoke.py holds the kernel against it on the card.

Pages as the pager lays them out: num f64 [B,R,C], ok / null bool [B,R,C],
sb u8 [B,R,C,W] (each cell's str() bytes, zero-padded), slen i32 [B,R,C],
rowvalid bool [B,R]. Semantics are the reference's: numeric compare when
both sides parse, False when either is null, else a compare of unsigned
bytes at the first differing byte of the zero-padded strings; arithmetic
invalid on a non-numeric operand or a zero divisor; `%` the floor-mod of
jnp.mod (fmod, plus the divisor when the remainder is nonzero and its sign
differs from the divisor's); NOT is a plain negation, so NOT over a null
cell is True.
"""

from __future__ import annotations

import torch


class _Val:
    """One comparison side over the pages: number, numeric and null
    flags, and its str() form as (bytes [..., W], length), or None for an
    arithmetic result."""

    __slots__ = ("num", "ok", "null", "sb", "slen")

    def __init__(self, num, ok, null, sb=None, slen=None):
        self.num, self.ok, self.null = num, ok, null
        self.sb, self.slen = sb, slen


def _const_str(shape, needle: bytes, width: int, device):
    """A literal's str() form broadcast to [*shape, max(width, len, 1)]."""
    w = max(width, len(needle), 1)
    buf = torch.zeros(w, dtype=torch.uint8)
    if needle:
        buf[:len(needle)] = torch.frombuffer(bytearray(needle),
                                             dtype=torch.uint8)
    sb = buf.to(device).expand(*shape, w)
    slen = torch.full(shape, len(needle), dtype=torch.int32, device=device)
    return sb, slen


def _pad_w(sb, w: int):
    have = sb.shape[-1]
    if have >= w:
        return sb
    return torch.nn.functional.pad(sb, (0, w - have))


def _str_cmp(op: str, a: _Val, b: _Val):
    w = max(a.sb.shape[-1], b.sb.shape[-1])
    ab, bb = torch.broadcast_tensors(_pad_w(a.sb, w), _pad_w(b.sb, w))
    diff = ab != bb
    any_diff = diff.any(-1)
    first = diff.to(torch.uint8).argmax(-1, keepdim=True)
    av = ab.gather(-1, first)[..., 0]
    bv = bb.gather(-1, first)[..., 0]
    lt = any_diff & (av < bv)
    eq = ~any_diff
    if op == "=":
        return eq
    if op in ("!=", "<>"):
        return ~eq
    if op == "<":
        return lt
    if op == "<=":
        return lt | eq
    if op == ">":
        return ~(lt | eq)
    return ~lt                                   # ">="


def _num_cmp(op: str, a, b):
    if op == "=":
        return a == b
    if op in ("!=", "<>"):
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


def _scale2(x, k):
    """x * 2**k for int64 tensors 0 <= k < 2100, exactly: in steps of at
    most 2**700, each factor built from its exponent bits (torch.ldexp
    forms 2**k first, which overflows past 2**1023 even where the product
    is finite, and torch.pow on the card is not exact)."""
    for _ in range(3):
        step = torch.clamp(k, max=700)
        x = x * ((step + 1023) << 52).view(torch.float64)
        k = k - step
    return x


def _fmod(a, b):
    """C's fmod, exactly: |a| reduced by |b| scaled by powers of two (each
    subtraction is exact), the sign of a; nan for an infinite a, a zero or
    nan divisor or a nan operand, a itself for an infinite divisor. PyTorch's
    vectorized CPU fmod divides first and gives nan or a wrong remainder
    when the quotient is large (1e308 % -0.5)."""
    bad = torch.isnan(a) | torch.isnan(b) | torch.isinf(a) | (b == 0)
    keep = ~bad & torch.isinf(b)
    live = ~bad & ~keep
    one = torch.ones_like(b)
    r = torch.where(live, a.abs(), torch.zeros_like(a))
    d = torch.where(live, b.abs(), one)
    md, ed = torch.frexp(d)
    while True:
        big = r >= d
        if not bool(big.any()):
            break
        mr, er = torch.frexp(torch.where(big, r, d))
        # the largest d * 2**k not above r: r/2 < t <= r, so r - t is exact
        k = (er - ed - (md > mr).to(er.dtype)).clamp(min=0)
        t = _scale2(d, k.long())
        r = torch.where(big, r - t, r)
    out = torch.copysign(r, a)
    out = torch.where(keep, a, out)
    return torch.where(bad, torch.full_like(a, float("nan")), out)


def _floor_mod(a, b):
    """jnp.mod's float remainder: fmod, then add the divisor where the
    remainder is nonzero and its sign differs from the divisor's."""
    r = _fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)


def _eval_side(side: tuple, arrs: dict, shape, width: int) -> _Val:
    kind = side[0]
    dev = arrs["num"].device
    if kind == "col":
        j = side[1]
        return _Val(arrs["num"][:, :, j], arrs["ok"][:, :, j],
                    arrs["null"][:, :, j], arrs["sb"][:, :, j, :],
                    arrs["slen"][:, :, j])
    if kind in ("nlit", "slit"):
        if kind == "nlit":
            value, ok, sform = side[1], True, side[2]
        else:
            sform = side[1]
            try:
                value, ok = float(sform.decode("utf-8")), True
            except ValueError:
                value, ok = 0.0, False
        sb, slen = _const_str(shape, sform, width, dev)
        return _Val(torch.full(shape, value, dtype=torch.float64,
                               device=dev),
                    torch.full(shape, ok, dtype=torch.bool, device=dev),
                    torch.zeros(shape, dtype=torch.bool, device=dev),
                    sb, slen)
    # arithmetic: numeric only; invalid (non-numeric operand, zero
    # divisor) behaves like the evaluator's None
    _k, op, sa, sb_ = side
    a = _eval_side(sa, arrs, shape, width)
    b = _eval_side(sb_, arrs, shape, width)
    valid = a.ok & b.ok
    if op == "+":
        v = a.num + b.num
    elif op == "-":
        v = a.num - b.num
    elif op == "*":
        v = a.num * b.num
    else:
        valid = valid & (b.num != 0)
        d = torch.where(b.num == 0, torch.ones_like(b.num), b.num)
        v = a.num / d if op == "/" else _floor_mod(a.num, d)
    return _Val(v, valid, ~valid)


def _eval_cmp(op: str, a: _Val, b: _Val):
    both_num = a.ok & b.ok
    either_null = a.null | b.null
    rnum = _num_cmp(op, a.num, b.num)
    if a.sb is None or b.sb is None:
        # an arithmetic side compares numerically only (the plan and the
        # pager decline what the string path would need)
        return both_num & rnum
    rstr = _str_cmp(op, a, b)
    return torch.where(both_num, rnum, (~either_null) & rstr)


def _eval_like(arrs: dict, slot: int, kind: str, needle: bytes,
               negate: bool):
    sb = arrs["sb"][:, :, slot, :]
    slen = arrs["slen"][:, :, slot]
    null = arrs["null"][:, :, slot]
    W = sb.shape[-1]
    L = len(needle)
    if kind == "any":
        ok = torch.ones_like(null)
    elif L > W:
        ok = torch.zeros_like(null)
    else:
        nd = torch.frombuffer(bytearray(needle) or bytearray(1),
                              dtype=torch.uint8)[:L].to(sb.device)
        if kind == "exact":
            ok = (slen == L) & (sb[..., :L] == nd).all(-1)
        elif kind == "prefix":
            ok = (slen >= L) & (sb[..., :L] == nd).all(-1)
        elif kind == "suffix":
            idx = (slen[..., None].long() - L).clamp(0, W - 1) \
                + torch.arange(L, device=sb.device)
            tail = sb.gather(-1, idx.clamp(max=W - 1))
            ok = (slen >= L) & (tail == nd).all(-1)
        else:                                    # contains
            win = sb.unfold(-1, L, 1)            # [B, R, W-L+1, L]
            hits = (win == nd).all(-1) & (
                slen[..., None]
                >= torch.arange(L, W + 1, device=sb.device, dtype=slen.dtype))
            ok = hits.any(-1)
    ok = ok & ~null                              # NULL never matches
    return ~ok if negate else ok


def eval_prog(prog: tuple, arrs: dict, shape, width: int):
    """The predicate tree over the pages -> bool [B, R] (rowvalid not yet
    applied)."""
    kind = prog[0]
    dev = arrs["num"].device
    if kind == "true":
        return torch.ones(shape, dtype=torch.bool, device=dev)
    if kind == "and":
        return eval_prog(prog[1], arrs, shape, width) \
            & eval_prog(prog[2], arrs, shape, width)
    if kind == "or":
        return eval_prog(prog[1], arrs, shape, width) \
            | eval_prog(prog[2], arrs, shape, width)
    if kind == "not":
        return ~eval_prog(prog[1], arrs, shape, width)
    if kind == "cmp":
        _k, op, sa, sb = prog
        return _eval_cmp(op, _eval_side(sa, arrs, shape, width),
                         _eval_side(sb, arrs, shape, width))
    if kind == "in":
        _k, sx, items, negate = prog
        x = _eval_side(sx, arrs, shape, width)
        hit = torch.zeros(shape, dtype=torch.bool, device=dev)
        for item in items:
            hit = hit | _eval_cmp("=", x, _eval_side(item, arrs, shape,
                                                     width))
        return ~hit if negate else hit
    if kind == "between":
        _k, sx, slo, shi, negate = prog
        x = _eval_side(sx, arrs, shape, width)
        lo = _eval_side(slo, arrs, shape, width)
        hi = _eval_side(shi, arrs, shape, width)
        ok = (~x.null) & _eval_cmp(">=", x, lo) & _eval_cmp("<=", x, hi)
        return ~ok if negate else ok
    if kind == "isnull":
        _k, slot, negate = prog
        null = arrs["null"][:, :, slot]
        return ~null if negate else null
    if kind == "like":
        _k, slot, lkind, needle, negate = prog
        return _eval_like(arrs, slot, lkind, needle, negate)
    raise ValueError(f"bad scan program node {kind!r}")


def scan_eval(prog: tuple, cspec: tuple, num, ok, null, sb, slen,
              rowvalid):
    """-> (mask uint8 [B, R], counts int32 [B, len(cspec)]): the rows that
    pass `prog` (and are real rows), and per page the COUNT of each spec
    (-1: the passing rows; a slot: the passing rows whose cell of that
    slot is not null)."""
    arrs = {"num": num, "ok": ok.bool(), "null": null.bool(), "sb": sb,
            "slen": slen}
    shape = tuple(num.shape[:2])
    mask = eval_prog(prog, arrs, shape, sb.shape[-1]) & rowvalid.bool()
    counts = [mask if c < 0 else mask & ~arrs["null"][:, :, c]
              for c in cspec]
    if counts:
        counts = torch.stack(counts, -1).sum(1, dtype=torch.int32)
    else:
        counts = torch.zeros((shape[0], 0), dtype=torch.int32,
                             device=num.device)
    return mask.to(torch.uint8), counts
