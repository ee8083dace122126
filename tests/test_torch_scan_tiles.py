"""Rehearsal of csrc/scan_eval.cu's tiles, staging and interpreter, in Python.

The kernel's geometry and index arithmetic are restated by hand over a flat
byte array that stands for device memory, holding the page arrays at the
addresses and page strides a launch gives them (the former's packed batch,
or separate arrays at odd addresses): the launcher's worst-case budget and
its choice of shared memory for the blob, the read set each block derives
from the program's code, the tile a block then takes, the work items of
(page, tile), the runs of 16-byte granules (one bulk copy each) and the
16-byte cell pieces (cp.async) each item stages into one of kStages stage
buffers of a simulated shared memory that starts as noise, the rows each
thread takes, and the interpreter: one decode of each instruction for all
of a tile's rows, descriptors on the value stack, arithmetic temporaries at
their shared offsets, word compares and the contains-LIKE filter on the
needle's first byte. Every byte the interpreter reads must have been staged
for its tile from its own array, the loads every thread row makes whatever
its result included (a row past the tile's last reads the tile's first);
every needed byte (scripts/scan_cases.needs) is staged exactly once in its
tile; no granule without a byte of its tile's run is read; every (page,
row) is written once. Results are held against the plain version
(ops/scan_plain.py) and the reference's program
(minio_tpu/scan/kernels._kernel_for, traced under jax.enable_x64), and the
read set against the one scan_cases.needs counts. The kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py); keep these
functions in step with the source by hand. The geometry constants are read
from the source, and test_geometry_is_the_sources fails when the formulas
that use them change.
"""

import os
import random
import re
import struct

import jax
import numpy as np
import pytest
import torch

from minio_tpu.s3select import sql as ref_sql
from minio_tpu.scan import kernels as ref_kernels
from minio_tpu.scan import plan as ref_plan
from minio_tpu_torch.ops import kernels, scan_cuda, scan_plain, scan_program
from minio_tpu_torch.s3select import sql
from minio_tpu_torch.scan import pager
from minio_tpu_torch.scan.plan import compile_plan
from minio_tpu_torch.scripts import scan_cases as sc

with open(os.path.join(kernels._CSRC, kernels.SOURCES["scan_eval"])) as _f:
    SOURCE = _f.read()


def constant(name: str) -> str:
    """The value of `constexpr int name = ...;` in csrc/scan_eval.cu."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, f"no constant {name} in scan_eval.cu"
    return m.group(1).strip()


def int_constant(name: str) -> int:
    value = constant(name)
    assert re.fullmatch(r"[\d\s*+]+", value), value
    return int(eval(value, {}))


THREADS = int_constant("kThreads")
WARPS = THREADS // 32
ROWS = int_constant("kRows")
BUDGET_TWO = int_constant("kBudgetTwo")
BUDGET_ONE = int_constant("kBudgetOne")
MASK_SLOTS = int_constant("kMaskSlots")
STAGES = int_constant("kStages")
BAR_BYTES = (8 * STAGES + 15) // 16 * 16
NUM, SLEN, OK, NULL, RV, SB = range(6)
NAMES = ("num", "slen", "ok", "null", "rowvalid", "sb")
ESIZE = (8, 4, 1, 1, 1, None)
TEMP, SLOT, LIT = 0, 1, 2
GRID = 264                      # 132 multiprocessors, two blocks each


def align16(n: int) -> int:
    return (n + 15) & ~15


def run_bytes(n: int) -> int:
    return align16(n) + 16


def stage_bytes(T: int, C: int, W: int, on: int, nS: int) -> int:
    n = 0
    for a, e in ((NUM, 8), (SLEN, 4), (OK, 1), (NULL, 1)):
        if on >> a & 1:
            n += run_bytes(T * C * e)
    if on >> RV & 1:
        n += run_bytes(T)
    if on >> SB & 1:
        n += align16(T * nS * W) if nS else run_bytes(T * C * W)
    return n


def temps_bytes(temps: int, rpt: int) -> int:
    return align16(8 * temps * rpt * THREADS)


def slot_bit(s: int) -> int:
    return 1 << min(s, MASK_SLOTS - 1)


class Blob:
    """A program's parts, read from its blob at the launcher's offsets."""

    def __init__(self, program):
        blob = program.blob.tobytes()
        at_code, ncode, at_cspec, ncnt, at_lnum, at_lmeta, at_lbytes = \
            program.parts
        nlit = (at_lbytes - at_lmeta) // 12
        self.code = np.frombuffer(blob, "<i4", ncode, at_code).tolist()
        self.cspec = np.frombuffer(blob, "<i4", ncnt, at_cspec).tolist()
        self.lnum = np.frombuffer(blob, "<f8", nlit, at_lnum)
        self.lmeta = np.frombuffer(blob, "<i4", 3 * nlit,
                                   at_lmeta).reshape(-1, 3)
        self.lbytes = blob[at_lbytes:]

    def lit_words(self, li: int) -> list:
        off, n = int(self.lmeta[li][1]), int(self.lmeta[li][2])
        return list(struct.unpack_from(f"<{(n + 7) // 8}Q", self.lbytes,
                                       off))

    def needle(self, li: int) -> bytes:
        off, n = int(self.lmeta[li][1]), int(self.lmeta[li][2])
        return self.lbytes[off:off + n]


def read_set(blob: Blob, W: int) -> dict:
    """The kernel's read_set(): the program's code walked over value-stack
    descriptors alone. Beside the kernel's masks, "sb" holds every slot
    whose string bytes the program can read: the staged ones (sb_stage)
    and those read from global memory for cells that do not parse."""
    rs = dict(ok=0, num=0, null=0, slen=0, sb=0, sb_stage=0, max_temps=0)
    st, temps, code, pc = [], 0, blob.code, 0

    def can_parse(v):
        return (v & 3) != LIT or blob.lmeta[v >> 2][0] != 0

    while pc < len(code):
        op = code[pc]
        pc += 1
        if op == scan_program.OP_COL:
            st.append(SLOT | code[pc] << 2)
            pc += 1
        elif op == scan_program.OP_LIT:
            st.append(LIT | code[pc] << 2)
            pc += 1
        elif op in (scan_program.OP_ARITH, scan_program.OP_CMP):
            pc += 1
            y, x = st.pop(), st.pop()
            arith = op == scan_program.OP_ARITH or TEMP in (x & 3, y & 3)
            temps -= ((x & 3) == TEMP) + ((y & 3) == TEMP)
            for v, other in ((x, y), (y, x)):
                if (v & 3) != SLOT:
                    continue
                bit = slot_bit(v >> 2)
                rs["ok"] |= bit
                if op == scan_program.OP_ARITH or can_parse(other):
                    rs["num"] |= bit
                if not arith:
                    rs["null"] |= bit
                    rs["sb"] |= bit
                    if not can_parse(other):
                        rs["sb_stage"] |= bit
            if op == scan_program.OP_ARITH:
                st.append(TEMP | temps << 2)
                temps += 1
                rs["max_temps"] = max(rs["max_temps"], temps)
        elif op == scan_program.OP_NOTNULL:
            x = st.pop()
            if (x & 3) == SLOT:
                rs["null"] |= slot_bit(x >> 2)
            temps -= (x & 3) == TEMP
        elif op == scan_program.OP_ISNULL:
            rs["null"] |= slot_bit(code[pc])
            pc += 1
        elif op == scan_program.OP_LIKE:
            slot, kind, li = code[pc:pc + 3]
            pc += 3
            L = int(blob.lmeta[li][2])
            rs["null"] |= slot_bit(slot)
            if kind != 4 and L <= W:
                rs["slen"] |= slot_bit(slot)
                if L > 0:
                    rs["sb"] |= slot_bit(slot)
                    rs["sb_stage"] |= slot_bit(slot)
        assert len(st) <= scan_program.MAX_VALS
    for c in blob.cspec:
        if c >= 0:
            rs["null"] |= slot_bit(c)
    return rs


def launcher(prog_bytes: int, ncnt: int, max_vals: int, C: int, W: int):
    """scan_eval_launch's (shared, smem): the blob in shared memory when
    two stages of THREADS rows of every array fit beside it, and the
    budget that one row's worst case fits; None when none does."""
    def need(T, prog_in):
        return (BAR_BYTES + (prog_bytes + align16(4 * WARPS * ncnt)
                             if prog_in else 0)
                + temps_bytes(max_vals, 1)
                + STAGES * stage_bytes(T, C, W, 0x3f, 0))
    shared = need(THREADS, True) <= BUDGET_TWO
    if need(1, shared) > BUDGET_ONE:
        return None
    return shared, BUDGET_TWO if need(1, shared) <= BUDGET_TWO \
        else BUDGET_ONE


class Geometry:
    """What every block of one launch derives in its prologue."""

    def __init__(self, blob: Blob, prog_bytes: int, shared: bool, smem: int,
                 B: int, R: int, C: int, W: int, sb_base: int, sb_ps: int):
        rs = self.rs = read_set(blob, W)
        self.on = ((rs["num"] != 0) << NUM | (rs["slen"] != 0) << SLEN
                   | (rs["ok"] != 0) << OK | (rs["null"] != 0) << NULL
                   | 1 << RV | (rs["sb_stage"] != 0) << SB)
        self.cells = (rs["sb_stage"] != 0 and C < MASK_SLOTS
                      and rs["sb_stage"] != (1 << C) - 1 and W % 16 == 0
                      and sb_base % 16 == 0 and sb_ps % 16 == 0)
        self.nS = bin(rs["sb_stage"]).count("1") if self.cells else 0
        self.sb_run = bool(self.on >> SB & 1) and not self.cells
        ncnt = len(blob.cspec)
        # the blob and each warp's COUNT sums, [warp][count] int32
        self.prog_region = BAR_BYTES + (prog_bytes
                                        + align16(4 * WARPS * ncnt)
                                        if shared else 0)
        self.T = 0
        t = ROWS * THREADS
        while t >= 1:
            r = t // THREADS if t > THREADS else 1
            if (self.prog_region + temps_bytes(rs["max_temps"], r)
                    + STAGES * stage_bytes(t, C, W, self.on, self.nS)
                    <= smem):
                self.T, self.rpt = t, r
                break
            t = t - THREADS if t > THREADS else t >> 1
        assert self.T > 0
        T = self.T
        self.stage0 = self.prog_region + temps_bytes(rs["max_temps"],
                                                     self.rpt)
        self.sbytes = stage_bytes(T, C, W, self.on, self.nS)
        assert self.stage0 + STAGES * self.sbytes <= smem
        sizes = (run_bytes(T * C * 8), run_bytes(T * C * 4),
                 run_bytes(T * C), run_bytes(T * C), run_bytes(T))
        self.off, at = [], 0
        for a in range(5):
            self.off.append(at)
            if self.on >> a & 1 or a == RV:
                at += sizes[a]
        self.off.append(at)
        self.tpp = -(-R // T)
        self.items = B * self.tpp
        self.B, self.R, self.C, self.W = B, R, C, W


class Memory:
    """Device memory: the page arrays at given addresses and page
    strides, noise around them."""

    def __init__(self, arrays: dict, place: str, rng):
        B, R, C, W = arrays["sb"].shape
        self.B, self.R, self.C, self.W = B, R, C, W
        self.base, self.ps, self.bytes = [0] * 6, [0] * 6, [0] * 6
        flat = {"num": np.ascontiguousarray(arrays["num"], "<f8"),
                "slen": np.ascontiguousarray(arrays["slen"], "<i4"),
                "ok": np.ascontiguousarray(arrays["ok"], np.uint8),
                "null": np.ascontiguousarray(arrays["null"], np.uint8),
                "rowvalid": np.ascontiguousarray(arrays["rowvalid"],
                                                 np.uint8),
                "sb": np.ascontiguousarray(arrays["sb"], np.uint8)}
        for a, name in enumerate(NAMES):
            self.bytes[a] = flat[name].reshape(B, -1).view(np.uint8).shape[1]
        if place == "packed":
            layout, P = scan_cuda.page_layout(R, C, W)
            packed = scan_cuda.pack_pages(arrays)
            self.mem = packed.reshape(-1).copy()
            for a, name in enumerate(NAMES):
                self.base[a], self.ps[a] = layout[name][0], P
            return
        # separate arrays at odd addresses and page strides, within the
        # launcher's alignment rules (num, sb: 8; slen: 4; flags: 1)
        at, chunks = 64, []
        for a, name in enumerate(NAMES):
            align = {NUM: 8, SLEN: 4, SB: 8}.get(a, 1)
            at += rng.integers(1, 40)
            at += -at % align
            if align == 8 and at % 16 == 0:
                at += 8
            stride = self.bytes[a] + rng.integers(0, 24)
            stride += -stride % align
            self.base[a], self.ps[a] = at, stride
            chunks.append((at, stride, flat[name].reshape(B, -1)
                           .view(np.uint8)))
            at += B * stride + 64
        self.mem = rng.integers(0, 256, at, dtype=np.uint8)
        for start, stride, data in chunks:
            for b in range(B):
                self.mem[start + b * stride:start + b * stride
                         + data.shape[1]] = data[b]


def run_kernel(program, mem: Memory, grid: int = GRID, smem_cap=None,
               rng=None, check_needs=None):
    """The kernel over `mem`: (mask, counts, geometry). smem_cap lowers
    the budget the launcher hands the blocks (to reach the smaller
    tiles); check_needs is scan_cases.needs of the pages, whose bytes must
    each be staged exactly once in their tile."""
    rng = rng or np.random.default_rng(0)
    blob = Blob(program)
    B, R, C, W = mem.B, mem.R, mem.C, mem.W
    prog_bytes = program.blob.nbytes
    got = launcher(prog_bytes, len(blob.cspec), program.max_vals, C, W)
    assert got is not None
    shared, smem = got
    if smem_cap is not None:
        smem = min(smem, smem_cap)
    g = Geometry(blob, prog_bytes, shared, smem, B, R, C, W,
                 mem.base[SB], mem.ps[SB])
    widest = B * -(-R // (ROWS * THREADS))
    grid = min(grid, widest)
    mask = np.full((B, R), 7, np.uint8)
    counts = np.zeros((B, len(blob.cspec)), np.int64)
    written = np.zeros((B, R), np.int64)
    for block in range(grid):
        sm = rng.integers(0, 256, smem, dtype=np.uint8)
        staged = [None] * STAGES
        issued = 0
        for k, item in enumerate(range(block, g.items, grid)):
            # stage the items up to STAGES - 1 past this one
            while issued < k + STAGES:
                it = block + issued * grid
                if it < g.items:
                    staged[issued % STAGES] = stage(
                        g, mem, it, sm, issued % STAGES, check_needs)
                issued += 1
            p = k % STAGES
            evaluate(g, blob, mem, item, sm, staged[p], p, mask, counts,
                     written)
    assert (written[:, :R] == 1).all()
    return mask, counts.astype(np.int32), g


def stage(g: Geometry, mem: Memory, item: int, sm, p: int, needs):
    """Copy work item `item` into stage p of sm; returns the staged map:
    smem offset -> memory address of each staged byte, and checks the
    granules (each holds a byte of its tile's run or is a whole cell
    piece) and, with `needs`, that every needed byte is staged once."""
    b, t = divmod(item, g.tpp)
    r0 = t * g.T
    n = min(g.T, g.R - r0)
    C, W = g.C, g.W
    dst = g.stage0 + p * g.sbytes
    src_of = np.full(g.sbytes, -1, np.int64)      # stage byte -> address
    copies = []

    def run(a: int, row_bytes: int):
        g0 = mem.base[a] + b * mem.ps[a] + r0 * row_bytes
        g1 = g0 + n * row_bytes
        a0 = g0 & ~15
        cnt = (((g1 + 15) & ~15) - a0) >> 4
        for i in range(cnt):
            lo = a0 + 16 * i
            # the granule holds a byte of the tile's run of this array
            assert lo < g1 and lo + 16 > g0
            copies.append((dst + g.off[a] + 16 * i, lo, 16))

    for a, e in ((NUM, 8), (SLEN, 4), (OK, 1), (NULL, 1)):
        if g.on >> a & 1:
            run(a, e * C)
    run(RV, 1)
    if g.cells:
        slots = [s for s in range(C) if g.rs["sb_stage"] >> s & 1]
        for q in range(n * g.nS):
            row, si = divmod(q, g.nS)
            src = mem.base[SB] + b * mem.ps[SB] + ((r0 + row) * C
                                                   + slots[si]) * W
            d = dst + g.off[SB] + (row * g.nS + si) * W
            assert src % 16 == 0 and d % 16 == 0 and W % 16 == 0
            copies += [(d + k, src + k, 16) for k in range(0, W, 16)]
    elif g.on >> SB & 1:
        run(SB, C * W)
    for d, s, size in copies:
        # bulk copies and cp.async: 16-byte aligned addresses and sizes
        assert dst <= d and d + size <= dst + g.sbytes
        assert s % 16 == 0 and d % 16 == 0 and size % 16 == 0
        assert (src_of[d - dst:d - dst + size] == -1).all(), "overlap"
        src_of[d - dst:d - dst + size] = np.arange(s, s + size)
        sm[d:d + size] = mem.mem[s:s + size]
    if needs is not None:
        addr_count = {}
        for d, s, size in copies:
            for x in range(s, s + size):
                addr_count[x] = addr_count.get(x, 0) + 1
        for a, name, e in ((NUM, "num", 8), (SLEN, "slen", 4),
                           (OK, "ok", 1), (NULL, "null", 1)):
            rows, cols = np.nonzero(needs[name][b, r0:r0 + n])
            for r, c in zip(rows.tolist(), cols.tolist()):
                at = mem.base[a] + b * mem.ps[a] + ((r0 + r) * C + c) * e
                for x in range(at, at + e):
                    assert addr_count.get(x) == 1, (name, r, c)
        lo, hi = needs["sb_lo"][b, r0:r0 + n], needs["sb_hi"][b, r0:r0 + n]
        staged = np.array([g.sb_run or bool(g.cells and g.rs["sb_stage"]
                                                >> c & 1) for c in range(C)])
        for r, c in zip(*np.nonzero((hi > lo) & staged)):
            at = mem.base[SB] + b * mem.ps[SB] + ((r0 + r) * C + c) * W
            for x in range(at + lo[r, c], at + hi[r, c]):
                assert addr_count.get(int(x)) == 1, ("sb", r, c)
    return src_of


def zero_bytes(x: int) -> int:
    lo7 = 0x7F7F7F7F7F7F7F7F
    return ~(((x & lo7) + lo7) | x | lo7) & 0xFFFFFFFFFFFFFFFF


def contains(words, cell, s: int, W: int, needle: bytes) -> bool:
    """The kernel's contains(): the cell's words filtered on the needle's
    first byte, and at each candidate the 8 bytes from it (two words
    funnel-shifted) held against the needle's first 8 under a mask, the
    rest byte by byte."""
    L = len(needle)
    last = min(s, W) - L
    pat = 0x0101010101010101 * needle[0]
    n8 = min(L, 8)
    head = int.from_bytes(needle[:n8], "little")
    hmask = (1 << (8 * n8)) - 1
    k = 0
    while 8 * k <= last:
        w = words(k)
        m = zero_bytes(w ^ pat)
        nxt = words(k + 1) if m and 8 * k + 8 < W else 0
        while m:
            b = ((m & -m).bit_length() - 1) >> 3
            off = 8 * k + b
            if off > last:
                return False
            at = w if b == 0 else ((w >> (8 * b)) | (nxt << (64 - 8 * b))) \
                & 0xFFFFFFFFFFFFFFFF
            if (at ^ head) & hmask == 0 and \
                    cell(off + 8, L - n8) == needle[8:]:
                return True
            m &= m - 1
        k += 1
    return False


def str_order(a: list, b: list) -> int:
    for i in range(max(len(a), len(b))):
        x = a[i] if i < len(a) else 0
        y = b[i] if i < len(b) else 0
        if x != y:
            low = (x ^ y) & -(x ^ y)
            sh = (low.bit_length() - 1) & ~7
            return -1 if (x >> sh) & 0xFF < (y >> sh) & 0xFF else 1
    return 0


def _arith(op: int, x: float, y: float) -> tuple[float, bool]:
    with np.errstate(all="ignore"):
        x, y = np.float64(x), np.float64(y)
        if op == 0:
            return float(x + y), True
        if op == 1:
            return float(x - y), True
        if op == 2:
            return float(x * y), True
        d = y if y != 0 else np.float64(1)
        if op == 3:
            return float(x / d), bool(y != 0)
        r = np.fmod(x, d)
        if r != 0 and (r < 0) != (d < 0):
            r = r + d
        return float(r), bool(y != 0)


def _num_cmp(op: int, a: float, b: float) -> bool:
    return (a == b, a != b, a < b, a <= b, a > b, a >= b)[op]


def evaluate(g: Geometry, blob: Blob, mem: Memory, item: int, sm, src_of,
             p: int, mask, counts, written):
    """Interpret the program for work item `item` from stage p: each
    instruction decoded once for all the tile's rows (rows j * THREADS +
    tid of the threads), every byte read checked to be one staged for
    this tile from its own array."""
    b, t = divmod(item, g.tpp)
    r0 = t * g.T
    n = min(g.T, g.R - r0)
    C, W = g.C, g.W
    sp = g.stage0 + p * g.sbytes

    def at(a, row_bytes):
        return sp + g.off[a] + ((mem.base[a] + b * mem.ps[a]
                                 + r0 * row_bytes) & 15)

    s_num, s_slen = at(NUM, 8 * C), at(SLEN, 4 * C)
    s_ok, s_null, s_rv = at(OK, C), at(NULL, C), at(RV, 1)
    s_sb = sp + g.off[SB] if g.cells else at(SB, C * W)

    def read(a: int, off: int, size: int, row: int, col: int) -> bytes:
        """`size` staged bytes at sm[off], which must come from array a's
        element (row, col) of this tile's page."""
        src = src_of[off - sp:off - sp + size]
        if a == SB:
            want0 = mem.base[SB] + b * mem.ps[SB] + ((r0 + row) * C
                                                     + col) * W
        else:
            cols = 1 if a == RV else C
            want0 = mem.base[a] + b * mem.ps[a] + ((r0 + row) * cols
                                                   + col) * ESIZE[a]
        assert 0 <= off - sp and off - sp + size <= g.sbytes
        assert (src >= want0).all() and (src < want0 + (
            W if a == SB else ESIZE[a])).all(), (NAMES[a], row, col)
        return sm[off:off + size].tobytes()

    def cell_bytes(rt: int, s: int, off: int, k: int) -> bytes:
        """k bytes at offset off of slot s's cell of tile row rt: staged,
        or from the page where it lies (a slot that is not staged)."""
        if k == 0:
            return b""
        assert 0 <= off and off + k <= W
        if g.sb_run:
            return read(SB, s_sb + (rt * C + s) * W + off, k, rt, s)
        if g.cells and g.rs["sb_stage"] >> s & 1:
            col = bin(g.rs["sb_stage"] & ((1 << s) - 1)).count("1")
            return read(SB, s_sb + (rt * g.nS + col) * W + off, k, rt, s)
        at = mem.base[SB] + b * mem.ps[SB] + ((r0 + rt) * C + s) * W + off
        return mem.mem[at:at + k].tobytes()

    thread_rows = [j * THREADS + tid for j in range(g.rpt)
                   for tid in range(THREADS)]
    rows = [rt for rt in thread_rows if rt < n]
    # the rows whose staged cells the kernel's per-row loads read, for every
    # thread row whether real or not (row(j)): a row past the tile's last
    # reads the tile's first
    read_rows = sorted({rt if rt < n else 0 for rt in thread_rows})
    for rt in rows:
        written[b, r0 + rt] += 1
    live = [rt for rt in rows if read(RV, s_rv + rt, 1, rt, 0) != b"\0"]
    bits = {rt: [] for rt in live}
    tval, tnum = {rt: {} for rt in live}, {}
    st, temps, code, pc = [], 0, blob.code, 0

    def side_ok(v, rt):
        if (v & 3) == SLOT:
            return read(OK, s_ok + rt * C + (v >> 2), 1, rt, v >> 2) != b"\0"
        if (v & 3) == LIT:
            return bool(blob.lmeta[v >> 2][0])
        return tval[rt][v >> 2]

    def side_null(v, rt):
        if (v & 3) == SLOT:
            return read(NULL, s_null + rt * C + (v >> 2), 1, rt,
                        v >> 2) != b"\0"
        if (v & 3) == LIT:
            return False
        return not tval[rt][v >> 2]

    def side_num(v, rt):
        if (v & 3) == SLOT:
            if not g.on >> NUM & 1:
                return 0.0
            return struct.unpack("<d", read(
                NUM, s_num + 8 * (rt * C + (v >> 2)), 8, rt, v >> 2))[0]
        if (v & 3) == LIT:
            return float(blob.lnum[v >> 2])
        return tnum[(v >> 2, rt)]

    def touch(v, *arrays):
        """The loads every thread row makes of slot side v's cells in
        `arrays`, whatever the row's result: each must be staged."""
        if (v & 3) != SLOT:
            return
        for a in arrays:
            if a == NUM and not g.on >> NUM & 1:
                continue
            e, base = ESIZE[a], {NUM: s_num, OK: s_ok, NULL: s_null}[a]
            for rt in read_rows:
                read(a, base + e * (rt * C + (v >> 2)), e, rt, v >> 2)

    def side_words(v, rt):
        if (v & 3) == SLOT:
            raw = cell_bytes(rt, v >> 2, 0, W)
            return list(struct.unpack(f"<{W // 8}Q", raw))
        return blob.lit_words(v >> 2)

    while pc < len(code):
        op = code[pc]
        pc += 1
        if op in (scan_program.OP_TRUE, scan_program.OP_FALSE):
            for rt in live:
                bits[rt].append(op == scan_program.OP_TRUE)
        elif op in (scan_program.OP_AND, scan_program.OP_OR):
            for rt in live:
                y, x = bits[rt].pop(), bits[rt].pop()
                bits[rt].append((x and y) if op == scan_program.OP_AND
                                else (x or y))
        elif op == scan_program.OP_NOT:
            for rt in live:
                bits[rt].append(not bits[rt].pop())
        elif op == scan_program.OP_COL:
            st.append(SLOT | code[pc] << 2)
            pc += 1
        elif op == scan_program.OP_LIT:
            st.append(LIT | code[pc] << 2)
            pc += 1
        elif op == scan_program.OP_ARITH:
            aop = code[pc]
            pc += 1
            y, x = st.pop(), st.pop()
            temps -= ((x & 3) == TEMP) + ((y & 3) == TEMP)
            dst = temps
            temps += 1
            assert dst < g.rs["max_temps"]
            touch(x, OK, NUM)
            touch(y, OK, NUM)
            for rt in live:
                j, tid = divmod(rt, THREADS)
                # the temporary's shared offset, inside its region
                assert (dst * g.rpt + j) * THREADS + tid < \
                    g.rs["max_temps"] * g.rpt * THREADS
                valid = side_ok(x, rt) and side_ok(y, rt)
                v, nz = _arith(aop, side_num(x, rt), side_num(y, rt))
                tnum[(dst, rt)] = v
                tval[rt][dst] = valid and nz
            st.append(TEMP | dst << 2)
        elif op == scan_program.OP_CMP:
            cop = code[pc]
            pc += 1
            y, x = st.pop(), st.pop()
            arith = TEMP in (x & 3, y & 3)
            temps -= ((x & 3) == TEMP) + ((y & 3) == TEMP)
            touch(x, OK, NUM)
            touch(y, OK, NUM)
            if {x & 3, y & 3} == {SLOT, LIT}:
                # a column against a literal: every row's null too
                touch(x, NULL)
                touch(y, NULL)
            # every row's sides first, numbers where num is staged (a
            # slot's number reads as 0 where it is not), then the rows
            # whose sides do not both parse fall to nulls and strings
            for rt in live:
                both = side_ok(x, rt) and side_ok(y, rt)
                nx, ny = side_num(x, rt), side_num(y, rt)
                res = both and _num_cmp(cop, nx, ny)
                if not both and not arith and not side_null(x, rt) and \
                        not side_null(y, rt):
                    c = str_order(side_words(x, rt), side_words(y, rt))
                    res = (c == 0, c != 0, c < 0, c <= 0, c > 0,
                           c >= 0)[cop]
                bits[rt].append(res)
        elif op == scan_program.OP_NOTNULL:
            x = st.pop()
            temps -= (x & 3) == TEMP
            touch(x, NULL)
            for rt in live:
                bits[rt].append(not side_null(x, rt))
        elif op == scan_program.OP_ISNULL:
            slot = code[pc]
            pc += 1
            touch(SLOT | slot << 2, NULL)
            for rt in live:
                bits[rt].append(read(NULL, s_null + rt * C + slot, 1, rt,
                                     slot) != b"\0")
        elif op == scan_program.OP_LIKE:
            slot, kind, li = code[pc:pc + 3]
            pc += 3
            needle = blob.needle(li)
            L = len(needle)
            touch(SLOT | slot << 2, NULL)
            for rt in live:
                null = read(NULL, s_null + rt * C + slot, 1, rt,
                            slot) != b"\0"
                if kind == 4:
                    hit = True
                elif L > W or null:
                    hit = False
                else:
                    s = struct.unpack("<i", read(
                        SLEN, s_slen + 4 * (rt * C + slot), 4, rt,
                        slot))[0]

                    def cell(off, k, rt=rt):
                        return cell_bytes(rt, slot, off, k)

                    if kind == 0:
                        hit = s == L and cell(0, L) == needle
                    elif kind == 1:
                        hit = s >= L and cell(0, L) == needle
                    elif kind == 2:
                        hit = s >= L and cell(s - L, L) == needle
                    else:
                        hit = s >= L and (L == 0 or contains(
                            lambda k, c=cell: struct.unpack(
                                "<Q", c(8 * k, 8))[0], cell, s, W, needle))
                bits[rt].append(hit and not null)
        else:
            raise AssertionError(f"opcode {op}")
    for slot in blob.cspec:
        if slot >= 0:
            touch(SLOT | slot << 2, NULL)
    for rt in rows:
        ok = rt in bits
        if ok:
            assert len(bits[rt]) == 1
        passed = ok and bits[rt][0]
        mask[b, r0 + rt] = passed
        for c, slot in enumerate(blob.cspec):
            if passed and (slot < 0 or read(
                    NULL, s_null + rt * C + slot, 1, rt, slot) == b"\0"):
                counts[b, c] += 1
    assert not st and temps == 0


def plain(program, arrays):
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in arrays.items()}
    m, c = scan_plain.scan_eval(program.prog, program.cspec, **t)
    return m.numpy(), c.numpy()


def jax_mask(expr: str, fmt: str, arrays: dict) -> np.ndarray:
    """The reference's own program for the query over the same pages
    (minio_tpu/scan/kernels._kernel_for), traced and run with 64-bit
    floats on."""
    ref = ref_plan.compile_plan(ref_sql.parse(expr), fmt)
    with jax.enable_x64(True):
        fn = ref_kernels._kernel_for(ref, None)
        return np.asarray(fn(*[arrays[k] for k in ref_kernels._ARRAY_ORDER]))


def subnormal_rows(arrays: dict) -> np.ndarray:
    """Rows holding a subnormal number, which XLA on the CPU flushes to
    zero (the reference's program departs from its own evaluator there)."""
    num, ok = arrays["num"], arrays["ok"].astype(bool)
    return ((num != 0) & (np.abs(num) < np.finfo(np.float64).tiny)
            & ok).any(-1)


def check(program, arrays, expr=None, fmt="CSV", place="packed", seed=0,
          jax=False, **kw):
    rng = np.random.default_rng(seed)
    mem = Memory(arrays, place, rng)
    want = plain(program, arrays)
    needs = sc.needs(program, arrays, want[0])
    mask, counts, g = run_kernel(program, mem, rng=rng, check_needs=needs,
                                 **kw)
    assert np.array_equal(mask, want[0]), expr
    assert np.array_equal(counts, want[1]), expr
    if jax:
        ref = jax_mask(expr, fmt, arrays)
        sub = subnormal_rows(arrays)
        assert np.array_equal(mask.astype(bool)[~sub], ref[~sub]), expr
    return g


def test_geometry_is_the_sources():
    # the restatement derives a block's tile, stage layout and rows from
    # kThreads, kRows and the budgets as the kernel does; a change of
    # those formulas must reach this file
    flat = " ".join(SOURCE.split())
    for text in (
            "return align16(n) + 16;",
            "return align16(8LL * temps * rpt * kThreads);",
            "return 1u << (s < kMaskSlots - 1 ? s : kMaskSlots - 1);",
            "for (int t = kRows * kThreads; t >= 1; "
            "t = t > kThreads ? t - kThreads : t >> 1) "
            "{ const int r = t > kThreads ? t / kThreads : 1;",
            "const int rt = j * kThreads + tid; "
            "if (j < rpt && rt < n && s_rv[rt] != 0) live |= 1u << j;",
            "const bool shared = need(kThreads, true) <= kBudgetTwo;",
            "const int smem = budget == 0 ? kBudgetTwo : kBudgetOne;",
            "a0 = g0 & ~uintptr_t{15};",
            "const bool cells = rs.sb_stage != 0 && C < kMaskSlots && "
            "rs.sb_stage != (1u << C) - 1u && W % 16 == 0 &&",
            "bar_wait(bars + p, (k / kStages) & 1);",
            "const int rt = j * kThreads + tid; return rt < n ? rt : 0;",
            "return s_null[row(j) * C + ref] != 0;",
            "const int at = row(j) * C + slot;",
            "kBarBytes + (kShared ? prog_bytes + align16(4LL * kWarps * ncnt)"
            " : 0);",
            "constexpr int kWarps = kThreads / 32;",
            "s_part[(tid >> 5) * ncnt + c] = sum;",
            "for (int w = 0; w < kWarps; ++w) sum += s_part[w * ncnt + c];",
            "return tnum[(ref * rpt + j) * kThreads + tid];",
            "if (sb_run) return s_sb + (rt * C + s) * W;",
            "return g_sb + (static_cast<long long>(r0 + rt) * C + s) * W;",
            "if (!can_parse(sides[1 - i])) rs.sb_stage |= bit;",
            "for (int k = 0, issued = 0; item < items; ++k, item += gridDim.x)",
            "(R + kRows * kThreads - 1) / (kRows * kThreads)"):
        assert text in flat, text
    assert constant("kMaxVals") == "SCAN_MAX_VALS"
    assert THREADS % 32 == 0 and ROWS >= 1
    # two blocks of the smaller budget fit an SM's 228 KB with 1 KB each
    # reserved; one of the larger is a block's most
    assert 2 * (BUDGET_TWO + 1024) <= 228 * 1024
    assert BUDGET_ONE == 227 * 1024


@pytest.mark.parametrize("fmt", ["CSV", "JSON"])
@pytest.mark.parametrize("width", [0, 30, 100])
def test_generated_queries_in_tiles(fmt, width):
    for expr, program, pages, _q, _r in sc.page_cases(
            fmt, width, 300 + width, 8, rows=150):
        check(program, pages.arrays, expr)


def test_oracle_queries_in_tiles():
    # every node kind; against the evaluator's WHERE decision and the
    # reference's program too
    data = sc.oracle_csv()
    rows = sc.rows_of(data, "CSV")
    for where in sc.ORACLE_WHERE:
        expr = f"SELECT COUNT(*), COUNT(s) FROM S3Object WHERE {where}"
        q = sql.parse(expr)
        plan = compile_plan(q, "CSV")
        program = scan_program.program_for(plan)
        pages = pager.build_pages(rows, plan)
        check(program, pages.arrays, expr, jax=True)
        mask = plain(program, pages.arrays)[0].reshape(-1)[:len(rows)]
        assert np.array_equal(mask.astype(bool), [
            bool(sql.evaluate(q.where, r, q.alias)) for r in rows]), where


def _lineitem(n_rows: int, query: str):
    rows = sc.rows_of(sc.lineitem_csv(n_rows, 7), "CSV")
    plan = compile_plan(sql.parse(query), "CSV")
    return scan_program.program_for(plan), pager.build_pages(rows, plan)


def test_q6_stages_one_string_slot_of_three():
    # Q6: l_shipdate's string bytes only (a cell of 16 B in 16-byte
    # pieces), every array's run; kRows x kThreads rows a tile
    program, pages = _lineitem(2500, sc.Q6_COUNT)
    g = check(program, pages.arrays, sc.Q6_COUNT, jax=True)
    assert g.cells and g.nS == 1
    assert g.T == ROWS * THREADS and g.rpt == ROWS
    assert g.on == (1 << NUM | 1 << OK | 1 << NULL | 1 << RV | 1 << SB)
    # separate arrays at odd addresses: sb's cells are not 16-byte
    # aligned, so it is staged as one run
    g = check(program, pages.arrays, sc.Q6_COUNT, place="odd", seed=3)
    assert not g.cells and g.on >> SB & 1


def test_contains_like_stages_the_whole_cell_run():
    program, pages = _lineitem(2500, sc.LIKE_QUERY)
    g = check(program, pages.arrays, sc.LIKE_QUERY, jax=True)
    assert not g.cells and g.on == (1 << SLEN | 1 << NULL | 1 << RV
                                    | 1 << SB)
    assert g.W == 64 and g.T < ROWS * THREADS


def _cut(arrays: dict, R: int, B: int | None = None) -> dict:
    """The first R rows of every page (a page of any row count), tiled to
    B pages with a ragged last one."""
    out = {k: np.ascontiguousarray(v[:, :R]) for k, v in arrays.items()}
    if B is not None:
        out = sc.tile_pages(out, B, max(1, R // 3))
    return out


@pytest.mark.parametrize("R,B,cap,place", [
    (1000, 3, None, "packed"),          # R not a multiple of the tile
    (1025, 2, None, "odd"),
    (3, 5, None, "odd"),                # one ragged tile a page
    (777, 4, 20_000, "odd"),            # small tiles, many items a block
    (300, 3, 12_000, "packed"),         # tiles below kThreads rows
    (64, 70, None, "packed")])          # more items than blocks
def test_ragged_tiles_and_budgets(R, B, cap, place):
    rdicts = sc.rows_of(sc.lineitem_csv(400, R), "CSV")
    for expr in ("SELECT COUNT(*), COUNT(l_tax) FROM S3Object WHERE "
                 "(l_quantity * 2) > l_extendedprice OR "
                 "l_comment LIKE '%ly%'",
                 "SELECT COUNT(*) FROM S3Object WHERE l_shipmode < 'RAIL' "
                 "AND l_discount BETWEEN 0.02 AND 0.05 AND "
                 "l_tax IS NOT NULL",
                 "SELECT * FROM S3Object WHERE ((l_quantity + 1) / "
                 "(l_tax - 0.02)) < (l_linenumber % 3) OR "
                 "l_shipinstruct LIKE 'DELIVER%'",
                 "SELECT COUNT(*) FROM S3Object WHERE "
                 "l_returnflag = l_linestatus OR l_quantity = 'x'"):
        plan = compile_plan(sql.parse(expr), "CSV")
        program = scan_program.program_for(plan)
        pages = pager.build_pages(rdicts, plan)
        arrays = _cut(pages.arrays, R, B)
        g = check(program, arrays, expr, place=place, seed=R,
                  grid=3, smem_cap=cap)
        assert R % g.T != 0 and g.items == B * -(-R // g.T)
        if cap == 12_000:
            assert g.T < THREADS


def _wide_numeric(C: int, n_rows: int, seed: int):
    data, expr = sc.wide_numeric_case(C, n_rows, seed)
    plan = compile_plan(sql.parse(expr), "CSV")
    return expr, scan_program.program_for(plan), pager.build_pages(
        sc.rows_of(data, "CSV"), plan)


def test_wide_numeric_where_reads_only_staged_rows():
    # 43 slots of numbers: a tile is under kThreads rows, so the threads
    # past it read the tile's first row, never past the stage
    expr, program, pages = _wide_numeric(43, 700, 43)
    g = check(program, pages.arrays, expr, grid=4)
    assert g.T < THREADS and g.rpt == 1
    assert g.on == (1 << NUM | 1 << OK | 1 << NULL | 1 << RV)
    g = check(program, _cut(pages.arrays, 300, 3), expr, place="odd",
              seed=4, grid=2)
    assert g.T < THREADS


def test_count_star_over_many_tiles_a_block():
    # COUNT(*) with no WHERE stages rowvalid alone, the widest tile; a
    # block walks many items, and its counts meet per page
    program, pages = _lineitem(2500, "SELECT COUNT(*) FROM S3Object")
    arrays = _cut(pages.arrays, 2048, 9)
    g = check(program, arrays, "count", grid=2)
    assert g.on == 1 << RV
    assert g.T == ROWS * THREADS and g.items > 4 * STAGES


def test_read_set_is_what_must_move_counts():
    # over data where every slot takes every state (parses, text, null) in
    # every combination and every length, the slots whose bytes
    # scan_cases.needs asks for are the read set the kernel derives
    programs = [p for fmt in ("CSV", "JSON") for width in (0, 30)
                for _e, p, _pg, _q, _r in sc.page_cases(fmt, width,
                                                       500 + width, 25)]
    for where in sc.ORACLE_WHERE:
        programs.append(scan_program.program_for(compile_plan(sql.parse(
            f"SELECT COUNT(*), COUNT(s) FROM S3Object WHERE {where}"),
            "CSV")))
    for program in programs:
        C = max([s for s in _slots(program.prog)] + list(program.cspec)
                + [0]) + 1
        W = 16
        arrays = _every_state(C, W)
        need = sc.needs(program, arrays, np.ones(arrays["rowvalid"].shape,
                                                 bool))
        rs = read_set(Blob(program), W)
        for name, key in (("num", "num"), ("ok", "ok"), ("null", "null"),
                          ("slen", "slen")):
            got = sum(1 << s for s in range(C) if need[key][..., s].any())
            assert got == rs[name], (program.prog, name)
        got = sum(1 << s for s in range(C)
                  if need["sb_bytes"][..., s].any())
        assert got == rs["sb"], program.prog


def _slots(prog) -> list:
    """Every slot a plan's program names."""
    if isinstance(prog, (tuple, list)):
        if prog and prog[0] == "col":
            return [prog[1]]
        if prog and prog[0] in ("isnull", "like"):
            return [prog[1]] + [s for x in prog[2:] for s in _slots(x)]
        return [s for x in prog for s in _slots(x)]
    return []


def _every_state(C: int, W: int) -> dict:
    """One page whose rows take each of (parses, text, null) per slot in
    every combination, at every string length 0..W."""
    combos = np.array(np.meshgrid(*[np.arange(3)] * C,
                                  indexing="ij")).reshape(C, -1).T
    states = np.repeat(combos, W + 1, axis=0)
    lens = np.tile(np.arange(W + 1), len(combos))
    R = len(states)
    sb = np.zeros((1, R, C, W), np.uint8)
    sb[..., :] = np.arange(W, dtype=np.uint8) % 26 + 97
    return {"num": np.ones((1, R, C)), "ok": (states == 0)[None],
            "null": (states == 2)[None],
            "slen": np.where(states == 2, 0, lens[:, None])[None]
            .astype(np.int32),
            "sb": sb, "rowvalid": np.ones((1, R), bool)}


def test_launcher_budgets():
    # a blob that with two stages of kThreads rows passes the budget goes
    # to global memory; so does one beside wide pages; a row past the
    # two-block budget takes one block a multiprocessor; past that, none
    small, big = 4_000, 70_000
    assert launcher(small, 2, 2, 3, 16) == (True, BUDGET_TWO)
    assert launcher(big, 2, 2, 3, 16) == (False, BUDGET_TWO)
    assert launcher(small, 2, 2, 4, 128)[0] is False
    wide = (BUDGET_TWO // 2) // (14 + 1024) + 2
    assert launcher(small, 2, 2, wide, 1024) == (False, BUDGET_ONE)
    assert launcher(small, 2, 2, 4 * wide, 1024) is None


def test_programs_past_the_budget_take_the_global_path():
    rng = random.Random(8)
    data = sc.csv_corpus(rng, 60, edge=True, width=60)
    rows = sc.rows_of(data, "CSV")
    for n in (100, 800):
        items = ", ".join(f"'{'w' * 60}{i}'" for i in range(n))
        expr = (f"SELECT COUNT(*), COUNT(b) FROM S3Object WHERE "
                f"a IN ({items}, 25, 'x') OR b NOT IN ({items})")
        plan = compile_plan(sql.parse(expr), "CSV")
        program = scan_program.program_for(plan)
        pages = pager.build_pages(rows, plan)
        arrays = _cut(pages.arrays, 700)
        B, R, C, W = arrays["sb"].shape
        shared, _smem = launcher(program.blob.nbytes, len(program.cspec),
                                 program.max_vals, C, W)
        assert shared == (n == 100)
        check(program, arrays, expr)


def test_contains_at_every_offset():
    # the first-byte filter against a plain search, the needle at every
    # offset of the cell including the last, and nowhere
    rng = np.random.default_rng(5)
    for W in (8, 16, 64):
        for _ in range(200):
            L = int(rng.integers(1, W + 1))
            s = int(rng.integers(0, W + 1))
            raw = rng.integers(97, 100, W, dtype=np.uint8)
            needle = bytes(rng.integers(97, 100, L, dtype=np.uint8))
            if s >= L and rng.random() < 0.7:
                off = int(rng.integers(0, s - L + 1))
                raw[off:off + L] = np.frombuffer(needle, np.uint8)
            raw[s:] = 0
            cell = raw.tobytes()
            got = contains(
                lambda k: struct.unpack_from("<Q", cell, 8 * k)[0],
                lambda off, k: cell[off:off + k], s, W, needle)
            want = any(cell[o:o + L] == needle
                       for o in range(0, min(s, W) - L + 1))
            assert got == want, (cell, s, needle)
