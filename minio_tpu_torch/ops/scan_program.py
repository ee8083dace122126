"""Flatten a scan plan into the postfix code of the card's interpreter.

The reference traces each plan signature into its own XLA program
(minio_tpu/scan/kernels.py:292-314). The port has one generic kernel
(csrc/scan_eval.cu) that runs any plan: the host flattens the plan's
predicate tree (scan/plan.py) once per signature into a postfix
instruction array, a float64 literal pool and a byte pool, and the kernel
interprets that program for every row. Programs are cached by signature in
an LRU of MINIO_TPU_SCAN_KERNEL_CACHE entries, as the reference bounds its
trace cache (its signatures bake in query literals).

The program blob is one byte array the kernel reads (from shared memory
when it fits there); where each part starts is the Program's ``parts``,
which the launcher takes as arguments:

  int32 code[ncode]  instructions, each an opcode and its immediates
  int32 cspec[ncnt]  COUNT specs: -1 for COUNT(*), else the counted slot
  f64   lnum[nlit]   each literal's number (0 where it does not parse)
  int32 lmeta[3*nlit] each literal's (ok, byte offset, byte length)
  u8    lbytes[]     literal bytes, each padded with zeros to 8 bytes

Opcodes (the value stack holds comparison sides, the bool stack
predicates):

  TRUE, FALSE           push a bool
  AND, OR, NOT          pop one or two bools, push one
  COL slot              push the row's cell of `slot` (number, ok, null,
                        string)
  LIT i                 push literal i
  ARITH op              pop b, a; push a op b (number only)
  CMP op                pop b, a; push the comparison
  NOTNULL               pop a side; push "not null"
  ISNULL slot           push null[slot]
  LIKE slot kind i      push the LIKE of `slot` against literal i's bytes,
                        already ANDed with "not null" (kind: exact, prefix,
                        suffix, contains, any)

IN becomes an OR chain of CMP("="), BETWEEN "not null AND >= AND <=", and
NOT IN / NOT BETWEEN / NOT LIKE a trailing NOT, as the reference's tree
walk has them (scan/kernels.py:255-287).

The kernel's stacks have fixed depths, MAX_VALS and MAX_BOOLS: the build
passes these to nvcc (ops/kernels.py), so they are written down here only.
A deeper program is refused here, before any launch, as a counted Decline
("program-depth"): the request then goes to the CPU evaluator. A program
of any size runs.
"""

from __future__ import annotations

import collections
import struct
import threading

import numpy as np

from ..scan.plan import Decline
from ..utils import knobs

# the depths of the kernel's value and bool stacks (csrc/scan_eval.cu is
# built with them as SCAN_MAX_VALS and SCAN_MAX_BOOLS)
MAX_VALS = 8
MAX_BOOLS = 32

OP_TRUE, OP_FALSE, OP_AND, OP_OR, OP_NOT = 1, 2, 3, 4, 5
OP_COL, OP_LIT, OP_ARITH, OP_CMP = 6, 7, 8, 9
OP_NOTNULL, OP_ISNULL, OP_LIKE = 10, 11, 12

ARITH_OPS = {"+": 0, "-": 1, "*": 2, "/": 3, "%": 4}
CMP_OPS = {"=": 0, "!=": 1, "<>": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
LIKE_KINDS = {"exact": 0, "prefix": 1, "suffix": 2, "contains": 3,
              "any": 4}


class Program:
    """One plan's flattened program: the tree it came from (the plain
    version walks it), the COUNT specs, the blob the kernel runs and
    where its parts start (``parts``: the byte offset of code, ncode, of
    cspec, ncnt, and of lnum, lmeta and lbytes, in the launcher's order),
    and the stack depths it needs."""

    __slots__ = ("signature", "prog", "cspec", "blob", "parts", "max_vals",
                 "max_bools", "on_device")

    def __init__(self, signature: str, prog: tuple, cspec: tuple,
                 blob: np.ndarray, parts: tuple, max_vals: int,
                 max_bools: int):
        self.signature = signature
        self.prog = prog
        self.cspec = cspec
        self.blob = blob
        self.parts = parts
        self.max_vals = max_vals
        self.max_bools = max_bools
        # device -> the blob as a uint8 tensor there (ops/scan_cuda)
        self.on_device: dict = {}


class _Flattener:
    def __init__(self):
        self.code: list[int] = []
        self.lits: list[tuple] = []        # (num, ok, bytes)
        self.vals = self.bools = 0
        self.max_vals = self.max_bools = 0

    def _stack(self, dvals: int, dbools: int) -> None:
        self.vals += dvals
        self.bools += dbools
        self.max_vals = max(self.max_vals, self.vals)
        self.max_bools = max(self.max_bools, self.bools)

    def lit(self, num: float, ok: bool, sform: bytes) -> int:
        self.lits.append((num, ok, sform))
        return len(self.lits) - 1

    def side(self, side: tuple) -> None:
        kind = side[0]
        if kind == "col":
            self.code += [OP_COL, side[1]]
            self._stack(1, 0)
        elif kind == "nlit":
            self.code += [OP_LIT, self.lit(side[1], True, side[2])]
            self._stack(1, 0)
        elif kind == "slit":
            b = side[1]
            try:
                nv, ok = float(b.decode("utf-8")), True
            except ValueError:
                nv, ok = 0.0, False
            self.code += [OP_LIT, self.lit(nv, ok, b)]
            self._stack(1, 0)
        elif kind == "arith":
            self.side(side[2])
            self.side(side[3])
            self.code += [OP_ARITH, ARITH_OPS[side[1]]]
            self._stack(-1, 0)
        else:
            raise ValueError(f"bad scan program side {kind!r}")

    def cmp(self, op: str, a: tuple, b: tuple) -> None:
        self.side(a)
        self.side(b)
        self.code += [OP_CMP, CMP_OPS[op]]
        self._stack(-2, 1)

    def bool_op(self, op: int) -> None:
        self.code.append(op)
        self._stack(0, -1 if op in (OP_AND, OP_OR) else 0)

    def node(self, prog: tuple) -> None:
        kind = prog[0]
        if kind == "true":
            self.code.append(OP_TRUE)
            self._stack(0, 1)
        elif kind in ("and", "or"):
            self.node(prog[1])
            self.node(prog[2])
            self.bool_op(OP_AND if kind == "and" else OP_OR)
        elif kind == "not":
            self.node(prog[1])
            self.bool_op(OP_NOT)
        elif kind == "cmp":
            self.cmp(prog[1], prog[2], prog[3])
        elif kind == "in":
            _k, x, items, negate = prog
            if not items:
                self.code.append(OP_FALSE)
                self._stack(0, 1)
            for i, item in enumerate(items):
                self.cmp("=", x, item)
                if i:
                    self.bool_op(OP_OR)
            if negate:
                self.bool_op(OP_NOT)
        elif kind == "between":
            _k, x, lo, hi, negate = prog
            self.side(x)
            self.code.append(OP_NOTNULL)
            self._stack(-1, 1)
            self.cmp(">=", x, lo)
            self.bool_op(OP_AND)
            self.cmp("<=", x, hi)
            self.bool_op(OP_AND)
            if negate:
                self.bool_op(OP_NOT)
        elif kind == "isnull":
            _k, slot, negate = prog
            self.code += [OP_ISNULL, slot]
            self._stack(0, 1)
            if negate:
                self.bool_op(OP_NOT)
        elif kind == "like":
            _k, slot, lkind, needle, negate = prog
            self.code += [OP_LIKE, slot, LIKE_KINDS[lkind],
                          self.lit(0.0, False, needle)]
            self._stack(0, 1)
            if negate:
                self.bool_op(OP_NOT)
        else:
            raise ValueError(f"bad scan program node {kind!r}")


def count_specs(plan) -> tuple:
    """The plan's COUNT projections as kernel specs (-1 for COUNT(*), the
    slot for COUNT(col)), in projection order, non-aggregate entries
    left out."""
    return tuple(-1 if c == "star" else int(c)
                 for c in (plan.counts or ()) if c is not None)


def flatten(plan) -> Program:
    """The plan's Program. Raises Decline("program-depth") when a stack
    of the kernel would overflow."""
    b = _Flattener()
    b.node(plan.prog)
    if b.max_vals > MAX_VALS or b.max_bools > MAX_BOOLS:
        raise Decline("program-depth",
                      f"program needs {b.max_vals} values and "
                      f"{b.max_bools} bools on the kernel's stacks "
                      f"(limits {MAX_VALS}, {MAX_BOOLS})")
    cspec = count_specs(plan)
    lbytes = bytearray()
    lmeta: list[int] = []
    for _num, ok, sform in b.lits:
        lmeta += [int(ok), len(lbytes), len(sform)]
        lbytes += sform + bytes(-len(sform) % 8)
    ncode, ncnt, nlit = len(b.code), len(cspec), len(b.lits)
    off_code = 0
    off_cspec = off_code + 4 * ncode
    off_lnum = off_cspec + 4 * ncnt
    off_lnum += -off_lnum % 8
    off_lmeta = off_lnum + 8 * nlit
    off_lbytes = off_lmeta + 12 * nlit
    off_lbytes += -off_lbytes % 8
    total = off_lbytes + len(lbytes)
    total += -total % 16
    blob = bytearray(total)
    struct.pack_into(f"<{ncode}i", blob, off_code, *b.code)
    struct.pack_into(f"<{ncnt}i", blob, off_cspec, *cspec)
    struct.pack_into(f"<{nlit}d", blob, off_lnum, *(n for n, _o, _s in b.lits))
    struct.pack_into(f"<{3 * nlit}i", blob, off_lmeta, *lmeta)
    blob[off_lbytes:off_lbytes + len(lbytes)] = lbytes
    parts = (off_code, ncode, off_cspec, ncnt, off_lnum, off_lmeta,
             off_lbytes)
    return Program(plan.signature, plan.prog, cspec,
                   np.frombuffer(bytes(blob), np.uint8), parts, b.max_vals,
                   b.max_bools)


_mu = threading.Lock()
_PROGRAMS: collections.OrderedDict = collections.OrderedDict()


def program_for(plan) -> Program:
    """The cached Program of `plan` (flattened at first sight of its
    signature); raises Decline as flatten() does."""
    cap = max(1, knobs.get_int("MINIO_TPU_SCAN_KERNEL_CACHE"))
    with _mu:
        prog = _PROGRAMS.get(plan.signature)
        if prog is not None:
            _PROGRAMS.move_to_end(plan.signature)
            return prog
    prog = flatten(plan)
    with _mu:
        _PROGRAMS[plan.signature] = prog
        while len(_PROGRAMS) > cap:
            _PROGRAMS.popitem(last=False)
    return prog
