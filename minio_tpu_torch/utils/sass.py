"""What one trip of a kernel's hot loop costs, read from its SASS.

``hot_loop`` finds, in the text ``cuobjdump -sass`` prints, the innermost
loop that holds the wanted instructions, and
``chain_cycles`` walks that loop body under a fixed-latency model to give
the cycles per trip of its longest loop-carried dependency chain: the
floor of a loop whose trips depend on each other, however many threads run
it. The latencies are a model (``LATENCY``), not a measurement; they are
printed beside every floor computed from them. ``packet_loop`` applies
them to hh256's packet loop in a built kernel library, ``block_loop`` to
sha256's loop over 64-byte blocks on its round warp (one trip = one
compression). ``analyse`` also counts a loop's instructions by issue pipe
(``PIPES``, also a model). ``unrolled`` reads a kernel with no hot loop,
all of whose work per thread is one straight run (chacha20's 20 unrolled
rounds): that run's instructions by pipe, its adds on each pipe, and the
subroutine calls left in the function (a 64-bit divide is one).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import subprocess

from ..ops import kernels

# dependent-issue latency in cycles: integer ALU and IMAD pipes, wide
# multiply, shared-memory loads and shuffles, global loads
LATENCY = {"default": 4, "IMAD.WIDE": 5, "LDS": 23, "SHFL": 23, "LDG": 400,
           "S2R": 20}
_NO_DEST = {"ST", "STS", "STG", "STL", "RED", "BRA", "EXIT", "BAR",
            "WARPSYNC", "BSYNC", "BSSY", "LDGSTS", "DEPBAR", "LDGDEPBAR",
            "NOP", "CALL", "RET", "YIELD", "MEMBAR", "ERRBAR", "CCTL",
            "ATOMS", "ARRIVES", "SYNCS"}
# issue pipe of each opcode family on Hopper, from NVIDIA's descriptions
# of the SM sub-partition (a model, not a measurement): the integer ALU
# pipe and the FMA pipe each take two cycles per warp instruction of
# integer work, so a loop bound by one of them issues at half rate.
# VIADD (sm_90's add of an immediate) is counted with the FMA pipe's
# IMAD.IADD, whose work it does.
PIPES = {"alu": ("IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA",
                 "MOV", "IABS", "IMNMX", "FLO", "POPC", "BMSK", "PLOP3"),
         "fma": ("IMAD", "IMUL", "VIADD", "FFMA", "FADD", "FMUL"),
         "mem": ("LDS", "STS", "LDG", "STG", "LDGSTS", "LDL", "STL",
                 "ATOMS", "LDSM")}
# opcodes whose leading predicate output is followed by a register output
_PRED_THEN_REG = {"SHFL", "LOP3", "VOTE"}
_LINE = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"^[-~!|]*(U?R)(\d+)(?:\.reuse)?(\.64)?\|?$")
_PRED = re.compile(r"^!?(U?P)(\d)$")


@dataclasses.dataclass
class Instr:
    addr: int
    opcode: str          # with modifiers, e.g. "IMAD.WIDE.U32"
    dests: list[str]
    srcs: list[str]
    target: int | None   # branch target address

    @property
    def base(self) -> str:
        return self.opcode.split(".")[0]


def _regs(tok: str, width: int) -> list[str]:
    m = _REG.match(tok)
    if m:
        n = int(m.group(2))
        w = 2 if m.group(3) else width
        return [f"{m.group(1)}{n + i}" for i in range(w)]
    m = _PRED.match(tok)
    if m:
        return [f"{m.group(1)}{m.group(2)}"]
    return []


def _operands(text: str) -> list[str]:
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


def _is_pred(tok: str) -> bool:
    return tok.lstrip("!") == "PT" or bool(_PRED.match(tok))


def parse(text: str) -> list[Instr]:
    """Instructions of the SASS text in address order (one function)."""
    lines = [(int(m.group(1), 16), m.group(2))
             for m in map(_LINE.search, text.splitlines()) if m]
    out = []
    for addr, body in lines:
        pred = re.match(r"^@!?(U?P\d)\s+", body)
        body = re.sub(r"^@!?U?P[T\d]\s+", "", body)
        parts = body.split(None, 1)
        opcode = parts[0]
        ops = _operands(parts[1]) if len(parts) > 1 else []
        mods = opcode.split(".")
        base = mods[0]
        wide = base == "IMAD" and "WIDE" in mods
        width = 4 if "128" in mods else 2 if "64" in mods or wide else 1
        target = None
        if base in ("BRA", "BRX", "JMP"):
            for tok in ops:
                if tok.startswith("0x"):
                    target = int(tok, 16)
        dests: list[str] = []
        srcs: list[str] = []
        i = 0
        if base not in _NO_DEST and ops:
            while i < len(ops) and _is_pred(ops[i]):
                dests += _regs(ops[i], 1)
                i += 1
            if i < len(ops) and (i == 0 or base in _PRED_THEN_REG):
                dests += _regs(ops[i], width)
                i += 1
                while i < len(ops) and _is_pred(ops[i]):   # carry outputs
                    dests += _regs(ops[i], 1)
                    i += 1
        for j, tok in enumerate(ops[i:], start=i):
            if "[" in tok:                    # address: 64-bit only if .64
                for part in re.split(r"[\[\]+ ]+", tok):
                    srcs += _regs(part, 1)
            else:           # registers; a wide multiply's addend is a pair
                srcs += _regs(tok, (2 if j == 3 else 1) if wide else width)
        if pred:
            srcs.append(pred.group(1))
        out.append(Instr(addr, opcode, dests, srcs, target))
    return out


def loops(instrs: list[Instr]) -> list[tuple[int, int]]:
    """(first, last) indices of every loop closed by a backward branch."""
    index = {ins.addr: i for i, ins in enumerate(instrs)}
    return [(index[ins.target], i) for i, ins in enumerate(instrs)
            if ins.target is not None and ins.target <= ins.addr
            and ins.target in index]


def hot_loop(instrs: list[Instr], need=("IMAD.WIDE",),
             avoid=("SHFL",)) -> list[Instr]:
    """Body of the innermost loop that holds every opcode prefix in `need`
    and none in `avoid`; among several, the one with the most of need[0]."""
    best, best_n = None, 0
    spans = loops(instrs)
    for a, b in spans:
        if any(a <= c and d <= b and (c, d) != (a, b) for c, d in spans):
            continue                                  # not innermost
        body = instrs[a:b + 1]
        ops = [ins.opcode for ins in body]
        if any(op.startswith(avoid) for op in ops) or not all(
                any(op.startswith(n) for op in ops) for n in need):
            continue
        n = sum(op.startswith(need[0]) for op in ops)
        if n > best_n:
            best, best_n = body, n
    if best is None:
        raise ValueError(f"no loop with {need} and without {avoid}")
    return best


def latency(ins: Instr) -> int:
    for key in (ins.opcode, ".".join(ins.opcode.split(".")[:2]), ins.base):
        if key in LATENCY:
            return LATENCY[key]
    return LATENCY["default"]


def chain_cycles(body: list[Instr], trips: int = 16) -> float:
    """Cycles per trip of the longest loop-carried dependency chain of a
    loop body, with unlimited issue: every instruction starts when its
    sources are ready and delivers after its latency. Walks `trips` trips
    and averages the second half, where the chain has settled."""
    ready: dict[str, float] = {}
    ends = []
    for _ in range(trips):
        end = 0.0
        for ins in body:
            t = max((ready.get(r, 0.0) for r in ins.srcs), default=0.0)
            done = t + latency(ins)
            for r in ins.dests:
                if r not in ("RZ", "PT", "URZ"):
                    ready[r] = done
            end = max(end, done)
        ends.append(end)
    half = trips // 2
    return (ends[-1] - ends[half - 1]) / (trips - half)


def pipe(ins: Instr) -> str:
    """The issue pipe of an instruction under ``PIPES``, else "other"."""
    for name, bases in PIPES.items():
        if ins.base in bases:
            return name
    return "other"


def analyse(text: str, need=("IMAD.WIDE",), avoid=("SHFL",)) -> dict:
    """Hot-loop summary of one function's SASS: its address range, issue
    slots (instructions per trip) and their count by opcode and by pipe,
    the 32-bit adds on each of the ALU (IADD3) and FMA (IMAD.IADD, VIADD)
    pipes, chain cycles per trip, and the latency model."""
    body = hot_loop(parse(text), need, avoid)
    adds = {"alu": sum(i.base == "IADD3" for i in body),
            "fma": sum(i.opcode.startswith(("IMAD.IADD", "VIADD"))
                       for i in body)}
    return {"loop": [hex(body[0].addr), hex(body[-1].addr)],
            "issue_slots": len(body),
            "opcodes": dict(collections.Counter(i.base for i in body)),
            "pipes": dict(collections.Counter(pipe(i) for i in body)),
            "adds": adds,
            "chain_cycles": chain_cycles(body),
            "latency_model": dict(LATENCY)}


def function_text(dump: str, name_part: str) -> str:
    """The SASS of the first function in a cuobjdump listing whose name
    contains `name_part`."""
    chunks = re.split(r"\n\s*Function\s*:\s*", dump)
    for chunk in chunks[1:]:
        if name_part in chunk.split("\n", 1)[0]:
            return chunk
    raise ValueError(f"no function matching {name_part!r} in the listing")


def dump(lib: str) -> str:
    """`cuobjdump -sass` of the shared library at path `lib`."""
    if not os.path.isfile(lib):
        raise FileNotFoundError(f"no kernel library at {lib}")
    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def packet_loop(lib: str) -> dict:
    """``analyse`` of one trip of hh256's packet loop in the kernel library
    at path `lib`: the loop with wide multiplies and shared loads, and
    neither shuffles (finalisation) nor cp.async (staging). Raises when the
    listing cannot be read or holds no such loop."""
    return analyse(function_text(dump(lib), "hh256_kernel"),
                   need=("IMAD.WIDE", "LDS"), avoid=("SHFL", "LDGSTS"))


def sha256_block_loop(text: str) -> dict:
    """``analyse`` of one trip of sha256's block loop (one compression of
    64 rounds) in the SASS of its kernel function. The round warp's loop
    reads W + K from shared memory (LDS) and holds the most funnel shifts
    (the rotates); the producers' loop also stores (STS) and the staging
    loop copies (LDGSTS), so both are passed over. A kernel with no such
    loop (one thread doing schedule and rounds from global loads, as
    before the round warp) is read as its loop with the most funnel
    shifts. Raises when neither is there."""
    try:
        return analyse(text, need=("SHF", "LDS"),
                       avoid=("SHFL", "LDGSTS", "STS"))
    except ValueError:
        return analyse(text, need=("SHF",), avoid=("SHFL",))


def block_loop(lib: str) -> dict:
    """``sha256_block_loop`` of the kernel library at path `lib`. Raises
    when the listing cannot be read or holds no such loop."""
    return sha256_block_loop(function_text(dump(lib), "sha256_kernel"))


def straight_runs(instrs: list[Instr]) -> list[list[Instr]]:
    """The function's basic blocks: runs of instructions entered only at
    their first (a branch target or the instruction after a branch, exit
    or return) and left only at their last."""
    leaders = {0} | {i + 1 for i, ins in enumerate(instrs)
                     if ins.base in ("BRA", "BRX", "JMP", "EXIT", "RET")}
    index = {ins.addr: i for i, ins in enumerate(instrs)}
    leaders |= {index[ins.target] for ins in instrs
                if ins.target is not None and ins.target in index}
    cuts = sorted(i for i in leaders if i < len(instrs)) + [len(instrs)]
    return [instrs[a:b] for a, b in zip(cuts, cuts[1:]) if b > a]


def _fma_add(ins: Instr) -> bool:
    # a plain IMAD in an unrolled run is an add, x * one + y with an
    # opaque one (IMAD.MOV, .SHL, .WIDE and .HI carry modifiers)
    return ins.opcode.startswith(("IMAD.IADD", "VIADD")) or \
        ins.opcode in ("IMAD", "IMAD.U32")


def unrolled(text: str) -> dict:
    """Summary of an unrolled kernel function's SASS: its longest straight
    run (for chacha20 the rounds and feed-forward of one 64-byte block)
    with its instructions by opcode and by pipe and its 32-bit adds on the
    ALU (IADD3) and FMA (IMAD.IADD, VIADD, plain IMAD) pipes; the whole
    function's instructions by pipe (every path counted once); and the
    subroutine calls left in it. nvcc reaches a 64-bit divide or
    remainder through such a call (CALL.REL to __internal_*div*), so
    ``divide64`` is whether any is left."""
    instrs = parse(text)
    run = max(straight_runs(instrs), key=len)
    calls = [ins.opcode for ins in instrs if ins.base == "CALL"]
    return {"run": [hex(run[0].addr), hex(run[-1].addr)],
            "run_instructions": len(run),
            "opcodes": dict(collections.Counter(i.base for i in run)),
            "pipes": dict(collections.Counter(pipe(i) for i in run)),
            "adds": {"alu": sum(i.base == "IADD3" for i in run),
                     "fma": sum(_fma_add(i) for i in run)},
            "function_instructions": len(instrs),
            "function_pipes": dict(collections.Counter(
                pipe(i) for i in instrs)),
            "calls": calls, "divide64": bool(calls)}


def keystream_block(lib: str) -> dict:
    """``unrolled`` of chacha20's kernel in the library at path `lib`.
    Raises when the listing cannot be read or holds no such function."""
    return unrolled(function_text(dump(lib), "chacha20_kernel"))
