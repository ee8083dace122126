"""The staging, realignment, padding and ring protocol of
minio_tpu_torch/csrc/sha256.cu, on the host.

A rehearsal, not coverage: the kernel cannot run without a card, so these
functions restate what its producer warps do to one row (stage_piece's
choice of words, the stage windows, the whole-word shift and byte permute
that realign and byte-swap, the masks that build the padding tail, the
schedule plus K) and what the round warp does with the result, and check
the digest against hashlib for every row offset mod 16 and for lengths
around the ring stage. Bytes of a stage that no copy wrote are random, so
a read of one shows as a wrong digest. A second test walks the named
barriers of the producers and the round warp. The kernel itself is held
against the plain version by the `cuda` tests and chip_smoke.py. The
geometry is read from the source; keep the restatement in step with it.
"""

import hashlib
import os
import random
import re
import struct

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "minio_tpu_torch", "csrc",
                   "sha256.cu")


def _geometry():
    text = open(SRC).read()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text)
                      .group(1))
            for name in ("kProducers", "kGroup", "kSlots")}


GEO = _geometry()
GROUP, PRODUCERS, SLOTS = GEO["kGroup"], GEO["kProducers"], GEO["kSlots"]
STAGE = 64 * GROUP                              # kStageBytes
RAW_PIECES = STAGE // 16 + 1
M32 = 0xffffffff
K = [int(v, 16) for v in re.findall(
    r"0x[0-9a-f]{8}", open(SRC).read().split("kK[64] = {")[1]
    .split("};")[0])]
H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f,
      0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def stage_piece(x, off, end):
    """Stream bytes stage_piece copies of the piece at stream byte x."""
    if x >= (off & ~3) and x + 16 <= ((end + 3) & ~3):
        words = (0, 4, 8, 12)
    else:
        words = [w for w in (0, 4, 8, 12) if x + w + 4 > off and x + w < end]
    return [x + w + b for w in words for b in range(4)]


def byte_perm(lo, hi, sel):
    src = lo | hi << 32
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xff) << (8 * i)
               for i in range(4))


def schedule_block(win, k0, sel, n_b, last, bits):
    """W[t] + K[t] of one block from its 80-byte window."""
    v = list(struct.unpack("<20I", win))
    if k0 & 2:
        v = v[2:] + v[18:]
    if k0 & 1:
        v = v[1:] + v[19:]
    w = [byte_perm(v[j], v[j + 1], sel) for j in range(16)]
    if n_b < 64:
        for j in range(16):
            n = n_b - 4 * j
            keep = M32 if n >= 4 else 0 if n <= 0 else \
                (M32 << (32 - 8 * n)) & M32
            pad = 0x80 << (24 - 8 * n) if 0 <= n < 4 else 0
            w[j] = (w[j] & keep) | pad
        if last:
            w[14], w[15] = bits >> 32, bits & M32
    out = []
    for i in range(64):
        if i >= 16:
            w15, w2 = w[(i - 15) & 15], w[(i - 2) & 15]
            s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3)
            s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10)
            w[i & 15] = (w[i & 15] + s0 + w[(i - 7) & 15] + s1) & M32
        out.append((w[i & 15] + K[i]) & M32)
    return out


def rounds(st, wk):
    a, b, c, d, e, f, g, h = st
    for x in wk:
        hk = (h + x) & M32
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g & M32)
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t1 = (hk + s1 + ch) & M32
        h, g, f = g, f, e
        e = (t1 + d) & M32
        d, c, b = c, b, a
        a = (t1 + s0 + maj) & M32
    return [(x + y) & M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def kernel_digest(mem, addr, length, rng):
    """The digest the kernel computes for the row of `length` bytes at
    address `addr` of `mem` (address -> byte, only the row's bytes)."""
    off = addr & 15
    end = off + length
    n_full = length // 64
    n_blocks = n_full + (2 if length % 64 >= 56 else 1)
    n_stages = -(-n_blocks // GROUP)
    k0, o = off >> 2, off & 3
    sel = (o + 3) | (o + 2) << 4 | (o + 1) << 8 | o << 12
    st = list(H0)
    for s in range(n_stages):
        raw = bytearray(rng.randbytes(16 * RAW_PIECES))   # stale bytes
        for j in range(RAW_PIECES):
            x = s * STAGE + 16 * j
            if x >= end:
                continue
            for y in stage_piece(x, off, end):
                assert (y & ~3) + 4 > off and (y & ~3) < end, \
                    "copied a word without a row byte"
                a = addr - off + y
                raw[y - s * STAGE] = mem.get(a, rng.randrange(256))
        for i in range(min(GROUP, n_blocks - s * GROUP)):
            b = s * GROUP + i
            wk = schedule_block(bytes(raw[64 * i:64 * i + 80]), k0, sel,
                                length - 64 * b, b == n_blocks - 1,
                                length * 8)
            st = rounds(st, wk)
    return b"".join(struct.pack(">I", x) for x in st)


def _lengths():
    out = {0, 1, 55, 56, 63, 64, 65}
    # a stage's bytes -1, +0, +1, and both padding forms ending a stage and
    # crossing into the next one, at the first stage and after a full turn
    # of the producers' slots
    for base in (STAGE, STAGE * PRODUCERS * SLOTS):
        out.update(base + d for d in (-1, 0, 1))
        for r in (55, 56, 63, 64):
            out.update((base - 64 + r, base + r))
    return sorted(out)


@pytest.mark.parametrize("length", _lengths())
def test_producer_path_equals_hashlib_at_every_offset(length):
    rng = random.Random(length)
    for off in range(16):
        addr = 4096 + off
        data = rng.randbytes(length)
        mem = {addr + i: data[i] for i in range(length)}
        assert kernel_digest(mem, addr, length, rng) == \
            hashlib.sha256(data).digest(), f"offset {off}"


def _walk(n_stages):
    """Run the round warp's and the producers' programs in turns until all
    end. A named barrier of 64 threads completes at its second warp; a
    warp that syncs waits for that, one that arrives goes on. Returns the
    stages the round warp read, in order, and each barrier's (arrivals,
    syncs)."""
    progs = {"round": []}
    for s in range(n_stages):
        p, slot = s % PRODUCERS, (s // PRODUCERS) % SLOTS
        progs["round"] += [("sync", ("full", p, slot)),
                           ("read", (p, slot), s)]
        if s + PRODUCERS * SLOTS < n_stages:
            progs["round"].append(("arrive", ("empty", p, slot)))
    for p in range(PRODUCERS):
        prog = progs[p] = []
        for k, s in enumerate(range(p, n_stages, PRODUCERS)):
            slot = k % SLOTS
            if k >= SLOTS:
                prog.append(("sync", ("empty", p, slot)))
            prog += [("write", (p, slot), s), ("arrive", ("full", p, slot))]
    pc = dict.fromkeys(progs, 0)
    phase, blocked, counts, slots, read = {}, {}, {}, {}, []
    while any(pc[w] < len(progs[w]) for w in progs):
        moved = False
        for w, prog in progs.items():
            if pc[w] >= len(prog) or w in blocked:
                continue
            op, arg, *stage = prog[pc[w]]
            pc[w] += 1
            moved = True
            if op == "write":
                slots[arg] = stage[0]
            elif op == "read":
                assert slots.get(arg) == stage[0], "read a stage not written"
                read.append(stage[0])
            else:
                arrived = phase.setdefault(arg, [])
                assert w not in arrived, "a warp arrived twice in one phase"
                arrived.append(w)
                counts.setdefault(arg, [0, 0])[op == "sync"] += 1
                if op == "sync":
                    blocked[w] = arg
                if len(arrived) == 2:
                    phase[arg] = []
                    for ww in [v for v, b in blocked.items() if b == arg]:
                        del blocked[ww]
        assert moved, "deadlock"
    assert not any(phase.values()), "a barrier left half done"
    return read, counts


@pytest.mark.parametrize("n_stages", [1, 2, 3, 5, 6, 7, 12, 13, 31])
def test_ring_protocol_reads_every_stage_in_order(n_stages):
    read, counts = _walk(n_stages)
    assert read == list(range(n_stages))
    for barrier, (arrivals, syncs) in counts.items():
        assert arrivals == syncs, barrier
