"""Rehearsal of csrc/chacha20.cu's tiles, staging and realignment, in Python.

The kernel's index arithmetic is restated by hand over a flat byte array
that stands for device memory: the entry point's tile count and package
length, each tile's package table and counters, the 16-byte granules it
stages into its padded input buffer, the whole-word and funnel-shift
realignment of each thread's 64 bytes, the span-aligned output buffer, and
the store phase's whole granules and byte-exact head and tail. The
keystream words come from chacha20_plain.keystream, taken at the block
index the restated package and counter name, so a wrong counter, package
or byte shift shows as a wrong byte. Staged bytes outside the tile are
replaced by noise (another tile may have written them, in place), and the
buffers start as noise (uninitialised shared memory). Every case must
equal chacha20_plain.keystream_xor and the JAX reference
(minio_tpu.ops.chacha20_jax keystream_xor / xor_packages) byte for byte;
no granule without a byte of its tile's span may be read, and every span
byte must be written exactly once, by whole aligned granules inside the
tile or single bytes, and nothing else. The kernel itself runs only on
the card (tests/test_torch_cuda.py); keep these functions in step with
the source by hand. The tile geometry (kThreads, kMaxTiles) is read from
the source, and test_geometry_is_the_sources fails when the formulas that
derive the rest from it change.
"""

import os
import re

import numpy as np
import pytest
import torch

from minio_tpu.ops import chacha20_jax as ref_jax
from minio_tpu_torch.ops import chacha20_cuda, chacha20_plain, kernels

with open(os.path.join(kernels._CSRC, kernels.SOURCES["chacha20"])) as _f:
    SOURCE = _f.read()


def constant(name: str) -> str:
    """The value of `constexpr int name = ...;` in csrc/chacha20.cu."""
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, f"no constant {name} in chacha20.cu"
    return m.group(1).strip()


THREADS = int(constant("kThreads"))
TILE_BLOCKS = THREADS
TILE = 64 * TILE_BLOCKS
GRANULES = TILE // 16 + 1
BUF_SLOTS = GRANULES + (GRANULES - 1) // 4
MAX_TILES = int(constant("kMaxTiles"))
# a thread's granules 4i + j, j = 0..4, at slots 5i + THREAD_SLOTS[j]
THREAD_SLOTS = np.array([0, 1, 2, 3, 5])


def pad(g):
    """Buffer slot of granule g."""
    return g + (g >> 2)


def realign(v: np.ndarray, k: int, sh: int) -> np.ndarray:
    """Words at byte 4k + sh / 8 of the little-endian words v (rows of
    at least k + 17 words when sh, k + 16 when not)."""
    w = v.shape[1] - k - 1
    if not sh:
        return v[:, k:k + w]
    return (v[:, k:k + w] >> np.uint32(sh)) | \
        (v[:, k + 1:k + 1 + w] << np.uint32(32 - sh))


def pkg_blocks_of(pkg_bytes: int) -> int:
    """The entry point's package length in blocks."""
    return min(pkg_bytes // 64, 0x7FFFFFFF)


def run_tile(mem, src, dst, span, t, pb, ks_row, plain_pb, rng, log):
    """Tile t of one row whose span starts at addresses src (input) and
    dst (output) of mem; ks_row: the row's plain keystream words, block j
    of package j // plain_pb, counter 1 + j % plain_pb."""
    t0 = t * TILE
    n = min(span - t0, TILE)
    src, dst = src + t0, dst + t0
    o_in, o_out = src & 15, dst & 15
    # staging: granules of the tile's input bytes
    pieces = (o_in + n + 15) >> 4
    g = np.arange(pieces)
    gaddr = src - o_in + 16 * g
    log["reads"].append((gaddr, src, n))
    ibuf = rng.integers(0, 256, (BUF_SLOTS, 16), dtype=np.uint8)
    byte_addr = gaddr[:, None] + np.arange(16)
    staged = mem[byte_addr]
    outside = (byte_addr < src) | (byte_addr >= src + n)
    staged[outside] = rng.integers(0, 256, int(outside.sum()),
                                   dtype=np.uint8)
    ibuf[pad(g)] = staged
    # packages of the tile: the nonce table p0 .. p0 + np - 1
    b0 = t * TILE_BLOCKS
    nb = (n + 63) >> 6
    p0 = b0 // pb
    n_pk = (b0 + nb - 1) // pb - p0 + 1
    assert 1 <= n_pk <= TILE_BLOCKS
    # a thread past the span (a tile cut by it) computes a block too: its
    # package stays inside the table's room
    every = b0 + np.arange(TILE_BLOCKS)
    assert (every // pb - p0 < TILE_BLOCKS).all()
    obuf = rng.integers(0, 256, (BUF_SLOTS, 16), dtype=np.uint8)
    i = np.arange(nb)                       # threads whose block is stored
    blk = b0 + i
    pkg = blk // pb
    assert ((pkg - p0 >= 0) & (pkg - p0 < n_pk)).all()
    ctr = 1 + blk - pkg * pb
    assert ((ctr >= 1) & (ctr <= pb)).all()
    ks = ks_row[pkg * plain_pb + ctr - 1]                  # (nb, 16)
    # the thread's input words: 4 granules when aligned, else 5
    k, sh = o_in >> 2, 8 * (o_in & 3)
    slots = THREAD_SLOTS if (k or sh) else THREAD_SLOTS[:4]
    raw = ibuf[5 * i[:, None] + slots].reshape(nb, -1)
    v = np.concatenate([raw, rng.integers(0, 256, (nb, 80 - raw.shape[1]),
                                          dtype=np.uint8)], 1).view("<u4")
    d = realign(v, k, sh)[:, :16] ^ ks
    obuf[5 * i[:, None] + np.arange(4)] = \
        d.astype("<u4").view(np.uint8).reshape(nb, 4, 16)
    # store phase
    x = (16 - o_out) & 15
    k, sh = x >> 2, 8 * (x & 3)
    q = np.arange((o_out + n + 15) >> 4)
    x0 = 16 * q - o_out
    whole = (x0 >= 0) & (x0 + 16 <= n)
    a = x0[whole] >> 4
    v = obuf[pad(a)].view("<u4")
    if k or sh:
        v = np.concatenate([v, obuf[pad(a + 1)].view("<u4")], 1)
    else:
        v = np.concatenate([v, np.zeros_like(v)], 1)
    w = realign(v, k, sh)[:, :4].astype("<u4").view(np.uint8)
    at = dst - o_out + 16 * q[whole]
    assert (at % 16 == 0).all()
    mem[at[:, None] + np.arange(16)] = w
    log["whole"].append(at)
    ob = obuf.reshape(-1)
    for xq in x0[~whole]:
        for e in range(max(xq, 0), min(xq + 16, n)):
            mem[dst + e] = ob[16 * pad(e >> 4) + (e & 15)]
            log["bytes"].append(dst + e)


def launch(mem, in_addr, in_stride, out_addr, out_stride, n_rows, span,
           keys, nonces, pkg_bytes, seed=0):
    """The entry point and kernel over mem; returns the access log."""
    pb = pkg_blocks_of(pkg_bytes)
    plain_pb = pkg_bytes // 64
    nblk = -(-span // 64)
    ks = chacha20_plain.keystream(keys, nonces, 64 * nblk, pkg_bytes)
    ks = ks.numpy().view("<u4").reshape(n_rows, nblk, 16)
    rng = np.random.default_rng(seed)
    log = {"reads": [], "whole": [], "bytes": []}
    tiles = -(-span // TILE)
    assert tiles <= MAX_TILES
    for row in range(n_rows):
        for t in range(tiles):
            run_tile(mem, in_addr + row * in_stride,
                     out_addr + row * out_stride, span, t, pb, ks[row],
                     plain_pb, rng, log)
    return log


def check_log(log, out_addr, out_stride, n_rows, span):
    """Each staged granule holds a byte of its tile's span; each span byte
    is written once and nothing else is."""
    for gaddr, src, n in log["reads"]:
        assert (gaddr % 16 == 0).all()
        assert ((gaddr + 16 > src) & (gaddr < src + n)).all()
    written = np.concatenate(
        [(a[:, None] + np.arange(16)).reshape(-1) for a in log["whole"]]
        + [np.array(log["bytes"], dtype=np.int64)])
    want = (out_addr + out_stride * np.arange(n_rows)[:, None]
            + np.arange(span)).reshape(-1)
    assert len(written) == len(want)
    assert np.array_equal(np.sort(written), np.sort(want))


def words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def run_case(n_rows, span, in_off, in_stride, out_off, out_stride,
             pkg_bytes, seed, in_place=False, jax_check=True):
    """Rows of `span` bytes at in_off (+ r * in_stride) and out_off of a
    noise-filled memory; the restated kernel against chacha20_plain and
    the JAX reference, bytes outside the span unchanged."""
    rng = np.random.default_rng(seed)
    p = -(-span // pkg_bytes)
    kw, nw = words(rng, (n_rows, 8)), words(rng, (n_rows, p, 3))
    keys, nonces = chacha20_cuda.words(kw, "cpu"), \
        chacha20_cuda.words(nw, "cpu")
    in_addr = 64 + in_off
    in_end = in_addr + (n_rows - 1) * in_stride + span
    if in_place:
        out_addr, out_stride = in_addr, in_stride
    else:
        out_addr = ((in_end + 64) & ~15) + out_off
    end = max(in_end, out_addr + (n_rows - 1) * out_stride + span) + 64
    mem = rng.integers(0, 256, end, dtype=np.uint8)
    before = mem.copy()
    rows_in = np.stack([before[in_addr + r * in_stride:][:span]
                        for r in range(n_rows)])
    log = launch(mem, in_addr, in_stride, out_addr, out_stride, n_rows,
                 span, keys, nonces, pkg_bytes, seed)
    check_log(log, out_addr, out_stride, n_rows, span)
    got = np.stack([mem[out_addr + r * out_stride:][:span]
                    for r in range(n_rows)])
    want = chacha20_plain.keystream_xor(torch.from_numpy(rows_in), keys,
                                        nonces, pkg_bytes).numpy()
    assert np.array_equal(got, want)
    if jax_check:
        full = np.zeros((n_rows, p * pkg_bytes), np.uint8)
        full[:, :span] = rows_in
        ref = np.asarray(ref_jax.keystream_xor(full, kw, nw, pkg_bytes))
        assert np.array_equal(got, ref[:, :span])
    # nothing outside the output rows' spans changed
    expect = before.copy()
    for r in range(n_rows):
        expect[out_addr + r * out_stride:][:span] = got[r]
    assert np.array_equal(mem, expect)
    return log


# two tiles a row, the second cut mid-tile and mid-block (12,325 % 64 =
# 37), four packages of 4,096 B; rows 5 and 11 bytes longer than the span,
# so each row of a case starts at another offset mod 16
PAIR_SPAN, PAIR_PKG = TILE + 4096 + 37, 4096


@pytest.mark.parametrize("out_off", range(16))
@pytest.mark.parametrize("in_off", range(16))
def test_every_offset_pair(in_off, out_off):
    run_case(3, PAIR_SPAN, in_off, PAIR_SPAN + 5, out_off, PAIR_SPAN + 11,
             PAIR_PKG, 16 * in_off + out_off)


@pytest.mark.parametrize("off", range(16))
def test_in_place(off):
    run_case(3, PAIR_SPAN, off, PAIR_SPAN + 7, 0, 0, PAIR_PKG, 300 + off,
             in_place=True)


@pytest.mark.parametrize("span", [1, 15, 16, 17, 63, 64, 65, 100, 1000,
                                  TILE - 64, TILE - 1, TILE, TILE + 1,
                                  TILE + 64, 2 * TILE + 200, 3 * TILE - 17])
def test_spans_cut_mid_block_and_mid_tile(span):
    # rows longer than the span, at offsets 3 and 9 mod 16; packages of 64
    # B (a package per block: the nonce table holds every block's) and of
    # 65,536 B
    for pkg in (64, 65536):
        run_case(2, span, 3, span + 21, 9, span + 50, pkg, span + pkg,
                 jax_check=pkg == 65536)


@pytest.mark.parametrize("length", [1, 40, 64, 129, 1000, 4097])
def test_rows_shorter_than_one_tile(length):
    # the row is the span: the tail granule of one row is the head of the
    # next, and the last row ends the memory's tensor
    run_case(5, length, 1, length, 6, length, 4096, length)
    run_case(5, length, 13, length, 0, 0, 4096, length + 1, in_place=True)


def test_encode_launch_stride():
    # the PUT's flat (B, k*S) rows at 12+4 with 1 MiB blocks: 8 rows of
    # 1,048,584 B, the 1 MiB span in 16 packages of 65,536 B; rows start
    # at offsets 0 and 8 mod 16
    stride, span = 1048584, 1 << 20
    log = run_case(8, span, 0, stride, 0, stride, 65536, 7)
    assert len(log["reads"]) == 8 * span // TILE
    # only the tiles of rows at offset 8 have a head and a tail granule
    assert len(log["bytes"]) == 4 * (span // TILE) * 16


def test_get_batch_equals_xor_packages():
    # GET's decipher batch: 64 packages of 65,536 B, one a row, the last
    # one short and zero-padded, in place as in crypto's decipher
    n, width = 64, 65536
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 256, (n, width), dtype=np.uint8)
    rows[-1, 1000:] = 0
    kw, nw = words(rng, (n, 8)), words(rng, (n, 3))
    mem = np.concatenate([np.zeros(64, np.uint8), rows.reshape(-1),
                          np.zeros(64, np.uint8)])
    log = launch(mem, 64, width, 64, width, n, width,
                 chacha20_cuda.words(kw, "cpu"),
                 chacha20_cuda.words(nw[:, None], "cpu"), width)
    check_log(log, 64, width, n, width)
    got = mem[64:64 + n * width].reshape(n, width)
    assert not log["bytes"]
    assert np.array_equal(got, ref_jax.xor_packages(rows, kw, nw))
    assert np.array_equal(got, chacha20_cuda.xor_packages(
        torch.from_numpy(rows), chacha20_cuda.words(kw, "cpu"),
        chacha20_cuda.words(nw, "cpu")).numpy())


@pytest.mark.parametrize("pkg_bytes", [64, 128, 4096, 65536, 1 << 40])
def test_package_table_covers_every_tile(pkg_bytes):
    # the nonce table of a tile (p0 .. p1) holds the package of each of
    # its blocks and fits its room, and the counter restarts at 1 in each
    # package, for spans up to the longest the entry point takes
    pb = pkg_blocks_of(pkg_bytes)
    for span in (64, TILE + 64, 5 * TILE - 1, MAX_TILES * TILE):
        nblk = -(-span // 64)
        for t in {0, 1, (nblk - 1) // TILE_BLOCKS}:
            b0 = t * TILE_BLOCKS
            if b0 >= nblk:
                continue
            nb = min(nblk - b0, TILE_BLOCKS)
            p0 = b0 // pb
            n_pk = (b0 + nb - 1) // pb - p0 + 1
            assert n_pk <= TILE_BLOCKS
            blk = b0 + np.arange(nb)
            pkg = blk // pb
            assert pkg.min() == p0 and pkg.max() - p0 == n_pk - 1
            ctr = 1 + blk - pkg * pb
            assert np.array_equal(ctr, 1 + blk % (pkg_bytes // 64))
            assert blk.max() < 1 << 31 and (b0 + nb - 1) < 1 << 32


def test_padded_buffer_is_free_of_bank_conflicts():
    # a 16-byte shared access serves eight lanes at a time; eight
    # neighbouring threads' granule j must fall in eight distinct 16-byte
    # bank groups (slot mod 8), for the input reads (j = 0..4) and the
    # output writes (j = 0..3)
    for lane0 in range(0, THREADS, 8):
        i = lane0 + np.arange(8)
        for j in range(5):
            assert len(set((5 * i + THREAD_SLOTS[j]) % 8)) == 8
            assert np.array_equal(5 * i + THREAD_SLOTS[j], pad(4 * i + j))
    assert pad(GRANULES - 1) == BUF_SLOTS - 1


def test_geometry_is_the_sources():
    # the restatement derives the tile, buffer and padding from kThreads as
    # the kernel does; a change of those formulas must reach this file
    assert constant("kTileBlocks") == "kThreads"
    assert constant("kTile") == "64 * kTileBlocks"
    assert constant("kGranules") == "kTile / 16 + 1"
    assert constant("kBufSlots") == "kGranules + (kGranules - 1) / 4"
    assert "return g + (g >> 2);" in SOURCE
    assert "span > static_cast<long long>(kMaxTiles) * kTile" in SOURCE
    # a tile's offsets and block indices stay 32-bit
    assert MAX_TILES * TILE < 1 << 31
