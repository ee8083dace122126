"""The ring index arithmetic of minio_tpu_torch/csrc/hh256.cu, on the host.

A rehearsal, not coverage: the kernel cannot run without a card, so these
pure functions restate its stage_piece rule (which words of a 16-byte
piece are copied), its ring addressing (stream byte x at ring byte
x % ring, the first kMirror bytes again past the end) and load_words' read
window, and check them for every row offset and for lengths around the
chunk size. The kernel itself is held against the plain version by the
`cuda` tests and chip_smoke.py. The geometry is read from the source.
"""

import os
import re

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "minio_tpu_torch", "csrc",
                   "hh256.cu")


def _geometry():
    text = open(SRC).read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", text)
                     .group(1)) for name in ("kChunk", "kDepth", "kMirror"))


CHUNK, DEPTH, MIRROR = _geometry()
RING = CHUNK * DEPTH
SLOT = RING + MIRROR + 16                      # kRowSlot


def stage_piece(x, off, end):
    """Stream bytes stage_piece copies of the piece at stream byte x."""
    if x >= (off & ~3) and x + 16 <= ((end + 3) & ~3):
        words = (0, 4, 8, 12)
    else:
        words = [w for w in (0, 4, 8, 12) if x + w + 4 > off and x + w < end]
    return [x + w + b for w in words for b in range(4)]


def load_window(x):
    """Ring bytes load_words reads for the half-packet at stream byte x."""
    start = (x & (RING - 1)) & ~3
    return range(start, start + 20)


def reads_of_chunk(c, off, full):
    """Stream bytes the packet loop's iteration c reads: its packets and
    the words of the next packet, loaded before the last update."""
    n = min(full - c * (CHUNK // 32), CHUNK // 32)
    x0 = off + c * CHUNK
    return [x + k for h in (0, 16) for j in range(n + 1)
            for x in [x0 + 32 * j + h] for k in range(16)]


def check_row(off, length, pending=DEPTH - 2):
    end = off + length
    copied = set()
    for x in range(0, end, 16):
        got = stage_piece(x, off, end)
        assert all((b & ~3) + 4 > off and (b & ~3) < end for b in got), \
            "copied a word without a row byte"
        copied.update(got)
    assert set(range(off, end)) <= copied
    full = length // 32
    for c in range(-(-full // (CHUNK // 32))):
        # after staging chunk c + DEPTH - 1, a wait leaving `pending`
        # groups in flight has landed the chunks up to c + DEPTH - 1 - pending
        landed = c + DEPTH - 1 - pending
        for y in reads_of_chunk(c, off, full):
            if y >= end:                      # the prefetch past the row
                continue
            assert y // CHUNK <= landed, "read a chunk before its wait"
            # chunk c + DEPTH - 1 is refilling chunk c - 1's stage
            assert y // CHUNK >= c, "read a refilled chunk"
        for x in range(off + c * CHUNK, off + (c + 1) * CHUNK, 16):
            window = load_window(x)
            assert window[-1] < SLOT
            # bytes past the ring come from its mirrored head
            assert all(p < RING + MIRROR for p in window[:16 + (x & 3)])
    if length & 31:
        # the tail is read bytewise after the last wait, from the DEPTH
        # chunks the last iteration left in the ring
        last = -(-full // (CHUNK // 32))
        for y in (off + 32 * full, end - 1):
            assert max(last - 1, 0) <= y // CHUNK <= last + DEPTH - 2


@pytest.mark.parametrize("base", [0, 3, 6, 13])
def test_ring_feeds_every_packet_byte(base):
    lengths = list(range(0, 66)) + [CHUNK - 31, CHUNK - 1, CHUNK, CHUNK + 1,
                                    CHUNK + 31, 3 * CHUNK + 17, 5 * CHUNK]
    for stride in (1031, 349526 // 64, 16):
        for r in range(3):                    # offsets of three rows
            for length in lengths:
                if length <= stride:
                    check_row((base + r * stride) & 15, length)


def test_ring_model_catches_a_missed_wait():
    # a row starting at byte 3: the last packet of each chunk reaches into
    # the next one, which a wait leaving one more group pending misses
    check_row(3, 4000)
    with pytest.raises(AssertionError, match="before its wait"):
        check_row(3, 4000, pending=DEPTH - 1)
