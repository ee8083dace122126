"""Rehearsal of csrc/gf_matmul.cu's tile edges, in Python.

Three pure functions of the source are restated by hand: the host's tile
width rule (`gf_matmul_launch`), which words phase (a) copies for an
aligned 16-byte piece (`stage_piece`), and which bytes phase (c) stores
whole or one by one (`store_tile`). They are checked over every start
offset mod 16: no word without a tensor byte is read, every tile byte is
staged, and each output byte is stored by exactly one tile, whole pieces
only where the piece lies inside the tile. The coding itself, and the
kernel as built, are left to the card tests (tests/test_torch_cuda.py).
Keep these functions in step with the source by hand.
"""

import numpy as np
import pytest

THREADS, WORDS = 256, 4
TILE = 4 * WORDS * THREADS
MIN_TILE = 1024


def tile_width(batch: int, s: int, resident: int) -> int:
    widest = batch * -(-s // TILE)
    waves = -(-widest // resident)
    per_row = waves * resident // batch
    tile = -(-s // per_row)
    tile = -(-tile // 128) * 128
    return min(max(tile, MIN_TILE), TILE)


def stage_piece(a: int, lo: int, hi: int) -> list[int]:
    """Word addresses phase (a) copies for the aligned piece at `a` of a
    tensor at [lo, hi)."""
    if a + 4 > lo and a + 12 < hi:
        return [a, a + 4, a + 8, a + 12]
    return [a + w for w in range(0, 16, 4) if a + w + 4 > lo and a + w < hi]


def store_tile_row(row: int, n: int) -> list[tuple[int, int, bool]]:
    """(first byte, bytes, whole) of each store phase (c) makes for the n
    bytes of one output row tile starting at address `row`."""
    off = row & 15
    stores = []
    for q in range((off + n + 15) >> 4):
        x0 = 16 * q - off
        if x0 >= 0 and x0 + 16 <= n:
            stores.append((row + x0, 16, True))
        else:
            e0, e1 = max(x0, 0), min(x0 + 16, n)
            stores += [(row + e, 1, False) for e in range(e0, e1)]
    return stores


def _tiles(batch, rows, s, resident):
    tile = tile_width(batch, s, resident)
    per_row = -(-s // tile)
    for t in range(batch * per_row):
        b, c0 = divmod(t, per_row)
        c0 *= tile
        for i in range(rows):
            yield (b * rows + i) * s + c0, min(tile, s - c0)


@pytest.mark.parametrize("in_off", range(16))
def test_every_start_offset(in_off):
    # B=2, k=3, S=4,097 puts neighbouring rows at different offsets;
    # resident 3 narrows the tiles to several per row
    batch, k, s = 2, 3, 4097
    lo = 64 + in_off
    hi = lo + batch * k * s
    staged = np.zeros(hi + 64, np.int32)
    for start, n in _tiles(batch, k, s, 3):
        row = lo + start
        a0 = row - (row & 15)
        for q in range(((row & 15) + n + 15) >> 4):
            words = stage_piece(a0 + 16 * q, lo, hi)
            assert len(words) in (1, 2, 3, 4)
            for w in words:
                assert w % 4 == 0 and w + 4 > lo and w < hi
                staged[w:w + 4] += 1
        assert (staged[row:row + n] > 0).all()
    assert (staged[lo:hi] > 0).all()


@pytest.mark.parametrize("out_off", range(16))
def test_each_output_byte_stored_once(out_off):
    # parity (r=4) at S=4,097 and at the main path's S=349,526, so that
    # neighbouring rows start 1 and 6 bytes apart mod 16; whole stores only
    # inside a tile
    for batch, r, s, resident in ((3, 4, 4097, 3), (1, 4, 349526, 396)):
        lo = 64 + out_off
        writes = np.zeros(lo + batch * r * s + 64, np.int32)
        for start, n in _tiles(batch, r, s, resident):
            row = lo + start
            first, last = row & ~15, (row + n - 1) & ~15
            for addr, size, whole in store_tile_row(row, n):
                assert row <= addr and addr + size <= row + n
                if whole:
                    assert addr % 16 == 0
                else:               # only in the tile's first or last piece
                    assert addr < first + 16 or addr >= last
                writes[addr:addr + size] += 1
        assert (writes[lo:lo + batch * r * s] == 1).all()
        assert writes.sum() == batch * r * s


@pytest.mark.parametrize("batch,s,resident,tiles", [
    (8, 349526, 396, 784),      # PUT parity and decode at 12+4, 3 blocks/SM
    (32, 87382, 396, 768),      # BASELINE.json's shape
    (8, 349526, 528, 1048),     # four blocks per SM
    (2, 17, 396, 2)])
def test_tile_width_fills_whole_waves(batch, s, resident, tiles):
    tile = tile_width(batch, s, resident)
    assert tile % 128 == 0 and MIN_TILE <= tile <= TILE
    n_tiles = batch * -(-s // tile)
    assert n_tiles == tiles
    widest = batch * -(-s // TILE)
    assert -(-n_tiles // resident) == -(-widest // resident)
