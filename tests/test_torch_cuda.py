"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card (tolerance 0: exact bytes). Marked `cuda`: each test
skips, with the reason, on a host without a card; CUDA kernels have no
CPU mode."""

import numpy as np
import pytest
import torch

from minio_tpu_torch.bitrot import MAGIC_HIGHWAYHASH_KEY as KEY
from minio_tpu_torch.models import pipeline
from minio_tpu_torch.ops import (highwayhash_cuda, highwayhash_py, rs_cuda,
                                 rs_matrix)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("s", [0, 1, 17, 16384, 87382])
def test_gf_matmul_kernel_equals_plain(dev, s):
    for k, m in ((4, 2), (12, 4), (16, 16)):
        m2 = rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), dev)
        x = _rand((3, k, s), s, dev)
        before = rs_cuda.gf_matmul.launches
        got = rs_cuda.gf_matmul(m2, x)
        assert torch.equal(got, rs_cuda.gf_matmul_plain(m2, x))
        assert rs_cuda.gf_matmul.launches == before + (1 if s else 0)


@pytest.mark.parametrize("length", [0, 1, 3, 16, 21, 31, 32, 33, 1000])
def test_hh256_kernel_equals_plain(dev, length):
    rows = _rand((8, length + 5), length, dev)
    before = highwayhash_cuda.hh256.launches
    got = highwayhash_cuda.hh256(rows, length, KEY)
    assert torch.equal(got, highwayhash_cuda.hh256_plain(rows, length, KEY))
    assert highwayhash_cuda.hh256.launches == before + 1


def _check_hh256(rows, length, row=-1):
    """Kernel == plain version on every row, and == the scalar
    HighwayHash on one row (the last by default: it may end the tensor)."""
    got = highwayhash_cuda.hh256(rows, length, KEY)
    assert torch.equal(got, highwayhash_cuda.hh256_plain(rows, length, KEY))
    h = highwayhash_py.HighwayHash(KEY)
    h.update(rows[row, :length].cpu().numpy().tobytes())
    assert got[row].cpu().numpy().tobytes() == h.digest256()


@pytest.mark.parametrize("stride", [1031, 349526])
def test_hh256_every_row_offset(dev, stride):
    # 1031 = 7 mod 16 puts 16 rows at every start offset mod 16; 349,526
    # (the main path's S) at every even one; length == row_stride, so the
    # last row ends the tensor (one length there: the plain version walks
    # 10,923 rounds at ~1 ms each)
    rows = _rand((16, stride), stride, dev)
    for length in (stride,) if stride > 2000 else (stride, stride - 1,
                                                   stride - 17):
        _check_hh256(rows, length)


@pytest.mark.parametrize("base", [1, 3, 6, 8, 13, 15])
def test_hh256_offset_views(dev, base):
    flat = _rand((base + 9 * 1031,), base, dev)
    view = flat[base:].view(9, 1031)        # contiguous, starts mid-word
    assert view.data_ptr() % 16 == base % 16
    _check_hh256(view, 1031)
    _check_hh256(view, 1000, row=4)
    sliced = _rand((9, 1040), base, dev)[:, base:].contiguous()
    _check_hh256(sliced, sliced.shape[1])


@pytest.mark.parametrize("chunk", [512, 1024, 2048])
def test_hh256_lengths_around_chunks(dev, chunk):
    for length in (chunk - 31, chunk - 1, chunk, chunk + 1, chunk + 31):
        _check_hh256(_rand((5, length + 3), length, dev), length)


@pytest.mark.parametrize("n_rows", [1, 2, 15, 17, 33, 96, 128, 512, 1100,
                                    9000])
def test_hh256_row_counts(dev, n_rows):
    # past 4 warps per SM, warps take several rows each (1100) and at 16
    # rows per warp the ring needs more than 48 KB of shared memory (9000)
    rows = _rand((n_rows, 1031), n_rows, dev)
    _check_hh256(rows, 1031)
    _check_hh256(rows, 999, row=0)


def test_hh256_shard_inside_longer_rows(dev):
    rows = _rand((4, 349526 + 64), 64, dev)
    _check_hh256(rows, 349526)


def test_put_step_on_card_equals_cpu(dev):
    x = _rand((2, 12, 1031), 5, dev)
    on_card = pipeline.put_step(x, 12, 4, 1000)
    on_cpu = pipeline.put_step(x.cpu(), 12, 4, 1000)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


def test_get_step_hashes_survivors_only(dev):
    k, m = 12, 4
    mask = sum(1 << i for i in range(k + m) if i not in (1, 5, 14))
    dm, used, missing = rs_matrix.missing_data_matrix(k, m, mask)
    bits = rs_cuda.matrix_bits(dm, dev)
    x = _rand((8, k, 1031), 7, dev)
    before = highwayhash_cuda.hh256.launches
    out, dig = pipeline.get_step(x, bits, len(missing), k, 1000)
    assert highwayhash_cuda.hh256.launches == before + 1
    assert dig.shape == (8, k, 32)
    cpu = pipeline.get_step(x.cpu(), bits.cpu(), len(missing), k, 1000)
    assert torch.equal(out.cpu(), cpu[0]) and torch.equal(dig.cpu(), cpu[1])
