"""The port's GF(2^8) Reed-Solomon path against minio_tpu's, byte for byte.

Matrices come from the port's own copy of rs_matrix and must equal the
reference's; the coding ops run through the gf_matmul wrapper on CPU
tensors (its plain PyTorch version) and must equal minio_tpu.ops.rs_tpu
on its own CPU path (use_pallas=False) and the numpy oracle rs_ref.
Tolerance: 0 (exact bytes).
"""

import numpy as np
import pytest
import torch

from minio_tpu.ops import rs_matrix as ref_matrix
from minio_tpu.ops import rs_ref as ref_rs
from minio_tpu.ops import rs_tpu
from minio_tpu_torch.ops import gf256, rs_cuda, rs_matrix, rs_ref

CONFIGS = [(2, 2), (4, 2), (5, 3), (8, 4), (12, 4), (16, 4), (8, 8)]


def _shards(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("k,m", CONFIGS)
def test_matrices_equal_reference(k, m):
    n = k + m
    assert (rs_matrix.encode_matrix(k, m)
            == ref_matrix.encode_matrix(k, m)).all()
    rng = np.random.default_rng(k * 31 + m)
    masks = [(1 << n) - 1]
    for _ in range(6):
        lost = set(rng.choice(n, m, replace=False).tolist())
        masks.append(sum(1 << i for i in range(n) if i not in lost))
    for mask in masks:
        d, used = rs_matrix.decode_matrix(k, m, mask)
        rd, rused = ref_matrix.decode_matrix(k, m, mask)
        assert used == rused and (d == rd).all()
        for fn in ("missing_data_matrix", "recover_matrix"):
            got = getattr(rs_matrix, fn)(k, m, mask)
            want = getattr(ref_matrix, fn)(k, m, mask)
            assert got[1:] == want[1:] and (got[0] == want[0]).all()


@pytest.mark.parametrize("k,m", [(4, 2), (12, 4)])
@pytest.mark.parametrize("s", [1, 17, 1031])
def test_encode_equals_reference(k, m, s):
    data = _shards((3, k, s), k + s)
    got = rs_cuda.encode(data, k, m, device="cpu").numpy()
    want = np.asarray(rs_tpu.encode(data, k, m, use_pallas=False))
    assert (got == want).all()
    for b in range(3):
        assert (got[b] == ref_rs.encode(data[b], m)).all()
        assert (got[b] == rs_ref.encode(data[b], m)).all()


@pytest.mark.parametrize("k,m", [(4, 2), (12, 4)])
def test_reconstruct_and_recover_equal_reference(k, m):
    n, s = k + m, 777
    data = _shards((k, s), 5)
    full = ref_rs.encode(data, m)
    rng = np.random.default_rng(6)
    for _ in range(4):
        missing = set(rng.choice(n, m, replace=False).tolist())
        mask = sum(1 << i for i in range(n) if i not in missing)
        _, used = rs_matrix.decode_matrix(k, m, mask)
        stack = full[list(used)]
        got = rs_cuda.reconstruct_data(stack, mask, k, m,
                                       device="cpu").numpy()
        want = np.asarray(rs_tpu.reconstruct_data(stack, mask, k, m,
                                                  use_pallas=False))
        assert (got == want).all() and (got == data).all()
        rec, _, miss = rs_matrix.recover_matrix(k, m, mask)
        got = rs_cuda.recover_missing(stack, mask, k, m,
                                      device="cpu").numpy()
        want = np.asarray(rs_tpu.recover_missing(stack, mask, k, m,
                                                 use_pallas=False))
        assert (got == want).all()
        for row, idx in enumerate(miss):
            assert (got[row] == full[idx]).all()


@pytest.mark.parametrize("shape", [(2, 4, 0), (1, 12, 1), (3, 16, 65)])
def test_apply_matrix_any_batch_and_width(shape):
    k = shape[1]
    mat = _shards((16 - k + 1, k), 3)
    data = _shards(shape, 4)
    got = rs_cuda.apply_matrix(mat, data, device="cpu").numpy()
    want = np.asarray(rs_tpu.apply_matrix(mat, data, use_pallas=False))
    assert got.shape == want.shape and (got == want).all()


def test_bit_expand_and_plain_kernel_math():
    mat = _shards((4, 12), 8)
    bits = rs_cuda._bit_expand_cached(mat.tobytes(), mat.shape)
    assert (bits == gf256.expand_to_gf2(mat)).all()
    assert (bits == rs_tpu._bit_expand_cached(mat.tobytes(),
                                              mat.shape)).all()
    x = torch.from_numpy(_shards((5, 64), 9))
    assert torch.equal(rs_cuda.pack_bits(rs_cuda.unpack_bits(x)), x)


def _bit_plane_product(m2: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Numpy restatement of csrc/gf_matmul.cu's arithmetic on packed
    little-endian uint32 words: acc_j ^= ((X_i >> p) & 0x01010101) *
    c(j, i, p), with c(j, i, p) = sum_q m2[8j+q, 8i+p] << q built as the
    kernel's prologue builds it. It rehearses the kernel's q/p orientation
    and is not coverage of the kernel, which runs only on the card."""
    r, k = m2.shape[0] // 8, m2.shape[1] // 8
    c = np.zeros((r, k, 8), np.uint32)
    for q in range(8):
        c |= (m2[q::8].reshape(r, k, 8).astype(np.uint32) & 1) << q
    s = data.shape[-1]
    pad = np.zeros((*data.shape[:-1], -s % 4), np.uint8)
    x = np.concatenate([data, pad], axis=-1).view("<u4")
    acc = np.zeros((*data.shape[:-2], r, x.shape[-1]), np.uint32)
    for i in range(k):
        for p in range(8):
            t = (x[..., i, :] >> np.uint32(p)) & np.uint32(0x01010101)
            acc ^= t[..., None, :] * c[:, i, p][:, None]
    return acc.view(np.uint8)[..., :s]


@pytest.mark.parametrize("r", [1, 4, 12, 16])
@pytest.mark.parametrize("k", [1, 4, 12, 16])
def test_bit_plane_identity_equals_plain_and_reference(r, k):
    import jax.numpy as jnp
    rng = np.random.default_rng(100 * r + k)
    data = _shards((2, k, 37), r + k)
    m2_random = rng.integers(0, 2, (8 * r, 8 * k), dtype=np.uint8)
    mat = _shards((r, k), r * k)
    for m2, want in (
            (m2_random, rs_tpu.gf_matmul_xla(
                jnp.asarray(m2_random, dtype=jnp.bfloat16), data)),
            (gf256.expand_to_gf2(mat),
             rs_tpu.apply_matrix(mat, data, use_pallas=False))):
        got = _bit_plane_product(m2, data)
        plain = rs_cuda.gf_matmul_plain(torch.from_numpy(m2),
                                        torch.from_numpy(data)).numpy()
        assert (got == plain).all() and (got == np.asarray(want)).all()


def test_gf_matmul_wrapper_rejects_bad_input():
    m2 = torch.zeros((32, 96), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_cuda.gf_matmul(m2, torch.zeros((1, 11, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        rs_cuda.gf_matmul(m2, torch.zeros((1, 12, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        rs_cuda.gf_matmul(torch.zeros((136, 96), dtype=torch.uint8),
                          torch.zeros((1, 12, 8), dtype=torch.uint8))
    before = rs_cuda.gf_matmul.launches
    rs_cuda.gf_matmul(m2, torch.zeros((1, 12, 8), dtype=torch.uint8))
    assert rs_cuda.gf_matmul.launches == before   # CPU: no kernel launch
