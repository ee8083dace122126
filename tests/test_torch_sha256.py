"""The port's plain SHA-256 (minio_tpu_torch/ops/sha256_ref.py, the CPU
path of ops/sha256_cuda.sha256_rows) against minio_tpu's _sha256_impl
(through sha256_batch, on the CPU as tests/test_sha256_jax.py runs it)
and hashlib, across the padding branches: the empty message, one block,
length % 64 on both sides of 56 (one padding block or two), a block
boundary and several blocks. Tolerance: 0 (exact bytes). Each length is
one JIT compile of the JAX program, so the lengths are few."""

import hashlib

import numpy as np
import pytest
import torch

from minio_tpu.ops.sha256_jax import sha256_batch
from minio_tpu_torch.ops import sha256_cuda, sha256_ref

LENGTHS = [0, 1, 55, 56, 63, 64, 120, 1000]


def _rows(n, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, s),
                                                dtype=np.uint8)


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_equals_reference_and_hashlib(length):
    data = _rows(5, length, length)
    want = np.asarray(sha256_batch(data))
    got = sha256_ref.sha256_rows(torch.from_numpy(data), length).numpy()
    assert got.shape == (5, 32) and got.dtype == np.uint8
    assert (got == want).all()
    for i in range(5):
        assert got[i].tobytes() == hashlib.sha256(data[i].tobytes()).digest()


@pytest.mark.parametrize("length", [0, 57, 119, 1001])
def test_prefix_of_longer_rows(length):
    # length < S: only the first `length` bytes of each row count, as in
    # the ragged last block of a part (hashlib is the witness)
    data = _rows(3, length + 37, length + 1)
    got = sha256_cuda.sha256_rows(torch.from_numpy(data), length).numpy()
    for i in range(3):
        assert got[i].tobytes() == hashlib.sha256(
            data[i, :length].tobytes()).digest()


def test_known_vector_and_cpu_route():
    got = sha256_cuda.sha256_rows(torch.tensor([list(b"abc")],
                                               dtype=torch.uint8), 3)
    assert got[0].numpy().tobytes().hex() == (
        "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad")
    # a CPU tensor takes the plain version and launches nothing
    before = sha256_cuda.sha256_rows.launches
    sha256_cuda.sha256_rows(torch.zeros((2, 9), dtype=torch.uint8), 9)
    assert sha256_cuda.sha256_rows.launches == before


def test_bad_arguments_raise():
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_rows(rows, 9)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_rows(rows.to(torch.int32), 8)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_rows(rows[0], 8)
