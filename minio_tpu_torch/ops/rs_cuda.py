"""GF(2^8) Reed-Solomon coding on the card.

Counterpart of minio_tpu/ops/rs_pallas.py (the kernel) and ops/rs_tpu.py
(its callers). Multiplication by a constant in GF(2^8) is linear over
GF(2), so an (r, k) coding matrix expands into an (8r, 8k) 0/1 matrix
(gf256.expand_to_gf2) and each output byte column is that matrix times the
column's 8k input bits, mod 2. Encode, reconstruct and heal are the same
operation with a different matrix.

``gf_matmul`` is the wrapper of the hand-written kernel
(csrc/gf_matmul.cu): on a CUDA tensor it launches the kernel, on a CPU
tensor it runs ``gf_matmul_plain``, the same math in plain PyTorch
(minio_tpu/ops/rs_tpu.py:50-81, gf_matmul_xla).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import device as device_mod
from . import gf256, kernels, rs_matrix

MAX_SHARDS = 16    # k and r per matrix (MinIO's largest erasure set)


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., k, S) uint8 -> (..., 8k, S) 0/1 bit planes, bit p of byte i at
    row 8i+p (the gf256.expand_to_gf2 column order)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x.unsqueeze(-2) >> shifts[:, None]) & 1
    return bits.reshape(*x.shape[:-2], x.shape[-2] * 8, x.shape[-1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8r, S) 0/1 -> (..., r, S) uint8 (LSB-first)."""
    b = bits.reshape(*bits.shape[:-2], bits.shape[-2] // 8, 8,
                     bits.shape[-1]).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=bits.device))
    return (b * weights[:, None]).sum(dim=-2).to(torch.uint8)


def gf_matmul_plain(m2: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (8r, 8k) 0/1 matrix applied to
    (..., k, S) uint8 -> (..., r, S) uint8. Sums of at most 128 products
    of 0/1 values are exact in float32."""
    bits = unpack_bits(data).to(torch.float32)
    acc = torch.einsum("rc,...cs->...rs", m2.to(torch.float32), bits)
    return pack_bits(acc.to(torch.int32) & 1)


@functools.cache
def _launcher():
    vp = ctypes.c_void_p
    return kernels.function(
        "gf_matmul", "gf_matmul_launch",
        [vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, vp])


def gf_matmul(m2: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """out = M (x) data over GF(2^8).

    m2: (8r, 8k) 0/1 uint8, the canonical bit expansion of an (r, k)
    matrix; data: (..., k, S) uint8. Returns (..., r, S) uint8 on data's
    device. CPU tensors take gf_matmul_plain; CUDA tensors launch the
    kernel (counted in gf_matmul.launches)."""
    if m2.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError("gf_matmul takes uint8 tensors")
    if m2.dim() != 2 or m2.shape[0] % 8 or m2.shape[1] % 8:
        raise ValueError(f"matrix must be (8r, 8k), got {tuple(m2.shape)}")
    r, k = m2.shape[0] // 8, m2.shape[1] // 8
    if not (1 <= r <= MAX_SHARDS and 1 <= k <= MAX_SHARDS):
        raise ValueError(f"r={r}, k={k}: both must be in 1..{MAX_SHARDS}")
    if data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(
            f"data must be (..., {k}, S), got {tuple(data.shape)}")
    if m2.device != data.device:
        raise ValueError(f"matrix on {m2.device}, data on {data.device}")
    if data.device.type == "cpu":
        return gf_matmul_plain(m2, data)
    if data.device.type != "cuda":
        raise ValueError(f"gf_matmul: unsupported device {data.device}")
    if not (m2.is_contiguous() and data.is_contiguous()):
        raise ValueError("gf_matmul takes contiguous tensors")
    lead, s = data.shape[:-2], data.shape[-1]
    batch = int(np.prod(lead)) if lead else 1
    if batch > 65535:
        raise ValueError(f"batch {batch} > 65535")
    out = torch.empty((*lead, r, s), dtype=torch.uint8, device=data.device)
    if batch == 0 or s == 0:
        return out
    err = _launcher()(m2.data_ptr(), data.data_ptr(), out.data_ptr(), batch,
                      r, k, s, torch.cuda.current_stream(
                          data.device).cuda_stream)
    kernels.check(err, "gf_matmul launch")
    kernels.count_launch(gf_matmul)
    return out


gf_matmul.launches = 0


@functools.lru_cache(maxsize=4096)
def _bit_expand_cached(matrix_bytes: bytes,
                       shape: tuple[int, int]) -> np.ndarray:
    """Host-side cache of the GF(2) expansion of an (r, k) matrix."""
    m = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(shape)
    out = gf256.expand_to_gf2(m)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1024)
def _bits_on(matrix_bytes: bytes, shape: tuple[int, int],
             device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _bit_expand_cached(matrix_bytes, shape).copy()).to(device)


def matrix_bits(matrix: np.ndarray, device) -> torch.Tensor:
    """(8r, 8k) uint8 bit expansion of an (r, k) GF(2^8) matrix, cached on
    `device`."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    return _bits_on(matrix.tobytes(), matrix.shape, torch.device(device))


def _as_tensor(shards, device) -> torch.Tensor:
    if isinstance(shards, torch.Tensor):
        return shards.contiguous()
    return torch.tensor(np.asarray(shards), dtype=torch.uint8,
                        device=device_mod.resolve(device))


def apply_matrix(matrix: np.ndarray, shards, *, device=None) -> torch.Tensor:
    """out = matrix (x) shards over GF(2^8), batched.

    matrix: (r, k) uint8 host matrix; shards: (..., k, S) uint8 tensor, or
    a numpy array moved to `device` (default: the card)."""
    x = _as_tensor(shards, device)
    return gf_matmul(matrix_bits(matrix, x.device), x)


def encode(data, data_shards: int, parity_shards: int, *,
           device=None) -> torch.Tensor:
    """(B, k, S) or (k, S) data shards -> (B, n, S) / (n, S) with parity
    appended — byte-identical to rs_ref.encode."""
    x = _as_tensor(data, device)
    parity = apply_matrix(rs_matrix.parity_matrix(data_shards,
                                                  parity_shards), x)
    return torch.cat([x, parity], dim=-2)


def reconstruct_data(shards, present_mask: int, data_shards: int,
                     parity_shards: int, *, device=None) -> torch.Tensor:
    """Rebuild all k data shards from the first k present shards, stacked
    in rs_matrix.decode_matrix's `used` order."""
    d, _used = rs_matrix.decode_matrix(data_shards, parity_shards,
                                       present_mask)
    return apply_matrix(d, shards, device=device)


def recover_missing(shards, present_mask: int, data_shards: int,
                    parity_shards: int, *, device=None) -> torch.Tensor:
    """Exactly the missing shards (data and parity) from k survivors —
    one matrix application instead of decode-then-reencode."""
    r, _used, _missing = rs_matrix.recover_matrix(data_shards, parity_shards,
                                                  present_mask)
    return apply_matrix(r, shards, device=device)
