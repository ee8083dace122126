"""Batched SHA-256 on the card.

Counterpart of minio_tpu/ops/sha256_jax.py. ``sha256_rows`` is the wrapper
of the hand-written kernel (csrc/sha256.cu): on a CUDA tensor it launches
the kernel, on a CPU tensor it runs the plain PyTorch version
(ops/sha256_ref.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernels, sha256_ref


@functools.cache
def _launcher():
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    return kernels.function("sha256", "sha256_launch",
                            [vp, ll, ll, ll, vp, vp])


def sha256_rows(rows: torch.Tensor, length: int) -> torch.Tensor:
    """SHA-256 of the first `length` bytes of each row of an (N, S) uint8
    tensor -> (N, 32) uint8 on rows' device, byte-identical to
    hashlib.sha256. CPU tensors take sha256_ref.sha256_rows; CUDA tensors
    launch the kernel (counted in sha256_rows.launches)."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("rows must be an (N, S) uint8 tensor")
    if not 0 <= length <= rows.shape[1]:
        raise ValueError(f"length {length} outside 0..{rows.shape[1]}")
    if rows.device.type == "cpu":
        return sha256_ref.sha256_rows(rows, length)
    if rows.device.type != "cuda":
        raise ValueError(f"sha256: unsupported device {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("sha256 takes a contiguous tensor")
    out = torch.empty((rows.shape[0], 32), dtype=torch.uint8,
                      device=rows.device)
    if rows.shape[0] == 0:
        return out
    err = _launcher()(rows.data_ptr(), rows.shape[0], rows.shape[1], length,
                      out.data_ptr(),
                      torch.cuda.current_stream(rows.device).cuda_stream)
    kernels.check(err, "sha256 launch")
    kernels.count_launch(sha256_rows)
    return out


sha256_rows.launches = 0

