"""Batched ChaCha20 keystream XOR on the card.

Counterpart of minio_tpu/ops/chacha20_jax.py (keystream_xor,
xor_packages). ``keystream_xor`` is the wrapper of the hand-written kernel
(csrc/chacha20.cu): on a CUDA tensor it launches the kernel, on a CPU
tensor it runs the plain PyTorch version (ops/chacha20_plain.py); any
other device raises. Key and nonce words arrive pre-derived
(features/crypto.DeviceSSE.batch_params, which owns all nonce
derivation): this module ciphers what it is handed.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import chacha20_plain, kernels


@functools.cache
def _launcher():
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    return kernels.function("chacha20", "chacha20_launch",
                            [vp, ll, vp, ll, ll, ll, vp, vp, ll, ll, vp])


def words(a, device) -> torch.Tensor:
    """u32 key or nonce words (a numpy array) -> an int32 tensor of the
    same bit patterns on `device`."""
    arr = np.array(a, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def _int32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.int64:
        t = torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)
    return t.contiguous()


def keystream_xor(data: torch.Tensor, keys: torch.Tensor,
                  nonces: torch.Tensor, pkg_bytes: int, span=None,
                  out=None) -> torch.Tensor:
    """(B, L) uint8 rows, the first `span` bytes of each XORed with its
    per-package ChaCha20 keystream (row i, package p under keys[i] and
    nonces[i, p], counter restarting at 1 in every package), written to
    `out` (default: a new tensor; `out=data` ciphers in place).

    keys (B, 8) and nonces (B, P, 3): u32 words as int32 bit patterns or
    int64 values, on data's device. span defaults to min(P·pkg_bytes, L);
    bytes of `out` at or past it are not written (a new `out` takes
    data's bytes there). XOR: the same call deciphers. CPU tensors take
    chacha20_plain.keystream_xor; CUDA tensors launch the kernel (counted
    in keystream_xor.launches)."""
    if data.device.type == "cpu":
        return chacha20_plain.keystream_xor(data, keys, nonces, pkg_bytes,
                                            span, out)
    if data.device.type != "cuda":
        raise ValueError(f"chacha20: unsupported device {data.device}")
    span = chacha20_plain.check_args(data, keys, nonces, pkg_bytes, span)
    for t in (keys, nonces):
        if t.device != data.device:
            raise ValueError("keys and nonces must be on data's device")
    if data.stride(1) != 1:
        raise ValueError("chacha20 takes rows of contiguous bytes")
    if out is None:
        out = torch.empty_like(data, memory_format=torch.contiguous_format)
        if span < data.shape[1]:
            out[:, span:] = data[:, span:]
    elif out.shape != data.shape or out.dtype != torch.uint8 \
            or out.device != data.device or out.stride(1) != 1:
        raise ValueError("out must be a uint8 tensor of data's shape and "
                         "device, rows contiguous")
    if span == 0:
        return out
    k32, n32 = _int32(keys), _int32(nonces)
    err = _launcher()(data.data_ptr(), data.stride(0), out.data_ptr(),
                      out.stride(0), data.shape[0], span, k32.data_ptr(),
                      n32.data_ptr(), nonces.shape[1], pkg_bytes,
                      torch.cuda.current_stream(data.device).cuda_stream)
    kernels.check(err, "chacha20 launch")
    kernels.count_launch(keystream_xor)
    return out


keystream_xor.launches = 0


def xor_packages(rows: torch.Tensor, keys: torch.Tensor,
                 nonces: torch.Tensor) -> torch.Tensor:
    """The GET decipher batch: (N, Lp) uint8 rows, one package each
    zero-padded to a 64-byte multiple, (N, 8) key words, (N, 3) nonce
    words -> (N, Lp) uint8 in one launch."""
    return keystream_xor(rows, keys, nonces[:, None, :], rows.shape[1])
