"""SHA-256 of every row, in plain PyTorch.

The plain version of the hand-written kernel (csrc/sha256.cu) and the
counterpart of minio_tpu/ops/sha256_jax.py:85-155 (_compress,
_sha256_impl): all N rows advance in lockstep, with the same padding (0x80,
zeros, the 64-bit big-endian bit length) and the same 64 rounds per
64-byte block. PyTorch has no unsigned 32-bit arithmetic, so every u32 is
an int64 tensor holding a value below 2^32, masked after each add; a
rotate takes the value doubled into the upper half (x | x << 32) and
shifts it right, so the three rotates of a sigma share one doubling.

The message schedule depends on the message alone, so W[16..63] of every
block is extended at once; only the rounds walk the blocks in order.
"""

from __future__ import annotations

import torch

_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
_H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
_M32 = 0xffffffff


def _sigma(x: torch.Tensor, r1: int, r2: int, r3: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ rotr(x, r3) of u32 values."""
    d = x | (x << 32)
    return ((d >> r1) ^ (d >> r2) ^ (d >> r3)) & _M32


def _small_sigma(x: torch.Tensor, r1: int, r2: int, s: int) -> torch.Tensor:
    """rotr(x, r1) ^ rotr(x, r2) ^ (x >> s) of u32 values."""
    d = x | (x << 32)
    return (((d >> r1) ^ (d >> r2)) & _M32) ^ (x >> s)


def _padded(rows: torch.Tensor, length: int) -> torch.Tensor:
    """(N, >= length) uint8 -> (N, blocks * 64) int64 bytes of the padded
    message."""
    n = rows.shape[0]
    padded_len = ((length + 8) // 64 + 1) * 64
    msg = torch.zeros((n, padded_len), dtype=torch.int64, device=rows.device)
    msg[:, :length] = rows[:, :length]
    msg[:, length] = 0x80
    for i, byte in enumerate((length * 8).to_bytes(8, "big")):
        msg[:, padded_len - 8 + i] = byte
    return msg


def sha256_rows(rows: torch.Tensor, length: int) -> torch.Tensor:
    """SHA-256 of the first `length` bytes of each row of an (N, S) uint8
    tensor -> (N, 32) uint8, on rows' device."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("rows must be an (N, S) uint8 tensor")
    if not 0 <= length <= rows.shape[1]:
        raise ValueError(f"length {length} outside 0..{rows.shape[1]}")
    n, dev = rows.shape[0], rows.device
    msg = _padded(rows, length)
    blocks = msg.shape[1] // 64
    b = msg.reshape(n, blocks, 16, 4)
    w16 = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    # (blocks, 64, N) schedule, extended for every block at once
    w = torch.zeros((blocks, 64, n), dtype=torch.int64, device=dev)
    w[:, :16] = w16.permute(1, 2, 0)
    for i in range(16, 64):
        w[:, i] = (w[:, i - 16] + _small_sigma(w[:, i - 15], 7, 18, 3)
                   + w[:, i - 7] + _small_sigma(w[:, i - 2], 17, 19, 10)
                   ) & _M32
    kw = w + torch.tensor(_K, dtype=torch.int64, device=dev)[None, :, None]
    state = [torch.full((n,), v, dtype=torch.int64, device=dev)
             for v in _H0]
    for blk in range(blocks):
        a, b_, c, d, e, f, g, h = state
        for i in range(64):
            t1 = (h + _sigma(e, 6, 11, 25) + ((e & f) ^ ((e ^ _M32) & g))
                  + kw[blk, i])
            t2 = _sigma(a, 2, 13, 22) + ((a & b_) ^ (a & c) ^ (b_ & c))
            h, g, f, e = g, f, e, (d + t1) & _M32
            d, c, b_, a = c, b_, a, (t1 + t2) & _M32
        state = [(s + v) & _M32 for s, v in
                 zip(state, (a, b_, c, d, e, f, g, h))]
    words = torch.stack(state, 1)                         # (N, 8)
    shifts = torch.tensor((24, 16, 8, 0), device=dev)
    return ((words[..., None] >> shifts) & 0xff).reshape(n, 32).to(
        torch.uint8)
