"""ChaCha20 keystream XOR of every row, in plain PyTorch.

The plain version of the hand-written kernel (csrc/chacha20.cu) and the
counterpart of minio_tpu/ops/chacha20_jax.py:50-122 (_keystream_words,
keystream_u8, keystream_xor): row i, package p is ciphered under key
words keys[i] and nonce words nonces[i, p], with the RFC 8439 block
counter restarting at 1 inside every package (counter 0 is the package's
Poly1305 one-time key, which the host derives). It is named ``_plain``,
not ``_ref`` as sha256_ref.py is, because ops/chacha20_ref.py is the
reference's host cipher under its own name.

All (row, 64-byte block) pairs advance in lockstep through the 10 double
rounds and the feed-forward add. PyTorch has no unsigned 32-bit
arithmetic, so every u32 is the bit pattern of an int32: adds wrap
modulo 2^32 as unsigned ones do, and the right shift of a rotation is
masked to its n bits, which makes the arithmetic shift a logical one.
The state words are updated in place; the keystream is serialised
little-endian.
"""

from __future__ import annotations

import torch

# "expand 32-byte k" as little-endian words (RFC 8439 §2.3)
_CONST = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
# quarter-round schedule: 4 column rounds then 4 diagonal rounds
_QROUNDS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def check_args(data: torch.Tensor, keys: torch.Tensor,
               nonces: torch.Tensor, pkg_bytes: int, span) -> int:
    """Validate a keystream_xor call; returns the span (default: the
    whole P·pkg_bytes of the nonces, at most the row length)."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be a (B, L) uint8 tensor")
    b, length = data.shape
    if pkg_bytes <= 0 or pkg_bytes % 64:
        raise ValueError("package length must be a positive 64-byte "
                         "multiple")
    if keys.dim() != 2 or tuple(keys.shape) != (b, 8):
        raise ValueError(f"keys must be ({b}, 8), got {tuple(keys.shape)}")
    if nonces.dim() != 3 or nonces.shape[0] != b or nonces.shape[2] != 3:
        raise ValueError(f"nonces must be ({b}, P, 3), got "
                         f"{tuple(nonces.shape)}")
    for t in (keys, nonces):
        if t.dtype not in (torch.int32, torch.int64):
            raise ValueError("key and nonce words must be int32 (u32 bit "
                             "patterns) or int64 (values below 2^32)")
    cover = nonces.shape[1] * pkg_bytes
    if span is None:
        span = min(cover, length)
    if not 0 <= span <= min(cover, length):
        raise ValueError(f"span {span} outside 0..{min(cover, length)}")
    return span


def _i32(t: torch.Tensor) -> torch.Tensor:
    """u32 words (int32 bit patterns or int64 values) -> int32."""
    if t.dtype == torch.int64:
        t = torch.where(t >= 1 << 31, t - (1 << 32), t)
    return t.to(torch.int32)


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | ((x >> (32 - n)) & ((1 << n) - 1))


def keystream(keys: torch.Tensor, nonces: torch.Tensor, span: int,
              pkg_bytes: int) -> torch.Tensor:
    """(B, span) uint8 keystream: row i's byte t comes from block
    j = t // 64, package j // (pkg_bytes / 64), counter 1 + j mod
    (pkg_bytes / 64)."""
    b, dev = keys.shape[0], keys.device
    nblk = -(-span // 64)
    pkg_blocks = pkg_bytes // 64
    j = torch.arange(nblk, device=dev)
    keys, nonces = _i32(keys), _i32(nonces)
    bn = nonces[:, j // pkg_blocks, :]                     # (B, nblk, 3)
    init = [torch.full((b, nblk), c - (1 << 32) if c >= 1 << 31 else c,
                       dtype=torch.int32, device=dev) for c in _CONST]
    init += [keys[:, i:i + 1].expand(b, nblk) for i in range(8)]
    init += [(1 + j % pkg_blocks).to(torch.int32).expand(b, nblk)]
    init += [bn[:, :, i] for i in range(3)]
    x = [t.clone(memory_format=torch.contiguous_format) for t in init]
    for _ in range(10):
        for a, b_, c, d in _QROUNDS:
            x[a].add_(x[b_])
            x[d] = _rotl(x[d].bitwise_xor_(x[a]), 16)
            x[c].add_(x[d])
            x[b_] = _rotl(x[b_].bitwise_xor_(x[c]), 12)
            x[a].add_(x[b_])
            x[d] = _rotl(x[d].bitwise_xor_(x[a]), 8)
            x[c].add_(x[d])
            x[b_] = _rotl(x[b_].bitwise_xor_(x[c]), 7)
    words = torch.stack([x[i].add_(init[i]) for i in range(16)], -1)
    shifts = torch.tensor((0, 8, 16, 24), dtype=torch.int32, device=dev)
    ks = ((words[..., None] >> shifts) & 0xFF).to(torch.uint8)
    return ks.reshape(b, nblk * 64)[:, :span]


def keystream_xor(data: torch.Tensor, keys: torch.Tensor,
                  nonces: torch.Tensor, pkg_bytes: int, span=None,
                  out=None) -> torch.Tensor:
    """`data` (B, L) uint8 with the first `span` bytes of each row XORed
    with the rows' keystreams, written to `out` (default: a new tensor;
    `out=data` ciphers in place). Bytes of `out` at or past the span are
    not written; a new `out` takes data's bytes there."""
    span = check_args(data, keys, nonces, pkg_bytes, span)
    if out is None:
        out = data.clone()
    if span:
        out[:, :span] = data[:, :span] ^ keystream(keys, nonces, span,
                                                   pkg_bytes)
    return out
