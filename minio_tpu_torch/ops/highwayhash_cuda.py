"""Batched keyed HighwayHash-256 on the card.

Counterpart of minio_tpu/ops/highwayhash_jax.py. ``hh256`` is the wrapper
of the hand-written kernel (csrc/hh256.cu): on a CUDA tensor it launches
the kernel, on a CPU tensor it runs ``hh256_plain``.

``hh256_plain`` is the same algorithm in plain PyTorch, all rows advancing
in lockstep. PyTorch has no unsigned 64-bit arithmetic on the CPU, so it
follows the JAX file's u32-pair form: every u64 is a (lo, hi) pair of int64
tensors holding values below 2^32, adds carry through bit 32, and a
32x32-bit product splits one operand into 16-bit halves so no partial
product reaches the sign bit. State tensors are (4, N): one row per u64
lane.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import device as device_mod
from . import kernels

_MUL0 = (0xdbe6d5d5fe4cce2f, 0xa4093822299f31d0,
         0x13198a2e03707344, 0x243f6a8885a308d3)
_MUL1 = (0x3bd39e10cb0ef593, 0xc0acf169b5f18a8c,
         0xbe5466cf34e90c6c, 0x452821e638d01377)
_M32 = 0xffffffff


# -- u64 as (lo, hi) pairs of int64 tensors ---------------------------------

def _pair(vals, n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    lo = torch.tensor([v & _M32 for v in vals], dtype=torch.int64, device=dev)
    hi = torch.tensor([v >> 32 for v in vals], dtype=torch.int64, device=dev)
    return lo[:, None].expand(-1, n).clone(), hi[:, None].expand(-1, n).clone()


def _add(a, b):
    lo = a[0] + b[0]
    return lo & _M32, (a[1] + b[1] + (lo >> 32)) & _M32


def _xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _mul32(a, b):
    """(u32 a) * (u32 b) -> u64 pair; b splits into 16-bit halves so each
    partial product stays below 2^48."""
    p0 = a * (b & 0xffff)
    p1 = a * (b >> 16)
    lo = (p0 & _M32) + ((p1 & 0xffff) << 16)
    return lo & _M32, ((p0 >> 32) + (p1 >> 16) + (lo >> 32)) & _M32


def _zipper(v1, v0):
    """Byte shuffle of a (high lane v1, low lane v0) pair -> (add1, add0),
    highwayhash_py.HighwayHash._zipper_merge on (lo, hi) halves."""
    a0_lo = (((v0[0] >> 24) & 0xff) | ((v1[1] & 0xff) << 8)
             | (v0[0] & 0xff0000) | ((v0[1] & 0xff00) << 16))
    a0_hi = (((v1[1] >> 16) & 0xff) | (v0[0] & 0xff00)
             | ((v1[1] >> 8) & 0xff0000) | ((v0[0] & 0xff) << 24))
    a1_lo = (((v1[0] >> 24) & 0xff) | ((v0[1] & 0xff) << 8)
             | (v1[0] & 0xff0000) | ((v1[1] & 0xff00) << 16))
    a1_hi = (((v1[0] >> 8) & 0xff) | ((v0[1] >> 8) & 0xff00)
             | ((v1[0] & 0xff) << 16) | (v0[1] & 0xff000000))
    return (a1_lo, a1_hi), (a0_lo, a0_hi)


def _even(x):
    return x[0][0::2], x[1][0::2]


def _odd(x):
    return x[0][1::2], x[1][1::2]


def _interleave(even, odd):
    """Lanes (0, 2) and (1, 3) back to (4, N) in lane order."""
    return tuple(torch.stack((e, o), 1).reshape(4, -1)
                 for e, o in zip(even, odd))


def _update(st, lanes):
    v0, v1, mul0, mul1 = st
    v1 = _add(v1, _add(mul0, lanes))
    mul0 = _xor(mul0, _mul32(v1[0], v0[1]))
    v0 = _add(v0, mul1)
    mul1 = _xor(mul1, _mul32(v0[0], v1[1]))
    add1, add0 = _zipper(_odd(v1), _even(v1))
    v0 = _interleave(_add(_even(v0), add0), _add(_odd(v0), add1))
    add1, add0 = _zipper(_odd(v0), _even(v0))
    v1 = _interleave(_add(_even(v1), add0), _add(_odd(v1), add1))
    return v0, v1, mul0, mul1


def _lanes(packets: torch.Tensor):
    """(N, P, 32) uint8 -> ((P, 4, N) lo, (P, 4, N) hi) int64 LE words."""
    b = packets.to(torch.int64).reshape(*packets.shape[:2], 8, 4)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    words = words.permute(1, 2, 0)                     # (P, 8, N)
    return words[:, 0::2].contiguous(), words[:, 1::2].contiguous()


def _remainder_packet(tail: torch.Tensor) -> torch.Tensor:
    """(N, n) uint8 tail with 0 < n < 32 -> (N, 32) padded packet
    (highwayhash_py.HighwayHash._update_remainder)."""
    n = tail.shape[1]
    mod4, base = n & 3, n & ~3
    packet = torch.zeros((tail.shape[0], 32), dtype=torch.uint8,
                         device=tail.device)
    packet[:, :base] = tail[:, :base]
    if n & 16:
        for i in range(4):
            packet[:, 28 + i] = tail[:, base + mod4 + i - 4]
    elif mod4:
        packet[:, 16] = tail[:, base]
        packet[:, 17] = tail[:, base + (mod4 >> 1)]
        packet[:, 18] = tail[:, base + mod4 - 1]
    return packet


def _modred(a3, a2, a1, a0):
    a3 = a3[0], a3[1] & 0x3FFFFFFF
    shl1 = ((a3[0] << 1) & _M32 | (a2[1] >> 31),
            (a3[1] << 1) & _M32 | (a3[0] >> 31))
    shl2 = ((a3[0] << 2) & _M32 | (a2[1] >> 30),
            (a3[1] << 2) & _M32 | (a3[0] >> 30))
    m1 = _xor(_xor(a1, shl1), shl2)
    a2s1 = ((a2[0] << 1) & _M32, (a2[1] << 1) & _M32 | (a2[0] >> 31))
    a2s2 = ((a2[0] << 2) & _M32, (a2[1] << 2) & _M32 | (a2[0] >> 30))
    m0 = _xor(_xor(a0, a2s1), a2s2)
    return m1, m0


def hh256_plain(rows: torch.Tensor, length: int, key: bytes) -> torch.Tensor:
    """Plain PyTorch version of the kernel: HighwayHash-256 of the first
    `length` bytes of each row of an (N, S) uint8 tensor -> (N, 32)."""
    n, dev = rows.shape[0], rows.device
    k = [int.from_bytes(key[i * 8:(i + 1) * 8], "little") for i in range(4)]
    rot = [((v >> 32) | (v << 32)) & ((1 << 64) - 1) for v in k]
    mul0 = _pair(_MUL0, n, dev)
    mul1 = _pair(_MUL1, n, dev)
    st = (_xor(mul0, _pair(k, n, dev)), _xor(mul1, _pair(rot, n, dev)),
          mul0, mul1)
    full, rem = divmod(length, 32)
    if full:
        lo, hi = _lanes(rows[:, :full * 32].reshape(n, full, 32))
        for p in range(full):
            st = _update(st, (lo[p], hi[p]))
    if rem:
        v0, v1, mul0, mul1 = st
        v0 = _add(v0, (torch.full_like(v0[0], rem),
                       torch.full_like(v0[1], rem)))
        v1 = tuple(((h << rem) & _M32) | (h >> (32 - rem)) for h in v1)
        lo, hi = _lanes(_remainder_packet(
            rows[:, full * 32:length])[:, None])
        st = _update((v0, v1, mul0, mul1), (lo[0], hi[0]))
    for _ in range(10):
        v0 = st[0]
        perm = [2, 3, 0, 1]
        st = _update(st, (v0[1][perm], v0[0][perm]))    # rot32 = swap halves
    v0, v1, mul0, mul1 = st
    a = _add(v0, mul0)
    b = _add(v1, mul1)
    m1, m0 = _modred(_odd(b), _even(b), _odd(a), _even(a))
    h = _interleave(m0, m1)                 # lanes h0, h1, h2, h3
    words = torch.stack(h, 1).reshape(8, n).T          # (N, 8) LE u32
    shifts = torch.arange(0, 32, 8, device=dev)
    return ((words[..., None] >> shifts) & 0xff).reshape(n, 32).to(
        torch.uint8)


@functools.cache
def _launcher():
    vp, ll, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
    return kernels.function("hh256", "hh256_launch",
                            [vp, ll, ll, ll, ull, ull, ull, ull, vp, vp])


def hh256(rows: torch.Tensor, length: int, key: bytes) -> torch.Tensor:
    """HighwayHash-256 of the first `length` bytes of each row of an
    (N, S) uint8 tensor -> (N, 32) uint8 on rows' device. CPU tensors take
    hh256_plain; CUDA tensors launch the kernel (counted in
    hh256.launches)."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError("rows must be an (N, S) uint8 tensor")
    if not 0 <= length <= rows.shape[1]:
        raise ValueError(f"length {length} outside 0..{rows.shape[1]}")
    if len(key) != 32:
        raise ValueError("HighwayHash key must be 32 bytes")
    if rows.device.type == "cpu":
        return hh256_plain(rows, length, key)
    if rows.device.type != "cuda":
        raise ValueError(f"hh256: unsupported device {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("hh256 takes a contiguous tensor")
    out = torch.empty((rows.shape[0], 32), dtype=torch.uint8,
                      device=rows.device)
    if rows.shape[0] == 0:
        return out
    kw = [int.from_bytes(key[i * 8:(i + 1) * 8], "little") for i in range(4)]
    err = _launcher()(rows.data_ptr(), rows.shape[0], rows.shape[1], length,
                      *kw, out.data_ptr(),
                      torch.cuda.current_stream(rows.device).cuda_stream)
    kernels.check(err, "hh256 launch")
    kernels.count_launch(hh256)
    return out


hh256.launches = 0


def hh256_batch(key: bytes, data, *, device=None) -> torch.Tensor:
    """HighwayHash-256 of every row of an (N, L) uint8 array -> (N, 32).

    `data` is a tensor (hashed where it lies) or a numpy array moved to
    `device` (default: the card)."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(data, dtype=torch.uint8,
                            device=device_mod.resolve(device))
    if data.dim() != 2:
        raise ValueError("data must be (N, L)")
    return hh256(data.contiguous(), data.shape[1], bytes(key))
