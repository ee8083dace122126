"""SipHash-2-4 (64-bit) — the object→set routing hash.

Bit-identical to the SipHash-2-4 the reference routes with
(cmd/erasure-sets.go:590 sipHashMod over the deployment-ID key):
placement compatibility requires exact agreement, so this is the
standard Aumasson–Bernstein construction, validated against the
published reference vectors (tests/test_sets.py).
"""

from __future__ import annotations

MASK = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & MASK


def siphash24(key: bytes, data: bytes) -> int:
    """SipHash-2-4 with a 16-byte key -> 64-bit digest."""
    if len(key) != 16:
        raise ValueError("siphash key must be 16 bytes")
    k0 = int.from_bytes(key[:8], "little")
    k1 = int.from_bytes(key[8:], "little")
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def sipround():
        nonlocal v0, v1, v2, v3
        v0 = (v0 + v1) & MASK
        v1 = _rotl(v1, 13)
        v1 ^= v0
        v0 = _rotl(v0, 32)
        v2 = (v2 + v3) & MASK
        v3 = _rotl(v3, 16)
        v3 ^= v2
        v0 = (v0 + v3) & MASK
        v3 = _rotl(v3, 21)
        v3 ^= v0
        v2 = (v2 + v1) & MASK
        v1 = _rotl(v1, 17)
        v1 ^= v2
        v2 = _rotl(v2, 32)

    n = len(data)
    end = n - (n % 8)
    for off in range(0, end, 8):
        m = int.from_bytes(data[off:off + 8], "little")
        v3 ^= m
        sipround()
        sipround()
        v0 ^= m

    b = (n & 0xFF) << 56
    tail = data[end:]
    for i, c in enumerate(tail):
        b |= c << (8 * i)
    v3 ^= b
    sipround()
    sipround()
    v0 ^= b

    v2 ^= 0xFF
    sipround()
    sipround()
    sipround()
    sipround()
    return (v0 ^ v1 ^ v2 ^ v3) & MASK


def sip_hash_mod(key: str, cardinality: int, id16: bytes) -> int:
    """Object name -> set index (reference sipHashMod,
    cmd/erasure-sets.go:590)."""
    if cardinality <= 0:
        return -1
    return siphash24(id16, key.encode()) % cardinality


def crc_hash_mod(key: str, cardinality: int) -> int:
    """Legacy CRCMOD routing (cmd/erasure-sets.go:599)."""
    import zlib
    if cardinality <= 0:
        return -1
    return zlib.crc32(key.encode()) % cardinality
