"""Host ChaCha20 + Poly1305 (RFC 8439) — the SSE byte-identity oracle.

A copy of minio_tpu/ops/chacha20_ref.py (the port imports nothing of the
JAX package). Two implementations of the same cipher, pinned against each
other and against the RFC 8439 test vectors (tests/test_torch_chacha.py):

  * ``_block_scalar`` — a literal per-block transcription of the RFC
    (pure ints, one 64-byte block at a time). Slow; exists so the
    vectorized paths have an independent reference.
  * ``keystream`` / ``xor_stream`` — numpy-vectorized over blocks: the
    16-word state is built for ALL counters at once and the 20 rounds
    run as u32 array ops. The host cipher of package tails and of
    batches the codec's size gate keeps off the card; the card's kernel
    (csrc/chacha20.cu) must match it byte for byte.

Poly1305 runs on Python big ints (the 130-bit field makes numpy
awkward and the tag input is one 64 KiB package, not the hot loop).

These are PRIMITIVES: policy — nonce derivation, package framing, AAD
discipline — lives in features/crypto.py.
"""

from __future__ import annotations

import numpy as np

_CONST = np.frombuffer(b"expa" b"nd 3" b"2-by" b"te k",
                       dtype="<u4").copy()

# quarter-round schedule: 4 column rounds then 4 diagonal rounds
_QROUNDS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def key_words(key: bytes) -> np.ndarray:
    """32-byte key -> (8,) little-endian u32 words."""
    if len(key) != 32:
        raise ValueError("ChaCha20 key must be 256 bits")
    return np.frombuffer(key, dtype="<u4").copy()


def nonce_words(nonce: bytes) -> np.ndarray:
    """12-byte nonce -> (3,) little-endian u32 words."""
    if len(nonce) != 12:
        raise ValueError("ChaCha20 nonce must be 96 bits")
    return np.frombuffer(nonce, dtype="<u4").copy()


# ---------------------------------------------------------------------------
# scalar reference (RFC 8439 §2.3 literal)
# ---------------------------------------------------------------------------

def _rotl32(x: int, n: int) -> int:
    x &= 0xFFFFFFFF
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _block_scalar(key: bytes, nonce: bytes, counter: int) -> bytes:
    """One 64-byte keystream block, pure ints."""
    init = list(_CONST.tolist()) + list(key_words(key).tolist()) + \
        [counter & 0xFFFFFFFF] + list(nonce_words(nonce).tolist())
    x = list(init)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(10):
        for a, b, c, d in _QROUNDS:
            qr(a, b, c, d)
    out = [(x[i] + init[i]) & 0xFFFFFFFF for i in range(16)]
    return b"".join(w.to_bytes(4, "little") for w in out)


# ---------------------------------------------------------------------------
# vectorized keystream (the CPU data path)
# ---------------------------------------------------------------------------

def _rounds_vec(state: np.ndarray) -> np.ndarray:
    """(16, N) u32 initial states -> (16, N) output states (rounds +
    feed-forward add)."""
    x = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            for a, b, c, d in _QROUNDS:
                x[a] += x[b]
                t = x[d] ^ x[a]
                x[d] = (t << np.uint32(16)) | (t >> np.uint32(16))
                x[c] += x[d]
                t = x[b] ^ x[c]
                x[b] = (t << np.uint32(12)) | (t >> np.uint32(20))
                x[a] += x[b]
                t = x[d] ^ x[a]
                x[d] = (t << np.uint32(8)) | (t >> np.uint32(24))
                x[c] += x[d]
                t = x[b] ^ x[c]
                x[b] = (t << np.uint32(7)) | (t >> np.uint32(25))
        x += state
    return x


def keystream(key: bytes, nonce: bytes, counter: int,
              nblocks: int) -> np.ndarray:
    """(nblocks*64,) u8 keystream starting at block `counter`."""
    if nblocks <= 0:
        return np.zeros(0, dtype=np.uint8)
    state = np.empty((16, nblocks), dtype=np.uint32)
    state[0:4] = _CONST[:, None]
    state[4:12] = key_words(key)[:, None]
    state[12] = (counter + np.arange(nblocks,
                                     dtype=np.uint64)) & 0xFFFFFFFF
    state[13:16] = nonce_words(nonce)[:, None]
    out = _rounds_vec(state)
    # serialize column-major: block j is out[:, j]'s 16 LE words
    return np.ascontiguousarray(out.T).astype("<u4").view(
        np.uint8).reshape(-1)


def xor_stream(data, key: bytes, nonce: bytes,
               counter: int = 1) -> bytes:
    """ChaCha20-encrypt/decrypt `data` (bytes/memoryview/uint8 array)
    with the keystream starting at block `counter` (RFC 8439 payload
    convention: counter 1; counter 0 is the Poly1305 one-time key)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data.astype(np.uint8,
                                                             copy=False)
    n = buf.shape[0]
    if n == 0:
        return b""
    ks = keystream(key, nonce, counter, -(-n // 64))
    return (buf ^ ks[:n]).tobytes()


def xor_stream_into(arr: np.ndarray, key: bytes, nonce: bytes,
                    counter: int = 1) -> None:
    """In-place variant over a uint8 array (the engine's staging-ring
    rows encrypt without a copy on the CPU fallback path)."""
    n = arr.shape[0]
    if n:
        ks = keystream(key, nonce, counter, -(-n // 64))
        np.bitwise_xor(arr, ks[:n], out=arr)


# ---------------------------------------------------------------------------
# Poly1305 (RFC 8439 §2.5) + the AEAD construction, detached-tag form
# ---------------------------------------------------------------------------

_P1305 = (1 << 130) - 5
_CLAMP = 0x0ffffffc0ffffffc0ffffffc0fffffff


def poly1305_mac(msg: bytes, key: bytes) -> bytes:
    """16-byte Poly1305 tag of `msg` under a 32-byte one-time key."""
    if len(key) != 32:
        raise ValueError("Poly1305 key must be 256 bits")
    r = int.from_bytes(key[:16], "little") & _CLAMP
    s = int.from_bytes(key[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i:i + 16]
        acc = ((acc + int.from_bytes(blk, "little")
                + (1 << (8 * len(blk)))) * r) % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def poly1305_key_gen(key: bytes, nonce: bytes) -> bytes:
    """Per-(key, nonce) one-time Poly1305 key: the first 32 bytes of
    ChaCha20 block 0 (RFC 8439 §2.6)."""
    return _block_scalar(key, nonce, 0)[:32]


def _pad16(n: int) -> bytes:
    return b"\x00" * (-n % 16)


def tag_detached(key: bytes, nonce: bytes, aad: bytes,
                 ct: bytes) -> bytes:
    """Poly1305 tag over an ALREADY-encrypted payload — the seam the
    device path uses: ciphertext comes back from the device, the tag
    is computed host-side before commit (no laundered auth)."""
    mac_data = (aad + _pad16(len(aad)) + ct + _pad16(len(ct))
                + len(aad).to_bytes(8, "little")
                + len(ct).to_bytes(8, "little"))
    return poly1305_mac(mac_data, poly1305_key_gen(key, nonce))


def seal_detached(key: bytes, nonce: bytes, aad: bytes,
                  pt: bytes) -> tuple[bytes, bytes]:
    """ChaCha20-Poly1305 seal, (ciphertext, tag) detached."""
    ct = xor_stream(pt, key, nonce, counter=1)
    return ct, tag_detached(key, nonce, aad, ct)


def open_detached(key: bytes, nonce: bytes, aad: bytes, ct: bytes,
                  tag: bytes) -> bytes:
    """Verify-then-decrypt; raises ValueError on tag mismatch BEFORE
    any plaintext is produced."""
    import hmac
    want = tag_detached(key, nonce, aad, ct)
    if not hmac.compare_digest(want, tag):
        raise ValueError("Poly1305 tag mismatch")
    return xor_stream(ct, key, nonce, counter=1)
