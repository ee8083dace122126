"""SSE-S3 / SSE-C encryption and inline compression of the PUT/GET path.

Counterpart of minio_tpu/features/crypto.py. The
reference encrypts with DARE (sio) streams — a per-object data key (OEK)
sealed by the KMS/master or the SSE-C client key, the payload split into
packages each AEAD-sealed (cmd/encryption-v1.go:195-364) — and
compresses eligible objects inline with S2, keeping the *actual* size in
internal metadata (cmd/object-api-utils.go:869, isCompressible). The ETag
stays the MD5 of the CLIENT bytes: PutObjReader pairs the raw hashing
reader with the transformed stream.

Compression is snappy framing (features/snappy.py: S2-interoperable, the
default) or zstd (MINIO_COMPRESS_ALGORITHM=zstd, no cross-binary interop;
the `zstandard` package is imported at the first zstd PUT or GET, and a
PUT without it fails rather than store the object uncompressed). The
compressor is a host transform; under a fused SSE PUT its output is the
plaintext the engine ciphers in the encode dispatch.

Two package ciphers (MINIO_TPU_SSE_CIPHER picks for NEW writes; reads
dispatch on the per-object X-Minio-Internal-Sse-Cipher record):

  * AES-256-GCM (default, `cryptography`-backed, imported only when
    used): interleaved ct||tag packages.
  * ChaCha20-Poly1305 (ops/chacha20_ref on the host, the card's kernel
    csrc/chacha20.cu through ops/chacha20_cuda): DETACHED tags — the
    stored stream is the pure ChaCha20 ciphertext (1:1 offsets with the
    plaintext) followed by a trailer of 16-byte Poly1305 tags, one per
    64 KiB package. The detached layout lets a PUT batch cipher, RS-encode
    and digest in one device step (DeviceSSE + models/pipeline.
    sse_put_step): the kernel produces only keystream XOR, and the host
    computes every tag over the ciphertext the card returned, before
    commit. GET checks each package's tag before it deciphers the package
    on the card (chacha_decrypt_ranged). The host ChaChaEncryptor writes
    the same bytes, so either side reads the other's objects, and so does
    the reference.

This module owns ALL SSE nonce derivation (base^seq package nonces, HMAC
per-part bases) and is the only caller of the AEAD primitives.

Internal metadata keys (never exposed over the API):
    X-Minio-Internal-Sse:             "S3" | "C"
    X-Minio-Internal-Sse-Sealed-Key:  base64(nonce||ct||tag) of the OEK
    X-Minio-Internal-Sse-Iv:          base64 12-byte package nonce base
    X-Minio-Internal-Sse-Cipher:      "CHACHA20-POLY1305" (absent = AES)
    X-Minio-Internal-Sse-Key-Md5:     SSE-C client key MD5 (verification)
    X-Minio-Internal-compression:     "klauspost/compress/s2" | "zstd"
    X-Minio-Internal-actual-size:     plaintext byte count

Departures from the reference: GET deciphers on the device of the caller's
choice (default: the card) and raises when that fails, with no host retry;
the fused PUT has no MINIO_TPU_SSE_DEVICE switch and its size window is
fixed at the reference's defaults (DEVICE_SSE_MIN_BYTES, no maximum).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
from typing import Iterator, Optional

import numpy as np

from ..object.hash_reader import HashReader
from ..ops import chacha20_ref as _c20

PKG_SIZE = 64 * 1024
TAG_SIZE = 16
_AAD = b"minio-tpu-dare-v1"

MK_SSE = "X-Minio-Internal-Sse"
MK_CIPHER = "X-Minio-Internal-Sse-Cipher"

# MK_CIPHER values; absent means AES (every pre-chacha object)
CIPHER_AES = "AES256-GCM"
CIPHER_CHACHA = "CHACHA20-POLY1305"
MK_SSE_MP = "X-Minio-Internal-Sse-Multipart"
MK_SEALED = "X-Minio-Internal-Sse-Sealed-Key"
MK_IV = "X-Minio-Internal-Sse-Iv"
MK_KEYMD5 = "X-Minio-Internal-Sse-Key-Md5"
# exact reference bytes (cmd/object-handlers.go:997 writes
# ReservedMetadataPrefix+"compression"): the reference binary looks
# this key up case-SENSITIVELY when reading our disks
MK_COMPRESS = "X-Minio-Internal-compression"

# MK_COMPRESS values. S2/snappy is the interop default: snappy framing
# is a strict subset of the S2 stream format. zstd stays available
# behind config with no cross-binary interop.
COMPRESS_S2 = "klauspost/compress/s2"      # cmd/object-handlers.go:69
COMPRESS_SNAPPY_V1 = "golang/snappy/LZ77"  # cmd/object-handlers.go:68
COMPRESS_ZSTD = "zstd"

# older minio_tpu builds wrote the key with a capital C; metadata lookups
# are case-sensitive, so reads accept both spellings
MK_COMPRESS_LEGACY = "X-Minio-Internal-Compression"


def stored_compression(md: dict) -> str:
    """The stored compression algorithm under either key spelling
    ('' when the object is not compressed)."""
    return md.get(MK_COMPRESS) or md.get(MK_COMPRESS_LEGACY) or ""


# matches storage.datatypes.to_object_info's actual-size key, so
# ObjectInfo.actual_size is correct for transformed objects too
MK_ACTUAL = "X-Minio-Internal-actual-size"
MK_KMS = "X-Minio-Internal-Sse-Kms-Key-Id"
MK_KMS_SEALED = "X-Minio-Internal-Sse-Kms-Sealed-Key"
MK_KMS_CTX = "X-Minio-Internal-Sse-Kms-Context"

COMPRESSIBLE_EXT = (".txt", ".log", ".csv", ".json", ".tar", ".xml",
                    ".bin")
COMPRESSIBLE_TYPES = ("text/", "application/json", "application/xml",
                      "application/x-tar", "binary/octet-stream")

# the fused PUT's size window (reference MINIO_TPU_SSE_DEVICE_MIN_BYTES
# and _MAX_BYTES at their defaults: 1 MiB, no maximum)
DEVICE_SSE_MIN_BYTES = 1 << 20

# GET decipher batch width: packages per device launch (64 packages =
# 4 MiB of ciphertext)
_GET_PKG_BATCH = 64


def _aesgcm(key: bytes):
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    return AESGCM(key)


def _pkg_nonce(base: bytes, seq: int) -> bytes:
    return base[:8] + bytes(a ^ b for a, b in
                            zip(base[8:12], seq.to_bytes(4, "little")))


def _pkg_aad(seq: int) -> bytes:
    return _AAD + seq.to_bytes(8, "little")


def encrypted_size(n: int) -> int:
    """Stored bytes of an n-byte plaintext: every 64 KiB package (the last
    may be partial) carries a 16-byte tag."""
    if n <= 0:
        return 0
    return n + TAG_SIZE * (-(-n // PKG_SIZE))


def seal_key(sealing_key: bytes, oek: bytes,
             cipher: str = CIPHER_AES) -> bytes:
    """Seal the OEK under `sealing_key`; same nonce||ct||tag layout for
    both ciphers, so MK_SEALED stays one opaque blob."""
    nonce = secrets.token_bytes(12)
    if cipher == CIPHER_CHACHA:
        ct, tag = _c20.seal_detached(sealing_key, nonce, _AAD, oek)
        return nonce + ct + tag
    return nonce + _aesgcm(sealing_key).encrypt(nonce, oek, _AAD)


def unseal_key(sealing_key: bytes, sealed: bytes,
               cipher: str = CIPHER_AES) -> bytes:
    if cipher == CIPHER_CHACHA:
        return _c20.open_detached(sealing_key, sealed[:12], _AAD,
                                  sealed[12:-TAG_SIZE],
                                  sealed[-TAG_SIZE:])
    return _aesgcm(sealing_key).decrypt(sealed[:12], sealed[12:], _AAD)


def stored_sse_cipher(md: dict) -> str:
    """The package cipher an encrypted object was written with."""
    return md.get(MK_CIPHER) or CIPHER_AES


def sse_cipher_for_new_writes() -> str:
    """MINIO_TPU_SSE_CIPHER: `chacha20` opts new writes into the
    ChaCha20-Poly1305 packages the card ciphers; anything else keeps the
    AES-256-GCM default."""
    from ..utils import knobs
    v = knobs.get_str("MINIO_TPU_SSE_CIPHER").strip().lower()
    return CIPHER_CHACHA if v in ("chacha20", "chacha20-poly1305",
                                  "chacha") else CIPHER_AES


# ---------------------------------------------------------------------------
# compression transforms
# ---------------------------------------------------------------------------

class ZstdCompress:
    def __init__(self) -> None:
        import zstandard
        self._c = zstandard.ZstdCompressor().compressobj()

    def update(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def finalize(self) -> bytes:
        return self._c.flush()


def decompress_stream(chunks: Iterator[bytes],
                      algo: str = COMPRESS_ZSTD) -> Iterator[bytes]:
    """Stored-compression decoder, dispatched on the MK_COMPRESS value
    (both S2 v2 and golang/snappy v1 streams ride the framing
    reader)."""
    if algo in (COMPRESS_S2, COMPRESS_SNAPPY_V1):
        from . import snappy as _snappy
        yield from _snappy.decompress_stream(chunks)
        return
    import zstandard
    d = zstandard.ZstdDecompressor().decompressobj()
    for chunk in chunks:
        out = d.decompress(chunk)
        if out:
            yield out


# ---------------------------------------------------------------------------
# AES-256-GCM package stream
# ---------------------------------------------------------------------------

class Encryptor:
    """AES-256-GCM package stream (the DARE-writer analog)."""

    def __init__(self, oek: bytes, nonce_base: bytes):
        self._gcm = _aesgcm(oek)
        self._base = nonce_base
        self._buf = b""
        self._seq = 0

    def _seal(self, pt: bytes) -> bytes:
        ct = self._gcm.encrypt(_pkg_nonce(self._base, self._seq), pt,
                               _pkg_aad(self._seq))
        self._seq += 1
        return ct

    def update(self, data: bytes) -> bytes:
        self._buf += data
        out = b""
        while len(self._buf) >= PKG_SIZE:
            out += self._seal(self._buf[:PKG_SIZE])
            self._buf = self._buf[PKG_SIZE:]
        return out

    def finalize(self) -> bytes:
        if not self._buf:
            return b""
        out = self._seal(self._buf)
        self._buf = b""
        return out


def decrypt_stream(chunks: Iterator[bytes], oek: bytes, nonce_base: bytes,
                   start_seq: int = 0) -> Iterator[bytes]:
    """Ciphertext chunk iterator -> plaintext iterator (DARE reader).
    The input must start exactly at package `start_seq`'s boundary and
    end at a package boundary (the GET path fetches aligned ranges)."""
    gcm = _aesgcm(oek)
    seq = start_seq
    buf = b""
    for chunk in chunks:
        buf += chunk
        while len(buf) >= PKG_SIZE + TAG_SIZE:
            pkg, buf = buf[:PKG_SIZE + TAG_SIZE], buf[PKG_SIZE + TAG_SIZE:]
            yield gcm.decrypt(_pkg_nonce(nonce_base, seq), pkg,
                              _pkg_aad(seq))
            seq += 1
    if buf:
        yield gcm.decrypt(_pkg_nonce(nonce_base, seq), buf, _pkg_aad(seq))


# ---------------------------------------------------------------------------
# ChaCha20-Poly1305 packages (detached tags)
# ---------------------------------------------------------------------------

def chacha_ct_len(stored: int) -> tuple[int, int]:
    """(ciphertext length, package count) of a chacha object from its
    stored size — stored = ct ‖ 16·npkg tag trailer, and every package
    but the last is full, so npkg = ceil(stored / (PKG+TAG))."""
    if stored <= 0:
        return 0, 0
    npkg = -(-stored // (PKG_SIZE + TAG_SIZE))
    return stored - TAG_SIZE * npkg, npkg


class ChaChaEncryptor:
    """ChaCha20-Poly1305 package stream, detached-tag form: update()
    emits pure ciphertext (offset-preserving), finalize() emits the
    final partial package plus the tag trailer. The host byte-identity
    oracle of the device path (DeviceSSE produces the same stream)."""

    def __init__(self, oek: bytes, nonce_base: bytes):
        self._key = oek
        self._base = nonce_base
        self._buf = b""
        self._seq = 0
        self._tags: list[bytes] = []

    def _seal(self, pt: bytes) -> bytes:
        ct, tag = _c20.seal_detached(
            self._key, _pkg_nonce(self._base, self._seq),
            _pkg_aad(self._seq), pt)
        self._tags.append(tag)
        self._seq += 1
        return ct

    def update(self, data: bytes) -> bytes:
        self._buf += data
        out = b""
        while len(self._buf) >= PKG_SIZE:
            out += self._seal(self._buf[:PKG_SIZE])
            self._buf = self._buf[PKG_SIZE:]
        return out

    def finalize(self) -> bytes:
        out = self._seal(self._buf) if self._buf else b""
        self._buf = b""
        return out + b"".join(self._tags)


def chacha_decrypt_ranged(fetch, stored: int, oek: bytes,
                          nonce_base: bytes, offset: int, length: int,
                          device=None, scheduler=None) -> Iterator[bytes]:
    """Verify-then-decrypt a plaintext range of one chacha stream.

    fetch(off, len) -> ciphertext-chunk iterator over the STORED bytes
    (ct ‖ tag trailer) — the engine read seam. Yields plaintext from the
    covering package boundary (callers trim with their skip/take). Every
    package's Poly1305 tag is checked against the trailer before any
    package of its batch is deciphered, so corrupt ciphertext surfaces as
    an authentication error, never as garbled plaintext. Each batch of up
    to _GET_PKG_BATCH packages is deciphered on `device` (None: the card;
    "cpu" runs the kernel's plain version) by the batch former
    `scheduler`, whose dispatch threads hold the device's slot streams
    (packages of concurrent GETs share a launch), or, without one or once
    it closed, by one launch of the ChaCha20 kernel inside a slot taken
    here (object/codec.decipher_packages); a failure raises.
    """
    from .. import device as device_mod
    from ..object.codec import decipher_packages
    from ..s3.s3errors import S3Error
    ct_len, npkg = chacha_ct_len(stored)
    if length <= 0 or ct_len <= 0:
        return
    dev = device_mod.resolve(device)
    start_pkg = offset // PKG_SIZE
    end_pkg = min((offset + length - 1) // PKG_SIZE, npkg - 1)
    tags = b"".join(fetch(ct_len + start_pkg * TAG_SIZE,
                          (end_pkg - start_pkg + 1) * TAG_SIZE))
    coff = start_pkg * PKG_SIZE
    clen = min(ct_len, (end_pkg + 1) * PKG_SIZE) - coff
    kw = np.frombuffer(oek, dtype="<u4")

    def _flush(pkgs: list[bytes], seq0: int) -> Iterator[bytes]:
        # authenticate FIRST: nothing deciphers until every package of
        # the batch carries a valid trailer tag
        for j, pkg in enumerate(pkgs):
            seq = seq0 + j
            at = (seq - start_pkg) * TAG_SIZE
            want = _c20.tag_detached(oek, _pkg_nonce(nonce_base, seq),
                                     _pkg_aad(seq), pkg)
            if not hmac.compare_digest(want, tags[at:at + TAG_SIZE]):
                raise S3Error("InternalError",
                              f"SSE package {seq} failed authentication")
        width = -(-max(len(p) for p in pkgs) // 64) * 64
        rows = np.zeros((len(pkgs), width), dtype=np.uint8)
        for j, pkg in enumerate(pkgs):
            rows[j, :len(pkg)] = np.frombuffer(pkg, np.uint8)
        nn = np.stack([np.frombuffer(_pkg_nonce(nonce_base, seq0 + j),
                                     dtype="<u4")
                       for j in range(len(pkgs))])
        keys = np.broadcast_to(kw, (len(pkgs), 8))
        out = None if scheduler is None else \
            scheduler.submit_decipher(dev, rows, keys, nn).result()
        if out is None:
            out = decipher_packages(dev, rows, keys, nn)
        for j, pkg in enumerate(pkgs):
            yield out[j, :len(pkg)].tobytes()

    buf = b""
    seq = start_pkg
    pend: list[bytes] = []
    for chunk in fetch(coff, clen):
        buf += chunk
        while len(buf) >= PKG_SIZE:
            pend.append(buf[:PKG_SIZE])
            buf = buf[PKG_SIZE:]
            if len(pend) >= _GET_PKG_BATCH:
                yield from _flush(pend, seq)
                seq += len(pend)
                pend = []
    if buf:
        pend.append(buf)
    if pend:
        yield from _flush(pend, seq)


class DeviceSSE:
    """Per-PUT cipher spec for the fused device data path.

    The engine treats this as an opaque capability object: key/nonce word
    arrays for the batch former come from batch_params(), batches the
    codec's size gate keeps on the host are ciphered in place
    byte-identically, and every ciphertext byte is absorbed IN STREAM
    ORDER so the Poly1305 tag trailer — computed on the host over the
    ciphertext the card returned, before commit — can be appended at
    stream end. All derivation stays inside this class."""

    def __init__(self, oek: bytes, nonce_base: bytes):
        self._key = oek
        self._base = nonce_base
        self._kw = np.frombuffer(oek, dtype="<u4")
        self._bw = np.frombuffer(nonce_base, dtype="<u4")
        self._tags: list[bytes] = []
        self._seq = 0
        self._partial = b""

    # -- batch former / device side ------------------------------------

    def batch_params(self, offset: int, nrows: int, row_bytes: int):
        """(keys (B, 8), nonces (B, P, 3)) u32 word arrays for a batch of
        full rows starting at stream offset `offset` (a PKG multiple).
        They ride the batch former's groups; its bucket key holds only
        their SHAPE, so concurrent PUTs under different keys share a
        dispatch."""
        p = row_bytes // PKG_SIZE
        keys = np.broadcast_to(self._kw, (nrows, 8)).copy()
        seqs = (offset // PKG_SIZE
                + np.arange(nrows * p, dtype=np.uint64).reshape(
                    nrows, p)).astype(np.uint32)
        nonces = np.empty((nrows, p, 3), dtype=np.uint32)
        nonces[:, :, 0] = self._bw[0]
        nonces[:, :, 1] = self._bw[1]
        nonces[:, :, 2] = self._bw[2] ^ seqs
        return keys, nonces

    # -- host cipher (byte-identity oracle) ----------------------------

    def cpu_encrypt_rows(self, flat_rows, offset: int) -> None:
        """In-place ChaCha20 over (B, row_bytes) u8 staging-row views: the
        batches the codec's size gate keeps on the host, producing the
        bytes the device kernel would."""
        b, row_bytes = flat_rows.shape
        for i in range(b):
            self.cpu_encrypt_tail(flat_rows[i], offset + i * row_bytes)

    def cpu_encrypt_tail(self, row, offset: int) -> None:
        """In-place ChaCha20 over one row of `len(row)` bytes (full
        packages + optional final partial) at stream offset `offset`."""
        n = row.shape[0]
        seq = offset // PKG_SIZE
        for at in range(0, n, PKG_SIZE):
            _c20.xor_stream_into(row[at:at + PKG_SIZE], self._key,
                                 _pkg_nonce(self._base, seq))
            seq += 1

    # -- host-side authentication (tag trailer) ------------------------

    def _tag(self, pkg: bytes) -> None:
        self._tags.append(_c20.tag_detached(
            self._key, _pkg_nonce(self._base, self._seq),
            _pkg_aad(self._seq), pkg))
        self._seq += 1

    def absorb(self, ct) -> None:
        """Feed ciphertext in stream order (device output or host cipher:
        the bytes are identical); packages close as they fill and their
        tags accumulate for the trailer."""
        mv = memoryview(ct)
        if self._partial:
            need = PKG_SIZE - len(self._partial)
            take = bytes(mv[:need])
            self._partial += take
            mv = mv[len(take):]
            if len(self._partial) == PKG_SIZE:
                self._tag(self._partial)
                self._partial = b""
        full = len(mv) // PKG_SIZE
        for i in range(full):
            self._tag(bytes(mv[i * PKG_SIZE:(i + 1) * PKG_SIZE]))
        rest = mv[full * PKG_SIZE:]
        if len(rest):
            self._partial = bytes(rest)

    def trailer(self) -> bytes:
        """Close the stream: the final partial package's tag plus the
        full tag trailer the engine appends after the ciphertext."""
        if self._partial:
            self._tag(self._partial)
            self._partial = b""
        return b"".join(self._tags)


def device_sse_allowed(size: int) -> bool:
    """The size window of the fused PUT path: a stated size of at least
    DEVICE_SSE_MIN_BYTES. Unknown-length and smaller streams take the host
    ChaChaEncryptor (the same bytes). Whether the kernel or its plain
    version runs is the engine's device's choice. A stream the window
    sends to the host emits one ``device.decline`` record (stage "sse",
    reason "size") per process: the reference records its declines of the
    device there too (minio_tpu/features/crypto.py:494-504), for reasons
    the port does not have (its switch, no device)."""
    if size >= DEVICE_SSE_MIN_BYTES:
        return True
    from ..utils import eventlog
    eventlog.emit_once("device.decline", stage="sse", reason="size")
    return False


# ---------------------------------------------------------------------------
# PutObjReader — raw hashing + transformed payload
# ---------------------------------------------------------------------------

def _finalize_chain(transforms: list) -> bytes:
    """Tail flush: finalize each transform in order, feeding its tail
    through the rest of the chain."""
    out = b""
    for i, t in enumerate(transforms):
        data = t.finalize()
        for t2 in transforms[i + 1:]:
            data = t2.update(data)
        out += data
    return out


class PutObjReader(HashReader):
    """Hashes/verifies the RAW client bytes (ETag semantics) while the
    engine consumes the transformed (compressed/encrypted) stream."""

    def __init__(self, inner: HashReader, transforms: list):
        # no super().__init__: hashing/verification delegate to `inner`
        self._inner = inner
        self._transforms = transforms
        self._out = b""
        self._eof = False

    @property
    def actual_size(self) -> int:           # type: ignore[override]
        return self._inner.actual_size

    @property
    def size(self) -> int:                  # type: ignore[override]
        return -1                            # transformed size unknown

    @property
    def bytes_read(self) -> int:            # type: ignore[override]
        return self._inner.bytes_read

    def verify(self) -> None:
        self._inner.verify()

    def md5_current_hex(self) -> str:
        return self._inner.md5_current_hex()

    def close(self) -> None:
        self._inner.close()

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = 1 << 62
        while len(self._out) < n and not self._eof:
            raw = self._inner.read(1 << 16)
            if raw:
                data = raw
                for t in self._transforms:
                    data = t.update(data)
                self._out += data
            else:
                self._out += _finalize_chain(self._transforms)
                self._eof = True
        out, self._out = self._out[:n], self._out[n:]
        return out

    def readinto_full(self, mv: memoryview) -> int:
        """Transformed streams cannot land zero-copy (the ciphertext is
        produced chunkwise here, not in the caller's buffer): override the
        inherited fast path, which would touch HashReader state this
        wrapper never initializes."""
        want = len(mv)
        got = 0
        while got < want:
            chunk = self.read(want - got)
            if not chunk:
                break
            mv[got:got + len(chunk)] = chunk
            got += len(chunk)
        return got


# ---------------------------------------------------------------------------
# request-level helpers (consumed by the S3 handlers)
# ---------------------------------------------------------------------------

def master_key_from_env() -> Optional[bytes]:
    raw = os.environ.get("MINIO_SSE_MASTER_KEY", "")
    if not raw:
        return None
    try:
        key = bytes.fromhex(raw)
    except ValueError:
        return None
    return key if len(key) == 32 else None


def kms_from_env():
    """The SSE-S3 KMS for this process: MINIO_SSE_MASTER_KEY gives a
    StaticKMS. None = SSE-S3 requests fail with
    ServerSideEncryptionConfigurationNotFoundError."""
    from .kms import StaticKMS
    key = master_key_from_env()
    return StaticKMS(key) if key is not None else None


def parse_ssec_headers(header) -> Optional[bytes]:
    """Returns the 32-byte client key, or None when no SSE-C requested.
    `header` is a callable(name, default="")."""
    algo = header("x-amz-server-side-encryption-customer-algorithm")
    if not algo:
        return None
    from ..s3.s3errors import S3Error
    if algo != "AES256":
        raise S3Error("InvalidEncryptionAlgorithmError")
    try:
        key = base64.b64decode(
            header("x-amz-server-side-encryption-customer-key"))
    except ValueError:
        raise S3Error("InvalidArgument", "bad SSE-C key") from None
    if len(key) != 32:
        raise S3Error("InvalidArgument", "SSE-C key must be 256 bits")
    want_md5 = header("x-amz-server-side-encryption-customer-key-md5")
    have_md5 = base64.b64encode(hashlib.md5(key).digest()).decode()
    if want_md5 and want_md5 != have_md5:
        raise S3Error("InvalidArgument", "SSE-C key MD5 mismatch")
    return key


def is_compressible(key: str, content_type: str) -> bool:
    if any(key.endswith(ext) for ext in COMPRESSIBLE_EXT):
        return True
    return any(content_type.startswith(t) for t in COMPRESSIBLE_TYPES)


def setup_put_transforms(*, key_name: str, raw_reader: HashReader,
                         raw_size: int, metadata: dict,
                         ssec_key: Optional[bytes], sse_s3: bool, kms,
                         compress: bool,
                         compress_algo: str = COMPRESS_S2,
                         cipher: Optional[str] = None,
                         device_sse: bool = False):
    """Build the transformed reader + metadata for a PUT.

    Returns (reader, size, sse_spec) — size is the stored byte count when
    computable, else -1; sse_spec is a DeviceSSE for the engine's fused
    device path (chacha, device_sse=True, and the size window allows) or
    None (the cipher runs as a host transform here). Mutates `metadata`
    with the internal keys.
    """
    transforms: list = []
    size = raw_size
    spec = None

    if compress:
        if compress_algo == COMPRESS_ZSTD:
            metadata[MK_COMPRESS] = COMPRESS_ZSTD
            transforms.append(ZstdCompress())
        else:
            from .snappy import SnappyFramedCompress
            metadata[MK_COMPRESS] = COMPRESS_S2
            transforms.append(SnappyFramedCompress())
        size = -1

    if ssec_key is not None or sse_s3:
        if cipher is None:
            cipher = sse_cipher_for_new_writes()
        oek, nonce_base = create_sse_seals(metadata, ssec_key, sse_s3, kms,
                                           kms_context={"object": key_name},
                                           cipher=cipher)
        if cipher == CIPHER_CHACHA:
            # compressed streams fuse too: the compressor stays a host
            # transform and its output is the "plaintext" the engine
            # ciphers in the encode dispatch (raw_size gates the window,
            # as in the reference; the engine reads the compressed
            # stream to its end whatever its length)
            if device_sse and device_sse_allowed(raw_size):
                # the cipher leaves this chain: the engine fuses it into
                # the encode step and appends the tag trailer
                spec = DeviceSSE(oek, nonce_base)
            else:
                transforms.append(ChaChaEncryptor(oek, nonce_base))
        else:
            transforms.append(Encryptor(oek, nonce_base))
        if size >= 0:
            size = encrypted_size(size)

    if not transforms and spec is None:
        return raw_reader, raw_size, None
    metadata[MK_ACTUAL] = str(raw_size) if raw_size >= 0 else "-1"
    if not transforms:
        # fused path, nothing else in the chain: the engine reads the
        # PLAINTEXT and ciphers in-batch; the stored size is still known
        return raw_reader, size, spec
    return PutObjReader(raw_reader, transforms), size, spec


def create_sse_seals(metadata: dict, ssec_key: Optional[bytes],
                     sse_s3: bool, kms, multipart: bool = False,
                     kms_context: Optional[dict] = None,
                     cipher: Optional[str] = None
                     ) -> Optional[tuple[bytes, bytes]]:
    """Generate + seal a fresh object key into `metadata`; returns
    (object key, nonce base), or None when no SSE was requested.
    Multipart uploads seal at create and encrypt each part later with a
    per-part nonce base (part_nonce).

    SSE-S3 sealing chain (cmd/crypto KES/master shapes): the KMS mints a
    DEK; the per-object key is sealed under the DEK; only the DEK's
    ciphertext (remote KMS) and the sealed OEK persist in metadata."""
    from ..s3.s3errors import S3Error
    if ssec_key is not None:
        sealing = ssec_key
        metadata[MK_SSE] = "C"
        metadata[MK_KEYMD5] = base64.b64encode(
            hashlib.md5(ssec_key).digest()).decode()
    elif sse_s3:
        if kms is None:
            raise S3Error("ServerSideEncryptionConfigurationNotFoundError")
        from .kms import KMSError
        ctx = dict(kms_context or {})
        try:
            dek, dek_ct = kms.generate_key(ctx)
        except KMSError as e:
            # fail closed: a down KMS refuses the PUT, never falls back to
            # plaintext or a stale key
            raise S3Error("InternalError", f"KMS generate-key: {e}") \
                from e
        sealing = dek
        metadata[MK_SSE] = "S3"
        if dek_ct:
            metadata[MK_KMS] = getattr(kms, "key_id", "kms")
            metadata[MK_KMS_SEALED] = base64.b64encode(dek_ct).decode()
            metadata[MK_KMS_CTX] = base64.b64encode(json.dumps(
                ctx, sort_keys=True,
                separators=(",", ":")).encode()).decode()
    else:
        return None
    if cipher is None:
        cipher = sse_cipher_for_new_writes()
    oek = secrets.token_bytes(32)
    nonce_base = secrets.token_bytes(12)
    metadata[MK_SEALED] = base64.b64encode(
        seal_key(sealing, oek, cipher)).decode()
    metadata[MK_IV] = base64.b64encode(nonce_base).decode()
    if cipher == CIPHER_CHACHA:
        metadata[MK_CIPHER] = CIPHER_CHACHA
    if multipart:
        metadata[MK_SSE_MP] = "true"
    return oek, nonce_base


def part_nonce(nonce_base: bytes, part_number: int) -> bytes:
    """Per-part package-nonce base: parts encrypt independently, so each
    needs its own nonce space under the shared object key."""
    return hmac.new(nonce_base, b"part-%d" % part_number,
                    hashlib.sha256).digest()[:12]


def resolve_get_key(info_metadata: dict, header,
                    kms) -> Optional[tuple]:
    """For an encrypted object: returns (oek, nonce_base). Raises on
    missing/wrong keys. None when the object is not encrypted."""
    from ..s3.s3errors import S3Error
    mode = info_metadata.get(MK_SSE, "")
    if not mode:
        return None
    sealed = base64.b64decode(info_metadata.get(MK_SEALED, ""))
    nonce_base = base64.b64decode(info_metadata.get(MK_IV, ""))
    if mode == "C":
        key = parse_ssec_headers(header)
        if key is None:
            raise S3Error("AccessDenied",
                          "object is SSE-C encrypted; key required")
        if base64.b64encode(hashlib.md5(key).digest()).decode() != \
                info_metadata.get(MK_KEYMD5, ""):
            raise S3Error("AccessDenied", "SSE-C key does not match")
        sealing = key
    else:
        if kms is None:
            raise S3Error("ServerSideEncryptionConfigurationNotFoundError")
        from .kms import KMSError
        dek_ct = base64.b64decode(info_metadata.get(MK_KMS_SEALED, ""))
        try:
            ctx = json.loads(base64.b64decode(
                info_metadata.get(MK_KMS_CTX, "") or "e30=").decode())
        except (ValueError, UnicodeDecodeError):
            ctx = {}
        try:
            sealing = kms.decrypt_key(dek_ct, ctx,
                                      key_id=info_metadata.get(MK_KMS, ""))
        except KMSError as e:
            raise S3Error("InternalError", f"KMS decrypt-key: {e}") \
                from e
    try:
        oek = unseal_key(sealing, sealed, stored_sse_cipher(info_metadata))
    except Exception:  # noqa: BLE001 — any unseal failure is a bad key
        raise S3Error("AccessDenied", "unable to unseal object key") \
            from None
    return oek, nonce_base
