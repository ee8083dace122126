"""Snappy framing format — the S2-interoperable compression codec.

Counterpart of minio_tpu/features/snappy.py, whole. The reference
compresses objects with S2 (`newS2CompressReader`,
cmd/object-api-utils.go:869) and reads them back through `s2.NewReader`
(cmd/object-api-utils.go:697), tagging them
``X-Minio-Internal-compression: klauspost/compress/s2``. Snappy's
framing format + block format is a strict subset of S2's stream format,
so everything this writer emits is byte-valid input to the reference's
reader. Reading reference-written streams works for the snappy subset
plus S2's basic repeat-offsets; the extended repeat-length encodings
raise NotImplementedError (mid-stream, as in minio_tpu), and every chunk
is CRC32C-verified so a bad decode can never pass silently.

Framing layout (the public snappy framing_format.txt):

    ff 06 00 00 "sNaPpY"                       stream identifier
    00 <len24> <crc32c-masked> <snappy block>  compressed chunk
    01 <len24> <crc32c-masked> <raw bytes>     uncompressed chunk
    fe ...                                     padding (skipped)
    80-fd ...                                  skippable (skipped)
    02-7f                                      reserved -> error

Chunk payloads cover <= 65536 uncompressed bytes; the CRC is over the
UNCOMPRESSED data, masked ((crc>>15 | crc<<17) + 0xa282ead8). S2
writers emit larger chunks (up to 4 MiB) — the reader here accepts
them.

The hot byte work (LZ match finding, CRC32C) runs in the repo's native
C++ (native/snappy.cpp, built by utils/native); without the native
library the writer degrades to spec-valid all-literal blocks and a
table-driven Python CRC, as minio_tpu's does: the same wire format, no
compression win. The pure-Python block decoder (_uncompress_block_py)
is the plain oracle of the native one.
"""

from __future__ import annotations

import struct
from typing import Iterator

from ..utils import native

STREAM_IDENT = b"\xff\x06\x00\x00sNaPpY"
# s2.NewWriter (the reference's writer) stamps its own magic; the
# chunk layout is identical and snappy-subset blocks decode the same
S2_IDENT_BODY = b"S2sTwO"
MAX_BLOCK = 65536                 # max uncompressed bytes per chunk
_MAX_READ_BLOCK = 4 << 20         # S2 writers may emit up to 4 MiB
_CRC_MASK_DELTA = 0xa282ead8

_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_PADDING = 0xfe
_CHUNK_STREAM_IDENT = 0xff


class SnappyError(ValueError):
    """Corrupt or unsupported snappy/S2 stream."""


# ---------------------------------------------------------------------------
# CRC32C (masked, per the framing spec)
# ---------------------------------------------------------------------------

_PY_CRC_TABLE = None


def _crc32c_py(data) -> int:
    global _PY_CRC_TABLE
    if _PY_CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82f63b78 ^ (c >> 1)) if c & 1 else c >> 1
            table.append(c)
        _PY_CRC_TABLE = table
    crc = 0xffffffff
    tab = _PY_CRC_TABLE
    for b in bytes(data):
        crc = tab[(crc ^ b) & 0xff] ^ (crc >> 8)
    return crc ^ 0xffffffff


def crc32c(data) -> int:
    if native.snappy_available():
        return native.crc32c(data)
    return _crc32c_py(data)


def masked_crc(data) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + _CRC_MASK_DELTA & 0xffffffff


# ---------------------------------------------------------------------------
# block codec (native fast path, pure-python fallback)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = b""
    while n >= 0x80:
        out += bytes([n & 0x7f | 0x80])
        n >>= 7
    return out + bytes([n])


def compress_block(data) -> bytes:
    """One snappy block (<= MAX_BLOCK bytes). Falls back to a spec-
    valid all-literal encoding without the native library."""
    data = bytes(data)
    if native.snappy_available():
        return native.snappy_compress_block(data)
    n1 = len(data) - 1
    if len(data) == 0:
        return _varint(0)
    if n1 < 60:
        tag = bytes([n1 << 2])
    else:
        tag = bytes([61 << 2, n1 & 0xff, n1 >> 8])
    return _varint(len(data)) + tag + data


def uncompress_block(data, max_out: int = _MAX_READ_BLOCK) -> bytes:
    if native.snappy_available():
        return native.snappy_uncompress_block(bytes(data), max_out)
    return _uncompress_block_py(bytes(data), max_out)


def _uncompress_block_py(src: bytes, max_out: int) -> bytes:
    """Pure-python snappy/S2 block decode (same subset as the C
    kernel: snappy + basic repeat-offsets)."""
    s, want, shift = 0, 0, 0
    while True:
        if s >= len(src) or shift > 63:
            raise SnappyError("corrupt block header")
        b = src[s]
        s += 1
        want |= (b & 0x7f) << shift
        if not b & 0x80:
            break
        shift += 7
    if want > max_out:
        raise SnappyError("block too large")
    dst = bytearray()
    last_offset = 0
    while s < len(src):
        tag = src[s]
        kind = tag & 3
        if kind == 0:                       # literal
            length = tag >> 2
            s += 1
            if length >= 60:
                extra = length - 59
                if s + extra > len(src):
                    raise SnappyError("truncated literal length")
                length = int.from_bytes(src[s:s + extra], "little")
                s += extra
            length += 1
            if s + length > len(src) or len(dst) + length > max_out:
                raise SnappyError("truncated literal")
            dst += src[s:s + length]
            s += length
            continue
        if kind == 1:                       # copy1 / S2 repeat
            if s + 2 > len(src):
                raise SnappyError("truncated copy1")
            length = (tag >> 2) & 0x7
            offset = ((tag & 0xe0) << 3) | src[s + 1]
            s += 2
            if offset == 0:
                if length >= 5:
                    raise NotImplementedError(
                        "S2 extended repeat encoding outside the "
                        "decoded subset")
                offset = last_offset
                if offset == 0:
                    raise SnappyError("repeat before any copy")
            length += 4
        elif kind == 2:                     # copy2
            if s + 3 > len(src):
                raise SnappyError("truncated copy2")
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[s + 1:s + 3], "little")
            s += 3
            if offset == 0:
                raise NotImplementedError("S2 extended repeat")
        else:                               # copy4
            if s + 5 > len(src):
                raise SnappyError("truncated copy4")
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[s + 1:s + 5], "little")
            s += 5
            if offset == 0:
                raise NotImplementedError("S2 extended repeat")
        if offset > len(dst) or len(dst) + length > max_out:
            raise SnappyError("copy out of range")
        last_offset = offset
        for _ in range(length):             # handles overlap correctly
            dst.append(dst[-offset])
    if len(dst) != want:
        raise SnappyError("length mismatch")
    return bytes(dst)


# ---------------------------------------------------------------------------
# framing: streaming transforms (the compression codec interface)
# ---------------------------------------------------------------------------

class SnappyFramedCompress:
    """update/finalize transform emitting the snappy framing format
    (drop-in peer of crypto.ZstdCompress). A chunk whose snappy block
    doesn't shrink is written as an uncompressed chunk, per spec."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._started = False

    def _frame(self, block: bytes) -> bytes:
        comp = compress_block(block)
        crc = struct.pack("<I", masked_crc(block))
        if len(comp) < len(block):
            payload = crc + comp
            kind = _CHUNK_COMPRESSED
        else:
            payload = crc + block
            kind = _CHUNK_UNCOMPRESSED
        return bytes([kind]) + struct.pack("<I", len(payload))[:3] + \
            payload

    def update(self, data: bytes) -> bytes:
        self._buf += data
        out = bytearray()
        if not self._started:
            out += STREAM_IDENT
            self._started = True
        while len(self._buf) >= MAX_BLOCK:
            out += self._frame(bytes(self._buf[:MAX_BLOCK]))
            del self._buf[:MAX_BLOCK]
        return bytes(out)

    def finalize(self) -> bytes:
        out = bytearray()
        if not self._started:
            out += STREAM_IDENT
            self._started = True
        if self._buf:
            out += self._frame(bytes(self._buf))
            self._buf.clear()
        return bytes(out)


def decompress_stream(chunks: Iterator[bytes]) -> Iterator[bytes]:
    """Framed snappy/S2 stream -> plaintext chunks, CRC-verified.
    Accepts streams from this writer, golang/snappy (compression v1),
    and the reference's s2.NewWriter (within the decoded block
    subset)."""
    buf = bytearray()
    first = True
    it = iter(chunks)

    def fill(n: int) -> bool:
        while len(buf) < n:
            try:
                buf.extend(next(it))
            except StopIteration:
                return False
        return True

    while True:
        if not fill(4):
            if buf:
                raise SnappyError("truncated frame header")
            return
        kind = buf[0]
        length = int.from_bytes(buf[1:4], "little")
        if not fill(4 + length):
            raise SnappyError("truncated frame body")
        body = bytes(buf[4:4 + length])
        del buf[:4 + length]
        if kind == _CHUNK_STREAM_IDENT:
            # legal at any point (stream concatenation), required
            # first; the reference's s2.NewWriter stamps "S2sTwO"
            if length != 6 or body not in (STREAM_IDENT[4:],
                                           S2_IDENT_BODY):
                raise SnappyError("bad stream identifier")
            first = False
            continue
        if kind == _CHUNK_COMPRESSED or kind == _CHUNK_UNCOMPRESSED:
            if first:
                raise SnappyError("missing stream identifier")
            if length < 4:
                raise SnappyError("chunk too short")
            want_crc = struct.unpack("<I", body[:4])[0]
            data = body[4:] if kind == _CHUNK_UNCOMPRESSED else \
                uncompress_block(body[4:])
            if masked_crc(data) != want_crc:
                raise SnappyError("chunk CRC mismatch")
            if data:
                yield data
            continue
        if kind == _CHUNK_PADDING or 0x80 <= kind <= 0xfd:
            continue
        raise SnappyError(f"reserved unskippable chunk 0x{kind:02x}")
