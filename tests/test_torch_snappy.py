"""The port's S2-interop compression (minio_tpu_torch/features/snappy.py)
held against minio_tpu's.

tests/test_snappy.py's cases rebound to the port's copies (golden
vectors, native/pure-Python cross-checks, the framing reader's error
modes, crypto's dispatch by stored algorithm, and a live port server
writing S2 objects with zstd behind config; the config-KV case becomes
the handlers reading MINIO_COMPRESS and MINIO_COMPRESS_ALGORITHM, since
the port has no ConfigSys); then block and framed streams byte-equal with
the reference's on seeded inputs, on the native library and on both
packages' pure-Python fallbacks, and an S2 extended repeat failing
mid-stream as the reference's does.
"""

from __future__ import annotations

import hashlib
import http.client
import os
import random
import struct
import urllib.parse

import numpy as np
import pytest

from minio_tpu.features import crypto as ref_sse
from minio_tpu.features import snappy as ref_sn
from minio_tpu_torch.features import crypto as sse
from minio_tpu_torch.features import snappy as sn
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3 import signature as sig
from minio_tpu_torch.s3.credentials import Credentials
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.utils import native

CREDS = Credentials("snaptestkey1", "snaptestsecret1")
REGION = "us-east-1"


# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

def test_crc32c_known_vectors():
    # RFC 3720 test vector
    assert sn.crc32c(b"123456789") == 0xE3069283
    assert sn._crc32c_py(b"123456789") == 0xE3069283
    assert sn.crc32c(b"") == 0
    # 32 zero bytes (iSCSI vector)
    assert sn.crc32c(bytes(32)) == 0x8A9136AA
    # native and python agree on arbitrary data
    data = os.urandom(1000)
    assert sn.crc32c(data) == sn._crc32c_py(data)


# ---------------------------------------------------------------------------
# block format
# ---------------------------------------------------------------------------

def test_block_golden_vector():
    """golang/snappy output for 30 x 'a': varint(30), 1-byte literal,
    copy2(offset 1, length 29) — any spec-compliant decoder reads it."""
    blob = bytes.fromhex("1e0061720100")
    assert sn.uncompress_block(blob) == b"a" * 30
    assert sn._uncompress_block_py(blob, 1 << 20) == b"a" * 30


def test_block_roundtrip_matrix():
    cases = [b"", b"a", b"ab" * 5, b"hello world " * 1000,
             os.urandom(65536), bytes(65536), os.urandom(17),
             b"x" * 65536, os.urandom(65535),
             (b"The quick brown fox. " * 4000)[:65536]]
    for data in cases:
        c = sn.compress_block(data)
        assert sn.uncompress_block(c) == data, len(data)
        # the pure-python decoder is an independent spec reading
        assert sn._uncompress_block_py(c, 1 << 24) == data, len(data)


def test_block_fuzz_roundtrip():
    rng = random.Random(7)
    for trial in range(100):
        n = rng.randrange(0, 65536)
        base = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(1, 300)))
        data = (base * (n // max(len(base), 1) + 1))[:n]
        if rng.random() < 0.5:
            data = bytes(rng.randrange(256) for _ in range(n))
        c = sn.compress_block(data)
        assert sn.uncompress_block(c) == data, (trial, n)


def test_s2_repeat_offset_decode():
    """S2 extension: copy1 with offset 0 repeats the previous offset —
    'abcd' + copy(4,4) + repeat(4) = 'abcd'*3."""
    blk = bytes([12, 3 << 2]) + b"abcd" + bytes([1, 4]) + bytes([1, 0])
    want = b"abcd" * 3
    assert sn.uncompress_block(blk) == want
    assert sn._uncompress_block_py(blk, 1 << 20) == want


def test_s2_extended_repeat_refused_cleanly():
    # repeat (offset 0) with length code 5 -> extended form we refuse
    blk = bytes([12, 3 << 2]) + b"abcd" + bytes([1, 4]) + \
        bytes([(5 << 2) | 1, 0])
    with pytest.raises(NotImplementedError):
        sn.uncompress_block(blk)
    with pytest.raises(NotImplementedError):
        sn._uncompress_block_py(blk, 1 << 20)


def test_block_corruption_detected():
    with pytest.raises((ValueError, sn.SnappyError)):
        sn.uncompress_block(b"\xff\xff\xff\xff\xff\xff")   # bad varint
    # copy beyond output start
    with pytest.raises((ValueError, sn.SnappyError)):
        sn.uncompress_block(bytes([4, 0 << 2]) + b"a" + bytes([1, 9]))


# ---------------------------------------------------------------------------
# framing format
# ---------------------------------------------------------------------------

def _frame_uncompressed(data: bytes) -> bytes:
    body = struct.pack("<I", sn.masked_crc(data)) + data
    return bytes([0x01]) + len(body).to_bytes(3, "little") + body


def test_framing_golden_handbuilt():
    """Hand-built per framing_format.txt: ident + one uncompressed
    chunk; also with padding and skippable chunks interleaved."""
    hand = sn.STREAM_IDENT + _frame_uncompressed(b"hello")
    assert b"".join(sn.decompress_stream(iter([hand]))) == b"hello"

    blk = bytes([5, 4 << 2]) + b"hello"          # literal block
    comp = sn.STREAM_IDENT + bytes([0x00]) + \
        (4 + len(blk)).to_bytes(3, "little") + \
        struct.pack("<I", sn.masked_crc(b"hello")) + blk
    assert b"".join(sn.decompress_stream(iter([comp]))) == b"hello"

    # padding (0xfe) and skippable (0x80) chunks are transparent
    pad = bytes([0xfe]) + (3).to_bytes(3, "little") + b"\0\0\0"
    skip = bytes([0x80]) + (2).to_bytes(3, "little") + b"zz"
    mixed = sn.STREAM_IDENT + pad + _frame_uncompressed(b"ab") + skip \
        + _frame_uncompressed(b"cd")
    assert b"".join(sn.decompress_stream(iter([mixed]))) == b"abcd"


def test_framing_accepts_s2_writer_magic():
    """The reference's s2.NewWriter stamps \\xff 06 00 00 'S2sTwO';
    chunk layout is otherwise identical — a reference-written stream
    of snappy-subset blocks must decode."""
    s2_ident = b"\xff\x06\x00\x00" + sn.S2_IDENT_BODY
    stream = s2_ident + _frame_uncompressed(b"from-the-reference")
    got = b"".join(sn.decompress_stream(iter([stream])))
    assert got == b"from-the-reference"


def test_legacy_capital_c_metadata_key_still_reads():
    """Objects written by the pre-r5 build carry
    X-Minio-Internal-Compression (capital C) = zstd; reads must keep
    decoding them after the key/default change."""
    payload = b"old-object " * 400
    z = sse.ZstdCompress()
    blob = z.update(payload) + z.finalize()
    md = {sse.MK_COMPRESS_LEGACY: "zstd"}
    assert sse.stored_compression(md) == "zstd"
    got = b"".join(sse.decompress_stream(
        iter([blob]), sse.stored_compression(md)))
    assert got == payload


def test_framing_error_modes():
    good = _frame_uncompressed(b"hello")
    # missing stream identifier
    with pytest.raises(sn.SnappyError):
        list(sn.decompress_stream(iter([good])))
    # corrupt CRC
    bad = bytearray(sn.STREAM_IDENT + good)
    bad[-1] ^= 1
    with pytest.raises(sn.SnappyError):
        list(sn.decompress_stream(iter([bytes(bad)])))
    # reserved unskippable chunk
    res = sn.STREAM_IDENT + bytes([0x02]) + (1).to_bytes(3, "little") \
        + b"x"
    with pytest.raises(sn.SnappyError):
        list(sn.decompress_stream(iter([res])))
    # truncated frame
    with pytest.raises(sn.SnappyError):
        list(sn.decompress_stream(iter([sn.STREAM_IDENT + good[:-2]])))


def test_framing_roundtrip_chunked():
    payload = (b"The quick brown fox jumps. " * 10000) + \
        os.urandom(150000)
    t = sn.SnappyFramedCompress()
    framed = t.update(payload[:77]) + t.update(payload[77:]) + \
        t.finalize()
    assert framed.startswith(sn.STREAM_IDENT)
    # arbitrary re-chunking on the read side
    pieces = [framed[i:i + 7777] for i in range(0, len(framed), 7777)]
    assert b"".join(sn.decompress_stream(iter(pieces))) == payload
    # empty payload still emits a valid (ident-only) stream
    t2 = sn.SnappyFramedCompress()
    empty = t2.finalize()
    assert empty == sn.STREAM_IDENT
    assert b"".join(sn.decompress_stream(iter([empty]))) == b""


def test_crypto_dispatch_by_metadata_value():
    """crypto.decompress_stream picks the decoder from the stored
    MK_COMPRESS value: s2/v1 -> framing reader, zstd -> zstd."""
    payload = b"dispatch-me " * 5000
    t = sn.SnappyFramedCompress()
    framed = t.update(payload) + t.finalize()
    for algo in (sse.COMPRESS_S2, sse.COMPRESS_SNAPPY_V1):
        got = b"".join(sse.decompress_stream(iter([framed]), algo))
        assert got == payload, algo
    z = sse.ZstdCompress()
    zblob = z.update(payload) + z.finalize()
    got = b"".join(sse.decompress_stream(iter([zblob]),
                                         sse.COMPRESS_ZSTD))
    assert got == payload


# ---------------------------------------------------------------------------
# live server: interop-default compression, zstd behind config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("snapdrives")
    sets = ErasureSets.from_drives(
        [str(root / f"d{i}") for i in range(4)], 1, 4, 2,
        block_size=1 << 17, device="cpu")
    srv = S3Server(sets, creds=CREDS, region=REGION).start()
    srv.api.compression_enabled = True
    yield srv
    srv.stop()
    sets.close()


def _req(srv, method, path, body=b"", headers=None):
    hdrs = {k.lower(): v for k, v in (headers or {}).items()}
    hdrs["host"] = f"127.0.0.1:{srv.port}"
    ph = hashlib.sha256(body).hexdigest()
    hdrs = sig.sign_v4(method, urllib.parse.quote(path), {}, hdrs, ph,
                       CREDS, REGION)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request(method, urllib.parse.quote(path), body=body,
                 headers=hdrs)
    resp = conn.getresponse()
    data = resp.read()
    out = {k.lower(): v for k, v in resp.getheaders()}
    conn.close()
    return resp.status, out, data


def test_server_writes_s2_interop_objects(server):
    srv = server
    assert _req(srv, "PUT", "/snapbkt")[0] == 200
    payload = (b"compress me please, I am very repetitive. " * 8000)
    st, _, _ = _req(srv, "PUT", "/snapbkt/doc.txt", body=payload,
                    headers={"content-type": "text/plain"})
    assert st == 200

    # stored form: reference metadata value + snappy framing magic,
    # i.e. byte-valid input for the reference's s2.NewReader
    info = srv.api.obj.get_object_info("snapbkt", "doc.txt")
    assert info.user_defined.get(sse.MK_COMPRESS) == sse.COMPRESS_S2
    assert info.size < len(payload)
    _, stream = srv.api.obj.get_object("snapbkt", "doc.txt", 0,
                                       len(sn.STREAM_IDENT))
    assert b"".join(stream) == sn.STREAM_IDENT

    # decodes through the framing reader on GET, full + ranged
    st, hdrs, data = _req(srv, "GET", "/snapbkt/doc.txt")
    assert st == 200 and data == payload
    assert hdrs["content-length"] == str(len(payload))
    st, _, data = _req(srv, "GET", "/snapbkt/doc.txt",
                       headers={"range": "bytes=100000-100099"})
    assert st == 206 and data == payload[100000:100100]


def test_server_zstd_behind_config(server):
    srv = server
    srv.api.compression_algorithm = "zstd"
    try:
        payload = b"zstd-configured object body " * 6000
        st, _, _ = _req(srv, "PUT", "/snapbkt/legacy.txt",
                        body=payload,
                        headers={"content-type": "text/plain"})
        assert st == 200
        info = srv.api.obj.get_object_info("snapbkt", "legacy.txt")
        assert info.user_defined.get(sse.MK_COMPRESS) == \
            sse.COMPRESS_ZSTD
    finally:
        srv.api.compression_algorithm = "s2"
    # both algorithms readable side by side (old r4 objects keep
    # decoding after the default flip)
    st, _, data = _req(srv, "GET", "/snapbkt/legacy.txt")
    assert st == 200 and data == payload
    st, _, data = _req(srv, "GET", "/snapbkt/doc.txt")
    assert st == 200


def test_server_reads_v1_snappy_objects(server):
    """An object tagged with the v1 value (golang/snappy framed stream
    — byte-identical framing) reads back decoded."""
    srv = server
    payload = b"v1-compressed object " * 3000
    t = sn.SnappyFramedCompress()
    framed = t.update(payload) + t.finalize()
    from minio_tpu_torch.object.engine import PutOptions
    srv.api.obj.put_object(
        "snapbkt", "v1obj.txt", framed, len(framed),
        PutOptions(metadata={
            "etag": hashlib.md5(payload).hexdigest(),
            sse.MK_COMPRESS: sse.COMPRESS_SNAPPY_V1,
            sse.MK_ACTUAL: str(len(payload))}))
    st, _, data = _req(srv, "GET", "/snapbkt/v1obj.txt")
    assert st == 200 and data == payload


def test_server_reads_pre_r5_legacy_key_objects(server):
    """e2e: an on-disk object whose metadata carries the old capital-C
    key serves decoded through the GET path."""
    srv = server
    payload = b"pre-r5 stored object " * 2500
    z = sse.ZstdCompress()
    blob = z.update(payload) + z.finalize()
    from minio_tpu_torch.object.engine import PutOptions
    srv.api.obj.put_object(
        "snapbkt", "old.txt", blob, len(blob),
        PutOptions(metadata={
            "etag": hashlib.md5(payload).hexdigest(),
            sse.MK_COMPRESS_LEGACY: "zstd",
            sse.MK_ACTUAL: str(len(payload))}))
    st, hdrs, data = _req(srv, "GET", "/snapbkt/old.txt")
    assert st == 200 and data == payload
    assert hdrs["content-length"] == str(len(payload))


def test_compression_algorithm_config_kv(tmp_path, monkeypatch):
    """The port has no config KV: its handlers take compression's switch
    and algorithm from MINIO_COMPRESS and MINIO_COMPRESS_ALGORITHM, as the
    reference's handlers do before a ConfigSys applies its "compression"
    subsystem (default off, algorithm s2)."""
    from minio_tpu_torch.s3.handlers import S3ApiHandlers
    sets = ErasureSets.from_drives(
        [str(tmp_path / f"cfg{i}") for i in range(4)], 1, 4, 2,
        block_size=1 << 16, device="cpu")
    try:
        monkeypatch.delenv("MINIO_COMPRESS", raising=False)
        monkeypatch.delenv("MINIO_COMPRESS_ALGORITHM", raising=False)
        api = S3ApiHandlers(sets)
        assert not api.compression_enabled
        assert api.compression_algorithm == "s2"
        assert api._compress_algo() == sse.COMPRESS_S2
        monkeypatch.setenv("MINIO_COMPRESS", "on")
        monkeypatch.setenv("MINIO_COMPRESS_ALGORITHM", "zstd")
        api = S3ApiHandlers(sets)
        assert api.compression_enabled
        assert api.compression_algorithm == "zstd"
        assert api._compress_algo() == sse.COMPRESS_ZSTD
    finally:
        sets.close()


# ---------------------------------------------------------------------------
# the port's codec against minio_tpu's, byte for byte
# ---------------------------------------------------------------------------

def _corpus(seed: int) -> list[bytes]:
    """Seeded inputs: empty, short, repetitive text, TPC-H-like CSV,
    random bytes, runs, and sizes around the 65,536-byte chunk."""
    from minio_tpu_torch.scripts import scan_cases
    rng = np.random.default_rng(seed)
    text = b"".join(rng.choice([b"alpha ", b"beta ", b"gamma\n", b"42,"],
                               size=20_000))
    return [b"", b"x", rng.bytes(17), text[:65535], text[:65536],
            text[:65537], text, rng.bytes(65536), bytes(200_000),
            scan_cases.lineitem_csv(2000, seed), rng.bytes(150_001)]


@pytest.fixture(params=["native", "python"])
def codec_path(request, monkeypatch):
    """Both packages' block codec and CRC on the native library, or both
    on their pure-Python fallbacks (the all-literal writer)."""
    if request.param == "native":
        assert native.snappy_available()
    else:
        from minio_tpu.utils import native as ref_native
        monkeypatch.setattr(native, "snappy_available", lambda: False)
        monkeypatch.setattr(ref_native, "snappy_available", lambda: False)
    return request.param


def test_blocks_equal_reference(codec_path):
    for data in _corpus(1):
        for at in range(0, max(len(data), 1), sn.MAX_BLOCK):
            blk = data[at:at + sn.MAX_BLOCK]
            got = sn.compress_block(blk)
            assert got == ref_sn.compress_block(blk), (codec_path, len(blk))
            assert sn.uncompress_block(got) == blk
            assert sn._uncompress_block_py(got, 1 << 24) == blk
        assert sn.crc32c(data) == ref_sn.crc32c(data)
        assert sn.masked_crc(data) == ref_sn.masked_crc(data)


def test_framed_streams_equal_reference(codec_path):
    rng = np.random.default_rng(2)
    for data in _corpus(2):
        cuts = sorted(int(c) for c in rng.integers(0, len(data) + 1, 5))
        pieces = [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]
        ours, theirs = sn.SnappyFramedCompress(), \
            ref_sn.SnappyFramedCompress()
        got = b"".join(ours.update(p) for p in pieces) + ours.finalize()
        want = b"".join(theirs.update(p) for p in pieces) + \
            theirs.finalize()
        assert got == want, (codec_path, len(data))
        assert b"".join(sn.decompress_stream(iter([got]))) == data
        assert b"".join(ref_sn.decompress_stream(iter([got]))) == data
    if codec_path == "native":
        # the native writer compresses; the fallback writes all literals
        text = _corpus(2)[6]
        t = sn.SnappyFramedCompress()
        assert len(t.update(text) + t.finalize()) < len(text) // 2


def test_extended_repeat_fails_mid_stream_as_reference():
    """A framed stream whose second chunk holds an S2 extended repeat:
    both packages yield the first chunk, then raise NotImplementedError
    (the reference's caveat: after the 200, mid-stream)."""
    blk = bytes([12, 3 << 2]) + b"abcd" + bytes([1, 4]) + \
        bytes([(5 << 2) | 1, 0])
    first = _frame_uncompressed(b"first chunk")
    bad = bytes([0x00]) + (4 + len(blk)).to_bytes(3, "little") + \
        struct.pack("<I", sn.masked_crc(b"abcd" * 3)) + blk
    stream = sn.STREAM_IDENT + first + bad
    for mod in (sn, ref_sn):
        it = mod.decompress_stream(iter([stream]))
        assert next(it) == b"first chunk"
        with pytest.raises(NotImplementedError):
            next(it)
