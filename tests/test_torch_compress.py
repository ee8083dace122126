"""The port's inline compression held against minio_tpu's, byte for byte.

  * features/crypto.setup_put_transforms with compression: S2 and zstd,
    alone, under SSE-S3 and under SSE-C, with and without the fused device
    cipher (the port's DeviceSSE takes the compressed stream of unknown
    length; the reference's gate keeps its cipher on the host here): the
    metadata and the stored bytes equal the reference's, with object keys
    and nonces drawn from one pinned generator in both packages;
  * twin servers (the reference's and the port's S3Server over their own
    sets, MINIO_COMPRESS on, identities pinned as tests/test_torch_s3.py
    pins them) fed one signed request sequence under both transports and
    both algorithms: CSV, JSON Lines, a compressible .bin, an incompressible
    .jpg, an empty object, SSE-S3 and SSE-C objects; whole, ranged and
    HEAD; listings; copies kept verbatim, REPLACEd, re-encrypted and
    decrypted; Selects over a compressed CSV on the port's scan plane;
    deletes: equal statuses, bodies and headers, then equal drive files;
  * compressed objects written through either package's server read back,
    whole, ranged and Selected, through the other's over the same drives;
  * a zstd PUT where `zstandard` does not import: both servers fail it
    alike and store nothing.

The port runs on the host (device="cpu"): its codec's size gate is at 0 so
that every batch, the compressed SSE ones included, takes the fused steps'
plain versions.
"""

from __future__ import annotations

import hashlib
import io
import random
import sys

import numpy as np
import pytest

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
from minio_tpu.features import kms as ref_kms
from minio_tpu.object.hash_reader import HashReader as RefHashReader
from minio_tpu_torch.features import kms as port_kms
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.hash_reader import HashReader
from minio_tpu_torch.scripts import scan_cases
from tests.test_s3 import S3TestClient
from tests.test_torch_s3 import (SSE_S3, SSEC, _creation_dates,  # noqa: F401
                                 _deadline, _norm, _one_torch_thread,
                                 _port_server, _ref_server, drive_files,
                                 pin, sse_env)

MASTER = bytes(range(200, 232))
SSEC_KEY = bytes(range(32))
PORT_ALGOS = {"s2": port_crypto.COMPRESS_S2, "zstd": port_crypto.COMPRESS_ZSTD}


@pytest.fixture
def gate(monkeypatch):
    """The port codec's size gate at 0: every batch takes the fused steps
    (on CPU tensors, their plain versions)."""
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)


class _Keys:
    """token_bytes from one seeded generator: both packages draw the same
    object keys, nonce bases and seal nonces in the same order."""

    def __init__(self):
        self.rng = np.random.default_rng(7)

    def token_bytes(self, n):
        return self.rng.bytes(n)


def _corpus(seed: int) -> dict[str, bytes]:
    rng = np.random.default_rng(seed)
    row = rng.bytes(40)
    return {
        "t.csv": scan_cases.lineitem_csv(12_000, seed),         # ~1.47 MB
        "d.json": scan_cases.json_corpus(random.Random(seed), 2000),
        "b.bin": b"".join(row[:int(n)] for n in
                          rng.integers(1, 40, 30_000)),
        "p.jpg": rng.bytes(300_001),
        "e.txt": b""}


# -- setup_put_transforms -------------------------------------------------

def _transform(mod, kms_mod, pt, algo, mode, device_sse):
    md = {}
    hr = (HashReader if mod is port_crypto else RefHashReader)(
        io.BytesIO(pt), len(pt))
    reader, size, spec = mod.setup_put_transforms(
        key_name="o", raw_reader=hr, raw_size=len(pt), metadata=md,
        ssec_key=SSEC_KEY if mode == "sse-c" else None,
        sse_s3=mode == "sse-s3", kms=kms_mod.StaticKMS(MASTER),
        compress=True, compress_algo=algo, cipher=mod.CIPHER_CHACHA,
        device_sse=device_sse)
    return reader, size, spec, md


@pytest.mark.parametrize("device_sse", [False, True])
@pytest.mark.parametrize("mode", ["none", "sse-s3", "sse-c"])
@pytest.mark.parametrize("algo", ["s2", "zstd"])
def test_setup_put_transforms_equal_reference(tmp_path, monkeypatch, gate,
                                              algo, mode, device_sse):
    monkeypatch.setattr(ref_crypto, "secrets", _Keys())
    monkeypatch.setattr(port_crypto, "secrets", _Keys())
    pt = _corpus(1)["t.csv"]
    reader, size, spec, md = _transform(port_crypto, port_kms, pt,
                                        PORT_ALGOS[algo], mode, device_sse)
    ref_reader, ref_size, ref_spec, ref_md = _transform(
        ref_crypto, ref_kms, pt, PORT_ALGOS[algo], mode, device_sse)
    assert ref_spec is None
    assert md == ref_md and size == ref_size == -1
    assert md[port_crypto.MK_COMPRESS] == PORT_ALGOS[algo]
    assert md[port_crypto.MK_ACTUAL] == str(len(pt))
    want = ref_reader.read()
    # the fused cipher takes the compressed stream only under device_sse
    assert (spec is not None) == (device_sse and mode != "none")
    assert isinstance(reader, port_crypto.PutObjReader)
    if spec is None:
        assert reader.read() == want
    else:
        # the engine ciphers the compressed stream in its encode step and
        # appends the tag trailer: the stored bytes are the host chain's
        eng = port_engine.from_reference_layout(
            [str(tmp_path / f"d{i}") for i in range(6)], 4, 2,
            block_size=1 << 16, device="cpu")
        eng.make_bucket("b")
        info = eng.put_object("b", "o", reader, size,
                              port_engine.PutOptions(metadata=md,
                                                     sse_spec=spec))
        assert b"".join(eng.get_object("b", "o")[1]) == want
        assert info.etag == hashlib.md5(pt).hexdigest()
    if mode == "none":
        assert b"".join(port_crypto.decompress_stream(
            iter([want]), PORT_ALGOS[algo])) == pt


def test_is_compressible_as_reference():
    for key, ctype in (("a.csv", ""), ("a.JSON", ""), ("x.tar", ""),
                       ("x.jpg", "image/jpeg"), ("x", "text/plain"),
                       ("x", "application/json; charset=utf-8"),
                       ("x", "binary/octet-stream"), ("x.gz", ""),
                       ("x", "application/octet-stream"), ("x.bin", "")):
        assert port_crypto.is_compressible(key, ctype) == \
            ref_crypto.is_compressible(key, ctype), (key, ctype)


def test_stored_compression_reads_both_key_spellings():
    for md in ({}, {port_crypto.MK_COMPRESS: "zstd"},
               {port_crypto.MK_COMPRESS_LEGACY: "zstd"},
               {port_crypto.MK_COMPRESS: port_crypto.COMPRESS_S2,
                port_crypto.MK_COMPRESS_LEGACY: "zstd"}):
        assert port_crypto.stored_compression(md) == \
            ref_crypto.stored_compression(md)


# -- twin servers ---------------------------------------------------------

def compress_sequence(data: dict[str, bytes]):
    """One signed request sequence: (callable c(client) -> response, the
    status the port must answer or None, the body it must answer or
    None)."""
    b = "/czip"
    steps = []

    def req(method, path, query=None, body=b"", headers=None, status=None,
            want=None):
        steps.append((lambda c: c.request(method, path, query=query,
                                          body=body, headers=headers),
                      status, want))

    plain = dict(data, **{"s.csv": data["t.csv"]})
    req("PUT", b, status=200)
    for key, body in data.items():
        ctype = {"p.jpg": "image/jpeg", "t.csv": "text/csv"}.get(key)
        req("PUT", f"{b}/{key}", body=body,
            headers={"content-type": ctype} if ctype else None, status=200)
    req("PUT", f"{b}/s.csv", body=data["t.csv"], headers=SSE_S3, status=200)
    req("PUT", f"{b}/c.json", body=data["d.json"], headers=SSEC, status=200)
    for key, body in plain.items():
        req("HEAD", f"{b}/{key}", status=200)
        req("GET", f"{b}/{key}", status=200, want=body)
        for lo, hi in ((0, 0), (100000, 300000), (70000, None)):
            rng = f"bytes={lo}-{'' if hi is None else hi}"
            hi = len(body) - 1 if hi is None else min(hi, len(body) - 1)
            req("GET", f"{b}/{key}", headers={"range": rng},
                want=body[lo:hi + 1] if lo < len(body) else None)
        for rng in ("bytes=-77", "bytes=9999999-"):
            req("GET", f"{b}/{key}", headers={"range": rng})
    req("HEAD", f"{b}/c.json", headers=SSEC, status=200)
    req("HEAD", f"{b}/c.json")
    req("GET", f"{b}/c.json", headers=SSEC, want=data["d.json"])
    req("GET", f"{b}/c.json", headers={**SSEC, "range": "bytes=1000-2000"},
        status=206, want=data["d.json"][1000:2001])
    # listings carry the stored sizes
    req("GET", b)
    req("GET", b, {"list-type": "2"})
    req("GET", b, {"versions": ""})
    # copies: verbatim, REPLACE, re-encrypted, decrypted
    req("PUT", f"{b}/cp1.csv", headers={"x-amz-copy-source": f"{b}/t.csv"},
        status=200)
    req("PUT", f"{b}/cp2.csv", headers={
        "x-amz-copy-source": f"{b}/t.csv",
        "x-amz-metadata-directive": "REPLACE", "x-amz-meta-k": "v"},
        status=200)
    req("PUT", f"{b}/cp3.csv", headers={
        "x-amz-copy-source": f"{b}/t.csv", **SSE_S3}, status=200)
    req("PUT", f"{b}/cp4.csv", headers={"x-amz-copy-source": f"{b}/s.csv"},
        status=200)
    req("PUT", f"{b}/cp5.json", status=200, headers={
        "x-amz-copy-source": f"{b}/c.json",
        "x-amz-copy-source-server-side-encryption-customer-algorithm":
            "AES256",
        "x-amz-copy-source-server-side-encryption-customer-key":
            SSEC["x-amz-server-side-encryption-customer-key"],
        "x-amz-copy-source-server-side-encryption-customer-key-md5":
            SSEC["x-amz-server-side-encryption-customer-key-md5"]})
    for key in ("cp1.csv", "cp2.csv", "cp3.csv", "cp4.csv", "cp5.json"):
        body = data["d.json"] if key == "cp5.json" else data["t.csv"]
        req("HEAD", f"{b}/{key}", status=200)
        req("GET", f"{b}/{key}", want=body)
        req("GET", f"{b}/{key}", headers={"range": "bytes=65530-131080"},
            status=206, want=body[65530:131081])
    # Selects over compressed objects: the port's scan plane
    for key, expr in (
            ("t.csv", "SELECT COUNT(*) FROM S3Object WHERE "
             "l_quantity < 24 AND l_discount >= 0.05"),
            ("t.csv", "SELECT l_orderkey, l_shipmode FROM S3Object WHERE "
             "l_quantity > 49"),
            ("s.csv", "SELECT COUNT(*) FROM S3Object WHERE "
             "l_shipmode = 'MAIL'")):
        req("POST", f"{b}/{key}", {"select": "", "select-type": "2"},
            scan_cases.select_xml(expr), status=200)
    req("DELETE", f"{b}/t.csv", status=204)
    req("POST", b, {"delete": ""}, b"<Delete><Object><Key>b.bin</Key>"
        b"</Object><Object><Key>cp1.csv</Key></Object></Delete>")
    req("GET", b, {"list-type": "2"})
    return steps


@pytest.mark.parametrize("algo", ["s2", "zstd"])
@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_servers_compress_as_reference(tmp_path, monkeypatch, sse_env,
                                            gate, edge, algo):
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    monkeypatch.setenv("MINIO_COMPRESS", "on")
    monkeypatch.setenv("MINIO_COMPRESS_ALGORITHM", algo)
    pin(monkeypatch, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(monkeypatch, port_engine, port_multipart, port_bmeta,
        port_handlers, port_crypto)
    fused = []
    real_absorb = port_crypto.DeviceSSE.absorb

    def absorb(self, ct):
        fused.append(len(ct))
        return real_absorb(self, ct)
    monkeypatch.setattr(port_crypto.DeviceSSE, "absorb", absorb)
    data = _corpus(11)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref, ref_sets = _ref_server(tmp_path / "ref")
    port, port_sets = _port_server(tmp_path / "port")
    try:
        assert port.api.compression_enabled and \
            port.api.compression_algorithm == algo
        clients = [S3TestClient("127.0.0.1", s.port) for s in (ref, port)]
        for i, (step, status, want) in enumerate(compress_sequence(data)):
            a, b = step(clients[0]), step(clients[1])
            assert status is None or b[0] == status, \
                f"step {i}: status {b[0]} {b[2][:200]!r}"
            assert want is None or b[2] == want, f"step {i}: wrong bytes"
            ca, cb = _creation_dates(a[2]), _creation_dates(b[2])
            assert len(ca) == len(cb) and \
                all(abs(x - y) < 30 for x, y in zip(ca, cb)), i
            a, b = _norm(a), _norm(b)
            assert a[0] == b[0], f"step {i}: status {a[0]} != {b[0]}"
            assert a[1] == b[1], f"step {i}: headers differ"
            assert a[2] == b[2], f"step {i}: bodies differ"
        stats = port.api.scan.stats()
        assert stats["device_serves"] == 3 and stats["fallbacks"] == 0
        # the SSE-S3 PUT ciphered its compressed stream in the fused step
        assert fused
        info = port_sets.get_object_info("czip", "s.csv")
        assert info.user_defined[port_crypto.MK_COMPRESS] == \
            PORT_ALGOS[algo]
        assert info.size < len(data["t.csv"])
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()
    want, got = drive_files(tmp_path / "ref"), drive_files(tmp_path / "port")
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k] != got[k]] == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_compressed_objects_cross_between_servers(tmp_path, monkeypatch,
                                                  sse_env, gate, writer):
    """Compressed objects, S2 and zstd, plain, SSE-S3 and SSE-C, PUT
    through one package's server read back whole, ranged and Selected
    through the other's over the same drives (the reader's own
    compression setting plays no part in reading)."""
    monkeypatch.setenv("MINIO_COMPRESS", "on")
    data = _corpus(5)
    ref, ref_sets = _ref_server(tmp_path)
    port, port_sets = _port_server(tmp_path)
    w, r = (port, ref) if writer == "port" else (ref, port)
    r.api.compression_enabled = False
    try:
        cw = S3TestClient("127.0.0.1", w.port)
        cr = S3TestClient("127.0.0.1", r.port)
        assert cw.request("PUT", "/cross")[0] == 200
        objects = {}
        for algo in ("s2", "zstd"):
            w.api.compression_algorithm = algo
            for key, hdrs in (("t.csv", {}), ("s.csv", SSE_S3),
                              ("c.csv", SSEC)):
                name = f"{algo}-{key}"
                body = data["t.csv"] if key != "c.csv" else \
                    data["t.csv"][:400_000]
                assert cw.request("PUT", f"/cross/{name}", body=body,
                                  headers=hdrs)[0] == 200
                objects[name] = (body, hdrs)
        for name, (body, hdrs) in objects.items():
            info = r.api.obj.get_object_info("cross", name)
            assert port_crypto.stored_compression(info.user_defined), name
            st, h, got = cr.request("GET", f"/cross/{name}", headers=hdrs)
            assert st == 200 and got == body, name
            assert h["etag"] == f'"{hashlib.md5(body).hexdigest()}"'
            st, h, got = cr.request("GET", f"/cross/{name}", headers={
                **hdrs, "range": "bytes=65530-131080"})
            assert st == 206 and got == body[65530:131081], name
            st, h, _ = cr.request("HEAD", f"/cross/{name}", headers=hdrs)
            assert st == 200 and h["content-length"] == str(len(body))
        expr = "SELECT COUNT(*) FROM S3Object WHERE l_quantity < 24"
        want = scan_cases.request(expr)
        from minio_tpu_torch.s3select.select import event_stream
        oracle = b"".join(event_stream(want, data["t.csv"]))
        for name in ("s2-t.csv", "zstd-s.csv"):
            st, _, got = cr.request(
                "POST", f"/cross/{name}",
                query={"select": "", "select-type": "2"},
                body=scan_cases.select_xml(expr))
            assert st == 200 and got == oracle, name
        if r is port:
            assert port.api.scan.stats()["device_serves"] == 2
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()


def test_zstd_put_without_zstandard_fails_as_reference(tmp_path,
                                                       monkeypatch):
    """MINIO_COMPRESS_ALGORITHM=zstd where the package does not import:
    both servers answer the PUT with the same error, and neither stores
    the object, compressed or not."""
    monkeypatch.setenv("MINIO_COMPRESS", "on")
    monkeypatch.setenv("MINIO_COMPRESS_ALGORITHM", "zstd")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref, ref_sets = _ref_server(tmp_path / "ref")
    port, port_sets = _port_server(tmp_path / "port")
    try:
        outs = []
        for srv in (ref, port):
            c = S3TestClient("127.0.0.1", srv.port)
            assert c.request("PUT", "/nozstd")[0] == 200
            put = _norm(c.request("PUT", "/nozstd/t.csv",
                                  body=b"a,b\n" * 999))
            # an incompressible type is stored as it is
            jpg = c.request("PUT", "/nozstd/p.jpg", body=b"\xff" * 99,
                            headers={"content-type": "image/jpeg"})
            outs.append((put[0], put[2], jpg[0],
                         c.request("GET", "/nozstd/t.csv")[0]))
        assert outs[0] == outs[1]
        assert outs[1][0] == 500 and outs[1][2] == 200 and \
            outs[1][3] == 404
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()
