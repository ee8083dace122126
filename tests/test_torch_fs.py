"""The port's single-path FS backend (minio_tpu_torch/object/fs.py,
cluster.start_fs) held against minio_tpu's.

  * tests/test_fs.py's cases rebound to the port's FSObjects and its S3
    server: the object lifecycle as plain files, metadata updates,
    multipart, HTTP, the FS node's boot (the root credential only: IAM is
    not ported, so the reference case's user and policy steps are left
    out), TLS, CORS, and versions paging over prefix-only pages;
  * twin FS servers, reference and port, fed one signed request sequence
    under both transports (identities pinned): statuses, bodies, headers
    and the trees' files are equal;
  * a tree written by either package's FSObjects is read by the other's.
Every comparison is byte for byte (tolerance 0).
"""

from __future__ import annotations

import hashlib
import http.client
import os
import urllib.parse

import numpy as np
import pytest

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.fs as ref_fs
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.fs as port_fs
import minio_tpu_torch.s3.handlers as port_handlers
from minio_tpu.object.multipart import CompletePart as RefPart
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu_torch.object import api_errors
from minio_tpu_torch.object.engine import PutOptions
from minio_tpu_torch.object.fs import FSObjects
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.s3 import signature as sig
from minio_tpu_torch.s3.credentials import Credentials
from minio_tpu_torch.s3.server import S3Server
from tests.test_s3 import S3TestClient
from tests.test_s3 import CREDS as TWIN_CREDS
from tests.test_torch_s3 import (MASTER, SSE_S3, SSEC, _Pinned,
                                 _creation_dates, _mp_complete_xml, _norm,
                                 _upload_id)

CREDS = Credentials("fstestkey123", "fstestsecret123")
REGION = "us-east-1"


@pytest.fixture()
def fs(tmp_path):
    return FSObjects(str(tmp_path / "fsroot"))


# ---------------------------------------------------------------------------
# tests/test_fs.py, rebound
# ---------------------------------------------------------------------------

def test_fs_object_lifecycle(fs):
    fs.make_bucket("b")
    assert fs.bucket_exists("b")
    payload = np.random.default_rng(1).bytes(3 << 20)
    info = fs.put_object("b", "dir/obj.bin", payload)
    assert info.etag == hashlib.md5(payload).hexdigest()
    assert info.size == len(payload)
    assert open(os.path.join(fs.root, "b", "dir", "obj.bin"),
                "rb").read() == payload
    _, stream = fs.get_object("b", "dir/obj.bin")
    assert b"".join(stream) == payload
    _, stream = fs.get_object("b", "dir/obj.bin", offset=100, length=50)
    assert b"".join(stream) == payload[100:150]
    objs, prefixes, _ = fs.list_objects("b", delimiter="/")
    assert prefixes == ["dir/"] and not objs
    objs, _, _ = fs.list_objects("b", prefix="dir/")
    assert [o.name for o in objs] == ["dir/obj.bin"]
    fs.delete_object("b", "dir/obj.bin")
    with pytest.raises(api_errors.ObjectNotFound):
        fs.get_object_info("b", "dir/obj.bin")
    assert not os.path.exists(os.path.join(fs.root, "b", "dir"))
    fs.delete_bucket("b")
    assert not fs.bucket_exists("b")


def test_fs_metadata_and_update(fs):
    fs.make_bucket("m")
    fs.put_object("m", "o", b"x", opts=PutOptions(
        metadata={"content-type": "text/css",
                  "X-Amz-Meta-Color": "blue"}))
    info = fs.get_object_info("m", "o")
    assert info.content_type == "text/css"
    assert info.user_defined["X-Amz-Meta-Color"] == "blue"
    fs.update_object_metadata("m", "o", {"content-type": "text/css",
                                         "X-Amz-Meta-Color": "red"})
    assert fs.get_object_info("m", "o").user_defined[
        "X-Amz-Meta-Color"] == "red"


def test_fs_multipart(fs):
    fs.make_bucket("mp")
    uid = fs.new_multipart_upload("mp", "big")
    rng = np.random.default_rng(2)
    p1 = rng.bytes(5 << 20)
    p2 = rng.bytes(1 << 20)
    i1 = fs.put_object_part("mp", "big", uid, 1, p1)
    i2 = fs.put_object_part("mp", "big", uid, 2, p2)
    parts = fs.list_object_parts("mp", "big", uid)
    assert [p.number for p in parts] == [1, 2]
    ups = fs.list_multipart_uploads("mp")
    assert ups and ups[0]["upload_id"] == uid
    info = fs.complete_multipart_upload(
        "mp", "big", uid,
        [CompletePart(1, i1.etag), CompletePart(2, i2.etag)])
    assert info.etag.endswith("-2")
    _, stream = fs.get_object("mp", "big")
    assert b"".join(stream) == p1 + p2
    assert fs.list_multipart_uploads("mp") == []


def _req(port, method, path, body=b"", query=None, headers=None):
    query = {k: [v] for k, v in (query or {}).items()}
    qs = urllib.parse.urlencode({k: v[0] for k, v in query.items()})
    hdrs = {k.lower(): v for k, v in (headers or {}).items()}
    hdrs["host"] = f"127.0.0.1:{port}"
    hdrs = sig.sign_v4(method, urllib.parse.quote(path), query, hdrs,
                       hashlib.sha256(body).hexdigest(), CREDS, REGION)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, urllib.parse.quote(path) +
                 (f"?{qs}" if qs else ""), body=body, headers=hdrs)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_fs_over_http(tmp_path):
    fs = FSObjects(str(tmp_path / "httproot"))
    srv = S3Server(fs, creds=CREDS, region=REGION).start()
    try:
        assert _req(srv.port, "PUT", "/web")[0] == 200
        payload = b"fs over http" * 1000
        assert _req(srv.port, "PUT", "/web/a/b.txt", body=payload)[0] == 200
        st, got = _req(srv.port, "GET", "/web/a/b.txt")
        assert st == 200 and got == payload
        st, body = _req(srv.port, "GET", "/web", query={"list-type": "2"})
        assert st == 200 and b"a/b.txt" in body
        assert _req(srv.port, "DELETE", "/web/a/b.txt")[0] == 204
        assert _req(srv.port, "GET", "/web/a/b.txt")[0] == 404
    finally:
        srv.stop()


def test_fs_node_boot(tmp_path):
    from minio_tpu_torch.cluster import start_fs
    node = start_fs(str(tmp_path / "fsnode"), port=0, creds=CREDS,
                    device="cpu")
    try:
        node.object_layer.make_bucket("boot")
        node.object_layer.put_object("boot", "k", b"v")
        st, got = _req(node.s3.port, "GET", "/boot/k")
        assert st == 200 and got == b"v"
        assert node.url.startswith("http://")
    finally:
        node.shutdown()
    node.shutdown()                         # idempotent
    assert os.path.isfile(str(tmp_path / "fsnode" / "boot" / "k"))


def test_fs_node_without_a_device_needs_a_card(tmp_path, monkeypatch):
    import torch
    from minio_tpu_torch.cluster import start_fs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        start_fs(str(tmp_path / "fsnode"), creds=CREDS)


def test_tls_server(tmp_path):
    import datetime
    import ipaddress
    import ssl
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "127.0.0.1")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName(
                [x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
            .sign(key, hashes.SHA256()))
    certfile = tmp_path / "tls.crt"
    keyfile = tmp_path / "tls.key"
    certfile.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    keyfile.write_bytes(key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))

    fs = FSObjects(str(tmp_path / "tlsroot"))
    srv = S3Server(fs, creds=CREDS, certfile=str(certfile),
                   keyfile=str(keyfile)).start()
    try:
        assert srv.url.startswith("https://")
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        conn = http.client.HTTPSConnection("127.0.0.1", srv.port,
                                           context=ctx, timeout=10)
        hdrs = sig.sign_v4("PUT", "/tlsb", {},
                           {"host": f"127.0.0.1:{srv.port}"},
                           hashlib.sha256(b"").hexdigest(), CREDS, REGION)
        conn.request("PUT", "/tlsb", body=b"", headers=hdrs)
        r = conn.getresponse()
        r.read()
        assert r.status == 200
        conn.close()
        assert fs.bucket_exists("tlsb")
    finally:
        srv.stop()


def test_cors_preflight_and_headers(tmp_path):
    fs = FSObjects(str(tmp_path / "cors"))
    srv = S3Server(fs, creds=CREDS).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=10)
        conn.request("OPTIONS", "/anyb/anyk", headers={
            "Origin": "https://app.example.com",
            "Access-Control-Request-Method": "PUT"})
        r = conn.getresponse()
        r.read()
        h = {k.lower(): v for k, v in r.getheaders()}
        assert r.status == 200
        assert h["access-control-allow-origin"] == \
            "https://app.example.com"
        assert "PUT" in h["access-control-allow-methods"]
        hdrs = sig.sign_v4("PUT", "/corsb", {},
                           {"host": f"127.0.0.1:{srv.port}",
                            "origin": "https://app.example.com"},
                           hashlib.sha256(b"").hexdigest(), CREDS, REGION)
        conn.request("PUT", "/corsb", body=b"", headers=hdrs)
        r = conn.getresponse()
        r.read()
        h = {k.lower(): v for k, v in r.getheaders()}
        assert r.status == 200
        assert h.get("access-control-allow-origin") == \
            "https://app.example.com"
        conn.close()
    finally:
        srv.stop()


def test_fs_versions_prefix_only_pages_resume(fs):
    fs.make_bucket("b")
    for i in range(5):
        fs.put_object("b", f"dir{i}/x", b"v")
    fs.put_object("b", "zzz", b"v")
    seen_prefixes, seen_objs = [], []
    marker, vmarker = "", ""
    for _ in range(10):
        vers, pfx, nkm, nvm, trunc = fs.list_object_versions(
            "b", marker=marker, version_marker=vmarker,
            max_keys=2, delimiter="/")
        seen_prefixes += pfx
        seen_objs += [v.name for v in vers]
        if not trunc:
            break
        assert nkm, "truncated page must carry a resume marker"
        marker, vmarker = nkm, nvm
    else:
        pytest.fail("versions paging did not terminate")
    assert seen_prefixes == [f"dir{i}/" for i in range(5)]
    assert seen_objs == ["zzz"]


# ---------------------------------------------------------------------------
# twin FS servers and trees crossing between the packages
# ---------------------------------------------------------------------------

def tree_files(root) -> dict:
    """relative path -> bytes of every file under an FS root."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def pin_fs(monkeypatch):
    """One uuid/clock counter per package for the FS backend (upload
    ids, staging names, mod times), the handlers' request ids, the
    bucket metadata's `created` and the SSE key material."""
    for fs_mod, handlers, bmeta, crypto in (
            (ref_fs, ref_handlers, ref_bmeta, ref_crypto),
            (port_fs, port_handlers, port_bmeta, port_crypto)):
        p = _Pinned()
        monkeypatch.setattr(fs_mod, "_uuid", p)
        monkeypatch.setattr(fs_mod, "time", p)
        monkeypatch.setattr(handlers, "uuid", p)
        monkeypatch.setattr(bmeta, "time", p)
        monkeypatch.setattr(crypto, "secrets", p)


def fs_sequence(data: dict):
    steps = []

    def req(method, path, query=None, body=b"", headers=None):
        steps.append(lambda port, c, st: c.request(
            method, path, query=query, body=body, headers=headers))

    def mp_start(key):
        def step(port, c, st):
            out = c.request("POST", key, query={"uploads": ""})
            st["up"] = _upload_id(out[2])
            return out
        steps.append(step)

    def mp_part(key, n, body):
        def step(port, c, st):
            out = c.request("PUT", key, body=body, query={
                "uploadId": st["up"], "partNumber": str(n)})
            st.setdefault("etags", []).append(out[1]["etag"])
            return out
        steps.append(step)

    def mp_complete(key):
        steps.append(lambda port, c, st: c.request(
            "POST", key, query={"uploadId": st["up"]},
            body=_mp_complete_xml(st["etags"])))

    b = "/fsb"
    req("PUT", b)
    req("GET", "/")
    req("HEAD", b)
    for key, body in data.items():
        if key != "part":
            req("PUT", f"{b}/{key}", body=body,
                headers={"content-type": "application/x-test",
                         "x-amz-meta-k": key})
    req("PUT", f"{b}/dir/nested", body=data["small"])
    # SSE on the FS backend: the default AES-GCM packages, on the host
    req("PUT", f"{b}/sse-s3", body=data["big"], headers=SSE_S3)
    req("PUT", f"{b}/sse-c", body=data["small"], headers=SSEC)
    req("GET", f"{b}/sse-s3")
    req("GET", f"{b}/sse-s3", headers={"range": "bytes=70000-140000"})
    req("GET", f"{b}/sse-c", headers=SSEC)
    req("HEAD", f"{b}/sse-c", headers=SSEC)
    req("GET", f"{b}/big")
    req("GET", f"{b}/big", headers={"range": "bytes=1000-70000"})
    req("HEAD", f"{b}/small")
    req("GET", f"{b}/absent")
    req("GET", b, {"list-type": "2"})
    req("GET", b, {"list-type": "2", "delimiter": "/"})
    req("GET", b, {"list-type": "2", "max-keys": "1"})
    req("GET", b, {"versions": ""})
    req("PUT", f"{b}/copy", headers={"x-amz-copy-source": f"{b}/small"})
    req("GET", f"{b}/copy")
    mp_start(f"{b}/mp")
    req("GET", b, {"uploads": ""})
    mp_part(f"{b}/mp", 1, data["part"])
    mp_part(f"{b}/mp", 2, data["small"])
    # ListParts: the reference's FS parts carry `number` where its
    # handler reads `part_number`, so it answers 500; the port matches
    steps.append(lambda port, c, st: c.request(
        "GET", f"{b}/mp", query={"uploadId": st["up"]}))
    mp_complete(f"{b}/mp")
    req("GET", f"{b}/mp")
    req("HEAD", f"{b}/mp")
    req("DELETE", f"{b}/small")
    req("POST", b, {"delete": ""}, b"<Delete><Object><Key>copy</Key>"
        b"</Object><Object><Key>absent</Key></Object></Delete>")
    req("DELETE", b)
    req("GET", b, {"list-type": "2"})
    return steps


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_fs_servers_answer_as_reference(tmp_path, monkeypatch, edge):
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    monkeypatch.setenv("MINIO_SSE_MASTER_KEY", MASTER)
    pin_fs(monkeypatch)
    rng = np.random.default_rng(17)
    data = {"big": rng.bytes(300_001), "small": rng.bytes(1234),
            "part": rng.bytes(5 << 20)}
    ref = RefServer(ref_fs.FSObjects(str(tmp_path / "ref")),
                    creds=TWIN_CREDS, region=REGION).start()
    port = S3Server(FSObjects(str(tmp_path / "port")), creds=TWIN_CREDS,
                    region=REGION).start()
    assert port.edge_enabled == (edge == "on")
    try:
        clients = [S3TestClient("127.0.0.1", s.port) for s in (ref, port)]
        states = [{}, {}]
        statuses = []
        for i, step in enumerate(fs_sequence(data)):
            a = step(ref.port, clients[0], states[0])
            b = step(port.port, clients[1], states[1])
            ca, cb = _creation_dates(a[2]), _creation_dates(b[2])
            assert len(ca) == len(cb) and \
                all(abs(x - y) < 30 for x, y in zip(ca, cb)), \
                f"step {i}: creation dates {ca} != {cb}"
            a, b = _norm(a), _norm(b)
            assert a[0] == b[0], f"step {i}: status {a[0]} != {b[0]}"
            assert a[1] == b[1], f"step {i}: headers differ"
            assert a[2] == b[2], f"step {i}: bodies differ"
            statuses.append(b[0])
        # every step but ListParts answered without a server error
        errors = [i for i, st in enumerate(statuses) if st >= 500]
        assert errors == [26] and statuses.count(200) >= 25
        assert states[1]["etags"][0] == \
            '"' + hashlib.md5(data["part"]).hexdigest() + '"'
    finally:
        ref.stop()
        port.stop()
    assert tree_files(tmp_path / "port") == tree_files(tmp_path / "ref")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_fs_trees_cross_between_packages(tmp_path, writer):
    rng = np.random.default_rng(23)
    objs = {"a": rng.bytes(100_000), "d/e/f": rng.bytes(7),
            "empty": b""}
    part1, part2 = rng.bytes(5 << 20), rng.bytes(4321)
    root = str(tmp_path / "tree")
    w = FSObjects(root) if writer == "port" else ref_fs.FSObjects(root)
    Part = CompletePart if writer == "port" else RefPart
    w.make_bucket("x")
    for k, v in objs.items():
        w.put_object("x", k, v)
    up = w.new_multipart_upload("x", "mp")
    e1 = w.put_object_part("x", "mp", up, 1, part1).etag
    e2 = w.put_object_part("x", "mp", up, 2, part2).etag
    w.complete_multipart_upload("x", "mp", up, [Part(1, e1), Part(2, e2)])
    pending = w.new_multipart_upload("x", "open")
    w.put_object_part("x", "open", pending, 1, b"half")
    objs["mp"] = part1 + part2

    r = ref_fs.FSObjects(root) if writer == "port" else FSObjects(root)
    for k, v in objs.items():
        info, stream = r.get_object("x", k)
        assert b"".join(stream) == v
        assert info.etag == w.get_object_info("x", k).etag
    assert r.get_object_info("x", "mp").etag.endswith("-2")
    assert [o.name for o in r.list_objects("x")[0]] == sorted(objs)
    assert [u["upload_id"] for u in r.list_multipart_uploads("x")] == \
        [pending]
    assert [p.etag for p in r.list_object_parts("x", "open", pending)] == \
        [hashlib.md5(b"half").hexdigest()]
