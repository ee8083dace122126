"""The port's S3 front (minio_tpu_torch/s3/) held against minio_tpu's.

Three parts, all on the host (device="cpu") over 8 drives at 6+2 with
256 KiB blocks:

  * twin servers: the reference's S3Server over minio_tpu sets and the
    port's over minio_tpu_torch sets, uuids, clocks and key material
    pinned in both packages, fed one signed request sequence (bucket verbs
    and sub-resources, signed, unsigned and aws-chunked PUTs, GET, HEAD,
    ranged and conditional GETs, copy, delete, bulk delete, listings,
    multipart with abort, tagging, SSE-S3 and SSE-C single and multipart
    objects, ranged SSE GETs, and SelectObjectContent over CSV, JSON
    Lines, GZIP input and an SSE-S3 object, with COUNTs, a LIMIT and a
    query the scan plan declines): equal statuses, bodies (request IDs, ports
    and bucket creation dates masked; the dates are the bucket
    directories' inode change times, which no test can set, and are held
    within seconds of each other instead) and headers (Date and Server
    aside), then equal files on the twin drives; under both transports;
  * objects written through one package's server read back byte for byte
    through the other's over the same drives, SSE objects included;
  * the reference's own HTTP cases (tests/test_s3.py) against the port's
    server, the notification plane's PUT ?notification validation among
    them;
  * twin servers with the notification wiring of a boot: PUT and GET
    ?notification (malformed XML, an unknown ARN and an unknown event
    refused alike) and a ListenBucketNotification stream each, equal
    records (eventTime aside) under both transports;
  * twin servers with IAM: ?replication configs and the owner-gated
    replication-apply and replica-prune branches (a bad spec header, a
    short body, a data version, a marker, a user that is not the owner)
    answer alike under both transports, to equal drive files;
  * the port's own: the admission gate's scheduler-occupancy and
    client-budget sheds (503 SlowDown before any body byte), a bucket
    quota written by the reference honoured by the port, encrypted GETs
    deciphered by the batch former's threads, never a handler's, and an
    object the reference stored compressed read and Selected as the
    reference reads it (tests/test_torch_compress.py holds compression
    itself).

Every test here is bounded by an alarm (``_deadline``), so a hung socket
fails one test instead of the run.
"""

from __future__ import annotations

import base64
import gzip
import hashlib
import http.client
import importlib
import json
import os
import random
import re
import signal
import threading
import time
import uuid

import numpy as np
import pytest
import torch

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
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3 import signature as sig
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu_torch import cluster
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.scripts import scan_cases
# the reference's HTTP cases, collected here against the port's `server`
from tests.test_s3 import (CREDS, REGION, S3TestClient,  # noqa: F401
                           bucket, client,
                           test_bad_signature_rejected,
                           test_bucket_lifecycle_of_missing,
                           test_bucket_policy_cycle,
                           test_bucket_tagging_cycle,
                           test_conditional_get,
                           test_content_md5_verified,
                           test_copy_object,
                           test_delete_bucket_not_empty_then_empty,
                           test_delete_multiple_objects,
                           test_delete_multiple_on_missing_bucket,
                           test_delete_object,
                           test_get_missing_object,
                           test_head_bucket, test_head_object,
                           test_invalid_bucket_name,
                           test_keepalive_after_unread_body,
                           test_list_multipart_uploads_reports_keys,
                           test_list_objects_v1_and_v2,
                           test_make_and_list_buckets,
                           test_max_keys_zero,
                           test_multipart_abort,
                           test_multipart_roundtrip,
                           test_object_tagging_cycle,
                           test_presigned_get,
                           test_put_bucket_notification_validated_by_plane,
                           test_put_get_object_roundtrip,
                           test_ranged_get,
                           test_signed_body_sha_mismatch_rejected,
                           test_streaming_signed_put,
                           test_unauthenticated_rejected,
                           test_unknown_access_key,
                           test_versioning_cycle)

N, M, BS = 8, 2, 1 << 18
MASTER = "4f" * 32
SSEC_KEY = bytes(range(32))
SSEC = {
    "x-amz-server-side-encryption-customer-algorithm": "AES256",
    "x-amz-server-side-encryption-customer-key":
        base64.b64encode(SSEC_KEY).decode(),
    "x-amz-server-side-encryption-customer-key-md5":
        base64.b64encode(hashlib.md5(SSEC_KEY).digest()).decode()}
SSE_S3 = {"x-amz-server-side-encryption": "AES256"}
TEST_SECONDS = 240
STALL_CEIL_S = 10.0     # both packages' MINIO_TPU_WRITE_STALL_CEIL_S
HEDGE_CEIL_S = 2.0      # both packages' MINIO_TPU_HEDGE_CEIL_S


@pytest.fixture(autouse=True)
def _deadline():
    """Fail a test that runs past TEST_SECONDS (SIGALRM in the test's
    own thread interrupts a blocked socket read)."""
    def expire(*_):
        raise TimeoutError(f"test ran past {TEST_SECONDS} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_SECONDS)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU steps are the kernels' plain versions, many small
    PyTorch ops each; in a parallel test run the intra-op threads of
    every worker process oversubscribe the cores and stall such ops for
    seconds. One thread per process keeps each request's time bounded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's S3Server over the port's sets, shaped as
    tests/test_s3.py's reference fixture."""
    root = tmp_path_factory.mktemp("s3drives")
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(N)],
                                   set_count=1, set_drive_count=N, parity=M,
                                   block_size=BS, device="cpu")
    srv = S3Server(sets, creds=CREDS, region=REGION).start()
    yield srv
    srv.stop()
    sets.close()


# -- pinned identity --------------------------------------------------------

class _Pinned:
    """uuid4 / now / token_bytes from counters: the same call sequence in
    both packages yields the same ids, times and key material."""
    UUID = uuid.UUID

    def __init__(self):
        self.n = 0
        self.t = 1.7e9
        self.rng = np.random.default_rng(7)

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n)

    def now(self):
        self.t += 1.0
        return self.t

    def time(self):
        return 1.7e9

    def token_bytes(self, n):
        return self.rng.bytes(n)


def pin(monkeypatch, engine, multipart, bmeta, handlers, crypto):
    """Pin one package's identity sources (see _Pinned), and its
    quorum-ack grace and read-hedge deadline at their cold-start
    ceilings: a shard write that lags under the suite's load is waited
    for, and a shard read that lags is not raced by a spare read,
    whatever latencies earlier tests in the worker fed that package's
    tracker, so that both packages leave the same files and the same span
    trees (a warm tracker's hedge deadline is 50 ms, which a loaded
    worker's tmpfs read can pass)."""
    p = _Pinned()
    for mod in (engine, multipart):
        monkeypatch.setattr(mod, "_uuid", p)
        monkeypatch.setattr(mod, "now", p.now)
    monkeypatch.setattr(bmeta, "time", p)
    monkeypatch.setattr(handlers, "uuid", p)
    monkeypatch.setattr(crypto, "secrets", p)
    pin_deadlines(monkeypatch, engine.__name__.split(".")[0])


def pin_deadlines(monkeypatch, *packages: str) -> None:
    """Pin the gray-failure deadlines of each named package (default:
    both) at their cold-start ceilings: the quorum-ack grace and the
    read-hedge deadline (see pin)."""
    for package in packages or ("minio_tpu", "minio_tpu_torch"):
        healthtrack = importlib.import_module(f"{package}.utils.healthtrack")
        monkeypatch.setattr(healthtrack, "write_stall_s",
                            lambda: STALL_CEIL_S)
        monkeypatch.setattr(healthtrack, "read_hedge_s",
                            lambda: HEDGE_CEIL_S)


@pytest.fixture
def sse_env(monkeypatch):
    monkeypatch.setenv("MINIO_SSE_MASTER_KEY", MASTER)
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "chacha20")


def _ref_server(root):
    sets = RefSets.from_drives([str(root / f"d{i}") for i in range(N)],
                               set_count=1, set_drive_count=N, parity=M,
                               block_size=BS)
    return RefServer(sets, creds=CREDS, region=REGION).start(), sets


def _port_server(root):
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(N)],
                                   set_count=1, set_drive_count=N, parity=M,
                                   block_size=BS, device="cpu")
    return S3Server(sets, creds=CREDS, region=REGION).start(), sets


# -- requests ---------------------------------------------------------------

def unsigned_put(port: int, path: str, data: bytes):
    """A SigV4 PUT whose payload hash is UNSIGNED-PAYLOAD."""
    hdrs = sig.sign_v4("PUT", path, {}, {"host": f"127.0.0.1:{port}"},
                       sig.UNSIGNED_PAYLOAD, CREDS, REGION)
    hdrs["x-amz-content-sha256"] = sig.UNSIGNED_PAYLOAD
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("PUT", path, body=data, headers=hdrs)
    resp = conn.getresponse()
    out = (resp.status, {k.lower(): v for k, v in resp.getheaders()},
           resp.read())
    conn.close()
    return out


def _mp_complete_xml(etags: list[str]) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags)) +
        "</CompleteMultipartUpload>").encode()


def _upload_id(body: bytes) -> str:
    return re.search(rb"<UploadId>([^<]+)</UploadId>", body)[1].decode()


def twin_sequence(data: dict[str, bytes]):
    """The request sequence: a list of callables c(port, client) ->
    (status, headers, body). Requests that read an earlier response (an
    upload id, part ETags) go through `state`, filled per server."""
    b = "/twin"
    big, small, sse1, ssec1, part = (data[k] for k in
                                     ("big", "small", "sse1", "ssec1",
                                      "part"))
    steps = []

    def req(method, path, query=None, body=b"", headers=None):
        steps.append(lambda port, c, st: c.request(
            method, path, query=query, body=body, headers=headers))

    def mp(key, n_parts, headers, tag):
        """A multipart upload: create, n parts, list parts, complete."""
        def create(port, c, st):
            out = c.request("POST", f"{b}/{key}", query={"uploads": ""},
                            headers=headers)
            st[tag] = _upload_id(out[2])
            st[tag + "etags"] = []
            return out
        steps.append(create)
        for i in range(n_parts):
            body = part[i::2] if i + 1 == n_parts else part

            def put_part(port, c, st, i=i, body=body):
                out = c.request("PUT", f"{b}/{key}",
                                query={"uploadId": st[tag],
                                       "partNumber": str(i + 1)},
                                body=body, headers=headers)
                st[tag + "etags"].append(out[1].get("etag", ""))
                return out
            steps.append(put_part)
        steps.append(lambda port, c, st: c.request(
            "GET", f"{b}/{key}", query={"uploadId": st[tag]}))
        steps.append(lambda port, c, st: c.request(
            "POST", f"{b}/{key}", query={"uploadId": st[tag]},
            body=_mp_complete_xml(st[tag + "etags"])))

    # bucket verbs and sub-resources
    req("PUT", b)
    req("PUT", b)
    req("HEAD", b)
    req("GET", "/")
    req("GET", b, {"location": ""})
    req("GET", b, {"versioning": ""})
    req("GET", b, {"policy": ""})
    req("PUT", b, {"policy": ""}, b'{"Version":"2012-10-17"}')
    req("GET", b, {"policy": ""})
    req("DELETE", b, {"policy": ""})
    req("PUT", b, {"tagging": ""}, b"<Tagging><TagSet><Tag><Key>k</Key>"
        b"<Value>v</Value></Tag></TagSet></Tagging>")
    req("GET", b, {"tagging": ""})
    req("DELETE", b, {"tagging": ""})
    req("GET", b, {"tagging": ""})
    req("PUT", b, {"lifecycle": ""}, b"<LifecycleConfiguration><Rule><ID>r"
        b"</ID><Status>Enabled</Status></Rule></LifecycleConfiguration>")
    req("GET", b, {"lifecycle": ""})
    req("DELETE", b, {"lifecycle": ""})
    req("PUT", b, {"encryption": ""}, b"<ServerSideEncryptionConfiguration>"
        b"</ServerSideEncryptionConfiguration>")
    req("GET", b, {"encryption": ""})
    req("DELETE", b, {"encryption": ""})
    req("GET", b, {"encryption": ""})
    req("GET", "/nosuchbucket", {"location": ""})
    # PUTs: signed, unsigned, aws-chunked
    req("PUT", f"{b}/big", body=big,
        headers={"x-amz-meta-color": "blue", "content-type": "text/plain"})
    req("PUT", f"{b}/dir/small", body=small, headers={
        "x-amz-tagging": "a=1&b=2"})
    steps.append(lambda port, c, st: unsigned_put(port, f"{b}/unsigned",
                                                  small[::-1]))
    steps.append(lambda port, c, st: S3Client(port, CREDS).streaming_put(
        f"{b}/chunked", big[:200001]))
    # GET, HEAD, ranged and conditional
    for key in ("big", "dir/small", "unsigned", "chunked"):
        req("GET", f"{b}/{key}")
        req("HEAD", f"{b}/{key}")
    for rng in ("bytes=0-0", "bytes=1000-299999", "bytes=-77",
                "bytes=500000-", "bytes=9999999-"):
        req("GET", f"{b}/big", headers={"range": rng})
    etag = hashlib.md5(big).hexdigest()
    req("GET", f"{b}/big", headers={"if-none-match": f'"{etag}"'})
    req("GET", f"{b}/big", headers={"if-match": '"0000"'})
    req("GET", f"{b}/big", headers={
        "if-modified-since": "Sat, 01 Jan 2000 00:00:00 GMT"})
    req("GET", f"{b}/big", headers={
        "if-unmodified-since": "Sat, 01 Jan 2000 00:00:00 GMT"})
    req("GET", f"{b}/absent")
    # copy, tagging
    req("PUT", f"{b}/copy", headers={"x-amz-copy-source": f"{b}/big"})
    req("PUT", f"{b}/copy2", headers={
        "x-amz-copy-source": f"{b}/dir/small",
        "x-amz-metadata-directive": "REPLACE",
        "x-amz-meta-new": "yes"})
    req("GET", f"{b}/copy2")
    req("GET", f"{b}/dir/small", {"tagging": ""})
    req("PUT", f"{b}/copy", {"tagging": ""}, b"<Tagging><TagSet><Tag>"
        b"<Key>x</Key><Value>y</Value></Tag></TagSet></Tagging>")
    req("GET", f"{b}/copy", {"tagging": ""})
    req("DELETE", f"{b}/copy", {"tagging": ""})
    # listings
    req("GET", b)
    req("GET", b, {"list-type": "2"})
    req("GET", b, {"list-type": "2", "delimiter": "/", "max-keys": "2"})
    req("GET", b, {"prefix": "d", "delimiter": "/"})
    req("GET", b, {"versions": ""})
    req("GET", b, {"max-keys": "0"})
    # multipart with abort, then one completed
    req("POST", f"{b}/mp-abort", {"uploads": ""})
    steps.append(lambda port, c, st: c.request(
        "GET", b, query={"uploads": ""}))

    def abort(port, c, st):
        listing = c.request("GET", b, query={"uploads": ""})[2]
        return c.request("DELETE", f"{b}/mp-abort",
                         query={"uploadId": _upload_id(listing)})
    steps.append(abort)
    mp("mp", 2, None, "mp")
    req("GET", f"{b}/mp")
    req("GET", f"{b}/mp", headers={"range": "bytes=5242000-5243000"})
    # SSE-S3 and SSE-C single and multipart, ranged SSE GETs
    req("PUT", f"{b}/sse-s3", body=sse1, headers=SSE_S3)
    req("PUT", f"{b}/sse-s3-small", body=small, headers=SSE_S3)
    req("PUT", f"{b}/sse-c", body=ssec1, headers=SSEC)
    req("HEAD", f"{b}/sse-s3")
    req("HEAD", f"{b}/sse-c", headers=SSEC)
    req("HEAD", f"{b}/sse-c")
    req("GET", f"{b}/sse-s3")
    req("GET", f"{b}/sse-s3-small")
    req("GET", f"{b}/sse-c", headers=SSEC)
    req("GET", f"{b}/sse-c")
    for rng in ("bytes=70000-200000", "bytes=-1", "bytes=65535-65536"):
        req("GET", f"{b}/sse-s3", headers={"range": rng})
        req("GET", f"{b}/sse-c", headers={**SSEC, "range": rng})
    mp("sse-mp", 2, SSE_S3, "ssemp")
    req("GET", f"{b}/sse-mp")
    req("GET", f"{b}/sse-mp", headers={"range": "bytes=5242000-5243000"})
    mp("ssec-mp", 2, SSEC, "ssecmp")
    req("GET", f"{b}/ssec-mp", headers={**SSEC, "range": "bytes=100-"})
    req("PUT", f"{b}/sse-copy", headers={
        "x-amz-copy-source": f"{b}/sse-c", **SSE_S3,
        "x-amz-copy-source-server-side-encryption-customer-algorithm":
            "AES256",
        "x-amz-copy-source-server-side-encryption-customer-key":
            SSEC["x-amz-server-side-encryption-customer-key"],
        "x-amz-copy-source-server-side-encryption-customer-key-md5":
            SSEC["x-amz-server-side-encryption-customer-key-md5"]})
    req("GET", f"{b}/sse-copy")
    # SelectObjectContent: the port's scan plane against the reference's
    # evaluator (its device path is inert on this host)
    csv, js = data["csv"], data["json"]
    req("PUT", f"{b}/t.csv", body=csv)
    req("PUT", f"{b}/t.json", body=js)
    req("PUT", f"{b}/t.csv.gz", body=gzip.compress(csv, mtime=0))
    req("PUT", f"{b}/t-sse.csv", body=csv, headers=SSE_S3)
    for key, expr, fmt, out, comp in (
            ("t.csv", "SELECT * FROM S3Object WHERE a > 1", "CSV", "CSV",
             "NONE"),
            ("t.csv", "SELECT COUNT(*), COUNT(b) FROM S3Object WHERE "
             "c = 'x' OR d IS NULL", "CSV", "JSON", "NONE"),
            ("t.csv", "SELECT a, b FROM S3Object WHERE b BETWEEN 0 AND 20 "
             "LIMIT 5", "CSV", "CSV", "NONE"),
            ("t.json", "SELECT * FROM S3Object WHERE a IN (1, 'x', 25)",
             "JSON", "JSON", "NONE"),
            ("t.json", "SELECT COUNT(a) FROM S3Object WHERE NOT (b < c)",
             "JSON", "CSV", "NONE"),
            ("t.csv.gz", "SELECT COUNT(*) FROM S3Object WHERE "
             "a >= 1 AND a < 30", "CSV", "CSV", "GZIP"),
            ("t.csv", "SELECT a, c FROM S3Object WHERE c LIKE 'x_y'",
             "CSV", "CSV", "NONE"),
            ("t-sse.csv", "SELECT a, d FROM S3Object WHERE a < b", "CSV",
             "CSV", "NONE")):
        req("POST", f"{b}/{key}", {"select": "", "select-type": "2"},
            scan_cases.select_xml(expr, fmt, out, comp))
    # versioning, deletes, bulk delete
    req("PUT", b, {"versioning": ""}, b"<VersioningConfiguration><Status>"
        b"Enabled</Status></VersioningConfiguration>")
    req("PUT", f"{b}/dir/small", body=small + b"v2")
    req("DELETE", f"{b}/dir/small")
    req("GET", b, {"versions": ""})
    req("GET", f"{b}/dir/small")
    req("DELETE", f"{b}/unsigned")
    req("POST", b, {"delete": ""}, b"<Delete><Object><Key>copy</Key>"
        b"</Object><Object><Key>absent</Key></Object><Object><Key>big</Key>"
        b"</Object></Delete>")
    req("GET", b, {"list-type": "2"})
    req("DELETE", b)
    return steps


_CREATED = re.compile(rb"<CreationDate>([^<]*)</CreationDate>")
_MASK = [(re.compile(rb"<RequestId>[^<]*</RequestId>"), b"<RequestId/>"),
         (re.compile(rb"127\.0\.0\.1:\d+"), b"127.0.0.1:PORT"),
         (_CREATED, b"<CreationDate/>")]


def _creation_dates(body: bytes) -> list[float]:
    import datetime
    return [datetime.datetime.strptime(
        d.decode(), "%Y-%m-%dT%H:%M:%S.%fZ").timestamp()
        for d in _CREATED.findall(body)]


def _norm(out):
    status, headers, body = out
    for rx, sub in _MASK:
        body = rx.sub(sub, body)
    return status, {k: v for k, v in headers.items()
                    if k not in ("date", "server")}, body


def drive_files(root) -> dict:
    """relative path -> bytes of every file under the twin drives, the
    per-drive format (a random deployment id) and tmp left out."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if rel.endswith("format.json") or "/tmp/" in rel:
                continue
            with open(p, "rb") as fh:
                out[rel] = fh.read()
    return out


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_servers_answer_as_reference(tmp_path, monkeypatch, sse_env,
                                          edge):
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    pin(monkeypatch, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(monkeypatch, port_engine, port_multipart, port_bmeta,
        port_handlers, port_crypto)
    rng = np.random.default_rng(11)
    data = {"big": rng.bytes(600_001), "small": rng.bytes(1234),
            "sse1": rng.bytes((1 << 20) + 4321), "ssec1": rng.bytes(300_000),
            "part": rng.bytes(5 << 20),
            "csv": scan_cases.csv_corpus(random.Random(3), 300),
            "json": scan_cases.json_corpus(random.Random(4), 300)}
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref, ref_sets = _ref_server(tmp_path / "ref")
    port, port_sets = _port_server(tmp_path / "port")
    assert port.edge_enabled == (edge == "on")
    try:
        clients = [S3TestClient("127.0.0.1", s.port) for s in (ref, port)]
        states = [{}, {}]
        for i, step in enumerate(twin_sequence(data)):
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
        # the port's rows came from its scan plane, but the declined one's
        assert port.api.scan.stats() == {
            "device_serves": 7, "fallbacks": 1,
            "fallback_reasons": {"like-pattern": 1}}
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()
    want, got = drive_files(tmp_path / "ref"), drive_files(tmp_path / "port")
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k] != got[k]] == []


def _both_ways_objects(rng):
    return {"plain": (rng.bytes(700_000), {}),
            "sse-s3": (rng.bytes((1 << 20) + 99), SSE_S3),
            "sse-s3-small": (rng.bytes(70_000), SSE_S3),
            "sse-c": (rng.bytes(200_000), SSEC)}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_objects_cross_between_servers(tmp_path, sse_env, writer):
    """Objects PUT (single and multipart, SSE included) through one
    package's server read back byte for byte through the other's over
    the same drives, ranged SSE reads included."""
    rng = np.random.default_rng(5)
    objects = _both_ways_objects(rng)
    part = rng.bytes(5 << 20)
    ref, ref_sets = _ref_server(tmp_path)
    port, port_sets = _port_server(tmp_path)
    w, r = (port, ref) if writer == "port" else (ref, port)
    try:
        cw = S3TestClient("127.0.0.1", w.port)
        cr = S3TestClient("127.0.0.1", r.port)
        assert cw.request("PUT", "/cross")[0] == 200
        for key, (body, hdrs) in objects.items():
            assert cw.request("PUT", f"/cross/{key}", body=body,
                              headers=hdrs)[0] == 200
        for key, hdrs in (("mp", {}), ("mp-sse", SSE_S3)):
            up = _upload_id(cw.request("POST", f"/cross/{key}",
                                       query={"uploads": ""},
                                       headers=hdrs)[2])
            etags = [cw.request("PUT", f"/cross/{key}", body=p,
                                query={"uploadId": up,
                                       "partNumber": str(i + 1)},
                                headers=hdrs)[1]["etag"]
                     for i, p in enumerate((part, part[:12345]))]
            assert cw.request("POST", f"/cross/{key}",
                              query={"uploadId": up},
                              body=_mp_complete_xml(etags))[0] == 200
            objects[key] = (part + part[:12345], {})
        for key, (body, hdrs) in objects.items():
            st, h, got = cr.request("GET", f"/cross/{key}", headers=hdrs)
            assert st == 200 and got == body, key
            st, h, got = cr.request("GET", f"/cross/{key}", headers={
                **hdrs, "range": "bytes=65530-131080"})
            assert st == 206 and got == body[65530:131081], key
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()


def _notify_wiring(srv, notify_pkg, events_pkg):
    """One package's server wired as the boot wires it: the legacy event
    notifier (ListenBucketNotification's hub) and a notification plane
    whose registry holds one queue target (the PUT ?notification
    validation)."""
    srv.api.events = events_pkg.EventNotifier(srv.api.bucket_meta)
    reg = notify_pkg.NotifyTargetRegistry()
    reg.add(notify_pkg.NotifyTarget(arn=NOTIFY_ARN, type="queue"))
    plane = notify_pkg.NotificationPlane(
        srv.api.obj, reg, bucket_meta=srv.api.bucket_meta, node="n1",
        site_id="twin", busy_fn=lambda: False)
    srv.api.notify = plane
    return plane


NOTIFY_ARN = "arn:minio:sqs::twin:queue"


def _notify_doc(arn=NOTIFY_ARN, event="s3:ObjectCreated:*") -> bytes:
    return ("<NotificationConfiguration><QueueConfiguration>"
            f"<Queue>{arn}</Queue><Event>{event}</Event>"
            "<Event>s3:ObjectRemoved:*</Event>"
            "</QueueConfiguration></NotificationConfiguration>").encode()


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_bucket_notification(tmp_path, monkeypatch, edge):
    """PUT and GET ?notification (the three refusals included) answer
    alike on twin servers, and a ListenBucketNotification subscriber of
    each (prefix and event filters, an idle window) streams the same
    ND-JSON records, eventTime aside, under both transports."""
    import minio_tpu.features.events as ref_events
    import minio_tpu.notify as ref_notify
    import minio_tpu_torch.features.events as port_events
    import minio_tpu_torch.notify as port_notify
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    pin(monkeypatch, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(monkeypatch, port_engine, port_multipart, port_bmeta,
        port_handlers, port_crypto)
    out = {}
    for tag, mk, npkg, epkg in (("ref", _ref_server, ref_notify, ref_events),
                                ("port", _port_server, port_notify,
                                 port_events)):
        (tmp_path / tag).mkdir()
        srv, sets = mk(tmp_path / tag)
        plane = _notify_wiring(srv, npkg, epkg)
        c = S3TestClient("127.0.0.1", srv.port)
        got = []
        try:
            got.append(c.request("PUT", "/nbkt"))
            got.append(c.request("GET", "/nbkt", query={"notification": ""}))
            for body in (b"<NotificationConfiguration",
                         _notify_doc(arn="arn:minio:sqs::ghost:webhook"),
                         _notify_doc(event="s3:ObjectTypo:*"),
                         _notify_doc()):
                got.append(c.request("PUT", "/nbkt",
                                     query={"notification": ""},
                                     body=body))
            got.append(c.request("GET", "/nbkt", query={"notification": ""}))
            stream = {}

            def listen():
                stream["resp"] = c.request(
                    "GET", "/nbkt", query={"events": "s3:ObjectCreated:*",
                                         "prefix": "p/", "idle": "1"})

            t = threading.Thread(target=listen, daemon=True)
            t.start()
            deadline = time.monotonic() + 10
            while srv.api.events.hub.subscriber_count == 0 and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            got.append(c.request("PUT", "/nbkt/p/one", body=b"1" * 100))
            got.append(c.request("PUT", "/nbkt/q/miss", body=b"2"))
            got.append(c.request("PUT", "/nbkt/p/two", body=b"3" * 7))
            got.append(c.request("DELETE", "/nbkt/p/one"))
            got.append(c.request("GET", "/nbkt/p/two"))
            t.join(30)
            assert not t.is_alive()
            st, hdrs, body = stream["resp"]
            assert st == 200, (tag, st, body[:500])
            lines = [json.loads(x) for x in body.split(b"\n") if x]
            for doc in lines:
                doc["Records"][0]["eventTime"] = "*"
            got.append((st, hdrs.get("content-type"), lines))
            out[tag] = got
        finally:
            plane.close()
            srv.api.events.close()
            srv.stop()
            sets.close()
    keys = [d["Records"][0]["s3"]["object"]["key"]
            for d in out["port"][-1][2]]
    assert out["port"][-1][0] == 200 and keys == ["p/one", "p/two"]
    assert [g[0] for g in out["port"][:6]] == [200, 200, 400, 400, 400,
                                              200]
    assert out["port"][-1] == out["ref"][-1]
    for want, have in zip(out["ref"][:-1], out["port"][:-1]):
        assert _norm(have) == _norm(want)


_REPL_XML = (b"<ReplicationConfiguration><Role>r</Role><Rule><ID>all</ID>"
             b"<Status>Enabled</Status><Filter><Prefix>k</Prefix></Filter>"
             b"<Destination><Bucket>arn:minio:replication::x:far"
             b"</Bucket></Destination></Rule></ReplicationConfiguration>")


def _repl_spec(**kw) -> str:
    """An x-minio-tpu-repl-spec header: a VersionSpec's dict, base64 JSON."""
    doc = {"v": "", "t": 1.7e9 + 3.0, "e": "", "s": 0, "dm": False,
           "md": {"X-Minio-Internal-replication-origin": "far-site"},
           "p": []}
    doc.update(kw)
    return base64.urlsafe_b64encode(json.dumps(doc).encode()).decode()


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_bucket_replication(tmp_path, monkeypatch, edge):
    """?replication GET, PUT (malformed XML refused) and DELETE, the
    replication-apply branch of PUT (a bad spec header, a short body, a
    data version, a delete marker, a repeat) and the replica-prune branch
    of DELETE (a marker, a version not there), each branch refused to an
    IAM user that is not the owner, on twin servers with IAM under both
    transports: equal statuses, masked bodies and headers, and equal
    drive files."""
    from tests.test_torch_iam import CREDS as ROOT
    from tests.test_torch_iam import _admin, _send, _twin_servers, pin_both
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    pin_both(monkeypatch)
    servers = _twin_servers(tmp_path)
    user = type(ROOT)("repluser", "replsecret12")
    data = b"replica-bytes" * 999
    vid, mvid = (str(uuid.UUID(int=n)) for n in (0xabc, 0xdef))
    spec = _repl_spec(v=vid, e=hashlib.md5(data).hexdigest(), s=len(data),
                      md={"content-type": "text/plain",
                          "X-Minio-Internal-replication-origin":
                              "far-site"})
    marker = _repl_spec(v=mvid, t=1.7e9 + 9.0, dm=True)
    out = []
    try:
        for srv, _layer in servers:
            p = srv.port

            def r(method, path, creds=ROOT, **kw):
                got.append(_norm(_send(p, creds, method, path, **kw)))

            got = []
            r("PUT", "/rpl")
            r("PUT", "/rpl", query={"versioning": ""},
              body=b"<VersioningConfiguration><Status>Enabled</Status>"
                   b"</VersioningConfiguration>")
            r("GET", "/rpl", query={"replication": ""})
            r("PUT", "/rpl", query={"replication": ""},
              body=b"<ReplicationConfiguration")
            r("PUT", "/rpl", query={"replication": ""}, body=_REPL_XML)
            r("GET", "/rpl", query={"replication": ""})
            r("PUT", "/rpl/k", body=data,
              headers={"x-minio-tpu-repl-spec": "%%not-base64%%"})
            r("PUT", "/rpl/k", body=data[:-1],
              headers={"x-minio-tpu-repl-spec": spec})
            r("PUT", "/rpl/k", body=data,
              headers={"x-minio-tpu-repl-spec": spec})
            r("PUT", "/rpl/k", headers={"x-minio-tpu-repl-spec": marker})
            r("PUT", "/rpl/k", body=data,
              headers={"x-minio-tpu-repl-spec": spec})
            _admin(p, "PUT", "add-user", {"accessKey": user.access_key},
                   json.dumps({"secretKey": user.secret_key}).encode())
            _admin(p, "PUT", "set-user-or-group-policy",
                   {"policyName": "readwrite",
                    "userOrGroup": user.access_key, "isGroup": "false"})
            r("PUT", "/rpl/k", creds=user, body=data,
              headers={"x-minio-tpu-repl-spec": spec})
            r("DELETE", "/rpl/k", creds=user, query={"versionId": vid},
              headers={"x-minio-tpu-repl-purge": "true"})
            r("PUT", "/rpl/u", creds=user, body=b"user-write")
            r("GET", "/rpl/k", query={"versionId": vid})
            r("GET", "/rpl", query={"versions": ""})
            r("DELETE", "/rpl/k", query={"versionId": mvid},
              headers={"x-minio-tpu-repl-purge": "true"})
            r("DELETE", "/rpl/k", query={"versionId": mvid},
              headers={"x-minio-tpu-repl-purge": "true"})
            r("GET", "/rpl", query={"versions": ""})
            r("DELETE", "/rpl", query={"replication": ""})
            r("GET", "/rpl", query={"replication": ""})
            out.append(got)
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
    ref, port = out
    assert [g[0] for g in port] == [200, 200, 404, 400, 200, 200, 400, 400,
                                    200, 200, 200, 403, 403, 200, 200, 200,
                                    204, 204, 200, 204, 404]
    assert port[8][2] == b'{"result": "applied"}'
    assert port[14][2] == data
    assert port == ref
    assert drive_files(tmp_path / "port") == drive_files(tmp_path / "ref")


def test_unported_verbs_answer_not_implemented(client, bucket):
    for method, path, query, hdrs in (
            ("POST", f"/{bucket}/o", {"restore": ""}, None),
            ("POST", "/", None, None)):
        status, _, body = client.request(method, path, query=query,
                                         headers=hdrs)
        assert status == 501 and b"<Code>NotImplemented</Code>" in body, \
            (method, path, query)


def test_compressed_object_of_the_reference_reads_as_reference(
        tmp_path, monkeypatch):
    """An object the reference stored compressed (MINIO_COMPRESS on for
    its server only): the port's server, with compression off, answers
    its HEAD, whole and ranged GETs and a Select with the reference's own
    statuses and bytes, the Select from the port's scan plane."""
    monkeypatch.setenv("MINIO_COMPRESS", "on")
    ref, ref_sets = _ref_server(tmp_path)
    monkeypatch.delenv("MINIO_COMPRESS")
    port, port_sets = _port_server(tmp_path)
    try:
        assert not port.api.compression_enabled
        c = S3TestClient("127.0.0.1", ref.port)
        data = scan_cases.csv_corpus(random.Random(5), 2000)
        assert c.request("PUT", "/cmp")[0] == 200
        assert c.request("PUT", "/cmp/t.csv", body=data,
                         headers={"content-type": "text/csv"})[0] == 200
        assert ref_crypto.stored_compression(
            ref_sets.get_object_info("cmp", "t.csv").user_defined)
        p = S3TestClient("127.0.0.1", port.port)
        sel = scan_cases.select_xml("SELECT * FROM S3Object WHERE a > 1")
        for method, query, hdrs, body in (
                ("HEAD", None, None, b""), ("GET", None, None, b""),
                ("GET", None, {"range": "bytes=1000-5000"}, b""),
                ("GET", None, {"range": "bytes=-99"}, b""),
                ("POST", {"select": "", "select-type": "2"}, None, sel)):
            want = _norm(c.request(method, "/cmp/t.csv", query=query,
                                   headers=hdrs, body=body))
            got = _norm(p.request(method, "/cmp/t.csv", query=query,
                                  headers=hdrs, body=body))
            assert got == want, (method, hdrs)
            assert got[0] in (200, 206)
        assert port.api.scan.stats()["device_serves"] == 1
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()


def test_handlers_read_the_compression_settings(monkeypatch):
    """MINIO_COMPRESS and MINIO_COMPRESS_ALGORITHM reach the handlers as
    the reference's read them: off and s2 by default."""
    srv = S3Server(None, creds=CREDS)
    assert not srv.api.compression_enabled
    assert srv.api.compression_algorithm == "s2"
    monkeypatch.setenv("MINIO_COMPRESS", "on")
    monkeypatch.setenv("MINIO_COMPRESS_ALGORITHM", "ZSTD")
    srv = S3Server(None, creds=CREDS)
    ref = RefServer(None, creds=CREDS)
    for api in (srv.api, ref.api):
        assert api.compression_enabled
        assert api.compression_algorithm == "zstd"
    assert srv.api._compress_algo() == port_crypto.COMPRESS_ZSTD == \
        ref.api._compress_algo()


def test_put_reads_the_body_through_readinto(tmp_path, monkeypatch):
    """Under the edge, a PUT's body reaches the engine through the body
    reader's readinto (the zero-copy seam into the staging ring), whole
    and in order, at every block of a multi-block object."""
    from minio_tpu_torch.s3.edge import server as edge_server
    calls = []
    real = edge_server._EdgeBodyReader.readinto

    def readinto(self, b):
        n = real(self, b)
        calls.append(n)
        return n
    monkeypatch.setattr(edge_server._EdgeBodyReader, "readinto", readinto)
    srv, sets = _port_server(tmp_path)
    try:
        c = S3TestClient("127.0.0.1", srv.port)
        c.request("PUT", "/rdb")
        data = np.random.default_rng(1).bytes(3 * BS + 777)
        assert c.request("PUT", "/rdb/o", body=data)[0] == 200
        assert c.request("GET", "/rdb/o")[2] == data
        assert sum(calls) == len(data)
    finally:
        srv.stop()
        sets.close()


def test_copies_of_chacha_objects_read_back(tmp_path, sse_env, monkeypatch):
    """The departure from the reference's copy: a REPLACE copy of a
    ChaCha20 object and its AES-GCM re-encryption keep a cipher record
    that names their stored bytes, so both read back (the reference's
    answer 403 "unable to unseal object key" to both)."""
    srv, sets = _port_server(tmp_path)
    try:
        c = S3TestClient("127.0.0.1", srv.port)
        c.request("PUT", "/cpy")
        data = np.random.default_rng(9).bytes(200_000)
        assert c.request("PUT", "/cpy/a", body=data, headers=SSE_S3)[0] \
            == 200
        assert c.request("PUT", "/cpy/b", headers={
            "x-amz-copy-source": "/cpy/a",
            "x-amz-metadata-directive": "REPLACE"})[0] == 200
        monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "aes-gcm")
        assert c.request("PUT", "/cpy/c", headers={
            "x-amz-copy-source": "/cpy/a", **SSE_S3})[0] == 200
        for key in ("b", "c"):
            st, _, got = c.request("GET", f"/cpy/{key}")
            assert st == 200 and got == data, key
    finally:
        srv.stop()
        sets.close()


# -- the admission gate -----------------------------------------------------

def _head(method: str, path: str, hdrs: dict) -> bytes:
    return (f"{method} {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode()


def _headers_only(port: int, method: str, path: str, body: bytes
                  ) -> tuple[int, bytes]:
    """Send a signed request's head with its Content-Length, but not one
    byte of its body; (status, response) as the server answers from the
    head alone and closes."""
    import socket
    hdrs = S3Client(port, CREDS, REGION).sign(method, path, body=body)
    hdrs["content-length"] = str(len(body))
    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall(_head(method, path, hdrs))
        got = b""
        while chunk := sock.recv(65536):
            got += chunk
    return int(got.split(b" ", 2)[1]), got


@pytest.mark.parametrize("edge", ["on", "off"])
def test_scheduler_occupancy_sheds_writes_before_the_body(
        tmp_path, monkeypatch, edge):
    """With MINIO_TPU_ADMIT_SCHED_QUEUE at 1 and two blocks parked in the
    booted node's batch former, a PUT answers 503 SlowDown from its head
    alone; a listing still answers. Once the former drains, the PUT is
    served."""
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    monkeypatch.setenv("MINIO_TPU_ADMIT_SCHED_QUEUE", "1")
    node = cluster.start_single([str(tmp_path / "d{1...8}")], creds=CREDS,
                                region=REGION, parity=M, block_size=BS,
                                device="cpu")
    try:
        c = S3Client(node.s3.port, CREDS, REGION, timeout=60)
        assert c.send("PUT", "/adm")[0] == 200
        sched = node.scheduler
        sched.max_wait = 60.0            # park the next group
        parked = sched.submit_decipher(torch.device("cpu"),
                                       np.zeros((2, 64), np.uint8),
                                       np.zeros((2, 8), np.uint32),
                                       np.zeros((2, 3), np.uint32))
        deadline = time.monotonic() + 10
        while sched.stats()["queued_blocks"] != 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        body = b"x" * 100_000
        status, got = _headers_only(node.s3.port, "PUT", "/adm/o", body)
        assert status == 503 and b"<Code>SlowDown</Code>" in got
        assert c.send("GET", "/adm")[0] == 200
        # a group that fills the bucket dispatches both at once
        fill = sched.submit_decipher(
            torch.device("cpu"), np.zeros((sched.max_batch, 64), np.uint8),
            np.zeros((sched.max_batch, 8), np.uint32),
            np.zeros((sched.max_batch, 3), np.uint32))
        assert parked.result(timeout=30) is not None
        assert fill.result(timeout=30) is not None
        assert sched.stats()["queued_blocks"] == 0
        sched.max_wait = 0.003
        assert c.send("PUT", "/adm/o", body=body)[0] == 200
    finally:
        node.shutdown()


@pytest.mark.parametrize("edge", ["on", "off"])
def test_client_budget_sheds_after_the_deadline(tmp_path, monkeypatch,
                                                edge):
    """MINIO_TPU_MAX_CLIENTS=1: while one PUT holds the only slot (its
    body half sent), a second PUT waits MINIO_TPU_REQUEST_DEADLINE and
    answers 503 SlowDown without its body; the first then completes."""
    import socket
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    monkeypatch.setenv("MINIO_TPU_MAX_CLIENTS", "1")
    monkeypatch.setenv("MINIO_TPU_REQUEST_DEADLINE", "0.5")
    srv, sets = _port_server(tmp_path)
    try:
        c = S3Client(srv.port, CREDS, REGION, timeout=60)
        assert c.send("PUT", "/bud")[0] == 200
        body = np.random.default_rng(3).bytes(300_000)
        hdrs = c.sign("PUT", "/bud/held", body=body)
        hdrs["content-length"] = str(len(body))
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=60) as held:
            held.sendall(_head("PUT", "/bud/held", hdrs) + body[:1000])
            deadline = time.monotonic() + 10
            while srv.api.admission._sem._value != 0:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            t0 = time.monotonic()
            status, got = _headers_only(srv.port, "PUT", "/bud/shed", body)
            assert status == 503 and b"<Code>SlowDown</Code>" in got
            assert time.monotonic() - t0 >= 0.5
            held.sendall(body[1000:])
            assert held.recv(65536).startswith(b"HTTP/1.1 200")
        assert c.send("GET", "/bud/held")[2] == body
    finally:
        srv.stop()
        sets.close()


# -- quota, and the GET decipher through the former -------------------------

def test_quota_set_by_the_reference_holds_on_the_port(tmp_path):
    """A hard quota that minio_tpu's BucketMetadataSys writes over shared
    drives refuses a port PUT past it with the reference's own answer."""
    ref, ref_sets = _ref_server(tmp_path)
    port, port_sets = _port_server(tmp_path)
    try:
        ref_sets.make_bucket("quota")
        ref_bmeta.BucketMetadataSys(ref_sets).update(
            "quota", quota={"quota": 300_000, "type": "hard"})
        cr = S3TestClient("127.0.0.1", ref.port)
        cp = S3TestClient("127.0.0.1", port.port)
        body = np.random.default_rng(4).bytes(200_000)
        assert cp.request("PUT", "/quota/a", body=body)[0] == 200
        want = _norm(cr.request("PUT", "/quota/b", body=body))
        got = _norm(cp.request("PUT", "/quota/b", body=body))
        assert want[0] == got[0] == 409 and want[2] == got[2]
        assert b"<Code>QuotaExceeded</Code>" in got[2]
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()


def test_concurrent_sse_gets_decipher_on_the_former(tmp_path, monkeypatch,
                                                    sse_env):
    """Encrypted GETs of a booted node, whole and ranged, released at once:
    every decipher runs on the batch former's dispatch threads, never on a
    handler thread, and the former deciphers exactly the packages the
    GETs cover."""
    import threading
    pkg = port_crypto.PKG_SIZE
    threads = []
    real = codec_mod.decipher_packages

    def recorded(*a, **kw):
        threads.append(threading.current_thread().name)
        return real(*a, **kw)
    monkeypatch.setattr(codec_mod, "decipher_packages", recorded)
    node = cluster.start_single([str(tmp_path / "d{1...8}")], creds=CREDS,
                                region=REGION, parity=M, block_size=BS,
                                device="cpu")
    try:
        c = S3Client(node.s3.port, CREDS, REGION, timeout=120)
        assert c.send("PUT", "/dec")[0] == 200
        rng = np.random.default_rng(8)
        objs = {"s3": (rng.bytes(5 * pkg + 77), SSE_S3),
                "c": (rng.bytes(3 * pkg), SSEC)}
        for k, (d, h) in objs.items():
            assert c.send("PUT", f"/dec/{k}", body=d, headers=h)[0] == 200
        # (object, inclusive byte range or None, packages it covers)
        gets = [("s3", None, 6), ("c", None, 3),
                ("s3", (pkg - 5, 3 * pkg + 3), 4), ("c", (100, 200), 1)]
        before = node.scheduler.stats()["verbs"]["decipher"]
        jobs = {}
        for i, (key, span, _n) in enumerate(gets):
            h = dict(objs[key][1])
            if span is not None:
                h["range"] = f"bytes={span[0]}-{span[1]}"
            jobs[i] = (lambda key=key, h=h: c.send("GET", f"/dec/{key}",
                                                   headers=h))
        results = _at_once(jobs)
        for i, (key, span, _n) in enumerate(gets):
            d = objs[key][0]
            want = d if span is None else d[span[0]:span[1] + 1]
            assert results[i][0] in (200, 206) and results[i][2] == want, i
        after = node.scheduler.stats()["verbs"]["decipher"]
        assert after["blocks"] - before["blocks"] == \
            sum(n for _k, _s, n in gets)
        assert 1 <= after["batches"] - before["batches"] <= len(gets)
        assert threads and all(n.startswith("sched-dispatch")
                               for n in threads), threads
    finally:
        node.shutdown()


def _at_once(jobs: dict) -> dict:
    """Run every job of {name: fn()} on its own thread, released at one
    barrier; {name: result}. A job's exception fails the test."""
    import threading
    start = threading.Barrier(len(jobs), timeout=60)
    out, errors = {}, []

    def run(name, fn):
        try:
            start.wait()
            out[name] = fn()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append((name, e))
    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return out
