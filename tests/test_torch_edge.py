"""The port's event-loop HTTP edge (minio_tpu_torch/s3/edge/server.py) held
against minio_tpu's.

  * tests/test_edge.py's seven cases rebound to the port's server
    (tests/test_torch_iam.rebound), on both transports where the reference
    runs them on both: keep-alive reuse, pipelined requests, the admission
    and staging sheds before the first body byte, the slowloris deadline,
    the quiet idle reap and a client dying mid-body;
  * ``MINIO_TPU_EDGE_WORKERS=2``: two loops on one port (``SO_REUSEPORT``),
    both accepting, the reference's and the port's answers equal, the
    edge's counters and gauges exported under the reference's names, each
    loop's lag under its own label;
  * ``stop()`` returns only when no worker serves: a PUT whose body is
    streaming when the edge stops is cut off and never commits, and a
    request in a worker holds ``stop()`` until it ends.
Four data and two parity drives at 64 KiB blocks, device="cpu".
"""

from __future__ import annotations

import hashlib
import socket
import threading
import time

import numpy as np
import pytest

import tests.test_edge as ref_cases
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3 import signature as sig
from minio_tpu_torch.s3.credentials import Credentials
from minio_tpu_torch.s3.edge import server as edge_server_mod
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.utils import telemetry
from tests.test_s3 import S3TestClient
from tests.test_torch_iam import rebound

CREDS = Credentials(ref_cases.CREDS.access_key, ref_cases.CREDS.secret_key)
REGION = ref_cases.REGION
BLOCK = ref_cases.BLOCK


def _port(fn):
    return rebound(fn, CREDS=CREDS)


_mk_server = _port(ref_cases._mk_server)


@pytest.fixture(scope="module")
def layer(tmp_path_factory):
    root = tmp_path_factory.mktemp("edgedrives")
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(6)],
                                   1, 6, 2, block_size=BLOCK, device="cpu")
    yield sets
    sets.close()


@pytest.fixture()
def edge_server(layer):
    srv = _mk_server(layer, MINIO_TPU_EDGE="on")
    yield srv
    srv.stop()


@pytest.fixture(params=["edge", "threaded"])
def any_server(request, layer):
    srv = _mk_server(layer, MINIO_TPU_EDGE="on"
                     if request.param == "edge" else "off")
    assert srv.edge_enabled == (request.param == "edge")
    yield srv
    srv.stop()


@pytest.mark.parametrize("name", [
    "test_keepalive_reuse_across_requests",
    "test_staging_shed_parity_retry_after_and_close"])
def test_reference_case_on_both_transports(any_server, name):
    _port(getattr(ref_cases, name))(any_server)


@pytest.mark.parametrize("name", [
    "test_pipelined_requests_carry_over",
    "test_admission_shed_before_body_byte",
    "test_midbody_death_frees_staging_and_slot"])
def test_reference_case_on_the_edge(edge_server, name):
    _port(getattr(ref_cases, name))(edge_server)


@pytest.mark.parametrize("name", [
    "test_slowloris_partial_header_sheds_not_leaks",
    "test_idle_connection_reaped_quietly"])
def test_reference_case_on_a_fresh_edge(layer, name):
    _port(getattr(ref_cases, name))(layer)


# -- MINIO_TPU_EDGE_WORKERS ---------------------------------------------------

def _family(name: str) -> dict:
    """label tuple -> value of one exposition family, collectors run."""
    text = telemetry.REGISTRY.render()
    out = {}
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            out[head[len(name):]] = float(value)
    return out


def test_two_loops_both_accept_and_answer_as_reference(tmp_path,
                                                       monkeypatch):
    """Both packages at MINIO_TPU_EDGE_WORKERS=2: 48 connections, one
    signed request each, the same statuses and bodies from both; each of
    the port's two loops accepted some of them, the families count every
    accept and request, the pool gauges are exported, and the loops' lag
    samples carry distinct labels."""
    monkeypatch.setenv("MINIO_TPU_EDGE_WORKERS", "2")
    monkeypatch.setenv("MINIO_TPU_EDGE", "on")
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_sets = RefSets.from_drives(
        [str(tmp_path / "ref" / f"d{i}") for i in range(6)], 1, 6, 2,
        block_size=BLOCK)
    port_sets = ErasureSets.from_drives(
        [str(tmp_path / "port" / f"d{i}") for i in range(6)], 1, 6, 2,
        block_size=BLOCK, device="cpu")
    ref = RefServer(ref_sets, creds=ref_cases.CREDS, region=REGION).start()
    port = S3Server(port_sets, creds=CREDS, region=REGION).start()
    edge = port._edge
    accepted0 = _family("minio_tpu_edge_accepted_total").get("", 0.0)
    requests0 = _family("minio_tpu_edge_requests_total").get("", 0.0)
    try:
        assert len(edge.loops) == 2 and len(ref._edge.loops) == 2
        body = np.random.default_rng(5).bytes(3000)
        answers = []
        for srv in (ref, port):
            c = S3TestClient("127.0.0.1", srv.port)
            out = [c.request("PUT", "/loops")[:1]]
            for i in range(48):
                path = f"/loops/o{i % 4}"
                st, _h, data = c.request(
                    "PUT" if i < 4 else "GET", path,
                    body=body if i < 4 else b"")
                out.append((st, data))
            answers.append(out)
        assert answers[0] == answers[1]
        per_loop = [lp.accepted for lp in edge.loops]
        assert all(n > 0 for n in per_loop), per_loop
        assert sum(lp.requests for lp in edge.loops) == 49
        fam = _family("minio_tpu_edge_accepted_total")
        assert fam[""] - accepted0 == sum(per_loop)
        fam = _family("minio_tpu_edge_requests_total")
        assert fam[""] - requests0 == 49
        for g in ("open_conns", "pool_size", "pool_busy", "pool_idle",
                  "pool_pending"):
            assert "" in _family(f"minio_tpu_edge_{g}"), g
        assert _family("minio_tpu_edge_pool_size")[""] == edge.pool.size
        st = edge.pool.stats()
        assert st["busy"] == st["threads"] - st["idle"]
        labels = {lp.label for lp in edge.loops}
        assert labels == {f"{port.port}:0", f"{port.port}:1"}
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()


# -- stop() --------------------------------------------------------------------

def _put_head(port: int, path: str, body: bytes) -> bytes:
    hdrs = sig.sign_v4("PUT", path, {}, {"host": f"127.0.0.1:{port}"},
                       hashlib.sha256(body).hexdigest(), CREDS, REGION)
    hdrs["content-length"] = str(len(body))
    return (f"PUT {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode()


@pytest.mark.parametrize("workers", [1, 2])
def test_stop_leaves_no_worker_serving(layer, monkeypatch, workers):
    """A PUT whose body is still streaming when the edge stops: stop()
    returns with no worker serving, the client's stream is cut off, the
    object never commits, and the port refuses new connections."""
    monkeypatch.setenv("MINIO_TPU_EDGE_WORKERS", str(workers))
    srv = _mk_server(layer, MINIO_TPU_EDGE="on")
    port = srv.port
    c = S3TestClient("127.0.0.1", port)
    bucket = f"stopb-{workers}"
    assert c.request("PUT", f"/{bucket}")[0] == 200
    body = np.random.default_rng(9).bytes(4 << 20)
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    sent = [0]
    s.sendall(_put_head(port, f"/{bucket}/o", body) + body[:BLOCK])
    sent[0] = BLOCK
    deadline = time.monotonic() + 10
    while srv._edge.serving() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv._edge.serving() == 1
    cut = threading.Event()

    def stream():
        # the peer keeps streaming while the edge stops
        try:
            while sent[0] < len(body):
                s.sendall(body[sent[0]:sent[0] + 4096])
                sent[0] += 4096
                time.sleep(0.001)
        except OSError:
            cut.set()

    t = threading.Thread(target=stream, daemon=True)
    t.start()
    time.sleep(0.05)
    srv.stop()
    assert srv._edge.serving() == 0
    t.join(timeout=10)
    assert cut.is_set() and sent[0] < len(body)
    s.close()
    with pytest.raises(Exception):
        layer.get_object_info(bucket, "o")
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=5)


def test_stop_waits_for_the_request_in_a_worker(layer, monkeypatch):
    """A request a worker is serving when stop() begins holds stop()
    until it returns (the handler here sleeps past the shutdown of its
    socket), and a request the loop handed over after stop() began is
    refused before it runs."""
    srv = _mk_server(layer, MINIO_TPU_EDGE="on")
    gate = threading.Event()
    ran = []

    def slow(ctx):
        gate.wait(5)
        ran.append(ctx.req.path)
        from minio_tpu_torch.s3.handlers import HTTPResponse
        return HTTPResponse(body=b"late")

    srv.register_router("/slow/", slow)
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=30)
    s.sendall(b"GET /slow/x HTTP/1.1\r\nHost: h\r\n\r\n")
    deadline = time.monotonic() + 10
    while srv._edge.serving() == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    stopped = threading.Event()

    def stop():
        srv.stop()
        stopped.set()

    threading.Thread(target=stop, daemon=True).start()
    time.sleep(0.3)
    assert not stopped.is_set() and srv._edge.serving() == 1
    gate.set()
    assert stopped.wait(10)
    assert ran == ["/slow/x"] and srv._edge.serving() == 0
    # the loop's hand-over after closed: refused, nothing runs
    edge = srv._edge
    lp = edge.loops[0]
    a, b = socket.socketpair()
    conn = edge_server_mod._Conn(a, ("127.0.0.1", 0))
    edge.track(conn, +1)
    edge.serve_request(lp, conn, "GET", "/slow/y", "/slow/y", "", {}, {},
                       "HTTP/1.1", 0, b"")
    assert ran == ["/slow/x"] and conn.closed
    b.close()
    s.close()
