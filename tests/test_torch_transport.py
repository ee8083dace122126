"""The port's internode transport (minio_tpu_torch/distributed/transport.py
and membership.py) held against minio_tpu's.

  * tests/test_transport_retry.py's cases, each run against both
    packages: the token's clock skew, retries of idempotent verbs inside
    the deadline, mutations failing fast, the offline flip on transport
    failures only, the offline host failing fast, the probe that brings a
    host back and its exponential backoff, mid-stream faults mapped to
    the retryable NetworkStorageError, and a remote's own error leaving
    the host online;
  * the wire both ways: each package's RestClient against the other's
    RPCHandler for plain, JSON, streamed-request and streamed-response
    verbs, the 403 of a bad token and the 404 ``unknown-verb``, with the
    identity and generation headers observed on both sides;
  * the port's additions: a boot generation per client and handler (a
    node rebooted in a process it shares with its peers is seen as a new
    incarnation and re-admitted by the generation listener), and the
    per-verb call and byte counters.
"""

from __future__ import annotations

import json
import socket
import time
import types

import pytest

import minio_tpu.distributed.membership as ref_membership
import minio_tpu.distributed.storage_rpc as ref_srpc
import minio_tpu.distributed.transport as ref_transport
import minio_tpu.storage as ref_storage
import minio_tpu_torch.distributed.membership as port_membership
import minio_tpu_torch.distributed.storage_rpc as port_srpc
import minio_tpu_torch.distributed.transport as port_transport
import minio_tpu_torch.storage.errors as port_errors
from minio_tpu_torch.storage.xl_storage import XLStorage as PortXL

AK, SK = "minio", "miniosecret"

PKGS = {
    "ref": types.SimpleNamespace(tr=ref_transport, srpc=ref_srpc,
                                 mem=ref_membership,
                                 serr=ref_storage.errors,
                                 XL=ref_storage.XLStorage),
    "port": types.SimpleNamespace(tr=port_transport, srpc=port_srpc,
                                  mem=port_membership, serr=port_errors,
                                  XL=PortXL),
}
both = pytest.mark.parametrize("pkg", ["ref", "port"])


# ---------------------------------------------------------------------------
# tests/test_transport_retry.py, against both packages
# ---------------------------------------------------------------------------

@both
def test_token_tolerates_clock_skew(pkg):
    tr = PKGS[pkg].tr
    assert tr.verify_token(tr.make_token(AK, SK, ttl=-10), AK, SK)
    assert not tr.verify_token(tr.make_token(AK, SK, ttl=-45), AK, SK)
    tok = tr.make_token(AK, SK)
    assert tr.verify_token(tok, AK, SK)
    assert not tr.verify_token(tok, AK, "other")


def _counting(pkg, script, **kw):
    """A RestClient whose wire layer is replaced by a scripted callable."""
    tr = PKGS[pkg].tr

    class CountingClient(tr.RestClient):
        def __init__(self):
            kw.setdefault("timeout", 5.0)
            super().__init__("127.0.0.1", 1, "/t/v1", AK, SK, **kw)
            self.attempts = 0

        def _call_once(self, verb, args, body, stream_response,
                       body_length, timeout):
            self.attempts += 1
            return script(self.attempts)

    return CountingClient()


@both
@pytest.mark.parametrize("case", ["retries_then_succeeds",
                                  "mutation_fails_fast",
                                  "conn_failure_goes_offline",
                                  "protocol_failure_stays_online",
                                  "deadline_caps_attempts"])
def test_retry_loop(pkg, case, monkeypatch):
    tr = PKGS[pkg].tr
    monkeypatch.setattr(tr, "RPC_RETRY_BACKOFF", 0.001)

    def fail(conn_failure=True):
        def script(n):
            raise tr.NetworkError("blip", conn_failure=conn_failure)
        return script

    if case == "retries_then_succeeds":
        c = _counting(pkg, lambda n: b"ok" if n == 3 else fail()(n))
        assert c.call("readall", idempotent=True) == b"ok"
        assert (c.attempts, c.online, c.retries) == (3, True, 2)
    elif case == "mutation_fails_fast":
        c = _counting(pkg, fail())
        with pytest.raises(tr.NetworkError):
            c.call("createfile")            # mutation: never replayed
        assert (c.attempts, c.online) == (1, False)
    elif case == "conn_failure_goes_offline":
        c = _counting(pkg, fail())
        with pytest.raises(tr.NetworkError):
            c.call("readall", idempotent=True)
        assert c.attempts == 1 + tr.RPC_RETRIES
        assert not c.online and c.offline_trips == 1
    elif case == "protocol_failure_stays_online":
        c = _counting(pkg, fail(conn_failure=False))
        with pytest.raises(tr.NetworkError):
            c.call("readall", idempotent=True)
        assert c.online                     # the peer answered: alive
    else:
        monkeypatch.setattr(tr, "RPC_RETRY_BACKOFF", 10.0)
        c = _counting(pkg, fail())
        t0 = time.monotonic()
        with pytest.raises(tr.NetworkError):
            c.call("readall", idempotent=True, deadline=0.05)
        assert c.attempts == 1
        assert time.monotonic() - t0 < 1.0
    c.close()


@both
def test_offline_host_fails_fast(pkg):
    c = _counting(pkg, lambda n: b"ok")
    c._online = False
    with pytest.raises(PKGS[pkg].tr.NetworkError):
        c.call("readall", idempotent=True)
    assert c.attempts == 0
    c.close()


def _rpc_host(pkg, prefix="/t/v1", node_id=""):
    tr = PKGS[pkg].tr
    srv = tr.RPCServer(port=0)
    h = tr.RPCHandler(prefix, AK, SK, node_id=node_id)
    srv.mount(h)
    srv.start()
    return srv, h


@both
def test_probe_brings_host_back_online(pkg, monkeypatch):
    tr = PKGS[pkg].tr
    monkeypatch.setattr(tr, "HEALTH_PROBE_INTERVAL", 0.05)
    srv, _h = _rpc_host(pkg)
    try:
        c = tr.RestClient("127.0.0.1", srv.port, "/t/v1", AK, SK)
        c.mark_offline()
        deadline = time.monotonic() + 5
        while not c.online and time.monotonic() < deadline:
            time.sleep(0.02)
        assert c.online
        c.close()
    finally:
        srv.stop()


@both
def test_probe_delay_grows_exponentially(pkg, monkeypatch):
    tr = PKGS[pkg].tr
    sleeps = []
    monkeypatch.setattr(tr, "HEALTH_PROBE_INTERVAL", 1.0)
    monkeypatch.setattr(tr, "HEALTH_PROBE_MAX", 8.0)
    c = tr.RestClient("127.0.0.1", 1, "/t/v1", AK, SK)  # nothing listens
    real_sleep = time.sleep

    def fake_sleep(d):
        sleeps.append(d)
        if len(sleeps) >= 6:
            c._online = True            # stop the loop
        real_sleep(0)

    monkeypatch.setattr(tr.time, "sleep", fake_sleep)
    c._online = False
    c._probe_loop()
    for want, got in zip([1, 2, 4, 8, 8, 8], sleeps):
        assert 0.74 * want <= got <= 1.26 * want, (want, got)


@both
def test_midstream_faults_map_to_retryable_errors(pkg):
    p = PKGS[pkg]

    class BrokenResp:
        def read(self, n=-1):
            raise ConnectionResetError("peer reset")

    class Conn:
        closed = False

        def close(self):
            self.closed = True

    conn = Conn()
    with pytest.raises(p.tr.NetworkError):
        p.tr._StreamedResponse(conn, BrokenResp()).read(10)
    assert conn.closed

    class Broken:
        def read(self, n=-1):
            raise p.tr.NetworkError("mid-stream: reset")

        def close(self):
            pass

    with pytest.raises(p.serr.NetworkStorageError):
        p.srpc._RemoteStream(Broken()).read(10)


@both
def test_remote_rpc_error_does_not_flip_online(pkg, tmp_path):
    p = PKGS[pkg]
    drive = p.XL(str(tmp_path / "d0"))
    srv = p.tr.RPCServer(port=0)
    rpc = p.srpc.StorageRPCServer({"/d0": drive}, AK, SK)
    srv.mount_route(p.srpc.STORAGE_RPC_PREFIX, rpc.handler)
    srv.start()
    try:
        rs = p.srpc.RemoteStorage("127.0.0.1", srv.port, "/d0", AK, SK)
        with pytest.raises(p.serr.StorageError):
            rs.read_all("novol", "nofile")   # remote storage error
        assert rs.is_online()                # ...but the peer is alive
        drive.make_vol("v")
        drive.write_all("v", "f", b"data")
        assert rs.read_all("v", "f") == b"data"
    finally:
        srv.stop()


@both
def test_remote_transport_error_maps_to_network_storage_error(pkg):
    p = PKGS[pkg]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                                # nothing listens on `port`
    rs = p.srpc.RemoteStorage("127.0.0.1", port, "/d0", AK, SK,
                              timeout=0.5)
    with pytest.raises(p.serr.NetworkStorageError):
        rs.read_all("v", "f")
    assert not rs.is_online()
    rs.close()


# ---------------------------------------------------------------------------
# the wire both ways
# ---------------------------------------------------------------------------

def _echo_handler(h):
    h.register("plain", lambda a, b: b"plain:" + b + a.get("x", "").encode())
    h.register("json", lambda a, b: {"got": json.loads(b.decode()),
                                     "args": a})
    h.register("none", lambda a, b: None)
    h.register("fail", lambda a, b: (_ for _ in ()).throw(
        ValueError("no good")))

    def upload(a, reader):
        n = 0
        while True:
            c = reader.read(1 << 16)
            if not c:
                return {"received": n}
            n += len(c)

    h.register("upload", upload, stream_body=True)

    def download(a, b):
        n = int(a["n"])
        return (bytes([i % 251]) * 1000 for i in range(n))

    h.register("download", download)


WIRES = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.mark.parametrize("client,server", WIRES,
                         ids=[f"{c}-to-{s}" for c, s in WIRES])
def test_verbs_cross_packages(client, server):
    srv, h = _rpc_host(server, node_id=f"127.0.0.1:7{len(server)}")
    _echo_handler(h)
    tr = PKGS[client].tr
    try:
        c = tr.RestClient("127.0.0.1", srv.port, "/t/v1", AK, SK)
        c.node_id = "127.0.0.1:61999"
        assert c.call("plain", {"x": "y"}, b"body") == b"plain:bodyy"
        assert c.call_json("json", {"a": "1"}, payload=[1, "two"]) == \
            {"got": [1, "two"], "args": {"a": "1"}}
        assert c.call("none") == b""
        with pytest.raises(tr.RPCError) as ei:
            c.call("fail")
        assert (ei.value.kind, ei.value.message) == ("ValueError",
                                                     "no good")
        with pytest.raises(tr.RPCError) as ei:
            c.call("nosuchverb")
        assert (ei.value.kind, ei.value.message) == ("unknown-verb",
                                                     "nosuchverb")
        body = (b"z" * 5000 for _ in range(40))
        assert json.loads(c.call("upload", body=body,
                                 body_length=200_000)) == \
            {"received": 200_000}
        s = c.call("download", {"n": "300"}, stream_response=True)
        got = b""
        while True:
            chunk = s.read(7777)
            if not chunk:
                break
            got += chunk
        s.close()
        assert got == b"".join(bytes([i % 251]) * 1000 for i in range(300))
        bad = tr.RestClient("127.0.0.1", srv.port, "/t/v1", AK, "nope")
        with pytest.raises(tr.RPCError) as ei:
            bad.call("plain")
        assert ei.value.kind == "auth"
        assert c.online and bad.online
        # each side saw the other's identity and boot generation
        assert PKGS[client].mem.TRACKER.generation_of(
            f"127.0.0.1:{srv.port}") == PKGS[server].mem.local_generation()
        assert PKGS[server].mem.TRACKER.generation_of(
            "127.0.0.1:61999") == PKGS[client].mem.local_generation()
        c.close()
        bad.close()
    finally:
        srv.stop()


@both
def test_health_answers_without_a_token(pkg):
    import http.client
    srv, _h = _rpc_host(pkg, node_id="127.0.0.1:5")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        conn.request("GET", "/t/v1/health")
        resp = conn.getresponse()
        assert (resp.status, resp.read()) == (200, b"OK")
        assert resp.getheader("x-ntpu-node") == "127.0.0.1:5"
        assert int(resp.getheader("x-ntpu-gen")) == \
            PKGS[pkg].mem.local_generation()
        conn.close()
    finally:
        srv.stop()


def test_generation_change_fences_peer_state():
    """A peer seen under a new boot generation fires the fencing
    listeners: the transport's drops its latency windows and re-admits
    its clients."""
    from minio_tpu_torch.utils import healthtrack
    tracker = port_membership.TRACKER
    peer = "127.0.0.1:1"
    c = port_transport.RestClient("127.0.0.1", 1, "/t/v1", AK, SK)
    c._online = False
    healthtrack.observe_peer(peer, "readall", 0.5)
    assert healthtrack.TRACKER.percentile("peer", peer, 0.5) == 0.5
    seen = []
    tracker.add_listener(lambda p, o, n: seen.append((p, o, n)))
    assert not tracker.observe(peer, 111, peer)      # first sight
    assert tracker.observe(peer, 222, peer)          # a new incarnation
    assert (peer, 111, 222) in seen
    assert healthtrack.TRACKER.percentile("peer", peer, 0.5) is None
    assert [e["verbs"] for e in healthtrack.TRACKER.snapshot("peer")
            if e["key"] == peer] in ([], [{}])
    assert c.online
    c.close()


# ---------------------------------------------------------------------------
# the port's additions
# ---------------------------------------------------------------------------

def test_per_node_generation_readmits_a_rebooted_node():
    """Clients and handlers carry their node's own boot generation over
    the process's: a handler stamps it on its answers, and a node that
    calls under a new generation (a node rebooted in this process) fires
    the generation listener, which re-admits the clients that held it
    offline; a call under the same generation re-admits nothing."""
    srv, h = _rpc_host("port")
    h.register("ping", lambda a, b: b"pong")
    h.generation = 4242
    try:
        held = port_transport.RestClient("127.0.0.1", 40001, "/t/v1", AK, SK)
        caller = port_transport.RestClient("127.0.0.1", srv.port, "/t/v1",
                                           AK, SK)
        caller.node_id, caller.generation = "127.0.0.1:40001", 111
        assert caller.call("ping") == b"pong"
        assert port_membership.TRACKER.generation_of(
            f"127.0.0.1:{srv.port}") == 4242
        held._online = False
        assert caller.call("ping") == b"pong"
        assert not held.online              # the same incarnation
        caller.generation = 222
        assert caller.call("ping") == b"pong"
        assert held.online                  # a new one: re-admitted
        held.close()
        caller.close()
    finally:
        srv.stop()


def test_verb_stats_count_calls_and_bytes():
    srv, h = _rpc_host("port")
    _echo_handler(h)
    try:
        before = port_transport.verb_stats()
        c = port_transport.RestClient("127.0.0.1", srv.port, "/t/v1", AK, SK)
        c.call("plain", body=b"12345")
        s = c.call("download", {"n": "3"}, stream_response=True)
        while s.read(1000):
            pass
        s.close()
        after = port_transport.verb_stats()

        def d(verb, k):
            return after[verb][k] - before.get(verb, {}).get(k, 0)

        assert (d("plain", "calls"), d("plain", "sent_bytes"),
                d("plain", "received_bytes")) == (1, 5, 11)
        assert (d("download", "calls"), d("download", "received_bytes")) \
            == (1, 3000)
        c.close()
    finally:
        srv.stop()


def test_rpc_routers_bypass_admission_on_both_transports(monkeypatch):
    """A router mounted with register_router answers ahead of S3 routing
    on both transports, and past an admission gate that sheds every S3
    request (a saturated S3 plane must not starve internode verbs)."""
    from minio_tpu_torch.s3.server import S3Server
    for edge in ("on", "off"):
        monkeypatch.setenv("MINIO_TPU_EDGE", edge)
        monkeypatch.setenv("MINIO_TPU_REQUEST_DEADLINE", "0.2")
        s3 = S3Server(None)
        h = port_transport.RPCHandler("/minio/t/v1", AK, SK)
        h.register("ping", lambda a, b: b"pong")
        s3.register_router("/minio/t/", h.route)
        s3.api.set_max_clients(1)
        s3.start()
        try:
            ticket = s3.api.admission.admit("GET", "/b/o", {}, {})
            c = port_transport.RestClient("127.0.0.1", s3.port,
                                          "/minio/t/v1", AK, SK)
            assert c.call("ping") == b"pong"
            with pytest.raises(port_transport.RPCError):
                c.call("nosuchverb")
            ticket.release()
            c.close()
        finally:
            s3.stop()
