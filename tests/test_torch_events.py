"""The port's legacy event notifier and its wire targets
(minio_tpu_torch/features/events.py) held against minio_tpu's.

  * every case of tests/test_events_durable.py rebound to the port
    (tests/test_torch_iam.rebound): the durable QueueStore, restart and
    redrive, the legacy replication pool's durable queue re-driven after
    a restart (its sets, which it takes from tests/test_features.py, the
    port's on device="cpu"), and each wire target
    against the reference's in-process brokers (Redis, MQTT, Kafka, NATS,
    Elasticsearch, NSQ, AMQP, Postgres with MD5 and SCRAM-SHA-256, MySQL
    native and caching_sha2); and tests/test_features.py's
    test_event_rules_and_memory_target, its sets on device="cpu";
  * wire bytes: one record sent by each package's target of every wire
    kind through a tap in front of the same fake broker: the bytes each
    client wrote are equal, connection for connection (the clock,
    the MQTT client id and the SCRAM nonce pinned in both packages).
"""

from __future__ import annotations

import http.server
import inspect
import socket
import threading
import types

import pytest

import minio_tpu.features.events as ref_events
import minio_tpu_torch.features.events as port_events
import tests.test_events_durable as ref_cases
import tests.test_features as ref_features
from minio_tpu_torch.object.sets import ErasureSets
from tests.test_torch_iam import rebound

# -- the reference's cases, rebound -----------------------------------------------

_CASES = sorted(name for name, fn in vars(ref_cases).items()
                if name.startswith("test_") and inspect.isfunction(fn))


def test_every_reference_case_is_rebound():
    assert len(_CASES) == 20, _CASES


class _CpuSets:
    @staticmethod
    def from_drives(*args, **kw):
        return ErasureSets.from_drives(*args, device="cpu", **kw)


@pytest.mark.parametrize("name", _CASES)
def test_reference_event_cases(tmp_path, monkeypatch, name):
    # a case that imports tests/test_features.py's _mk_sets takes the
    # port's sets through it
    monkeypatch.setattr(ref_features, "_mk_sets",
                        rebound(ref_features._mk_sets, ErasureSets=_CpuSets))
    fn = rebound(getattr(ref_cases, name))
    given = {"tmp_path": tmp_path}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_reference_event_rules_and_memory_target(tmp_path):
    rebound(ref_features.test_event_rules_and_memory_target,
            ErasureSets=_CpuSets)(tmp_path)


# -- wire bytes ---------------------------------------------------------------------

class Tap:
    """A TCP relay in front of a broker: every connection's client bytes
    are kept, in order (one list of chunks joined per connection)."""

    def __init__(self, upstream_port: int):
        self.upstream = upstream_port
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.conns: list[bytearray] = []
        self._mu = threading.Lock()
        self._pumps: list[threading.Thread] = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            up = socket.create_connection(("127.0.0.1", self.upstream))
            buf = bytearray()
            with self._mu:
                self.conns.append(buf)
            for src, dst, rec in ((c, up, buf), (up, c, None)):
                t = threading.Thread(target=self._pump,
                                     args=(src, dst, rec), daemon=True)
                t.start()
                self._pumps.append(t)

    @staticmethod
    def _pump(src, dst, rec):
        try:
            while True:
                b = src.recv(65536)
                if not b:
                    break
                if rec is not None:
                    rec += b
                dst.sendall(b)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def take(self) -> list[bytes]:
        """The client bytes of every connection so far (each connection
        closed first), and a fresh start."""
        for t in list(self._pumps):
            t.join(timeout=10)
        with self._mu:
            out = [bytes(b) for b in self.conns]
            self.conns.clear()
            self._pumps.clear()
        return out

    def close(self):
        self.srv.close()


class _OkHTTP(http.server.BaseHTTPRequestHandler):
    """Answers any request 200 with a small JSON body."""
    protocol_version = "HTTP/1.0"

    def _h(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        if n:
            self.rfile.read(n)
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")
    do_PUT = do_POST = do_DELETE = do_GET = do_HEAD = _h

    def log_message(self, *a):
        pass


class _HTTPBroker:
    def __init__(self):
        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _OkHTTP)
        self.port = self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


class _NSQ:
    """nsqd's V2 PUB: answers OK to each frame."""

    def __init__(self):
        self.sock = socket.create_server(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                try:
                    f = conn.makefile("rb")
                    f.read(4)
                    f.readline()
                    f.read(int.from_bytes(f.read(4), "big"))
                    conn.sendall((6).to_bytes(4, "big")
                                 + (0).to_bytes(4, "big") + b"OK")
                    f.read(1)
                except OSError:
                    pass

    def close(self):
        self.sock.close()


def _targets(ev, addr: str, url: str) -> dict:
    """kind -> (a target of package `ev` at addr/url)."""
    return {
        "webhook": lambda: ev.WebhookTarget("arn:w", url + "/hook"),
        "redis": lambda: ev.RedisTarget("arn:r", addr, "bucketevents"),
        "redis-access": lambda: ev.RedisTarget("arn:r2", addr, "log",
                                               format="access"),
        "mqtt": lambda: ev.MQTTTarget("arn:m", addr, "minio/events",
                                      client_id="wire-client"),
        "nats": lambda: ev.NATSTarget("arn:n", addr, "minio.events"),
        "amqp": lambda: ev.AMQPTarget("arn:a", addr, exchange="ex",
                                      routing_key="rk"),
        "nsq": lambda: ev.NSQTarget("arn:q", addr, "minio_events"),
        "postgres-md5": lambda: ev.PostgresTarget(
            "arn:p", addr, "db", "events", user="u", password="pw"),
        "postgres-scram": lambda: ev.PostgresTarget(
            "arn:p2", addr, "db", "events", user="u", password="pw"),
        "mysql-native": lambda: ev.MySQLTarget(
            "arn:s", addr, "db", "events", user="u", password="pw"),
        "mysql-sha2": lambda: ev.MySQLTarget(
            "arn:s2", addr, "db", "events", user="u", password="pw"),
        "elasticsearch": lambda: ev.ElasticsearchTarget(
            "arn:e", url, "events"),
        "kafka": lambda: ev.KafkaTarget("arn:k", [addr], "events"),
    }


_BROKERS = {
    "webhook": _HTTPBroker, "elasticsearch": _HTTPBroker,
    "redis": ref_cases.FakeRedis, "redis-access": ref_cases.FakeRedis,
    "mqtt": ref_cases.FakeMQTT, "nats": ref_cases.FakeNATS,
    "amqp": ref_cases.FakeAMQP, "nsq": _NSQ,
    "postgres-md5": lambda: ref_cases.FakePostgres(password="pw",
                                                   auth="md5"),
    "postgres-scram": lambda: ref_cases.FakePostgres(password="pw",
                                                     auth="scram"),
    "mysql-native": lambda: ref_cases.FakeMySQL(password="pw",
                                                auth="native"),
    "mysql-sha2": lambda: ref_cases.FakeMySQL(password="pw",
                                              auth="sha2_fast"),
    "kafka": ref_cases.FakeKafkaBroker,
}


def _close(broker):
    for name in ("close", "stop"):
        if hasattr(broker, name):
            getattr(broker, name)()
            return


@pytest.fixture
def pinned_wire(monkeypatch):
    """The clock each package's events module reads (Kafka's message
    timestamp) and the SCRAM nonces (the client's and the fake
    server's), pinned."""
    import os
    import secrets
    import time as _time
    clock = types.SimpleNamespace(**{k: getattr(_time, k) for k in dir(_time)
                                     if not k.startswith("_")})
    clock.time = lambda: 1.7e9
    for ev in (ref_events, port_events):
        monkeypatch.setattr(ev, "time", clock)
    monkeypatch.setattr(secrets, "token_bytes", lambda n: bytes(range(n)))
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))


@pytest.mark.parametrize("kind", sorted(_BROKERS))
def test_wire_bytes_equal(kind, pinned_wire):
    record = ref_events.event_record("s3:ObjectCreated:Put", "b", "x/y z",
                                     4096, "0f" * 16)
    broker = _BROKERS[kind]()
    tap = Tap(broker.port)
    try:
        addr, url = f"127.0.0.1:{tap.port}", f"http://127.0.0.1:{tap.port}"
        wire = {}
        for tag, ev in (("ref", ref_events), ("port", port_events)):
            target = _targets(ev, addr, url)[kind]()
            target.send(record)
            for name in ("close",):
                if hasattr(target, name):
                    getattr(target, name)()
            wire[tag] = tap.take()
        assert wire["port"] and all(wire["port"]), wire
        assert wire["port"] == wire["ref"]
    finally:
        tap.close()
        _close(broker)
