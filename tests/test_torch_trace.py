"""The port's request tracing (minio_tpu_torch/s3/trace.py, the root span
of s3/edge/dispatch.py and the admin routes of the tracing plane) held
against minio_tpu's on twin servers: the reference's and the port's, 4
drives at 2+2, 64 KiB blocks, device="cpu", every identity pinned in
both packages (tests/test_torch_s3.pin).

  * one signed request sequence (bucket, PUTs of one and several blocks,
    GETs whole and ranged, HEAD, a 404, a listing, a multipart upload, a
    delete), under the event-loop edge and the threaded frontend: the
    trace records are equal (api, method, path, query, status, caller and
    their keys), with times, durations, TTFBs and trace ids masked; every
    record's trace id names a kept span tree whose root is the record's
    API; and the span trees have the same span names and attributes,
    children compared as multisets (drive fan-outs finish in any order);
  * the ``spans`` route's filters (``api``, ``trace_id``, ``count``,
    ``sort=slowest``) answer alike;
  * an audit webhook set through the admin ``set-config`` route at a
    loopback receiver gets every request's record in both packages, and
    turning it off stops the shipping;
  * ``trace`` (bounded stream), ``trace/cluster``, ``events``,
    ``incidents``, ``slo``, ``consolelog`` and ``profiling/start`` /
    ``profiling/stop`` answer alike, and the four Prometheus families of
    this plane are exported by both with equal types and label names.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
import types

import pytest
import torch

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu.utils.console as ref_console
import minio_tpu.utils.eventlog as ref_eventlog
import minio_tpu.utils.healthtrack as ref_ht
import minio_tpu.utils.incidents as ref_incidents
import minio_tpu.utils.slo as ref_slo
import minio_tpu.utils.telemetry as ref_tel
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
import minio_tpu_torch.utils.console as port_console
import minio_tpu_torch.utils.eventlog as port_eventlog
import minio_tpu_torch.utils.healthtrack as port_ht
import minio_tpu_torch.utils.incidents as port_incidents
import minio_tpu_torch.utils.slo as port_slo
import minio_tpu_torch.utils.telemetry as port_tel
from minio_tpu.madmin import AdminClient as RefAdmin
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3.admin import mount_admin as ref_mount_admin
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.storage.naughty import NaughtyDisk as RefNaughty
from minio_tpu_torch.madmin import AdminClient
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.admin import mount_admin
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage.naughty import NaughtyDisk
from tests.test_s3 import CREDS, REGION, S3TestClient
from tests.test_torch_s3 import _mp_complete_xml, _upload_id, pin

N, M, BS = 4, 2, 1 << 16
BODY = {"one": bytes(range(256)) * 40, "many": bytes(range(251)) * 1200,
        "part": bytes(range(253)) * 1100}
TELS = (ref_tel, port_tel)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _servers(root, edge: str):
    """(ref, port) S3Servers with the admin router, under MINIO_TPU_EDGE
    `edge`."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MINIO_TPU_EDGE", edge)
    try:
        out = []
        for tag, sets_cls, srv_cls, mount, kw in (
                ("ref", RefSets, RefServer, ref_mount_admin, {}),
                ("port", ErasureSets, S3Server, mount_admin,
                 {"device": "cpu"})):
            sets = sets_cls.from_drives(
                [str(root / tag / f"d{i}") for i in range(N)],
                set_count=1, set_drive_count=N, parity=M, block_size=BS,
                **kw)
            srv = srv_cls(sets, creds=CREDS, region=REGION).start()
            mount(srv)
            out.append((srv, sets))
        return out
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=["on", "off"])
def twins(request, tmp_path_factory):
    """Twin servers under one transport, identities pinned, every trace
    kept."""
    mp = pytest.MonkeyPatch()
    for tel in TELS:
        mp.setattr(tel.SPANS, "sample", 1.0)
    pin(mp, ref_engine, ref_multipart, ref_bmeta, ref_handlers, ref_crypto)
    pin(mp, port_engine, port_multipart, port_bmeta, port_handlers,
        port_crypto)
    pair = _servers(tmp_path_factory.mktemp(f"trace{request.param}"),
                    request.param)
    assert [s.edge_enabled for s, _ in pair] == [request.param == "on"] * 2
    yield [s for s, _ in pair], request.param
    for srv, sets in pair:
        srv.stop()
        sets.close()
    mp.undo()


def _sequence(port: int, bucket: str) -> list:
    c = S3TestClient("127.0.0.1", port)
    out = [c.request("PUT", f"/{bucket}")[0]]
    for name in ("one", "many"):
        out.append(c.request("PUT", f"/{bucket}/{name}",
                             body=BODY[name])[0])
    out.append(c.request("GET", f"/{bucket}/many")[0])
    out.append(c.request("GET", f"/{bucket}/many",
                         headers={"range": "bytes=1000-90000"})[0])
    out.append(c.request("HEAD", f"/{bucket}/one")[0])
    out.append(c.request("GET", f"/{bucket}/nosuch")[0])
    out.append(c.request("GET", f"/{bucket}",
                         query={"list-type": "2"})[0])
    st, _h, body = c.request("POST", f"/{bucket}/mp",
                             query={"uploads": ""})
    uid = _upload_id(body)
    st, h, _ = c.request("PUT", f"/{bucket}/mp", body=BODY["part"],
                         query={"partNumber": "1", "uploadId": uid})
    out.append(st)
    st, _h, _ = c.request("POST", f"/{bucket}/mp",
                          body=_mp_complete_xml([h["etag"]]),
                          query={"uploadId": uid})
    out.append(st)
    out.append(c.request("DELETE", f"/{bucket}/one")[0])
    return out


_MASKED = ("time", "duration_ms", "ttfb_ms", "trace_id")


def _records(srv, bucket: str) -> list:
    return [e for e in list(srv.api.trace.recent)
            if e["path"].startswith(f"/{bucket}")]


def _span_shape(node: dict) -> tuple:
    kids = sorted(_span_shape(c) for c in node.get("children", ()))
    attrs = json.dumps(node.get("attrs", {}), sort_keys=True)
    return (node["name"], attrs, tuple(kids))


def _wait_records(srv, bucket: str, n: int) -> list:
    """The client sees a response a hair before the server's finally
    records it: poll."""
    deadline = time.monotonic() + 10
    while len(_records(srv, bucket)) < n and time.monotonic() < deadline:
        time.sleep(0.02)
    return _records(srv, bucket)


def test_twin_trace_records_and_span_trees(twins):
    servers, edge = twins
    bucket = f"trc{edge}"
    statuses = [_sequence(s.port, bucket) for s in servers]
    assert statuses[0] == statuses[1]
    n = len(statuses[0]) + 1            # + the CreateMultipartUpload
    recs = [_wait_records(s, bucket, n) for s in servers]
    assert len(recs[0]) == len(recs[1]) == n
    for a, b in zip(*recs):
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k not in _MASKED} == \
            {k: v for k, v in b.items() if k not in _MASKED}
    shapes = []
    for tel, rs in zip(TELS, recs):
        kept = {t["trace_id"]: t for t in tel.SPANS.dump(500)}
        trees = [kept[r["trace_id"]] for r in rs]
        assert [t["name"] for t in trees] == [r["api"] for r in rs]
        shapes.append([_span_shape(t) for t in trees])
    for (i, a), b in zip(enumerate(shapes[0]), shapes[1]):
        assert a == b, recs[1][i]
    names = {s[0] for t in shapes[1] for s in _flatten(t)}
    assert {"engine.put_object", "pipeline.encode", "pipeline.shard_write",
            "disk.shard_write", "engine.get_object", "pipeline.read_group",
            "disk.shard_read", "pipeline.verify_decode"} <= names


# each package's read_hedge_s as its module defines it (the twin pin
# replaces it for the module's tests)
_LIVE_HEDGE = {ref_ht.__name__: ref_ht.read_hedge_s,
               port_ht.__name__: port_ht.read_hedge_s}


# the live pass's deadline, from the knobs, and the slowed drive's stall
HEDGE_S, STALL_S = 0.15, 0.6


def _shard_reads(tel, trace_id: str) -> int:
    kept = {t["trace_id"]: t for t in tel.SPANS.dump(500)}
    return sum(1 for s in _flatten(_span_shape(kept[trace_id]))
               if s[0] == "disk.shard_read")


def test_twin_read_hedge_pin_and_what_it_hides(twins, monkeypatch):
    """What the twin pin's read-hedge half hides: with each package's own
    deadline live (its tracker warm, the floor and ceiling both set to
    HEDGE_S, so that the deadline does not hang on how fast the worker's
    reads run), one drive holding a data shard stalled well past it makes
    a GET race a spare shard read, in both packages alike: its tree holds
    a spare ``disk.shard_read`` span and
    ``minio_tpu_hedged_reads_total{trigger="latency"}`` rises by one.
    Under the pin (the deadline at its 2 s ceiling) the same slowed GET
    waits for the drive: k spans, no hedge."""
    servers, edge = twins
    bucket = f"hdg{edge}"
    for s in servers:
        c = S3TestClient("127.0.0.1", s.port)
        assert c.request("PUT", f"/{bucket}")[0] == 200
        assert c.request("PUT", f"/{bucket}/k", body=BODY["one"])[0] == 200
    got = []
    for s, tel, naughty, ht in zip(servers, TELS, (RefNaughty, NaughtyDisk),
                                   (ref_ht, port_ht)):
        ht.TRACKER.reset()
        slow = next(d for d in s.api.obj.sets[0].disks
                    if d.read_version(bucket, "k").erasure.index <= 2)
        inner = slow.inner
        c = S3TestClient("127.0.0.1", s.port)
        hedged = tel.REGISTRY.counter("minio_tpu_hedged_reads_total")
        row = []
        try:
            for pinned in (True, False):
                if not pinned:
                    # the package's own deadline, its tracker warmed by
                    # fast reads (the pinned pass's slow sample dropped)
                    # and clamped to HEDGE_S by the knobs
                    monkeypatch.setattr(ht, "read_hedge_s",
                                        _LIVE_HEDGE[ht.__name__])
                    ht.TRACKER.reset()
                    for _ in range(8):
                        assert c.request("GET", f"/{bucket}/k")[0] == 200
                    monkeypatch.setenv("MINIO_TPU_HEDGE_FLOOR_S",
                                       str(HEDGE_S))
                    monkeypatch.setenv("MINIO_TPU_HEDGE_CEIL_S",
                                       str(HEDGE_S))
                    assert ht.read_hedge_s() == pytest.approx(HEDGE_S)
                nd = naughty(inner, enabled=True)
                nd.stall_verbs = {"read_file_stream": STALL_S,
                                  "read_file": STALL_S}
                slow.inner = nd
                before = hedged.value(trigger="latency")
                assert c.request("GET", f"/{bucket}/k")[0] == 200
                time.sleep(STALL_S + 0.1)   # the stalled read settles
                slow.inner = inner
                rec = _wait_records(s, bucket, 0)[-1]
                assert rec["api"] == "GetObject"
                row.append((_shard_reads(tel, rec["trace_id"]),
                            hedged.value(trigger="latency") - before,
                            nd.stats.stalls))
        finally:
            slow.inner = inner
            ht.TRACKER.reset()
        got.append(row)
    assert got[0] == got[1]
    pinned_row, live_row = got[1]
    assert pinned_row[1:] == (0, 1) and live_row[1:] == (1, 1), got
    assert live_row[0] == pinned_row[0] + 1, got


def _flatten(shape: tuple):
    yield shape
    for c in shape[2]:
        yield from _flatten(c)


def test_twin_spans_route_filters(twins):
    servers, edge = twins
    bucket = f"spf{edge}"
    for s in servers:
        c = S3TestClient("127.0.0.1", s.port)
        assert c.request("PUT", f"/{bucket}")[0] == 200
        assert c.request("PUT", f"/{bucket}/k", body=BODY["one"])[0] == 200
    answers = []
    for s, adm_cls in zip(servers, (RefAdmin, AdminClient)):
        adm = adm_cls("127.0.0.1", s.port, CREDS.access_key,
                      CREDS.secret_key)
        got = adm.spans(count=3, api="PutObject")
        assert len(got["spans"]) == 3
        assert all(t["name"] == "PutObject" for t in got["spans"])
        tid = got["spans"][0]["trace_id"]
        one = adm.spans(trace_id=tid)["spans"]
        slow = adm.spans(count=2, sort="slowest")["spans"]
        assert slow[0]["duration_ms"] >= slow[1]["duration_ms"]
        answers.append((sorted(got), got["sample"],
                        got["slow_threshold_ms"],
                        [t["attrs"] for t in one], len(slow)))
    assert answers[0] == answers[1]
    assert answers[1][3] == [{"method": "PUT", "path": f"/{bucket}/k"}]


class _Receiver:
    """A loopback audit webhook collecting the POSTed records."""

    def __init__(self):
        got = self.got = []

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                got.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/audit"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _wait_audit(rx: _Receiver, bucket: str, n: int) -> None:
    deadline = time.monotonic() + 10
    while sum(e["path"].startswith(f"/{bucket}") for e in rx.got) < n \
            and time.monotonic() < deadline:
        time.sleep(0.02)


def test_twin_audit_webhook_through_config_kv(twins):
    servers, edge = twins
    bucket = f"aud{edge}"
    got = []
    # the reference's audit worker never exits: its server ships inline
    # here, so that the test leaves no thread behind
    ref_trace = servers[0].api.trace
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_trace, "_enqueue_audit", ref_trace._ship_audit)
    for s, adm_cls in zip(servers, (RefAdmin, AdminClient)):
        rx = _Receiver()
        adm = adm_cls("127.0.0.1", s.port, CREDS.access_key,
                      CREDS.secret_key)
        try:
            adm.set_config("audit_webhook", enable="on", endpoint=rx.url)
            assert s.api.trace.audit_webhook == rx.url
            c = S3TestClient("127.0.0.1", s.port)
            # a record ships a hair after its response, and the receiver
            # serves each POST on a thread of its own: the next request
            # goes only once the last one's record is in, so that a loaded
            # worker cannot reorder the two
            assert c.request("PUT", f"/{bucket}")[0] == 200
            _wait_audit(rx, bucket, 1)
            assert c.request("PUT", f"/{bucket}/k",
                             body=BODY["one"])[0] == 200
            _wait_audit(rx, bucket, 2)
            adm.set_config("audit_webhook", enable="off")
            assert s.api.trace.audit_webhook == ""
            mine = [{k: v for k, v in e.items() if k not in _MASKED}
                    for e in rx.got if e["path"].startswith(f"/{bucket}")]
            got.append(mine)
            assert s.api.trace.audit_dropped == 0
        finally:
            rx.close()
    mp.undo()
    assert got[0] == got[1]
    assert [e["api"] for e in got[1]] == ["MakeBucket", "PutObject"]
    deadline = time.monotonic() + 10
    while servers[1].api.trace._audit_worker is not None and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert servers[1].api.trace._audit_worker is None, \
        "the port's idle audit worker did not exit"


def _admins(servers):
    return [cls("127.0.0.1", s.port, CREDS.access_key, CREDS.secret_key)
            for s, cls in zip(servers, (RefAdmin, AdminClient))]


def test_twin_trace_stream_and_cluster_ring(twins):
    servers, edge = twins
    bucket = f"stm{edge}"
    answers = []
    for s, adm in zip(servers, _admins(servers)):
        got: list = []
        t = threading.Thread(target=lambda: got.extend(
            adm.trace(count=1, idle=10, api="MakeBucket")), daemon=True)
        t.start()
        time.sleep(0.5)
        c = S3TestClient("127.0.0.1", s.port)
        c.request("HEAD", f"/{bucket}")
        assert c.request("PUT", f"/{bucket}")[0] == 200
        t.join(15)
        assert not t.is_alive() and len(got) == 1
        ring = [e for e in adm.cluster_trace()
                if e["path"] == f"/{bucket}"]
        answers.append(([{k: v for k, v in e.items() if k not in _MASKED}
                         for e in got],
                        [{k: v for k, v in e.items() if k not in _MASKED}
                         for e in ring]))
    assert answers[0] == answers[1]
    assert [e["api"] for e in answers[1][1]] == ["HeadBucket", "MakeBucket"]


def test_twin_events_incidents_slo_console(twins, tmp_path, monkeypatch):
    """The journal, recorder, SLO and console routes of a server without
    a cluster node: the same records emitted in each package read back
    alike (times, sequence numbers, ids and nodes masked)."""
    servers, _edge = twins
    fake = types.SimpleNamespace(time=lambda: 1.9e9,
                                 monotonic=time.monotonic)
    for mod in (ref_incidents, port_incidents):
        monkeypatch.setattr(mod, "time", fake)
    answers = []
    for (s, adm, ev, inc, sl, con) in zip(
            servers, _admins(servers), (ref_eventlog, port_eventlog),
            (ref_incidents, port_incidents), (ref_slo, port_slo),
            (ref_console, port_console)):
        rec = inc.IncidentRecorder()
        rec.attach(str(tmp_path / ev.__name__.split(".")[0]))
        monkeypatch.setattr(inc, "RECORDER", rec)
        monkeypatch.setattr(sl, "ENGINE", sl.SLOEngine())
        try:
            # not a trigger class: the recorder's own loop stays out
            trig = ev.emit("net.heal", peers="a|b")
            inc_id = rec.capture(trig)
            events = adm.events(count=1, classes="net.heal")
            summaries = [i for i in adm.incidents() if i["id"] == inc_id]
            bundle = adm.incident(inc_id)
        finally:
            rec.stop()
        con.get_console().log_line("INFO", "twin console line")
        lines = adm.console_log(count=1)
        answers.append((
            [{k: v for k, v in e.items() if k not in ("ts", "seq", "node")}
             for e in events],
            # the window holds what each package's process emitted before
            [{k: v for k, v in i.items() if k not in ("node", "events")}
             for i in summaries],
            sorted(bundle), bundle["trigger"]["class"], bundle["id"],
            sorted(bundle["state"]),
            adm.slo(),
            [{k: v for k, v in e.items() if k not in ("time", "ts", "node")}
             for e in lines]))
    assert answers[0] == answers[1]
    assert answers[1][1][0]["trigger"] == "net.heal"


def test_twin_profiling_routes(twins):
    """profiling/start then profiling/stop, one package after the other
    (the process has one cProfile and one tracemalloc): the same answers
    and the same profile files, each non-empty."""
    servers, _edge = twins
    answers = []
    for s, adm, tel in zip(servers, _admins(servers), TELS):
        started = adm.profiling_start("cpu,mem")
        assert 'minio_tpu_profiler_running{kind="mem"} 1' in \
            tel.REGISTRY.render()
        S3TestClient("127.0.0.1", s.port).request("GET", "/")
        profiles = adm.profiling_stop("cpu,mem")
        assert all(profiles.values())
        answers.append((started, sorted(profiles)))
        text = tel.REGISTRY.render()
        assert 'minio_tpu_profiler_running{kind="cpu"} 0' in text
        assert 'minio_tpu_profiler_running{kind="mem"} 0' in text
    assert answers[0] == answers[1]
    assert answers[1][0] == {"kinds": {"cpu": "started", "mem": "started"}}


@pytest.mark.parametrize("family", [
    "minio_tpu_audit_dropped_total", "minio_tpu_profiler_running",
    "minio_tpu_slo_burn_rate", "minio_tpu_slo_error_budget_ratio"])
def test_plane_families_exported_alike(family):
    """The four families this plane adds: one type and one label-name
    set in both packages' expositions, each with a series of its own.
    The family's series left by earlier tests in the process (a booted
    node's SLO loop sets them in one package's registry at its own pace)
    are cleared first; one SLO engine per package then evaluates twice, a
    window apart, so that a baseline exists and the burn-rate series are
    set in both."""
    import minio_tpu.s3.trace  # noqa: F401 — registers the audit family
    import minio_tpu.utils.profiling  # noqa: F401
    import minio_tpu_torch.s3.trace  # noqa: F401
    import minio_tpu_torch.utils.profiling  # noqa: F401
    seen = []
    for tel, sl in zip(TELS, (ref_slo, port_slo)):
        if family in tel.REGISTRY._families:
            tel.REGISTRY._families[family].clear()
        engine = sl.SLOEngine()
        engine.evaluate_once(now=0.0)
        engine.evaluate_once(now=1e9)
        tel.REGISTRY.counter("minio_tpu_audit_dropped_total").inc(0)
        text = tel.REGISTRY.render()
        fam = tel.REGISTRY._families[family]
        labels = set()
        series = 0
        for line in text.splitlines():
            if line.startswith(family + "{"):
                inner = line[len(family) + 1:line.index("}")]
                labels.add(tuple(sorted(p.split("=", 1)[0]
                                        for p in inner.split(","))))
                series += 1
            elif line.startswith(family + " "):
                labels.add(())
                series += 1
        assert series, f"{family}: no series in {tel.__name__}"
        seen.append((fam.kind, labels))
    assert seen[0] == seen[1]
