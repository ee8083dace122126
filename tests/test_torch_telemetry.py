"""The port's span tracer (minio_tpu_torch/utils/telemetry.py, the span
half) and request tracing (s3/trace.py) held against minio_tpu's.

  * tests/test_telemetry.py's cases rebound to the port (each case's code
    runs with the names it imports from minio_tpu bound to their
    minio_tpu_torch counterparts): the registry, span trees and tail
    sampling, the per-trace span budget, the no-op without a trace,
    ``traced_iter`` never current across a yield, a trace id joined across
    a storage RPC, TraceSys's idle stream and locked ring, the profiler
    kinds and the API-name classifier; audit overflow on the port's
    TraceSys, whose idle worker exits; and the live-server
    cases over the port's erasure set (exposition lint, PUT and GET span
    trees, the staging shed);
  * the same span program run in both packages gives the same tree
    (names, attributes, nesting, fragments grafted by span id, budget
    drops), with ids and times masked;
  * tail sampling with the sampler's draws pinned keeps and drops the same
    roots in both packages;
  * a joined fragment is grafted under the span that made the call, and an
    unmatched one under the root, in both packages alike;
  * the port's edge dispatch takes ``api_name_of`` from s3/trace.py.
Four drives at 2+2, 64 KiB blocks, device="cpu".
"""

from __future__ import annotations

import random
import threading
import time

import pytest
import torch

import minio_tpu.utils.telemetry as ref_tel
import minio_tpu_torch.utils.telemetry as port_tel
import tests.test_telemetry as ref_cases
from minio_tpu_torch import device as device_mod
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.admin import mount_admin
from minio_tpu_torch.s3.server import S3Server
from tests.test_torch_iam import rebound

PACKAGES = (ref_tel, port_tel)


@pytest.fixture
def cpu_default(monkeypatch):
    monkeypatch.setattr(device_mod, "resolve",
                        lambda d=None: torch.device("cpu" if d is None
                                                    else d))


@pytest.mark.parametrize("name", [
    "test_registry_families_and_render",
    "test_span_tree_and_tail_sampling",
    "test_span_noop_without_active_trace",
    "test_traced_iter_never_leaks_into_consumer",
    "test_tracesys_stream_idle_timeout",
    "test_recent_ring_mutation_is_locked",
    "test_profiling_kind_table_and_gauges",
    "test_api_name_classifier"])
def test_reference_cases(name):
    rebound(getattr(ref_cases, name))()


def test_reference_span_budget_case(monkeypatch):
    rebound(ref_cases.test_span_budget_caps_trace_size)(monkeypatch)


def test_audit_overflow_drops_and_counts(monkeypatch):
    """tests/test_telemetry.py's overflow case on the port's TraceSys: a
    full queue drops and counts, exactly the rest ship on one worker, and
    that worker exits once idle (the port's departure). Its threads are
    told apart by identity: other tests of the process may leave the
    reference's audit workers, which never exit, alive."""
    from minio_tpu_torch.s3 import trace as port_trace
    ts = port_trace.TraceSys(audit_queue_size=2)
    ts.audit_webhook = "http://127.0.0.1:9/never"
    gate = threading.Event()
    shipped, workers = [], set()

    def slow_ship(entry):
        workers.add(threading.current_thread())
        gate.wait(5.0)
        shipped.append(entry)

    monkeypatch.setattr(ts, "_ship_audit", slow_ship)
    monkeypatch.setattr(port_trace, "AUDIT_IDLE_S", 0.2)
    dropped = port_tel.REGISTRY.counter("minio_tpu_audit_dropped_total")
    before = dropped.value()
    for i in range(8):
        ts.record("GET", f"/p{i}", "", 200, 0.001)
    assert ts.requests_total == 8
    assert ts.audit_dropped >= 5
    assert dropped.value() - before == ts.audit_dropped
    gate.set()
    deadline = time.time() + 5
    while len(shipped) < 8 - ts.audit_dropped and time.time() < deadline:
        time.sleep(0.02)
    assert len(shipped) == 8 - ts.audit_dropped
    assert len(workers) == 1
    worker = workers.pop()
    worker.join(5)
    assert not worker.is_alive() and ts._audit_worker is None
    ts.record("GET", "/again", "", 200, 0.001)
    deadline = time.time() + 5
    while len(shipped) < 9 - ts.audit_dropped and time.time() < deadline:
        time.sleep(0.02)
    assert shipped[-1]["path"] == "/again"


def test_trace_id_propagates_across_storage_rpc(tmp_path):
    """tests/test_telemetry.py's case on the port's RemoteStorage and
    StorageRPCServer: the client's rpc span carries the trace headers,
    the serving side records a joined fragment, and the dump grafts it
    under the span that made the call."""
    from minio_tpu_torch.distributed.storage_rpc import (RemoteStorage,
                                                         StorageRPCServer)
    from minio_tpu_torch.distributed.transport import RPCServer
    from minio_tpu_torch.storage.format import new_format_erasure_v3
    from minio_tpu_torch.storage.xl_storage import XLStorage

    fmts = new_format_erasure_v3(1, 1)
    d = XLStorage(str(tmp_path / "rd0"))
    d.write_format(fmts[0][0])
    host = RPCServer().start()
    host.mount(StorageRPCServer({"/rd0": d}, "tracekey",
                                "tracesecret12345").handler)
    remote = RemoteStorage("127.0.0.1", host.port, "/rd0", "tracekey",
                           "tracesecret12345")
    was = (port_tel.SPANS.slow_s, port_tel.SPANS.sample)
    port_tel.SPANS.configure(sample=1.0)
    try:
        with port_tel.trace("rpc-prop-test") as root:
            remote.make_vol("tv")
            remote.write_all("tv", "x", b"payload")
            assert remote.read_all("tv", "x") == b"payload"
            tid = root.trace_id
        trees = [t for t in port_tel.SPANS.dump(20) if t["trace_id"] == tid]
        assert trees, "trace not kept"
        client_spans = ref_cases._find_spans(trees[0], "rpc.readall")
        server_spans = ref_cases._find_spans(trees[0], "rpc.server.readall")
        assert client_spans and server_spans
        assert server_spans[0]["remote"] is True
        assert server_spans[0]["trace_id"] == tid
        assert any(s["span_id"] == server_spans[0].get("parent_id")
                   for s in client_spans)
    finally:
        port_tel.SPANS.configure(*was)
        remote.close()
        host.stop()
        d.close()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """tests/test_telemetry.py's server fixture on the port's sets."""
    root = tmp_path_factory.mktemp("telemdrives")
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(4)],
                                   set_count=1, set_drive_count=4,
                                   parity=2, block_size=1 << 16,
                                   device="cpu")
    srv = S3Server(sets, creds=ref_cases.CREDS,
                   region=ref_cases.REGION).start()
    mount_admin(srv)
    was = (port_tel.SPANS.slow_s, port_tel.SPANS.sample)
    port_tel.SPANS.configure(sample=1.0)
    yield srv
    port_tel.SPANS.configure(*was)
    srv.stop()
    sets.close()


@pytest.fixture(scope="module")
def client(server):
    """tests/test_telemetry.py's client fixture: a bucket and a 2 MiB
    object put and read back."""
    c = ref_cases.Client(server.port)
    assert c.request("PUT", "/telb")[0] == 200
    payload = b"t" * (2 << 20)
    assert c.request("PUT", "/telb/obj", body=payload)[0] == 200
    st, got = c.request("GET", "/telb/obj")
    assert st == 200 and got == payload
    return c


@pytest.mark.parametrize("name", [
    "test_metrics_exposition_lint", "test_put_and_get_span_trees",
    "test_slowdown_on_staging_pressure"])
def test_reference_server_cases(server, client, name):
    rebound(getattr(ref_cases, name))(server, client)


# -- the same span program in both packages ----------------------------------

def _program(tel, budget_kids: int = 3):
    """One trace: nested spans, a traced stream, an externally timed span
    with a child, a joined fragment of a remote call and an unmatched one,
    and a span past the budget. Returns the root."""
    with tel.trace("Prog", path="/p") as root:
        with tel.span("a", k=1):
            with tel.span("a.1", blocks=2):
                pass
            with tel.span("a.2") as a2:
                caller = a2
        list(tel.traced_iter("stream", iter([b"x", b"y"]), length=2))
        d = tel.attach_span(root, "ext", root.start, 0.5, verb="encode")
        tel.attach_span(d, "ext.child", root.start, 0.25)
        for i in range(budget_kids):
            with tel.span(f"b{i}"):
                pass
    with tel.join("rpc.server.x", root.trace_id, caller.span_id):
        pass
    with tel.join("rpc.server.lost", root.trace_id, "nosuchspan"):
        pass
    return root


def _shape(node: dict) -> dict:
    return {"name": node["name"], "attrs": node.get("attrs", {}),
            "remote": node.get("remote", False),
            "error": node.get("error", ""),
            "spans_dropped": node.get("spans_dropped", 0),
            "children": [_shape(c) for c in node.get("children", ())]}


@pytest.mark.parametrize("budget", [512, 8])
def test_span_program_trees_equal(monkeypatch, budget):
    trees = []
    for tel in PACKAGES:
        monkeypatch.setattr(tel, "MAX_SPANS", budget)
        sink = tel.SpanSink(capacity=4, slow_s=0.0, sample=0.0)
        monkeypatch.setattr(tel, "SPANS", sink)
        root = _program(tel)
        dumped = sink.dump(1)
        assert len(dumped) == 1 and dumped[0]["trace_id"] == root.trace_id
        trees.append(_shape(dumped[0]))
    assert trees[0] == trees[1]
    if budget == 8:
        assert trees[1]["spans_dropped"] > 0


def test_tail_sampling_keeps_alike(monkeypatch):
    """Ordinary traces kept with probability `sample`, errors and slow
    traces always: with the sampler's draws pinned, both packages keep
    the same roots."""
    kept = []
    for tel in PACKAGES:
        draws = random.Random(5)
        monkeypatch.setattr(tel.random, "random", draws.random)
        sink = tel.SpanSink(capacity=64, slow_s=3600.0, sample=0.3)
        for i in range(40):
            root = tel.Span(f"r{i}", f"t{i}")
            if i % 7 == 0:
                child = tel.Span("c", root.trace_id, root=root)
                child.mark_error("boom")
                root.add_child(child)
            root.finish()
            sink.offer(root)
        kept.append(([t["name"] for t in sink.dump(64)],
                     sink.kept_total, sink.dropped_total))
    assert kept[0] == kept[1]
    assert 0 < kept[1][1] < 40


def test_fragment_cap_and_eviction_alike():
    """One trace holds at most 64 fragments, and the sink remembers
    4 x capacity traces' fragments, oldest evicted first."""
    out = []
    for tel in PACKAGES:
        sink = tel.SpanSink(capacity=2)
        for t in range(10):
            for i in range(70):
                sink.record_fragment(tel.Span("f", f"t{t}", parent_id=""))
        out.append(sorted((k, len(v)) for k, v in sink._fragments.items()))
    assert out[0] == out[1] == [(f"t{t}", 64) for t in range(2, 10)]


def test_dispatch_uses_the_trace_modules_classifier():
    from minio_tpu_torch.s3 import trace as port_trace
    from minio_tpu_torch.s3.edge import dispatch
    assert dispatch.api_name_of is port_trace.api_name_of


def test_root_span_covers_request_on_both_transports(cpu_default,
                                                     tmp_path,
                                                     monkeypatch):
    """The middleware's root span is named by the API, carries method and
    path, and holds the engine's tree, on the threaded server and on the
    event-loop edge alike."""
    monkeypatch.setattr(port_tel.SPANS, "sample", 1.0)
    names = []
    for edge in ("off", "on"):
        monkeypatch.setenv("MINIO_TPU_EDGE", edge)
        sets = ErasureSets.from_drives(
            [str(tmp_path / edge / f"d{i}") for i in range(4)],
            set_count=1, set_drive_count=4, parity=2, block_size=1 << 16,
            device="cpu")
        srv = S3Server(sets, creds=ref_cases.CREDS,
                       region=ref_cases.REGION).start()
        try:
            c = ref_cases.Client(srv.port)
            assert c.request("PUT", f"/rtspan{edge}")[0] == 200
            assert c.request("PUT", f"/rtspan{edge}/k",
                             body=b"z" * 200_000)[0] == 200
            # the root span and the trace record close after the response
            # is flushed: wait for both to land
            deadline = time.monotonic() + 10
            while True:
                trees = [t for t in port_tel.SPANS.dump(50, name="PutObject")
                         if t["attrs"]["path"] == f"/rtspan{edge}/k"]
                rec = [e for e in srv.api.trace.recent
                       if e["path"] == f"/rtspan{edge}/k"]
                if trees and rec or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            assert trees, edge
            t = trees[0]
            assert t["attrs"]["method"] == "PUT"
            names.append(sorted(c["name"] for c in t["children"]))
            assert rec and rec[-1]["trace_id"] == t["trace_id"]
        finally:
            srv.stop()
            sets.close()
    assert names[0] == names[1] == ["engine.put_object"]
