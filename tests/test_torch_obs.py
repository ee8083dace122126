"""The port's cluster observability surfaces held against minio_tpu's
(tests/test_obs.py's cases rebound to the port, on two in-process port
nodes and a 2+2 erasure set, device="cpu"):

  * the batch former's stage split: ``minio_tpu_device_dispatch_seconds``
    carries the reference's stage values (queue, transfer, compute,
    fetch) and no codec-internal name, and every submitter's span tree
    holds ``sched.dispatch`` (verb, blocks, coalesced) with the
    ``sched.queue`` / ``sched.transfer`` / ``sched.compute`` /
    ``sched.fetch`` children, the compute child's duration the codec's
    compute span of that dispatch; a dispatch the size gate routes to the
    host gets no stage children; a coalesced dispatch lands in each
    submitter's own tree; a declined submission emits one
    ``device.decline`` record;
  * a ``trace?follow=1`` stream on node A delivers a PUT served by node B
    (both frontends) and a vanished client unwinds its peer subscriptions;
    ``events?follow=1`` alike; the events window's filters and
    ``?cluster=1`` merge; the SLO document;
  * the shed reason on trace records, the ``spans`` filters, and the
    edge's root span and trace record equal to the threaded oracle's.
"""

from __future__ import annotations

import re
import threading
import types

import numpy as np
import pytest
import torch

import tests.test_obs as ref_obs
from minio_tpu_torch import bitrot
from minio_tpu_torch import device as device_mod
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.parallel import scheduler as sched_mod
from minio_tpu_torch.parallel.scheduler import BatchScheduler
from minio_tpu_torch.utils import eventlog, telemetry
from tests.test_torch_iam import rebound

HH = bitrot.BitrotAlgorithm.HIGHWAYHASH256
STAGES = ("queue", "transfer", "compute", "fetch")


def _cpu(d=None):
    return torch.device("cpu" if d is None else d)


@pytest.fixture(scope="module", autouse=True)
def _cpu_default():
    mp = pytest.MonkeyPatch()
    mp.setattr(device_mod, "resolve", _cpu)
    yield
    mp.undo()


# -- the stage split ----------------------------------------------------------

def _stage_counts(verb: str) -> dict:
    hist = telemetry.REGISTRY.histogram("minio_tpu_device_dispatch_seconds")
    return {s: hist.count(verb=verb, stage=s) for s in STAGES}


@pytest.fixture
def recorded_steps(monkeypatch):
    """Every codec step's stage spans, in call order."""
    seen: list = []
    real = codec_mod._record_step

    def record(verb, stages):
        seen.append((verb, dict(stages)))
        real(verb, stages)

    monkeypatch.setattr(codec_mod, "_record_step", record)
    return seen


def test_dispatch_stage_labels_are_the_references(monkeypatch,
                                                  recorded_steps):
    """tests/test_obs.py:699's fused encode through the port's former:
    the exposition renders stage="queue"/"transfer"/"compute"/"fetch"
    and no codec-internal ``*_span_s`` value; the tree holds the stage
    children, the compute child equal to the codec's compute span."""
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)
    before = _stage_counts("encode")
    sched = BatchScheduler(max_wait=0.05)
    codec = codec_mod.Codec(4, 2, 4 * 4096, device="cpu")
    data = np.random.default_rng(3).integers(0, 255, (4, 4, 4096),
                                             dtype=np.uint8)
    try:
        with telemetry.trace("obs-stage-test") as root:
            out = sched.submit(codec, data, HH).result(120)
        assert out is not None, "dispatch took the host route"
    finally:
        sched.close()
    after = _stage_counts("encode")
    assert all(after[s] == before[s] + 1 for s in STAGES), (before, after)
    text = telemetry.REGISTRY.render()
    fam = "minio_tpu_device_dispatch_seconds"
    assert f"# TYPE {fam} histogram" in text
    assert re.search(
        fam + r'_bucket\{stage="compute",verb="encode",le="[^"]+"\}', text)
    assert not re.search(fam + r'_\w+\{stage="\w+_span_s"', text)
    assert "minio_tpu_sched_inflight_dispatches" in text
    d = ref_obs._find(root.to_dict(), "sched.dispatch")
    assert len(d) == 1
    assert d[0]["attrs"] == {"verb": "encode", "blocks": 4, "coalesced": 0}
    kids = {c["name"]: c for c in d[0]["children"]}
    assert list(kids) == [f"sched.{s}" for s in STAGES]
    enc = [s for v, s in recorded_steps if v == "encode"]
    assert len(enc) == 1
    span = [c for c in root.walk() if c.name == "sched.compute"][0]
    assert abs(span.duration_s - enc[0]["compute_span_s"]) < 1e-6
    # the stage children sit end to end from the dispatch's start
    assert kids["sched.transfer"]["start"] == d[0]["start"]


def test_host_routed_dispatch_gets_no_stage_children(monkeypatch):
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 1 << 40)
    sched = BatchScheduler(max_wait=0.01)
    codec = codec_mod.Codec(4, 2, 4 * 4096, device="cpu")
    data = np.zeros((2, 4, 4096), np.uint8)
    before = _stage_counts("encode")
    try:
        with telemetry.trace("obs-host") as root:
            assert sched.submit(codec, data, HH).result(60) is None
    finally:
        sched.close()
    d = ref_obs._find(root.to_dict(), "sched.dispatch")
    assert len(d) == 1 and "children" not in d[0]
    assert _stage_counts("encode") == before


def test_coalesced_dispatch_lands_in_each_submitters_tree(monkeypatch):
    """The collector and dispatch threads serve many requests: the span
    comes from each submission, never from the dispatching thread."""
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)
    sched = BatchScheduler(max_wait=0.3)
    codec = codec_mod.Codec(4, 2, 4 * 4096, device="cpu")
    data = np.ones((1, 4, 4096), np.uint8)
    roots: list = [None, None]
    start = threading.Barrier(2)

    def one(i):
        with telemetry.trace(f"req{i}") as root:
            start.wait()
            assert sched.submit(codec, data, HH).result(120) is not None
        roots[i] = root

    ts = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
    finally:
        sched.close()
    for root in roots:
        d = ref_obs._find(root.to_dict(), "sched.dispatch")
        assert len(d) == 1 and d[0]["attrs"]["blocks"] == 2
        assert d[0]["attrs"]["coalesced"] == 1
        assert d[0]["trace_id"] == root.trace_id
        assert [c["name"] for c in d[0]["children"]] == \
            [f"sched.{s}" for s in STAGES]


def test_declined_submission_emits_device_decline(monkeypatch):
    seen = []
    monkeypatch.setattr(sched_mod.eventlog, "emit_once",
                        lambda cls, **a: seen.append((cls, a)))
    sched = BatchScheduler(max_wait=0.01)
    try:
        # a parity-less geometry (no Codec is built without parity)
        bare = types.SimpleNamespace(m=0, fused_route=lambda algo: False)
        assert sched.submit(bare, np.zeros((1, 4, 4096), np.uint8),
                            HH).result() is None
        codec = codec_mod.Codec(4, 2, 4 * 4096, device="cpu")
        assert sched.submit(codec, np.zeros((1, 4, 4096), np.uint8),
                            bitrot.BitrotAlgorithm.BLAKE2B512
                            ).result() is None
    finally:
        sched.close()
    assert seen == [
        ("device.decline", {"stage": "scheduler", "reason": "no-parity"}),
        ("device.decline", {"stage": "scheduler", "reason": "algo"})]
    assert "device.decline" in eventlog.EVENTS


# -- two port nodes: follow streams, events, SLO ------------------------------

@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    nodes = rebound(ref_obs._boot_cluster)(
        tmp_path_factory.mktemp("obscluster"))
    yield nodes
    for n in nodes:
        n.shutdown()


@pytest.mark.parametrize("name", [
    "test_follow_delivers_peer_records_and_unwinds",
    "test_follow_disconnect_frees_workers",
    "test_events_follow_delivers_and_unwinds",
    "test_events_follow_disconnect_frees_workers",
    "test_events_endpoint_filters_and_cluster_merge",
    "test_slo_endpoint_reports_objectives"])
def test_reference_cluster_cases(cluster, name):
    rebound(getattr(ref_obs, name))(cluster)


def test_reference_threaded_follow_case(tmp_path_factory):
    rebound(ref_obs.test_follow_threaded_frontend)(tmp_path_factory)


def test_cluster_trace_merges_peer_rings(cluster):
    """trace/cluster holds node B's records when asked on node A, each
    record naming the node that served it."""
    a, b = cluster
    assert ref_obs._signed_request(b.spec.port, "PUT", "/obsring")[0] == 200
    entries = ref_obs._mc(a).cluster_trace()
    mine = [e for e in entries if e["path"] == "/obsring"]
    assert mine and mine[-1]["node"] == b.spec.addr
    assert mine[-1]["api"] == "MakeBucket" and mine[-1]["status"] == 200


# -- one server: shed reason, spans filters, edge parity ----------------------

@pytest.fixture(scope="module")
def layer(tmp_path_factory):
    from minio_tpu_torch.object.sets import ErasureSets
    root = tmp_path_factory.mktemp("obsdrives")
    sets = ErasureSets.from_drives(
        [str(root / f"d{i}") for i in range(4)], 1, 4, 2,
        block_size=1 << 16, device="cpu")
    yield sets
    sets.close()


@pytest.mark.parametrize("name", [
    "test_shed_reason_rides_trace_records", "test_spans_endpoint_filters",
    "test_edge_trace_parity_with_threaded_oracle"])
def test_reference_server_cases(layer, name):
    rebound(getattr(ref_obs, name))(layer)


def test_reference_filtered_stream_case():
    rebound(ref_obs.test_filtered_nonfollow_stream_idles_out_on_matches)()
