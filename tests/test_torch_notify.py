"""The port's bucket notification plane (minio_tpu_torch/notify/ and the
replication target registry in minio_tpu_torch/replicate/targets.py)
held against minio_tpu's.

  * every case of tests/test_notify.py rebound to the port
    (tests/test_torch_iam.rebound), its sets on device="cpu": the record
    shapes of PUT, multipart commit, delete marker, purge, transition and
    restore, origin site and replica suppression, the rules, the
    registry's persistence, rollback and validation, the NaughtyTarget
    chaos cases, the durable backlog across a restart, owner routing and
    the plane's filters;
  * twin planes: twin sets (the reference's and the port's, identities
    pinned in both, tests/test_torch_s3.pin) with one queue target each
    take one sequence (PUT, multipart complete, delete marker, purge,
    transition and restore), draining after each mutation; the records
    the two QueueSender sinks hold are equal, with only the fields that
    differ between twin runs normalised: ``x-amz-request-id`` (random),
    ``eventTime`` and ``sequencer`` (the clock); origin node and site
    are pinned in both;
  * cross-package files: a target registry written by either package
    loads in the other (epoch, lineage, targets, secrets), and so does a
    replication target registry with its site id; the durable per-target
    queue a killed plane of either package leaves is replayed by the
    other's plane to the same records;
  * a booted node (cluster.start_single): a PUT, a crawler transition, a
    restore over HTTP and a crawler expiry reach both a legacy notifier
    target and a plane target, and the site id the first boot persisted
    is the next boot's.
Four drives at 2+2, 64 KiB blocks, device="cpu".
"""

from __future__ import annotations

import copy
import inspect
import io
import os
import time
import types

import pytest

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.features.events as ref_events
import minio_tpu.notify as ref_notify
import minio_tpu.notify.targets as ref_ntargets
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.replicate.targets as ref_rtargets
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu.tier.config as ref_tier
import minio_tpu.tier.transition as ref_transition
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.features.events as port_events
import minio_tpu_torch.notify as port_notify
import minio_tpu_torch.notify.targets as port_ntargets
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.replicate.targets as port_rtargets
import minio_tpu_torch.s3.handlers as port_handlers
import minio_tpu_torch.tier.config as port_tier
import minio_tpu_torch.tier.transition as port_transition
import tests.test_notify as ref_cases
from minio_tpu.object.engine import PutOptions as RefPutOptions
from minio_tpu.object.multipart import CompletePart as RefPart
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.utils.streams import IterStream as RefIterStream
from minio_tpu_torch.object.engine import PutOptions
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.utils.streams import IterStream
from tests.test_torch_iam import rebound
from tests.test_torch_s3 import pin

N, M, BS = 4, 2, 1 << 16
ARN = "arn:minio:sqs::twin:queue"
NODE, SITE = "n1:9000", "site-twin"

REF = types.SimpleNamespace(
    tag="ref", sets=RefSets, server_sets=RefServerSets, notify=ref_notify,
    ntargets=ref_ntargets, rtargets=ref_rtargets, tier=ref_tier,
    transition=ref_transition, put=RefPutOptions, part=RefPart,
    stream=RefIterStream, events=ref_events, kw={},
    pin=(ref_engine, ref_multipart, ref_bmeta, ref_handlers, ref_crypto))
PORT = types.SimpleNamespace(
    tag="port", sets=ErasureSets, server_sets=ErasureServerSets,
    notify=port_notify, ntargets=port_ntargets, rtargets=port_rtargets,
    tier=port_tier, transition=port_transition, put=PutOptions,
    part=CompletePart, stream=IterStream, events=port_events,
    kw={"device": "cpu"},
    pin=(port_engine, port_multipart, port_bmeta, port_handlers,
         port_crypto))


# -- tests/test_notify.py, rebound ----------------------------------------------

class _CpuSets:
    """The port's ErasureSets as tests/test_notify.py calls it, on the
    CPU."""

    @staticmethod
    def from_drives(*args, **kw):
        return ErasureSets.from_drives(*args, device="cpu", **kw)


_CASES = sorted(name for name, fn in vars(ref_cases).items()
                if name.startswith("test_") and inspect.isfunction(fn))


def test_every_reference_case_is_rebound():
    assert len(_CASES) == 17, _CASES


@pytest.mark.parametrize("name", _CASES)
def test_reference_notify_cases(tmp_path, name):
    fn = rebound(getattr(ref_cases, name), ErasureSets=_CpuSets)
    given = {"tmp_path": tmp_path}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


# -- twin planes ------------------------------------------------------------------

def _layer(pkg, root):
    sets = pkg.sets.from_drives([str(root / f"d{i}") for i in range(N)],
                                set_count=1, set_drive_count=N, parity=M,
                                block_size=BS, **pkg.kw)
    layer = pkg.server_sets([sets], load_topology=False)
    layer.make_bucket("b")
    return layer


def _plane(pkg, layer, queue_dir=None, sender=None):
    reg = pkg.notify.NotifyTargetRegistry(layer)
    reg.add(pkg.notify.NotifyTarget(arn=ARN, type="queue"))
    sink = sender or pkg.ntargets.QueueSender(ARN)
    reg.set_sender(ARN, sink)
    plane = pkg.notify.NotificationPlane(
        layer, reg, queue_dir=queue_dir, node=NODE, site_id=SITE,
        busy_fn=lambda: False)
    plane.set_config("b", ref_cases._xml(ARN))
    layer.attach_notifications(plane)
    return plane, reg, sink


def _drained(plane, sink, n):
    assert plane.drain(30), plane.stats()
    assert sink.wait_for(n, 30), (len(sink.records), plane.stats())


def _sequence(pkg, root) -> list:
    """PUT, multipart complete, delete marker, purge, transition and
    restore through one package's layer and plane; the sink's records,
    drained after each mutation."""
    layer = _layer(pkg, root / "site")
    tiers = pkg.tier.TierManager(layer)
    tiers.add(pkg.tier.TierConfig("cold", "fs",
                                  {"path": str(root / "tier")}))
    plane, _reg, sink = _plane(pkg, layer)
    n = 0

    def step():
        nonlocal n
        n += 1
        _drained(plane, sink, n)

    try:
        layer.put_object("b", "dir/a b.txt", b"x" * 700,
                         opts=pkg.put(versioned=True))
        step()
        p1, p2 = b"p" * (5 << 20), b"q" * 4096
        up = layer.new_multipart_upload("b", "mp", pkg.put())
        e1 = layer.put_object_part("b", "mp", up, 1, io.BytesIO(p1),
                                   len(p1)).etag
        e2 = layer.put_object_part("b", "mp", up, 2, io.BytesIO(p2),
                                   len(p2)).etag
        layer.complete_multipart_upload(
            "b", "mp", up, [pkg.part(1, e1), pkg.part(2, e2)])
        step()
        layer.delete_object("b", "dir/a b.txt", versioned=True)
        step()
        layer.put_object("b", "gone", b"g" * 33)
        step()
        layer.delete_object("b", "gone")
        step()
        layer.put_object("b", "arch", b"z" * 9000,
                         opts=pkg.put(versioned=True))
        step()
        oi = layer.get_object_info("b", "arch")
        _, stream = layer.get_object("b", "arch")
        rd = pkg.stream(stream)
        rk = tiers.remote_key("b", "arch", oi.version_id)
        try:
            tiers.client("cold").put(rk, rd, oi.size)
        finally:
            rd.close()
        layer.transition_object("b", "arch", version_id=oi.version_id,
                                tier="cold", remote_object=rk,
                                expect_etag=oi.etag)
        step()
        pkg.transition.restore_object(layer, tiers, "b", "arch",
                                      version_id=oi.version_id)
        step()
        time.sleep(0.2)               # nothing late may follow
        assert len(sink.records) == n, plane.stats()
        return copy.deepcopy(sink.records)
    finally:
        plane.close()
        layer.close()


def _norm(records: list) -> list:
    """Only the fields that differ between twin runs, masked."""
    out = copy.deepcopy(records)
    for doc in out:
        for rec in doc["Records"]:
            rec["eventTime"] = "*"
            rec["responseElements"]["x-amz-request-id"] = "*"
            rec["s3"]["object"]["sequencer"] = "*"
    return out


def test_twin_planes_send_equal_records(tmp_path, monkeypatch):
    pin(monkeypatch, *REF.pin)
    pin(monkeypatch, *PORT.pin)
    got = {}
    for pkg in (REF, PORT):
        (tmp_path / pkg.tag).mkdir()
        got[pkg.tag] = _sequence(pkg, tmp_path / pkg.tag)
    names = [d["Records"][0]["eventName"] for d in got["port"]]
    assert names == [
        "s3:ObjectCreated:Put", "s3:ObjectCreated:CompleteMultipartUpload",
        "s3:ObjectRemoved:DeleteMarkerCreated", "s3:ObjectCreated:Put",
        "s3:ObjectRemoved:Delete", "s3:ObjectCreated:Put",
        "s3:ObjectTransition:Complete", "s3:ObjectRestore:Completed"]
    assert got["port"][0]["Records"][0]["s3"]["object"]["key"] == \
        "dir/a%20b.txt"
    assert _norm(got["port"]) == _norm(got["ref"])


# -- cross-package files ------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_target_registry_loads_in_the_other_package(tmp_path, writer):
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    root = tmp_path / "site"
    layer = _layer(w, root)
    reg = w.notify.NotifyTargetRegistry(layer)
    a1 = w.ntargets.new_arn("hook", "webhook")
    reg.add(w.notify.NotifyTarget(arn=a1, type="webhook", params={
        "endpoint": "http://127.0.0.1:1/h", "auth_token": "s3cret"}))
    reg.add(w.notify.NotifyTarget(arn=ARN, type="queue"))
    reg.remove(ARN)
    reg.add(w.notify.NotifyTarget(arn=ARN, type="log",
                                  params={"path": str(tmp_path / "ev")}))
    repl = w.rtargets.TargetRegistry(layer)
    repl.save()
    layer.close()

    sets = r.sets.from_drives([str(root / f"d{i}") for i in range(N)],
                              set_count=1, set_drive_count=N, parity=M,
                              block_size=BS, **r.kw)
    other = r.server_sets([sets], load_topology=False)
    try:
        reg2 = r.notify.NotifyTargetRegistry(other)
        assert reg2.load()
        assert reg2.epoch == reg.epoch
        assert reg2.lineage == reg.lineage
        assert reg2.arns() == reg.arns() == {a1, ARN}
        assert reg2.list(redact=False) == reg.list(redact=False)
        assert reg2.list(redact=True) == reg.list(redact=True)
        assert reg2.get(a1).params["auth_token"] == "s3cret"
        repl2 = r.rtargets.TargetRegistry(other)
        assert repl2.load()
        assert repl2.site_id == repl.site_id and repl2.site_id
        assert repl2.epoch == repl.epoch
    finally:
        other.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_durable_queue_replays_in_the_other_package(tmp_path, monkeypatch,
                                                    writer):
    """One package's plane, its target down, leaves five records in its
    durable queue and is closed (the kill); the other package's plane
    over the same drives and queue directory delivers all five, equal
    to the entries the first left."""
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    pin(monkeypatch, *REF.pin)
    pin(monkeypatch, *PORT.pin)
    root = tmp_path / "site"
    qdir = str(tmp_path / "queue")
    layer = _layer(w, root)

    class Dead:
        def send(self, record):
            raise ConnectionError("down")

    plane, _reg, _ = _plane(w, layer, queue_dir=qdir, sender=Dead())
    for i in range(5):
        layer.put_object("b", f"crash/{i}", bytes([i]) * (100 + i))
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and plane.stats()["backlog"] < 5:
        time.sleep(0.02)
    assert plane.stats()["backlog"] == 5, plane.stats()
    plane.close()
    layer.close()
    # what the killed plane left: its durable entries, read back with
    # the writer's own store
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in ARN)
    left = w.events.QueueStore(os.path.join(qdir, safe))
    first = {}
    for ekey in left.keys():
        doc = left.get(ekey)["record"]
        first[doc["Records"][0]["s3"]["object"]["key"]] = doc
    assert sorted(first) == [f"crash/{i}" for i in range(5)]

    sets = r.sets.from_drives([str(root / f"d{i}") for i in range(N)],
                              set_count=1, set_drive_count=N, parity=M,
                              block_size=BS, **r.kw)
    other = r.server_sets([sets], load_topology=False)
    sink = r.ntargets.QueueSender(ARN)
    reg = r.notify.NotifyTargetRegistry(other)
    assert reg.load()
    reg.set_sender(ARN, sink)
    plane2 = r.notify.NotificationPlane(other, reg, queue_dir=qdir,
                                        node=NODE, site_id=SITE,
                                        busy_fn=lambda: False)
    try:
        _drained(plane2, sink, 5)
        assert plane2.stats()["backlog"] == 0
        got = {d["Records"][0]["s3"]["object"]["key"]: d
               for d in sink.records}
        assert got == first
    finally:
        plane2.close()
        other.close()


# -- a booted node --------------------------------------------------------------------

def test_booted_node_sends_put_transition_restore_and_lifecycle(tmp_path):
    """A node booted by cluster.start_single wires both event paths: the
    legacy notifier (the handlers' events, the crawler's expiry) and the
    notification plane (the namespace feed). A PUT, a transition by the
    crawler, a restore over HTTP and an expiry by the crawler reach a
    target of each; the site id the first boot persisted is the one the
    next boot loads."""
    from minio_tpu_torch import cluster
    from minio_tpu_torch.features.events import MemoryTarget
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.tier.config import TierConfig
    creds = Credentials("notifytestkey1", "notifytestsecret1")
    drives = [str(tmp_path / "d{1...4}")]
    node = cluster.start_single(drives, creds=creds, parity=2,
                                block_size=BS, device="cpu")
    try:
        site = node.repl_targets.site_id
        assert site and node.notify_plane.site_id == site
        assert node.s3.api.events is node.events
        assert node.s3.api.notify is node.notify_plane
        node.tiers.add(TierConfig("cold", "fs",
                                  {"path": str(tmp_path / "tier")}))
        legacy = MemoryTarget("arn:minio:sqs::legacy:webhook")
        node.events.register_target(legacy)
        node.notify_targets.add(port_notify.NotifyTarget(arn=ARN,
                                                         type="queue"))
        sink = port_ntargets.QueueSender(ARN)
        node.notify_targets.set_sender(ARN, sink)
        plane = node.notify_plane
        c = S3Client(node.s3.port, creds)
        assert c.send("PUT", "/nodeev")[0] == 200
        doc = "<NotificationConfiguration>" + "".join(
            f"<QueueConfiguration><Queue>{a}</Queue>"
            + "".join(f"<Event>{e}</Event>" for e in ref_cases.ALL_EVENTS)
            + "</QueueConfiguration>" for a in (legacy.arn, ARN)) + \
            "</NotificationConfiguration>"
        assert c.send("PUT", "/nodeev", query={"notification": ""},
                      body=doc.encode())[0] == 200
        payload = bytes(range(256)) * 300
        assert c.send("PUT", "/nodeev/o", body=payload)[0] == 200
        _drained(plane, sink, 1)
        lc = ("<LifecycleConfiguration><Rule><ID>t</ID><Status>Enabled"
              "</Status><Filter><Prefix></Prefix></Filter><Transition>"
              "<Date>2020-01-01T00:00:00Z</Date><StorageClass>cold"
              "</StorageClass></Transition></Rule>"
              "</LifecycleConfiguration>").encode()
        assert c.send("PUT", "/nodeev", query={"lifecycle": ""},
                      body=lc)[0] == 200
        assert node.metacache.drain(10)
        node.crawler.scan_once()
        assert node.transition_worker.drain(30)
        _drained(plane, sink, 2)
        assert c.send("POST", "/nodeev/o", query={"restore": ""})[0] == 202
        _drained(plane, sink, 3)
        assert c.send("GET", "/nodeev/o")[2] == payload
        lc = ("<LifecycleConfiguration><Rule><ID>x</ID><Status>Enabled"
              "</Status><Filter><Prefix></Prefix></Filter><Expiration>"
              "<Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>"
              "</LifecycleConfiguration>").encode()
        assert c.send("PUT", "/nodeev", query={"lifecycle": ""},
                      body=lc)[0] == 200
        assert node.metacache.drain(10)
        node.crawler.scan_once()
        _drained(plane, sink, 4)
        assert legacy.wait_for(3, 10)
        node.events.drain()
        assert [(r["Records"][0]["eventName"],
                 r["Records"][0]["s3"]["object"]["key"])
                for r in legacy.records] == [
            ("s3:ObjectCreated:Put", "o"),
            ("s3:ObjectRestore:Completed", "o"),
            ("s3:ObjectRemoved:Lifecycle", "o")]
        recs = [r["Records"][0] for r in sink.records]
        assert [r["eventName"] for r in recs] == [
            "s3:ObjectCreated:Put", "s3:ObjectTransition:Complete",
            "s3:ObjectRestore:Completed", "s3:ObjectRemoved:Delete"]
        assert recs[0]["s3"]["object"]["size"] == len(payload)
        assert [r["responseElements"]["x-minio-tier"] for r in recs] == \
            ["", "cold", "cold", ""]
        assert {r["responseElements"]["x-minio-origin-site"]
                for r in recs} == {site}
    finally:
        node.shutdown()
    node = cluster.start_single(drives, creds=creds, parity=2,
                                block_size=BS, device="cpu")
    try:
        assert node.repl_targets.site_id == site
        assert ARN in node.notify_targets.arns()
    finally:
        node.shutdown()
