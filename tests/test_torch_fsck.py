"""The port's fsck auditor (minio_tpu_torch/object/fsck.py) and the
crash plane it repairs, held against minio_tpu's.

  * tests/test_fsck.py's cases rebound to the port: each finding class
    found and repaired, the tmp age gate, the FS backend unsupported, the
    per-class counters, commit-window aborts keeping the previous
    version, a partial rename and a torn staged xl.meta converging, the
    torn-write injector, the MRF drain crash, torn checkpoint and
    registry loaders, the metacache persist crash and half manifest, the
    atomic writer and its fsync knob, atomic temp siblings, and a stub
    spared on a transient tier error. Left out:
    test_resync_checkpoint_torn_tolerated, which needs the resync walker
    of the replication plane (replicate/*, not ported);
  * for each of the 13 classes: one broken tree built by the reference,
    copied, and audited by each package: the two ``FsckReport.to_dict()``
    results are equal (timings and the copies' roots masked), and after
    repair the two trees' drive files are equal;
  * the boot fsck: a node booted through start_single (device="cpu")
    under MINIO_TPU_FSCK_BOOT=on repairs what a crash left, before its
    scanners start; with the knob off it leaves the tree alone.
Every comparison is byte for byte (tolerance 0).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time

import pytest

import minio_tpu.object.engine as ref_engine
import minio_tpu.object.fsck as ref_fsck_mod
import minio_tpu.object.multipart as ref_multipart
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
from minio_tpu.object.engine import PutOptions as RefPutOptions
from minio_tpu.object.multipart import CompletePart as RefPart
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.tier.config import TierConfig as RefTierConfig
from minio_tpu.tier.config import TierManager as RefTierManager
from minio_tpu.utils import regfence as ref_regfence
from minio_tpu_torch.object import api_errors
from minio_tpu_torch.object.background import MRFHealer
from minio_tpu_torch.object.engine import PutOptions
from minio_tpu_torch.object.fsck import CLASSES, run_fsck
from minio_tpu_torch.object.metacache import (MetacacheManager,
                                              manifest_key, mc_prefix)
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.object.rebalance import Rebalancer
from minio_tpu_torch.object.rebalance import _checkpoint_object as reb_ckpt
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.topology import TopologyStore
from minio_tpu_torch.storage.xl_storage import MINIO_META_BUCKET
from minio_tpu_torch.tier.config import TierManager
from minio_tpu_torch.utils import atomicfile, crashpoint, telemetry
from tests.test_s3 import CREDS
from tests.test_torch_s3 import _Pinned, drive_files

K, M, NDISKS = 4, 2, 6
BLOCK = 1 << 16
ORIGIN_KEY = "X-Minio-Internal-replication-origin"


def make_zones(tmp_path, pools=1, tag="p", bucket=True):
    zz = ErasureServerSets(
        [ErasureSets.from_drives(
            [str(tmp_path / f"{tag}{p}d{j}") for j in range(NDISKS)],
            1, NDISKS, M, block_size=BLOCK, enable_mrf=False, device="cpu")
         for p in range(pools)],
        load_topology=False)
    if bucket:
        zz.make_bucket("b")
    return zz


def ref_zones(tmp_path, pools=1, tag="p", bucket=True):
    zz = RefServerSets(
        [RefSets.from_drives(
            [str(tmp_path / f"{tag}{p}d{j}") for j in range(NDISKS)],
            1, NDISKS, M, block_size=BLOCK, enable_mrf=False)
         for p in range(pools)],
        load_topology=False)
    if bucket:
        zz.make_bucket("b")
    return zz


@pytest.fixture()
def zz(tmp_path):
    z = make_zones(tmp_path)
    yield z
    z.close()


@pytest.fixture(autouse=True)
def _disarm():
    crashpoint.disarm()
    yield
    crashpoint.disarm()


def eng_of(zz, pool=0):
    return zz.server_sets[pool].sets[0]


def get_bytes(zz, bucket, name):
    _info, stream = zz.get_object(bucket, name)
    try:
        return b"".join(stream)
    finally:
        close = getattr(stream, "close", None)
        if close:
            close()


# ---------------------------------------------------------------------------
# tests/test_fsck.py, rebound: fsck per finding class
# ---------------------------------------------------------------------------

def test_fsck_clean_tree(zz):
    zz.put_object("b", "ok", b"x" * 1000)
    rep = run_fsck(zz, tmp_age_s=0)
    assert rep.clean and rep.supported
    assert rep.objects_scanned >= 1


def test_fsck_orphan_data_dir(zz):
    zz.put_object("b", "obj", b"x" * 1000)
    d0 = eng_of(zz).disks[0]
    orphan = os.path.join(d0.root, "b", "obj", "11111111-dead")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "part.1"), "wb") as f:
        f.write(b"junk")
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"orphan_data": 1}
    assert rep.repaired_counts() == {"orphan_data": 1}
    assert not os.path.exists(orphan)
    assert get_bytes(zz, "b", "obj") == b"x" * 1000
    assert run_fsck(zz, tmp_age_s=0).clean


def test_fsck_tmp_age_gate(zz):
    d0 = eng_of(zz).disks[0]
    stale = os.path.join(d0.root, ".minio.sys", "tmp", "stale-uuid")
    os.makedirs(stale)
    with open(os.path.join(stale, "f"), "wb") as f:
        f.write(b"junk")
    # a FRESH staged dir is NOT reaped under the default age gate
    assert run_fsck(zz).counts() == {}
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"stale_tmp": 1}
    assert not os.path.exists(stale)


def test_fsck_meta_missing_heals(zz):
    zz.put_object("b", "deg", b"y" * 800)
    eng = eng_of(zz)
    os.unlink(os.path.join(eng.disks[1].root, "b", "deg", "xl.meta"))
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"meta_missing": 1}
    assert rep.repaired_counts() == {"meta_missing": 1}
    assert run_fsck(zz, tmp_age_s=0).clean
    assert os.path.exists(
        os.path.join(eng.disks[1].root, "b", "deg", "xl.meta"))


def test_fsck_missing_shards_heal_and_lost(zz):
    zz.put_object("b", "sh", b"z" * 4000)
    eng = eng_of(zz)
    fi = eng.disks[0].read_versions("b", "sh")[0]
    shutil.rmtree(os.path.join(eng.disks[2].root, "b", "sh",
                               fi.data_dir))
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"missing_shards": 1}
    assert run_fsck(zz, tmp_age_s=0).clean
    for j in range(NDISKS - K + 1):
        p = os.path.join(eng.disks[j].root, "b", "sh", fi.data_dir)
        if os.path.isdir(p):
            shutil.rmtree(p)
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert "lost_data" in rep.counts()
    lost = [f for f in rep.findings if f.cls == "lost_data"]
    assert lost and not lost[0].repairable


def test_fsck_origin_divergence_repairs(zz):
    zz.put_object("b", "repl", b"r" * 600,
                  opts=PutOptions(versioned=True))
    eng = eng_of(zz)
    for j, site in ((0, "site-A"), (1, "site-B")):
        fi = eng.disks[j].read_versions("b", "repl")[0]
        fi.metadata[ORIGIN_KEY] = site
        eng.disks[j].write_metadata("b", "repl", fi)
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"origin_divergence": 1}
    assert rep.repaired_counts() == {"origin_divergence": 1}
    assert run_fsck(zz, tmp_age_s=0).clean
    origins = {d.read_versions("b", "repl")[0].metadata.get(ORIGIN_KEY)
               for d in eng.disks}
    assert len(origins) == 1


def test_fsck_stale_multipart(zz):
    eng = eng_of(zz)
    for d in eng.disks:
        p = os.path.join(d.root, ".minio.sys", "multipart", "shaX",
                         "upl1", "dd")
        os.makedirs(p)
        with open(os.path.join(p, "part.1"), "wb") as f:
            f.write(b"junk")
    up = zz.new_multipart_upload("b", "live-mpu")
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"stale_multipart": 1}
    assert not os.path.exists(os.path.join(
        eng.disks[0].root, ".minio.sys", "multipart", "shaX"))
    pi = zz.put_object_part("b", "live-mpu", up, 1, b"m" * 700)
    zz.complete_multipart_upload("b", "live-mpu", up,
                                 [CompletePart(1, pi.etag)])
    assert get_bytes(zz, "b", "live-mpu") == b"m" * 700


def test_fsck_torn_registry_rewrites_from_best_copy(tmp_path):
    zz = make_zones(tmp_path, pools=2)
    try:
        epoch = zz.set_pool_state(1, "suspended")
        zz.set_pool_state(1, "active")
        zz.server_sets[0].put_object(MINIO_META_BUCKET,
                                     "topology/pools.json", b'{"epo')
        rep = run_fsck(zz, repair=True, tmp_age_s=0)
        assert rep.counts() == {"torn_registry": 1}
        assert rep.repaired_counts() == {"torn_registry": 1}
        assert run_fsck(zz, tmp_age_s=0).clean
        loaded = TopologyStore.load(zz)
        assert loaded is not None and loaded.epoch >= epoch
    finally:
        zz.close()


def test_fsck_torn_registry_single_copy_drops(zz):
    zz.server_sets[0].put_object(MINIO_META_BUCKET,
                                 "replicate/targets.json", b"\x00garb")
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"torn_registry": 1}
    assert run_fsck(zz, tmp_age_s=0).clean
    with pytest.raises(api_errors.ObjectApiError):
        zz.get_object(MINIO_META_BUCKET, "replicate/targets.json")


def test_fsck_dangling_stub(tmp_path, zz):
    from minio_tpu_torch.tier.config import TierConfig
    tiers = TierManager(zz)
    tiers.add(TierConfig.from_dict(
        {"name": "t1", "type": "fs",
         "params": {"path": str(tmp_path / "tier")}}))
    zz.put_object("b", "cold", b"cold" * 300)
    client = tiers.client("t1")
    client.put("rk1", io.BytesIO(b"cold" * 300), 1200)
    zz.transition_object("b", "cold", tier="t1", remote_object="rk1")
    assert run_fsck(zz, tiers=tiers, tmp_age_s=0).clean
    client.delete("rk1")
    rep = run_fsck(zz, repair=True, tiers=tiers, tmp_age_s=0)
    assert rep.counts() == {"dangling_stub": 1}
    assert rep.repaired_counts() == {"dangling_stub": 1}
    with pytest.raises(api_errors.ObjectApiError):
        zz.get_object_info("b", "cold")
    assert run_fsck(zz, tiers=tiers, tmp_age_s=0).clean


def test_fsck_metacache_orphan_segment_and_broken_manifest(zz):
    zz.put_object(MINIO_META_BUCKET, mc_prefix("b") + "seg-dead.json",
                  b"[]")
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"orphan_metacache_segment": 1}
    assert run_fsck(zz, tmp_age_s=0).clean
    zz.put_object(MINIO_META_BUCKET, manifest_key("b"), json.dumps(
        {"format": 1, "bucket": "b", "gen": 3,
         "segments": [{"key": mc_prefix("b") + "seg-gone.json",
                       "first": "", "count": 0}]}).encode())
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"broken_metacache_manifest": 1}
    assert run_fsck(zz, tmp_age_s=0).clean
    with pytest.raises(api_errors.ObjectApiError):
        zz.get_object(MINIO_META_BUCKET, manifest_key("b"))


def test_fsck_fs_backend_unsupported(tmp_path):
    from minio_tpu_torch.object.fs import FSObjects
    rep = run_fsck(FSObjects(str(tmp_path / "fs")))
    assert not rep.supported and rep.clean


def test_fsck_metrics_count_per_class(zz):
    found = telemetry.REGISTRY.counter("minio_tpu_fsck_findings_total")
    fixed = telemetry.REGISTRY.counter("minio_tpu_fsck_repaired_total")
    before = (found.value(**{"class": "meta_missing"}),
              fixed.value(**{"class": "meta_missing"}))
    zz.put_object("b", "obj", b"x" * 400)
    eng = eng_of(zz)
    os.unlink(os.path.join(eng.disks[0].root, "b", "obj", "xl.meta"))
    run_fsck(zz, repair=True, tmp_age_s=0)
    assert found.value(**{"class": "meta_missing"}) == before[0] + 1
    assert fixed.value(**{"class": "meta_missing"}) == before[1] + 1


# ---------------------------------------------------------------------------
# commit-window aborts: the previous version stays readable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["put.shards.before_meta",
                                   "put.meta.before_rename"])
def test_crash_between_fanout_and_commit_keeps_previous(zz, point):
    zz.put_object("b", "obj", b"OLD" * 500)
    crashpoint.arm(point)
    with pytest.raises(crashpoint.CrashpointAbort):
        zz.put_object("b", "obj", b"NEW" * 700)
    crashpoint.disarm()
    assert get_bytes(zz, "b", "obj") == b"OLD" * 500
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert len(rep.unrepaired) == 0
    assert run_fsck(zz, tmp_age_s=0).clean
    assert get_bytes(zz, "b", "obj") == b"OLD" * 500


def test_partial_rename_degrades_not_tears(zz):
    crashpoint.arm("put.rename.partial", nth=1)
    zz.put_object("b", "part", b"P" * 3000)     # succeeds degraded
    crashpoint.disarm()
    assert get_bytes(zz, "b", "part") == b"P" * 3000
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert len(rep.unrepaired) == 0
    assert run_fsck(zz, tmp_age_s=0).clean
    assert get_bytes(zz, "b", "part") == b"P" * 3000


def test_torn_write_injection(tmp_path):
    from minio_tpu_torch.storage.xl_storage import XLStorage
    d = XLStorage(str(tmp_path / "drv"))
    d.make_vol_bulk("vol")
    doc = json.dumps({"epoch": 12, "pools": ["active"]}).encode()
    crashpoint.arm("storage.write_all.commit",
                   action=crashpoint.torn_write_action(0.5))
    with pytest.raises(crashpoint.CrashpointAbort):
        d.write_all("vol", "doc.json", doc)
    crashpoint.disarm()
    torn = d.read_all("vol", "doc.json")
    assert 0 < len(torn) < len(doc)
    assert atomicfile.load_json_doc(torn) is None
    d.write_all("vol", "doc.json", doc)
    assert atomicfile.load_json_doc(d.read_all("vol", "doc.json")) \
        == json.loads(doc)


def test_torn_staged_meta_on_one_drive_converges(zz):
    crashpoint.arm("storage.write_all.commit",
                   action=crashpoint.torn_write_action(0.3))
    zz.put_object("b", "torn", b"T" * 2500)
    crashpoint.disarm()
    assert get_bytes(zz, "b", "torn") == b"T" * 2500
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert len(rep.unrepaired) == 0
    assert run_fsck(zz, tmp_age_s=0).clean
    assert get_bytes(zz, "b", "torn") == b"T" * 2500


def test_mrf_drain_crash():
    healed = []
    mrf = MRFHealer(lambda b, o, v: healed.append((b, o, v)),
                    backoff_base=0.01, backoff_max=0.05)
    try:
        crashpoint.arm("mrf.drain.before_heal")
        assert mrf.enqueue("b", "o", "v")
        deadline = time.monotonic() + 5
        while crashpoint.hits("mrf.drain.before_heal") < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert crashpoint.hits("mrf.drain.before_heal") >= 1
        # the aborted drain requeued the entry instead of losing it
        assert mrf.drain(timeout=5)
        assert healed == [("b", "o", "v")]
        assert mrf.requeued >= 1 and mrf.healed == 1
    finally:
        crashpoint.disarm()
        mrf.close()


# ---------------------------------------------------------------------------
# torn checkpoint/registry loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [b'{"updated": 5, "mark',  # torn
                                     b"12",      # valid-JSON wrong type
                                     b"",        # empty file
                                     b"\xff\xfe garbage"])
def test_rebalance_checkpoint_torn_tolerated(tmp_path, payload):
    zz = make_zones(tmp_path, pools=2)
    try:
        zz.server_sets[0].put_object(MINIO_META_BUCKET, reb_ckpt(1),
                                     payload)
        assert Rebalancer.load_checkpoint(zz, 1) is None
        zz.server_sets[1].put_object(
            MINIO_META_BUCKET, reb_ckpt(1),
            json.dumps({"updated": 9.0, "bucket": "b",
                        "marker": "k"}).encode())
        doc = Rebalancer.load_checkpoint(zz, 1)
        assert doc and doc["marker"] == "k"
        zz.server_sets[0].put_object(MINIO_META_BUCKET, reb_ckpt(1),
                                     payload)
        zz.server_sets[1].delete_object(MINIO_META_BUCKET, reb_ckpt(1))
        assert Rebalancer.load_checkpoint(zz, 1) is None
        assert zz.resume_rebalance_if_pending() is False
    finally:
        zz.close()


def test_registry_loads_tolerate_torn_copy(tmp_path):
    zz = make_zones(tmp_path, pools=2)
    try:
        epoch = zz.set_pool_state(1, "suspended")
        zz.server_sets[0].put_object(MINIO_META_BUCKET,
                                     "topology/pools.json", b"[1, 2")
        loaded = TopologyStore.load(zz)
        assert loaded is not None and loaded.epoch == epoch
        zz.server_sets[1].put_object(MINIO_META_BUCKET,
                                     "topology/pools.json", b"[1, 2")
        assert TopologyStore.load(zz) is None
        fresh = ErasureServerSets(zz.server_sets)   # boots all-active
        assert fresh.topology.write_pools() == [0, 1]
    finally:
        zz.close()


def test_tier_registry_tolerates_torn_doc(zz):
    """The tier half of test_tier_and_target_registry_tolerate_torn_docs
    (the replication target registry is not ported)."""
    zz.put_object(MINIO_META_BUCKET, "tier/config.json", b'{"epoch"')
    assert TierManager(zz).load() is False


# ---------------------------------------------------------------------------
# metacache persist crash: fallback + rebuild, never a half manifest
# ---------------------------------------------------------------------------

def _attach(zz, **kw):
    kw.setdefault("staleness_s", 0.0)
    kw.setdefault("flush_s", 0.05)
    mgr = MetacacheManager(zz, **kw)
    mgr.start()
    zz.attach_metacache(mgr)
    return mgr


def _oracle(zz, bucket="b"):
    mc, zz.metacache = zz.metacache, None
    try:
        objs, _p, _t = zz.list_objects(bucket, "", "", "", 1000)
        return [o.name for o in objs]
    finally:
        zz.metacache = mc


def test_metacache_persist_crash_falls_back_and_rebuilds(zz):
    for i in range(8):
        zz.put_object("b", f"k{i:02d}", bytes([i]) * 300)
    mgr = _attach(zz, persist_s=0.0)
    crashpoint.arm("metacache.persist.before_manifest")
    try:
        deadline = time.monotonic() + 10
        while mgr.persist_errors == 0 and time.monotonic() < deadline:
            zz.list_objects("b", "", "", "", 100)
            time.sleep(0.05)
        assert mgr.persist_errors >= 1, "persist crash never fired"
    finally:
        crashpoint.disarm()
    objs, _p, _t = zz.list_objects("b", "", "", "", 100)
    assert [o.name for o in objs] == _oracle(zz)
    mgr.close(flush=False)
    zz.metacache = None
    mgr2 = _attach(zz)
    objs, _p, _t = zz.list_objects("b", "", "", "", 100)
    assert [o.name for o in objs] == _oracle(zz)
    mgr2.close(flush=False)
    zz.metacache = None
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert set(rep.counts()) <= {"orphan_metacache_segment"}
    assert len(rep.unrepaired) == 0
    assert run_fsck(zz, tmp_age_s=0).clean


def test_metacache_half_manifest_never_served(zz):
    def plant_half_manifest():
        zz.put_object(MINIO_META_BUCKET, manifest_key("b"), json.dumps(
            {"format": 1, "bucket": "b", "gen": 9,
             "segments": [{"key": mc_prefix("b") + "seg-never.json",
                           "first": "", "count": 5}]}).encode())

    for i in range(5):
        zz.put_object("b", f"m{i}", bytes([i + 1]) * 200)
    plant_half_manifest()
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert "broken_metacache_manifest" in rep.counts()
    assert run_fsck(zz, tmp_age_s=0).clean
    plant_half_manifest()
    mgr = _attach(zz)
    try:
        objs, _p, _t = zz.list_objects("b", "", "", "", 100)
        assert [o.name for o in objs] == _oracle(zz)
    finally:
        mgr.close(flush=False)
        zz.metacache = None


def test_write_atomic_and_fsync_knob(tmp_path, monkeypatch):
    p = str(tmp_path / "sub" / "doc.json")
    os.makedirs(os.path.dirname(p))
    atomicfile.write_atomic(p, b"hello")
    assert open(p, "rb").read() == b"hello"
    monkeypatch.setenv("MINIO_TPU_FSYNC", "on")
    assert atomicfile.fsync_enabled()
    atomicfile.write_atomic(p, b"world")
    assert open(p, "rb").read() == b"world"
    assert not [f for f in os.listdir(os.path.dirname(p))
                if f.endswith(".tmp")]


def test_load_json_doc_shapes():
    assert atomicfile.load_json_doc(b'{"a": 1}') == {"a": 1}
    assert atomicfile.load_json_doc(b'{"a": 1') is None
    assert atomicfile.load_json_doc(b"12") is None
    assert atomicfile.load_json_doc(b"[1]") is None
    assert atomicfile.load_json_doc(b"") is None
    assert atomicfile.load_json_doc(b"\xff\x00") is None


def test_fsck_reclaims_atomic_temp_siblings(zz):
    zz.put_object("b", "obj", b"x" * 600)
    d0 = eng_of(zz).disks[0]
    leftover = os.path.join(d0.root, "b", "obj", "xl.meta.ab12cd34.tmp")
    with open(leftover, "wb") as f:
        f.write(b'{"half')
    assert run_fsck(zz).counts() == {}
    rep = run_fsck(zz, repair=True, tmp_age_s=0)
    assert rep.counts() == {"stale_tmp": 1}
    assert not os.path.exists(leftover)
    assert get_bytes(zz, "b", "obj") == b"x" * 600
    assert run_fsck(zz, tmp_age_s=0).clean


def test_fsck_stub_spared_on_transient_tier_error(tmp_path, zz):
    from minio_tpu_torch.tier.client import TierClientError
    from minio_tpu_torch.tier.config import TierConfig
    tiers = TierManager(zz)
    tiers.add(TierConfig.from_dict(
        {"name": "t1", "type": "fs",
         "params": {"path": str(tmp_path / "tier")}}))
    zz.put_object("b", "cold", b"c" * 900)
    tiers.client("t1").put("rk", io.BytesIO(b"c" * 900), 900)
    zz.transition_object("b", "cold", tier="t1", remote_object="rk")

    class DownClient:
        def head(self, key):
            raise TierClientError("connection refused")

    class DownTiers:
        def client(self, name):
            return DownClient()

    rep = run_fsck(zz, repair=True, tiers=DownTiers(), tmp_age_s=0)
    assert rep.counts() == {}
    assert zz.get_object_info("b", "cold") is not None

    class EmptyTiers:
        def client(self, name):
            raise KeyError(name)
    assert run_fsck(zz, repair=True, tiers=EmptyTiers(),
                    tmp_age_s=0).counts() == {}


# ---------------------------------------------------------------------------
# twin trees: one broken tree, audited and repaired by each package
# ---------------------------------------------------------------------------

def _ref_put(zz, name, size, **kw):
    zz.put_object("b", name, bytes([len(name)]) * size, **kw)


def _data_dir(zz, name):
    eng = zz.server_sets[0].sets[0]
    return eng.disks[0].read_versions("b", name)[0].data_dir


def _build_meta_missing(root, zz):
    _ref_put(zz, "deg", 800)
    os.unlink(os.path.join(str(root), "p0d1", "b", "deg", "xl.meta"))


def _build_meta_below_quorum(root, zz):
    _ref_put(zz, "dang", 900)
    for j in range(3):
        os.unlink(os.path.join(str(root), f"p0d{j}", "b", "dang",
                               "xl.meta"))


def _build_missing_shards(root, zz):
    _ref_put(zz, "sh", 300_001)
    dd = _data_dir(zz, "sh")
    for j in (2, 5):
        shutil.rmtree(os.path.join(str(root), f"p0d{j}", "b", "sh", dd))


def _build_lost_data(root, zz):
    _ref_put(zz, "gone", 70_000)
    dd = _data_dir(zz, "gone")
    for j in range(NDISKS - K + 1):
        shutil.rmtree(os.path.join(str(root), f"p0d{j}", "b", "gone", dd))


def _build_orphan_data(root, zz):
    _ref_put(zz, "obj", 1000)
    orphan = os.path.join(str(root), "p0d0", "b", "obj", "11111111-dead")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "part.1"), "wb") as f:
        f.write(b"junk")
    lone = os.path.join(str(root), "p0d3", "b", "lone", "dd")
    os.makedirs(lone)
    with open(os.path.join(lone, "part.1"), "wb") as f:
        f.write(b"junk")


def _build_stale_tmp(root, zz):
    _ref_put(zz, "obj", 600)
    stale = os.path.join(str(root), "p0d0", ".minio.sys", "tmp", "s-uuid")
    os.makedirs(stale)
    with open(os.path.join(stale, "f"), "wb") as f:
        f.write(b"junk")
    with open(os.path.join(str(root), "p0d4", "b", "obj",
                           "xl.meta.ab12cd34.tmp"), "wb") as f:
        f.write(b'{"half')


def _build_stale_multipart(root, zz):
    for j in range(NDISKS):
        p = os.path.join(str(root), f"p0d{j}", ".minio.sys", "multipart",
                         "shaX", "upl1", "dd")
        os.makedirs(p)
        with open(os.path.join(p, "part.1"), "wb") as f:
            f.write(b"junk")
    up = zz.new_multipart_upload("b", "used")
    zz.server_sets[0].mark_multipart_session(
        "b", "used", up, {"x-minio-internal-migrated": "1"})
    live = zz.new_multipart_upload("b", "live")
    pi = zz.put_object_part("b", "live", live, 1, b"m" * 700)
    done = zz.new_multipart_upload("b", "done")
    pd = zz.put_object_part("b", "done", done, 1, b"d" * 900)
    zz.complete_multipart_upload("b", "done", done, [RefPart(1, pd.etag)])
    assert pi.etag


def _build_orphan_metacache_segment(root, zz):
    zz.put_object(MINIO_META_BUCKET, mc_prefix("b") + "seg-dead.json",
                  b"[]")


def _build_broken_metacache_manifest(root, zz):
    zz.put_object(MINIO_META_BUCKET, manifest_key("b"), json.dumps(
        {"format": 1, "bucket": "b", "gen": 3,
         "segments": [{"key": mc_prefix("b") + "seg-gone.json",
                       "first": "", "count": 0}]}).encode())


def _build_dangling_stub(root, zz):
    tiers = RefTierManager(zz)
    tiers.add(RefTierConfig.from_dict(
        {"name": "t1", "type": "fs",
         "params": {"path": str(root.parent / "tier")}}))
    for name in ("cold", "warm"):
        _ref_put(zz, name, 1200)
        tiers.client("t1").put(f"rk-{name}", io.BytesIO(b"c" * 1200), 1200)
        zz.transition_object("b", name, tier="t1",
                             remote_object=f"rk-{name}")
    tiers.client("t1").delete("rk-cold")


def _build_torn_registry(root, zz):
    zz.set_pool_state(1, "suspended")
    zz.set_pool_state(1, "active")
    zz.server_sets[0].put_object(MINIO_META_BUCKET,
                                 "topology/pools.json", b'{"epo')
    zz.server_sets[1].put_object(MINIO_META_BUCKET,
                                 "replicate/targets.json", b"\x00garb")


def _build_origin_divergence(root, zz):
    zz.put_object("b", "repl", b"r" * 600,
                  opts=RefPutOptions(versioned=True))
    eng = zz.server_sets[0].sets[0]
    for j, site in ((0, "site-A"), (1, "site-B")):
        fi = eng.disks[j].read_versions("b", "repl")[0]
        fi.metadata[ORIGIN_KEY] = site
        eng.disks[j].write_metadata("b", "repl", fi)


def _build_registry_epoch_fork(root, zz):
    for p, writer in ((0, "node-a"), (1, "node-b")):
        doc = ref_regfence.stamp({"epoch": 4, "pools": ["active",
                                                        "active"],
                                  "updated": 1.7e9}, 4, writer, "p0")
        zz.server_sets[p].put_object(MINIO_META_BUCKET,
                                     "topology/pools.json",
                                     json.dumps(doc).encode())


TWIN_CASES = {
    "meta_missing": (1, _build_meta_missing),
    "meta_below_quorum": (1, _build_meta_below_quorum),
    "missing_shards": (1, _build_missing_shards),
    "lost_data": (1, _build_lost_data),
    "orphan_data": (1, _build_orphan_data),
    "stale_tmp": (1, _build_stale_tmp),
    "stale_multipart": (1, _build_stale_multipart),
    "orphan_metacache_segment": (1, _build_orphan_metacache_segment),
    "broken_metacache_manifest": (1, _build_broken_metacache_manifest),
    "dangling_stub": (1, _build_dangling_stub),
    "torn_registry": (2, _build_torn_registry),
    "origin_divergence": (1, _build_origin_divergence),
    "registry_epoch_fork": (2, _build_registry_epoch_fork),
}


def test_twin_cases_cover_every_class():
    assert set(TWIN_CASES) == set(CLASSES) == set(ref_fsck_mod.CLASSES)


def _masked(report: dict, root) -> dict:
    out = dict(report)
    out.pop("duration_s")
    out["findings"] = [
        dict(f, detail=f["detail"].replace(str(root), "<root>"),
             repair_error=f["repair_error"].replace(str(root), "<root>"))
        for f in report["findings"]]
    return out


@pytest.mark.parametrize("cls", sorted(TWIN_CASES))
def test_twin_trees_audited_and_repaired_alike(tmp_path, monkeypatch, cls):
    pools, build = TWIN_CASES[cls]
    seed = tmp_path / "seed"
    ref = ref_zones(seed, pools=pools)
    build(seed, ref)
    ref.close()
    shutil.copytree(seed, tmp_path / "ref")
    shutil.copytree(seed, tmp_path / "port")
    layers = {"ref": ref_zones(tmp_path / "ref", pools, bucket=False),
              "port": make_zones(tmp_path / "port", pools, bucket=False)}
    runs = {"ref": ref_fsck_mod.run_fsck, "port": run_fsck}
    tier_mgr = {"ref": RefTierManager, "port": TierManager}
    # the repairs' writes (heals, registry rewrites) take their uuids and
    # mod times from one counter per package
    for mods in ((ref_engine, ref_multipart),
                 (port_engine, port_multipart)):
        p = _Pinned()
        for mod in mods:
            monkeypatch.setattr(mod, "_uuid", p)
            monkeypatch.setattr(mod, "now", p.now)
    try:
        reports = {}
        for side, layer in layers.items():
            tiers = tier_mgr[side](layer)
            tiers.load()
            root = tmp_path / side
            audit = runs[side](layer, tiers=tiers, tmp_age_s=0).to_dict()
            fixed = runs[side](layer, repair=True, tiers=tiers,
                               tmp_age_s=0).to_dict()
            again = runs[side](layer, tiers=tiers, tmp_age_s=0).to_dict()
            reports[side] = [_masked(r, root) for r in (audit, fixed,
                                                        again)]
        assert reports["port"] == reports["ref"]
        audit, fixed, again = reports["port"]
        assert cls in audit["counts"]
        assert fixed["repair"] and fixed["counts"] == audit["counts"]
        if cls in ("lost_data", "meta_below_quorum"):
            # below the read or decode quorum no heal can rebuild the
            # object, in either package (InsufficientReadQuorum for the
            # dangling meta): reported again, never dropped
            assert fixed["unrepaired"] == 1 and not again["clean"]
        else:
            assert fixed["unrepaired"] == 0
            assert again["clean"]
        assert drive_files(tmp_path / "port") == \
            drive_files(tmp_path / "ref")
    finally:
        for layer in layers.values():
            layer.close()


# ---------------------------------------------------------------------------
# the boot fsck
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", ["on", "off"])
def test_boot_fsck_through_start_single(tmp_path, monkeypatch, knob):
    from minio_tpu_torch import cluster
    from minio_tpu_torch.parallel import pipeline
    monkeypatch.setattr(pipeline, "POOL_BUFFERS", pipeline.POOL_BUFFERS)
    drives = [str(tmp_path / f"d{i}") for i in range(NDISKS)]
    node = cluster.start_single(drives, creds=CREDS, block_size=BLOCK,
                                device="cpu")
    node.object_layer.make_bucket("b")
    node.object_layer.put_object("b", "obj", b"x" * 5000)
    node.shutdown()
    # what a crash leaves: staged tmp garbage and an orphan data dir
    stale = os.path.join(drives[0], ".minio.sys", "tmp", "crash-uuid")
    os.makedirs(stale)
    orphan = os.path.join(drives[1], "b", "obj", "22222222-dead")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "part.1"), "wb") as f:
        f.write(b"junk")
    # the boot's drives are wrapped in their disk-id checks, which the tmp
    # age gate cannot stat (the reference's rule): a quiesced boot reaps
    # under MINIO_TPU_FSCK_TMP_AGE_S=0
    monkeypatch.setenv("MINIO_TPU_FSCK_TMP_AGE_S", "0")
    monkeypatch.setenv("MINIO_TPU_FSCK_BOOT", knob)
    node = cluster.start_single(drives, creds=CREDS, block_size=BLOCK,
                                device="cpu")
    try:
        if knob == "off":
            assert node.boot_fsck is None
            assert os.path.exists(orphan)
            return
        rep = node.boot_fsck
        assert rep.repair_ran
        assert rep.counts() == rep.repaired_counts() == \
            {"orphan_data": 1, "stale_tmp": 1}
        assert not os.path.exists(stale) and not os.path.exists(orphan)
        assert run_fsck(node.object_layer, tmp_age_s=0).clean
        assert get_bytes(node.object_layer, "b", "obj") == b"x" * 5000
    finally:
        node.shutdown()


def test_boot_fsck_misses_a_pool_added_after_boot(tmp_path, monkeypatch):
    """The boot's audit runs inside the node's boot, before the CLI's
    --pool pools join (add_pool after start_single, as in the reference):
    a fault in an added pool is left to an on-demand run_fsck."""
    from minio_tpu_torch import cluster
    from minio_tpu_torch.parallel import pipeline
    monkeypatch.setattr(pipeline, "POOL_BUFFERS", pipeline.POOL_BUFFERS)
    drives0 = [str(tmp_path / f"a{i}") for i in range(NDISKS)]
    drives1 = [str(tmp_path / f"b{i}") for i in range(NDISKS)]
    node = cluster.start_single(drives0, creds=CREDS, block_size=BLOCK,
                                device="cpu")
    node.add_pool(drives1)
    node.shutdown()
    stale0 = os.path.join(drives0[0], ".minio.sys", "tmp", "crash-a")
    stale1 = os.path.join(drives1[1], ".minio.sys", "tmp", "crash-b")
    for d in (stale0, stale1):
        os.makedirs(d)
    monkeypatch.setenv("MINIO_TPU_FSCK_TMP_AGE_S", "0")
    monkeypatch.setenv("MINIO_TPU_FSCK_BOOT", "on")
    node = cluster.start_single(drives0, creds=CREDS, block_size=BLOCK,
                                device="cpu")
    try:
        assert node.add_pool(drives1) == 1
        rep = node.boot_fsck
        assert rep.counts() == rep.repaired_counts() == {"stale_tmp": 1}
        assert [f.pool for f in rep.findings] == [0]
        assert not os.path.exists(stale0) and os.path.exists(stale1)
        rep = run_fsck(node.object_layer, repair=True, tmp_age_s=0)
        assert rep.repaired_counts() == {"stale_tmp": 1}
        assert [f.pool for f in rep.findings] == [1]
        assert not os.path.exists(stale1)
        assert run_fsck(node.object_layer, tmp_age_s=0).clean
    finally:
        node.shutdown()


def test_boot_fsck_failure_is_logged_and_the_boot_proceeds(
        tmp_path, monkeypatch, capsys):
    from minio_tpu_torch import cluster
    from minio_tpu_torch.parallel import pipeline
    monkeypatch.setattr(pipeline, "POOL_BUFFERS", pipeline.POOL_BUFFERS)
    monkeypatch.setenv("MINIO_TPU_FSCK_BOOT", "on")

    def boom(*a, **kw):
        raise RuntimeError("audit exploded")

    monkeypatch.setattr(cluster, "run_fsck", boom)
    node = cluster.start_single([str(tmp_path / f"d{i}")
                                 for i in range(NDISKS)], creds=CREDS,
                                block_size=BLOCK, device="cpu")
    try:
        assert node.boot_fsck is None
        assert "boot fsck failed" in capsys.readouterr().err
        node.object_layer.make_bucket("b")
    finally:
        node.shutdown()
