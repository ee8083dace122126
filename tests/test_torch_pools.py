"""The port's pool plane (minio_tpu_torch/object/rebalance.py, the server
sets' topology verbs and migrate_upload, the disk monitor's add_pool)
held against minio_tpu's.

  * tests/test_topology.py's cases from online expansion on, rebound to
    the port: add_pool, the last active pool refusing to drain, a
    decommission end to end with GETs interleaved, a resume from the
    checkpoint, the throttle, cancel, meta-bucket objects, the disk
    monitor covering a pool added after boot, and the three multipart
    migration cases; with test_metacache.py's drain through the index
    feed and test_tier.py's drain of a transitioned stub;
  * cross-package: one two-pool tree the reference wrote, copied and
    drained by each package under pinned identities, leaves equal drive
    files; a drain checkpointed by either package is resumed by the
    other; a session migrated by either package completes under the
    other. Every comparison is byte for byte (tolerance 0).
"""

from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np
import pytest

import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.object.rebalance as ref_rebalance
import minio_tpu.object.topology as ref_topology
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.object.rebalance as port_rebalance
import minio_tpu_torch.object.topology as port_topology
from minio_tpu.object.rebalance import Rebalancer as RefRebalancer
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu_torch.object import api_errors
from minio_tpu_torch.object.engine import PutOptions
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.object.rebalance import Rebalancer
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.topology import (POOL_ACTIVE, POOL_DRAINING,
                                             POOL_SUSPENDED, TopologyError)
from minio_tpu_torch.storage.xl_storage import MINIO_META_BUCKET
from minio_tpu_torch.utils import telemetry
from tests.test_torch_s3 import _Pinned, drive_files

BLOCK = 1 << 16
NEVER_BUSY = dict(busy_fn=lambda: False, throttle_s=0.001)
# version ids are serialized as UUID bytes in xl.meta
VID1 = "00000000-0000-4000-8000-000000000001"
VID2 = "00000000-0000-4000-8000-000000000002"
VIDM = "00000000-0000-4000-8000-00000000000f"


def make_zone(tmp_path, tag: str, enable_mrf: bool = False) -> ErasureSets:
    return ErasureSets.from_drives(
        [str(tmp_path / f"{tag}d{i}") for i in range(4)], 1, 4, 2,
        block_size=BLOCK, enable_mrf=enable_mrf, device="cpu")


def ref_zone(tmp_path, tag: str) -> RefSets:
    return RefSets.from_drives(
        [str(tmp_path / f"{tag}d{i}") for i in range(4)], 1, 4, 2,
        block_size=BLOCK, enable_mrf=False)


@pytest.fixture()
def pools(tmp_path):
    zz = ErasureServerSets([make_zone(tmp_path, "p0"),
                            make_zone(tmp_path, "p1")])
    zz.make_bucket("b")
    yield zz
    zz.close()


def holders(zz, bucket, name):
    return [i for i, z in enumerate(zz.server_sets)
            if z.has_object_versions(bucket, name)]


def wait_status(zz, want: str, timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = zz.rebalance_status().get("rebalance", {})
        if st.get("status") == want:
            return st
        if st.get("status") == "failed":
            raise AssertionError(f"rebalance failed: {st}")
        time.sleep(0.05)
    raise AssertionError(
        f"rebalance never reached {want!r}: {zz.rebalance_status()}")


def read(zz, name, bucket="b"):
    _, it = zz.get_object(bucket, name)
    return b"".join(it)


# ---------------------------------------------------------------------------
# tests/test_topology.py, rebound
# ---------------------------------------------------------------------------

def test_add_pool_online_expansion(tmp_path):
    zz = ErasureServerSets([make_zone(tmp_path, "p0")])
    zz.make_bucket("b")
    zz.put_object("b", "pre", b"before-expansion")
    try:
        idx = zz.add_pool(make_zone(tmp_path, "p1"))
        assert idx == 1
        assert zz.topology.epoch == 1
        assert len(zz.topology) == 2
        # namespace replicated onto the new pool
        assert zz.server_sets[1].bucket_exists("b")
        # overwrite affinity: the object's history stays in pool 0
        zz.put_object("b", "pre", b"after-expansion!")
        assert holders(zz, "b", "pre") == [0]
        assert read(zz, "pre") == b"after-expansion!"
        # the persisted epoch doc reaches both pools, and the reference
        # reads the same map
        zz2 = ErasureServerSets(zz.server_sets)
        assert zz2.topology.epoch == 1 and len(zz2.topology) == 2
        ref = RefServerSets([ref_zone(tmp_path, "p0"),
                             ref_zone(tmp_path, "p1")])
        assert ref.topology.to_dict() == zz2.topology.to_dict()
        ref.close()
    finally:
        zz.close()


def test_add_pool_adopts_a_persisted_pool_state(tmp_path):
    """A node that reboots mid-drain re-attaches its pools one by one:
    add_pool adopts the persisted state of the pool's index, so the
    pool keeps its state (a draining pool resumes its drain) instead
    of coming back active."""
    zz = ErasureServerSets([make_zone(tmp_path, "p0"),
                            make_zone(tmp_path, "p1")])
    zz.make_bucket("b")
    zz.set_pool_state(1, POOL_SUSPENDED)
    zz.close()
    boot = ErasureServerSets([make_zone(tmp_path, "p0")])
    try:
        boot.add_pool(make_zone(tmp_path, "p1"))
        assert boot.topology.states == [POOL_ACTIVE, POOL_SUSPENDED]
    finally:
        boot.close()


def test_last_active_pool_cannot_drain(tmp_path):
    zz = ErasureServerSets([make_zone(tmp_path, "solo")])
    try:
        with pytest.raises(TopologyError):
            zz.start_decommission(0)
    finally:
        zz.close()


def test_decommission_end_to_end(pools):
    """2 pools -> drain pool 0 with interleaved GETs -> everything
    readable throughout, pool 0 empty, status complete, version history
    and markers preserved."""
    zz = pools
    datas = {}
    for i in range(6):
        name = f"e2e-{i}"
        data = bytes([i]) * (BLOCK + 137 * i)
        zz.server_sets[i % 2].put_object("b", name, data)
        datas[name] = data
    # a versioned object with two versions and a non-latest marker
    z0 = zz.server_sets[0]
    z0.put_object("b", "ver", b"v1-bytes",
                  opts=PutOptions(versioned=True, version_id=VID1))
    time.sleep(0.01)
    z0.delete_object("b", "ver", versioned=True)
    time.sleep(0.01)
    z0.put_object("b", "ver", b"v2-bytes!",
                  opts=PutOptions(versioned=True, version_id=VID2))
    datas["ver"] = b"v2-bytes!"

    stop_reads = threading.Event()
    read_failures: list = []

    def reader():
        while not stop_reads.is_set():
            for name, data in datas.items():
                try:
                    if read(zz, name) != data:
                        read_failures.append((name, "byte mismatch"))
                except Exception as e:  # noqa: BLE001 — asserted below
                    read_failures.append((name, repr(e)))

    t = threading.Thread(target=reader)
    t.start()
    counter = telemetry.REGISTRY.counter("minio_tpu_rebalance_objects_total")
    before = counter.value(pool="0")
    try:
        out = zz.start_decommission(0, checkpoint_every=2, **NEVER_BUSY)
        assert out["status"] == "draining"
        assert zz.topology.state(0) == POOL_DRAINING
        st = wait_status(zz, "complete")
    finally:
        stop_reads.set()
        t.join()
    assert not read_failures, read_failures[:5]
    # pool 0 held e2e-0/2/4 and "ver": 4 object names moved
    assert st["objects_moved"] == 4
    assert st["objects_failed"] == 0
    assert zz.server_sets[0].list_object_versions("b", max_keys=10)[0] == []
    for name, data in datas.items():
        assert holders(zz, "b", name) == [1], name
        assert read(zz, name) == data
    vers = [(v.version_id, v.delete_marker, v.mod_time)
            for v in zz.server_sets[1].list_object_versions("b", "ver")[0]
            if v.name == "ver"]
    assert len(vers) == 3
    assert {v[0] for v in vers} >= {VID1, VID2}
    assert any(v[1] for v in vers)          # the marker moved too
    assert vers[0][0] == VID2 and not vers[0][1]
    # every version move counted (6: e2e-0/2/4 and three of "ver")
    assert counter.value(pool="0") - before == 6


def test_rebalance_resumes_from_checkpoint(pools):
    zz = pools
    for i in range(10):
        zz.server_sets[0].put_object("b", f"r-{i:02d}", b"y" * 200)
    zz.set_pool_state(0, POOL_DRAINING)

    moves = 0

    def busy():
        nonlocal moves
        moves += 1
        if moves == 5:
            reb.stop()          # kill mid-drain (the throttle runs
        return False            # before each object's move)

    reb = Rebalancer(zz, 0, checkpoint_every=1, busy_fn=busy)
    reb.start()
    deadline = time.monotonic() + 30
    while reb.running() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not reb.running()
    first = reb.status()
    assert first["status"] == "stopped"
    assert 0 < first["objects_moved"] < 10
    ckpt = Rebalancer.load_checkpoint(zz, 0)
    assert ckpt is not None and ckpt["marker"]

    reb2 = Rebalancer(zz, 0, resume=True, checkpoint_every=1,
                      **NEVER_BUSY)
    assert reb2.state.get("resumed")
    assert reb2.state["marker"] == ckpt["marker"]
    zz._rebalancer = reb2
    reb2.start()
    st = wait_status(zz, "complete")
    assert 10 <= st["objects_moved"] <= 11
    assert zz.server_sets[0].list_object_versions("b", max_keys=20)[0] == []
    for i in range(10):
        assert holders(zz, "b", f"r-{i:02d}") == [1]


def test_rebalance_throttle_backs_off_on_occupancy(pools):
    zz = pools
    calls = []
    reb = Rebalancer(zz, 0, busy_fn=lambda: calls.append(1) or True,
                     throttle_s=0.001)
    t0 = time.monotonic()
    reb._throttle()
    assert len(calls) == port_rebalance.BACKOFF_TRIES == \
        ref_rebalance.BACKOFF_TRIES
    assert time.monotonic() - t0 < 5.0
    calls.clear()
    reb2 = Rebalancer(zz, 0, busy_fn=lambda: calls.append(1) or False)
    reb2._throttle()
    assert len(calls) == 1


def test_cancel_returns_pool_to_active(pools):
    zz = pools
    for i in range(4):
        zz.server_sets[0].put_object("b", f"c-{i}", b"z" * 100)
    zz.start_decommission(0, busy_fn=lambda: True, throttle_s=0.2)
    out = zz.cancel_rebalance()
    assert out["status"] == "canceled"
    assert zz.topology.state(0) == POOL_ACTIVE
    assert zz.topology.write_pools() == [0, 1]
    with pytest.raises(TopologyError):
        ErasureServerSets([zz.server_sets[0]],
                          load_topology=False).cancel_rebalance()


def test_meta_bucket_objects_migrate_but_internals_stay(pools):
    zz = pools
    zz.server_sets[0].put_object(MINIO_META_BUCKET, "config/test.json",
                                 b'{"k":"v"}')
    zz.set_pool_state(0, POOL_DRAINING)
    reb = Rebalancer(zz, 0, **NEVER_BUSY)
    zz._rebalancer = reb
    reb.start()
    wait_status(zz, "complete")
    assert read(zz.server_sets[1], "config/test.json",
                MINIO_META_BUCKET) == b'{"k":"v"}'
    with pytest.raises(api_errors.ObjectNotFound):
        zz.server_sets[0].get_object_info(MINIO_META_BUCKET,
                                          "config/test.json")
    # the per-pool topology doc is still on pool 0 (deliberately)
    zz.server_sets[0].get_object_info(MINIO_META_BUCKET,
                                      "topology/pools.json")


def test_disk_monitor_covers_post_boot_pool(tmp_path):
    """A drive killed in a pool appended AFTER the monitor started is
    re-admitted and healed like a boot-time one."""
    from minio_tpu_torch.object.background import DiskMonitor
    from minio_tpu_torch.storage.xl_storage import XLStorage

    zz = ErasureServerSets([make_zone(tmp_path, "p0")])
    zz.make_bucket("b")
    mon = DiskMonitor(zz.server_sets[0], interval=3600)
    try:
        pool1 = make_zone(tmp_path, "p1")
        zz.add_pool(pool1)
        mon.add_pool(pool1)
        mon.add_pool(pool1)                  # registering twice is a no-op
        assert mon.pools == [zz.server_sets[0], pool1]
        assert mon.sets is zz.server_sets[0]

        zz.set_pool_state(0, POOL_SUSPENDED)
        payload = b"post-boot pool data " * 5000
        zz.put_object("b", "obj", payload)
        assert zz.server_sets[1].has_object_versions("b", "obj")

        victim = str(tmp_path / "p1d2")
        shutil.rmtree(victim)
        assert mon.scan_once() == 1          # re-admitted + formatted
        assert mon.healed_slots              # swept as a fresh drive

        fmt = XLStorage(victim).read_format()
        assert fmt.id == pool1.deployment_id
        assert fmt.this in [u for row in pool1.format_ref.sets
                            for u in row]
        assert read(zz, "obj") == payload
        assert os.path.isdir(os.path.join(victim, "b", "obj"))
        assert mon.scan_once() == 0
    finally:
        mon.close()
        zz.close()


def test_decommission_migrates_live_multipart_session(pools):
    """A session in flight on the draining pool is migrated: metadata,
    uploaded parts and the client-held uploadID survive, the drain
    completes without waiting the client out, and the upload finishes
    against the new pool."""
    zz = pools
    part = b"p" * (6 << 20)
    uid = zz.new_multipart_upload("b", "mpu-live")
    src = zz._zone_index_of_upload("b", "mpu-live", uid)
    p1 = zz.put_object_part("b", "mpu-live", uid, 1, part, len(part))

    zz.start_decommission(src, mpu_grace_s=0.0, **NEVER_BUSY)
    wait_status(zz, "complete")
    dst = zz._zone_index_of_upload("b", "mpu-live", uid)
    assert dst != src
    listed = zz.list_object_parts("b", "mpu-live", uid)
    assert [(p.part_number, p.etag, p.size) for p in listed] == \
        [(1, p1.etag, len(part))]
    st = zz.rebalance_status()["rebalance"]
    assert st["mpu_migrated"] >= 1 and st["mpu_failed"] == 0

    part2 = b"q" * (1 << 20)
    p2 = zz.put_object_part("b", "mpu-live", uid, 2, part2, len(part2))
    info = zz.complete_multipart_upload(
        "b", "mpu-live", uid,
        [CompletePart(1, p1.etag), CompletePart(2, p2.etag)])
    assert info.size == len(part) + len(part2)
    assert read(zz, "mpu-live") == part + part2
    assert holders(zz, "b", "mpu-live") == [dst]


def test_draining_pool_refuses_new_parts_via_migration(pools):
    """Before the rebalancer reaches the session, a part-write aimed at
    a draining pool migrates the session to an active pool and lands
    there."""
    zz = pools
    part = b"x" * (6 << 20)
    uid = zz.new_multipart_upload("b", "mpu-guard")
    src = zz._zone_index_of_upload("b", "mpu-guard", uid)
    p1 = zz.put_object_part("b", "mpu-guard", uid, 1, part, len(part))
    zz.set_pool_state(src, POOL_DRAINING)
    try:
        part2 = b"y" * (1 << 20)
        zz.put_object_part("b", "mpu-guard", uid, 2, part2, len(part2))
        dst = zz._zone_index_of_upload("b", "mpu-guard", uid)
        assert dst != src
        listed = zz.list_object_parts("b", "mpu-guard", uid)
        assert [p.part_number for p in listed] == [1, 2]
        assert listed[0].etag == p1.etag
    finally:
        zz.set_pool_state(src, POOL_ACTIVE)


def test_mpu_migration_crash_window_converges(pools):
    """A crash between the parts copy and the source abort leaves the
    session in two pools: clients continue on the writable target, a
    re-run copies only what the target lacks, and once the client
    completes the upload the sweep purges the stale source leftover."""
    zz = pools
    part = b"m" * (6 << 20)
    uid = zz.new_multipart_upload("b", "mpu-crash")
    src = zz._zone_index_of_upload("b", "mpu-crash", uid)
    zz.put_object_part("b", "mpu-crash", uid, 1, part, len(part))
    zz.set_pool_state(src, POOL_DRAINING)
    try:
        src_zone = zz.server_sets[src]
        real_abort = src_zone.abort_multipart_upload

        def dying_abort(*a, **kw):
            raise RuntimeError("crash before source abort")

        src_zone.abort_multipart_upload = dying_abort
        with pytest.raises(RuntimeError):
            zz.migrate_upload("b", "mpu-crash", uid, source=src)
        src_zone.abort_multipart_upload = real_abort
        dst = zz._zone_index_of_upload("b", "mpu-crash", uid)
        assert dst != src and zz.topology.can_write(dst)

        newer = b"n" * (6 << 20)
        p1b = zz.put_object_part("b", "mpu-crash", uid, 1, newer,
                                 len(newer))
        assert zz.migrate_upload("b", "mpu-crash", uid,
                                 source=src) == dst
        listed = zz.list_object_parts("b", "mpu-crash", uid)
        assert [(p.part_number, p.etag) for p in listed] == \
            [(1, p1b.etag)]
        with pytest.raises(api_errors.InvalidUploadID):
            zz.server_sets[src].list_object_parts("b", "mpu-crash",
                                                  uid, max_parts=1)

        uid2 = zz.new_multipart_upload("b", "mpu-done")
        s2 = zz._zone_index_of_upload("b", "mpu-done", uid2)
        q1 = zz.put_object_part("b", "mpu-done", uid2, 1, part,
                                len(part))
        if s2 != src:
            zz.set_pool_state(src, POOL_ACTIVE)
            zz.set_pool_state(s2, POOL_DRAINING)
        z2 = zz.server_sets[s2]
        real_abort2 = z2.abort_multipart_upload
        z2.abort_multipart_upload = dying_abort
        with pytest.raises(RuntimeError):
            zz.migrate_upload("b", "mpu-done", uid2, source=s2)
        z2.abort_multipart_upload = real_abort2
        zz.complete_multipart_upload("b", "mpu-done", uid2,
                                     [CompletePart(1, q1.etag)])
        with pytest.raises(api_errors.InvalidUploadID):
            zz.migrate_upload("b", "mpu-done", uid2, source=s2)
        with pytest.raises(api_errors.InvalidUploadID):
            z2.list_object_parts("b", "mpu-done", uid2, max_parts=1)
        assert read(zz, "mpu-done") == part
    finally:
        for i in range(len(zz.server_sets)):
            if zz.topology.state(i) != POOL_ACTIVE:
                zz.set_pool_state(i, POOL_ACTIVE)


# ---------------------------------------------------------------------------
# test_metacache.py / test_tier.py drains, rebound
# ---------------------------------------------------------------------------

def test_rebalance_drains_via_feed(tmp_path):
    """With the metacache attached the walker takes its names from the
    index while moving pool-local versions, and still empties the
    pool."""
    from minio_tpu_torch.object.metacache import (MetacacheManager,
                                                  walks_counter)
    zz = ErasureServerSets([make_zone(tmp_path, "p0"),
                            make_zone(tmp_path, "p1")],
                           load_topology=False)
    zz.make_bucket("b")
    datas = {}
    rng = np.random.default_rng(3)
    for i in range(8):
        data = rng.bytes(256 + i)
        zz.server_sets[0].put_object("b", f"r-{i:02d}", data)
        datas[f"r-{i:02d}"] = data
    mgr = MetacacheManager(zz, staleness_s=0.0, flush_s=0.05)
    mgr.start()
    zz.attach_metacache(mgr)
    try:
        assert mgr.build("b")
        c = walks_counter()
        merge0 = c.value(consumer="rebalance", source="merge")
        index0 = c.value(consumer="rebalance", source="index")
        reb = Rebalancer(zz, 0, busy_fn=lambda: False)
        zz.topology.set_state(0, "draining")
        moved, failed, remaining = reb.run_pass()
        assert failed == 0 and remaining == 0 and moved == 8
        assert zz.server_sets[0].list_object_versions(
            "b", max_keys=10)[0] == []
        for name, data in datas.items():
            assert read(zz, name) == data
        # only the hidden .minio.sys sweep walked; the client bucket
        # drained off the feed
        assert c.value(consumer="rebalance", source="merge") - merge0 <= 1
        assert c.value(consumer="rebalance", source="index") - index0 >= 1
    finally:
        zz.close()


def test_rebalance_moves_transitioned_stub(tmp_path):
    """Decommissioning a pool holding a transitioned stub moves the
    xl.meta pointer (metadata only) into the active pool; the object
    still restores from its unchanged remote copy afterwards."""
    from minio_tpu_torch.storage import datatypes as dt
    from minio_tpu_torch.tier.config import TierConfig, TierManager
    from minio_tpu_torch.tier.transition import (TransitionWorker,
                                                 restore_object)
    zz = ErasureServerSets([make_zone(tmp_path, "p0"),
                            make_zone(tmp_path, "p1")])
    try:
        zz.make_bucket("b")
        tiers = TierManager(zz)
        tiers.add(TierConfig("cold", "fs",
                             {"path": str(tmp_path / "tier")}))
        payload = np.random.default_rng(4).bytes(120_000)
        info = zz.server_sets[0].put_object("b", "stub", payload)
        worker = TransitionWorker(zz, tiers,
                                  busy_fn=lambda: False).start()
        worker.enqueue("b", "stub", "", "cold", etag=info.etag)
        assert worker.drain(30), worker.stats()
        worker.close()
        md = zz.get_object_info("b", "stub").user_defined
        remote_key = md[dt.TRANSITIONED_OBJECT_KEY]

        zz.start_decommission(0, **NEVER_BUSY)
        st = wait_status(zz, "complete")
        assert st["bytes_moved"] == 0        # metadata only
        assert not zz.server_sets[0].has_object_versions("b", "stub")
        assert zz.server_sets[1].has_object_versions("b", "stub")
        with pytest.raises(api_errors.InvalidObjectState):
            zz.get_object("b", "stub")
        assert tiers.client("cold").head(remote_key) == len(payload)
        restore_object(zz, tiers, "b", "stub")
        oi, stream = zz.get_object("b", "stub")
        assert b"".join(stream) == payload
        assert oi.etag == info.etag
    finally:
        zz.close()


# ---------------------------------------------------------------------------
# cross-package: drained trees, checkpoints and sessions
# ---------------------------------------------------------------------------

def pin_pools(monkeypatch):
    """Identity sources of a drain in both packages: one uuid/now counter
    per package shared by its engine and multipart modules (the call
    sequences line up), and fixed clocks for the rebalancer's checkpoint
    stamps and the topology doc's `updated`."""
    for eng, mp, reb, topo in ((ref_engine, ref_multipart, ref_rebalance,
                                ref_topology),
                               (port_engine, port_multipart,
                                port_rebalance, port_topology)):
        p = _Pinned()
        for mod in (eng, mp):
            monkeypatch.setattr(mod, "_uuid", p)
            monkeypatch.setattr(mod, "now", p.now)
        monkeypatch.setattr(reb, "time", p)
        monkeypatch.setattr(topo, "time", p)


def _seed_two_pools(root):
    """The reference writes the seed into pool 0 before pool 1 exists:
    plain objects across the 64 KiB block, a versioned key (v1, marker,
    v2), a completed multipart object, a meta-bucket config object; one
    object already in pool 1."""
    rng = np.random.default_rng(21)
    zz = RefServerSets([ref_zone(root, "p0"), ref_zone(root, "p1")],
                       load_topology=False)
    zz.make_bucket("b")
    data = {}
    z0 = zz.server_sets[0]
    for i, size in enumerate((1, 999, BLOCK, BLOCK + 12_345, 300_001)):
        data[f"o{i}"] = rng.bytes(size)
        z0.put_object("b", f"o{i}", data[f"o{i}"])
    z0.put_object("b", "ver", b"v1", opts=ref_engine.PutOptions(
        versioned=True, version_id=VID1))
    z0.delete_object("b", "ver", versioned=True)
    z0.put_object("b", "ver", b"v2-bytes", opts=ref_engine.PutOptions(
        versioned=True, version_id=VID2))
    data["ver"] = b"v2-bytes"
    up = z0.new_multipart_upload("b", "mp")
    parts = [rng.bytes(5 << 20), rng.bytes(70_001)]
    etags = [z0.put_object_part("b", "mp", up, n + 1, p, len(p)).etag
             for n, p in enumerate(parts)]
    z0.complete_multipart_upload("b", "mp", up, [
        ref_multipart.CompletePart(n + 1, e) for n, e in enumerate(etags)])
    data["mp"] = b"".join(parts)
    z0.put_object(MINIO_META_BUCKET, "config/x.json", b'{"x":1}')
    data["in1"] = rng.bytes(5000)
    zz.server_sets[1].put_object("b", "in1", data["in1"])
    zz.close()
    return data


def _ref_layer(root):
    return RefServerSets([ref_zone(root, "p0"), ref_zone(root, "p1")])


def _port_layer(root):
    return ErasureServerSets([make_zone(root, "p0"), make_zone(root, "p1")])


def _drain(layer, **kw):
    layer.start_decommission(0, checkpoint_every=3, busy_fn=lambda: False,
                             throttle_s=0.001, **kw)
    return wait_status(layer, "complete")


def test_drained_trees_equal_the_references(tmp_path, monkeypatch):
    seed = tmp_path / "seed"
    data = _seed_two_pools(seed)
    pin_pools(monkeypatch)
    shutil.copytree(seed, tmp_path / "ref")
    shutil.copytree(seed, tmp_path / "port")
    ref = _ref_layer(tmp_path / "ref")
    st_ref = _drain(ref)
    ref.close()
    port = _port_layer(tmp_path / "port")
    st_port = _drain(port)
    try:
        drop = ("running",)
        assert {k: v for k, v in st_port.items() if k not in drop} == \
            {k: v for k, v in st_ref.items() if k not in drop}
        assert st_port["objects_moved"] == 8 and \
            st_port["objects_failed"] == 0
        assert drive_files(tmp_path / "port") == \
            drive_files(tmp_path / "ref")
        for name, body in data.items():
            assert read(port, name) == body
        assert port.server_sets[0].list_object_versions("b")[0] == []
    finally:
        port.close()


@pytest.mark.parametrize("first", ["ref", "port"])
def test_checkpoint_resumed_by_the_other_package(tmp_path, first):
    """A drain stopped mid-way by one package leaves its checkpoint in
    pool 1; the other package's rebalancer resumes from that marker and
    completes the drain."""
    data = _seed_two_pools(tmp_path)
    a = _ref_layer(tmp_path) if first == "ref" else _port_layer(tmp_path)
    A = RefRebalancer if first == "ref" else Rebalancer
    a.set_pool_state(0, "draining")
    moves = 0

    def busy():
        nonlocal moves
        moves += 1
        if moves == 4:
            reb.stop()
        return False

    reb = A(a, 0, checkpoint_every=1, busy_fn=busy)
    reb.start()
    deadline = time.monotonic() + 60
    while reb.running() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert reb.status()["status"] == "stopped"
    ckpt = A.load_checkpoint(a, 0)
    a.close()

    b = _port_layer(tmp_path) if first == "ref" else _ref_layer(tmp_path)
    B = Rebalancer if first == "ref" else RefRebalancer
    try:
        assert B.load_checkpoint(b, 0) == ckpt
        assert b.topology.state(0) == "draining"
        assert b.resume_rebalance_if_pending()
        assert b._rebalancer.state.get("resumed")
        assert b._rebalancer.state["marker"] == ckpt["marker"]
        st = wait_status(b, "complete")
        assert st["objects_failed"] == 0
        assert ckpt["objects_moved"] <= st["objects_moved"] <= 9
        assert b.server_sets[0].list_object_versions("b")[0] == []
        for name, body in data.items():
            assert read(b, name) == body
    finally:
        b.close()


@pytest.mark.parametrize("migrator", ["port", "ref"])
def test_session_migrated_by_one_package_completes_under_the_other(
        tmp_path, migrator):
    rng = np.random.default_rng(9)
    part1, part2 = rng.bytes(5 << 20), rng.bytes(123_457)
    seed = _ref_layer(tmp_path)
    seed.make_bucket("b")
    seed.get_available_zone_idx = lambda size: 0
    uid = seed.new_multipart_upload("b", "mp")
    e1 = seed.put_object_part("b", "mp", uid, 1, part1, len(part1)).etag
    seed.set_pool_state(0, "draining")
    seed.close()

    a = _port_layer(tmp_path) if migrator == "port" else _ref_layer(tmp_path)
    try:
        # the second part's write migrates the session to pool 1
        e2 = a.put_object_part("b", "mp", uid, 2, part2, len(part2)).etag
        assert a._zone_index_of_upload("b", "mp", uid) == 1
    finally:
        a.close()
    b = _ref_layer(tmp_path) if migrator == "port" else _port_layer(tmp_path)
    Part = ref_multipart.CompletePart if migrator == "port" else CompletePart
    try:
        assert [p.etag for p in b.list_object_parts("b", "mp", uid)] == \
            [e1, e2]
        info = b.complete_multipart_upload("b", "mp", uid,
                                           [Part(1, e1), Part(2, e2)])
        assert info.etag.endswith("-2")
        assert read(b, "mp") == part1 + part2
        assert not b.server_sets[0].has_object_versions("b", "mp")
    finally:
        b.close()
    c = _port_layer(tmp_path) if migrator == "port" else _ref_layer(tmp_path)
    try:
        assert read(c, "mp") == part1 + part2
    finally:
        c.close()


# ---------------------------------------------------------------------------
# the registry write quorum (utils/regfence.py), held against the reference
# ---------------------------------------------------------------------------

class _StubPool:
    """A pool that stores the topology doc in a dict, or refuses every
    write while partitioned away."""

    def __init__(self, reachable: bool = True):
        self.objs: dict = {}
        self.reachable = reachable

    def put_object(self, _bucket, key, data, **_kw):
        if not self.reachable:
            raise OSError("stub pool partitioned away")
        self.objs[key] = bytes(data)


class _StubLayer:
    def __init__(self, pools):
        self.server_sets = pools


@pytest.mark.parametrize("quorum", [None, "1", "2", "majority", "0", "9",
                                    "junk"])
def test_registry_write_quorum_matches_the_reference(monkeypatch, quorum):
    """MINIO_TPU_REGISTRY_WRITE_QUORUM read by both packages' write_quorum
    and check_write_quorum, and a two-pool topology save with one pool
    partitioned away: the same need, the same refusal text, the same pools
    written."""
    from minio_tpu.utils import regfence as ref_regfence
    from minio_tpu_torch.utils import regfence as port_regfence
    if quorum is None:
        monkeypatch.delenv("MINIO_TPU_REGISTRY_WRITE_QUORUM", raising=False)
    else:
        monkeypatch.setenv("MINIO_TPU_REGISTRY_WRITE_QUORUM", quorum)
    for n in range(1, 5):
        assert port_regfence.write_quorum(n) == ref_regfence.write_quorum(n)
        for landed in range(n + 1):
            got = []
            for rf in (port_regfence, ref_regfence):
                try:
                    rf.check_write_quorum(landed, n, "topology")
                    got.append(None)
                except ValueError as e:
                    got.append(str(e))
            assert got[0] == got[1]
    outcomes = []
    for topo in (port_topology, ref_topology):
        pools = [_StubPool(), _StubPool(reachable=False)]
        tmap = topo.TopologyMap(2, epoch=3)
        try:
            outcomes.append(
                ("landed", topo.TopologyStore.save(_StubLayer(pools), tmap)))
        except (TopologyError, ref_topology.TopologyError) as e:
            outcomes.append(("refused", str(e)))
        outcomes[-1] += (sorted(pools[0].objs), sorted(pools[1].objs))
    assert outcomes[0] == outcomes[1]
    # the reference's default keeps one pool enough; majority of two is 2
    assert outcomes[0][0] == ("refused" if quorum in ("2", "majority", "9")
                              else "landed")
