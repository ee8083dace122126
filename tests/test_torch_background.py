"""The port's background plane (minio_tpu_torch/object/background.py and
update_tracker.py) held against minio_tpu's.

tests/test_background.py's cases (a wiped drive reformatted and swept, a
dead boot slot re-admitted, a foreign drive never adopted, the usage
crawler and quota from its cache) and tests/test_update_tracker.py's six
(marks and cycles, history expiry failing open, persistence across a
restart, the heal scanner's pruning, mutations marking the tracker
through a live server, peer snapshots) rebound to the port; then, on twin
trees minio_tpu wrote:

  * the same drive wiped in both, one scan_once of each package's
    DiskMonitor: every file of every drive equal (the port's sweep runs
    its fused heal step's plain version, the codec's gate lowered);
  * a foreign drive in the same slot of both: neither adopts it;
  * the hinted heal scanner over the same damage and the same marks:
    checked, healed, scanned and skipped-bucket counts equal, and equal
    drive files;
  * the crawler's usage document (its clock pinned) equal, the persisted
    snapshots equal, and QuotaExceeded from its cache in both handlers;
  * the tracker's file written by either package read by the other.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

import minio_tpu.object.background as ref_bg
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.object.update_tracker import \
    DataUpdateTracker as RefTracker
from minio_tpu_torch.object import background as bg
from minio_tpu_torch.object import codec, healing
from minio_tpu_torch.object.background import (DataUsageCrawler,
                                               DiskMonitor, HealScanner)
from minio_tpu_torch.object.metacache import walks_counter
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.update_tracker import (DataUpdateTracker,
                                                   TrackerSnapshot)
from minio_tpu_torch.storage.xl_storage import XLStorage

BS = 1 << 14


def _mk_sets(root, n=6, parity=2, **kw):
    drives = [str(root / f"d{i}") for i in range(n)]
    sets = ErasureSets.from_drives(drives, set_count=1, set_drive_count=n,
                                   parity=parity, block_size=1 << 16,
                                   device="cpu", **kw)
    return sets, drives


def make_engine(tmp_path, n=6, k=4, m=2):
    """The port's counterpart of tests/test_engine.make_engine."""
    from minio_tpu_torch.object import open_erasure_set
    return open_erasure_set([str(tmp_path / f"d{j}") for j in range(n)],
                            k, m, block_size=1 << 16, device="cpu")


# -- tests/test_background.py, rebound ---------------------------------------

def test_wiped_drive_is_reformatted_and_swept(tmp_path):
    sets, drives = _mk_sets(tmp_path)
    sets.make_bucket("b")
    payload = os.urandom(150_000)
    sets.put_object("b", "obj", payload)
    sets.put_object("b", "obj2", b"x" * 1000)

    # wipe one drive entirely (format.json + shards gone)
    victim_idx = 2
    shutil.rmtree(drives[victim_idx])

    mon = DiskMonitor(sets)
    admitted = mon.scan_once()
    assert admitted == 1
    assert mon.healed_slots  # a fresh drive was formatted + swept

    # the wiped drive holds a valid format again, in the right slot
    d = XLStorage(drives[victim_idx])
    fmt = d.read_format()
    assert fmt.id == sets.deployment_id
    assert fmt.this in [u for row in sets.format_ref.sets for u in row]

    # its shards were rebuilt
    names = d.list_dir("b", "obj")
    assert any("xl.meta" in n or n for n in names)
    _, stream = sets.get_object("b", "obj")
    assert b"".join(stream) == payload

    # second scan: steady state, nothing to admit
    assert mon.scan_once() == 0
    sets.close()


def test_dead_boot_slot_readmitted(tmp_path):
    # one root is a regular FILE: XLStorage(root) fails -> None slot
    bad = tmp_path / "d3"
    bad.write_bytes(b"not a dir")
    sets, drives = _mk_sets(tmp_path)
    assert sets.sets[0].disks.count(None) == 1
    sets.make_bucket("b")
    sets.put_object("b", "k", b"hello world" * 100)

    # the operator replaces the broken "drive"
    bad.unlink()
    mon = DiskMonitor(sets)
    assert mon.scan_once() == 1
    assert sets.sets[0].disks.count(None) == 0

    # healed: data now lands on all 6 drives
    _, stream = sets.get_object("b", "k")
    assert b"".join(stream) == b"hello world" * 100
    sets.close()


def test_monitor_never_adopts_foreign_drive(tmp_path):
    sets, drives = _mk_sets(tmp_path / "a")
    other, _ = _mk_sets(tmp_path / "b")
    # swap a drive of `sets` for one formatted by the OTHER deployment
    victim = 1
    shutil.rmtree(drives[victim])
    shutil.copytree(str((tmp_path / "b") / "d0"), drives[victim])
    mon = DiskMonitor(sets)
    assert mon.scan_once() == 0          # wrong deployment: not adopted
    sets.close()
    other.close()


def test_usage_crawler_and_quota(tmp_path):
    sets, _ = _mk_sets(tmp_path)
    sets.make_bucket("q1")
    sets.make_bucket("q2")
    sets.put_object("q1", "a", b"x" * 10_000)
    sets.put_object("q1", "b", b"y" * 5_000)
    sets.put_object("q2", "c", b"z" * 1_000)

    crawler = DataUsageCrawler(sets, persist=True)
    usage = crawler.scan_once()
    assert usage["buckets"]["q1"] == {"objects": 2, "size": 15_000}
    assert usage["buckets"]["q2"] == {"objects": 1, "size": 1_000}
    assert crawler.bucket_usage("q1") == 15_000
    assert crawler.bucket_usage("missing") == 0

    # snapshot persisted through the object layer
    snap = DataUsageCrawler.load_snapshot(sets)
    assert snap is not None and snap["size_total"] == 16_000

    # per-object actions fire for every object
    seen = []
    crawler.actions.append(lambda b, oi: seen.append((b, oi.name)))
    crawler.scan_once()
    assert ("q1", "a") in seen and ("q2", "c") in seen
    sets.close()


def test_quota_enforced_from_crawler_cache(tmp_path):
    from minio_tpu_torch.s3.handlers import S3ApiHandlers
    from minio_tpu_torch.s3.s3errors import S3Error
    sets, _ = _mk_sets(tmp_path)
    sets.make_bucket("qb")
    sets.put_object("qb", "base", b"d" * 8_000)
    api = S3ApiHandlers(sets)
    api.bucket_meta.update("qb", quota={"quota": 10000,
                                        "quotatype": "hard"})
    crawler = DataUsageCrawler(sets, persist=False)
    crawler.scan_once()
    api.usage = crawler

    api._enforce_quota("qb", 1_000)      # 8k + 1k < 10k: fine
    with pytest.raises(S3Error):
        api._enforce_quota("qb", 5_000)  # 8k + 5k > 10k
    sets.close()


# -- tests/test_update_tracker.py, rebound -----------------------------------

def test_tracker_mark_and_cycles(tmp_path):
    t = DataUpdateTracker(str(tmp_path / "t.bin"))
    t.mark("bkt", "obj1")
    # current cycle content is visible at any since <= cycle
    assert t.changed_since(1, "bkt", "obj1")
    assert t.changed_since(1, "bkt")             # bucket-level mark
    assert not t.changed_since(1, "bkt", "other")
    assert not t.changed_since(1, "coldbkt")

    c2 = t.advance_cycle()
    assert c2 == 2
    # rotated history still answers for since=1
    assert t.changed_since(1, "bkt", "obj1")
    # but a scanner starting at cycle 2 sees nothing changed
    assert not t.changed_since(2, "bkt", "obj1")
    t.mark("bkt", "obj2")
    assert t.changed_since(2, "bkt", "obj2")


def test_tracker_history_expiry_fails_open():
    t = DataUpdateTracker()
    for _ in range(20):
        t.advance_cycle()
    # asking about a cycle older than the kept history => "changed"
    assert t.changed_since(1, "anything")
    assert t.changed_since(0, "anything")


def test_tracker_persistence_across_restart(tmp_path):
    p = str(tmp_path / "t.bin")
    t1 = DataUpdateTracker(p)
    t1.mark("bkt", "persisted")
    t1.advance_cycle()                 # rotation persists
    t2 = DataUpdateTracker(p)
    assert t2.current_cycle() == 2
    assert t2.changed_since(1, "bkt", "persisted")
    assert not t2.changed_since(2, "bkt", "persisted")


def test_heal_scanner_prunes_unchanged(tmp_path):
    """Pass 1 heals everything (no history); pass 2 with no mutations
    skips every bucket; a mutation re-includes exactly its bucket."""
    eng = make_engine(tmp_path)
    eng.make_bucket("hot")
    eng.make_bucket("cold")
    eng.put_object("hot", "h1", b"x" * 100)
    eng.put_object("cold", "c1", b"y" * 100)

    tracker = DataUpdateTracker()
    scanner = HealScanner(eng, tracker, interval=3600)

    assert scanner.scan_once() == 2          # full first pass
    assert scanner.skipped_buckets == 0

    assert scanner.scan_once() == 0          # nothing changed
    assert scanner.skipped_buckets == 2

    tracker.mark("hot", "h1")                # the mutation funnel's job
    assert scanner.scan_once() == 1          # only hot/h1 rechecked
    assert scanner.skipped_buckets == 3      # cold skipped again


def test_mutations_feed_tracker_through_live_server(tmp_path):
    """The S3 mutation funnel marks the tracker (the handlers' _mark):
    PUT, copy, DELETE, bulk delete and a bucket's creation; reads do
    not."""
    from minio_tpu_torch.s3.server import S3Server
    from tests.test_s3 import CREDS, REGION, S3TestClient
    drives = [str(tmp_path / f"d{i}") for i in range(4)]
    sets = ErasureSets.from_drives(drives, set_count=1,
                                   set_drive_count=4, parity=2,
                                   block_size=1 << 16, device="cpu")
    srv = S3Server(sets, creds=CREDS, region=REGION).start()
    try:
        tracker = DataUpdateTracker()
        srv.api.update_tracker = tracker
        c = S3TestClient("127.0.0.1", srv.port)
        assert c.request("PUT", "/trkbkt")[0] == 200
        assert tracker.changed_since(1, "trkbkt")
        assert c.request("PUT", "/trkbkt/obj", body=b"t")[0] == 200
        assert tracker.changed_since(1, "trkbkt", "obj")
        assert not tracker.changed_since(1, "trkbkt", "untouched")
        # reads do NOT mark
        c.request("GET", "/trkbkt/obj")
        c.request("HEAD", "/trkbkt/obj-read")
        assert not tracker.changed_since(1, "trkbkt", "obj-read")
        assert c.request("PUT", "/trkbkt/cp", headers={
            "x-amz-copy-source": "/trkbkt/obj"})[0] == 200
        assert c.request("DELETE", "/trkbkt/gone")[0] == 204
        assert c.request("POST", "/trkbkt", query={"delete": ""},
                         body=b"<Delete><Object><Key>obj</Key></Object>"
                         b"</Delete>")[0] == 200
        for key in ("cp", "gone", "obj"):
            assert tracker.changed_since(1, "trkbkt", key), key
    finally:
        srv.stop()
        sets.close()


def test_heal_scanner_sees_peer_mutations(tmp_path):
    """Mutations through ANOTHER node's funnel (its own tracker) are not
    pruned by the scanner: it pulls rotated peer snapshots each pass."""
    eng = make_engine(tmp_path)
    eng.make_bucket("shared")
    eng.put_object("shared", "o1", b"x" * 64)

    local = DataUpdateTracker()
    peer = DataUpdateTracker()          # another node's tracker
    scanner = HealScanner(
        eng, local, interval=3600,
        peer_snapshots=lambda: [peer.rotate_snapshot()])

    assert scanner.scan_once() == 1     # full first pass
    assert scanner.scan_once() == 0     # nothing changed anywhere

    peer.mark("shared", "o1")           # mutation via the OTHER node
    assert scanner.scan_once() == 1     # seen through the snapshot
    assert scanner.scan_once() == 0     # consumed; pruned again

    # unreachable peer => no pruning that pass (fail open)
    down = HealScanner(eng, DataUpdateTracker(), interval=3600,
                       peer_snapshots=lambda: [None])
    assert down.scan_once() == 1
    assert down.scan_once() == 1        # still full: peer unknown


# -- twin trees -------------------------------------------------------------

SIZES = {"empty": 0, "small": 1000, "one": BS, "multi": 5 * BS + 123,
         "groups": 11 * BS + 7}


@pytest.fixture
def small_gate(monkeypatch):
    """The port codec's size gate lowered so that the sweep's recover
    groups run the fused heal step (its plain version on the host)."""
    monkeypatch.setattr(codec, "DEVICE_MIN_BYTES", 1024)
    monkeypatch.setattr(healing, "HEAL_BATCH_BLOCKS", 4)


def _merge_walks(consumer):
    """The port's merge walks so far by `consumer` (its scanners count
    them on the namespace walks counter)."""
    return walks_counter().value(consumer=consumer, source="merge")


def _twin_trees(tmp_path, n=6, parity=2, seed=3):
    """Two byte-equal copies of a set minio_tpu wrote (two buckets, objects
    of every shape); their roots."""
    src = tmp_path / "src"
    paths = [str(src / f"d{i}") for i in range(n)]
    rng = np.random.default_rng(seed)
    ref = RefSets.from_drives(paths, set_count=1, set_drive_count=n,
                              parity=parity, block_size=BS)
    try:
        for bucket in ("b1", "b2"):
            ref.make_bucket(bucket)
            for name, size in SIZES.items():
                ref.put_object(bucket, f"{name}-{bucket}", rng.bytes(size))
    finally:
        ref.close()
    roots = []
    for who in ("ref", "port"):
        shutil.copytree(src, tmp_path / who)
        roots.append(tmp_path / who)
    return roots


def _open(root, who, n=6, parity=2):
    drives = [str(root / f"d{i}") for i in range(n)]
    if who == "ref":
        return RefSets.from_drives(drives, set_count=1, set_drive_count=n,
                                   parity=parity, block_size=BS,
                                   enable_mrf=False)
    return ErasureSets.from_drives(drives, set_count=1, set_drive_count=n,
                                   parity=parity, block_size=BS,
                                   device="cpu", enable_mrf=False)


def _tree(root) -> dict:
    """relative path -> bytes of every file, tmp staging left out."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if "/tmp/" in rel:
                continue
            with open(p, "rb") as fh:
                out[rel] = fh.read()
    return out


def test_wiped_drive_sweep_equals_reference(tmp_path, small_gate,
                                            monkeypatch):
    from minio_tpu_torch.models import pipeline
    roots = _twin_trees(tmp_path)
    before = _tree(roots[0] / "d2")
    calls = []
    real = pipeline.heal_step

    def spy(survivors, *a, **kw):
        calls.append(tuple(survivors.shape))
        return real(survivors, *a, **kw)
    monkeypatch.setattr(pipeline, "heal_step", spy)
    sets = {who: _open(root, who) for who, root in zip(("ref", "port"),
                                                       roots)}
    try:
        for root in roots:
            shutil.rmtree(root / "d2")
        counts = {}
        for who, mod in (("ref", ref_bg), ("port", bg)):
            mon = mod.DiskMonitor(sets[who])
            counts[who] = (mon.scan_once(), list(mon.healed_slots),
                           mon.scan_once())
        assert counts["port"] == counts["ref"] == (1, [(0, 2)], 0)
    finally:
        for s in sets.values():
            s.close()
    want, got = _tree(roots[0]), _tree(roots[1])
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k] != got[k]] == []
    # the healed drive holds every shard and journal it held before
    after = _tree(roots[1] / "d2")
    assert {k: v for k, v in after.items() if k in before} == before
    # the sweep's full-block groups ran the fused heal step
    assert (4, 4, BS // 4) in calls


def test_foreign_drive_is_adopted_by_neither(tmp_path):
    roots = _twin_trees(tmp_path)
    other, _ = _mk_sets(tmp_path / "other")
    other.close()
    sets = {who: _open(root, who) for who, root in zip(("ref", "port"),
                                                       roots)}
    try:
        for root in roots:
            shutil.rmtree(root / "d4")
            shutil.copytree(tmp_path / "other" / "d0", root / "d4")
        for who, mod in (("ref", ref_bg), ("port", bg)):
            mon = mod.DiskMonitor(sets[who])
            assert mon.scan_once() == 0 and mon.healed_slots == [], who
    finally:
        for s in sets.values():
            s.close()
    # the foreign drive is untouched in both
    assert _tree(roots[0] / "d4") == _tree(roots[1] / "d4") == \
        _tree(tmp_path / "other" / "d0")


def test_heal_scanner_counts_equal_reference(tmp_path, small_gate):
    """The same damage (one object's shard directory gone on a drive, a
    whole bucket's on another) and the same marks: each pass of either
    package's scanner checks, heals and skips alike and leaves the same
    files."""
    roots = _twin_trees(tmp_path)
    sets = {who: _open(root, who) for who, root in zip(("ref", "port"),
                                                       roots)}
    trackers = {"ref": RefTracker(), "port": DataUpdateTracker()}
    scanners = {"ref": ref_bg.HealScanner(sets["ref"], trackers["ref"]),
                "port": HealScanner(sets["port"], trackers["port"])}
    walks0 = _merge_walks("heal")

    def damage(rel):
        for root in roots:
            shutil.rmtree(root / rel)

    def one_pass():
        out = {}
        for who, sc in scanners.items():
            checked = sc.scan_once()
            out[who] = (checked, sc.healed, sc.scanned, sc.skipped_buckets)
        assert out["port"] == out["ref"], out
        return out["port"]

    try:
        damage("d1/b1/multi-b1")
        assert one_pass() == (10, 1, 10, 0)          # full first pass
        assert one_pass() == (0, 1, 10, 2)           # nothing marked
        damage("d3/b2/groups-b2")
        damage("d0/b2/small-b2")
        for t in trackers.values():
            t.mark("b2", "groups-b2")
        # only the marked object is checked; b1 is pruned outright, and
        # the unmarked damage waits for a mark or a full pass
        assert one_pass() == (1, 2, 11, 3)
        assert _merge_walks("heal") - walks0 == 2 + 1
    finally:
        for s in sets.values():
            s.close()
    want, got = _tree(roots[0]), _tree(roots[1])
    assert [k for k in set(want) | set(got)
            if want.get(k) != got.get(k)] == []
    assert not os.path.exists(roots[1] / "d0" / "b2" / "small-b2")


def test_crawler_usage_equals_reference(tmp_path, monkeypatch):
    class _Clock:
        @staticmethod
        def time():
            return 1.7e9

        monotonic = staticmethod(lambda: 0.0)
    monkeypatch.setattr(ref_bg, "time", _Clock)
    monkeypatch.setattr(bg, "time", _Clock)
    roots = _twin_trees(tmp_path)
    sets = {who: _open(root, who) for who, root in zip(("ref", "port"),
                                                       roots)}
    try:
        crawlers = {"ref": ref_bg.DataUsageCrawler(sets["ref"]),
                    "port": DataUsageCrawler(sets["port"])}
        walks0 = _merge_walks("crawler")
        docs = {who: c.scan_once() for who, c in crawlers.items()}
        assert docs["port"] == docs["ref"]
        assert docs["port"]["buckets"]["b1"] == {
            "objects": len(SIZES), "size": sum(SIZES.values())}
        assert docs["port"]["last_update"] == 1.7e9
        # persisted through each object layer, read back by either
        assert DataUsageCrawler.load_snapshot(sets["port"]) == \
            ref_bg.DataUsageCrawler.load_snapshot(sets["ref"]) == \
            ref_bg.DataUsageCrawler.load_snapshot(sets["port"]) == \
            docs["ref"]
        assert _merge_walks("crawler") - walks0 == 2
        # quota from the cache: both handlers refuse past it, and a write
        # since the crawl is not counted until the next one
        from minio_tpu.s3.handlers import S3ApiHandlers as RefApi
        from minio_tpu.s3.s3errors import S3Error as RefError
        from minio_tpu_torch.s3.handlers import S3ApiHandlers
        from minio_tpu_torch.s3.s3errors import S3Error
        limit = sum(SIZES.values()) + 100
        for who, api_cls, err in (("ref", RefApi, RefError),
                                  ("port", S3ApiHandlers, S3Error)):
            api = api_cls(sets[who])
            api.bucket_meta.update("b1", quota={"quota": limit,
                                                "quotatype": "hard"})
            api.usage = crawlers[who]
            api._enforce_quota("b1", 100)
            sets[who].put_object("b1", "late", b"z" * 5000)
            api._enforce_quota("b1", 100)
            with pytest.raises(err) as e:
                api._enforce_quota("b1", 101)
            assert e.value.code == "QuotaExceeded"
            crawlers[who].scan_once()
            with pytest.raises(err):
                api._enforce_quota("b1", 1)
    finally:
        for s in sets.values():
            s.close()


def test_tracker_files_cross_packages(tmp_path):
    for writer, reader in ((DataUpdateTracker, RefTracker),
                           (RefTracker, DataUpdateTracker)):
        p = str(tmp_path / f"{writer.__module__}.bin")
        t = writer(p)
        t.mark("bkt", "a")
        t.advance_cycle()
        t.mark("bkt", "b")
        t.advance_cycle()
        t.flush()
        r = reader(p)
        assert r.current_cycle() == 3
        assert r.changed_since(1, "bkt", "a")
        assert not r.changed_since(2, "bkt", "a")
        assert r.changed_since(2, "bkt", "b")
        assert not r.changed_since(1, "bkt", "c")
    a, b = DataUpdateTracker(), RefTracker()
    for t in (a, b):
        t.mark("x", "y")
    snap_a, snap_b = a.rotate_snapshot(), b.rotate_snapshot()
    assert snap_a == snap_b
    assert TrackerSnapshot(snap_b).changed_since(1, "x", "y")
