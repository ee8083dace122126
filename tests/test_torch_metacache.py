"""The port's bucket metacache (minio_tpu_torch/object/metacache.py) and
its listing serve path in object/server_sets.py, held against minio_tpu's.

tests/test_metacache.py's cases rebound to the port (18 of its 19:
test_rebalance_drains_via_feed waits for the port's rebalance.py), each
with its own seeding; then:

  * twin trees (the port's a copy of the one the reference wrote): the
    port's index pages, its merge-walk pages and the reference's index
    pages equal page for page, for objects and versions, with and
    without a delimiter, paged by their markers;
  * an index persisted by either package loaded by the other: manifest,
    segment and version documents equal (generation uuids differ between
    runs, so documents are compared, not segment bytes);
  * the guarded drain: with the drainer held inside its refresh (an Event
    in a wrapped object_versions) a listing with the staleness bound at
    0 holds the acknowledged write on the port; the reference's, under
    the same pause, misses it (kept as the record of the departure).
    With the drainer held after its read, an overwrite or a delete, a
    listing and then the drainer's late install: the port keeps the
    newer read, the reference's index goes back to the old versions.
    A listing waits for a drainer that keeps installing instead of
    re-reading what it claimed.
"""

from __future__ import annotations

import glob
import json
import os
import random
import shutil
import threading
import time

import pytest

import minio_tpu.object.metacache as ref_mc
from minio_tpu.object import PutOptions as RefPutOptions
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu_torch.object import PutOptions, api_errors
from minio_tpu_torch.object import metacache as port_mc
from minio_tpu_torch.object.metacache import (MetacacheManager,
                                              manifest_key, walks_counter)
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.xl_storage import MINIO_META_BUCKET

K, M, NDISKS = 4, 2, 6
BLOCK = 1 << 16


def make_zones(tmp_path, pools=1, tag="p"):
    zz = ErasureServerSets(
        [ErasureSets.from_drives(
            [str(tmp_path / f"{tag}{p}d{j}") for j in range(NDISKS)],
            1, NDISKS, M, block_size=BLOCK, enable_mrf=False,
            device="cpu")
         for p in range(pools)],
        load_topology=False)
    zz.make_bucket("b")
    return zz


@pytest.fixture()
def zz(tmp_path):
    z = make_zones(tmp_path)
    yield z
    z.close()


def attach(zz, start=True, **kw):
    kw.setdefault("staleness_s", 0.0)
    kw.setdefault("flush_s", 0.05)
    mgr = MetacacheManager(zz, **kw)
    if start:
        mgr.start()
    zz.attach_metacache(mgr)
    return mgr


def names_of(page):
    return [o.name for o in page[0]]


def oracle_pages(zz, prefix="", delimiter="", max_keys=1000):
    """(objects, prefixes) union collected by paging with the handler's
    next-marker rule, bypassing the metacache."""
    mc, zz.metacache = zz.metacache, None
    try:
        objs, pfx, marker = [], [], ""
        while True:
            o, p, trunc = zz.list_objects("b", prefix, marker, delimiter,
                                          max_keys)
            objs.extend(x.name for x in o)
            pfx.extend(p)
            if not trunc:
                return objs, sorted(set(pfx))
            if o and (not p or o[-1].name > p[-1]):
                marker = o[-1].name
            elif p:
                marker = p[-1]
            else:
                raise AssertionError("truncated page with no marker")
    finally:
        zz.metacache = mc


# ---------------------------------------------------------------------------
# oracle equivalence
# ---------------------------------------------------------------------------

def test_index_pages_equal_merge_walk_randomized(zz):
    """Randomized interleaving of PUT / DELETE / versioned-delete with
    listings: with staleness bound 0 every index-served page must be
    RESULT-IDENTICAL to the merge-walk page."""
    seed = int(os.environ.get("MINIO_TPU_CHAOS_SEED",
                              str(random.randrange(1 << 30))))
    print(f"MINIO_TPU_CHAOS_SEED={seed}")
    rng = random.Random(seed)
    mgr = attach(zz)
    assert mgr.build("b")
    live: dict[str, bool] = {}          # name -> has versioned writes
    for step in range(120):
        op = rng.random()
        name = f"d{rng.randrange(3)}/o{rng.randrange(40):03d}"
        if op < 0.55:
            versioned = rng.random() < 0.3
            zz.put_object("b", name, b"x" * rng.randrange(1, 64),
                          opts=PutOptions(versioned=versioned))
            live[name] = live.get(name, False) or versioned
        elif op < 0.75 and live:
            victim = rng.choice(sorted(live))
            if live[victim] or rng.random() < 0.5:
                # versioned history only ever deletes via a marker
                zz.delete_object("b", victim, versioned=True)
            else:
                zz.delete_object("b", victim)
            del live[victim]            # hidden from listings either way
        elif op < 0.9:
            prefix = rng.choice(["", "d0/", "d1/", "d"])
            mk = rng.choice([1, 3, 7, 1000])
            got = zz.list_objects("b", prefix, "", "", mk)
            mc, zz.metacache = zz.metacache, None
            try:
                want = zz.list_objects("b", prefix, "", "", mk)
            finally:
                zz.metacache = mc
            assert names_of(got) == names_of(want), (step, prefix, mk)
            assert got[1] == want[1] and got[2] == want[2]
        else:
            got = zz.list_object_versions("b", "", "", rng.choice([2, 5,
                                                                   1000]))
            mc, zz.metacache = zz.metacache, None
            try:
                want = zz.list_object_versions("b", "", "",
                                               len(got[0]) or 1000)
            finally:
                zz.metacache = mc
            assert [(v.name, v.version_id) for v in got[0]] == \
                [(v.name, v.version_id) for v in want[0][:len(got[0])]]
    assert mgr.stats()["serves"] > 0
    assert mgr.stats()["drops"] == 0


def test_index_delimiter_pages_equal_oracle(zz):
    mgr = attach(zz)
    for i in range(30):
        zz.put_object("b", f"a/{i % 3}/k{i:02d}", b"x")
        zz.put_object("b", f"top{i:02d}", b"y")
    assert mgr.build("b")
    for prefix in ("", "a/", "a/1/", "top"):
        for delim in ("", "/"):
            for mk in (1, 2, 5, 1000):
                got = zz.list_objects("b", prefix, "", delim, mk)
                mc, zz.metacache = zz.metacache, None
                try:
                    want = zz.list_objects("b", prefix, "", delim, mk)
                finally:
                    zz.metacache = mc
                assert names_of(got) == names_of(want)
                assert got[1] == want[1] and got[2] == want[2]


def test_index_delimiter_versions_equal_oracle(zz):
    """Delimiter-aware list_object_versions (satellite): rolled-up
    CommonPrefixes from the index must equal the merge-walk oracle
    page-for-page, and paging with the returned markers must replay
    the one-shot listing exactly — prefix entries included."""
    mgr = attach(zz)
    for i in range(18):
        zz.put_object("b", f"a/{i % 3}/k{i:02d}", b"x",
                      opts=PutOptions(versioned=(i % 2 == 0)))
        if i % 4 == 0:
            zz.put_object("b", f"a/{i % 3}/k{i:02d}", b"y",
                          opts=PutOptions(versioned=True))
        zz.put_object("b", f"top{i:02d}", b"z")
    assert mgr.build("b")
    for prefix in ("", "a/", "a/1/", "top"):
        for mk in (1, 2, 5, 1000):
            got = zz.list_object_versions("b", prefix, "", mk, "", "/")
            mc, zz.metacache = zz.metacache, None
            try:
                want = zz.list_object_versions("b", prefix, "", mk,
                                               "", "/")
            finally:
                zz.metacache = mc
            assert [(v.name, v.version_id) for v in got[0]] == \
                [(v.name, v.version_id) for v in want[0]], (prefix, mk)
            assert got[1] == want[1], (prefix, mk)      # CommonPrefixes
            assert got[2:] == want[2:], (prefix, mk)    # markers+trunc
    # paging with delimiter replays the one-shot page exactly
    one_vers, one_pfx, _, _, trunc = zz.list_object_versions(
        "b", "", "", 10000, "", "/")
    assert not trunc and one_pfx == ["a/"]
    for mk in (1, 2, 3, 7):
        vers, pfx, marker, vidm = [], [], "", ""
        while True:
            page, p, nkm, nvm, tr = zz.list_object_versions(
                "b", "", marker, mk, vidm, "/")
            vers.extend((v.name, v.version_id) for v in page)
            pfx.extend(p)
            assert len(page) + len(p) <= mk
            if not tr:
                break
            marker, vidm = nkm, nvm
        assert vers == [(v.name, v.version_id) for v in one_vers], mk
        assert pfx == one_pfx, mk


def test_staleness_bound_delta_becomes_visible(zz):
    """A delta OLDER than the staleness bound must be visible: the
    serve path force-drains the journal instead of cutting a stale
    page. (The daemon is not started, so only the bound enforces
    visibility.)"""
    mgr = attach(zz, staleness_s=0.15, start=False)
    zz.put_object("b", "old", b"x")
    assert mgr.build("b")
    zz.put_object("b", "young", b"y")           # delta sits journaled
    time.sleep(0.3)                             # now older than bound
    page = zz.list_objects("b", "", "", "", 100)
    assert "young" in names_of(page)
    assert mgr.stats()["sync_drains"] >= 1


def test_disabled_flag_restores_merge_walk(zz, monkeypatch):
    mgr = attach(zz)
    zz.put_object("b", "k", b"x")
    assert mgr.build("b")
    assert zz.metacache.serve_list_objects("b", "", "", "", 10) \
        is not None
    monkeypatch.setenv("MINIO_TPU_METACACHE", "off")
    assert zz.metacache.serve_list_objects("b", "", "", "", 10) is None
    assert mgr.namespace_feed("b") is None
    # the listing surface still answers (merge-walk fallback)
    assert names_of(zz.list_objects("b", "", "", "", 10)) == ["k"]


def test_journal_overflow_invalidates_never_lies(zz):
    mgr = attach(zz, journal_max=4, start=False)
    for i in range(4):
        zz.put_object("b", f"seed{i}", b"x")
    assert mgr.build("b")
    assert mgr.drain(5.0)
    for i in range(8):                  # overflow the 4-entry journal
        zz.put_object("b", f"of{i}", b"x")
    assert mgr.stats()["drops"] >= 1
    # invalid index: serves fall back to the (correct) merge-walk
    assert mgr.serve_list_objects("b", "", "", "", 100) is None
    got = names_of(zz.list_objects("b", "", "", "", 100))
    assert [n for n in got if n.startswith("of")] == \
        [f"of{i}" for i in range(8)]
    # reconcile repairs the drift and restores index serving
    mgr._drain_once()
    assert mgr.reconcile("b") >= 0
    assert mgr.serve_list_objects("b", "", "", "", 100) is not None
    assert names_of(zz.list_objects("b", "", "", "", 100)) == got


# ---------------------------------------------------------------------------
# persistence + durability
# ---------------------------------------------------------------------------

def test_persist_load_roundtrip_and_reconcile_drift(zz):
    mgr = attach(zz)
    for i in range(25):
        zz.put_object("b", f"k{i:03d}", b"x",
                      opts=PutOptions(versioned=(i % 5 == 0)))
    assert mgr.build("b")
    mgr._persist("b")
    assert manifest_key("b") in mgr.segment_objects()
    # mutate AFTER the persist: the reloaded index must repair drift
    zz.put_object("b", "post-persist", b"y")
    zz.delete_object("b", "k003")       # k003 is unversioned
    mgr.drain(5.0)

    mgr2 = MetacacheManager(zz, staleness_s=0.0)
    assert mgr2.build("b")              # loads segments, then reconciles
    zz.attach_metacache(mgr2)
    got = names_of(zz.list_objects("b", "", "", "", 1000))
    mc, zz.metacache = zz.metacache, None
    try:
        want = names_of(zz.list_objects("b", "", "", "", 1000))
    finally:
        zz.metacache = mc
    assert got == want
    assert "post-persist" in got and "k003" not in got


def test_segment_survives_drive_kill_and_heals(zz, tmp_path):
    """Kill a drive holding metacache segments: listings stay correct
    (the index reloads through erasure reconstruction), and the heal
    scanner's segment sweep re-protects the index objects."""
    import shutil
    mgr = attach(zz)
    for i in range(20):
        zz.put_object("b", f"k{i:03d}", b"x")
    assert mgr.build("b")
    mgr._persist("b")
    seg_keys = mgr.segment_objects()
    assert len(seg_keys) >= 2

    # kill drive 0 of the pool (it holds shards of every segment)
    dead = tmp_path / "p0d0"
    shutil.rmtree(dead)
    os.makedirs(dead)                   # wiped, like a replaced drive

    # a FRESH manager must still load the persisted index (reads
    # reconstruct around the dead drive) and serve correct listings
    mgr2 = MetacacheManager(zz, staleness_s=0.0)
    assert mgr2.build("b")
    zz.attach_metacache(mgr2)
    got = names_of(zz.list_objects("b", "", "", "", 1000))
    assert got == [f"k{i:03d}" for i in range(20)]

    # DiskMonitor re-admits the wiped drive (formats it for its slot),
    # then the heal scanner's segment sweep rewrites the index shards
    # onto it — the regular bucket walk never visits the meta bucket
    from minio_tpu_torch.object.background import DiskMonitor, HealScanner
    assert DiskMonitor(zz.server_sets[0]).scan_once() >= 1
    healed = HealScanner(zz, tracker=None)._heal_metacache_segments(mgr2)
    assert healed >= len(seg_keys)
    shards = glob.glob(str(dead / MINIO_META_BUCKET / "buckets" / "b"
                           / ".metacache" / "**" / "part.1"),
                       recursive=True)
    assert shards, "healed drive holds no metacache segment shards"


def test_segment_bitrot_never_wrong_listing(zz, tmp_path):
    """Flip bytes in one drive's copy of a metacache segment: the GET
    path reconstructs (bitrot is detected per-shard), so the reloaded
    index stays CORRECT — and when damage exceeds parity the load
    fails closed into a walk rebuild, never a wrong listing."""
    mgr = attach(zz)
    for i in range(15):
        zz.put_object("b", f"k{i:03d}", b"x")
    assert mgr.build("b")
    mgr._persist("b")

    # corrupt every metacache shard file on ONE drive (<= parity)
    hits = 0
    for f in glob.glob(str(tmp_path / "p0d1" / MINIO_META_BUCKET
                           / "buckets" / "b" / ".metacache" / "**"
                           / "part.1"), recursive=True):
        with open(f, "r+b") as fh:
            data = bytearray(fh.read())
            for j in range(0, len(data), 7):
                data[j] ^= 0xFF
            fh.seek(0)
            fh.write(data)
        hits += 1
    assert hits >= 1

    mgr2 = MetacacheManager(zz, staleness_s=0.0)
    assert mgr2.build("b")
    zz.attach_metacache(mgr2)
    assert names_of(zz.list_objects("b", "", "", "", 100)) == \
        [f"k{i:03d}" for i in range(15)]

    # damage beyond parity: the load must FAIL (fall back to a walk
    # rebuild via reconcile), not parse garbage into a wrong listing
    for d in ("p0d2", "p0d3"):
        for f in glob.glob(str(tmp_path / d / MINIO_META_BUCKET
                               / "buckets" / "b" / ".metacache" / "**"
                               / "part.1"), recursive=True):
            with open(f, "r+b") as fh:
                data = bytearray(fh.read())
                for j in range(0, len(data), 7):
                    data[j] ^= 0xFF
                fh.seek(0)
                fh.write(data)
    mgr3 = MetacacheManager(zz, staleness_s=0.0)
    assert mgr3.build("b")              # walk rebuild path
    assert mgr3.stats()["buckets"]["b"]["names"] == 15


def test_persisted_reload_repairs_overwrite_after_overflow(zz):
    """Journal overflow loses an OVERWRITE delta (same name, new
    content): the rebuild must not trust the persisted snapshot's
    version for that name — presence drift alone cannot prove
    freshness, so a build that loads segments stays invalid until the
    immediate reconcile has refreshed every name."""
    mgr = attach(zz, journal_max=3, start=False)
    for i in range(3):
        zz.put_object("b", f"k{i}", b"old")
    assert mgr.build("b")
    assert mgr.drain(5.0)
    mgr._persist("b")

    for i in range(3):                  # fill the journal to its bound
        zz.put_object("b", f"f{i}", b"x")
    zz.put_object("b", "k1", b"the-new-bigger-content")  # delta LOST
    assert mgr.stats()["drops"] >= 1

    assert mgr.build("b")               # persisted load + reconcile
    assert mgr.drain(5.0)
    zz.attach_metacache(mgr)
    page = zz.list_objects("b", "", "", "", 100)
    assert mgr.serves >= 1              # index-served, not fallback
    k1 = next(o for o in page[0] if o.name == "k1")
    assert k1.size == len(b"the-new-bigger-content")


def test_delete_bucket_purges_persisted_index(zz):
    """DELETE bucket removes the persisted manifest + segments from the
    meta bucket — a recreated same-name bucket must not reload (or leak
    artifacts of) the dead incarnation's index."""
    mgr = attach(zz)
    for i in range(5):
        zz.put_object("b", f"old{i}", b"x")
    assert mgr.build("b")
    assert mgr.drain(5.0)
    mgr._persist("b")
    seg_keys = [s["key"] for s in mgr._indexes["b"].segments]
    zz.delete_bucket("b", force=True)
    for key in seg_keys + [manifest_key("b")]:
        with pytest.raises(api_errors.ObjectApiError):
            mgr._get_bytes(key)

    zz.make_bucket("b")
    zz.put_object("b", "fresh", b"y")
    assert mgr.build("b")               # no manifest: walk rebuild
    assert mgr.drain(5.0)
    assert names_of(zz.list_objects("b", "", "", "", 100)) == ["fresh"]


def test_persist_reclaims_superseded_segments(zz, tmp_path):
    """Unreferenced segment objects must not accumulate: a walk-rebuild
    persist reclaims the prior manifest's segments even though the
    fresh index never knew their keys (idx.segments is None)."""
    mgr = attach(zz, start=False)
    for i in range(10):
        zz.put_object("b", f"k{i}", b"x")
    assert mgr.build("b")
    assert mgr.drain(5.0)
    mgr._persist("b")

    def live_seg_dirs():
        return {os.path.basename(p) for p in glob.glob(
            str(tmp_path / "p0d0" / MINIO_META_BUCKET / "buckets" / "b"
                / ".metacache" / "seg-*"))}

    first = live_seg_dirs()
    assert first
    # a fresh manager whose load FAILS (manifest unreadable beyond
    # parity is hard to stage; simplest equivalent: blank segments)
    mgr2 = MetacacheManager(zz, staleness_s=0.0)
    assert mgr2.build("b")
    with mgr2._cond:
        mgr2._indexes["b"].segments = None        # walk-rebuild state
        mgr2._indexes["b"].dirty = {"k0"}
    mgr2._persist("b")
    second = live_seg_dirs()
    assert second and not (first & second), \
        "prior manifest's segment objects leaked"


# ---------------------------------------------------------------------------
# the shared namespace feed
# ---------------------------------------------------------------------------

def test_feed_replaces_scanner_walks(zz):
    """One crawler cycle with the feed attached performs ZERO merge
    walks; detached it walks per consumer — the walk-count metric the
    bench A/B gates on."""
    from minio_tpu_torch.features.lifecycle import iter_version_groups
    from minio_tpu_torch.object.background import DataUsageCrawler

    for i in range(12):
        zz.put_object("b", f"k{i:02d}", b"x",
                      opts=PutOptions(versioned=(i % 3 == 0)))
    c = walks_counter()

    def totals():
        with c._mu:
            items = dict(c._series)
        out = {"merge": 0.0, "index": 0.0}
        for key, v in items.items():
            out[dict(key).get("source", "merge")] += v
        return out

    crawler = DataUsageCrawler(zz, interval=1e9, persist=False)

    def cycle():
        before = totals()
        crawler.scan_once()
        for _ in iter_version_groups(zz, "b", consumer="lifecycle"):
            pass
        for _ in iter_version_groups(zz, "b", consumer="transition"):
            pass
        after = totals()
        return (after["merge"] - before["merge"],
                after["index"] - before["index"])

    merge_walks, index_reads = cycle()      # no metacache attached
    assert merge_walks >= 3 and index_reads == 0

    mgr = attach(zz)
    assert mgr.build("b")
    merge_walks, index_reads = cycle()
    assert merge_walks == 0, merge_walks
    assert index_reads >= 3
    # usage numbers from the feed match the walk
    assert crawler.usage["buckets"]["b"]["objects"] == 12


def test_feed_version_groups_match_listing(zz):
    mgr = attach(zz)
    for i in range(6):
        zz.put_object("b", "multi", b"x" * (i + 1),
                      opts=PutOptions(versioned=True))
    zz.put_object("b", "single", b"y")
    assert mgr.build("b")
    feed = dict(mgr.namespace_feed("b", versions=True))
    assert set(feed) == {"multi", "single"}
    assert len(feed["multi"]) == 6
    mods = [v.mod_time for v in feed["multi"]]
    assert mods == sorted(mods, reverse=True)


# ---------------------------------------------------------------------------
# list_object_versions paging semantics (satellite)
# ---------------------------------------------------------------------------

def test_versions_paging_markers_resume_mid_object(zz):
    """A page boundary inside one key's version list must be marked
    (NextKeyMarker + NextVersionIdMarker) and resumable without loss
    or duplication — the old bare-list form cut silently."""
    for i in range(7):
        zz.put_object("b", "vk", b"x" * (i + 1),
                      opts=PutOptions(versioned=True))
    zz.put_object("b", "aa", b"1")
    zz.put_object("b", "zz", b"2")
    one_shot = [(v.name, v.version_id)
                for v in zz.list_object_versions("b", "", "", 1000)[0]]
    assert len(one_shot) == 9
    for mk in (1, 2, 3, 4, 5):
        got, marker, vidm, rounds = [], "", "", 0
        while True:
            page, _pfx, nkm, nvm, trunc = zz.list_object_versions(
                "b", "", marker, mk, vidm)
            got.extend((v.name, v.version_id) for v in page)
            rounds += 1
            assert rounds < 100
            if not trunc:
                break
            assert nkm and len(page) == mk
            marker, vidm = nkm, nvm
        assert got == one_shot, mk


def test_versions_paging_equivalence_randomized(zz):
    seed = int(os.environ.get("MINIO_TPU_CHAOS_SEED",
                              str(random.randrange(1 << 30))))
    print(f"MINIO_TPU_CHAOS_SEED={seed}")
    rng = random.Random(seed)
    for i in range(40):
        name = f"p{rng.randrange(4)}/k{rng.randrange(12):02d}"
        zz.put_object("b", name, b"x",
                      opts=PutOptions(versioned=rng.random() < 0.5))
        if rng.random() < 0.2:
            zz.delete_object("b", name, versioned=True)
    one_shot = [(v.name, v.version_id)
                for v in zz.list_object_versions("b", "", "", 10000)[0]]
    for mk in (1, 2, 3, 7):
        got, marker, vidm = [], "", ""
        while True:
            page, _pfx, nkm, nvm, trunc = zz.list_object_versions(
                "b", "", marker, mk, vidm)
            got.extend((v.name, v.version_id) for v in page)
            if not trunc:
                break
            marker, vidm = nkm, nvm
        assert got == one_shot, mk


# ---------------------------------------------------------------------------
# list_objects paging equivalence property (satellite)
# ---------------------------------------------------------------------------

def test_list_objects_paging_equivalence_property(zz):
    """Paging a seeded bucket in many small pages (varying max-keys,
    delimiter, marker, prefix) must equal the one-shot listing —
    pinned over the single-homed paginate_objects truncation loop."""
    seed = int(os.environ.get("MINIO_TPU_CHAOS_SEED",
                              str(random.randrange(1 << 30))))
    print(f"MINIO_TPU_CHAOS_SEED={seed}")
    rng = random.Random(seed)
    names = set()
    for i in range(60):
        parts = [rng.choice(["a", "b", "a0", "ab"])
                 for _ in range(rng.randint(1, 3))]
        names.add("/".join(parts) + str(i % 3))
    for n in sorted(names):
        zz.put_object("b", n, b"x",
                      opts=PutOptions(versioned=rng.random() < 0.3))
    for victim in rng.sample(sorted(names), len(names) // 4):
        zz.delete_object("b", victim, versioned=True)  # marker hides it
    for prefix in ("", "a", "a/", "ab/"):
        for delim in ("", "/", "0"):
            want = oracle_pages(zz, prefix, delim, 100000)
            for mk in (1, 2, 3, 5):
                got = oracle_pages(zz, prefix, delim, mk)
                assert got == want, (prefix, delim, mk)


def test_serve_raises_bucket_not_found_like_oracle(zz):
    mgr = attach(zz)
    zz.put_object("b", "k", b"x")
    assert mgr.build("b")
    with pytest.raises(api_errors.BucketNotFound):
        zz.list_objects("nope", "", "", "", 10)
    zz.delete_bucket("b", force=True)
    with pytest.raises(api_errors.BucketNotFound):
        zz.list_objects("b", "", "", "", 10)


# ---------------------------------------------------------------------------
# twin trees: the port's index and walk against the reference's index
# ---------------------------------------------------------------------------

def _ref_zones(root):
    zz = RefServerSets([RefSets.from_drives(
        [str(root / f"d{j}") for j in range(NDISKS)], 1, NDISKS, M,
        block_size=BLOCK, enable_mrf=False)], load_topology=False)
    return zz


def _port_zones(root):
    return ErasureServerSets([ErasureSets.from_drives(
        [str(root / f"d{j}") for j in range(NDISKS)], 1, NDISKS, M,
        block_size=BLOCK, enable_mrf=False, device="cpu")],
        load_topology=False)


def _seed_reference_tree(root, seed=20241017):
    """A bucket the reference wrote: nested prefixes, versioned
    overwrites, delete markers and unversioned deletes."""
    rng = random.Random(seed)
    zz = _ref_zones(root)
    zz.make_bucket("b")
    names = [f"{rng.choice(['', 'd0/', 'd1/', 'd1/x/', 'e'])}"
             f"k{i:03d}" for i in range(70)]
    for i, n in enumerate(names):
        zz.put_object("b", n, bytes([i % 251]) * rng.randrange(1, 40),
                      opts=RefPutOptions(versioned=rng.random() < 0.4))
        if rng.random() < 0.25:
            zz.put_object("b", n, b"v2" * rng.randrange(1, 9),
                          opts=RefPutOptions(versioned=True))
    for n in rng.sample(names, 12):
        zz.delete_object("b", n, versioned=True)
    for n in rng.sample(names, 6):
        try:
            zz.delete_object("b", n)
        except Exception:  # noqa: BLE001 — already gone is fine here
            pass
    zz.close()


def _obj_pages(zz, prefix, delim, mk):
    out, marker = [], ""
    while True:
        objs, pfx, trunc = zz.list_objects("b", prefix, marker, delim, mk)
        out.append(([(o.name, o.version_id, o.size, o.etag, o.mod_time,
                      o.is_latest) for o in objs], pfx, trunc))
        if not trunc:
            return out
        marker = max([o.name for o in objs] + list(pfx))


def _ver_pages(zz, prefix, delim, mk):
    out, marker, vidm = [], "", ""
    while True:
        vers, pfx, nkm, nvm, trunc = zz.list_object_versions(
            "b", prefix, marker, mk, vidm, delim)
        out.append(([(v.name, v.version_id, v.delete_marker, v.size,
                      v.mod_time, v.is_latest) for v in vers], pfx, nkm,
                    nvm, trunc))
        if not trunc:
            return out
        marker, vidm = nkm, nvm


def _walk(zz, fn, *a):
    mc, zz.metacache = zz.metacache, None
    try:
        return fn(zz, *a)
    finally:
        zz.metacache = mc


@pytest.mark.parametrize("delim", ["", "/"])
def test_twin_tree_pages_equal_walk_and_reference(tmp_path, delim):
    _seed_reference_tree(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref, port = _ref_zones(tmp_path / "ref"), _port_zones(tmp_path / "port")
    try:
        rm = ref_mc.MetacacheManager(ref, staleness_s=0.0)
        pm = MetacacheManager(port, staleness_s=0.0)
        ref.attach_metacache(rm)
        port.attach_metacache(pm)
        assert rm.build("b") and pm.build("b")
        for prefix in ("", "d1/", "d1/x", "e", "d"):
            for mk in (1, 3, 7, 1000):
                got = _obj_pages(port, prefix, delim, mk)
                assert got == _walk(port, _obj_pages, prefix, delim, mk)
                assert got == _obj_pages(ref, prefix, delim, mk), \
                    (prefix, mk)
                vgot = _ver_pages(port, prefix, delim, mk)
                assert vgot == _walk(port, _ver_pages, prefix, delim, mk)
                assert vgot == _ver_pages(ref, prefix, delim, mk), \
                    (prefix, mk)
        assert pm.stats()["fallbacks"] == 0 and pm.serves > 0
        assert rm.stats()["fallbacks"] == 0
    finally:
        ref.close()
        port.close()


# ---------------------------------------------------------------------------
# an index persisted by either package, loaded by the other
# ---------------------------------------------------------------------------

def _docs(mod, idx):
    return {n: [mod._oi_to_doc(o) for o in vers]
            for n, vers in idx.entries.items()}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_persisted_index_loads_across_packages(tmp_path, writer):
    _seed_reference_tree(tmp_path / "t")
    mods = {"ref": ref_mc, "port": port_mc}
    opens = {"ref": _ref_zones, "port": _port_zones}
    reader = "port" if writer == "ref" else "ref"
    zw = opens[writer](tmp_path / "t")
    try:
        mw = mods[writer].MetacacheManager(zw, staleness_s=0.0,
                                           segment_keys=16)
        assert mw.build("b")
        mw._persist("b")
        want = _docs(mods[writer], mw._indexes["b"])
        manifest = json.loads(mw._get_bytes(manifest_key("b")))
        segs = [json.loads(mw._get_bytes(s["key"]))
                for s in manifest["segments"]]
    finally:
        zw.close()
    assert len(manifest["segments"]) >= 3
    zr = opens[reader](tmp_path / "t")
    try:
        mr = mods[reader].MetacacheManager(zr, staleness_s=0.0,
                                           segment_keys=16)
        idx = mods[reader]._BucketIndex("b")
        assert mr._load_persisted("b", idx)
        assert _docs(mods[reader], idx) == want
        assert idx.segments == manifest["segments"]
        assert idx.gen == manifest["gen"] == 1
        # the reader persists the same documents under its own keys
        mr.build("b")
        with mr._cond:
            mr._indexes["b"].segments = None
            mr._indexes["b"].dirty = set(mr._indexes["b"].names)
        mr._persist("b")
        again = json.loads(mr._get_bytes(manifest_key("b")))
        assert set(again) == set(manifest) == {
            "format", "bucket", "gen", "updated", "count", "segments"}
        assert again["count"] == manifest["count"]
        assert [(s["first"], s["count"]) for s in again["segments"]] == \
            [(s["first"], s["count"]) for s in manifest["segments"]]
        assert [json.loads(mr._get_bytes(s["key"]))
                for s in again["segments"]] == segs
        # and serves the loaded index like its own
        zr.attach_metacache(mr)
        assert _obj_pages(zr, "", "", 1000) == \
            _walk(zr, _obj_pages, "", "", 1000)
    finally:
        zr.close()


# ---------------------------------------------------------------------------
# the guarded drain (a departure from the reference)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["port", "ref"])
def test_listing_holds_write_claimed_by_a_stalled_drainer(tmp_path, which):
    """The drainer claims the journaled name and stalls inside its
    refresh (object_versions blocks on an Event for the drainer's thread
    only); a listing with the staleness bound at 0 then runs. The port's
    page holds the acknowledged write. The reference's drainer popped the
    name from the journal, so its page is cut without it: that half is
    the record of the reference's hole."""
    if which == "port":
        zz, mod, opts = make_zones(tmp_path), port_mc, PutOptions
    else:
        zz = _ref_zones(tmp_path)
        zz.make_bucket("b")
        mod, opts = ref_mc, RefPutOptions
    try:
        mgr = mod.MetacacheManager(zz, staleness_s=0.0)
        zz.attach_metacache(mgr)
        zz.put_object("b", "seed", b"x", opts=opts())
        assert mgr.build("b")
        entered, release = threading.Event(), threading.Event()
        real = zz.object_versions

        def held(bucket, name):
            if threading.current_thread().name == "drainer":
                entered.set()
                assert release.wait(30)
            return real(bucket, name)
        zz.object_versions = held
        zz.put_object("b", "fresh", b"acked", opts=opts())
        drainer = threading.Thread(target=mgr._drain_once, name="drainer")
        drainer.start()
        try:
            assert entered.wait(30)
            names = [o.name for o in
                     zz.list_objects("b", "", "", "", 100)[0]]
            serves = mgr.serves
        finally:
            release.set()
            drainer.join(30)
        assert serves == 1                   # cut from the index
        if which == "port":
            assert names == ["fresh", "seed"]
            assert mgr.stats()["inflight"] == 0
        else:
            assert names == ["seed"]         # the acked write is missing
        # once the drainer installs, both agree
        assert [o.name for o in zz.list_objects("b", "", "", "", 100)[0]] \
            == ["fresh", "seed"]
    finally:
        zz.close()


@pytest.mark.parametrize("op", ["overwrite", "delete"])
@pytest.mark.parametrize("which", ["port", "ref"])
def test_late_install_of_an_older_read_is_dropped(tmp_path, which, op):
    """The drainer reads N (V1) and is held before it installs. N is
    then overwritten or deleted (W2, acknowledged and journaled), and a
    listing at bound 0 refreshes N itself (V2) and serves it. The
    drainer's install of V1 comes last. The port's read tickets drop
    it, so the next listing still holds W2. The reference installs V1:
    its index has lost W2, with nothing journaled or in flight for N
    (kept as the record of the departure)."""
    if which == "port":
        zz, mod, opts = make_zones(tmp_path), port_mc, PutOptions
    else:
        zz = _ref_zones(tmp_path)
        zz.make_bucket("b")
        mod, opts = ref_mc, RefPutOptions
    try:
        mgr = mod.MetacacheManager(zz, staleness_s=0.0)
        zz.attach_metacache(mgr)
        zz.put_object("b", "seed", b"x", opts=opts())
        assert mgr.build("b")
        mgr._drain_once()                   # the seed's delta
        zz.put_object("b", "n", b"v1", opts=opts())
        entered, release = threading.Event(), threading.Event()
        real = zz.object_versions

        def held(bucket, name):
            vers = real(bucket, name)
            if threading.current_thread().name == "drainer":
                assert name == "n"
                entered.set()
                assert release.wait(30)
            return vers
        zz.object_versions = held
        drainer = threading.Thread(target=mgr._drain_once, name="drainer")
        drainer.start()
        try:
            assert entered.wait(30)
            if op == "overwrite":
                zz.put_object("b", "n", b"v2-longer", opts=opts())
                want = [("n", 9), ("seed", 1)]
            else:
                zz.delete_object("b", "n")
                want = [("seed", 1)]
            first = [(o.name, o.size) for o in
                     zz.list_objects("b", "", "", "", 100)[0]]
        finally:
            release.set()
            drainer.join(30)
        assert first == want
        assert mgr.stats()["pending"] == 0
        after = [(o.name, o.size) for o in
                 zz.list_objects("b", "", "", "", 100)[0]]
        assert mgr.serves == 2
        if which == "port":
            assert after == want
            assert mgr.stats()["inflight"] == 0
        else:
            # W2 lost: the old object is back, or stays at its old size
            assert after == [("n", 2), ("seed", 1)]
    finally:
        zz.close()


def test_listing_waits_for_a_drainer_that_installs(tmp_path, monkeypatch):
    """A listing at bound 0 finds the journaled name claimed by a drainer
    whose read is held. While the drainer is only slow (the stall limit
    is not reached), the listing waits for its install and does not read
    the name a second time; the page holds the write."""
    monkeypatch.setattr(port_mc, "_STALL_S", 30.0)
    zz = make_zones(tmp_path)
    try:
        mgr = MetacacheManager(zz, staleness_s=0.0)
        zz.attach_metacache(mgr)
        zz.put_object("b", "seed", b"x")
        assert mgr.build("b")
        mgr._drain_once()                   # the seed's delta
        entered, release = threading.Event(), threading.Event()
        real, readers = zz.object_versions, []

        def held(bucket, name):
            readers.append((threading.current_thread().name, name))
            if threading.current_thread().name == "drainer":
                entered.set()
                assert release.wait(30)
            return real(bucket, name)
        zz.object_versions = held
        zz.put_object("b", "fresh", b"acked")
        drainer = threading.Thread(target=mgr._drain_once, name="drainer")
        drainer.start()
        page = []
        lister = threading.Thread(
            target=lambda: page.extend(
                zz.list_objects("b", "", "", "", 100)[0]), name="lister")
        try:
            assert entered.wait(30)
            lister.start()
            deadline = time.monotonic() + 30
            while mgr.sync_drains == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert mgr.sync_drains == 1 and lister.is_alive()
        finally:
            release.set()
            drainer.join(30)
            lister.join(30)
        assert [o.name for o in page] == ["fresh", "seed"]
        assert readers == [("drainer", "fresh")]
        assert mgr.stats()["inflight"] == 0
    finally:
        zz.close()
