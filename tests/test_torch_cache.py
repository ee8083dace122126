"""The port's hot-object read cache (minio_tpu_torch/object/cache.py)
held against minio_tpu's.

tests/test_disk_cache.py's cases rebound to the port (all 13, the
tiering case over the port's tier plane): range entries, streamed fills at bounded memory, frame-by-frame
verification, the watermark LRU, the hit that skips the erasure decode
(a flat minio_tpu_erasure_get_streams_total), admission by frequency,
eviction off the namespace feed, a bitrot frame falling back. The cases
the reference runs over FSObjects (not ported) run over a 2+2 erasure
set whose feed is not wired to the cache, so their writes bypass the
wrapper as FSObjects' do. Then:

  * the guarded hit: an overwrite lands mid-stream and a later frame
    fails its check; the port's hit aborts instead of splicing, and the
    reference's _serve_hit, under the same schedule, splices the new
    object's bytes into the old response (the record of the departure);
  * entries of either package equal: the same fills leave the same meta
    documents and frame files;
  * a booted node with MINIO_TPU_CACHE=on and compression on: plain,
    SSE-S3, SSE-C and compressed objects, whole and ranged, HEADs and
    Selects answer the same statuses, headers and bodies on a miss, an
    admitted fill and a hit; the hits read no erasure stream.
"""

from __future__ import annotations

import base64
import json
import os
import random
import subprocess
import sys
import time

import pytest

from minio_tpu_torch.object import api_errors
from minio_tpu_torch.object.cache import AccessTracker, CacheObjects
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets

BLOCK = 1 << 14                       # small cache block for tests


def _origin(root):
    """The backend the reference's cases run on FSObjects (not ported):
    one 2+2 erasure set, its namespace feed NOT wired to the cache, so
    writes bypass the wrapper as FSObjects' do."""
    zz = ErasureServerSets([ErasureSets.from_drives(
        [str(root / f"o{i}") for i in range(4)], 1, 4, 2,
        block_size=1 << 16, enable_mrf=False, device="cpu")],
        load_topology=False)
    zz.make_bucket("b")
    return zz


@pytest.fixture()
def stack(tmp_path):
    fs = _origin(tmp_path / "origin")
    cache = CacheObjects(fs, str(tmp_path / "cache"),
                         budget_bytes=64 << 20, block_size=BLOCK)
    yield fs, cache
    fs.close()


def test_ranged_miss_caches_aligned_span(stack):
    fs, cache = stack
    payload = os.urandom(BLOCK * 6 + 777)
    fs.put_object("b", "o", payload)

    # ranged miss: only the covering aligned span lands in the cache
    _, s = cache.get_object("b", "o", offset=BLOCK + 100, length=300)
    assert b"".join(s) == payload[BLOCK + 100:BLOCK + 400]
    assert cache.misses == 1
    meta = cache._load_entry("b", "o")
    assert meta["ranges"] == [
        {"start": BLOCK, "end": 2 * BLOCK, "file": f"r{BLOCK}"}]

    # a hit fully inside the cached span serves from cache
    _, s = cache.get_object("b", "o", offset=BLOCK + 500, length=100)
    assert b"".join(s) == payload[BLOCK + 500:BLOCK + 600]
    assert cache.hits == 1

    # a span NOT covered is a miss and caches its own range
    _, s = cache.get_object("b", "o", offset=4 * BLOCK, length=BLOCK)
    assert b"".join(s) == payload[4 * BLOCK:5 * BLOCK]
    assert cache.misses == 2
    meta = cache._load_entry("b", "o")
    assert {r["start"] for r in meta["ranges"]} == {BLOCK, 4 * BLOCK}

    # a request spanning cached+uncached blocks is a miss (no single
    # covering span) and fills its full aligned span
    _, s = cache.get_object("b", "o", offset=BLOCK, length=3 * BLOCK)
    assert b"".join(s) == payload[BLOCK:4 * BLOCK]
    assert cache.misses == 3
    _, s = cache.get_object("b", "o", offset=BLOCK, length=3 * BLOCK)
    assert b"".join(s) == payload[BLOCK:4 * BLOCK]
    assert cache.hits == 2

    # the tail range (unaligned object end) caches and serves
    _, s = cache.get_object("b", "o", offset=BLOCK * 6, length=777)
    assert b"".join(s) == payload[BLOCK * 6:]
    _, s = cache.get_object("b", "o", offset=BLOCK * 6 + 700, length=77)
    assert b"".join(s) == payload[BLOCK * 6 + 700:]
    assert cache.hits == 3


def test_whole_object_entry_serves_any_range(stack):
    fs, cache = stack
    payload = os.urandom(3 * BLOCK + 5)
    fs.put_object("b", "w", payload)
    _, s = cache.get_object("b", "w")
    assert b"".join(s) == payload
    for off, ln in [(0, 10), (BLOCK - 1, 2), (2 * BLOCK, BLOCK + 5),
                    (0, len(payload))]:
        _, s = cache.get_object("b", "w", offset=off, length=ln)
        assert b"".join(s) == payload[off:off + ln], (off, ln)
    assert cache.misses == 1 and cache.hits == 4


def test_corrupt_block_detected_mid_stream_and_evicted(stack):
    """Incremental verification: blocks before the corruption stream
    verified; the corrupt block is never served — the rest comes from
    the backend and the bad file is evicted."""
    fs, cache = stack
    payload = os.urandom(5 * BLOCK)
    fs.put_object("b", "c", payload)
    b"".join(cache.get_object("b", "c")[1])          # populate

    d = cache._entry_dir("b", "c")
    # corrupt the PAYLOAD of the third frame (frame = 32-digest+block)
    with open(os.path.join(d, "data"), "r+b") as f:
        f.seek(2 * (32 + BLOCK) + 32 + 7)
        f.write(b"\xff")
    _, s = cache.get_object("b", "c")
    assert b"".join(s) == payload                    # bytes all correct
    # the corrupt file is gone; next read is a clean miss that refills
    meta = cache._load_entry("b", "c")
    assert meta["ranges"] == []
    before = cache.misses
    _, s = cache.get_object("b", "c")
    assert b"".join(s) == payload
    assert cache.misses == before + 1
    _, s = cache.get_object("b", "c")
    assert b"".join(s) == payload                    # refilled → hit


def test_partial_fill_never_committed(stack):
    """A client that hangs up mid-download must not leave a partial
    cache entry that later reads would trust."""
    fs, cache = stack
    payload = os.urandom(6 * BLOCK)
    fs.put_object("b", "p", payload)
    _, s = cache.get_object("b", "p")
    next(s)                                          # one block only
    s.close()                                        # client hangup
    meta = cache._load_entry("b", "p")
    assert (meta or {}).get("ranges", []) == []
    d = cache._entry_dir("b", "p")
    leftovers = [f for f in os.listdir(d) if f != "meta.json"]
    assert leftovers == []
    # and the object still reads fine (miss -> refill)
    _, s = cache.get_object("b", "p")
    assert b"".join(s) == payload


def test_watermark_lru_prefers_cold_entries(tmp_path):
    fs = _origin(tmp_path / "o")
    cache = CacheObjects(fs, str(tmp_path / "c"),
                         budget_bytes=200_000, block_size=BLOCK)
    for i in range(12):
        fs.put_object("b", f"k{i}", bytes(BLOCK))
        b"".join(cache.get_object("b", f"k{i}")[1])
        time.sleep(0.01)
    # keep k0 hot: its clock refreshes on every hit
    b"".join(cache.get_object("b", "k0")[1])
    time.sleep(0.01)
    for i in range(12, 16):
        fs.put_object("b", f"k{i}", bytes(BLOCK))
        b"".join(cache.get_object("b", f"k{i}")[1])
    assert cache._usage() <= 200_000 * 0.95
    # the hot entry survived the purge; a cold early one did not
    hits_before = cache.hits
    b"".join(cache.get_object("b", "k0")[1])
    assert cache.hits == hits_before + 1
    misses_before = cache.misses
    b"".join(cache.get_object("b", "k1")[1])
    assert cache.misses == misses_before + 1
    fs.close()


def test_oversized_object_reads_through(stack):
    fs, cache = stack
    cache.budget = 1 << 20                # max entry = 100 KiB
    payload = os.urandom(300_000)
    fs.put_object("b", "huge", payload)
    _, s = cache.get_object("b", "huge")
    assert b"".join(s) == payload
    meta = cache._load_entry("b", "huge")
    assert meta is None or meta.get("ranges", []) == []
    # but a small RANGE of the huge object still caches
    _, s = cache.get_object("b", "huge", offset=BLOCK, length=100)
    assert b"".join(s) == payload[BLOCK:BLOCK + 100]
    meta = cache._load_entry("b", "huge")
    assert meta and len(meta["ranges"]) == 1


_RSS_CHILD = r"""
import os, resource, sys
sys.path.insert(0, os.environ["REPO"])
from minio_tpu_torch.object.cache import CacheObjects

SIZE = 256 << 20
CHUNK = 1 << 20

class FakeInfo:
    etag = "fixed"; size = SIZE; content_type = "application/x"
    user_defined = {}; mod_time = 0.0

class FakeInner:
    def get_object_info(self, b, k, opts=None):
        return FakeInfo()
    def get_object(self, b, k, offset=0, length=-1, opts=None):
        n = SIZE - offset if length < 0 else length
        def gen():
            left = n
            blob = b"\xab" * CHUNK
            while left > 0:
                yield blob[:min(CHUNK, left)]
                left -= min(CHUNK, left)
        return FakeInfo(), gen()

cache = CacheObjects(FakeInner(), os.environ["CACHEDIR"],
                     budget_bytes=SIZE * 20)
# a tiny warm-up fill loads every code path (incl. the hash kernels),
# so the big fill's delta over this high-water is pure buffering
_, warm = cache.get_object("b", "big", offset=0, length=1 << 20)
for _chunk in warm:
    pass
base_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

_, stream = cache.get_object("b", "big")
total = 0
for chunk in stream:
    total += len(chunk)
assert total == SIZE, total
meta = cache._load_entry("b", "big")
assert any(r["start"] == 0 and r["end"] == SIZE
           for r in meta["ranges"]), "fill did not commit"
rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
print(f"rss_mb={rss_mb:.0f} base_mb={base_mb:.0f}")
assert rss_mb - base_mb < 100, \
    f"streamed 256 MiB fill grew RSS by {rss_mb - base_mb:.0f} MB"
"""


def test_fill_memory_is_bounded(tmp_path):
    """A 256 MiB fill must stream at constant memory (the r4 cache
    buffered the entire object in RAM — VERDICT weak: cache.py:146)."""
    cachedir = "/dev/shm/mt-cache-test" if os.path.isdir("/dev/shm") \
        else str(tmp_path / "c")
    env = dict(os.environ,
               REPO=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))),
               CACHEDIR=cachedir)
    try:
        proc = subprocess.run([sys.executable, "-c", _RSS_CHILD],
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "rss_mb=" in proc.stdout
    finally:
        import shutil
        shutil.rmtree(cachedir, ignore_errors=True)


# ---------------------------------------------------------------------------
# erasure-path hot-object read cache (device scan plane)
# ---------------------------------------------------------------------------

def _erasure_stack(tmp_path, **cache_kw):
    zz = ErasureServerSets([ErasureSets.from_drives(
        [str(tmp_path / f"ecd{i}") for i in range(4)], 1, 4, 2,
        block_size=1 << 16, enable_mrf=False, device="cpu")],
        load_topology=False)
    zz.make_bucket("b")
    cache_kw.setdefault("budget_bytes", 64 << 20)
    cache_kw.setdefault("block_size", BLOCK)
    cache = CacheObjects(zz, str(tmp_path / "cache"), **cache_kw)
    # cluster-boot wiring: invalidation rides the namespace feed
    zz.attach_read_cache(cache)
    return zz, cache


def _decode_streams() -> float:
    from minio_tpu_torch.utils import telemetry
    return telemetry.REGISTRY.counter(
        "minio_tpu_erasure_get_streams_total",
        "Object read streams served through the erasure "
        "shard-read/verify/decode path").value()


def test_cache_hit_serves_without_erasure_decode(tmp_path):
    """THE acceptance proof: a cache hit streams the framed local
    entry — the erasure shard-read/verify/decode path must not run
    (flat minio_tpu_erasure_get_streams_total delta)."""
    zz, cache = _erasure_stack(tmp_path)
    payload = os.urandom(3 * BLOCK + 17)
    zz.put_object("b", "hot", payload)
    # miss + fill: the backend read pays one decode stream
    before = _decode_streams()
    _, s = cache.get_object("b", "hot")
    assert b"".join(s) == payload
    assert _decode_streams() == before + 1
    assert cache.misses == 1 and cache.fills == 1
    # hit: identical bytes, ZERO new decode streams
    before = _decode_streams()
    for _ in range(3):
        _, s = cache.get_object("b", "hot")
        assert b"".join(s) == payload
    assert _decode_streams() == before
    assert cache.hits == 3
    zz.close()


def test_admission_frequency_bar(tmp_path):
    """Admission is driven by in-window access frequency: below the
    bar the read passes through WITHOUT filling (one-shot bulk reads
    must not churn the LRU), at the bar the entry fills."""
    zz, cache = _erasure_stack(tmp_path, admit_hits=2,
                               admit_window_s=60.0)
    payload = os.urandom(BLOCK)
    zz.put_object("b", "k", payload)
    _, s = cache.get_object("b", "k")        # 1st access: below bar
    assert b"".join(s) == payload
    assert cache.admit_rejects == 1 and cache.fills == 0
    assert cache._load_entry("b", "k") is None
    _, s = cache.get_object("b", "k")        # 2nd: admitted, fills
    assert b"".join(s) == payload
    assert cache.fills == 1
    _, s = cache.get_object("b", "k")        # 3rd: hit
    assert b"".join(s) == payload
    assert cache.hits == 1
    zz.close()


def test_access_tracker_window_expiry():
    t = AccessTracker(admit_hits=2, window_s=0.05)
    assert t.record("b", "k") == 1
    time.sleep(0.08)
    # window expired: the count restarts — stale popularity never admits
    assert t.record("b", "k") == 1
    assert t.record("b", "k") == 2
    assert t.admitted(2) and not t.admitted(1)


def test_every_mutation_verb_evicts_via_namespace_feed(tmp_path):
    """Mutations that BYPASS the wrapper (engine-level writes: the
    rebalance/heal/lifecycle planes) must still evict through the
    namespace feed — overwrite, delete, delete-marker, metadata
    update each drop the entry."""
    zz, cache = _erasure_stack(tmp_path)
    payload = os.urandom(BLOCK)

    def fill(name):
        zz.put_object("b", name, payload)
        b"".join(cache.get_object("b", name)[1])
        assert cache._load_entry("b", name) is not None, name

    fill("ow")
    zz.put_object("b", "ow", os.urandom(BLOCK))       # raw overwrite
    assert cache._load_entry("b", "ow") is None
    fill("del")
    zz.delete_object("b", "del")
    assert cache._load_entry("b", "del") is None
    fill("marker")
    zz.delete_object("b", "marker", versioned=True)   # marker write
    assert cache._load_entry("b", "marker") is None
    fill("md")
    zz.update_object_metadata("b", "md", {"x-amz-meta-a": "1"})
    assert cache._load_entry("b", "md") is None
    assert cache.evictions >= 4
    # correctness after the overwrite eviction: fresh bytes, not stale
    new = os.urandom(BLOCK)
    zz.put_object("b", "ow", new)
    b"".join(cache.get_object("b", "ow")[1])
    _, s = cache.get_object("b", "ow")
    assert b"".join(s) == new
    zz.close()


def test_transition_evicts_and_gates_invalid_object_state(tmp_path):
    """A transitioned (stubbed) version evicts its entry through the
    namespace feed, and a cached copy never answers a GET that must
    answer InvalidObjectState: the backend gate is the single home."""
    import shutil

    from minio_tpu_torch.tier.config import TierConfig, TierManager
    from minio_tpu_torch.tier.transition import (TransitionWorker,
                                                 restore_object)
    zz, cache = _erasure_stack(tmp_path)
    tiers = TierManager(zz)
    tiers.add(TierConfig("cold", "fs", {"path": str(tmp_path / "tier")}))
    worker = TransitionWorker(zz, tiers, busy_fn=lambda: False).start()
    payload = os.urandom(2 * BLOCK)
    info = zz.put_object("b", "doc", payload)
    b"".join(cache.get_object("b", "doc")[1])         # hot + cached
    assert cache._load_entry("b", "doc") is not None
    worker.enqueue("b", "doc", "", "cold", etag=info.etag)
    assert worker.drain(30), worker.stats()
    # the transition's namespace delta evicted the entry
    assert cache._load_entry("b", "doc") is None
    with pytest.raises(api_errors.InvalidObjectState):
        cache.get_object("b", "doc")
    # a STALE entry planted behind the stub is refused and dropped
    zz2, planted = _erasure_stack(tmp_path / "p2")
    zz2.put_object("b", "doc", payload)
    b"".join(planted.get_object("b", "doc")[1])
    shutil.copytree(planted._entry_dir("b", "doc"),
                    cache._entry_dir("b", "doc"))
    assert cache._load_entry("b", "doc") is not None
    hits = cache.hits
    with pytest.raises(api_errors.InvalidObjectState):
        cache.get_object("b", "doc")
    assert cache._load_entry("b", "doc") is None      # cause=transition
    assert cache.hits == hits
    # restored: the object serves again from a fresh backend read
    restore_object(zz, tiers, "b", "doc", days=1)
    _, s = cache.get_object("b", "doc")
    assert b"".join(s) == payload
    worker.close()
    zz2.close()
    zz.close()


def test_cache_bitrot_frame_falls_back_to_backend(tmp_path):
    """Chaos (satellite): a random bitrot flip inside a cached frame
    must fall back to the erasure backend read — correct bytes out,
    corrupt file evicted, fallback counted."""
    seed = int(os.environ.get("MINIO_TPU_CHAOS_SEED",
                              str(random.randrange(1 << 30))))
    print(f"MINIO_TPU_CHAOS_SEED={seed}")
    rng = random.Random(seed)
    zz, cache = _erasure_stack(tmp_path)
    payload = os.urandom(5 * BLOCK + 123)
    zz.put_object("b", "c", payload)
    b"".join(cache.get_object("b", "c")[1])           # populate
    d = cache._entry_dir("b", "c")
    data = os.path.join(d, "data")
    size = os.path.getsize(data)
    with open(data, "r+b") as f:                      # one random flip
        pos = rng.randrange(size)
        f.seek(pos)
        byte = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([byte ^ (1 << rng.randrange(8))]))
    before = _decode_streams()
    _, s = cache.get_object("b", "c")
    assert b"".join(s) == payload                     # NEVER bad bytes
    assert _decode_streams() > before                 # backend re-read
    meta = cache._load_entry("b", "c")
    assert (meta or {}).get("ranges", []) == []       # corrupt file gone
    zz.close()


# ---------------------------------------------------------------------------
# the guarded hit (a departure from the reference)
# ---------------------------------------------------------------------------

def _ref_stack(tmp_path, make=True, **cache_kw):
    from minio_tpu.object.cache import CacheObjects as RefCache
    from minio_tpu.object.server_sets import ErasureServerSets as RefZones
    from minio_tpu.object.sets import ErasureSets as RefSets
    zz = RefZones([RefSets.from_drives(
        [str(tmp_path / f"ecd{i}") for i in range(4)], 1, 4, 2,
        block_size=1 << 16, enable_mrf=False)], load_topology=False)
    if make:
        zz.make_bucket("b")
    cache_kw.setdefault("budget_bytes", 64 << 20)
    cache_kw.setdefault("block_size", BLOCK)
    cache = RefCache(zz, str(tmp_path / "cache"), **cache_kw)
    zz.attach_read_cache(cache)
    return zz, cache


@pytest.mark.parametrize("which", ["port", "ref"])
def test_overwrite_mid_hit_aborts_instead_of_splicing(tmp_path, which):
    """A hit streams the first frame; the object is overwritten (the
    feed evicts the entry, the open file reads on); the fourth frame
    then fails its check. The port re-reads with the GET's options, sees
    a new ETag and aborts the response. The reference resumes from the
    backend at the same offset and splices the new object's bytes under
    the old ETag and length."""
    zz, cache = (_erasure_stack if which == "port" else _ref_stack)(
        tmp_path)
    try:
        old = os.urandom(6 * BLOCK)
        new = os.urandom(6 * BLOCK)
        zz.put_object("b", "o", old)
        b"".join(cache.get_object("b", "o")[1])          # fill
        with open(os.path.join(cache._entry_dir("b", "o"), "data"),
                  "r+b") as f:
            f.seek(3 * (32 + BLOCK) + 32 + 11)            # frame 3 payload
            f.write(bytes([f.read(1)[0] ^ 0x5A]))
        info, stream = cache.get_object("b", "o")
        hits = cache.hits
        got = next(stream)
        zz.put_object("b", "o", new)                     # lands mid-stream
        assert cache._load_entry("b", "o") is None       # feed evicted it
        if which == "port":
            with pytest.raises(api_errors.ObjectApiError,
                               match="changed mid-stream"):
                for piece in stream:
                    got += piece
            assert got == old[:3 * BLOCK]     # only verified old frames
        else:
            got += b"".join(stream)
            assert got == old[:3 * BLOCK] + new[3 * BLOCK:]
            assert got not in (old, new)      # two versions, one response
        assert hits == 1 and info.etag != zz.get_object_info(
            "b", "o").etag
    finally:
        zz.close()


def test_hit_fallback_of_the_same_generation_completes(tmp_path):
    """The guard lets the fallback finish when the backend still holds
    the generation the response started with."""
    zz, cache = _erasure_stack(tmp_path)
    try:
        payload = os.urandom(4 * BLOCK + 9)
        zz.put_object("b", "o", payload)
        b"".join(cache.get_object("b", "o")[1])
        with open(os.path.join(cache._entry_dir("b", "o"), "data"),
                  "r+b") as f:
            f.seek(2 * (32 + BLOCK) + 40)
            f.write(b"\x00\x01")
        _, s = cache.get_object("b", "o", offset=BLOCK + 3,
                                length=2 * BLOCK)
        assert b"".join(s) == payload[BLOCK + 3:3 * BLOCK + 3]
    finally:
        zz.close()


# ---------------------------------------------------------------------------
# entries of either package
# ---------------------------------------------------------------------------

def _entry_files(cache, bucket, key):
    d = cache._entry_dir(bucket, key)
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            data = fh.read()
        out[f] = json.loads(data) if f == "meta.json" else data
    return d[len(cache.dir):], out


def test_entries_equal_reference(tmp_path):
    """The same object (the port's tree a copy of the reference's) and
    the same whole and ranged fills: equal entry paths, meta documents
    and framed files."""
    import shutil
    rz, rc = _ref_stack(tmp_path / "ref")
    payload = os.urandom(5 * BLOCK + 77)
    rz.put_object("b", "obj", payload)
    rz.put_object("b", "big", os.urandom(9 * BLOCK))
    rz.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "port",
                    ignore=shutil.ignore_patterns("cache"))
    rz, rc = _ref_stack(tmp_path / "ref", make=False)
    pz = ErasureServerSets([ErasureSets.from_drives(
        [str(tmp_path / "port" / f"ecd{i}") for i in range(4)], 1, 4, 2,
        block_size=1 << 16, enable_mrf=False, device="cpu")],
        load_topology=False)
    pc = CacheObjects(pz, str(tmp_path / "port" / "cache"),
                      budget_bytes=64 << 20, block_size=BLOCK)
    try:
        for cache in (rc, pc):
            b"".join(cache.get_object("b", "obj")[1])
            b"".join(cache.get_object("b", "big", offset=BLOCK + 5,
                                      length=2 * BLOCK)[1])
            b"".join(cache.get_object("b", "big", offset=7 * BLOCK,
                                      length=10)[1])
        for key in ("obj", "big"):
            assert _entry_files(pc, "b", key) == _entry_files(rc, "b", key)
        assert pc.stats() == rc.stats()
    finally:
        rz.close()
        pz.close()


# ---------------------------------------------------------------------------
# the handlers through the wrapper, on a booted node
# ---------------------------------------------------------------------------

_MASTER = bytes(range(32)).hex()
_SSEC_KEY = bytes(range(100, 132))
_SSE_S3 = {"x-amz-server-side-encryption": "AES256"}
_SSEC = {
    "x-amz-server-side-encryption-customer-algorithm": "AES256",
    "x-amz-server-side-encryption-customer-key":
        base64.b64encode(_SSEC_KEY).decode(),
    "x-amz-server-side-encryption-customer-key-md5":
        base64.b64encode(__import__("hashlib").md5(_SSEC_KEY).digest())
        .decode()}
_VOLATILE = ("x-amz-request-id", "date", "x-amz-id-2")


def test_booted_node_answers_alike_through_the_cache(tmp_path,
                                                     monkeypatch):
    import torch

    from minio_tpu_torch import cluster
    from minio_tpu_torch.object import engine
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    from minio_tpu_torch.s3select.select import event_stream
    from minio_tpu_torch.scripts import scan_cases as sc
    torch.set_num_threads(1)
    monkeypatch.setenv("MINIO_TPU_CACHE", "on")
    monkeypatch.setenv("MINIO_COMPRESS", "on")
    monkeypatch.setenv("MINIO_SSE_MASTER_KEY", _MASTER)
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "chacha20")
    creds = Credentials("cachetest1234", "cachesecret1234")
    node = cluster.start_single([str(tmp_path / "d{1...4}")], creds=creds,
                                parity=2, block_size=1 << 16,
                                device="cpu")
    try:
        cache = node.read_cache
        assert node.s3.api.obj is cache and cache.inner is \
            node.object_layer
        # the background planes keep the raw layer
        assert node.crawler.obj is node.object_layer
        assert node.heal_scanner.obj is node.object_layer
        c = S3Client(node.s3.port, creds, timeout=120)
        assert c.send("PUT", "/cbk")[0] == 200
        rng = random.Random(7)
        blob = bytes(rng.randrange(256) for _ in range(300_000))
        csv = sc.lineitem_csv(3000, 11)
        objs = {"plain.bin": (blob, {}), "s3.bin": (blob, _SSE_S3),
                "c.bin": (blob[:150_000], _SSEC), "t.csv": (csv, {}),
                "s3.csv": (csv, _SSE_S3)}
        for k, (d, h) in objs.items():
            assert c.send("PUT", f"/cbk/{k}", body=d, headers=h)[0] == 200
        pkg = 64 * 1024
        reqs = []
        for k, (d, h) in objs.items():
            reqs.append(("GET", k, h, None, d))
            reqs.append(("HEAD", k, h, None, None))
            for a, b in ((5, 70_000), (pkg - 3, 2 * pkg + 9),
                         (len(d) - 100, len(d) - 1)):
                reqs.append(("GET", k, h, f"bytes={a}-{b}", d[a:b + 1]))
        expr = "SELECT l_orderkey FROM S3Object WHERE l_quantity < 3"
        for k in ("t.csv", "s3.csv"):
            reqs.append(("SELECT", k, objs[k][1], None,
                         b"".join(event_stream(sc.request(expr), csv))))
        for method, key, hdrs, rng_h, want in reqs:
            h = dict(hdrs)
            if rng_h:
                h["range"] = rng_h
            answers = []
            for _round in range(4):
                before = engine.GET_STREAMS.value()
                if method == "SELECT":
                    r = c.send("POST", f"/cbk/{key}",
                               query={"select": "", "select-type": "2"},
                               body=sc.select_xml(expr), headers=h)
                else:
                    r = c.send(method, f"/cbk/{key}", headers=h)
                streams = engine.GET_STREAMS.value() - before
                answers.append((r[0], {n: v for n, v in r[1].items()
                                       if n.lower() not in _VOLATILE},
                                r[2]))
            st = answers[0][0]
            assert all(a == answers[0] for a in answers), (method, key,
                                                            rng_h)
            assert st in (200, 206), (method, key, rng_h, st)
            if want is not None:
                assert answers[0][2] == want, (method, key, rng_h)
            if method != "HEAD":
                assert streams == 0, (method, key, rng_h)   # the 4th hit
        s = cache.stats()
        assert s["hits"] > 0 and s["fills"] > 0
        assert node.s3.api.scan.device_serves >= 2
    finally:
        node.shutdown()
