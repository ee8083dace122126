"""The port's replication plane (minio_tpu_torch/replicate/ and
features/replication.py) held against minio_tpu's.

  * every case of tests/test_replicate.py rebound to the port
    (tests/test_torch_iam.rebound), its sets on device="cpu": concurrent
    writers converging with no ping-pong, markers and purges, the
    unversioned conflict rule, multipart part boundaries, transitioned
    stubs, resync crash and resume, the registry across a decommission,
    the chaos client, the HTTP wire, an offline wire target, the legacy
    push target, pacing, the null version and the per-target lag; and
    tests/test_features.py::test_replication_end_to_end (the legacy
    ReplicationPool through the handlers' ``_notify``);
  * twin pairs: a reference site pair and a port site pair, site ids,
    ARNs, version ids and clocks pinned (tests/test_torch_s3.pin), take
    one sequence: writes to the same keys on both sites before either
    syncs, a delete marker, a purge, a multipart object and a
    transitioned stub. Each plane's queue is pumped in the test's thread
    (no worker threads), so both packages sync the same keys in the same
    order; the converged listings (name, version id, mod time, ETag,
    delete marker, origin site), the bytes of every data version, the
    planes' counts and the replica writes are equal, and a further
    cycle over every key writes no replica;
  * cross-package wire: a port site pushes over HTTP to a reference
    site, and a reference site to a port site (each server with its own
    plane answering the admin replicate routes): the target's listing
    and bytes equal the source's, a purge prunes over the wire, and a
    further cycle writes no replica;
  * cross-package files: a resync stopped midway by one package leaves
    its checkpoint under .minio.sys/replicate/; the other package's
    resync over the same drives resumes from that marker, pushes only
    the keys after it, and seeds the target equal to the source.
Four drives at 2+2, 64 KiB blocks, device="cpu". Every comparison is
exact (tolerance 0).
"""

from __future__ import annotations

import hashlib
import inspect
import io
import types

import pytest

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.replicate as ref_replicate
import minio_tpu.replicate.client as ref_rclient
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu.tier.config as ref_tier
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.replicate as port_replicate
import minio_tpu_torch.replicate.client as port_rclient
import minio_tpu_torch.s3.handlers as port_handlers
import minio_tpu_torch.tier.config as port_tier
import tests.test_features as ref_features
import tests.test_replicate as ref_cases
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3.admin import mount_admin as ref_mount_admin
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.utils.streams import IterStream as RefIterStream
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.admin import mount_admin
from minio_tpu_torch.s3.credentials import Credentials
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.utils.streams import IterStream
from tests.test_torch_iam import rebound
from tests.test_torch_s3 import pin

N, M, BS = 4, 2, 1 << 16
CREDS = Credentials("replwirekey1", "replwiresecret1")
ORIGIN = "X-Minio-Internal-replication-origin"

REF = types.SimpleNamespace(
    tag="ref", sets=RefSets, server_sets=RefServerSets,
    replicate=ref_replicate, rclient=ref_rclient, engine=ref_engine,
    multipart=ref_multipart, tier=ref_tier, stream=RefIterStream,
    server=RefServer, mount_admin=ref_mount_admin, kw={},
    pin=(ref_engine, ref_multipart, ref_bmeta, ref_handlers, ref_crypto))
PORT = types.SimpleNamespace(
    tag="port", sets=ErasureSets, server_sets=ErasureServerSets,
    replicate=port_replicate, rclient=port_rclient, engine=port_engine,
    multipart=port_multipart, tier=port_tier, stream=IterStream,
    server=S3Server, mount_admin=mount_admin, kw={"device": "cpu"},
    pin=(port_engine, port_multipart, port_bmeta, port_handlers,
         port_crypto))


# -- the reference's cases, rebound -------------------------------------------------

class _CpuSets:
    """The port's ErasureSets as the reference's tests call it, on the
    CPU."""

    @staticmethod
    def from_drives(*args, **kw):
        return ErasureSets.from_drives(*args, device="cpu", **kw)


_CASES = sorted(name for name, fn in vars(ref_cases).items()
                if name.startswith("test_") and inspect.isfunction(fn))


def test_every_reference_case_is_rebound():
    assert len(_CASES) == 14, _CASES


@pytest.mark.parametrize("name", _CASES)
def test_reference_replicate_cases(tmp_path, name):
    fn = rebound(getattr(ref_cases, name), ErasureSets=_CpuSets)
    given = {"tmp_path": tmp_path}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_reference_replication_end_to_end(tmp_path):
    rebound(ref_features.test_replication_end_to_end,
            ErasureSets=_CpuSets)(tmp_path)


# -- helpers --------------------------------------------------------------------------

def _layer(pkg, root, buckets=("b",)):
    sets = pkg.sets.from_drives([str(root / f"d{i}") for i in range(N)],
                                set_count=1, set_drive_count=N, parity=M,
                                block_size=BS, **pkg.kw)
    layer = pkg.server_sets([sets], load_topology=False)
    for b in buckets:
        layer.make_bucket(b)
    return layer


def _site(pkg, root, name, workers=None):
    """One site: a layer, its registry (site id pinned) and its plane on
    the layer's namespace feed."""
    layer = _layer(pkg, root)
    reg = pkg.replicate.TargetRegistry(layer, site_id=name)
    plane = pkg.replicate.ReplicationPlane(layer, reg, workers=workers,
                                           busy_fn=lambda: False)
    layer.attach_replication(plane)
    return layer, reg, plane


def _pump(*planes) -> None:
    """Sync every queued key in this thread, plane after plane, until no
    plane holds one: a replica apply re-fires its target's feed, so the
    loop runs until both sides are quiet."""
    moved = True
    while moved:
        moved = False
        for p in planes:
            while True:
                with p._cond:
                    if not p._queue:
                        break
                    bucket, key, _t = p._queue.popleft()
                    p._pending.discard((bucket, key))
                p._sync_key_targets(bucket, key)
                moved = True
    for p in planes:
        st = p.stats()
        assert st["failed"] == 0 and st["retry"]["pending"] == 0, st


def _listing(layer, bucket="b", site=""):
    """Every version as (name, version id, mod time, ETag, delete marker,
    origin site); a native write's origin is the listing site's."""
    return [(v.name, v.version_id, v.mod_time, v.etag, v.delete_marker,
             (v.user_defined or {}).get(ORIGIN, "") or site)
            for v in layer.list_object_versions(bucket)[0]]


def _contents(pkg, layer, bucket="b") -> dict:
    """(name, version id) -> sha256 of every data version's bytes (a
    transitioned stub's GET refusal named instead)."""
    out = {}
    for v in layer.list_object_versions(bucket)[0]:
        if v.delete_marker:
            continue
        try:
            _, stream = layer.get_object(
                bucket, v.name,
                opts=pkg.engine.GetOptions(version_id=v.version_id
                                           or "null"))
            out[(v.name, v.version_id)] = hashlib.sha256(
                b"".join(stream)).hexdigest()
        except Exception as e:  # noqa: BLE001 — a stub's refusal
            out[(v.name, v.version_id)] = type(e).__name__
    return out


def _counts(plane) -> dict:
    st = plane.stats()
    return {k: st[k] for k in ("synced", "skipped", "failed", "pruned",
                               "dropped")}


# -- twin pairs ---------------------------------------------------------------------

def _twin_sequence(pkg, root) -> dict:
    """The sequence through one package's site pair; what converged."""
    A, regA, planeA = _site(pkg, root / "a", "siteA", workers=0)
    B, regB, planeB = _site(pkg, root / "b", "siteB", workers=0)
    rep = pkg.replicate
    regA.add(rep.SiteTarget(arn="arn:minio:replication::ab:b", bucket="b",
                            dest_bucket="b", site="siteB", type="layer"),
             client=rep.LayerReplClient(B, "b", "siteB"))
    regB.add(rep.SiteTarget(arn="arn:minio:replication::ba:b", bucket="b",
                            dest_bucket="b", site="siteA", type="layer"),
             client=rep.LayerReplClient(A, "b", "siteA"))
    versioned = pkg.engine.PutOptions(versioned=True)
    writes = rep.replica_writes_counter()
    before = {s: writes.value(site=s) for s in ("siteA", "siteB")}
    steps = {}
    try:
        # writes to the same keys on both sites before either syncs, a
        # null version under a versioned history, and the unversioned
        # slot written at both (the later mod time wins at both)
        for i in range(6):
            site = A if i % 2 == 0 else B
            site.put_object("b", f"k{i % 3}", f"{i}".encode() * (40 + i),
                            opts=versioned)
        A.put_object("b", "mixed", b"null-era")
        A.put_object("b", "mixed", b"versioned-era", opts=versioned)
        A.put_object("b", "u", b"unversioned-a")
        B.put_object("b", "u", b"unversioned-b")
        _pump(planeA, planeB)
        steps["writes"] = _listing(A, site="siteA")
        A.delete_object("b", "k1", versioned=True)          # a marker
        _pump(planeA, planeB)
        steps["marker"] = _listing(B, site="siteB")
        gone = next(v for v in A.object_versions("b", "k0")
                    if (v.user_defined or {}).get(ORIGIN, "") == "")
        A.delete_object("b", "k0", version_id=gone.version_id)  # purge
        _pump(planeA, planeB)
        steps["purge"] = _listing(B, site="siteB")
        p1, p2 = b"p" * (5 << 20), b"q" * 4096
        up = B.new_multipart_upload("b", "mp", versioned)
        e1 = B.put_object_part("b", "mp", up, 1, io.BytesIO(p1),
                               len(p1)).etag
        e2 = B.put_object_part("b", "mp", up, 2, io.BytesIO(p2),
                               len(p2)).etag
        B.complete_multipart_upload("b", "mp", up,
                                    [pkg.multipart.CompletePart(1, e1),
                                     pkg.multipart.CompletePart(2, e2)])
        _pump(planeA, planeB)
        mp = A.get_object_info("b", "mp")
        steps["multipart"] = (mp.etag, [(p.number, p.size)
                                        for p in mp.parts])
        tiers = pkg.tier.TierManager(A)
        tiers.add(pkg.tier.TierConfig("cold", "fs",
                                      {"path": str(root / "tier")}))
        A.put_object("b", "arch", b"z" * 9000, opts=versioned)
        oi = A.get_object_info("b", "arch")
        _, stream = A.get_object("b", "arch")
        rd = pkg.stream(stream)
        rk = tiers.remote_key("b", "arch", oi.version_id)
        try:
            tiers.client("cold").put(rk, rd, oi.size)
        finally:
            rd.close()
        A.transition_object("b", "arch", version_id=oi.version_id,
                            tier="cold", remote_object=rk,
                            expect_etag=oi.etag)
        _pump(planeA, planeB)
        steps["stub"] = B.get_object_info("b", "arch").size
        assert _listing(A, site="siteA") == _listing(B, site="siteB")
        steps["listing"] = _listing(A, site="siteA")
        steps["contents"] = (_contents(pkg, A), _contents(pkg, B))
        steps["counts"] = (_counts(planeA), _counts(planeB))
        wrote = {s: writes.value(site=s) - before[s]
                 for s in ("siteA", "siteB")}
        steps["replica_writes"] = wrote
        # one more cycle over every key: no replica is written
        for p in (planeA, planeB):
            for name in {v.name for v in A.list_object_versions("b")[0]}:
                p.on_namespace_change("b", name)
        _pump(planeA, planeB)
        assert {s: writes.value(site=s) - before[s]
                for s in ("siteA", "siteB")} == wrote
        assert _listing(A, site="siteA") == _listing(B, site="siteB") == steps["listing"]
        return steps
    finally:
        planeA.close()
        planeB.close()
        A.close()
        B.close()


def test_twin_pairs_converge_alike(tmp_path, monkeypatch):
    pin(monkeypatch, *REF.pin)
    pin(monkeypatch, *PORT.pin)
    got = {}
    for pkg in (REF, PORT):
        (tmp_path / pkg.tag).mkdir()
        got[pkg.tag] = _twin_sequence(pkg, tmp_path / pkg.tag)
    port = got["port"]
    names = [v[0] for v in port["listing"]]
    assert sorted(set(names)) == ["arch", "k0", "k1", "k2", "mixed", "mp",
                                  "u"]
    assert any(v[4] for v in port["marker"])
    assert port["multipart"][0].endswith("-2")
    assert port["multipart"][1] == [(1, 5 << 20), (2, 4096)]
    assert port["stub"] == 9000
    contents_a, contents_b = port["contents"]
    assert contents_a == contents_b
    assert set(contents_a.values()) >= {"InvalidObjectState"}
    assert port["counts"][0]["pruned"] >= 1
    assert sum(port["replica_writes"].values()) >= len(port["listing"]) - 4
    assert got["port"] == got["ref"]


# -- cross-package wire ---------------------------------------------------------------

def _wire_target(src, dst, root):
    """A server of `dst`'s package over fresh drives, its admin router
    mounted and a plane of its own attached (so GET replicate answers its
    site id); a wire target at it for a `src` site's bucket b."""
    layer = _layer(dst, root / "dst", buckets=())
    srv = dst.server(layer, creds=CREDS).start()
    dst.mount_admin(srv)
    reg = dst.replicate.TargetRegistry(layer, site_id="siteW")
    plane = dst.replicate.ReplicationPlane(layer, reg,
                                           busy_fn=lambda: False)
    srv.api.replication = plane
    target = src.replicate.SiteTarget(
        arn="arn:minio:replication::wire:wbk", bucket="b", dest_bucket="wbk",
        site="", type="s3",
        params={"host": "127.0.0.1", "port": srv.port,
                "access_key": CREDS.access_key,
                "secret_key": CREDS.secret_key})
    return srv, layer, plane, target


def _drained(plane) -> None:
    assert plane.drain(60), plane.stats()
    st = plane.stats()
    assert st["failed"] == 0 and st["pending"] == 0, st


@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_wire_push_between_packages(tmp_path, monkeypatch, direction):
    src, dst = (PORT, REF) if direction == "port-to-ref" else (REF, PORT)
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.multipart, "MIN_PART_SIZE", 64 << 10)
    A, regA, planeA = _site(src, tmp_path / "src", "siteA")
    srv, W, planeW, target = _wire_target(src, dst, tmp_path)
    client = src.rclient.HTTPReplClient(target)
    try:
        assert client.remote_site() == "siteW"
        client.ensure_bucket()
        regA.add(target)            # the registry builds the wire client
        versioned = src.engine.PutOptions(versioned=True)
        A.put_object("b", "mixed", b"null-era")
        for i in range(3):
            A.put_object("b", f"w{i}", bytes([i]) * (1000 + 7 * i),
                         opts=versioned)
        A.put_object("b", "mixed", b"versioned" * 99, opts=versioned)
        A.put_object("b", "big", b"B" * (1 << 20), opts=versioned)
        p1, p2 = b"m" * (64 << 10), b"n" * 999
        up = A.new_multipart_upload("b", "mp", versioned)
        e1 = A.put_object_part("b", "mp", up, 1, io.BytesIO(p1),
                               len(p1)).etag
        e2 = A.put_object_part("b", "mp", up, 2, io.BytesIO(p2),
                               len(p2)).etag
        A.complete_multipart_upload("b", "mp", up,
                                    [src.multipart.CompletePart(1, e1),
                                     src.multipart.CompletePart(2, e2)])
        A.delete_object("b", "w1", versioned=True)
        _drained(planeA)
        assert _listing(W, "wbk", "siteA") == _listing(A, site="siteA")
        assert _contents(dst, W, "wbk") == _contents(src, A)
        assert [(p.number, p.size) for p in
                W.get_object_info("wbk", "mp").parts] == \
            [(1, len(p1)), (2, len(p2))]
        # a purge at the source prunes its replica over the wire
        gone = next(v for v in A.object_versions("b", "w0"))
        A.delete_object("b", "w0", version_id=gone.version_id)
        _drained(planeA)
        assert planeA.stats()["pruned"] == 1
        assert _listing(W, "wbk", "siteA") == _listing(A, site="siteA")
        # a further cycle pushes nothing
        synced = planeA.stats()["synced"]
        for name in ("mixed", "w1", "w2", "big", "mp"):
            planeA.on_namespace_change("b", name)
        _drained(planeA)
        assert planeA.stats()["synced"] == synced
    finally:
        planeA.close()
        planeW.close()
        srv.stop()
        A.close()
        W.close()


# -- cross-package files ----------------------------------------------------------------

class _Counting:
    """A target client that counts the keys it applies and, once `stop_at`
    keys have applied, stops the resync that drives it."""

    def __init__(self, inner, stop_at=0):
        self.inner = inner
        self.stop_at = stop_at
        self.keys: list[str] = []
        self.resyncer = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def apply_version(self, key, spec, reader_factory=None):
        out = self.inner.apply_version(key, spec, reader_factory)
        if key not in self.keys:
            self.keys.append(key)
        if self.stop_at and len(self.keys) >= self.stop_at:
            self.resyncer._stop.set()
        return out


def _resync_run(pkg, root, stop_at, resume_expected=None):
    """One package's resync of site A's bucket into site C over the
    drives under root: stopped after `stop_at` keys (0: run to its end).
    Returns the status and the keys it applied."""
    A = pkg.server_sets([pkg.sets.from_drives(
        [str(root / "a" / f"d{i}") for i in range(N)], set_count=1,
        set_drive_count=N, parity=M, block_size=BS, **pkg.kw)],
        load_topology=False)
    C = pkg.server_sets([pkg.sets.from_drives(
        [str(root / "c" / f"d{i}") for i in range(N)], set_count=1,
        set_drive_count=N, parity=M, block_size=BS, **pkg.kw)],
        load_topology=False)
    rep = pkg.replicate
    reg = rep.TargetRegistry(A, site_id="siteA")
    plane = rep.ReplicationPlane(A, reg, workers=0, busy_fn=lambda: False)
    arn = "arn:minio:replication::seed:b"
    client = _Counting(rep.LayerReplClient(C, "b", "siteC"), stop_at)
    reg.add(rep.SiteTarget(arn=arn, bucket="b", dest_bucket="b",
                           site="siteC", type="layer"), client=client)
    r = rep.Resyncer(A, reg, arn, plane=plane, checkpoint_every=1, page=4,
                     resume=True)
    client.resyncer = r
    try:
        if resume_expected is not None:
            assert r.state.get("resumed")
            for k in ("bucket", "marker", "keys_scanned",
                      "versions_pushed"):
                assert r.state[k] == resume_expected[k], k
        r.start()
        r._thread.join(60)
        st = r.status()
        listings = (_listing(A, site="siteA"), _listing(C, "b", "siteA")) if not stop_at else None
        contents = (_contents(pkg, A), _contents(pkg, C)) \
            if not stop_at else None
        return st, client.keys, listings, contents
    finally:
        plane.close()
        A.close()
        C.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_resync_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    w, r = (REF, PORT) if writer == "ref" else (PORT, REF)
    A = _layer(w, tmp_path / "a")
    versioned = w.engine.PutOptions(versioned=True)
    keys = [f"seed/{i:02d}" for i in range(12)]
    for i, k in enumerate(keys):
        A.put_object("b", k, f"v{i}".encode() * 64, opts=versioned)
        if i % 4 == 0:
            A.put_object("b", k, f"w{i}".encode() * 33, opts=versioned)
    A.delete_object("b", "seed/07", versioned=True)
    A.close()
    st, first, _l, _c = _resync_run(w, tmp_path, stop_at=5)
    assert st["status"] == "stopped", st
    assert first == keys[:5] and st["marker"] == keys[4], st
    st2, second, (la, lc), (ca, cc) = _resync_run(r, tmp_path, 0, st)
    assert st2["status"] == "complete", st2
    assert second == keys[5:]
    assert st2["keys_scanned"] == len(keys)
    assert la == lc and ca == cc
    assert len(la) == len(keys) + 3 + 1
