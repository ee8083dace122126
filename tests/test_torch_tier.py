"""The port's tier plane (minio_tpu_torch/tier/, the engine's stub verbs,
the handlers' RestoreObject) held against minio_tpu's.

  * the stub repairs, on trees the reference's TransitionWorker wrote:
    the port's GET answers InvalidObjectState, its HEAD over HTTP carries
    the reference's storage-class and restore headers, its heal puts a
    stub's lost xl.meta back with metadata only and no dispatch, and its
    crawler expiry and DELETE free the remote copy; a stub the port wrote
    is read, healed and restored by the reference; a tier registry saved
    by either package loads in the other;
  * tests/test_tier.py's cases rebound to the port: the tier clients, the
    registry's CRUD rules and persistence, the end-to-end transition ->
    InvalidObjectState -> restore -> identical bytes -> reclaim flow, the
    overwrite skip and the commit precondition, dedup and the bound,
    noncurrent and multipart transitions, part-preserving restores, expiry
    winning over transition, the async restore and its ongoing gate, the
    HTTP restore flow and its 202, versioned ``null`` deletes keeping the
    remote copy, batch deletes freeing it, and the tier metrics. Left for
    their slices: test_admin_tier_crud_http, test_madmin_tier_client and
    test_admin_tier_delete_refuses_in_use (the admin router and madmin),
    and test_rebalance_moves_transitioned_stub (rebalance);
  * twin trees, reference and port, transitioned, restored and reclaimed
    under pinned identities: equal drive files and tier files at every
    stage; and twin servers fed one request sequence (PUT, lifecycle,
    crawl, HEAD, GET 403, restore, GET, reclaim, DELETE) under both
    transports: equal statuses, bodies, headers, drive files and tier
    files;
  * the port's own: the GET of an encrypted stub answering 403 before
    any transform (the reference's starts a 200 and breaks off: the
    record of the departure), gateway-typed tiers refused by name, a failed
    transition left fully local and queued for heal, a short tier read
    failing the restore with the stub kept, and a booted node whose
    crawler transitions, reclaims and expires through its wiring.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import os
import shutil
import time

import numpy as np
import pytest

import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu.features.crypto as ref_crypto
import minio_tpu.tier.config as ref_config
import minio_tpu.tier.transition as ref_transition
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
import minio_tpu_torch.tier.config as port_config
import minio_tpu_torch.tier.transition as port_transition
from minio_tpu.object.background import DataUsageCrawler as RefCrawler
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.tier.config import TierConfig as RefTierConfig
from minio_tpu.tier.config import TierManager as RefTierManager
from minio_tpu_torch.object import api_errors
from minio_tpu_torch.object.background import DataUsageCrawler
from minio_tpu_torch.object.engine import GetOptions, PutOptions
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage import datatypes as dt
from minio_tpu_torch.tier.client import (FSTierClient, GatewayTierClient,
                                         NaughtyTierClient, TierClientError,
                                         TierObjectNotFound,
                                         new_tier_client)
from minio_tpu_torch.tier.config import (TIER_CONFIG_OBJECT, TierConfig,
                                         TierConfigError, TierManager)
from minio_tpu_torch.tier.transition import (TransitionWorker, free_remote,
                                             noncurrent_transition_action,
                                             restore_object,
                                             restore_reclaim_action,
                                             transition_action)
from tests.test_s3 import CREDS, REGION, S3TestClient
from tests.test_torch_s3 import _norm, drive_files, pin

BLOCK = 1 << 16
DAY = 86400
NEVER_BUSY = dict(busy_fn=lambda: False)

LC_TRANSITION = """<LifecycleConfiguration>
  <Rule><ID>t</ID><Status>Enabled</Status><Prefix></Prefix>
    <Transition><Days>1</Days><StorageClass>cold</StorageClass>
    </Transition></Rule>
</LifecycleConfiguration>"""


def make_sets(tmp_path, tag: str = "p0", drives: int = 4,
              **kw) -> ErasureSets:
    return ErasureSets.from_drives(
        [str(tmp_path / f"{tag}d{i}") for i in range(drives)], 1,
        drives, 2, block_size=BLOCK, device="cpu", **kw)


def ref_zones(root, drives: int = 4) -> RefServerSets:
    return RefServerSets([RefSets.from_drives(
        [str(root / f"d{i}") for i in range(drives)], 1, drives, 2,
        block_size=BLOCK, enable_mrf=False)], load_topology=False)


def port_zones(root, drives: int = 4) -> ErasureServerSets:
    return ErasureServerSets([ErasureSets.from_drives(
        [str(root / f"d{i}") for i in range(drives)], 1, drives, 2,
        block_size=BLOCK, enable_mrf=False, device="cpu")],
        load_topology=False)


class FakeBucketMeta:
    """bucket_meta_sys stand-in: one lifecycle XML for every bucket."""

    def __init__(self, lifecycle_xml: str = "", versioned: bool = False):
        self.lifecycle_xml = lifecycle_xml
        self._versioned = versioned

    def get(self, bucket):
        return self

    def versioning_enabled(self) -> bool:
        return self._versioned


def tree_files(root) -> dict:
    """relative path -> sha256 of every file under root (a tier's)."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture()
def env(tmp_path):
    sets = make_sets(tmp_path, enable_mrf=False)
    zz = ErasureServerSets([sets])
    zz.make_bucket("b")
    tiers = TierManager(zz)
    tiers.add(TierConfig("cold", "fs", {"path": str(tmp_path / "tier")}))
    worker = TransitionWorker(zz, tiers, **NEVER_BUSY).start()
    yield zz, tiers, worker, tmp_path
    worker.close()
    zz.close()


# ---------------------------------------------------------------------------
# the stub repairs, on trees the reference wrote
# ---------------------------------------------------------------------------

def _ref_transitioned_tree(root, restored: bool = False):
    """The reference writes b/doc (200,000 B, unversioned) and b/kept,
    registers an fs tier `cold` at root/tier, transitions both with its
    TransitionWorker, and with `restored` restores b/kept."""
    zz = ref_zones(root / "drives")
    zz.make_bucket("b")
    tiers = RefTierManager(zz)
    tiers.add(RefTierConfig("cold", "fs", {"path": str(root / "tier")}))
    worker = ref_transition.TransitionWorker(zz, tiers, **NEVER_BUSY)
    payloads = {"doc": os.urandom(200_000), "kept": os.urandom(70_000)}
    for name, data in payloads.items():
        info = zz.put_object("b", name, data)
        worker.enqueue("b", name, "", "cold", etag=info.etag)
    worker.start()
    assert worker.drain(60), worker.stats()
    assert worker.stats()["moved"] == 2
    if restored:
        ref_transition.restore_object(zz, tiers, "b", "kept", days=3)
    worker.close()
    zz.close()
    return payloads


def test_port_get_of_a_reference_stub_is_invalid_object_state(tmp_path):
    payloads = _ref_transitioned_tree(tmp_path)
    zz = port_zones(tmp_path / "drives")
    try:
        with pytest.raises(api_errors.InvalidObjectState):
            zz.get_object("b", "doc")
        oi = zz.get_object_info("b", "doc")
        assert oi.size == len(payloads["doc"])
        assert oi.user_defined[dt.TRANSITION_TIER_KEY] == "cold"
        # the data directory is gone from every drive: only xl.meta
        for i in range(4):
            d = tmp_path / "drives" / f"d{i}" / "b" / "doc"
            assert sorted(p.name for p in d.iterdir()) == ["xl.meta"]
    finally:
        zz.close()


@pytest.mark.parametrize("edge", ["on", "off"])
def test_port_head_of_reference_stubs_answers_as_reference(
        tmp_path, monkeypatch, edge):
    """HEAD and GET of a stub and of a restored copy over HTTP: the
    port's server answers the reference's statuses, headers and bodies
    over the same drives (storage class = the tier, x-amz-restore)."""
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    payloads = _ref_transitioned_tree(tmp_path, restored=True)
    answers = {}
    for who in ("ref", "port"):
        if who == "ref":
            sets = RefSets.from_drives(
                [str(tmp_path / "drives" / f"d{i}") for i in range(4)],
                1, 4, 2, block_size=BLOCK)
            srv = RefServer(sets, creds=CREDS, region=REGION).start()
        else:
            sets = ErasureSets.from_drives(
                [str(tmp_path / "drives" / f"d{i}") for i in range(4)],
                1, 4, 2, block_size=BLOCK, device="cpu")
            srv = S3Server(sets, creds=CREDS, region=REGION).start()
        try:
            c = S3TestClient("127.0.0.1", srv.port)
            answers[who] = [_norm(c.request(m, f"/b/{k}"))
                            for k in ("doc", "kept")
                            for m in ("HEAD", "GET")]
        finally:
            srv.stop()
            sets.close()
    assert answers["port"] == answers["ref"]
    head_doc, get_doc, head_kept, get_kept = answers["port"]
    assert head_doc[1]["x-amz-storage-class"] == "cold"
    assert "x-amz-restore" not in head_doc[1]
    assert get_doc[0] == 403 and b"InvalidObjectState" in get_doc[2]
    assert head_kept[1]["x-amz-storage-class"] == "cold"
    assert 'ongoing-request="false"' in head_kept[1]["x-amz-restore"]
    assert get_kept[0] == 200 and get_kept[2] == payloads["kept"]


def test_get_of_an_encrypted_stub_answers_before_the_transform(
        tmp_path, monkeypatch):
    """The departure: the port's GET of an SSE-S3 (ChaCha20) stub answers
    403 InvalidObjectState; the reference's starts a 200 whose stream
    fails once its transformed read opens the layer (the record)."""
    import http.client
    monkeypatch.setenv("MINIO_SSE_MASTER_KEY", "4f" * 32)
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "chacha20")
    zz = ref_zones(tmp_path / "drives")
    zz.make_bucket("b")
    zz.close()
    answers = {}
    for who in ("ref", "port"):
        drives = [str(tmp_path / "drives" / f"d{i}") for i in range(4)]
        if who == "ref":
            sets = RefSets.from_drives(drives, 1, 4, 2, block_size=BLOCK)
            srv = RefServer(sets, creds=CREDS, region=REGION).start()
            tiers, tr = RefTierManager(sets), ref_transition
            tiers.add(RefTierConfig("cold", "fs",
                                    {"path": str(tmp_path / "t-ref")}))
        else:
            sets = ErasureSets.from_drives(drives, 1, 4, 2,
                                           block_size=BLOCK, device="cpu")
            srv = S3Server(sets, creds=CREDS, region=REGION).start()
            tiers, tr = TierManager(sets), port_transition
            tiers.add(TierConfig("cold", "fs",
                                 {"path": str(tmp_path / "t-port")}))
        worker = tr.TransitionWorker(sets, tiers, **NEVER_BUSY).start()
        try:
            c = S3TestClient("127.0.0.1", srv.port)
            st, h, _ = c.request("PUT", f"/b/{who}", body=os.urandom(
                200_000), headers={"x-amz-server-side-encryption":
                                   "AES256"})
            assert st == 200
            worker.enqueue("b", who, "", "cold", etag=h["etag"].strip('"'))
            assert worker.drain(30) and worker.stats()["moved"] == 1
            try:
                answers[who] = c.request("GET", f"/b/{who}")
            except http.client.IncompleteRead:
                answers[who] = "incomplete"
        finally:
            worker.close()
            srv.stop()
            sets.close()
    assert answers["ref"] == "incomplete"
    st, _h, body = answers["port"]
    assert st == 403 and b"<Code>InvalidObjectState</Code>" in body


def test_port_heals_a_stub_with_metadata_only(tmp_path, monkeypatch):
    """One drive's xl.meta of a reference stub removed: the port's heal
    writes it back with no codec (no dispatch), file-equal to the
    reference's own heal of the same tree."""
    _ref_transitioned_tree(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    for who in ("ref", "port"):
        os.remove(tmp_path / who / "drives" / "d1" / "b" / "doc" /
                  "xl.meta")

    def no_codec(*_a, **_k):
        raise AssertionError("a stub's heal built a codec")

    monkeypatch.setattr(port_engine.ErasureObjects, "codec", no_codec)
    zz = port_zones(tmp_path / "port" / "drives")
    try:
        res = zz.heal_object("b", "doc")
        assert (res.missing_before, res.disks_healed) == (1, 1)
        with pytest.raises(api_errors.InvalidObjectState):
            zz.get_object("b", "doc")
    finally:
        zz.close()
    rz = ref_zones(tmp_path / "ref" / "drives")
    try:
        rz.heal_object("b", "doc")
    finally:
        rz.close()
    want = drive_files(tmp_path / "ref" / "drives")
    got = drive_files(tmp_path / "port" / "drives")
    assert sorted(got) == sorted(want)
    assert [k for k in want if want[k] != got[k]] == []
    assert os.path.exists(tmp_path / "port" / "drives" / "d1" / "b" /
                          "doc" / "xl.meta")


def test_port_expiry_and_delete_free_reference_remote_copies(tmp_path):
    """The registry the reference saved loads in the port; the port's
    crawler expiry and its DELETE handler free the remote copies."""
    from minio_tpu_torch.features.lifecycle import crawler_action
    _ref_transitioned_tree(tmp_path)
    zz = port_zones(tmp_path / "drives")
    srv = None
    try:
        tiers = TierManager(zz)
        assert tiers.load() and set(tiers.tiers) == {"cold"}
        keys = {n: zz.get_object_info("b", n).user_defined[
            dt.TRANSITIONED_OBJECT_KEY] for n in ("doc", "kept")}
        cold = tiers.client("cold")
        assert all(cold.head(k) > 0 for k in keys.values())
        lc = ("<LifecycleConfiguration><Rule><Status>Enabled</Status>"
              "<Prefix>doc</Prefix><Expiration><Days>1</Days>"
              "</Expiration></Rule></LifecycleConfiguration>")
        act = crawler_action(FakeBucketMeta(lc), zz,
                             now_fn=lambda: time.time() + 2 * DAY,
                             tiers=tiers)
        act("b", zz.get_object_info("b", "doc"))
        with pytest.raises(api_errors.ObjectNotFound):
            zz.get_object_info("b", "doc")
        with pytest.raises(TierObjectNotFound):
            cold.head(keys["doc"])
        srv = S3Server(zz, creds=CREDS, region=REGION).start()
        srv.api.tiers = tiers
        c = S3TestClient("127.0.0.1", srv.port)
        assert c.request("DELETE", "/b/kept")[0] == 204
        with pytest.raises(TierObjectNotFound):
            cold.head(keys["kept"])
        assert tree_files(tmp_path / "tier") == {}
    finally:
        if srv is not None:
            srv.stop()
        zz.close()


def test_reference_reads_heals_and_restores_a_port_stub(tmp_path):
    zz = port_zones(tmp_path / "drives")
    zz.make_bucket("b")
    tiers = TierManager(zz)
    tiers.add(TierConfig("cold", "fs", {"path": str(tmp_path / "tier")}))
    worker = TransitionWorker(zz, tiers, **NEVER_BUSY).start()
    payload = os.urandom(150_000)
    try:
        info = zz.put_object("b", "doc", payload)
        worker.enqueue("b", "doc", "", "cold", etag=info.etag)
        assert worker.drain(30) and worker.stats()["moved"] == 1
    finally:
        worker.close()
        zz.close()
    os.remove(tmp_path / "drives" / "d3" / "b" / "doc" / "xl.meta")
    rz = ref_zones(tmp_path / "drives")
    try:
        from minio_tpu.object import api_errors as ref_errors
        with pytest.raises(ref_errors.InvalidObjectState):
            rz.get_object("b", "doc")
        res = rz.heal_object("b", "doc")
        assert res.disks_healed == 1
        rtiers = RefTierManager(rz)
        assert rtiers.load()
        ref_transition.restore_object(rz, rtiers, "b", "doc")
        oi, stream = rz.get_object("b", "doc")
        assert b"".join(stream) == payload and oi.etag == info.etag
    finally:
        rz.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tier_registry_loads_in_the_other_package(tmp_path, writer):
    """A registry saved by either package loads in the other: the same
    document, and the re-saved files byte-equal to the writer's."""
    if writer == "port":
        zz, mgr_cls, cfg_cls = port_zones(tmp_path / "drives"), \
            TierManager, TierConfig
    else:
        zz, mgr_cls, cfg_cls = ref_zones(tmp_path / "drives"), \
            RefTierManager, RefTierConfig
    try:
        w = mgr_cls(zz)
        w.add(cfg_cls("cold", "fs", {"path": str(tmp_path / "t1")}))
        w.add(cfg_cls("ice", "fs", {"path": str(tmp_path / "t2")}))
        w.remove("ice")
        doc = w.to_dict()
    finally:
        zz.close()
    raw = _registry_bytes(tmp_path / "drives")
    assert json.loads(raw) == doc
    if writer == "port":
        zz, mgr_cls = ref_zones(tmp_path / "drives"), RefTierManager
    else:
        zz, mgr_cls = port_zones(tmp_path / "drives"), TierManager
    try:
        r = mgr_cls(zz)
        assert r.load()
        assert r.to_dict() == doc
        assert r.epoch == 3 and list(r.tiers) == ["cold"]
        r.save()        # the reader's save writes the writer's bytes
    finally:
        zz.close()
    assert _registry_bytes(tmp_path / "drives") == raw


def _registry_bytes(drives) -> bytes:
    zz = port_zones(drives)
    try:
        _, s = zz.get_object(".minio.sys", TIER_CONFIG_OBJECT)
        return b"".join(s)
    finally:
        zz.close()


def test_put_stub_version_writes_the_references_stub(tmp_path):
    """A stub replayed by metadata (put_stub_version through
    faithful.replay_version, the stub's copy between pools): each
    package's copy of the reference's stub is the same file, and the copy
    restores from the unchanged remote copy."""
    from minio_tpu.object import faithful as ref_faithful
    from minio_tpu_torch.object import faithful
    payloads = _ref_transitioned_tree(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    for who, zones, mod in (("ref", ref_zones, ref_faithful),
                            ("port", port_zones, faithful)):
        zz = zones(tmp_path / who / "drives")
        try:
            zz.make_bucket("b2")
            spec = mod.spec_of(zz.get_object_info("b", "doc"))
            assert spec.transitioned_stub
            mod.replay_version(zz, "b2", "copy", spec)
        finally:
            zz.close()
    want = drive_files(tmp_path / "ref" / "drives")
    got = drive_files(tmp_path / "port" / "drives")
    assert sorted(got) == sorted(want)
    assert [k for k in want if want[k] != got[k]] == []
    zz = port_zones(tmp_path / "port" / "drives")
    try:
        with pytest.raises(api_errors.InvalidObjectState):
            zz.get_object("b2", "copy")
        tiers = TierManager(zz)
        assert tiers.load()
        restore_object(zz, tiers, "b2", "copy")
        _, s = zz.get_object("b2", "copy")
        assert b"".join(s) == payloads["doc"]
    finally:
        zz.close()


# ---------------------------------------------------------------------------
# tests/test_tier.py's cases, rebound
# ---------------------------------------------------------------------------

def test_fs_client_round_trip(tmp_path):
    c = FSTierClient(str(tmp_path / "t"))
    etag = c.put("b/o/v1/abc", io.BytesIO(b"x" * 1000), 1000)
    assert etag
    assert c.head("b/o/v1/abc") == 1000
    assert b"".join(c.get("b/o/v1/abc")) == b"x" * 1000
    assert b"".join(c.get("b/o/v1/abc", offset=10, length=5)) == b"xxxxx"
    c.delete("b/o/v1/abc")
    with pytest.raises(TierObjectNotFound):
        c.head("b/o/v1/abc")
    c.delete("b/o/v1/abc")          # idempotent
    assert os.listdir(tmp_path / "t") == []     # key dirs pruned


def test_fs_client_refuses_short_write(tmp_path):
    c = FSTierClient(str(tmp_path / "t"))
    with pytest.raises(TierClientError):
        c.put("k", io.BytesIO(b"short"), 1000)
    with pytest.raises(TierObjectNotFound):
        c.head("k")
    assert os.listdir(tmp_path / "t") == []     # no staged leftover


def test_fs_client_rejects_escaping_keys(tmp_path):
    c = FSTierClient(str(tmp_path / "t"))
    with pytest.raises(TierClientError):
        c.put("../../etc/shadow", io.BytesIO(b"x"), 1)


def test_gateway_client_over_a_port_layer(tmp_path):
    zz = port_zones(tmp_path / "remote")
    zz.make_bucket("warm")
    try:
        c = GatewayTierClient(zz, "warm", prefix="/cold/")
        data = os.urandom(100_000)
        assert c.put("b/o/null/1", io.BytesIO(data), len(data)) == \
            hashlib.md5(data).hexdigest()
        assert zz.get_object_info("warm", "cold/b/o/null/1").size == \
            len(data)
        assert c.head("b/o/null/1") == len(data)
        assert b"".join(c.get("b/o/null/1", 10, 20)) == data[10:30]
        c.delete("b/o/null/1")
        c.delete("b/o/null/1")
        with pytest.raises(TierObjectNotFound):
            c.head("b/o/null/1")
    finally:
        zz.close()


@pytest.mark.parametrize("type_", ["s3", "azure", "gcs", "hdfs"])
def test_gateway_tier_types_are_refused_by_name(tmp_path, type_):
    with pytest.raises(TierClientError, match="gateway plane"):
        new_tier_client(type_, {"host": "h", "bucket": "b"})
    zz = port_zones(tmp_path / "drives")
    try:
        with pytest.raises(TierConfigError, match="gateway plane"):
            TierManager(zz).add(TierConfig("r", type_, {"bucket": "b"}))
    finally:
        zz.close()


def test_tier_config_persists_across_pools_highest_epoch(tmp_path):
    zz = ErasureServerSets([make_sets(tmp_path, "p0", enable_mrf=False),
                            make_sets(tmp_path, "p1", enable_mrf=False)])
    try:
        tiers = TierManager(zz)
        tiers.add(TierConfig("cold", "fs",
                             {"path": str(tmp_path / "t1")}))
        tiers.add(TierConfig("ice", "fs",
                             {"path": str(tmp_path / "t2")}))
        assert tiers.epoch == 2

        t2 = TierManager(zz)
        assert t2.load()
        assert t2.epoch == 2
        assert {t["name"] for t in t2.list()} == {"cold", "ice"}

        # the highest epoch wins over a stale pool's document
        from minio_tpu_torch.storage.xl_storage import MINIO_META_BUCKET
        stale = {"epoch": 1, "tiers": [{"name": "old", "type": "fs",
                                        "params": {"path": "/x"}}]}
        zz.server_sets[1].put_object(MINIO_META_BUCKET,
                                     TIER_CONFIG_OBJECT,
                                     json.dumps(stale).encode())
        t3 = TierManager(zz)
        assert t3.load()
        assert t3.epoch == 2 and "cold" in t3.tiers
    finally:
        zz.close()


def test_tier_registry_crud_rules(env, tmp_path):
    zz, tiers, _, _ = env
    with pytest.raises(TierConfigError):
        tiers.add(TierConfig("cold", "fs",
                             {"path": str(tmp_path / "dup")}))
    tiers.add(TierConfig("cold", "fs", {"path": str(tmp_path / "dup")}),
              update=True)
    with pytest.raises(api_errors.TierNotFound):
        tiers.remove("nope")
    with pytest.raises(TierConfigError):
        tiers.add(TierConfig("bad", "fs", {}))        # fs needs path
    with pytest.raises(TierConfigError):
        tiers.add(TierConfig("bad", "wat", {}))       # unknown type
    # secrets are redacted in listings: an s3 tier the reference added
    # (the port refuses to add one) loads, listed redacted, and its load
    # names the gateway plane
    rtiers = RefTierManager(zz)
    rtiers.epoch = tiers.epoch
    rtiers.tiers = {"remote": RefTierConfig(
        "remote", "s3", {"host": "h", "bucket": "b", "access_key": "AK",
                         "secret_key": "SECRET"})}
    rtiers.epoch += 1
    rtiers.save()
    loaded = TierManager(zz)
    with pytest.raises(TierClientError, match="gateway plane"):
        loaded.load()
    listed = {t["name"]: t for t in loaded.list()}
    assert listed["remote"]["params"]["secret_key"] == "REDACTED"
    assert listed["remote"]["params"]["access_key"] == "AK"
    with pytest.raises(TierClientError, match="gateway plane"):
        loaded.client("remote")


def test_e2e_transition_restore_reclaim(env):
    """PUT -> the crawler transitions per the lifecycle rule -> GET
    answers InvalidObjectState -> RestoreObject -> GET serves identical
    bytes (etag, version id and mod time kept) -> the restore's expiry
    reclaims the local copy."""
    zz, tiers, worker, tmp_path = env
    payload = os.urandom(200_000)
    info = zz.put_object("b", "obj", payload,
                         opts=PutOptions(versioned=True))
    orig_vid, orig_etag, orig_mt = info.version_id, info.etag, \
        info.mod_time

    later = time.time() + 2 * DAY
    crawler = DataUsageCrawler(
        zz, persist=False,
        actions=[transition_action(FakeBucketMeta(LC_TRANSITION),
                                   worker, now_fn=lambda: later)])
    crawler.scan_once()
    assert worker.drain(30), worker.stats()
    assert worker.stats()["moved"] == 1

    with pytest.raises(api_errors.InvalidObjectState):
        zz.get_object("b", "obj")
    oi = zz.get_object_info("b", "obj")
    assert oi.size == len(payload)
    md = oi.user_defined
    assert md[dt.TRANSITION_STATUS_KEY] == dt.TRANSITION_COMPLETE
    assert md[dt.TRANSITION_TIER_KEY] == "cold"
    remote_key = md[dt.TRANSITIONED_OBJECT_KEY]
    assert tiers.client("cold").head(remote_key) == len(payload)

    for i in range(4):
        objdir = tmp_path / f"p0d{i}" / "b" / "obj"
        if objdir.exists():
            assert sorted(p.name for p in objdir.iterdir()) \
                == ["xl.meta"], list(objdir.iterdir())

    out = restore_object(zz, tiers, "b", "obj", days=1)
    assert out["status"] == "restored"
    oi2, stream = zz.get_object("b", "obj")
    assert b"".join(stream) == payload
    assert oi2.version_id == orig_vid
    assert oi2.etag == orig_etag
    assert oi2.mod_time == pytest.approx(orig_mt, abs=1e-6)
    assert dt.is_restored(oi2.user_defined)

    out2 = restore_object(zz, tiers, "b", "obj", days=7)
    assert out2["status"] == "updated"
    assert out2["expiry"] > out["expiry"]

    reclaim = restore_reclaim_action(zz, tiers,
                                     now_fn=lambda: time.time() + 30 * DAY)
    DataUsageCrawler(zz, persist=False, actions=[reclaim]).scan_once()
    with pytest.raises(api_errors.InvalidObjectState):
        zz.get_object("b", "obj")
    assert tiers.client("cold").head(remote_key) == len(payload)
    assert zz.get_object_info("b", "obj").version_id == orig_vid


def test_transition_skips_overwritten_object(env):
    zz, tiers, _, _ = env
    frozen = TransitionWorker(zz, tiers, **NEVER_BUSY)
    info = zz.put_object("b", "o", b"old" * 1000)
    frozen.enqueue("b", "o", "", "cold", etag=info.etag)
    zz.put_object("b", "o", b"new" * 2000)   # overwrite before the move
    frozen.start()
    assert frozen.drain(30)
    assert frozen.stats()["skipped"] == 1
    frozen.close()
    _, stream = zz.get_object("b", "o")
    assert b"".join(stream) == b"new" * 2000


def test_transition_worker_dedups_and_bounds(env):
    zz, tiers, worker, _ = env
    worker.close()
    small = TransitionWorker(zz, tiers, maxsize=2, **NEVER_BUSY)
    assert small.enqueue("b", "x", "", "cold")
    assert not small.enqueue("b", "x", "", "cold")     # dedup
    assert small.enqueue("b", "y", "", "cold")
    assert not small.enqueue("b", "z", "", "cold")     # over maxsize
    assert small.stats()["dropped"] == 1
    small.close()


def test_delete_frees_remote_copy(env):
    zz, tiers, worker, _ = env
    payload = b"c" * 50_000
    info = zz.put_object("b", "gone", payload)
    worker.enqueue("b", "gone", "", "cold", etag=info.etag)
    assert worker.drain(30)
    md = zz.get_object_info("b", "gone").user_defined
    remote_key = md[dt.TRANSITIONED_OBJECT_KEY]
    client = tiers.client("cold")
    assert client.head(remote_key) == len(payload)
    zz.delete_object("b", "gone")
    assert free_remote(tiers, md)
    with pytest.raises(TierObjectNotFound):
        client.head(remote_key)


def test_restore_requires_transitioned(env):
    zz, tiers, _, _ = env
    zz.put_object("b", "hot", b"h" * 100)
    with pytest.raises(api_errors.InvalidObjectState):
        restore_object(zz, tiers, "b", "hot")
    with pytest.raises(api_errors.InvalidObjectState):
        restore_object(zz, tiers, "b", "hot", days=0)


def test_noncurrent_transition_action(env):
    zz, tiers, worker, _ = env
    old = zz.put_object("b", "v", b"old" * 500,
                        opts=PutOptions(versioned=True))
    time.sleep(0.01)
    cur = zz.put_object("b", "v", b"new" * 500,
                        opts=PutOptions(versioned=True))
    lc = """<LifecycleConfiguration><Rule>
      <Status>Enabled</Status><Prefix></Prefix>
      <NoncurrentVersionTransition><NoncurrentDays>1</NoncurrentDays>
        <StorageClass>cold</StorageClass></NoncurrentVersionTransition>
    </Rule></LifecycleConfiguration>"""
    act = noncurrent_transition_action(
        FakeBucketMeta(lc), worker, now_fn=lambda: time.time() + 2 * DAY)
    act("b")
    assert worker.drain(30), worker.stats()
    assert worker.stats()["moved"] == 1
    _, stream = zz.get_object("b", "v")
    assert b"".join(stream) == b"new" * 500
    with pytest.raises(api_errors.InvalidObjectState):
        zz.get_object("b", "v", opts=GetOptions(version_id=old.version_id))
    restore_object(zz, tiers, "b", "v", version_id=old.version_id)
    _, stream = zz.get_object("b", "v",
                              opts=GetOptions(version_id=old.version_id))
    assert b"".join(stream) == b"old" * 500
    assert cur.version_id != old.version_id


def test_multipart_object_transitions_whole(env):
    """A multipart object's parts share one data dir: the stub rewrite
    reclaims every part and the restore brings the whole back."""
    zz, tiers, worker, _ = env
    part = os.urandom(5 << 20)
    uid = zz.new_multipart_upload("b", "mp")
    etags = [zz.put_object_part("b", "mp", uid, n, part, len(part)).etag
             for n in (1, 2)]
    zz.complete_multipart_upload(
        "b", "mp", uid, [CompletePart(i + 1, e)
                         for i, e in enumerate(etags)])
    info = zz.get_object_info("b", "mp")
    worker.enqueue("b", "mp", "", "cold", etag=info.etag)
    assert worker.drain(60)
    assert worker.stats()["moved"] == 1
    with pytest.raises(api_errors.InvalidObjectState):
        zz.get_object("b", "mp")
    restore_object(zz, tiers, "b", "mp")
    _, stream = zz.get_object("b", "mp")
    assert b"".join(stream) == part + part


def test_expiry_wins_over_transition(env):
    zz, tiers, worker, _ = env
    lc = """<LifecycleConfiguration><Rule>
      <Status>Enabled</Status><Prefix></Prefix>
      <Expiration><Days>1</Days></Expiration>
      <Transition><Days>1</Days><StorageClass>cold</StorageClass>
      </Transition></Rule></LifecycleConfiguration>"""
    zz.put_object("b", "both", b"x" * 1000)
    later = time.time() + 2 * DAY
    act = transition_action(FakeBucketMeta(lc), worker,
                            now_fn=lambda: later)
    act("b", zz.get_object_info("b", "both"))
    assert worker.pending() == 0


def test_tier_metrics_registered(env):
    from minio_tpu_torch.utils import telemetry
    zz, tiers, worker, _ = env
    objects = telemetry.REGISTRY.counter("minio_tpu_tier_objects_total")
    moved = telemetry.REGISTRY.counter("minio_tpu_tier_bytes_total")
    o0, b0 = objects.value(tier="cold"), moved.value(tier="cold")
    info = zz.put_object("b", "m", b"m" * 10_000)
    worker.enqueue("b", "m", "", "cold", etag=info.etag)
    assert worker.drain(30)
    assert objects.value(tier="cold") == o0 + 1
    assert moved.value(tier="cold") == b0 + 10_000


def test_transition_commit_precondition_aborts_on_overwrite(env):
    zz, tiers, _, _ = env
    zz.put_object("b", "race", b"current" * 100)
    with pytest.raises(api_errors.PreConditionFailed):
        zz.transition_object("b", "race", tier="cold",
                             remote_object="whatever",
                             expect_etag="not-the-etag")
    _, stream = zz.get_object("b", "race")
    assert b"".join(stream) == b"current" * 100


def _transition_now(zz, tiers, worker, bucket, name, vid=""):
    info = zz.get_object_info(bucket, name, GetOptions(version_id=vid))
    worker.enqueue(bucket, name, info.version_id, "cold",
                   etag=info.etag)
    assert worker.drain(30), worker.stats()
    return info


def test_multipart_restore_preserves_part_boundaries(env):
    zz, tiers, worker, _tmp = env
    p1, p2 = b"a" * (5 << 20), b"b" * (1 << 20)
    up = zz.new_multipart_upload("b", "mpr", PutOptions(versioned=True))
    e1 = zz.put_object_part("b", "mpr", up, 1, io.BytesIO(p1),
                            len(p1)).etag
    e2 = zz.put_object_part("b", "mpr", up, 2, io.BytesIO(p2),
                            len(p2)).etag
    info = zz.complete_multipart_upload(
        "b", "mpr", up, [CompletePart(1, e1), CompletePart(2, e2)])
    assert info.etag.endswith("-2")

    _transition_now(zz, tiers, worker, "b", "mpr", info.version_id)
    with pytest.raises(api_errors.InvalidObjectState):
        zz.get_object("b", "mpr")
    stub = zz.get_object_info("b", "mpr")
    assert [(p.number, p.size) for p in stub.parts] == \
        [(1, len(p1)), (2, len(p2))]

    restore_object(zz, tiers, "b", "mpr", version_id=info.version_id)
    got = zz.get_object_info("b", "mpr")
    assert got.etag == info.etag
    assert [(p.number, p.size) for p in got.parts] == \
        [(1, len(p1)), (2, len(p2))]
    assert got.version_id == info.version_id
    assert got.mod_time == info.mod_time
    _, stream = zz.get_object("b", "mpr")
    assert b"".join(stream) == p1 + p2
    _, stream = zz.get_object("b", "mpr", offset=(5 << 20) - 2, length=4)
    assert b"".join(stream) == b"aabb"


def test_async_restore_background_pull_and_ongoing_gate(env):
    from minio_tpu_torch.tier.transition import (clear_restore_ongoing,
                                                 mark_restore_ongoing)
    zz, tiers, worker, _tmp = env
    payload = os.urandom(1 << 18)
    zz.put_object("b", "bigr", payload, opts=PutOptions(versioned=True))
    info = _transition_now(zz, tiers, worker, "b", "bigr")

    mark_restore_ongoing(zz, "b", "bigr")
    md = zz.get_object_info("b", "bigr").user_defined
    assert dt.RESTORE_ONGOING in md.get(dt.RESTORE_KEY, "")
    with pytest.raises(api_errors.InvalidObjectState):
        zz.get_object("b", "bigr")          # ongoing != restored
    assert worker.enqueue_restore("b", "bigr", info.version_id, days=2)
    assert worker.drain(30), worker.stats()
    assert worker.stats()["restored"] == 1
    _, stream = zz.get_object("b", "bigr")
    assert b"".join(stream) == payload
    md = zz.get_object_info("b", "bigr").user_defined
    assert dt.RESTORE_ONGOING not in md.get(dt.RESTORE_KEY, "")

    # back to a stub; a FAILED background pull clears the marker
    zz.transition_object(
        "b", "bigr", version_id=info.version_id, tier="cold",
        remote_object=md[dt.TRANSITIONED_OBJECT_KEY],
        expect_etag=info.etag)
    naughty = NaughtyTierClient(tiers.client("cold"),
                                fail_verbs={"get": TierClientError("503")})
    tiers.set_client("cold", naughty)
    mark_restore_ongoing(zz, "b", "bigr")
    assert worker.enqueue_restore("b", "bigr", info.version_id, days=1)
    assert worker.drain(30), worker.stats()
    assert worker.stats()["restore_failed"] == 1
    md = zz.get_object_info("b", "bigr").user_defined
    assert dt.RESTORE_KEY not in md          # cleared: retryable
    naughty.clear_faults()
    restore_object(zz, tiers, "b", "bigr", version_id=info.version_id)
    _, stream = zz.get_object("b", "bigr")
    assert b"".join(stream) == payload
    clear_restore_ongoing(zz, "b", "bigr")   # no marker: a no-op
    assert dt.is_restored(zz.get_object_info("b", "bigr").user_defined)


# ---------------------------------------------------------------------------
# the port's own: failures stay local, short reads keep the stub
# ---------------------------------------------------------------------------

def test_failed_transition_stays_local_and_queues_heal(tmp_path):
    sets = make_sets(tmp_path, enable_mrf=False)
    zz = ErasureServerSets([sets])
    zz.make_bucket("b")
    tiers = TierManager(zz)
    tiers.add(TierConfig("cold", "fs", {"path": str(tmp_path / "tier")}))
    queued = []

    class _Mrf:
        def enqueue(self, bucket, name):
            queued.append((bucket, name))

        def close(self):
            pass

    sets.mrf = _Mrf()
    tiers.set_client("cold", NaughtyTierClient(
        tiers.client("cold"), fail_verbs={"put": TierClientError("503")}))
    worker = TransitionWorker(zz, tiers, **NEVER_BUSY).start()
    try:
        info = zz.put_object("b", "o", b"o" * 70_000)
        worker.enqueue("b", "o", "", "cold", etag=info.etag)
        assert worker.drain(30)
        assert worker.stats()["failed"] == 1 and queued == [("b", "o")]
        _, stream = zz.get_object("b", "o")
        assert b"".join(stream) == b"o" * 70_000
        assert not dt.is_transitioned(
            zz.get_object_info("b", "o").user_defined)
        assert tree_files(tmp_path / "tier") == {}
    finally:
        worker.close()
        zz.close()


def test_short_tier_read_fails_the_restore_and_keeps_the_stub(env):
    zz, tiers, worker, tmp_path = env
    payload = os.urandom(300_000)
    info = zz.put_object("b", "s", payload)
    _transition_now(zz, tiers, worker, "b", "s")
    before = drive_files(tmp_path)
    tiers.set_client("cold", NaughtyTierClient(
        tiers.client("cold"), short_read_verbs=("get",)))
    with pytest.raises(TierClientError, match="short tier read"):
        restore_object(zz, tiers, "b", "s")
    with pytest.raises(api_errors.InvalidObjectState):
        zz.get_object("b", "s")
    assert drive_files(tmp_path) == before
    tiers.client("cold").clear_faults()
    restore_object(zz, tiers, "b", "s")
    oi, stream = zz.get_object("b", "s")
    assert b"".join(stream) == payload and oi.etag == info.etag


# ---------------------------------------------------------------------------
# the HTTP surface (tests/test_tier.py's http_env, without the admin)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def http_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("tierdrives")
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(4)],
                                   set_count=1, set_drive_count=4, parity=2,
                                   block_size=BLOCK, device="cpu")
    srv = S3Server(sets, creds=CREDS, region=REGION).start()
    tiers = TierManager(sets)
    srv.api.tiers = tiers
    worker = TransitionWorker(sets, tiers, busy_fn=lambda: False).start()
    client = S3TestClient("127.0.0.1", srv.port)
    yield srv, client, tiers, worker, root
    worker.close()
    srv.stop()
    sets.close()


def test_restore_object_http_flow(http_env):
    srv, client, tiers, worker, root = http_env
    tiers.add(TierConfig("cold", "fs", {"path": str(root / "t")}),
              update=True)
    assert client.request("PUT", "/tierb")[0] == 200
    payload = os.urandom(120_000)
    status, headers, _ = client.request("PUT", "/tierb/doc", body=payload)
    assert status == 200
    etag = headers["etag"]
    worker.enqueue("tierb", "doc", "", "cold", etag=etag.strip('"'))
    assert worker.drain(30), worker.stats()

    status, _, body = client.request("GET", "/tierb/doc")
    assert status == 403 and b"InvalidObjectState" in body
    status, headers, _ = client.request("HEAD", "/tierb/doc")
    assert status == 200
    assert headers.get("x-amz-storage-class") == "cold"
    assert "x-amz-restore" not in headers

    body_xml = b"<RestoreRequest><Days>2</Days></RestoreRequest>"
    status, _, body = client.request("POST", "/tierb/doc",
                                     query={"restore": ""}, body=body_xml)
    assert status == 202, body
    status, _, _ = client.request("POST", "/tierb/doc",
                                  query={"restore": ""}, body=body_xml)
    assert status == 200

    status, headers, body = client.request("GET", "/tierb/doc")
    assert status == 200
    assert body == payload
    assert headers["etag"] == etag
    assert 'ongoing-request="false"' in headers.get("x-amz-restore", "")

    status, _, body = client.request("POST", "/tierb/doc",
                                     query={"restore": ""},
                                     body=b"<RestoreRequest><Days>")
    assert status == 400 and b"MalformedXML" in body

    client.request("PUT", "/tierb/hot", body=b"hot")
    status, _, body = client.request("POST", "/tierb/hot",
                                     query={"restore": ""}, body=body_xml)
    assert status == 403 and b"InvalidObjectState" in body

    md = srv.api.obj.get_object_info("tierb", "doc").user_defined
    remote_key = md[dt.TRANSITIONED_OBJECT_KEY]
    assert tiers.client("cold").head(remote_key) == len(payload)
    status, _, _ = client.request("DELETE", "/tierb/doc")
    assert status == 204
    with pytest.raises(TierObjectNotFound):
        tiers.client("cold").head(remote_key)


def test_versioned_null_delete_keeps_remote_copy(http_env):
    """DELETE ?versionId=null on a VERSIONED bucket lays a marker: the
    stub stays, so its remote copy must not be freed."""
    srv, client, tiers, worker, root = http_env
    tiers.add(TierConfig("cold", "fs", {"path": str(root / "t")}),
              update=True)
    client.request("PUT", "/verb")
    status, _, _ = client.request(
        "PUT", "/verb", query={"versioning": ""},
        body=b'<VersioningConfiguration><Status>Enabled</Status>'
             b'</VersioningConfiguration>')
    assert status == 200
    payload = b"versioned" * 2000
    status, h, _ = client.request("PUT", "/verb/doc", body=payload)
    assert status == 200
    vid = h["x-amz-version-id"]
    worker.enqueue("verb", "doc", vid, "cold", etag=h["etag"].strip('"'))
    assert worker.drain(30)
    md = srv.api.obj.get_object_info(
        "verb", "doc", GetOptions(version_id=vid)).user_defined
    remote_key = md[dt.TRANSITIONED_OBJECT_KEY]
    status, h, _ = client.request("DELETE", "/verb/doc",
                                  query={"versionId": "null"})
    assert status == 204 and h.get("x-amz-delete-marker") == "true"
    assert tiers.client("cold").head(remote_key) == len(payload)
    status, _, _ = client.request("DELETE", "/verb/doc",
                                  query={"versionId": vid})
    assert status == 204
    with pytest.raises(TierObjectNotFound):
        tiers.client("cold").head(remote_key)


def test_batch_delete_frees_remote_copies(http_env):
    srv, client, tiers, worker, root = http_env
    tiers.add(TierConfig("cold", "fs", {"path": str(root / "t")}),
              update=True)
    client.request("PUT", "/batchb")
    payload = b"bulk" * 3000
    status, h, _ = client.request("PUT", "/batchb/bulk1", body=payload)
    assert status == 200
    worker.enqueue("batchb", "bulk1", "", "cold", etag=h["etag"].strip('"'))
    assert worker.drain(30)
    md = srv.api.obj.get_object_info("batchb", "bulk1").user_defined
    remote_key = md[dt.TRANSITIONED_OBJECT_KEY]
    body = (b'<Delete><Object><Key>bulk1</Key></Object>'
            b'<Object><Key>missing</Key></Object></Delete>')
    status, _, resp = client.request(
        "POST", "/batchb", query={"delete": ""}, body=body,
        headers={"content-md5": ""})
    assert status == 200, resp
    with pytest.raises(TierObjectNotFound):
        tiers.client("cold").head(remote_key)


def test_restore_http_async_202(http_env, monkeypatch):
    """At or above MINIO_TPU_RESTORE_ASYNC_BYTES a RestoreObject answers
    202 at once with the pull on the worker, a duplicate answers
    RestoreAlreadyInProgress (409) while the marker is up, and the
    object reads once the pull lands."""
    srv, client, tiers, worker, root = http_env
    tiers.add(TierConfig("cold", "fs", {"path": str(root / "t")}),
              update=True)
    monkeypatch.setenv("MINIO_TPU_RESTORE_ASYNC_BYTES", "1024")
    srv.api.restore_worker = worker
    try:
        client.request("PUT", "/asyb")
        payload = os.urandom(1 << 16)
        status, headers, _ = client.request("PUT", "/asyb/big",
                                            body=payload)
        assert status == 200
        worker.enqueue("asyb", "big", "", "cold",
                       etag=headers["etag"].strip('"'))
        assert worker.drain(30), worker.stats()

        body_xml = b"<RestoreRequest><Days>1</Days></RestoreRequest>"
        status, _, _ = client.request("POST", "/asyb/big",
                                      query={"restore": ""}, body=body_xml)
        assert status == 202
        status2, _, body2 = client.request("POST", "/asyb/big",
                                           query={"restore": ""},
                                           body=body_xml)
        assert status2 in (200, 409), (status2, body2)
        if status2 == 409:
            assert b"RestoreAlreadyInProgress" in body2
        assert worker.drain(30), worker.stats()
        deadline = time.time() + 10
        while time.time() < deadline:
            status, headers, body = client.request("GET", "/asyb/big")
            if status == 200:
                break
            time.sleep(0.1)
        assert status == 200 and body == payload
        assert 'ongoing-request="false"' in headers.get("x-amz-restore",
                                                        "")
    finally:
        srv.api.restore_worker = None


def test_restore_without_tiers_answers_not_implemented(http_env):
    srv, client, tiers, _, _ = http_env
    srv.api.tiers = None
    try:
        client.request("PUT", "/nob")
        status, _, body = client.request("POST", "/nob/x",
                                         query={"restore": ""})
        assert status == 501 and b"NotImplemented" in body
    finally:
        srv.api.tiers = tiers


# ---------------------------------------------------------------------------
# twin trees: transitioned, restored and reclaimed by each package
# ---------------------------------------------------------------------------

class _FixedTime:
    @staticmethod
    def time():
        return 1.7e9


def pin_tier(monkeypatch, cfg_mod, tr_mod):
    """The tier plane's identity sources: the remote key's uuid, the
    registry's `updated` stamp and the restore's clock."""
    counter = itertools.count(1)
    monkeypatch.setattr(
        cfg_mod.TierManager, "remote_key",
        staticmethod(lambda b, o, v: f"{b}/{o}/{v or 'null'}/"
                                     f"{next(counter):032x}"))
    monkeypatch.setattr(cfg_mod, "time", _FixedTime)
    d = tr_mod.restore_object.__defaults__
    monkeypatch.setattr(tr_mod.restore_object, "__defaults__",
                        d[:-1] + (lambda: 1.7e9 + 7.0,))


def pin_both(monkeypatch):
    pin(monkeypatch, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(monkeypatch, port_engine, port_multipart, port_bmeta,
        port_handlers, port_crypto)
    pin_tier(monkeypatch, ref_config, ref_transition)
    pin_tier(monkeypatch, port_config, port_transition)


def _seed_twin(root):
    """The reference writes the seed: plain and versioned objects, a
    multipart object of 3 parts, and a noncurrent version."""
    rng = np.random.default_rng(5)
    zz = ref_zones(root)
    zz.make_bucket("b")
    data = {"plain": rng.bytes(250_001), "small": rng.bytes(999)}
    for name, d in data.items():
        zz.put_object("b", name, d)
    for i in range(2):
        data[f"ver{i}"] = rng.bytes(40_000 + i)
        zz.put_object("b", "ver", data[f"ver{i}"],
                      opts=ref_engine.PutOptions(versioned=True))
    up = zz.new_multipart_upload("b", "mp")
    parts = [rng.bytes(5 << 20), rng.bytes(5 << 20), rng.bytes(77_777)]
    data["mp"] = b"".join(parts)
    etags = [zz.put_object_part("b", "mp", up, n + 1, p, len(p)).etag
             for n, p in enumerate(parts)]
    zz.complete_multipart_upload(
        "b", "mp", up, [ref_multipart.CompletePart(n + 1, e)
                        for n, e in enumerate(etags)])
    zz.close()
    return data


def test_twin_trees_transition_restore_and_reclaim_alike(tmp_path,
                                                         monkeypatch):
    (tmp_path / "ref").mkdir()
    data = _seed_twin(tmp_path / "ref" / "drives")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    pin_both(monkeypatch)
    # the seed was written at the wall clock; only the restore's clock
    # is written down, and that one is pinned
    t_due = time.time() + 40 * DAY
    later = lambda: t_due                  # noqa: E731
    lc = FakeBucketMeta("""<LifecycleConfiguration><Rule>
      <Status>Enabled</Status><Prefix></Prefix>
      <Transition><Days>1</Days><StorageClass>cold</StorageClass>
      </Transition>
      <NoncurrentVersionTransition><NoncurrentDays>1</NoncurrentDays>
        <StorageClass>cold</StorageClass></NoncurrentVersionTransition>
    </Rule></LifecycleConfiguration>""")
    stacks = {}
    for who, zones, mgr, cfg, tr, crawler in (
            ("ref", ref_zones, RefTierManager, RefTierConfig,
             ref_transition, RefCrawler),
            ("port", port_zones, TierManager, TierConfig, port_transition,
             DataUsageCrawler)):
        zz = zones(tmp_path / who / "drives")
        tiers = mgr(zz)
        # the registry records the tier's path: the same relative one,
        # resolved in each package's own directory
        monkeypatch.chdir(tmp_path / who)
        tiers.add(cfg("cold", "fs", {"path": "tier"}))
        worker = tr.TransitionWorker(zz, tiers, **NEVER_BUSY)
        stacks[who] = (zz, tiers, worker, tr, crawler)

    def compare(stage):
        want = drive_files(tmp_path / "ref" / "drives")
        got = drive_files(tmp_path / "port" / "drives")
        assert sorted(got) == sorted(want), stage
        assert [k for k in want if want[k] != got[k]] == [], stage
        assert tree_files(tmp_path / "port" / "tier") == \
            tree_files(tmp_path / "ref" / "tier"), stage

    try:
        # transition: one crawler pass each, then the worker drains in
        # the order the pass enqueued
        for zz, tiers, worker, tr, crawler in stacks.values():
            crawler(zz, persist=False,
                    actions=[tr.transition_action(lc, worker,
                                                  now_fn=later)],
                    bucket_actions=[tr.noncurrent_transition_action(
                        lc, worker, now_fn=later)]).scan_once()
            worker.start()
            assert worker.drain(60), worker.stats()
            assert worker.stats()["moved"] == 5, worker.stats()
        compare("transition")
        tier_sizes = sorted(os.path.getsize(os.path.join(d, f))
                            for d, _, fs in os.walk(tmp_path / "port" /
                                                    "tier") for f in fs)
        assert tier_sizes == sorted(len(data[k]) for k in
                                    ("plain", "small", "ver0", "ver1",
                                     "mp"))
        # restore every version
        for zz, tiers, worker, tr, crawler in stacks.values():
            for v in zz.list_object_versions("b")[0]:
                tr.restore_object(zz, tiers, "b", v.name,
                                  version_id=v.version_id, days=2)
        compare("restore")
        zp = stacks["port"][0]
        for v in zp.list_object_versions("b")[0]:
            _, s = zp.get_object("b", v.name,
                                 opts=GetOptions(version_id=v.version_id))
            key = v.name if v.name != "ver" else \
                ("ver1" if v.is_latest else "ver0")
            assert b"".join(s) == data[key], v.name
        assert [p.number for p in zp.get_object_info("b", "mp").parts] \
            == [1, 2, 3]
        # reclaim past the expiry
        for zz, tiers, worker, tr, crawler in stacks.values():
            crawler(zz, persist=False, actions=[tr.restore_reclaim_action(
                zz, tiers, now_fn=lambda: 1.7e9 + 90 * DAY)]).scan_once()
        compare("reclaim")
        for name in ("plain", "mp"):
            with pytest.raises(api_errors.InvalidObjectState):
                zp.get_object("b", name)
    finally:
        for zz, _tiers, worker, _tr, _c in stacks.values():
            worker.close()
            zz.close()


# ---------------------------------------------------------------------------
# twin servers: one request sequence, both packages
# ---------------------------------------------------------------------------

def _xml_complete(etags) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags)) +
        "</CompleteMultipartUpload>").encode()


def _twin_steps(data):
    """Each step: (port, client, stack) -> (status, headers, body); a
    pseudo-step drives the package's crawler and worker, or lists the
    tier's files, and reports them as a body."""
    later = lambda: 1.7e9 + 40 * DAY        # noqa: E731
    lc = ("<LifecycleConfiguration><Rule><ID>t</ID><Status>Enabled"
          "</Status><Filter><Prefix></Prefix></Filter><Transition><Days>1"
          "</Days><StorageClass>cold</StorageClass></Transition></Rule>"
          "</LifecycleConfiguration>").encode()
    restore = b"<RestoreRequest><Days>2</Days></RestoreRequest>"

    def req(method, path, **kw):
        return lambda c, st: c.request(method, path, **kw)

    def crawl(action):
        def step(c, st):
            srv, tiers, worker, tr, crawler = st["stack"]
            acts = {"transition": [tr.transition_action(
                        srv.api.bucket_meta, worker, now_fn=later)],
                    "reclaim": [tr.restore_reclaim_action(
                        srv.api.obj, tiers,
                        now_fn=lambda: 1.7e9 + 90 * DAY)]}[action]
            usage = crawler(srv.api.obj, persist=False,
                            actions=acts).scan_once()
            assert worker.drain(60)
            s = worker.stats()
            return 0, {}, json.dumps(
                [usage["buckets"], s["moved"], s["failed"]]).encode()
        return step

    def tier_listing(c, st):
        return 0, {}, json.dumps(tree_files(st["tier_root"]),
                                 sort_keys=True).encode()

    def mp_upload(c, st):
        s, _, body = c.request("POST", "/twinb/mp", query={"uploads": ""})
        assert s == 200, body
        uid = body.split(b"<UploadId>")[1].split(b"<")[0].decode()
        etags = []
        for n, p in enumerate(data["parts"]):
            s, h, _ = c.request("PUT", "/twinb/mp", body=p,
                                query={"partNumber": str(n + 1),
                                       "uploadId": uid})
            etags.append(h["etag"])
        return c.request("POST", "/twinb/mp", query={"uploadId": uid},
                         body=_xml_complete(etags))

    mp_len = sum(map(len, data["parts"]))
    cut = len(data["parts"][0])
    return [
        req("PUT", "/twinb"),
        req("PUT", "/twinb/doc", body=data["doc"]),
        req("PUT", "/twinb/tiny", body=data["tiny"]),
        mp_upload,
        req("PUT", "/twinb", query={"lifecycle": ""}, body=lc),
        req("GET", "/twinb", query={"lifecycle": ""}),
        crawl("transition"),
        tier_listing,
        req("HEAD", "/twinb/doc"), req("HEAD", "/twinb/mp"),
        req("GET", "/twinb/doc"), req("GET", "/twinb/mp"),
        req("GET", "/twinb", query={"list-type": "2"}),
        req("POST", "/twinb/doc", query={"restore": ""}, body=restore),
        req("POST", "/twinb/doc", query={"restore": ""}, body=restore),
        req("POST", "/twinb/mp", query={"restore": ""}),
        req("HEAD", "/twinb/doc"),
        req("GET", "/twinb/doc"), req("GET", "/twinb/mp"),
        req("GET", "/twinb/mp", headers={"range": f"bytes={cut - 3}-{cut + 3}"}),
        req("GET", "/twinb/tiny"),
        crawl("reclaim"),
        req("GET", "/twinb/doc"), req("HEAD", "/twinb/mp"),
        tier_listing,
        req("DELETE", "/twinb/doc"),
        tier_listing,
        req("POST", "/twinb", query={"delete": ""},
            body=b"<Delete><Object><Key>mp</Key></Object><Object><Key>"
                 b"tiny</Key></Object></Delete>"),
        tier_listing,
        req("GET", "/twinb", query={"list-type": "2"}),
        lambda c, st: (0, {}, str(mp_len).encode()),
    ]


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_servers_tier_sequence(tmp_path, monkeypatch, edge):
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    pin_both(monkeypatch)
    rng = np.random.default_rng(17)
    data = {"doc": rng.bytes(300_007), "tiny": rng.bytes(1_500),
            "parts": [rng.bytes(5 << 20), rng.bytes(123_457)]}
    states = []
    for who in ("ref", "port"):
        root = tmp_path / who
        drives = [str(root / "drives" / f"d{i}") for i in range(4)]
        if who == "ref":
            sets = RefSets.from_drives(drives, 1, 4, 2, block_size=BLOCK,
                                       enable_mrf=False)
            srv = RefServer(sets, creds=CREDS, region=REGION).start()
            tiers = RefTierManager(sets)
            monkeypatch.chdir(root)
            tiers.add(RefTierConfig("cold", "fs", {"path": "tier"}))
            tr, crawler = ref_transition, RefCrawler
        else:
            sets = ErasureSets.from_drives(drives, 1, 4, 2,
                                           block_size=BLOCK,
                                           enable_mrf=False, device="cpu")
            srv = S3Server(sets, creds=CREDS, region=REGION).start()
            tiers = TierManager(sets)
            monkeypatch.chdir(root)
            tiers.add(TierConfig("cold", "fs", {"path": "tier"}))
            tr, crawler = port_transition, DataUsageCrawler
        srv.api.tiers = tiers
        worker = tr.TransitionWorker(sets, tiers, **NEVER_BUSY).start()
        srv.api.restore_worker = worker
        states.append({"stack": (srv, tiers, worker, tr, crawler),
                       "sets": sets, "tier_root": root / "tier",
                       "client": S3TestClient("127.0.0.1", srv.port)})
    try:
        outs = []
        for i, step in enumerate(_twin_steps(data)):
            a, b = (_norm(step(st["client"], st)) for st in states)
            assert a[0] == b[0], f"step {i}: status {a[0]} != {b[0]}"
            assert a[1] == b[1], f"step {i}: headers differ"
            assert a[2] == b[2], f"step {i}: bodies differ"
            outs.append(b)
        # the sequence did what it says
        assert [o[0] for o in outs[:6]] == [200] * 6
        assert outs[6][2].startswith(b"[{") and \
            json.loads(outs[6][2])[1:] == [3, 0]
        assert outs[8][1]["x-amz-storage-class"] == "cold"
        assert outs[10][0] == 403 and outs[11][0] == 403
        assert (outs[13][0], outs[14][0], outs[15][0]) == (202, 200, 202)
        assert outs[17][2] == data["doc"]
        assert outs[18][2] == b"".join(data["parts"])
        assert outs[19][0] == 206
        assert outs[22][0] == 403
        assert outs[20][0] == 403               # tiny: never restored
        assert len(json.loads(outs[7][2])) == 3
        assert json.loads(outs[24][2]) == json.loads(outs[7][2])
        assert len(json.loads(outs[26][2])) == 2
        assert json.loads(outs[28][2]) == {}
    finally:
        for st in states:
            srv, _tiers, worker, _tr, _c = st["stack"]
            worker.close()
            srv.stop()
            st["sets"].close()
    want = drive_files(tmp_path / "ref" / "drives")
    got = drive_files(tmp_path / "port" / "drives")
    assert sorted(got) == sorted(want)
    assert [k for k in want if want[k] != got[k]] == []


# ---------------------------------------------------------------------------
# a booted node: the crawler's tier actions through the boot's wiring
# ---------------------------------------------------------------------------

def test_booted_node_transitions_restores_and_expires(tmp_path):
    from minio_tpu_torch import cluster
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    creds = Credentials("tiertestaccess", "tiertestsecret1")
    node = cluster.start_single([str(tmp_path / "d{1...4}")], creds=creds,
                                parity=2, block_size=BLOCK, device="cpu")
    try:
        assert node.tiers is node.s3.api.tiers
        assert node.s3.api.restore_worker is node.transition_worker
        node.tiers.add(TierConfig("cold", "fs",
                                  {"path": str(tmp_path / "tier")}))
        c = S3Client(node.s3.port, creds)
        assert c.send("PUT", "/nodeb")[0] == 200
        payload = os.urandom(90_000)
        assert c.send("PUT", "/nodeb/o", body=payload)[0] == 200
        doc = ("<LifecycleConfiguration><Rule><ID>t</ID><Status>Enabled"
               "</Status><Filter><Prefix></Prefix></Filter><Transition>"
               "<Date>2020-01-01T00:00:00Z</Date><StorageClass>cold"
               "</StorageClass></Transition></Rule>"
               "</LifecycleConfiguration>").encode()
        assert c.send("PUT", "/nodeb", query={"lifecycle": ""},
                      body=doc)[0] == 200
        assert node.metacache.drain(10)
        node.crawler.scan_once()
        assert node.transition_worker.drain(30)
        assert node.transition_worker.stats()["moved"] == 1
        st, h, body = c.send("GET", "/nodeb/o")
        assert st == 403 and b"InvalidObjectState" in body
        assert c.send("HEAD", "/nodeb/o")[1]["x-amz-storage-class"] == "cold"
        assert c.send("POST", "/nodeb/o", query={"restore": ""})[0] == 202
        assert c.send("GET", "/nodeb/o")[2] == payload
        # the boot's expiry action frees the remote copy
        doc = ("<LifecycleConfiguration><Rule><ID>x</ID><Status>Enabled"
               "</Status><Filter><Prefix></Prefix></Filter><Expiration>"
               "<Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>"
               "</LifecycleConfiguration>").encode()
        assert c.send("PUT", "/nodeb", query={"lifecycle": ""},
                      body=doc)[0] == 200
        assert len(tree_files(tmp_path / "tier")) == 1
        assert node.metacache.drain(10)
        node.crawler.scan_once()
        assert c.send("GET", "/nodeb/o")[0] == 404
        assert tree_files(tmp_path / "tier") == {}
        # the registry persisted: a second boot over the drives loads it
    finally:
        node.shutdown()
    node = cluster.start_single([str(tmp_path / "d{1...4}")], creds=creds,
                                parity=2, block_size=BLOCK, device="cpu")
    try:
        assert list(node.tiers.tiers) == ["cold"]
    finally:
        node.shutdown()
