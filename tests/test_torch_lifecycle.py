"""The port's lifecycle plane (minio_tpu_torch/features/lifecycle.py and
the crawler's actions in object/background.py) held against minio_tpu's.

tests/test_features.py's lifecycle cases rebound to the port (parse and
evaluation, expiry by the crawler, noncurrent-version expiry,
AbortIncompleteMultipartUpload with an injected clock, the Transition
and NoncurrentVersionTransition parser); then:

  * the rules of either package parsed from the same documents agree
    field for field;
  * the crawler takes the metacache feed (no merge walk) and still
    expires;
  * an overwrite newer than the feed's view survives the expiry: the
    port re-stats before it deletes, the reference deletes on the
    feed's mod time (kept as the record of the departure);
  * twin trees the reference wrote, each package's crawler with its
    actions (expiry, noncurrent sweep, multipart abort) at the same
    clock: the same versions deleted, the same markers laid, the same
    uploads aborted;
  * twin crawlers handed their package's event notifier send equal
    s3:ObjectRemoved:Lifecycle records (eventTime aside);
  * a booted node: a lifecycle document PUT over HTTP, one crawler pass,
    the expired objects answer 404 and the index lists the others;
  * tests/test_tier.py's ``tiers=`` expiry cases: expiring a transitioned
    object (unversioned) or a transitioned noncurrent version frees its
    remote copy; a versioned expiry lays a marker and keeps it; the feed's
    version lists carry the transition pointers the sweep frees by.
"""

from __future__ import annotations

import dataclasses
import shutil
import time

import pytest

import minio_tpu.features.lifecycle as ref_lc
import minio_tpu.object.background as ref_bg
from minio_tpu.object import PutOptions as RefPutOptions
from minio_tpu.object.bucket_metadata import BucketMetadataSys as RefMeta
from minio_tpu.object.metacache import MetacacheManager as RefManager
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu_torch.features import lifecycle as port_lc
from minio_tpu_torch.features.lifecycle import Lifecycle, crawler_action
from minio_tpu_torch.object import PutOptions, api_errors
from minio_tpu_torch.object import background as port_bg
from minio_tpu_torch.object.background import DataUsageCrawler
from minio_tpu_torch.object.bucket_metadata import BucketMetadataSys
from minio_tpu_torch.object.metacache import (MetacacheManager,
                                              walks_counter)
from minio_tpu_torch.object.server_sets import ErasureServerSets
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.handlers import S3ApiHandlers

LC_XML = """<LifecycleConfiguration>
  <Rule><ID>exp-tmp</ID><Status>Enabled</Status>
    <Filter><Prefix>tmp/</Prefix></Filter>
    <Expiration><Days>1</Days></Expiration></Rule>
  <Rule><ID>off</ID><Status>Disabled</Status>
    <Filter><Prefix>keep/</Prefix></Filter>
    <Expiration><Days>1</Days></Expiration></Rule>
</LifecycleConfiguration>"""


def _mk_sets(root, n=4, parity=2):
    drives = [str(root / f"d{i}") for i in range(n)]
    return ErasureSets.from_drives(drives, set_count=1, set_drive_count=n,
                                   parity=parity, block_size=1 << 16,
                                   device="cpu")


# ---------------------------------------------------------------------------
# tests/test_features.py's lifecycle cases, rebound
# ---------------------------------------------------------------------------

def test_lifecycle_parse_and_eval():
    lc = Lifecycle.from_xml(LC_XML)
    assert len(lc.rules) == 2
    now = time.time()
    old = now - 2 * 86400
    assert lc.is_expired("tmp/a", old, now)
    assert not lc.is_expired("tmp/a", now, now)         # too young
    assert not lc.is_expired("data/a", old, now)        # prefix miss
    assert not lc.is_expired("keep/a", old, now)        # disabled rule


def test_lifecycle_enforced_by_crawler(tmp_path):
    sets = _mk_sets(tmp_path)
    api = S3ApiHandlers(sets)
    sets.make_bucket("lc")
    sets.put_object("lc", "tmp/old", b"stale")
    sets.put_object("lc", "data/fresh", b"fresh")
    api.bucket_meta.update("lc", lifecycle_xml=LC_XML)

    # pretend 2 days pass (inject the clock instead of rewriting mtimes)
    future = time.time() + 2 * 86400
    crawler = DataUsageCrawler(
        sets, persist=False,
        actions=[crawler_action(api.bucket_meta, sets,
                                now_fn=lambda: future)])
    crawler.scan_once()

    with pytest.raises(api_errors.ObjectNotFound):
        sets.get_object_info("lc", "tmp/old")
    assert sets.get_object_info("lc", "data/fresh").size == 5
    sets.close()


def test_noncurrent_version_expiry(tmp_path):
    """NoncurrentVersionExpiration: the clock starts when a version
    BECAME noncurrent (its successor's mod time), the sweep runs per
    bucket so delete-marker-latest keys are covered too."""
    from minio_tpu_torch.features.lifecycle import noncurrent_sweep_action
    sets = _mk_sets(tmp_path)
    api = S3ApiHandlers(sets)
    sets.make_bucket("ncb")
    api.bucket_meta.update("ncb", versioning="Enabled")
    for i in range(3):
        sets.put_object("ncb", "doc", f"v{i}".encode(),
                        opts=PutOptions(versioned=True))
    assert len(sets.list_object_versions("ncb", prefix="doc")[0]) == 3
    # a second key whose LATEST is a delete marker (invisible to
    # object listings)
    sets.put_object("ncb", "gone", b"old",
                    opts=PutOptions(versioned=True))
    sets.delete_object("ncb", "gone", versioned=True)

    lc = ("<LifecycleConfiguration><Rule><ID>nc</ID>"
          "<Status>Enabled</Status><Filter><Prefix></Prefix></Filter>"
          "<NoncurrentVersionExpiration><NoncurrentDays>1"
          "</NoncurrentDays></NoncurrentVersionExpiration>"
          "</Rule></LifecycleConfiguration>")
    api.bucket_meta.update("ncb", lifecycle_xml=lc)

    # versions became noncurrent "now": a sweep at +12h must keep them
    now = time.time()
    act = noncurrent_sweep_action(api.bucket_meta, sets,
                                  now_fn=lambda: now + 12 * 3600)
    act("ncb")
    assert len(sets.list_object_versions("ncb", prefix="doc")[0]) == 3

    # at +2d they are past NoncurrentDays=1: only the latest survives,
    # and the delete-marker key's data version is purged too
    act2 = noncurrent_sweep_action(api.bucket_meta, sets,
                                   now_fn=lambda: now + 2 * 86400)
    act2("ncb")
    versions = sets.list_object_versions("ncb", prefix="doc")[0]
    assert len(versions) == 1 and versions[0].is_latest
    _, stream = sets.get_object("ncb", "doc")
    assert b"".join(stream) == b"v2"
    gone = sets.list_object_versions("ncb", prefix="gone")[0]
    assert all(v.delete_marker for v in gone)
    sets.close()


def test_stale_multipart_abort(tmp_path):
    """AbortIncompleteMultipartUpload: uploads older than the cutoff are
    aborted; younger ones survive (mpu_abort_action with a now_fn)."""
    from minio_tpu_torch.features.lifecycle import mpu_abort_action
    sets = _mk_sets(tmp_path)
    api = S3ApiHandlers(sets)
    sets.make_bucket("mab")
    uid_a = sets.new_multipart_upload("mab", "upload-a")
    uid_b = sets.new_multipart_upload("mab", "upload-b")
    lc = ("<LifecycleConfiguration><Rule><ID>abort</ID>"
          "<Status>Enabled</Status><Filter><Prefix></Prefix></Filter>"
          "<AbortIncompleteMultipartUpload><DaysAfterInitiation>3"
          "</DaysAfterInitiation></AbortIncompleteMultipartUpload>"
          "</Rule></LifecycleConfiguration>")
    api.bucket_meta.update("mab", lifecycle_xml=lc)
    now = time.time()

    # +2 days: both uploads younger than the 3-day cutoff -> kept
    mpu_abort_action(api.bucket_meta, sets,
                     now_fn=lambda: now + 2 * 86400)("mab")
    assert {u["upload_id"] for u in sets.list_multipart_uploads("mab")} \
        == {uid_a, uid_b}

    # +4 days: both past the cutoff -> aborted
    mpu_abort_action(api.bucket_meta, sets,
                     now_fn=lambda: now + 4 * 86400)("mab")
    assert sets.list_multipart_uploads("mab") == []
    sets.close()


def test_lifecycle_transition_parse_days_and_storage_class():
    lc = Lifecycle.from_xml("""<LifecycleConfiguration>
      <Rule><ID>t1</ID><Status>Enabled</Status><Prefix>logs/</Prefix>
        <Transition><Days>30</Days><StorageClass>GLACIER</StorageClass>
        </Transition>
        <NoncurrentVersionTransition><NoncurrentDays>7</NoncurrentDays>
          <StorageClass>DEEP</StorageClass>
        </NoncurrentVersionTransition>
      </Rule>
    </LifecycleConfiguration>""")
    r = lc.rules[0]
    assert r.transition_days == 30
    assert r.transition_tier == "GLACIER"
    assert r.noncurrent_transition_days == 7
    assert r.noncurrent_transition_tier == "DEEP"
    now = time.time()
    # not due before 30 days, due after; prefix must match
    assert lc.transition_due("logs/a", now - 10 * 86400, now) == ""
    assert lc.transition_due("logs/a", now - 31 * 86400, now) == "GLACIER"
    assert lc.transition_due("other/a", now - 31 * 86400, now) == ""
    assert lc.noncurrent_transition("logs/a") == (7, "DEEP")
    assert lc.noncurrent_transition("other/a") == (0, "")


def test_lifecycle_transition_parse_date():
    lc = Lifecycle.from_xml("""<LifecycleConfiguration>
      <Rule><Status>Enabled</Status><Prefix></Prefix>
        <Transition><Date>2020-01-01T00:00:00Z</Date>
          <StorageClass>cold</StorageClass></Transition>
      </Rule>
    </LifecycleConfiguration>""")
    r = lc.rules[0]
    assert r.transition_date > 0 and r.transition_days == 0
    # the date is long past: any object is due regardless of age
    assert lc.transition_due("k", time.time(), time.time()) == "cold"


def test_lifecycle_transition_namespaced_xml():
    ns = "http://s3.amazonaws.com/doc/2006-03-01/"
    lc = Lifecycle.from_xml(
        f'<LifecycleConfiguration xmlns="{ns}">'
        "<Rule><Status>Enabled</Status><Prefix></Prefix>"
        "<Transition><Days>1</Days><StorageClass>tz</StorageClass>"
        "</Transition></Rule></LifecycleConfiguration>")
    assert lc.rules[0].transition_tier == "tz"
    assert lc.rules[0].transition_days == 1


def test_lifecycle_transition_precedence_vs_expiry():
    """Expiry wins when both are due (transition_due answers "")."""
    lc = Lifecycle.from_xml("""<LifecycleConfiguration>
      <Rule><Status>Enabled</Status><Prefix></Prefix>
        <Expiration><Days>5</Days></Expiration>
        <Transition><Days>1</Days><StorageClass>cold</StorageClass>
        </Transition>
      </Rule>
    </LifecycleConfiguration>""")
    now = time.time()
    # only the transition is due: transition wins
    assert lc.transition_due("k", now - 2 * 86400, now) == "cold"
    # both due: expiry wins
    assert lc.transition_due("k", now - 6 * 86400, now) == ""
    assert lc.is_expired("k", now - 6 * 86400, now)


def test_lifecycle_transition_disabled_and_tierless_rules_ignored():
    lc = Lifecycle.from_xml("""<LifecycleConfiguration>
      <Rule><Status>Disabled</Status><Prefix></Prefix>
        <Transition><Days>1</Days><StorageClass>cold</StorageClass>
        </Transition></Rule>
      <Rule><Status>Enabled</Status><Prefix></Prefix>
        <Transition><Days>1</Days></Transition></Rule>
    </LifecycleConfiguration>""")
    now = time.time()
    # disabled rule + rule with no StorageClass: nothing actionable
    assert lc.transition_due("k", now - 9 * 86400, now) == ""


def test_lifecycle_malformed_xml_raises():
    import xml.etree.ElementTree as ET
    with pytest.raises(ET.ParseError):
        Lifecycle.from_xml("<LifecycleConfiguration><Rule>")
    with pytest.raises(ValueError):
        Lifecycle.from_xml("""<LifecycleConfiguration>
          <Rule><Status>Enabled</Status><Prefix></Prefix>
            <Transition><Days>NaN</Days>
              <StorageClass>c</StorageClass></Transition>
          </Rule></LifecycleConfiguration>""")


def test_lifecycle_noncurrent_transition_strictest_rule_wins():
    lc = Lifecycle.from_xml("""<LifecycleConfiguration>
      <Rule><Status>Enabled</Status><Prefix></Prefix>
        <NoncurrentVersionTransition><NoncurrentDays>30</NoncurrentDays>
          <StorageClass>warm</StorageClass>
        </NoncurrentVersionTransition></Rule>
      <Rule><Status>Enabled</Status><Prefix></Prefix>
        <NoncurrentVersionTransition><NoncurrentDays>7</NoncurrentDays>
          <StorageClass>cold</StorageClass>
        </NoncurrentVersionTransition></Rule>
    </LifecycleConfiguration>""")
    assert lc.noncurrent_transition("any") == (7, "cold")


# ---------------------------------------------------------------------------
# the parser against the reference's
# ---------------------------------------------------------------------------

FULL_XML = """<LifecycleConfiguration
    xmlns="http://s3.amazonaws.com/doc/2006-03-01/">
  <Rule><ID>a</ID><Status>Enabled</Status>
    <Filter><And><Prefix>logs/</Prefix><Tag><Key>k</Key><Value>v</Value>
    </Tag></And></Filter>
    <Expiration><Date>2021-03-04T00:00:00Z</Date></Expiration>
    <NoncurrentVersionExpiration><NoncurrentDays>9</NoncurrentDays>
    </NoncurrentVersionExpiration>
    <AbortIncompleteMultipartUpload><DaysAfterInitiation>2
    </DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>
  <Rule><Status>Disabled</Status><Prefix>old/</Prefix>
    <Expiration><Days>3</Days></Expiration>
    <Transition><Date>2030-01-01T00:00:00Z</Date>
      <StorageClass>cold</StorageClass></Transition>
    <NoncurrentVersionTransition><NoncurrentDays>4</NoncurrentDays>
      <StorageClass>warm</StorageClass></NoncurrentVersionTransition>
  </Rule>
</LifecycleConfiguration>"""


@pytest.mark.parametrize("doc", [LC_XML, FULL_XML])
def test_rules_equal_reference(doc):
    import dataclasses
    got = [dataclasses.asdict(r) for r in Lifecycle.from_xml(doc).rules]
    want = [dataclasses.asdict(r)
            for r in ref_lc.Lifecycle.from_xml(doc).rules]
    assert got == want
    now = 1.7e9
    for lc in (Lifecycle.cached(doc), ref_lc.Lifecycle.cached(doc)):
        assert lc.mpu_abort_before("logs/x", now) == \
            ref_lc.Lifecycle.from_xml(doc).mpu_abort_before("logs/x", now)


# ---------------------------------------------------------------------------
# the crawler on the metacache feed
# ---------------------------------------------------------------------------

def _port_zones(root, n=6, parity=2):
    return ErasureServerSets([ErasureSets.from_drives(
        [str(root / f"d{i}") for i in range(n)], 1, n, parity,
        block_size=1 << 16, enable_mrf=False, device="cpu")],
        load_topology=False)


def _ref_zones(root, n=6, parity=2):
    return RefServerSets([RefSets.from_drives(
        [str(root / f"d{i}") for i in range(n)], 1, n, parity,
        block_size=1 << 16, enable_mrf=False)], load_topology=False)


def _walks(consumer):
    c = walks_counter()
    return {src: c.value(consumer=consumer, source=src)
            for src in ("merge", "index")}


def test_crawler_expires_through_the_feed(tmp_path):
    zz = _port_zones(tmp_path)
    try:
        zz.make_bucket("lc")
        for i in range(20):
            zz.put_object("lc", f"tmp/{i:02d}" if i % 2 else f"k{i:02d}",
                          b"x" * (i + 1))
        meta = BucketMetadataSys(zz)
        meta.update("lc", lifecycle_xml=LC_XML)
        mgr = MetacacheManager(zz, staleness_s=0.0)
        zz.attach_metacache(mgr)
        future = time.time() + 2 * 86400
        crawler = DataUsageCrawler(
            zz, persist=False,
            actions=[crawler_action(meta, zz, now_fn=lambda: future)])
        before = _walks("crawler")
        usage = crawler.scan_once()
        after = _walks("crawler")
        assert after["merge"] == before["merge"]
        assert after["index"] == before["index"] + 1
        # the pass counted what it saw, then expired the tmp/ half
        assert usage["buckets"]["lc"]["objects"] == 20
        assert [o.name for o in zz.list_objects("lc")[0]] == \
            [f"k{i:02d}" for i in range(0, 20, 2)]
        assert mgr.serves >= 1 and mgr.stats()["fallbacks"] == 0
        assert crawler.scan_once()["buckets"]["lc"]["objects"] == 10
    finally:
        zz.close()


@pytest.mark.parametrize("which", ["port", "ref"])
def test_expiry_restats_an_object_newer_than_the_feed(tmp_path, which):
    """The crawler's ObjectInfo says tmp/a was written two days ago (the
    feed's view); the object on the drives was written now (an overwrite
    the feed has not caught up with). At a clock half a day on, only the
    feed's view is expired. The port re-stats and keeps the overwrite;
    the reference deletes it."""
    if which == "port":
        zz, mod, meta_cls = _port_zones(tmp_path), port_lc, BucketMetadataSys
    else:
        zz, mod, meta_cls = _ref_zones(tmp_path), ref_lc, RefMeta
    try:
        zz.make_bucket("lc")
        zz.put_object("lc", "tmp/a", b"overwrite")
        meta = meta_cls(zz)
        meta.update("lc", lifecycle_xml=LC_XML)
        fresh = zz.get_object_info("lc", "tmp/a")
        seen = dataclasses.replace(fresh,
                                   mod_time=fresh.mod_time - 2 * 86400)
        now = fresh.mod_time + 86400 / 2
        mod.crawler_action(meta, zz, now_fn=lambda: now)("lc", seen)
        if which == "port":
            assert zz.get_object_info("lc", "tmp/a").etag == fresh.etag
            # a view the drives agree with still expires
            mod.crawler_action(meta, zz, now_fn=lambda: now + 86400)(
                "lc", fresh)
        with pytest.raises(Exception) as err:
            zz.get_object_info("lc", "tmp/a")
        assert type(err.value).__name__ == "ObjectNotFound"
    finally:
        zz.close()


# ---------------------------------------------------------------------------
# twin trees: the same versions deleted by either package's crawler
# ---------------------------------------------------------------------------

TWIN_XML = """<LifecycleConfiguration>
  <Rule><ID>exp</ID><Status>Enabled</Status>
    <Filter><Prefix>exp/</Prefix></Filter>
    <Expiration><Days>1</Days></Expiration></Rule>
  <Rule><ID>nc</ID><Status>Enabled</Status>
    <Filter><Prefix></Prefix></Filter>
    <NoncurrentVersionExpiration><NoncurrentDays>1</NoncurrentDays>
    </NoncurrentVersionExpiration>
    <AbortIncompleteMultipartUpload><DaysAfterInitiation>1
    </DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>
</LifecycleConfiguration>"""


def _seed_twin(root):
    zz = _ref_zones(root)
    zz.make_bucket("plain")
    zz.make_bucket("ver")
    for i in range(12):
        zz.put_object("plain", f"exp/{i:02d}" if i % 3 else f"keep/{i:02d}",
                      b"p" * (i + 1))
    for i in range(8):
        name = f"exp/v{i}" if i % 2 else f"doc{i}"
        for j in range(1 + i % 3):
            zz.put_object("ver", name, f"{i}.{j}".encode(),
                          opts=RefPutOptions(versioned=True))
    zz.put_object("ver", "gone", b"g", opts=RefPutOptions(versioned=True))
    zz.delete_object("ver", "gone", versioned=True)
    zz.new_multipart_upload("plain", "mpu-a")
    zz.new_multipart_upload("ver", "mpu-b")
    meta = RefMeta(zz)
    meta.update("plain", lifecycle_xml=TWIN_XML)
    meta.update("ver", lifecycle_xml=TWIN_XML, versioning="Enabled")
    zz.close()


def _state(zz):
    """Every bucket's versions (a marker's identity is minted by the
    package that laid it, so markers compare by name and position), and
    the multipart uploads left."""
    out = {}
    for b in ("plain", "ver"):
        vers = zz.list_object_versions(b, max_keys=10000)[0]
        out[b] = [(v.name, v.delete_marker,
                   "" if v.delete_marker else v.version_id, v.is_latest)
                  for v in vers]
        out[b + "/uploads"] = [u["object"]
                               for u in zz.list_multipart_uploads(b)]
    return out


def test_twin_crawlers_delete_the_same_versions(tmp_path):
    _seed_twin(tmp_path / "ref")
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    future = time.time() + 3 * 86400
    stacks = {}
    for who, open_, mc, lc, bg, meta_cls in (
            ("ref", _ref_zones, RefManager, ref_lc, ref_bg, RefMeta),
            ("port", _port_zones, MetacacheManager, port_lc, port_bg,
             BucketMetadataSys)):
        zz = open_(tmp_path / who)
        mgr = mc(zz, staleness_s=0.0)
        zz.attach_metacache(mgr)
        meta = meta_cls(zz)
        stacks[who] = (zz, mgr, bg.DataUsageCrawler(
            zz, persist=False,
            actions=[lc.crawler_action(meta, zz, now_fn=lambda: future)],
            bucket_actions=[
                lc.mpu_abort_action(meta, zz, now_fn=lambda: future),
                lc.noncurrent_sweep_action(meta, zz,
                                           now_fn=lambda: future)]))
    try:
        before = {who: _state(s[0]) for who, s in stacks.items()}
        assert before["port"] == before["ref"]
        usage = {who: s[2].scan_once() for who, s in stacks.items()}
        for u in usage.values():
            u.pop("last_update")
        assert usage["port"] == usage["ref"]
        for s in stacks.values():
            assert s[1].drain(10)
        after = {who: _state(s[0]) for who, s in stacks.items()}
        assert after["port"] == after["ref"]
        assert after["port"] != before["port"]
        assert after["port"]["plain"] == [
            (f"keep/{i:02d}", False, "", True) for i in range(0, 12, 3)]
        assert after["port"]["plain/uploads"] == []
        assert after["port"]["ver/uploads"] == []
        # the index the crawler fed from holds what the walk holds
        zp = stacks["port"][0]
        for b in ("plain", "ver"):
            got = [(o.name, o.version_id)
                   for o in zp.list_object_versions(b, max_keys=10000)[0]]
            mc_, zp.metacache = zp.metacache, None
            try:
                want = [(o.name, o.version_id) for o in
                        zp.list_object_versions(b, max_keys=10000)[0]]
            finally:
                zp.metacache = mc_
            assert got == want
    finally:
        for s in stacks.values():
            s[0].close()


def test_twin_crawlers_send_equal_lifecycle_events(tmp_path):
    """Each package's crawler, its expiry action handed that package's
    event notifier (as the boot hands it), sends the same
    s3:ObjectRemoved:Lifecycle records for the same expired objects,
    eventTime aside."""
    import minio_tpu.features.events as ref_events
    import minio_tpu_torch.features.events as port_events
    arn = "arn:minio:sqs::lc:webhook"
    doc = ("<NotificationConfiguration><QueueConfiguration>"
           f"<Queue>{arn}</Queue><Event>s3:ObjectRemoved:*</Event>"
           "</QueueConfiguration></NotificationConfiguration>")
    future = time.time() + 3 * 86400
    got = {}
    for who, open_, lc, bg, meta_cls, ev in (
            ("ref", _ref_zones, ref_lc, ref_bg, RefMeta, ref_events),
            ("port", _port_zones, port_lc, port_bg, BucketMetadataSys,
             port_events)):
        zz = open_(tmp_path / who, n=4)
        zz.make_bucket("lcev")
        for i in range(6):
            zz.put_object("lcev", f"tmp/{i}" if i % 2 else f"keep/{i}",
                          b"e" * (i + 1))
        meta = meta_cls(zz)
        meta.update("lcev", lifecycle_xml=LC_XML, notification_xml=doc)
        notifier = ev.EventNotifier(meta)
        sink = ev.MemoryTarget(arn)
        notifier.register_target(sink)
        try:
            bg.DataUsageCrawler(zz, persist=False, actions=[
                lc.crawler_action(meta, zz, notifier,
                                  now_fn=lambda: future)]).scan_once()
            assert sink.wait_for(3, 10), sink.records
            notifier.drain()
            recs = sorted(sink.records, key=lambda r: r["Records"][0][
                "s3"]["object"]["key"])
            for r in recs:
                r["Records"][0]["eventTime"] = "*"
            got[who] = recs
        finally:
            notifier.close()
            zz.close()
    assert [(r["Records"][0]["eventName"],
             r["Records"][0]["s3"]["object"]["key"]) for r in got["port"]] \
        == [("s3:ObjectRemoved:Lifecycle", f"tmp/{i}") for i in (1, 3, 5)]
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# the boot's crawler enforces expiry
# ---------------------------------------------------------------------------

def test_booted_node_expires_by_lifecycle_date(tmp_path):
    from minio_tpu_torch import cluster
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    creds = Credentials("lifecycletest1", "lifecyclesecret1")
    node = cluster.start_single([str(tmp_path / "d{1...4}")], creds=creds,
                                parity=2, block_size=1 << 16,
                                device="cpu")
    try:
        c = S3Client(node.s3.port, creds)
        assert c.send("PUT", "/lcb")[0] == 200
        for i in range(20):
            key = f"exp/{i:02d}" if i % 2 else f"live/{i:02d}"
            assert c.send("PUT", f"/lcb/{key}", body=b"z" * i)[0] == 200
        doc = ("<LifecycleConfiguration><Rule><ID>past</ID>"
               "<Status>Enabled</Status><Filter><Prefix>exp/</Prefix>"
               "</Filter><Expiration><Date>2020-01-01T00:00:00Z</Date>"
               "</Expiration></Rule></LifecycleConfiguration>").encode()
        assert c.send("PUT", "/lcb", query={"lifecycle": ""},
                      body=doc)[0] == 200
        assert node.metacache is not None
        assert node.metacache.drain(10)
        before = _walks("crawler")
        node.crawler.scan_once()
        assert _walks("crawler")["merge"] == before["merge"]
        # the expiries' deltas are inside the 2 s staleness bound: settle
        assert node.metacache.drain(10)
        for i in range(1, 20, 2):
            assert c.send("GET", f"/lcb/exp/{i:02d}")[0] == 404
        st, _, body = c.send("GET", "/lcb", query={"list-type": "2"})
        assert st == 200
        assert body.count(b"<Key>live/") == 10
        assert b"<Key>exp/" not in body
        assert node.metacache.serves >= 1
    finally:
        node.shutdown()


# ---------------------------------------------------------------------------
# tests/test_tier.py's tiers= expiry cases
# ---------------------------------------------------------------------------

class _OneLifecycle:
    """bucket_meta_sys stand-in: one lifecycle document for every bucket."""

    def __init__(self, lifecycle_xml: str, versioned: bool = False):
        self.lifecycle_xml = lifecycle_xml
        self._versioned = versioned

    def get(self, bucket):
        return self

    def versioning_enabled(self) -> bool:
        return self._versioned


EXPIRE_1D = ("<LifecycleConfiguration><Rule><Status>Enabled</Status>"
             "<Prefix></Prefix><Expiration><Days>1</Days></Expiration>"
             "</Rule></LifecycleConfiguration>")
NONCURRENT_1D = ("<LifecycleConfiguration><Rule><Status>Enabled</Status>"
                 "<Prefix></Prefix><NoncurrentVersionExpiration>"
                 "<NoncurrentDays>1</NoncurrentDays>"
                 "</NoncurrentVersionExpiration></Rule>"
                 "</LifecycleConfiguration>")


@pytest.fixture()
def tiered(tmp_path):
    from minio_tpu_torch.tier.config import TierConfig, TierManager
    from minio_tpu_torch.tier.transition import TransitionWorker
    zz = _port_zones(tmp_path, n=4)
    zz.make_bucket("b")
    tiers = TierManager(zz)
    tiers.add(TierConfig("cold", "fs", {"path": str(tmp_path / "tier")}))
    worker = TransitionWorker(zz, tiers, busy_fn=lambda: False).start()
    yield zz, tiers, worker
    worker.close()
    zz.close()


def _transitioned(zz, worker, name, info):
    from minio_tpu_torch.object import GetOptions
    from minio_tpu_torch.storage import datatypes as dt
    worker.enqueue("b", name, info.version_id, "cold", etag=info.etag)
    assert worker.drain(30), worker.stats()
    md = zz.get_object_info(
        "b", name, GetOptions(version_id=info.version_id)).user_defined
    return md[dt.TRANSITIONED_OBJECT_KEY]


def test_expired_transitioned_object_frees_remote(tiered):
    from minio_tpu_torch.tier.client import TierObjectNotFound
    zz, tiers, worker = tiered
    info = zz.put_object("b", "exp", b"e" * 10_000)
    remote_key = _transitioned(zz, worker, "exp", info)
    assert tiers.client("cold").head(remote_key) == 10_000
    act = crawler_action(_OneLifecycle(EXPIRE_1D), zz,
                         now_fn=lambda: time.time() + 2 * 86400,
                         tiers=tiers)
    act("b", zz.get_object_info("b", "exp"))
    with pytest.raises(api_errors.ObjectNotFound):
        zz.get_object_info("b", "exp")
    with pytest.raises(TierObjectNotFound):
        tiers.client("cold").head(remote_key)


def test_versioned_expiry_keeps_the_remote_copy(tiered):
    """A versioned expiry lays a marker: the stub stays a noncurrent
    version, and so does its remote copy."""
    zz, tiers, worker = tiered
    info = zz.put_object("b", "v", b"v" * 9_000,
                         opts=PutOptions(versioned=True))
    remote_key = _transitioned(zz, worker, "v", info)
    act = crawler_action(_OneLifecycle(EXPIRE_1D, versioned=True), zz,
                         now_fn=lambda: time.time() + 2 * 86400,
                         tiers=tiers)
    act("b", zz.get_object_info("b", "v"))
    vers = zz.list_object_versions("b", prefix="v")[0]
    assert [v.delete_marker for v in vers] == [True, False]
    assert tiers.client("cold").head(remote_key) == 9_000


@pytest.mark.parametrize("feed", [False, True])
def test_noncurrent_expiry_frees_remote(tiered, feed):
    from minio_tpu_torch.features.lifecycle import noncurrent_sweep_action
    from minio_tpu_torch.object import GetOptions
    from minio_tpu_torch.tier.client import TierObjectNotFound
    zz, tiers, worker = tiered
    old = zz.put_object("b", "ncx", b"old" * 800,
                        opts=PutOptions(versioned=True))
    time.sleep(0.01)
    zz.put_object("b", "ncx", b"new" * 800,
                  opts=PutOptions(versioned=True))
    remote_key = _transitioned(zz, worker, "ncx", old)
    if feed:
        # the sweep reads the version lists from the index's feed
        mgr = MetacacheManager(zz, staleness_s=0.0)
        zz.attach_metacache(mgr)
        before = _walks("lifecycle")
    act = noncurrent_sweep_action(_OneLifecycle(NONCURRENT_1D), zz,
                                  now_fn=lambda: time.time() + 2 * 86400,
                                  tiers=tiers)
    act("b")
    if feed:
        assert _walks("lifecycle")["merge"] == before["merge"]
        mgr.close()
    with pytest.raises(api_errors.VersionNotFound):
        zz.get_object_info("b", "ncx", GetOptions(version_id=old.version_id))
    with pytest.raises(TierObjectNotFound):
        tiers.client("cold").head(remote_key)
