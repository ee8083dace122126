"""Multipart uploads on the port (minio_tpu_torch/object/multipart.py)
held byte for byte against minio_tpu's: the same calls on the same bytes,
with uuids and mod times pinned in both packages, leave the same drive
trees — format.json, session journals, part files, committed xl.meta —
and each package reads what the other wrote. Crash points follow
tests/test_crash.py's points, fired in-process.

Six temp drives at 4+2 and 16 KiB blocks; the 5 MiB minimum part size is
lowered to one block in both packages so parts stay small."""

import hashlib
import os
import time
import uuid

import numpy as np
import pytest

import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.storage.format as ref_format
from minio_tpu.bitrot import BitrotAlgorithm as RefAlgo
from minio_tpu.object.multipart import CompletePart as RefPart
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu_torch.bitrot import BitrotAlgorithm
from minio_tpu_torch.object import (api_errors, bitrot_io, codec, engine,
                                    multipart)
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.scheduler import BatchScheduler
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.xl_storage import XLStorage
from minio_tpu_torch.utils import crashpoint, healthtrack
from tests.test_torch_s3 import pin_deadlines

K, M, BS = 4, 2, 1 << 14
PARTS = [3 * BS + 5, 2 * BS, 777]


class _Pinned:
    """uuid4 and now() as counters: one per package, patched into the
    modules that mint ids and stamp times, so both packages see the same
    sequence."""

    UUID = uuid.UUID

    def __init__(self):
        self.n = 0
        self.t = 1.7e9

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n)

    def now(self):
        self.t += 1.0
        return self.t


@pytest.fixture
def pinned(monkeypatch):
    ref, port = _Pinned(), _Pinned()
    # both packages' gray-failure deadlines at their cold-start ceilings:
    # a part upload waits for every drive's close, whatever latencies
    # earlier tests in this worker fed the process-wide trackers
    pin_deadlines(monkeypatch)
    for mod in (ref_engine, ref_multipart, ref_format):
        monkeypatch.setattr(mod, "_uuid", ref)
    for mod in (engine, multipart, port_format):
        monkeypatch.setattr(mod, "_uuid", port)
    for mod in (ref_engine, ref_multipart):
        monkeypatch.setattr(mod, "now", ref.now)
    for mod in (engine, multipart):
        monkeypatch.setattr(mod, "now", port.now)
    monkeypatch.setattr(ref_multipart, "MIN_PART_SIZE", BS)
    monkeypatch.setattr(multipart, "MIN_PART_SIZE", BS)


def _paths(tmp_path, tag):
    return [str(tmp_path / f"{tag}{i}") for i in range(K + M)]


def _open(paths, algo, ref=False, **kw):
    if ref:
        return RefSets.from_drives(paths, 1, K + M, M, block_size=BS,
                                   enable_mrf=False,
                                   bitrot_algo=RefAlgo(algo), **kw)
    return ErasureSets.from_drives(paths, 1, K + M, M, block_size=BS,
                                   enable_mrf=False, device="cpu",
                                   bitrot_algo=BitrotAlgorithm(algo), **kw)


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _meta_sans_digests(raw):
    """A journal's FileInfo with the whole-file digests blanked (the port
    records each drive's own; minio_tpu records none)."""
    from minio_tpu_torch.storage.xl_meta import XLMetaV2
    fis = XLMetaV2.loads(raw).list_file_infos("v", "p")
    for fi in fis:
        for c in fi.erasure.checksums:
            c.hash = b""
    return fis


def _assert_trees_equal(ref_paths, port_paths, whole_file):
    for rp, pp in zip(ref_paths, port_paths):
        a, b = _tree(rp), _tree(pp)
        assert a.keys() == b.keys()
        for rel in a:
            if whole_file and rel.endswith("xl.meta"):
                assert _meta_sans_digests(a[rel]) == \
                    _meta_sans_digests(b[rel]), rel
            else:
                assert a[rel] == b[rel], rel


def _upload(layer, part_cls, data, parts_order=(1, 0, 2)):
    uid = layer.new_multipart_upload("b", "dir/obj")
    etags = {}
    for i in parts_order:
        info = layer.put_object_part("b", "dir/obj", uid, i + 1, data[i])
        etags[i + 1] = info.etag
    listed = [(p.part_number, p.etag, p.size)
              for p in layer.list_object_parts("b", "dir/obj", uid)]
    uploads = [(u["object"], u["upload_id"])
               for u in layer.list_multipart_uploads("b")]
    return uid, etags, listed, uploads


@pytest.mark.parametrize("algo", ["highwayhash256S", "sha256"])
def test_trees_equal_to_reference(tmp_path, pinned, algo):
    rng = np.random.default_rng(11)
    data = [rng.bytes(n) for n in PARTS]
    ref_paths, port_paths = _paths(tmp_path, "r"), _paths(tmp_path, "p")
    whole = algo == "sha256"
    ref = _open(ref_paths, algo, ref=True)
    port = _open(port_paths, algo)
    pairs = ((ref, RefPart), (port, CompletePart))
    for layer, _cls in pairs:
        layer.make_bucket("b")
    # the session, its parts uploaded out of order, not yet completed
    ups = [_upload(layer, cls, data) for layer, cls in pairs]
    assert ups[0] == ups[1]
    _assert_trees_equal(ref_paths, port_paths, whole)
    uid, etags = ups[0][0], ups[0][1]
    md5s = b"".join(hashlib.md5(d).digest() for d in data)
    for layer, cls in pairs:
        info = layer.complete_multipart_upload(
            "b", "dir/obj", uid, [cls(n, etags[n]) for n in sorted(etags)])
        assert info.etag == hashlib.md5(md5s).hexdigest() + "-3"
        assert info.size == sum(PARTS)
        # a second session, aborted
        uid2 = layer.new_multipart_upload("b", "other")
        layer.put_object_part("b", "other", uid2, 1, data[2])
        layer.abort_multipart_upload("b", "other", uid2)
        assert layer.list_multipart_uploads("b") == []
        layer.close()
    _assert_trees_equal(ref_paths, port_paths, whole)
    # each package reads what the other wrote
    for paths, is_ref in ((port_paths, True), (ref_paths, False)):
        layer = _open(paths, algo, ref=is_ref)
        info, it = layer.get_object("b", "dir/obj")
        assert b"".join(it) == b"".join(data)
        assert info.etag.endswith("-3")
        layer.close()


def test_trees_equal_with_warm_tracker_and_a_slow_close(
        tmp_path, pinned, monkeypatch):
    """The twin trees do not depend on what ran before in the worker or
    on load: with the port's tracker warmed by fast writes, as earlier
    tests warm it (a grace of 0.5 s if it were derived from it), and one
    port drive's first part close taking 1 s, as under the suite's load,
    the port still waits for that drive, as the reference does."""
    monkeypatch.setattr(healthtrack, "TRACKER", healthtrack.HealthTracker())
    for i in range(64):
        healthtrack.TRACKER.observe("drive", f"warm{i % 4}", "write", 0.001)
    slow_root = str(tmp_path / "p0")
    orig = bitrot_io.StreamingBitrotWriter.close
    slowed = []

    def close(self):
        if not slowed and healthtrack.disk_key(self.disk) == slow_root:
            slowed.append(self.path)
            time.sleep(1.0)
        return orig(self)
    monkeypatch.setattr(bitrot_io.StreamingBitrotWriter, "close", close)
    rng = np.random.default_rng(12)
    data = [rng.bytes(n) for n in PARTS]
    ref_paths, port_paths = _paths(tmp_path, "r"), _paths(tmp_path, "p")
    ref = _open(ref_paths, "highwayhash256S", ref=True)
    port = _open(port_paths, "highwayhash256S")
    ups = []
    for layer, cls in ((ref, RefPart), (port, CompletePart)):
        layer.make_bucket("b")
        ups.append(_upload(layer, cls, data))
        layer.close()
    assert ups[0] == ups[1]
    assert slowed
    _assert_trees_equal(ref_paths, port_paths, False)


def test_whole_file_digests_are_each_drives_own(tmp_path, pinned):
    paths = _paths(tmp_path, "p")
    layer = _open(paths, "sha256")
    layer.make_bucket("b")
    data = [np.random.default_rng(i).bytes(n) for i, n in enumerate(PARTS)]
    uid, etags, _l, _u = _upload(layer, CompletePart, data)
    layer.complete_multipart_upload(
        "b", "dir/obj", uid,
        [CompletePart(n, etags[n]) for n in sorted(etags)])
    for root in paths:
        fi = XLStorage(root).read_version("b", "dir/obj")
        assert [c.part_number for c in fi.erasure.checksums] == [1, 2, 3]
        for c in fi.erasure.checksums:
            with open(os.path.join(root, "b", "dir/obj", fi.data_dir,
                                   f"part.{c.part_number}"), "rb") as f:
                assert c.hash == hashlib.sha256(f.read()).digest()
        XLStorage(root).verify_file("b", "dir/obj", fi)


@pytest.mark.parametrize("case", ["bad_etag", "too_small", "unknown_id",
                                  "part_number"])
def test_errors_match_reference(tmp_path, pinned, case):
    names = []
    for is_ref, part_cls, tag in ((True, RefPart, "r"),
                                  (False, CompletePart, "p")):
        layer = _open(_paths(tmp_path, tag), "highwayhash256S",
                      ref=is_ref)
        layer.make_bucket("b")
        uid = layer.new_multipart_upload("b", "o")
        e1 = layer.put_object_part("b", "o", uid, 1, b"x" * 100).etag
        e2 = layer.put_object_part("b", "o", uid, 2, b"y" * BS).etag
        try:
            if case == "bad_etag":
                layer.complete_multipart_upload(
                    "b", "o", uid, [part_cls(1, e1), part_cls(2, e1)])
            elif case == "too_small":
                layer.complete_multipart_upload(
                    "b", "o", uid, [part_cls(1, e1), part_cls(2, e2)])
            elif case == "unknown_id":
                layer.list_object_parts("b", "o", "no-such-upload")
            else:
                layer.put_object_part("b", "o", uid, 10001, b"z")
        except Exception as e:  # noqa: BLE001 — compared below
            names.append(type(e).__name__)
        layer.close()
    assert len(names) == 2 and names[0] == names[1]
    assert names[1] in {"InvalidPart", "PartTooSmall", "InvalidUploadID"}


def test_parts_go_through_the_former_under_sha256(tmp_path, pinned,
                                                  monkeypatch):
    # the fused route (on CPU tensors: the kernels' plain versions) under
    # sha256: the parts' blocks go through the former, and the whole-file
    # digests in xl.meta still come from the host rehash
    monkeypatch.setattr(codec, "DEVICE_MIN_BYTES", 1024)
    monkeypatch.setattr(engine, "ENCODE_BATCH_BLOCKS", 2)
    sched = BatchScheduler(max_wait=0.05)
    paths = _paths(tmp_path, "p")
    layer = _open(paths, "sha256", scheduler=sched)
    try:
        layer.make_bucket("b")
        data = [np.random.default_rng(i).bytes(n)
                for i, n in enumerate((2 * BS, 2 * BS + 9))]
        uid = layer.new_multipart_upload("b", "o")
        etags = [layer.put_object_part("b", "o", uid, i + 1, d).etag
                 for i, d in enumerate(data)]
        layer.complete_multipart_upload(
            "b", "o", uid, [CompletePart(i + 1, e)
                            for i, e in enumerate(etags)])
        st = sched.stats()["verbs"]["encode"]
        # one fused dispatch per part's full blocks; the 9-byte last
        # block is under the size gate and takes the host route
        assert st["batches"] == 3 and st["host_routed"] == 1
        assert sched.stats()["declined"] == 0
        _info, it = layer.get_object("b", "o")
        assert b"".join(it) == b"".join(data)
    finally:
        layer.close()
        sched.close()


# -- crash points (tests/test_crash.py's multipart points, in-process) -----

def _session(tmp_path):
    layer = _open(_paths(tmp_path, "p"), "highwayhash256S")
    layer.make_bucket("b")
    uid = layer.new_multipart_upload("b", "o")
    return layer, uid


def test_crash_before_part_rename_leaves_no_part(tmp_path, pinned):
    layer, uid = _session(tmp_path)
    crashpoint.arm("multipart.part.before_rename")
    try:
        with pytest.raises(crashpoint.CrashpointAbort):
            layer.put_object_part("b", "o", uid, 1, b"a" * BS)
    finally:
        crashpoint.disarm()
    # the journal never saw the part, and the staged shards are gone
    assert layer.list_object_parts("b", "o", uid) == []
    for p in _paths(tmp_path, "p"):
        assert os.listdir(os.path.join(p, ".minio.sys", "tmp")) == []
    e = layer.put_object_part("b", "o", uid, 1, b"a" * BS).etag
    info = layer.complete_multipart_upload("b", "o", uid,
                                           [CompletePart(1, e)])
    assert info.size == BS
    layer.close()


def test_crash_before_complete_rename_keeps_the_session(tmp_path, pinned):
    layer, uid = _session(tmp_path)
    e = layer.put_object_part("b", "o", uid, 1, b"a" * BS).etag
    crashpoint.arm("multipart.complete.before_rename")
    try:
        with pytest.raises(crashpoint.CrashpointAbort):
            layer.complete_multipart_upload("b", "o", uid,
                                            [CompletePart(1, e)])
    finally:
        crashpoint.disarm()
    with pytest.raises(api_errors.ObjectNotFound):
        layer.get_object_info("b", "o")
    assert [p.part_number
            for p in layer.list_object_parts("b", "o", uid)] == [1]
    layer.complete_multipart_upload("b", "o", uid, [CompletePart(1, e)])
    _info, it = layer.get_object("b", "o")
    assert b"".join(it) == b"a" * BS
    layer.close()


def test_torn_complete_rename_is_a_degraded_write(tmp_path, pinned):
    layer, uid = _session(tmp_path)
    e = layer.put_object_part("b", "o", uid, 1, b"a" * BS).etag
    degraded = []
    for s in layer.sets:
        s.on_degraded_write = lambda b, o, v: degraded.append((b, o))
    crashpoint.arm("multipart.complete.rename.partial", nth=2)
    try:
        layer.complete_multipart_upload("b", "o", uid,
                                        [CompletePart(1, e)])
    finally:
        crashpoint.disarm()
    # one drive missed the rename: quorum met, the object reads back,
    # and the miss feeds the MRF queue
    assert degraded == [("b", "o")]
    _info, it = layer.get_object("b", "o")
    assert b"".join(it) == b"a" * BS
    layer.close()
