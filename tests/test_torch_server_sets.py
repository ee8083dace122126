"""Server sets (pools) on the port (minio_tpu_torch/object/server_sets.py)
against minio_tpu's: pool choice by free space, newest-wins reads across
pools, multipart routing to the session's pool (and its migration, with
the reference's, off a pool that stops taking writes), the persisted topology
map, a multipart upload into two pools that leaves drive trees equal to
the reference's (uuids, mod times and pool choice pinned), and a
two-pool layout written by minio_tpu read back by the port. Tolerance: 0
(exact bytes)."""

import hashlib
import itertools
import os
import random
import uuid

import numpy as np
import pytest

import minio_tpu.object.api_errors as ref_api_errors
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.storage.format as ref_format
from minio_tpu.bitrot import BitrotAlgorithm as RefAlgo
from minio_tpu.object.multipart import CompletePart as RefPart
from minio_tpu.object.server_sets import ErasureServerSets as RefServerSets
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu_torch.bitrot import BitrotAlgorithm
from minio_tpu_torch.object import api_errors, engine, multipart
from minio_tpu_torch.object.engine import PutOptions
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.object.server_sets import (ErasureServerSets,
                                                open_server_sets)
from minio_tpu_torch.object.topology import (POOL_ACTIVE, POOL_SUSPENDED,
                                             TopologyError)
from minio_tpu_torch.storage import format as port_format

N, M, BS = 6, 2, 1 << 14


def _pools(tmp_path, tag):
    return [[str(tmp_path / f"{tag}p{p}d{j}") for j in range(N)]
            for p in range(2)]


def _port(pools, **kw):
    kw.setdefault("bitrot_algo", BitrotAlgorithm.SHA256)
    return open_server_sets(pools, N, M, block_size=BS, enable_mrf=False,
                            device="cpu", **kw)


def _ref(pools, algo="sha256"):
    return RefServerSets([RefSets.from_drives(p, 1, N, M, block_size=BS,
                                              enable_mrf=False,
                                              bitrot_algo=RefAlgo(algo))
                          for p in pools])


def _read(layer, name):
    info, it = layer.get_object("b", name)
    return info, b"".join(it)


def _stub_space(layer, infos):
    for z, info in zip(layer.server_sets, infos):
        z.storage_info = lambda info=info: dict(info)


SPACES = [{"total": 1000, "free": 40}, {"total": 1000, "free": 700}]


def test_pool_choice_equals_reference(tmp_path):
    port, ref = _port(_pools(tmp_path, "p")), _ref(_pools(tmp_path, "r"))
    for layer in (port, ref):
        _stub_space(layer, SPACES)
    for size in (0, 10, 100, 650, 800):
        assert port._available_space(size) == ref._available_space(size)
        random.seed(size)
        got = [port.get_available_zone_idx(size) for _ in range(20)]
        random.seed(size)
        assert got == [ref.get_available_zone_idx(size) for _ in range(20)]
    # pool 0 is past its fill watermark: every new object lands in pool 1
    assert port._available_space(10)[0] == 0
    port.make_bucket("b")
    for i in range(5):
        port.put_object("b", f"o{i}", b"x" * 100, 100)
        assert [z.has_object_versions("b", f"o{i}")
                for z in port.server_sets] == [False, True]
    port.close()
    ref.close()


def test_newest_version_wins_across_pools(tmp_path):
    layer = _port(_pools(tmp_path, "p"))
    layer.make_bucket("b")
    p0, p1 = layer.server_sets
    p0.put_object("b", "x", b"old")
    p1.put_object("b", "x", b"newer")
    assert _read(layer, "x")[1] == b"newer"
    assert layer.latest_file_info("b", "x").size == 5
    # a newer delete marker in pool 0 hides both copies
    p0.put_delete_marker("b", "x")
    with pytest.raises(api_errors.ObjectNotFound):
        layer.get_object_info("b", "x")
    # a PUT keeps the pool that holds the object's history
    layer.put_object("b", "y", b"one")
    holder = [z.has_object_versions("b", "y")
              for z in layer.server_sets].index(True)
    layer.put_object("b", "y", b"two")
    assert [z.has_object_versions("b", "y")
            for z in layer.server_sets].count(True) == 1
    assert layer.server_sets[holder].has_object_versions("b", "y")
    assert _read(layer, "y")[1] == b"two"
    layer.delete_object("b", "y")
    with pytest.raises(api_errors.ObjectNotFound):
        layer.get_object_info("b", "y")
    layer.close()


def test_multipart_routes_to_the_sessions_pool(tmp_path):
    layer = _port(_pools(tmp_path, "p"))
    ref = _ref(_pools(tmp_path, "r"))
    out = []
    no_upload = (api_errors.InvalidUploadID, ref_api_errors.InvalidUploadID)
    for z, Part in ((layer, CompletePart), (ref, RefPart)):
        z.make_bucket("b")
        z.get_available_zone_idx = lambda size: 1
        uid = z.new_multipart_upload("b", "mp")
        assert z._zone_index_of_upload("b", "mp", uid) == 1
        e1 = z.put_object_part("b", "mp", uid, 1, b"a" * (5 << 20)).etag
        assert [p.part_number for p in
                z.list_object_parts("b", "mp", uid)] == [1]
        with pytest.raises(no_upload):
            z.server_sets[0].list_object_parts("b", "mp", uid)
        # a session on a pool that takes no writes migrates, with its
        # uploadID, to an active pool at its next part (as the
        # reference's migrate_upload does)
        del z.get_available_zone_idx
        z.set_pool_state(1, POOL_SUSPENDED)
        e2 = z.put_object_part("b", "mp", uid, 2, b"b" * 10).etag
        assert z._zone_index_of_upload("b", "mp", uid) == 0
        with pytest.raises(no_upload):
            z.server_sets[1].list_object_parts("b", "mp", uid)
        z.set_pool_state(1, POOL_ACTIVE)
        assert [u["upload_id"] for u in z.list_multipart_uploads("b")] \
            == [uid]
        info = z.complete_multipart_upload(
            "b", "mp", uid, [Part(1, e1), Part(2, e2)])
        assert info.etag.endswith("-2")
        assert z.server_sets[0].has_object_versions("b", "mp")
        assert not z.server_sets[1].has_object_versions("b", "mp")
        assert _read(z, "mp")[1] == b"a" * (5 << 20) + b"b" * 10
        out.append((e1, e2, info.etag, info.size))
        z.close()
    assert out[0] == out[1]


def test_topology_saved_and_loaded_by_both_packages(tmp_path):
    pools = _pools(tmp_path, "p")
    layer = _port(pools)
    epoch = layer.set_pool_state(0, POOL_SUSPENDED)
    assert epoch == 1 and layer.topology.write_pools() == [1]
    with pytest.raises(TopologyError):
        layer.set_pool_state(1, POOL_SUSPENDED)     # the last active pool
    info = layer.storage_info()
    assert [z["pool_state"] for z in info["zones"]] == \
        [POOL_SUSPENDED, POOL_ACTIVE]
    assert info["topology_epoch"] == 1
    layer.close()
    again = _port(pools)
    ref = _ref(pools)
    for tm in (again.topology, ref.topology):
        assert tm.states == [POOL_SUSPENDED, POOL_ACTIVE]
        assert tm.epoch == 1
    assert again.topology.to_dict() == ref.topology.to_dict()
    again.close()
    ref.close()


class _Pinned:
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


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_two_pool_multipart_trees_equal_reference(tmp_path, monkeypatch):
    ref_pin, port_pin = _Pinned(), _Pinned()
    for mod in (ref_engine, ref_multipart, ref_format):
        monkeypatch.setattr(mod, "_uuid", ref_pin)
    for mod in (engine, multipart, port_format):
        monkeypatch.setattr(mod, "_uuid", port_pin)
    for mod in (ref_engine, ref_multipart):
        monkeypatch.setattr(mod, "now", ref_pin.now)
    for mod in (engine, multipart):
        monkeypatch.setattr(mod, "now", port_pin.now)
    for mod in (ref_multipart, multipart):
        monkeypatch.setattr(mod, "MIN_PART_SIZE", BS)
    ref_pools, port_pools = _pools(tmp_path, "r"), _pools(tmp_path, "p")
    ref, port = _ref(ref_pools), _port(port_pools)
    rng = np.random.default_rng(21)
    objs = {f"obj{i}": [rng.bytes(2 * BS + 3 * i), rng.bytes(BS + 11)]
            for i in range(3)}
    for layer, cls in ((ref, RefPart), (port, CompletePart)):
        # the pools take the sessions in turn (the weighted-random pool
        # choice pinned)
        turn = itertools.cycle([0, 1])
        layer.get_available_zone_idx = lambda size, t=turn: next(t)
        layer.make_bucket("b")
        for name, parts in objs.items():
            uid = layer.new_multipart_upload("b", name)
            etags = [layer.put_object_part("b", name, uid, i + 1, p).etag
                     for i, p in enumerate(parts)]
            layer.complete_multipart_upload(
                "b", name, uid, [cls(i + 1, e) for i, e in enumerate(etags)])
        layer.put_object("b", "single", b"s" * 5000)
    from minio_tpu_torch.storage.xl_meta import XLMetaV2
    for rp, pp in zip(sum(ref_pools, []), sum(port_pools, [])):
        a, b = _tree(rp), _tree(pp)
        assert a.keys() == b.keys()
        for rel in a:
            if rel.endswith("xl.meta"):
                # the port records each drive's whole-file digests; the
                # reference leaves multipart parts' empty
                fa = XLMetaV2.loads(a[rel]).list_file_infos("v", "p")
                fb = XLMetaV2.loads(b[rel]).list_file_infos("v", "p")
                for fi in fa + fb:
                    for c in fi.erasure.checksums:
                        c.hash = b""
                assert fa == fb, rel
            else:
                assert a[rel] == b[rel], rel
    for name, parts in objs.items():
        for layer in (ref, port):
            info, data = _read(layer, name)
            assert data == b"".join(parts)
            assert info.etag == hashlib.md5(b"".join(
                hashlib.md5(p).digest() for p in parts)).hexdigest() + "-2"
    ref.close()
    port.close()


def test_port_reads_a_reference_two_pool_layout(tmp_path):
    pools = _pools(tmp_path, "r")
    ref = _ref(pools)
    ref.make_bucket("b")
    rng = np.random.default_rng(31)
    want = {}
    for i in range(6):
        name = f"k/{i}"
        if i % 2:
            parts = [rng.bytes(5 << 20), rng.bytes(1000 + i)]
            uid = ref.new_multipart_upload("b", name)
            etags = [ref.put_object_part("b", name, uid, j + 1, p).etag
                     for j, p in enumerate(parts)]
            info = ref.complete_multipart_upload(
                "b", name, uid, [RefPart(j + 1, e)
                                 for j, e in enumerate(etags)])
            want[name] = (b"".join(parts), info.etag)
        else:
            data = rng.bytes(3 * BS + i)
            want[name] = (data, ref.put_object("b", name, data).etag)
    ref_list = [o.name for o in ref.list_objects("b", prefix="k/")[0]]
    ref.close()
    port = open_server_sets(pools, N, M, block_size=BS, enable_mrf=False,
                            device="cpu")
    for name, (data, etag) in want.items():
        info, got = _read(port, name)
        assert got == data and info.etag == etag
    assert [o.name for o in port.list_objects("b", prefix="k/")[0]] == \
        ref_list == sorted(want)
    # a port PUT into the reference layout with its parity option
    port.put_object("b", "p2", b"q" * 999, opts=PutOptions(parity=3))
    assert port.get_object_info("b", "p2").parity_blocks == 3
    port.close()
