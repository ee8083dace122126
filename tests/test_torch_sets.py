"""Erasure sets on the port (minio_tpu_torch/object/sets.py) against
minio_tpu's: the object-to-set hashes, format.json bytes (uuids pinned),
the format heal of a fresh drive, the drive-identity guard, routing that
both packages agree on, and the cross-set batching of config 5: two sets
sharing one batch former put at once, and their groups share a dispatch.
Tolerance: 0 (exact bytes)."""

import os
import shutil
import threading
import uuid

import numpy as np
import pytest

import minio_tpu.storage.format as ref_format
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.utils import siphash as ref_siphash
from minio_tpu_torch.object import codec, engine
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.parallel.scheduler import BatchScheduler
from minio_tpu_torch.storage import errors
from minio_tpu_torch.storage import format as port_format
from minio_tpu_torch.storage.diskid_check import DiskIDCheck
from minio_tpu_torch.storage.xl_storage import XLStorage
from minio_tpu_torch.utils import siphash

N, M, BS = 6, 2, 1 << 14
NAMES = ["", "a", "obj-0", "dir/sub/x.bin", "ünïcödé/ключ", "x" * 300]


@pytest.mark.parametrize("sets", [1, 2, 3, 16])
def test_set_hashes_equal_reference(sets):
    key = uuid.UUID(int=0x1234_5678_9abc_def0_0fed_cba9_8765_4321).bytes
    rng = np.random.default_rng(sets)
    names = NAMES + [rng.bytes(12).hex() for _ in range(200)]
    for name in names:
        assert siphash.sip_hash_mod(name, sets, key) == \
            ref_siphash.sip_hash_mod(name, sets, key)
        assert siphash.crc_hash_mod(name, sets) == \
            ref_siphash.crc_hash_mod(name, sets)


class _Seq:
    UUID = uuid.UUID

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n)


def _paths(tmp_path, tag, n=2 * N):
    return [str(tmp_path / f"{tag}{i}") for i in range(n)]


def _fmt(path):
    with open(os.path.join(path, ".minio.sys", "format.json"), "rb") as f:
        return f.read()


def test_format_json_and_fresh_drive_heal_equal_reference(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(ref_format, "_uuid", _Seq())
    monkeypatch.setattr(port_format, "_uuid", _Seq())
    ref_paths, port_paths = _paths(tmp_path, "r"), _paths(tmp_path, "p")
    RefSets.from_drives(ref_paths, 2, N, M, enable_mrf=False).close()
    ErasureSets.from_drives(port_paths, 2, N, M, enable_mrf=False,
                            device="cpu").close()
    for rp, pp in zip(ref_paths, port_paths):
        assert _fmt(rp) == _fmt(pp)
    # a replaced (empty) drive gets the format of its slot on reopen
    for paths in (ref_paths, port_paths):
        shutil.rmtree(paths[7])
    RefSets.from_drives(ref_paths, 2, N, M, enable_mrf=False).close()
    port = ErasureSets.from_drives(port_paths, 2, N, M, enable_mrf=False,
                                   device="cpu")
    assert _fmt(ref_paths[7]) == _fmt(port_paths[7])
    assert XLStorage(port_paths[7]).read_format().this == \
        port.format_ref.sets[1][1]
    port.close()


def test_diskid_guard_reads_a_swapped_drive_as_stale(tmp_path):
    paths = _paths(tmp_path, "d", N)
    layer = ErasureSets.from_drives(paths, 1, N, M, enable_mrf=False,
                                    device="cpu")
    guard = layer.sets[0].disks[0]
    assert isinstance(guard, DiskIDCheck)
    guard.interval = 0.0
    guard.make_vol("b")
    assert guard.stat_vol("b").name == "b"
    # another drive's format behind the guard: every verb is refused
    shutil.copy(os.path.join(paths[1], ".minio.sys", "format.json"),
                os.path.join(paths[0], ".minio.sys", "format.json"))
    with pytest.raises(errors.DiskStale):
        guard.stat_vol("b")
    with pytest.raises(errors.DiskStale):
        DiskIDCheck(XLStorage(paths[2]), "not-its-id").list_vols()
    layer.close()


def test_routing_agrees_with_reference(tmp_path):
    paths = _paths(tmp_path, "d")
    port = ErasureSets.from_drives(paths, 2, N, M, block_size=BS,
                                   enable_mrf=False, device="cpu")
    port.make_bucket("b")
    rng = np.random.default_rng(5)
    objs = {f"k{i}": rng.bytes(100 + 37 * i) for i in range(12)}
    for name, data in objs.items():
        port.put_object("b", name, data)
    assert {port.get_hashed_set_index(n) for n in objs} == {0, 1}
    port.close()
    ref = RefSets.from_drives(paths, 2, N, M, block_size=BS,
                              enable_mrf=False)
    for name, data in objs.items():
        assert ref.get_hashed_set_index(name) == \
            ErasureSets.get_hashed_set_index(ref, name)
        _info, it = ref.get_object("b", name)
        assert b"".join(it) == data
    objs_listed, _pfx, _tr = ref.list_objects("b")
    assert [o.name for o in objs_listed] == sorted(objs)
    ref.close()


def test_two_sets_sharing_a_former_share_a_dispatch(tmp_path, monkeypatch):
    # groups of two sets' concurrent PUTs land in one bucket of the former
    # (keyed by geometry, not by codec) and go out in one dispatch
    monkeypatch.setattr(codec, "DEVICE_MIN_BYTES", 1024)
    monkeypatch.setattr(engine, "ENCODE_BATCH_BLOCKS", 2)
    sched = BatchScheduler(max_wait=0.5)
    layer = ErasureSets.from_drives(_paths(tmp_path, "d"), 2, N, M,
                                    block_size=BS, enable_mrf=False,
                                    device="cpu", scheduler=sched)
    codec_set = {id(s.codec(N - M, M)): i for i, s in enumerate(layer.sets)}
    dispatches = []
    real = sched._run_erasure

    def watched(key, group, stage_cb):
        dispatches.append(sorted(codec_set[id(p.codec)] for p in group))
        return real(key, group, stage_cb)

    sched._run_erasure = watched
    names = {}
    for i in range(40):
        names.setdefault(layer.get_hashed_set_index(f"o{i}"), f"o{i}")
    layer.make_bucket("b")
    rng = np.random.default_rng(9)
    data = {n: rng.bytes(2 * BS) for n in names.values()}
    start = threading.Barrier(len(data))
    errs = []

    def put(name):
        try:
            start.wait()
            layer.put_object("b", name, data[name])
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    threads = [threading.Thread(target=put, args=(n,)) for n in data]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sched._run_erasure = real
    try:
        assert not errs
        assert dispatches == [[0, 1]]
        assert sched.stats()["coalesced"] == 1
        for name, d in data.items():
            _info, it = layer.get_object("b", name)
            assert b"".join(it) == d
    finally:
        layer.close()
        sched.close()
