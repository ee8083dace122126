"""The port's heal (minio_tpu_torch.object.healing) against minio_tpu's,
byte for byte.

minio_tpu writes one drive set; it is copied, the same damage is done to
both copies (drives wiped, a survivor byte flipped), minio_tpu heals one
copy and the port the other. Every file under every drive's bucket dir
must then be identical across the two copies (tolerance 0: bytes). The
port runs its fused recover step on CPU tensors (the kernels' plain
versions; the codec's size gate lowered), with and without the batch
former. Also: a dangling object is removed as minio_tpu removes it, and a
fused recover dispatch that raises makes heal_object raise — there is no
host retry.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from minio_tpu.object.sets import ErasureSets
from minio_tpu_torch.object import codec, healing, open_erasure_set
from minio_tpu_torch.parallel.scheduler import BatchScheduler

K, M, BS = 4, 2, 1 << 14
SIZES = {"empty": 0, "small": 1000, "one": BS, "multi": 5 * BS + 123,
         "groups": 11 * BS + 7}


@pytest.fixture
def small_gate(monkeypatch):
    monkeypatch.setattr(codec, "DEVICE_MIN_BYTES", 1024)
    monkeypatch.setattr(healing, "HEAL_BATCH_BLOCKS", 4)


def _reference_set(root, seed=3):
    """Drive paths of a set minio_tpu wrote, and the objects in it."""
    paths = [os.path.join(root, f"d{i}") for i in range(K + M)]
    rng = np.random.default_rng(seed)
    objs = {name: rng.bytes(n) for name, n in SIZES.items()}
    ref = ErasureSets.from_drives(paths, set_count=1, set_drive_count=K + M,
                                  parity=M, block_size=BS)
    try:
        ref.make_bucket("b")
        for name, data in objs.items():
            ref.put_object("b", name, data)
    finally:
        ref.close()
    return paths, objs


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _flip(path, obj, at=32 + 100):
    """Flip one payload byte of the object's shard file on one drive."""
    for dirpath, _dirs, files in os.walk(os.path.join(path, "b", obj)):
        for f in files:
            if f.startswith("part."):
                p = os.path.join(dirpath, f)
                with open(p, "r+b") as fh:
                    fh.seek(at)
                    b = fh.read(1)
                    fh.seek(at)
                    fh.write(bytes([b[0] ^ 0x5A]))
                return
    raise AssertionError(f"no shard of {obj} on {path}")


DAMAGE = {
    "one_drive": dict(wipe=(2,)),
    "two_drives": dict(wipe=(0, 5)),
    "flipped_survivor": dict(wipe=(1,), flip=(3,)),
    "deep_scan_flip": dict(flip=(4,), deep=True),
}


@pytest.mark.parametrize("with_scheduler", [False, True])
@pytest.mark.parametrize("damage", list(DAMAGE))
def test_heal_equals_reference(tmp_path, small_gate, damage,
                               with_scheduler):
    spec = DAMAGE[damage]
    paths, objs = _reference_set(str(tmp_path / "ref"))
    port_root = str(tmp_path / "port")
    shutil.copytree(str(tmp_path / "ref"), port_root)
    port_paths = [os.path.join(port_root, f"d{i}") for i in range(K + M)]
    before = {i: _tree(os.path.join(p, "b")) for i, p in enumerate(paths)}
    for ps in (paths, port_paths):
        for i in spec.get("wipe", ()):
            shutil.rmtree(os.path.join(ps[i], "b"))
        for i in spec.get("flip", ()):
            _flip(ps[i], "groups")
    deep = spec.get("deep", False)

    ref = ErasureSets.from_drives(paths, set_count=1, set_drive_count=K + M,
                                  parity=M, block_size=BS)
    try:
        ref_res = {n: ref.heal_object("b", n, deep_scan=deep) for n in objs}
    finally:
        ref.close()
    sched = BatchScheduler(max_wait=0.001) if with_scheduler else None
    port = open_erasure_set(port_paths, K, M, scheduler=sched,
                            block_size=BS, device="cpu")
    try:
        port_res = {n: port.heal_object("b", n, deep_scan=deep)
                    for n in objs}
    finally:
        if sched is not None:
            sched.close()
    for n in objs:
        assert port_res[n].disks_healed == ref_res[n].disks_healed, n
        assert port_res[n].missing_after == ref_res[n].missing_after == 0
    for i in range(K + M):
        got = _tree(os.path.join(port_paths[i], "b"))
        assert got == _tree(os.path.join(paths[i], "b")), f"drive {i}"
        if i in spec.get("wipe", ()) or (deep and i in spec["flip"]):
            assert got == before[i], f"drive {i} not restored"
    if with_scheduler:
        assert sched.stats()["verbs"]["recover"]["batches"] > 0
    for name, data in objs.items():
        _, it = port.get_object("b", name)
        assert b"".join(it) == data


def test_heal_runs_the_fused_recover_step(tmp_path, small_gate,
                                          monkeypatch):
    from minio_tpu_torch.models import pipeline
    paths, objs = _reference_set(str(tmp_path))
    shutil.rmtree(os.path.join(paths[2], "b"))
    calls = []
    real = pipeline.heal_step

    def spy(survivors, *a, **kw):
        calls.append(tuple(survivors.shape))
        return real(survivors, *a, **kw)

    monkeypatch.setattr(pipeline, "heal_step", spy)
    port = open_erasure_set(paths, K, M, block_size=BS, device="cpu")
    for n in objs:
        port.heal_object("b", n)
    # "groups" (12 blocks): batches of 4, 4, 3 full blocks and the short
    # last block; every object's full blocks reach the fused step
    assert (4, K, BS // K) in calls and len(calls) >= len(objs) - 1


def test_dangling_object_removed_as_reference(tmp_path, small_gate):
    paths, objs = _reference_set(str(tmp_path / "ref"))
    port_root = str(tmp_path / "port")
    shutil.copytree(str(tmp_path / "ref"), port_root)
    port_paths = [os.path.join(port_root, f"d{i}") for i in range(K + M)]
    # two copies of "multi" survive (< K): it can never be read back
    for ps in (paths, port_paths):
        for i in range(2, K + M):
            shutil.rmtree(os.path.join(ps[i], "b", "multi"))
    ref = ErasureSets.from_drives(paths, set_count=1, set_drive_count=K + M,
                                  parity=M, block_size=BS)
    try:
        assert ref.heal_object("b", "multi").dangling_removed
    finally:
        ref.close()
    port = open_erasure_set(port_paths, K, M, block_size=BS, device="cpu")
    assert port.heal_object("b", "multi").dangling_removed
    for i in range(K + M):
        assert not os.path.exists(os.path.join(port_paths[i], "b", "multi"))
        assert _tree(os.path.join(port_paths[i], "b")) == \
            _tree(os.path.join(paths[i], "b"))


@pytest.mark.parametrize("with_scheduler", [False, True])
def test_failed_recover_dispatch_raises(tmp_path, small_gate, monkeypatch,
                                        with_scheduler):
    """A fused recover dispatch that fails raises out of heal_object: no
    host rebuild takes its place, and the drive stays unhealed for the MRF
    queue to retry."""
    paths, _objs = _reference_set(str(tmp_path))
    shutil.rmtree(os.path.join(paths[1], "b"))

    def boom(*a, **kw):
        raise RuntimeError("recover dispatch failed on the device")

    monkeypatch.setattr(codec.Codec, "verify_and_recover_batch", boom)
    rebuilt = []
    monkeypatch.setattr(healing.HealMixin, "_host_rebuild_block",
                        lambda *a, **kw: rebuilt.append(a))
    monkeypatch.setattr(codec.Codec, "recover_stacked",
                        lambda *a, **kw: rebuilt.append(a))
    sched = BatchScheduler(max_wait=0.001) if with_scheduler else None
    port = open_erasure_set(paths, K, M, scheduler=sched, block_size=BS,
                            device="cpu")
    try:
        with pytest.raises(RuntimeError, match="recover dispatch failed"):
            port.heal_object("b", "groups")
    finally:
        if sched is not None:
            sched.close()
    assert rebuilt == []
    assert not os.path.exists(os.path.join(paths[1], "b", "groups"))
