"""The port's MRF heal queue (minio_tpu_torch.object.background.MRFHealer)
held to the reference's unit tests (tests/test_mrf.py:34-171): retry with
capped exponential backoff, dedup and re-arm, partial heals, the bound,
close and kick; and a degraded PUT on the CPU that converges after
drain(), its healed shards byte for byte those of minio_tpu's healthy PUT
of the same bytes."""

from __future__ import annotations

import os
import threading
import time

import pytest

from minio_tpu_torch.object import (HealResultItem, api_errors, codec,
                                    engine, open_erasure_set)
from minio_tpu_torch.object.background import MRFHealer

K, M, BS = 4, 2, 1 << 14


def _healer(fn, **kw):
    kw.setdefault("max_retries", 3)
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("backoff_max", 0.05)
    return MRFHealer(fn, **kw)


def test_mrf_heals_and_drains():
    healed = []
    h = _healer(lambda b, o, v: healed.append((b, o, v)))
    assert h.enqueue("b", "o1")
    assert h.enqueue("b", "o2", "vid")
    assert h.drain(5.0)
    assert ("b", "o1", "") in healed and ("b", "o2", "vid") in healed
    s = h.stats()
    assert s["healed"] == 2 and s["pending"] == 0 and s["failed"] == 0
    h.close()


def test_mrf_retries_with_backoff_then_succeeds():
    attempts = []

    def flaky(b, o, v):
        attempts.append(time.monotonic())
        if len(attempts) < 3:
            raise api_errors.InsufficientReadQuorum("not yet")

    h = _healer(flaky)
    h.enqueue("b", "o")
    assert h.drain(5.0)
    s = h.stats()
    assert len(attempts) == 3
    assert s["healed"] == 1 and s["requeued"] == 2 and s["failed"] == 0
    assert attempts[1] - attempts[0] >= 0.004
    h.close()


def test_mrf_gives_up_after_max_retries():
    n = [0]

    def hopeless(b, o, v):
        n[0] += 1
        raise api_errors.HealFailed("never")

    h = _healer(hopeless, max_retries=2)
    h.enqueue("b", "o")
    assert h.drain(5.0)
    s = h.stats()
    assert n[0] == 3                      # first try + 2 retries
    assert s["failed"] == 1 and s["healed"] == 0 and s["pending"] == 0
    h.close()


def test_mrf_vanished_object_counts_skipped():
    h = _healer(lambda b, o, v: (_ for _ in ()).throw(
        api_errors.ObjectNotFound(b, o)))
    h.enqueue("b", "gone")
    assert h.drain(5.0)
    s = h.stats()
    assert s["skipped"] == 1 and s["failed"] == 0
    h.close()


def test_mrf_dedups_queued_and_rearms_inflight():
    gate = threading.Event()
    healed = []

    def slow(b, o, v):
        if o == "blocker":
            gate.wait(5.0)
        healed.append((b, o, v))

    h = _healer(slow)
    assert h.enqueue("b", "blocker")
    time.sleep(0.05)                       # blocker moves in-flight
    assert h.enqueue("b", "o")             # queued behind it
    assert not h.enqueue("b", "o")         # duplicate while QUEUED: drop
    assert h.enqueue("b", "o", "v2")       # distinct version: kept
    assert h.enqueue("b", "blocker")       # running: re-armed, not lost
    gate.set()
    assert h.drain(5.0)
    assert healed.count(("b", "o", "")) == 1
    assert healed.count(("b", "o", "v2")) == 1
    assert healed.count(("b", "blocker", "")) == 2
    h.close()


def test_mrf_partial_heal_retries_until_converged():
    calls = []

    def partial(b, o, v):
        calls.append(1)
        return HealResultItem(disks_healed=1,
                              missing_after=0 if len(calls) >= 3 else 1)

    h = _healer(partial)
    h.enqueue("b", "o")
    assert h.drain(5.0)
    s = h.stats()
    assert len(calls) == 3
    assert s["healed"] == 1 and s["requeued"] == 2 and s["failed"] == 0
    h.close()


def test_mrf_bounded_queue_drops_overflow():
    gate = threading.Event()
    h = _healer(lambda b, o, v: gate.wait(5.0), maxsize=2)
    h.enqueue("b", "o1")
    time.sleep(0.05)          # let o1 move in-flight
    h.enqueue("b", "o2")
    h.enqueue("b", "o3")
    assert not h.enqueue("b", "o4")       # over maxsize: dropped
    assert h.stats()["dropped"] == 1
    gate.set()
    assert h.drain(5.0)
    h.close()


def test_mrf_close_stops_the_drain_thread():
    h = _healer(lambda b, o, v: None)
    h.close()
    assert not h.enqueue("b", "o")        # closed: enqueue refused
    h._thread.join(2.0)
    assert not h._thread.is_alive()


def test_mrf_kick_collapses_pending_backoffs():
    attempts = []

    def flaky(b, o, v):
        attempts.append(time.monotonic())
        if len(attempts) == 1:
            raise api_errors.HealFailed("drive offline")

    h = _healer(flaky, backoff_base=30.0, backoff_max=30.0)
    h.enqueue("b", "o")
    deadline = time.monotonic() + 5
    while h.stats()["requeued"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert h.kick() == 1
    assert h.drain(5.0)                   # no 15-30 s backoff wait
    assert len(attempts) == 2 and h.stats()["healed"] == 1
    h.close()


def _part_files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.startswith("part."):
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                parts = rel.split(os.sep)
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.sep.join(parts[:-2] + [parts[-1]])] = fh.read()
    return out


@pytest.mark.parametrize("with_scheduler", [False, True])
def test_degraded_put_converges_after_drain(tmp_path, monkeypatch,
                                            with_scheduler):
    """A PUT with one drive offline queues an MRF heal; the drive comes
    back, drain() heals it through the fused recover step, and the drive
    then holds the shards of minio_tpu's healthy PUT of the same bytes."""
    import numpy as np
    from minio_tpu.object.sets import ErasureSets
    from minio_tpu_torch.parallel.scheduler import BatchScheduler
    monkeypatch.setattr(codec, "DEVICE_MIN_BYTES", 1024)
    monkeypatch.setattr(engine, "ENCODE_BATCH_BLOCKS", 2)
    rng = np.random.default_rng(17)
    objs = {"o1": rng.bytes(5 * BS + 77), "o2": rng.bytes(2 * BS)}
    sched = BatchScheduler(max_wait=0.001) if with_scheduler else None
    paths = [str(tmp_path / f"p{i}") for i in range(K + M)]
    obj = open_erasure_set(paths, K, M, scheduler=sched, mrf=True,
                           block_size=BS, device="cpu",
                           mrf_kw={"backoff_base": 0.01,
                                   "backoff_max": 0.05,
                                   "max_retries": 1000})
    try:
        obj.make_bucket("b")
        slot = 3
        drive, obj.disks[slot] = obj.disks[slot], None
        for name, data in objs.items():
            obj.put_object("b", name, data)
        assert obj.mrf.stats()["queued"] == len(objs)
        obj.disks[slot] = drive
        obj.mrf.kick()
        assert obj.mrf.drain(60.0)
        st = obj.mrf.stats()
        assert st["healed"] == len(objs) and st["failed"] == 0
        for name, data in objs.items():
            fi = drive.read_version("b", name)
            drive.check_parts("b", name, fi)
            drive.verify_file("b", name, fi)
            _, it = obj.get_object("b", name)
            assert b"".join(it) == data
    finally:
        obj.mrf.close()
        if sched is not None:
            sched.close()
    if sched is not None:
        assert sched.stats()["verbs"]["recover"]["batches"] > 0
    ref_paths = [str(tmp_path / f"r{i}") for i in range(K + M)]
    ref = ErasureSets.from_drives(ref_paths, set_count=1,
                                  set_drive_count=K + M, parity=M,
                                  block_size=BS)
    try:
        ref.make_bucket("b")
        for name, data in objs.items():
            ref.put_object("b", name, data)
    finally:
        ref.close()
    want = _part_files(os.path.join(ref_paths[slot], "b"))
    got = _part_files(os.path.join(paths[slot], "b"))
    assert len(want) == len(objs) and got == want


def test_degraded_write_hook_reports_version(tmp_path):
    eng = engine.from_reference_layout(
        [str(tmp_path / f"d{i}") for i in range(K + M)], K, M,
        block_size=BS, device="cpu")
    eng.make_bucket("b")
    seen = []
    eng.on_degraded_write = lambda b, o, v: seen.append((b, o, v))
    eng.put_object("b", "whole", b"x" * 100)
    assert seen == []                     # every drive took the write
    eng.disks[0] = None
    info = eng.put_object("b", "o", b"y" * 100,
                          opts=engine.PutOptions(versioned=True))
    assert seen == [("b", "o", info.version_id)] and info.version_id
