"""The port's lock-order watchdog (minio_tpu_torch/utils/lockcheck.py) and
its named locks, held against minio_tpu's.

  * every case of tests/test_lockcheck.py rebound to the port
    (tests/test_torch_iam.rebound): cycle detection and its raise,
    record-only mode, held-while-blocking and long-hold flags, the
    self-deadlock refusal, conditions over checked locks, the rollback of
    a refused acquire, the watchdog flipped off mid-hold, and the mesh
    dispatch cycle shape;
  * the reference's in-situ case on the port's batch former, byte pool
    and codec, on device="cpu";
  * a PUT/GET/heal round through the batch former on an erasure set, so
    that the card path's roles the CPU reaches (codec.steps,
    bpool.copies) are taken beside the reference's under the watchdog,
    with no cycle recorded (codec.slots, kernels.count and kernels.build
    are taken only on the card: chip_smoke.py's watchdog phases).

The watchdog is on for this module and for tests/test_torch_chaos.py and
tests/test_torch_concurrency.py (``port_watchdog``, the port's copy of
tests/conftest.py's fixture): every test ends with no ``cycle``
violation. MINIO_TPU_LOCKCHECK=off opts out.
"""

from __future__ import annotations

import inspect
import os
import shutil
import threading

import numpy as np
import pytest

import minio_tpu.utils.lockcheck  # noqa: F401 — imported before the knob flips
import tests.test_lockcheck as ref_cases
from minio_tpu_torch.utils import lockcheck
from tests.test_torch_iam import rebound

pytestmark = pytest.mark.chaos

_OFF = ("off", "0", "false", "no")


@pytest.fixture(autouse=True)
def port_watchdog():
    """tests/conftest.py's watchdog fixture for the port's lockcheck: on
    for the test, and no cycle recorded at its end (cycles raised on
    daemon threads are swallowed by their loops; they surface here)."""
    if os.environ.get("MINIO_TPU_LOCKCHECK", "").strip().lower() in _OFF:
        yield
        return
    prev = os.environ.get("MINIO_TPU_LOCKCHECK")
    os.environ["MINIO_TPU_LOCKCHECK"] = "on"
    lockcheck.refresh()
    lockcheck.reset()
    try:
        yield
        cycles = lockcheck.violations("cycle")
        assert not cycles, ("lock-order watchdog recorded cycle(s): "
                            + "; ".join(v.detail for v in cycles))
    finally:
        if prev is None:
            os.environ.pop("MINIO_TPU_LOCKCHECK", None)
        else:
            os.environ["MINIO_TPU_LOCKCHECK"] = prev
        lockcheck.refresh()
        lockcheck.reset()


@pytest.fixture(autouse=True)
def _fresh_graph(port_watchdog):
    """tests/test_lockcheck.py's own fixture: the cases that make cycles
    on purpose start and end with an empty graph."""
    lockcheck.reset()
    yield
    lockcheck.reset()


# -- tests/test_lockcheck.py, rebound -----------------------------------------

_HAND_PORTED = ("test_real_scheduler_and_metacache_clean_under_watchdog",)
_ALL = sorted(name for name, fn in vars(ref_cases).items()
              if name.startswith("test_") and inspect.isfunction(fn))
_CASES = [n for n in _ALL if n not in _HAND_PORTED]


def test_every_reference_case_is_rebound():
    assert len(_ALL) == 16, _ALL
    assert set(_HAND_PORTED) <= set(_ALL)


@pytest.mark.parametrize("name", _CASES)
def test_reference_lockcheck_cases(monkeypatch, name):
    fn = rebound(getattr(ref_cases, name))
    given = {"monkeypatch": monkeypatch}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_real_scheduler_and_metacache_clean_under_watchdog(tmp_path):
    """tests/test_lockcheck.py's in-situ case on the port: the named
    production locks (scheduler buckets and kick, byte pool) run a real
    submit/drain workload under the watchdog without a cycle."""
    from minio_tpu_torch import bitrot as bitrot_mod
    from minio_tpu_torch.object.codec import Codec
    from minio_tpu_torch.parallel.bpool import BytePool
    from minio_tpu_torch.parallel.scheduler import BatchScheduler

    sched = BatchScheduler(max_batch=8, max_wait=0.001)
    try:
        codec = Codec(2, 1, 1 << 12, device="cpu")
        futs = [sched.submit(codec,
                             np.zeros((1, 2, 1 << 11), np.uint8),
                             bitrot_mod.BitrotAlgorithm.HIGHWAYHASH256)
                for _ in range(4)]
        for f in futs:
            f.result(5)        # declined or dispatched: either way resolves
        pool = BytePool(1 << 10, 2)
        b1 = pool.get(1)
        pool.put(b1)
        sched.stats()
    finally:
        sched.close()
    assert lockcheck.violations("cycle") == []
    assert {"sched.buckets", "bpool.created"} <= set(lockcheck.roles())


# -- the card path's roles ------------------------------------------------------

def test_put_get_heal_through_the_former_clean_under_watchdog(tmp_path,
                                                              monkeypatch):
    """Concurrent PUTs, healthy and degraded GETs and a heal of one
    wiped drive through one batch former on a 4+2 set: every object
    reads back, the wiped drive's shards are rebuilt, and the roles of
    the dispatch path are taken with no cycle recorded."""
    from minio_tpu_torch.object import codec as codec_mod
    from minio_tpu_torch.object import engine as engine_mod
    from minio_tpu_torch.object.sets import ErasureSets
    from minio_tpu_torch.parallel.scheduler import BatchScheduler

    # every batch through the former, and two-block batches so that each
    # PUT runs the pipelined loop over the staging ring
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(engine_mod, "ENCODE_BATCH_BLOCKS", 2)
    sched = BatchScheduler(max_batch=16, max_wait=0.02)
    sets = ErasureSets.from_drives(
        [str(tmp_path / f"d{i}") for i in range(6)], 1, 6, 2,
        block_size=1 << 16, device="cpu", scheduler=sched)
    try:
        sets.make_bucket("b")
        rng = np.random.default_rng(2101)
        datas = {f"o{i}": rng.integers(0, 256, (1 << 16) * 5 + 999 * i,
                                       dtype=np.uint8).tobytes()
                 for i in range(4)}
        errs: list = []

        def put(name):
            try:
                sets.put_object("b", name, datas[name])
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=put, args=(n,)) for n in datas]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert errs == []
        for name, data in datas.items():
            assert b"".join(sets.get_object("b", name)[1]) == data
        eng = sets.sets[0]
        shutil.rmtree(os.path.join(eng.disks[1].root, "b"))
        for name, data in datas.items():
            assert b"".join(sets.get_object("b", name)[1]) == data
        eng.heal_bucket("b")
        for name in datas:
            eng.heal_object("b", name)
        for name in datas:
            fi = eng.disks[1].read_version("b", name)
            eng.disks[1].verify_file("b", name, fi)
    finally:
        sets.close()
        sched.close()
    assert lockcheck.violations("cycle") == []
    taken = set(lockcheck.roles())
    assert {"sched.buckets", "codec.steps", "bpool.copies",
            "mrf.queue"} <= taken, sorted(taken)
    assert sched.stats()["verbs"]["recover"]["batches"] >= 1
