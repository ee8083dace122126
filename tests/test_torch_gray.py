"""The port's gray-failure plane (minio_tpu_torch/utils/healthtrack.py, the
hedged shard reads and the PUT's quorum-ack lane of object/engine.py, the
disk monitor's slow-drive quarantine in object/background.py, and
storage/naughty.py) held against minio_tpu's.

  * every case of tests/test_gray.py rebound to the port
    (tests/test_torch_iam.rebound), its sets on device="cpu": a stall mid
    GET bounded by the hedge, a hedge loser that stays benign across
    read groups, a stall mid PUT acked at quorum and converged through
    MRF, a stall mid multipart commit, a slow drive behind storage RPC,
    the quarantine round trip, the capacity rule, and the seeded stall
    schedule;
  * the deterministic scenarios on twin sets (the reference's and the
    port's, identities pinned in both, tests/test_torch_s3.pin, with the
    gray-failure deadlines left live): the stalled PUT and the stalled
    multipart commit converge to equal bucket files, ``xl.meta`` bytes
    included, on every drive; the hedge loser's GET reconstructs its
    groups in both and queues no MRF heal in either; the quarantine round
    trip gives equal quarantine events and equal ``drive.*`` and
    ``health.transition`` journal records (drive paths and times
    masked).

Six drives at 4+2, 64 KiB blocks, one drive wrapped in each package's
NaughtyDisk stalling 0.6 s; the deadlines tightened as the reference's
tests tighten them. Byte comparisons are exact (tolerance 0).
"""

from __future__ import annotations

import inspect
import os
import time
import types

import numpy as np
import pytest

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.codec as ref_codec
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu.utils.eventlog as ref_eventlog
import minio_tpu.utils.healthtrack as ref_ht
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.codec as port_codec
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
import minio_tpu_torch.utils.eventlog as port_eventlog
import minio_tpu_torch.utils.healthtrack as port_ht
import tests.test_gray as ref_cases
from minio_tpu.object.background import DiskMonitor as RefMonitor
from minio_tpu.object.multipart import CompletePart as RefPart
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.storage.naughty import NaughtyDisk as RefNaughty
from minio_tpu.storage.xl_storage import XLStorage as RefXL
from minio_tpu_torch.object.background import DiskMonitor
from minio_tpu_torch.object.multipart import CompletePart
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.datatypes import hash_order
from minio_tpu_torch.storage.naughty import NaughtyDisk
from minio_tpu_torch.storage.xl_storage import XLStorage
from tests.test_torch_iam import rebound
from tests.test_torch_s3 import pin

pytestmark = pytest.mark.chaos

K, M = ref_cases.K, ref_cases.M
N = K + M
BLOCK = ref_cases.BLOCK
STALL = ref_cases.STALL
READ_STALLS = ref_cases.READ_STALLS
WRITE_STALLS = ref_cases.WRITE_STALLS

REF = types.SimpleNamespace(
    tag="ref", sets=RefSets, naughty=RefNaughty, xl=RefXL, ht=ref_ht,
    monitor=RefMonitor, part=RefPart, codec=ref_codec, eventlog=ref_eventlog,
    kw={}, pin=(ref_engine, ref_multipart, ref_bmeta, ref_handlers,
                ref_crypto))
PORT = types.SimpleNamespace(
    tag="port", sets=ErasureSets, naughty=NaughtyDisk, xl=XLStorage,
    ht=port_ht, monitor=DiskMonitor, part=CompletePart, codec=port_codec,
    eventlog=port_eventlog, kw={"device": "cpu"},
    pin=(port_engine, port_multipart, port_bmeta, port_handlers,
         port_crypto))


@pytest.fixture(autouse=True)
def _gray_env(monkeypatch):
    """tests/test_gray.py's fixture for both packages: the deadlines
    tightened so the plane bites at test scale, and clean trackers."""
    monkeypatch.setenv("MINIO_TPU_HEDGE_FLOOR_S", "0.05")
    monkeypatch.setenv("MINIO_TPU_HEDGE_CEIL_S", "0.1")
    monkeypatch.setenv("MINIO_TPU_WRITE_STALL_FLOOR_S", "0.1")
    monkeypatch.setenv("MINIO_TPU_WRITE_STALL_CEIL_S", "0.2")
    for ht in (ref_ht, port_ht):
        ht.TRACKER.reset()
    yield
    for ht in (ref_ht, port_ht):
        ht.TRACKER.reset()


# -- tests/test_gray.py, rebound ----------------------------------------------

class _CpuSets:
    """The port's ErasureSets as tests/test_gray.py calls it, on the CPU."""

    @staticmethod
    def from_storage(*args, **kw):
        return ErasureSets.from_storage(*args, device="cpu", **kw)


_CASES = sorted(name for name, fn in vars(ref_cases).items()
                if name.startswith("test_") and inspect.isfunction(fn))


def test_every_reference_case_is_rebound():
    assert len(_CASES) == 9, _CASES


@pytest.mark.parametrize("name", _CASES)
def test_reference_gray_cases(tmp_path, monkeypatch, name):
    fn = rebound(getattr(ref_cases, name), ErasureSets=_CpuSets)
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


# -- twin sets ------------------------------------------------------------------

def _payload(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _make(pkg, root):
    """One package's 6-drive set under `root`, drive 0 wrapped in its
    (disarmed) NaughtyDisk, bucket b made."""
    drives: list = [pkg.xl(str(root / f"d{j}")) for j in range(N)]
    nd = pkg.naughty(drives[0], enabled=False)
    drives[0] = nd
    sets = pkg.sets.from_storage(
        drives, set_count=1, set_drive_count=N, parity=M, block_size=BLOCK,
        mrf_options=dict(ref_cases.MRF_TEST_OPTIONS), **pkg.kw)
    sets.make_bucket("b")
    return sets, nd


def _stall(nd, verbs) -> None:
    nd.stall_verbs = {v: STALL for v in verbs}
    nd.arm()


def _calm(nd) -> None:
    nd.disarm()
    nd.stall_verbs = {}


def _converged(sets, datas: dict) -> None:
    """tests/test_gray.assert_converged: MRF drained, every object whole
    on every drive."""
    assert sets.drain_mrf(30.0)
    assert sets.mrf_stats()["pending"] == 0
    for name, data in datas.items():
        _, it = sets.get_object("b", name)
        assert b"".join(it) == data, name
        for d in sets.sets[0].disks:
            d.check_parts("b", name, d.read_version("b", name))


def _bucket_files(root) -> dict:
    """Every file under each drive's bucket dir, by path relative to the
    set's root: shard files and xl.meta, bytes."""
    out = {}
    for j in range(N):
        base = root / f"d{j}" / "b"
        for dirpath, _dirs, files in os.walk(base):
            for f in files:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture
def pinned(monkeypatch):
    """Both packages' identities pinned, their gray-failure deadlines left
    live (tests/test_torch_s3.pin pins the write grace at its ceiling)."""
    live = {pkg.tag: (pkg.ht.write_stall_s, pkg.ht.read_hedge_s)
            for pkg in (REF, PORT)}
    for pkg in (REF, PORT):
        pin(monkeypatch, *pkg.pin)
        monkeypatch.setattr(pkg.ht, "write_stall_s", live[pkg.tag][0])
        monkeypatch.setattr(pkg.ht, "read_hedge_s", live[pkg.tag][1])


def _put_stalled(pkg, root) -> dict:
    sets, nd = _make(pkg, root)
    data = _payload(2 * BLOCK + 77, 12)
    _stall(nd, WRITE_STALLS)
    try:
        t0 = time.perf_counter()
        sets.put_object("b", "o", data)
        dt = time.perf_counter() - t0
    finally:
        _calm(nd)
    assert dt < STALL * 1.5, f"{pkg.tag} PUT took {dt:.3f}s"
    assert nd.stats.stalls >= 1
    _converged(sets, {"o": data})
    sets.close()
    return _bucket_files(root)


def _multipart_stalled(pkg, root) -> dict:
    sets, nd = _make(pkg, root)
    data = _payload(3 * BLOCK + 17, 13)
    uid = sets.new_multipart_upload("b", "mp")
    sets.put_object_part("b", "mp", uid, 1, data)
    pi = sets.list_object_parts("b", "mp", uid)[0]
    _stall(nd, WRITE_STALLS)
    try:
        t0 = time.perf_counter()
        sets.complete_multipart_upload("b", "mp", uid,
                                       [pkg.part(1, pi.etag)])
        dt = time.perf_counter() - t0
    finally:
        _calm(nd)
    assert dt < STALL * 1.5, f"{pkg.tag} complete took {dt:.3f}s"
    assert nd.stats.stalls >= 1
    _converged(sets, {"mp": data})
    sets.close()
    return _bucket_files(root)


@pytest.mark.parametrize("scenario", [_put_stalled, _multipart_stalled],
                         ids=["put", "multipart_commit"])
def test_twin_stalled_writes_converge_to_equal_files(tmp_path, pinned,
                                                     scenario):
    """A write acked at quorum past the stalled drive, then healed
    through MRF: both packages leave the same bucket files on every
    drive (the abandoned laggard's late landing or its MRF heal)."""
    files = [scenario(pkg, tmp_path / pkg.tag) for pkg in (REF, PORT)]
    assert sorted(files[0]) == sorted(files[1])
    assert any(p.endswith("xl.meta") for p in files[1])
    for path in files[0]:
        assert files[0][path] == files[1][path], path


def test_twin_hedge_loser_reconstructs_without_heal(tmp_path, monkeypatch):
    """A multi-group GET against a drive stalling every read: in both
    packages the latency hedge out-races it in the first group, every
    group that lacked its data shard is reconstructed, and nothing is
    queued for heal (the loser's absence is benign across groups)."""
    got = []
    for pkg in (REF, PORT):
        calls = []
        real = pkg.codec.Codec.recover_stacked

        def counted(self, *a, _real=real, _calls=calls, **kw):
            _calls.append(1)
            return _real(self, *a, **kw)

        monkeypatch.setattr(pkg.codec.Codec, "recover_stacked", counted)
        sets, nd = _make(pkg, tmp_path / pkg.tag)
        engine = port_engine if pkg is PORT else ref_engine
        data = _payload(3 * engine.GET_BATCH_BLOCKS * BLOCK + 31, 15)
        # a name whose data shard lives on the stalled drive
        name = next(f"o{i}" for i in range(64)
                    if hash_order(f"b/o{i}", N)[0] <= K)
        sets.put_object("b", name, data)
        assert nd.read_version("b", name).erasure.index <= K
        hedged0 = pkg.ht._HEDGED.value(trigger="latency")
        calls.clear()
        _stall(nd, READ_STALLS)
        try:
            _, it = sets.get_object("b", name)
            body = b"".join(it)
        finally:
            _calm(nd)
        assert body == data
        stats = sets.mrf_stats()
        got.append((pkg.ht._HEDGED.value(trigger="latency") > hedged0,
                    len(calls) > 0, stats["queued"], stats["pending"]))
        sets.close()
    assert got[0] == got[1] == (True, True, 0, 0), got


def _round_trip(pkg, root) -> tuple[list, list]:
    """tests/test_gray.py's quarantine round trip on one package: (the
    monitor's events, the journal's drive.* and health.transition records
    for the drive, masked)."""
    sets, nd = _make(pkg, root)
    key = pkg.ht.disk_key(nd)
    seq0 = max([e["seq"] for e in pkg.eventlog.JOURNAL.recent()] or [0])
    for i in range(4):
        sets.put_object("b", f"o{i}", _payload(BLOCK + i, 20 + i))
    mon = pkg.monitor(sets, interval=3600)
    _stall(nd, READ_STALLS + ("disk_info",))
    for i in range(4):
        _, it = sets.get_object("b", f"o{i}")
        b"".join(it)
    mon.scan_once()
    assert pkg.ht.TRACKER.state_of("drive", key) == pkg.ht.STATE_SUSPECT
    mon.scan_once()
    _calm(nd)
    for _ in range(4):
        mon.scan_once()
        if pkg.ht.TRACKER.state_of("drive", key) == pkg.ht.STATE_OK:
            break
    mon.scan_once()
    assert pkg.ht.TRACKER.state_of("drive", key) == pkg.ht.STATE_OK
    sets.close()
    records = []
    for e in pkg.eventlog.JOURNAL.recent(
            0, classes={"drive.suspect", "drive.probation",
                        "drive.reconvict", "drive.readmit",
                        "health.transition"}, since_seq=seq0):
        attrs = dict(e["attrs"])
        who = attrs.get("drive", attrs.get("target"))
        if who != key:
            continue
        for a in ("drive", "target"):
            if a in attrs:
                attrs[a] = os.path.relpath(attrs[a], root)
        records.append((e["class"], e["sev"], e["sub"], attrs))
    return [e for _k, e in mon.quarantine_events], records


def test_twin_quarantine_round_trip_events_and_journal(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("MINIO_TPU_QUAR_LATENCY_S", "0.2")
    monkeypatch.setenv("MINIO_TPU_QUAR_MIN_SAMPLES", "4")
    monkeypatch.setenv("MINIO_TPU_QUAR_PROBATION_S", "0")
    monkeypatch.setenv("MINIO_TPU_QUAR_PROBES", "2")
    got = [_round_trip(pkg, tmp_path / pkg.tag)
           for pkg in (REF, PORT)]
    assert got[0] == got[1]
    events, records = got[1]
    assert events == ["suspect", "probation", "reconvict", "probation",
                      "readmit"], events
    assert [r[0] for r in records if r[0].startswith("drive.")] == \
        ["drive.suspect", "drive.probation", "drive.reconvict",
         "drive.probation", "drive.readmit"]
    assert records[0][3] == {"kind": "drive", "target": "d0",
                             "state": "suspect", "event": "suspect"}
