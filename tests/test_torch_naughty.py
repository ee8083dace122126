"""The port's fault-injecting drive (minio_tpu_torch/storage/naughty.py)
held against minio_tpu's.

  * the same seed gives the same decisions in both packages'
    ``FaultSchedule``s, verb by verb and call by call: errors (class and
    message), latency, bitrot, truncation, the fault offset, offline op
    windows and stall durations (the heavy tail and the stall windows);
  * both packages' ``NaughtyDisk`` over their own ``XLStorage``, driven
    through one seeded verb sequence under one schedule, answer alike
    (payloads byte for byte, errors by class), count the same
    ``FaultStats`` and leave the same files;
  * programmed faults: ``fail_verbs``, one-shot ``verb_errors``,
    ``offline``, one-shot ``verb_stalls`` and ``stall_verbs`` (a
    ``read_file_stream`` stall deferred to the stream's first read) behave
    alike.
Exact equality throughout (tolerance 0).
"""

from __future__ import annotations

import io
import os
import time

import numpy as np
import pytest

from minio_tpu.storage import errors as ref_errors
from minio_tpu.storage.naughty import FaultSchedule as RefSchedule
from minio_tpu.storage.naughty import NaughtyDisk as RefNaughty
from minio_tpu.storage.xl_storage import XLStorage as RefXL
from minio_tpu_torch.storage import errors
from minio_tpu_torch.storage.naughty import (ALL_VERBS, DATA_VERBS,
                                             FaultSchedule, NaughtyDisk)
from minio_tpu_torch.storage.xl_storage import XLStorage

PAIRS = ((RefSchedule, RefNaughty, RefXL, ref_errors),
         (FaultSchedule, NaughtyDisk, XLStorage, errors))

SCHEDULES = [
    dict(seed=7, error_rate=0.2, latency_rate=0.3, bitrot_rate=0.1,
         truncate_rate=0.1, offline_windows=((30, 40),)),
    dict(seed=99, stall_rate=0.4, stall_s=0.3, stall_pareto=1.5,
         stall_max_s=2.0, stall_windows=((5, 9), (50, 60))),
    dict(seed=12345, error_rate=0.05, bitrot_rate=0.5, truncate_rate=0.3,
         fault_verbs=ALL_VERBS),
]


def _decisions(cls, params: dict) -> list:
    s = cls(**params)
    out = []
    for verb in ALL_VERBS + ("disk_info",):
        for n in range(1, 120):
            err = s.error_for(verb, n)
            out.append((verb, n, type(err).__name__ if err else None,
                        str(err) if err else None, s.latency_for(verb, n),
                        s.corrupts(verb, n), s.truncates(verb, n),
                        s.fault_offset(verb, n, 1000 + n),
                        s.stall_for(verb, n, n)))
    out.append([s.offline_at(op) for op in range(100)])
    return out


@pytest.mark.parametrize("params", SCHEDULES,
                         ids=["errors", "stalls", "payload"])
def test_schedule_decisions_equal(params):
    ref, port = (_decisions(cls, params) for cls, *_ in PAIRS)
    assert ref == port
    fired = [d for d in port[:-1] if d[2] or d[5] or d[6] or d[8]]
    assert fired, "the schedule decided nothing"


def _drive_program(pair, root: str, params: dict, seed: int) -> tuple:
    """One seeded verb sequence against one package's NaughtyDisk: every
    answer, the stats, and the files left."""
    sched_cls, naughty_cls, xl_cls, _errs = pair
    params = dict(params, latency=0.0, stall_s=0.0)
    nd = naughty_cls(xl_cls(root), sched_cls(**params), enabled=False)
    nd.make_vol("v")
    nd.arm()
    rng = np.random.default_rng(seed)
    out = []
    for step in range(150):
        op = int(rng.integers(0, 6))
        name = f"f{int(rng.integers(0, 8))}"
        body = rng.bytes(int(rng.integers(1, 300)))
        try:
            if op == 0:
                nd.write_all("v", name, body)
                res = None
            elif op == 1:
                res = nd.read_all("v", name)
            elif op == 2:
                nd.create_file("v", name, len(body), io.BytesIO(body))
                res = None
            elif op == 3:
                nd.append_file("v", name, body)
                res = None
            elif op == 4:
                s = nd.read_file_stream("v", name, 0, 64)
                res = s.read(64)
                s.close()
            else:
                res = nd.read_file("v", name, 0, 16)
            out.append((step, op, res))
        except Exception as e:  # noqa: BLE001 — compared by class
            out.append((step, op, type(e).__name__))
    st = nd.stats
    stats = (st.errors, st.latency, st.bitrot, st.truncated,
             st.offline_hits, st.stalls, dict(st.calls), nd.total_ops)
    files = {}
    for dirpath, _d, fs in os.walk(os.path.join(root, "v")):
        for f in fs:
            with open(os.path.join(dirpath, f), "rb") as fh:
                files[os.path.relpath(os.path.join(dirpath, f), root)] = \
                    fh.read()
    return out, stats, files


@pytest.mark.parametrize("params", SCHEDULES,
                         ids=["errors", "stalls", "payload"])
def test_naughty_disk_program_equal(tmp_path, params):
    ref, port = (_drive_program(pair, str(tmp_path / tag), params, 3)
                 for pair, tag in zip(PAIRS, ("ref", "port")))
    assert ref[0] == port[0]
    assert ref[1] == port[1]
    assert ref[2] == port[2]
    assert port[1][6], "no verb was counted"


def _programmed(pair, root: str) -> list:
    sched_cls, naughty_cls, xl_cls, errs = pair
    nd = naughty_cls(xl_cls(root), enabled=True)
    out = []
    nd.make_vol("v")
    nd.write_all("v", "a", b"payload")
    nd.fail_verbs["read_all"] = errs.FaultyDisk("programmed")
    for _ in range(2):
        try:
            nd.read_all("v", "a")
        except errs.StorageError as e:
            out.append(type(e).__name__)
    nd.fail_verbs.clear()
    nd.verb_errors = {"read_all": {5: errs.FileCorrupt("5th")}}
    for _ in range(3):
        try:
            out.append(nd.read_all("v", "a"))
        except errs.StorageError as e:
            out.append(type(e).__name__)
    nd.offline = True
    out.append(nd.is_online())
    try:
        nd.stat_vol("v")
    except errs.DiskNotFound as e:
        out.append(type(e).__name__)
    nd.offline = False
    nd.verb_stalls = {"write_all": {3: 0.05}}
    t0 = time.perf_counter()
    nd.write_all("v", "b", b"x")
    out.append(time.perf_counter() - t0 >= 0.05)
    nd.stall_verbs = {"read_file_stream": 0.05}
    t0 = time.perf_counter()
    s = nd.read_file_stream("v", "a", 0, 7)
    opened = time.perf_counter() - t0
    got = s.read(7)
    read = time.perf_counter() - t0
    s.close()
    # the stall rides the first read, not the open
    out += [opened < 0.05, read >= 0.05, got]
    st = nd.stats
    out.append((st.stalls, round(st.stall_s, 6), st.offline_hits,
                dict(st.calls), nd.total_ops, str(nd).startswith("naughty(")))
    return out


def test_programmed_faults_equal(tmp_path):
    ref, port = (_programmed(pair, str(tmp_path / tag))
                 for pair, tag in zip(PAIRS, ("ref", "port")))
    assert ref == port
    assert port[:6] == ["FaultyDisk", "FaultyDisk", b"payload", b"payload",
                        "FileCorrupt", False]


def test_data_verbs_are_the_references():
    from minio_tpu.storage import naughty as ref_naughty
    assert DATA_VERBS == ref_naughty.DATA_VERBS
    assert ALL_VERBS == ref_naughty.ALL_VERBS
