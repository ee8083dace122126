"""The port's incident plane (minio_tpu_torch/utils/slo.py, incidents.py,
console.py, profiling.py and their wiring in cluster.py) held against
minio_tpu's.

  * tests/test_incidents.py's cases rebound to the port: API-class
    membership, breach and clear with hysteresis, the minimum samples, a
    half-filled window, the latency objective over bucket counts, the
    bundle's shape and providers, and the trigger loop's capture and
    debounce; retention;
  * twin SLO engines fed one sequence of cumulative totals give equal
    status documents and equal burn-rate and budget gauges;
  * twin recorders capturing one trigger with the clock pinned write
    bundles of the same id and shape, and each package lists and reads
    the other's bundle directory alike;
  * the console ring: the logging bridge on the ``minio_tpu_torch``
    logger tree, the direct API and ``recent``, alike in both packages;
  * a booted port node (16 drives, 12+4, device="cpu"): the ``online``
    console line, a ``drive.probation`` record captured into a bundle on
    drive 0 with journal and span counts, the SLO engine's windows, the
    recorder's four providers, and the journal's records replayed after
    the node is shut down and booted again; every thread the plane
    started stops at shutdown.
"""

from __future__ import annotations

import logging
import os
import time
import types

import pytest

import minio_tpu.utils.console as ref_console
import minio_tpu.utils.incidents as ref_inc
import minio_tpu.utils.slo as ref_slo
import minio_tpu.utils.telemetry as ref_tel
import minio_tpu_torch.utils.console as port_console
import minio_tpu_torch.utils.incidents as port_inc
import minio_tpu_torch.utils.slo as port_slo
import minio_tpu_torch.utils.telemetry as port_tel
import tests.test_incidents as ref_cases
from minio_tpu_torch import cluster, madmin
from minio_tpu_torch.utils import eventlog
import tests.test_torch_iam as iam_tests


def rebound(fn):
    """tests/test_torch_iam.rebound, leaving as they are the globals of
    the reference module that name planes the port has not got (its
    NaughtyDisk drive wrapper, used only by the stalled-drive case)."""
    def tolerant(v, real=iam_tests.port_of):
        try:
            return real(v)
        except ImportError:
            return v
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(iam_tests, "port_of", tolerant)
        return iam_tests.rebound(fn)


@pytest.mark.parametrize("name", [
    "test_breach_and_clear_hysteresis", "test_breach_requires_min_samples",
    "test_half_filled_window_never_alerts",
    "test_latency_objective_uses_bucket_counts"])
def test_reference_slo_cases(monkeypatch, name):
    rebound(getattr(ref_cases, name))(monkeypatch)


def test_reference_api_class_case():
    rebound(ref_cases.test_api_class_membership)()


@pytest.mark.parametrize("name", [
    "test_capture_bundle_shape_and_providers",
    "test_trigger_loop_captures_and_debounces"])
def test_reference_recorder_cases(tmp_path, name):
    rebound(getattr(ref_cases, name))(tmp_path)


def test_capture_retention_prunes_oldest(tmp_path, monkeypatch):
    """tests/test_incidents.py's retention case, triggered by a class that
    is not a capture trigger: with a trigger class the recorder's own
    loop captures the same record concurrently and the two captures race
    for the bundle counter."""
    monkeypatch.setenv("MINIO_TPU_INCIDENT_KEEP", "2")
    rec = port_inc.IncidentRecorder()
    rec.attach(str(tmp_path / "incidents"))
    try:
        trig = eventlog.emit("net.heal", peers="p|q")
        ids = [rec.capture(trig) for _ in range(4)]
        assert all(ids)
        kept = {x["id"] for x in rec.list()}
        assert kept == set(ids[-2:])
    finally:
        rec.stop()


# -- twin engines and recorders ----------------------------------------------

FEED = [((0, 0, 0), (0, 0, 0)), ((100, 50, 0), (40, 0, 12)),
        ((100, 50, 0), (40, 0, 12)), ((300, 51, 90), (400, 1, 12)),
        ((900, 51, 90), (400, 1, 300))]


@pytest.mark.parametrize("windows", ["60", "60,300", "30,120,600"])
def test_twin_slo_engines_equal(monkeypatch, windows):
    monkeypatch.setenv("MINIO_TPU_SLO_WINDOWS_S", windows)
    monkeypatch.setenv("MINIO_TPU_SLO_MIN_SAMPLES", "10")
    docs = []
    for sl, tel in ((ref_slo, ref_tel), (port_slo, port_tel)):
        feed = {"cls": {}}
        e = sl.SLOEngine()
        monkeypatch.setattr(e, "_collect", lambda now, sl=sl, feed=feed:
                            sl._Totals(now, {c: list(v) for c, v in
                                             feed["cls"].items()}))
        out = []
        for i, (r, w) in enumerate(FEED):
            feed["cls"] = {"read": list(r), "write": list(w)}
            out.append(e.evaluate_once(now=1e9 + 61 * i))
        burn = tel.REGISTRY.gauge("minio_tpu_slo_burn_rate")
        budget = tel.REGISTRY.gauge("minio_tpu_slo_error_budget_ratio")
        for o in out[-1]["objectives"]:
            out.append((budget.value(objective=o["objective"]),
                        [burn.value(objective=o["objective"], window=w)
                         for w in o["windows"]]))
        docs.append(out)
    assert docs[0] == docs[1]
    assert any(o["breached"] for d in docs[1][:len(FEED)]
               for o in d["objectives"])


def test_twin_bundles_and_cross_reading(tmp_path, monkeypatch):
    fake = types.SimpleNamespace(time=lambda: 1.95e9,
                                 monotonic=time.monotonic)
    ids, docs = [], []
    import minio_tpu.utils.eventlog as ref_ev
    for inc, ev in ((ref_inc, ref_ev), (port_inc, eventlog)):
        monkeypatch.setattr(inc, "time", fake)
        rec = inc.IncidentRecorder()
        rec.attach(str(tmp_path / inc.__name__.split(".")[0]))
        rec.add_provider("static", lambda: {"pools": 1})
        try:
            # not a trigger class: the recorder's own loop stays out
            trig = ev.emit("fsck.complete", findings=3, repaired=2,
                           unrepaired=1)
            ids.append(rec.capture(trig))
            docs.append(rec.get(ids[-1]))
        finally:
            rec.stop()
    assert ids[0] == ids[1] == "inc-1950000000-001-fsck-complete"
    shape = [(sorted(d), d["v"], d["id"], d["trigger"]["class"],
              d["trigger"]["attrs"], d["state"], d["time"]) for d in docs]
    assert shape[0] == shape[1]
    # each package reads the other's bundle directory alike
    lists = []
    for inc, other in ((port_inc, "minio_tpu"), (ref_inc, "minio_tpu_torch"),
                       (port_inc, "minio_tpu_torch")):
        rec = inc.IncidentRecorder()
        rec.attach(str(tmp_path / other))
        try:
            got = rec.list()
            lists.append(([{k: v for k, v in i.items() if k != "node"}
                           for i in got], sorted(rec.get(got[0]["id"]))))
        finally:
            rec.stop()
    assert lists[0][1] == lists[1][1] == lists[2][1]
    assert [i["id"] for i in lists[0][0]] == [ids[0]]


def test_twin_console_rings():
    out = []
    for con, logger in ((ref_console, "minio_tpu"),
                        (port_console, "minio_tpu_torch")):
        ring = con.ConsoleLogSys(capacity=3, node="n9")
        ring.install(logger)
        try:
            logging.getLogger(logger + ".sub").warning("disk %s slow", 7)
            ring.log_line("INFO", "direct")
            for i in range(3):
                ring.log_line("ERROR", f"e{i}")
        finally:
            logging.getLogger(logger).removeHandler(ring)
        out.append([{k: v for k, v in e.items() if k not in ("time", "ts")}
                    for e in ring.recent()] +
                   [len(ring.recent(2))])
    assert out[0] == out[1]
    assert [e["message"] for e in out[1][:3]] == ["e0", "e1", "e2"]


def test_console_bridges_the_port_logger():
    ring = port_console.get_console()
    logging.getLogger("minio_tpu_torch.cluster").info("bridged line")
    assert ring.recent(1)[0]["message"] == "bridged line"


# -- a booted port node ---------------------------------------------------------

def _plane_threads() -> set:
    """The port's plane threads that are alive (told apart by identity:
    the reference's journal, engine and recorder name theirs alike)."""
    threads = {"eventlog-flush": eventlog.JOURNAL._flusher,
               "slo-eval": port_slo.ENGINE._thread,
               "incident-capture": port_inc.RECORDER._worker}
    return {name for name, t in threads.items()
            if t is not None and t.is_alive()}


def test_booted_node_plane_and_reboot_replay(tmp_path, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SLO_EVAL_S", "0.2")
    monkeypatch.setenv("MINIO_TPU_SLO_WINDOWS_S", "1,2")
    monkeypatch.setenv("MINIO_TPU_SLO_MIN_SAMPLES", "1")
    monkeypatch.setenv("MINIO_TPU_INCIDENT_DEBOUNCE_S", "0")
    drives = [str(tmp_path / f"d{i}") for i in range(16)]
    node = cluster.start_single(drives, device="cpu", block_size=1 << 16,
                                parity=4)
    try:
        assert _plane_threads() == {"eventlog-flush", "slo-eval",
                                    "incident-capture"}
        # the ring also holds what the process emitted before the journal
        # had a drive; only the records since the attach are persisted
        seq0 = eventlog.JOURNAL.seq
        port = node.s3.port
        mc = madmin.AdminClient("127.0.0.1", port, node.creds.access_key,
                                node.creds.secret_key)
        assert any(e["message"] == f"node {node.spec.addr} online"
                   for e in mc.console_log())
        with port_tel.trace("probe-root"):
            with port_tel.span("probe-child"):
                pass
        eventlog.emit("drive.probation", drive="/d/3", set=0)
        deadline = time.monotonic() + 15
        bundles: list = []
        while not bundles and time.monotonic() < deadline:
            bundles = [i for i in mc.incidents()
                       if i["trigger"] == "drive.probation"]
            time.sleep(0.1)
        assert bundles and bundles[0]["events"] > 0
        doc = mc.incident(bundles[0]["id"])
        assert sorted(doc["state"]) == ["healthtrack", "membership", "slo",
                                        "topology"]
        assert os.path.isfile(os.path.join(
            drives[0], ".minio.sys", "incidents", bundles[0]["id"] + ".json"))
        time.sleep(2.5)
        slo_doc = mc.slo()
        assert slo_doc["enabled"] and slo_doc["windows_s"] == [1.0, 2.0]
        before = [(e["class"], e["seq"]) for e in mc.events()
                  if e["seq"] > seq0]
        assert any(c == "drive.probation" for c, _ in before)
        assert any(c == "incident.captured" for c, _ in before)
    finally:
        node.shutdown()
    assert _plane_threads() == set()
    assert os.listdir(os.path.join(drives[0], ".minio.sys", "eventlog"))
    node = cluster.start_single(drives, device="cpu", block_size=1 << 16,
                                parity=4)
    try:
        mc = madmin.AdminClient("127.0.0.1", node.s3.port,
                                node.creds.access_key, node.creds.secret_key)
        after = [(e["class"], e["seq"]) for e in mc.events()]
        assert set(before) <= set(after), (before, after)
    finally:
        node.shutdown()
    assert _plane_threads() == set()
