"""The port's event journal (minio_tpu_torch/utils/eventlog.py) held
against minio_tpu's.

  * tests/test_eventlog.py's cases rebound to the port: the emit matrix
    over every class, registry validation, sev ranks, emit_once, the ring
    and its filters, the kill switch, persistence across instances, a torn
    segment serving the surviving prefix, retention, and the follow
    stream's backlog, count cut, (node, seq) dedup and filters;
  * the registry is the reference's: every class with its subsystem,
    severity and attr keys, the severities and the unbounded vocabulary;
  * twin journals fed one emit sequence with the clock pinned write the
    same segment files, byte for byte, and each package replays the
    other's segments to the same ring;
  * a crash inside the persist's commit window (the
    ``eventlog.persist.segment`` crashpoint) leaves the earlier segments,
    which both packages replay alike;
  * ``detach`` (the port's last-node shutdown) forgets the ring, and the
    next attach replays it from the segments.
"""

from __future__ import annotations

import os
import types

import pytest

import minio_tpu.utils.crashpoint as ref_crash
import minio_tpu.utils.eventlog as ref_ev
import minio_tpu_torch.utils.crashpoint as port_crash
import minio_tpu_torch.utils.eventlog as port_ev
import tests.test_eventlog as ref_cases
from tests.test_torch_iam import rebound

PACKAGES = (ref_ev, port_ev)


@pytest.mark.parametrize("name", [
    "test_matrix_covers_registry", "test_every_matrix_class_emits",
    "test_define_rejects_bad_registrations",
    "test_emit_unregistered_raises", "test_sev_rank_orders_severities",
    "test_emit_once_dedupes_for_process_lifetime",
    "test_recent_filters_and_since_seq", "test_stream_backlog_then_idle_end",
    "test_stream_max_entries_cuts_live_feed",
    "test_stream_dedupes_peer_echo_by_node_seq",
    "test_stream_filters_apply_to_peer_entries"])
def test_reference_cases(name):
    rebound(getattr(ref_cases, name))()


def test_reference_kill_switch_case(monkeypatch):
    rebound(ref_cases.test_emit_respects_kill_switch)(monkeypatch)


@pytest.mark.parametrize("name", [
    "test_persistence_roundtrip", "test_torn_segment_serves_surviving_prefix",
    "test_segment_retention_prunes_oldest"])
def test_reference_persistence_cases(tmp_path, name):
    rebound(getattr(ref_cases, name))(tmp_path)


def test_registry_is_the_references():
    assert port_ev.SEVERITIES == ref_ev.SEVERITIES
    assert port_ev.UNBOUNDED_ATTR_KEYS == ref_ev.UNBOUNDED_ATTR_KEYS
    assert list(port_ev.EVENTS) == list(ref_ev.EVENTS)
    for name, ec in ref_ev.EVENTS.items():
        pc = port_ev.EVENTS[name]
        assert (pc.subsystem, pc.severity, pc.attrs, pc.doc) == \
            (ec.subsystem, ec.severity, ec.attrs, ec.doc), name


def _pin_clock(monkeypatch, t0: float = 1.8e9):
    """Both modules' clocks at one fixed instant (the journal stamps
    ``ts`` with time.time())."""
    import time as real
    fake = types.SimpleNamespace(time=lambda: t0, monotonic=real.monotonic,
                                 sleep=real.sleep)
    for ev in PACKAGES:
        monkeypatch.setattr(ev, "time", fake)


def _feed(j) -> None:
    for name, attrs in sorted(ref_cases.EVENT_MATRIX.items()):
        j.emit(name, **attrs)
        if name.startswith("mrf"):
            j.flush()


def _files(d: str) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_twin_segments_equal_and_cross_replay(tmp_path, monkeypatch):
    _pin_clock(monkeypatch)
    dirs = []
    for ev in PACKAGES:
        d = str(tmp_path / ev.__name__.split(".")[0])
        j = ev.EventJournal()
        j.attach(d, node="n1", segment_events=1000, flush_s=60.0)
        _feed(j)
        j.close()
        dirs.append(d)
    want, got = _files(dirs[0]), _files(dirs[1])
    assert list(want) == list(got) and len(got) >= 3
    assert want == got
    # each package replays the other's segments to the same ring
    rings = []
    for ev, d in ((port_ev, dirs[0]), (ref_ev, dirs[1]),
                  (port_ev, dirs[1])):
        j = ev.EventJournal()
        j.attach(d, node="n2", flush_s=60.0)
        rings.append((j.recent(), j.seq))
        j.close()
    assert rings[0] == rings[1] == rings[2]
    assert rings[0][1] == len(ref_cases.EVENT_MATRIX)


def test_crash_in_commit_window_keeps_prefix(tmp_path, monkeypatch):
    """A crash armed at eventlog.persist.segment (before the segment's
    rename) loses only that segment: both packages' restarts replay the
    earlier ones alike."""
    _pin_clock(monkeypatch)
    rings = []
    for ev, cp in ((ref_ev, ref_crash), (port_ev, port_crash)):
        d = str(tmp_path / ev.__name__.split(".")[0])
        j = ev.EventJournal()
        j.attach(d, node="n1", segment_events=1000, flush_s=60.0)
        j.emit("mrf.enqueue", queued=1)
        j.flush()
        j.emit("mrf.enqueue", queued=2)
        cp.arm("eventlog.persist.segment")
        try:
            with pytest.raises(cp.CrashpointAbort):
                j.flush()
        finally:
            cp.disarm()
        j._stop.set()
        j._kick.set()
        j2 = ev.EventJournal()
        j2.attach(d, node="n1", flush_s=60.0)
        rings.append([(e["class"], e["attrs"], e["seq"])
                      for e in j2.recent()])
        j2.close()
    assert rings[0] == rings[1] == [("mrf.enqueue", {"queued": 1}, 1)]


def test_detach_then_attach_replays(tmp_path):
    j = port_ev.EventJournal()
    d = str(tmp_path / "eventlog")
    j.attach(d, node="n1", flush_s=60.0)
    for i in range(5):
        j.emit("mrf.enqueue", queued=i)
    j.detach()
    assert j.recent() == [] and j.node == "" and j._dir is None
    j.attach(d, node="n2", flush_s=60.0)
    got = j.recent()
    assert [e["attrs"]["queued"] for e in got] == list(range(5))
    assert {e["node"] for e in got} == {"n1"} and j.node == "n2"
    assert j.emit("mrf.drain", healed=1, failed=0)["seq"] == 6
    j.detach()
