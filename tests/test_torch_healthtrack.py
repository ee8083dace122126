"""The port's latency tracker (minio_tpu_torch/utils/healthtrack.py) held
against minio_tpu's: the same seeded observation and transition sequences
fed to both packages' process-wide trackers, under a pinned monotonic
clock, give the same answers at every step — states and state ages,
quarantine thresholds and verdicts, pooled and per-entity percentiles,
hedge deadlines and write-stall graces (None when their knob is off),
probe counts, snapshots (every key and value), the ``minio_tpu_drive_*``
and ``minio_tpu_hedged_reads_total`` series, and the ``health.transition``
journal records (times and sequence numbers masked). Exact equality
(tolerance 0): both trackers run the same float arithmetic.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import minio_tpu.utils.eventlog as ref_eventlog
import minio_tpu.utils.healthtrack as ref_ht
import minio_tpu.utils.telemetry as ref_tel
import minio_tpu_torch.utils.eventlog as port_eventlog
import minio_tpu_torch.utils.healthtrack as port_ht
import minio_tpu_torch.utils.telemetry as port_tel

PACKAGES = ((ref_ht, ref_eventlog, ref_tel), (port_ht, port_eventlog,
                                              port_tel))
VERBS = ("read", "write", "probe")


class _Clock:
    """A monotonic clock the test advances."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


class _Disk:
    """A drive as the tracker sees one: its endpoint is its key."""

    def __init__(self, key: str):
        self.key = key

    def endpoint(self) -> str:
        return self.key


@pytest.fixture
def clocks(monkeypatch):
    out = []
    for ht, _ev, _tel in PACKAGES:
        c = _Clock()
        monkeypatch.setattr(ht, "time", types.SimpleNamespace(
            monotonic=c.monotonic, perf_counter=c.monotonic))
        ht.TRACKER.reset()
        out.append(c)
    yield out
    for ht, _ev, _tel in PACKAGES:
        ht.TRACKER.reset()


def _series(tel, name: str, prefix: str) -> dict:
    """The family's series whose disk label starts with `prefix`."""
    fam = tel.REGISTRY._families[name]
    out = {}
    for key, v in dict(fam._series).items():
        labels = dict(key)
        if labels.get("disk", "").startswith(prefix):
            out[key] = v if not hasattr(v, "counts") else \
                (list(v.counts), round(v.total, 9), v.count)
    return out


def _run(pkg, clock, seed: int, prefix: str) -> list:
    """One seeded program of observations, transitions and queries
    against one package's tracker; returns every answer."""
    ht, ev, tel = pkg
    tr = ht.TRACKER
    rng = np.random.default_rng(seed)
    keys = [f"{prefix}/d{i}" for i in range(6)]
    seq0 = max([e["seq"] for e in ev.JOURNAL.recent()] or [0])
    hedged0 = {t: ht._HEDGED.value(trigger=t) for t in ("latency", "error")}
    events = ("suspect", "probation", "readmit", "reconvict", "ok")
    quar0 = {e: ht._QUAR.value(event=e) for e in events}
    out: list = []
    for step in range(400):
        op = rng.integers(0, 100)
        key = keys[rng.integers(0, len(keys))]
        if op < 60:
            verb = VERBS[rng.integers(0, len(VERBS))]
            # drive 0 runs slow: its samples sit far above the others'
            slow = key.endswith("/d0") and rng.random() < 0.7
            sec = float(rng.uniform(0.3, 0.9) if slow
                        else rng.uniform(0.0002, 0.004))
            ht.observe_disk(_Disk(key), verb, sec)
        elif op < 65:
            ht.observe_peer(f"{prefix}-peer{rng.integers(0, 2)}", "call",
                            float(rng.uniform(0.001, 0.02)))
        elif op < 72:
            state = (ht.STATE_OK, ht.STATE_SUSPECT,
                     ht.STATE_PROBATION)[rng.integers(0, 3)]
            tr.set_state("drive", key, state,
                         event=state if rng.random() < 0.8 else "")
        elif op < 78:
            out.append(("probe", key,
                        tr.note_probe("drive", key, bool(rng.random() < .6)),
                        tr.state_of("drive", key)))
        elif op < 80:
            tr.clear_samples("drive", key)
        elif op < 82:
            ht.note_hedge(("latency", "error")[rng.integers(0, 2)])
        else:
            clock.t += float(rng.uniform(0, 5))
            q = float(rng.choice([0.5, 0.95, 0.99]))
            out.append((
                step, key, tr.state_of("drive", key),
                round(tr.state_age("drive", key), 9),
                tr.quarantine_threshold("drive", key),
                tr.should_quarantine("drive", key),
                tr.percentile("drive", key, q),
                tr.percentile("drive", key, q, verbs=("read",)),
                tr.healthy_percentile("drive", q),
                tr.healthy_percentile("drive", q, verbs=("write",),
                                      exclude=key),
                ht.is_suspect_disk(_Disk(key)),
                ht.read_hedge_s(), ht.write_stall_s(),
                ht.hedging_enabled(), ht.quorum_ack_enabled(),
                ht.quarantine_enabled()))
    snap = [e for e in tr.snapshot() if e["key"].startswith(prefix)]
    out.append(("snapshot", snap))
    out.append(("drives", [e["key"] for e in tr.snapshot("drive")
                           if e["key"].startswith(prefix)]))
    tel.REGISTRY.render()          # runs the collector: drive_health
    for fam in ("minio_tpu_drive_health", "minio_tpu_drive_latency_seconds"):
        out.append((fam, _series(tel, fam, prefix)))
    out.append(("quarantine", {e: ht._QUAR.value(event=e) - quar0[e]
                               for e in events}))
    out.append(("hedged", {t: ht._HEDGED.value(trigger=t) - hedged0[t]
                           for t in hedged0}))
    out.append(("journal", [
        (e["class"], e["sev"], e["sub"], e["attrs"])
        for e in ev.JOURNAL.recent(0, classes={"health.transition"},
                                   since_seq=seq0)
        if str(e["attrs"].get("target", "")).startswith(prefix)]))
    return out


@pytest.mark.parametrize("seed,env", [
    (1, {}),
    (2, {"MINIO_TPU_LAT_WINDOW": "8"}),
    (3, {"MINIO_TPU_HEDGE": "off", "MINIO_TPU_QUAR_MIN_SAMPLES": "3"}),
    (4, {"MINIO_TPU_QUORUM_ACK": "off", "MINIO_TPU_QUARANTINE": "off"}),
    (5, {"MINIO_TPU_HEDGE_K": "5", "MINIO_TPU_HEDGE_FLOOR_S": "0.001",
         "MINIO_TPU_WRITE_STALL_K": "2", "MINIO_TPU_QUAR_RATIO": "2",
         "MINIO_TPU_QUAR_LATENCY_S": "0.01"}),
])
def test_same_program_same_answers(clocks, monkeypatch, seed, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    prefix = f"/ht{seed}"
    ref, port = (_run(pkg, c, seed, prefix)
                 for pkg, c in zip(PACKAGES, clocks))
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a == b
    # the program reached every verdict it can
    queries = [r for r in port if isinstance(r[0], int)]
    assert {q[2] for q in queries} == {"ok", "suspect", "probation"}
    if env.get("MINIO_TPU_HEDGE") == "off":
        assert {q[11] for q in queries} == {None}
    else:
        assert all(isinstance(q[11], float) for q in queries)


def test_cold_deadlines_are_the_ceilings(clocks, monkeypatch):
    """No samples: both deadlines are their ceiling knobs in both
    packages; a slow drive in suspect leaves the healthy pool."""
    monkeypatch.setenv("MINIO_TPU_HEDGE_CEIL_S", "0.125")
    monkeypatch.setenv("MINIO_TPU_WRITE_STALL_CEIL_S", "0.25")
    got = []
    for ht, _ev, _tel in PACKAGES:
        row = [ht.read_hedge_s(), ht.write_stall_s()]
        for i in range(8):
            ht.observe_disk(_Disk("/cold/d1"), "read", 0.001 * (i + 1))
            ht.observe_disk(_Disk("/cold/d0"), "read", 0.6)
        row.append(ht.read_hedge_s())
        ht.TRACKER.set_state("drive", "/cold/d0", ht.STATE_SUSPECT,
                             event="suspect")
        row += [ht.read_hedge_s(), ht.TRACKER.should_quarantine(
            "drive", "/cold/d0"), ht.is_suspect_disk(_Disk("/cold/d0"))]
        got.append(row)
    assert got[0] == got[1]
    assert got[1][:2] == [0.125, 0.25]
    assert got[1][2] == 0.125 and got[1][3] == pytest.approx(0.05)
