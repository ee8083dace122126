"""Latency-aware drive/peer health tracking — the gray-failure plane.

Counterpart of minio_tpu/utils/healthtrack.py, whole. A production store
is dominated not by components that die but by components that are *slow
while still answering*: a drive doing 500 ms I/Os, a peer behind a
saturated NIC ("The Tail at Scale", Dean & Barroso; "Gray Failure", Huang
et al.). The binary online/offline health model (DiskMonitor, transport
probes) cannot see them, so this module keeps per-entity windowed latency
and derives three behaviors from it:

  * **Adaptive hedge deadlines** — the GET shard-read state machine
    races a spare shard read against any reader slower than
    ``healthy p95 × MINIO_TPU_HEDGE_K`` (clamped to floor/ceiling
    knobs) instead of waiting on errors alone (engine
    ``_read_group_shards_raw``).
  * **Quorum-ack write stalls** — PUT/multipart fan-outs ack once
    write-quorum drives are durable and abandon laggards past
    ``healthy p95 × MINIO_TPU_WRITE_STALL_K`` to a background lane
    that feeds the MRF heal queue (``metadata.for_each_disk_quorum``).
  * **Slow-drive quarantine** — DiskMonitor consults
    ``should_quarantine`` and walks drives through the
    ok → suspect → probation → ok state machine; suspect/probation
    drives are excluded from read plans and hedge targets
    (capacity-permitting) while still being written-and-MRF'd.

Every observation lands in ``minio_tpu_drive_latency_seconds{disk,
verb}`` / ``minio_tpu_peer_latency_seconds{peer,verb}`` histograms and
the ``minio_tpu_drive_health{disk}`` gauge mirrors the state machine
(0 = ok, 1 = suspect, 2 = probation); transitions are journalled as
``health.transition`` records.

Deadlines are derived at call time (knobs are read from the environment
at each call) and fall back to the CEILING when no samples exist yet — a
cold process must not hedge or abandon spuriously.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from . import eventlog, knobs, telemetry

__all__ = [
    "STATE_OK", "STATE_SUSPECT", "STATE_PROBATION",
    "HealthTracker", "TRACKER", "disk_key",
    "observe_disk", "observe_peer", "is_suspect_disk",
    "read_hedge_s", "write_stall_s", "hedging_enabled",
    "quorum_ack_enabled", "quarantine_enabled",
    "note_hedge", "note_laggard",
]

STATE_OK = "ok"
STATE_SUSPECT = "suspect"
STATE_PROBATION = "probation"
_STATE_NUM = {STATE_OK: 0, STATE_SUSPECT: 1, STATE_PROBATION: 2}

# sub-ms to tens-of-seconds: drive I/O spans tmpfs (~50 µs) to a
# gray-failing spindle (~seconds)
_LAT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_DRIVE_LAT = telemetry.REGISTRY.histogram(
    "minio_tpu_drive_latency_seconds",
    "Per-drive storage-verb latency (feeds hedge deadlines and "
    "slow-drive quarantine)", buckets=_LAT_BUCKETS)
_PEER_LAT = telemetry.REGISTRY.histogram(
    "minio_tpu_peer_latency_seconds",
    "Per-peer internode RPC latency (feeds the gray-failure health "
    "snapshot)", buckets=_LAT_BUCKETS)
_HEDGED = telemetry.REGISTRY.counter(
    "minio_tpu_hedged_reads_total",
    "Spare shard reads raced against slow/failed readers, by trigger "
    "(latency = hedge deadline expired, error = reader failed)")
_LAGGARDS = telemetry.REGISTRY.counter(
    "minio_tpu_write_laggards_total",
    "Shard-write fan-out stragglers abandoned to the background lane "
    "after quorum ack (each feeds the MRF degraded-write queue)")
_QUAR = telemetry.REGISTRY.counter(
    "minio_tpu_drive_quarantine_total",
    "Slow-drive quarantine state transitions, by event "
    "(suspect/probation/readmit)")
_HEALTH = telemetry.REGISTRY.gauge(
    "minio_tpu_drive_health",
    "Drive health state from the latency tracker "
    "(0 = ok, 1 = suspect, 2 = probation)")

# verbs whose latency drives the quarantine decision (probe latency is
# tracked separately: it must only prove RECOVERY, never re-convict a
# drive out of stale traffic samples)
_DECISION_VERBS = ("read", "write")


def disk_key(disk) -> str:
    """Stable identity of a drive across its wrapper chain
    (DiskIDCheck / NaughtyDisk / RemoteStorage all delegate
    ``endpoint()`` to the innermost drive)."""
    try:
        return disk.endpoint()
    except Exception:  # noqa: BLE001 — identity probe only
        return str(disk)


class _Window:
    """Fixed-size sample ring; percentile over whatever is retained."""

    __slots__ = ("cap", "buf", "idx")

    def __init__(self, cap: int):
        self.cap = max(4, cap)
        self.buf: List[float] = []
        self.idx = 0

    def add(self, v: float) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(v)
        else:
            self.buf[self.idx] = v
            self.idx = (self.idx + 1) % self.cap

    def values(self) -> List[float]:
        return list(self.buf)


def _pct(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    i = min(len(s) - 1, max(0, int(q * len(s))))
    return s[i]


class _Entity:
    __slots__ = ("kind", "key", "windows", "state", "state_since",
                 "probes_ok", "ewma")

    def __init__(self, kind: str, key: str):
        self.kind = kind
        self.key = key
        self.windows: Dict[str, _Window] = {}
        self.state = STATE_OK
        self.state_since = time.monotonic()
        self.probes_ok = 0
        self.ewma: Dict[str, float] = {}


class HealthTracker:
    """Process-global latency + health-state registry, keyed by
    (kind, key) where kind ∈ {"drive", "peer"}."""

    EWMA_ALPHA = 0.2

    def __init__(self):
        self._mu = threading.Lock()
        self._entities: Dict[Tuple[str, str], _Entity] = {}
        telemetry.REGISTRY.register_collector(self._collect)

    # -- feeding -----------------------------------------------------------

    def observe(self, kind: str, key: str, verb: str,
                seconds: float) -> None:
        with self._mu:
            e = self._entities.get((kind, key))
            if e is None:
                e = self._entities[(kind, key)] = _Entity(kind, key)
            w = e.windows.get(verb)
            if w is None:
                w = e.windows[verb] = _Window(
                    knobs.get_int("MINIO_TPU_LAT_WINDOW"))
            w.add(seconds)
            prev = e.ewma.get(verb)
            e.ewma[verb] = seconds if prev is None else \
                prev + self.EWMA_ALPHA * (seconds - prev)
        if kind == "drive":
            _DRIVE_LAT.observe(seconds, disk=key, verb=verb)
        else:
            _PEER_LAT.observe(seconds, peer=key, verb=verb)

    # -- querying ----------------------------------------------------------

    def _samples(self, e: _Entity, verbs) -> List[float]:
        out: List[float] = []
        for v in (verbs or e.windows):
            w = e.windows.get(v)
            if w is not None:
                out.extend(w.buf)
        return out

    def percentile(self, kind: str, key: str, q: float,
                   verbs=None) -> Optional[float]:
        with self._mu:
            e = self._entities.get((kind, key))
            if e is None:
                return None
            return _pct(self._samples(e, verbs), q)

    def healthy_percentile(self, kind: str, q: float, verbs=None,
                           exclude: str = "") -> Optional[float]:
        """Pooled percentile across entities in state OK — the
        "healthy baseline" hedge deadlines and quarantine ratios
        compare against."""
        vals: List[float] = []
        with self._mu:
            for (k_, key), e in self._entities.items():
                if k_ != kind or key == exclude or e.state != STATE_OK:
                    continue
                vals.extend(self._samples(e, verbs))
        return _pct(vals, q)

    def state_of(self, kind: str, key: str) -> str:
        with self._mu:
            e = self._entities.get((kind, key))
            return e.state if e is not None else STATE_OK

    def state_age(self, kind: str, key: str) -> float:
        with self._mu:
            e = self._entities.get((kind, key))
            if e is None:
                return 0.0
            return time.monotonic() - e.state_since

    def set_state(self, kind: str, key: str, state: str,
                  event: str = "") -> None:
        with self._mu:
            e = self._entities.get((kind, key))
            if e is None:
                e = self._entities[(kind, key)] = _Entity(kind, key)
            if e.state == state:
                return
            e.state = state
            e.state_since = time.monotonic()
            e.probes_ok = 0
        if event:
            _QUAR.inc(event=event)
        eventlog.emit("health.transition", kind=kind, target=key,
                      state=state, event=event)

    # -- quarantine policy -------------------------------------------------

    def quarantine_threshold(self, kind: str, key: str) -> float:
        """Latency above which this entity counts slow: the absolute
        knob floor, raised by the relative ratio when a healthy
        baseline exists (a uniformly slow medium must not quarantine
        everything; a uniformly fast one must still catch the one
        drive doing 500 ms I/Os)."""
        thresh = knobs.get_float("MINIO_TPU_QUAR_LATENCY_S")
        healthy = self.healthy_percentile(kind, 0.95,
                                          verbs=_DECISION_VERBS,
                                          exclude=key)
        if healthy is not None:
            thresh = max(thresh,
                         healthy * knobs.get_float("MINIO_TPU_QUAR_RATIO"))
        return thresh

    def should_quarantine(self, kind: str, key: str) -> bool:
        with self._mu:
            e = self._entities.get((kind, key))
            vals = self._samples(e, _DECISION_VERBS) if e else []
        if len(vals) < knobs.get_int("MINIO_TPU_QUAR_MIN_SAMPLES"):
            return False
        p95 = _pct(vals, 0.95)
        return p95 is not None and p95 > self.quarantine_threshold(
            kind, key)

    def clear_samples(self, kind: str, key: str) -> None:
        """Drop an entity's latency windows (heal-verified
        re-admission calls this): conviction evidence gathered BEFORE
        recovery must not re-convict the drive on the next scan — a
        quarantined drive takes no reads, so stale slow samples would
        otherwise sit in the window and flap it forever."""
        with self._mu:
            e = self._entities.get((kind, key))
            if e is not None:
                e.windows.clear()
                e.ewma.clear()

    def note_probe(self, kind: str, key: str, ok: bool) -> int:
        """Record one probation probe verdict; returns consecutive
        passes (a failure resets the count AND the probation dwell —
        the drive re-convicts back to suspect)."""
        reconvicted = False
        with self._mu:
            e = self._entities.get((kind, key))
            if e is None:
                return 0
            if ok:
                e.probes_ok += 1
                return e.probes_ok
            e.probes_ok = 0
            if e.state == STATE_PROBATION:
                reconvicted = True
            e.state = STATE_SUSPECT
            e.state_since = time.monotonic()
        if reconvicted:
            # a flapping drive must be visible as flapping, not as
            # one forever-pending probation
            _QUAR.inc(event="reconvict")
            eventlog.emit("health.transition", kind=kind, target=key,
                          state=STATE_SUSPECT, event="reconvict")
        return 0

    # -- surfaces ----------------------------------------------------------

    def snapshot(self, kind: Optional[str] = None) -> list:
        """Per-entity latency + health summary (OBD / admin)."""
        out = []
        with self._mu:
            ents = [e for (k_, _), e in self._entities.items()
                    if kind is None or k_ == kind]
            for e in ents:
                verbs = {}
                for v, w in e.windows.items():
                    vals = w.buf
                    verbs[v] = {
                        "n": len(vals),
                        "p50_ms": round((_pct(vals, 0.5) or 0) * 1e3, 3),
                        "p95_ms": round((_pct(vals, 0.95) or 0) * 1e3, 3),
                        "ewma_ms": round(e.ewma.get(v, 0.0) * 1e3, 3),
                    }
                out.append({"kind": e.kind, "key": e.key,
                            "state": e.state,
                            "state_age_s": round(
                                time.monotonic() - e.state_since, 3),
                            "verbs": verbs})
        out.sort(key=lambda d: (d["kind"], d["key"]))
        return out

    def _collect(self) -> None:
        with self._mu:
            drives = [(e.key, e.state) for (k_, _), e in
                      self._entities.items() if k_ == "drive"]
        for key, state in drives:
            _HEALTH.set(_STATE_NUM.get(state, 0), disk=key)

    def reset(self) -> None:
        """Drop every entity (tests)."""
        with self._mu:
            self._entities.clear()


TRACKER = HealthTracker()


# ---------------------------------------------------------------------------
# call-site helpers (the engine / transport / DiskMonitor surface)
# ---------------------------------------------------------------------------

def observe_disk(disk, verb: str, seconds: float) -> None:
    TRACKER.observe("drive", disk_key(disk), verb, seconds)


def observe_peer(key: str, verb: str, seconds: float) -> None:
    TRACKER.observe("peer", key, verb, seconds)


def is_suspect_disk(disk) -> bool:
    """True while the drive sits in suspect OR probation — both are
    excluded from read plans and hedge targets until the heal-verified
    re-admission flips the state back to ok."""
    return TRACKER.state_of("drive", disk_key(disk)) != STATE_OK


def hedging_enabled() -> bool:
    return knobs.get_bool("MINIO_TPU_HEDGE")


def quorum_ack_enabled() -> bool:
    return knobs.get_bool("MINIO_TPU_QUORUM_ACK")


def quarantine_enabled() -> bool:
    return knobs.get_bool("MINIO_TPU_QUARANTINE")


def _clamped_deadline(p: Optional[float], k_mult: float, floor: float,
                      ceil: float) -> float:
    if p is None:
        return ceil            # cold start: never hedge/abandon early
    return min(max(p * k_mult, floor), ceil)


def read_hedge_s() -> Optional[float]:
    """Seconds a shard read may run before a spare read races it, or
    None when hedging is off."""
    if not hedging_enabled():
        return None
    p = TRACKER.healthy_percentile("drive", 0.95, verbs=("read",))
    return _clamped_deadline(p, knobs.get_float("MINIO_TPU_HEDGE_K"),
                             knobs.get_float("MINIO_TPU_HEDGE_FLOOR_S"),
                             knobs.get_float("MINIO_TPU_HEDGE_CEIL_S"))


def write_stall_s() -> Optional[float]:
    """Seconds a shard-write fan-out waits for stragglers once quorum
    is durable, or None when quorum-ack is off."""
    if not quorum_ack_enabled():
        return None
    p = TRACKER.healthy_percentile("drive", 0.95, verbs=("write",))
    return _clamped_deadline(
        p, knobs.get_float("MINIO_TPU_WRITE_STALL_K"),
        knobs.get_float("MINIO_TPU_WRITE_STALL_FLOOR_S"),
        knobs.get_float("MINIO_TPU_WRITE_STALL_CEIL_S"))


def note_hedge(trigger: str) -> None:
    _HEDGED.inc(trigger=trigger)


def note_laggard(stage: str) -> None:
    _LAGGARDS.inc(stage=stage)
