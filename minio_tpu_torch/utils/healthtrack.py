"""Drive and peer latency tracking.

Counterpart of minio_tpu/utils/healthtrack.py, trimmed to two users. The
quorum-ack write lane of multipart uploads: ``write_stall_s``, the
seconds a shard-write fan-out waits for stragglers once write quorum is
durable, derived from the drives' shard-write latencies (``observe_disk``,
fed by the engine's shard writes, into ``TRACKER``), and ``note_laggard``,
which counts the drive ops the lane abandoned. The reference's tuning
knobs are constants here, at its defaults: the lane is always on, and the
grace is the drives' healthy write p95 times 4, within [0.5 s, 10 s]. And
the peer half the internode transport feeds (distributed/transport.py):
``observe_peer`` per successful verb (``minio_tpu_peer_latency_seconds``)
and ``clear_samples``, which drops a restarted peer's windows.

The exposition-time collector sets ``minio_tpu_drive_health`` for every
tracked drive, at 0 (ok): left out are hedged reads, the
suspect/probation quarantine state machine, and the knobs
``MINIO_TPU_LAT_WINDOW``, ``MINIO_TPU_QUORUM_ACK`` and
``MINIO_TPU_WRITE_STALL_*``.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import telemetry

LAT_WINDOW = 64            # latency samples kept per (drive, verb)
WRITE_STALL_K = 4.0        # straggler grace = healthy write p95 x this
WRITE_STALL_FLOOR_S = 0.5
WRITE_STALL_CEIL_S = 10.0  # also the cold-start grace

# sub-ms to tens-of-seconds: tmpfs drives (~50 us) to a gray-failing
# peer (~seconds)
_LAT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
_PEER_LAT = telemetry.REGISTRY.histogram(
    "minio_tpu_peer_latency_seconds",
    "Per-peer internode RPC latency (feeds the gray-failure health "
    "snapshot)", buckets=_LAT_BUCKETS)
_HEALTH = telemetry.REGISTRY.gauge(
    "minio_tpu_drive_health",
    "Drive health state from the latency tracker "
    "(0 = ok, 1 = suspect, 2 = probation)")
_LAGGARDS = telemetry.REGISTRY.counter(
    "minio_tpu_write_laggards_total",
    "Drive write ops abandoned to the background lane after write quorum "
    "was durable")


class _Window:
    """Fixed-size sample ring."""

    __slots__ = ("cap", "buf", "idx")

    def __init__(self, cap: int):
        self.cap = cap
        self.buf: list[float] = []
        self.idx = 0

    def add(self, v: float) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(v)
        else:
            self.buf[self.idx] = v
            self.idx = (self.idx + 1) % self.cap


def _pct(vals: list[float], q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(q * len(s))))]


class HealthTracker:
    """Latency windows keyed by (kind, key, verb)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._windows: dict[tuple[str, str, str], _Window] = {}
        telemetry.REGISTRY.register_collector(self._collect)

    def _collect(self) -> None:
        """Every tracked drive's state gauge; with no quarantine ported,
        each drive is in state ok (0)."""
        with self._mu:
            drives = {key for (kind, key, _v) in self._windows
                      if kind == "drive"}
        for key in drives:
            _HEALTH.set(0, disk=key)

    def observe(self, kind: str, key: str, verb: str,
                seconds: float) -> None:
        with self._mu:
            w = self._windows.get((kind, key, verb))
            if w is None:
                w = self._windows[(kind, key, verb)] = _Window(LAT_WINDOW)
            w.add(seconds)
        if kind == "peer":
            _PEER_LAT.observe(seconds, peer=key, verb=verb)

    def clear_samples(self, kind: str, key: str) -> None:
        """Drop an entity's latency windows: evidence gathered against a
        peer's previous incarnation must not judge the new one."""
        with self._mu:
            for wkey in [w for w in self._windows
                         if w[0] == kind and w[1] == key]:
                del self._windows[wkey]

    def healthy_percentile(self, kind: str, q: float,
                           verbs=None) -> Optional[float]:
        """Pooled percentile over every `kind` entity's windows of
        `verbs` (all verbs when None). The quarantine that would keep
        suspect drives out of this pool is not ported, so every drive
        counts as healthy."""
        with self._mu:
            vals = [v for (k, _key, verb), w in self._windows.items()
                    if k == kind and (verbs is None or verb in verbs)
                    for v in w.buf]
        return _pct(vals, q)

    def snapshot(self, kind: Optional[str] = None) -> list:
        """Per-entity latency summary (the incident recorder's
        ``healthtrack`` provider), in the reference's shape less the
        quarantine's state age and EWMA: every entity is in state ok."""
        ents: dict[tuple[str, str], dict] = {}
        with self._mu:
            for (k, key, verb), w in self._windows.items():
                if kind is not None and k != kind:
                    continue
                vals = list(w.buf)
                ents.setdefault((k, key), {})[verb] = {
                    "n": len(vals),
                    "p50_ms": round((_pct(vals, 0.5) or 0) * 1e3, 3),
                    "p95_ms": round((_pct(vals, 0.95) or 0) * 1e3, 3)}
        return [{"kind": k, "key": key, "state": "ok", "verbs": verbs}
                for (k, key), verbs in sorted(ents.items())]


TRACKER = HealthTracker()


def disk_key(disk) -> str:
    """Stable identity of a drive across its wrapper chain (DiskIDCheck
    delegates ``endpoint()`` to the drive it wraps)."""
    try:
        return disk.endpoint()
    except Exception:  # noqa: BLE001 — identity probe only
        return str(disk)


def observe_disk(disk, verb: str, seconds: float) -> None:
    TRACKER.observe("drive", disk_key(disk), verb, seconds)


def observe_peer(key: str, verb: str, seconds: float) -> None:
    TRACKER.observe("peer", key, verb, seconds)


def _clamped_deadline(p: Optional[float], k_mult: float, floor: float,
                      ceil: float) -> float:
    if p is None:
        return ceil            # cold start: never abandon early
    return min(max(p * k_mult, floor), ceil)


def write_stall_s() -> float:
    """Seconds a shard-write fan-out waits for stragglers once quorum
    is durable."""
    p = TRACKER.healthy_percentile("drive", 0.95, verbs=("write",))
    return _clamped_deadline(p, WRITE_STALL_K, WRITE_STALL_FLOOR_S,
                             WRITE_STALL_CEIL_S)


def note_laggard(stage: str) -> None:
    _LAGGARDS.inc(stage=stage)
