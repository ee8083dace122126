"""slo — per-API-class objectives and multi-window burn rates.

A copy of minio_tpu/utils/slo.py; nothing is left out. Objectives
(availability, latency) per API class derive from telemetry the request
path already pays for: ``minio_tpu_http_responses_total{api,
code_class}`` (5xx spends the availability budget) and the bucket counts
of ``minio_tpu_http_requests_duration_seconds`` (requests over the
class threshold spend the latency budget). The engine snapshots
cumulative totals on a cadence, diffs snapshots per window, and exports
``minio_tpu_slo_burn_rate{objective,window}`` and
``minio_tpu_slo_error_budget_ratio{objective}``. A burn rate crossing
MINIO_TPU_SLO_BURN_THRESHOLD with enough samples emits ``slo.breach``
and clears at half the threshold.

Knobs: MINIO_TPU_SLO, MINIO_TPU_SLO_EVAL_S, MINIO_TPU_SLO_WINDOWS_S,
MINIO_TPU_SLO_AVAIL_TARGET, MINIO_TPU_SLO_LAT_TARGET,
MINIO_TPU_SLO_LAT_READ_MS, MINIO_TPU_SLO_LAT_WRITE_MS,
MINIO_TPU_SLO_BURN_THRESHOLD, MINIO_TPU_SLO_MIN_SAMPLES.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import eventlog, knobs, telemetry

# API-class membership: the S3 data-plane calls only. Internal and
# admin surfaces (including this plane's own streaming endpoints) are
# excluded — an idling `mc admin trace` must not spend read budget.
_EXCLUDED_APIS = frozenset({
    "Admin", "Health", "Metrics", "WebUI", "PeerRPC", "StorageRPC",
    "STS",
})

_BURN = telemetry.REGISTRY.gauge(
    "minio_tpu_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 = spending "
    "exactly the budget; above the threshold knob = breach)")
_BUDGET = telemetry.REGISTRY.gauge(
    "minio_tpu_slo_error_budget_ratio",
    "Error budget remaining per objective over the longest window "
    "(1 = untouched, 0 = fully burned)")


def api_class(api: str) -> Optional[str]:
    """'read' / 'write' / None (excluded from objectives)."""
    if not api or api in _EXCLUDED_APIS:
        return None
    if api.startswith(("Get", "Head", "List")):
        return "read"
    return "write"


def _windows() -> List[float]:
    out = []
    for part in knobs.get_str("MINIO_TPU_SLO_WINDOWS_S").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            continue
        if w > 0:
            out.append(w)
    return sorted(out) or [60.0, 300.0]


class _Totals:
    """Cumulative (requests, errors, slow) per class at one instant."""

    __slots__ = ("ts", "cls")

    def __init__(self, ts: float, cls: Dict[str, List[int]]):
        self.ts = ts
        self.cls = cls


class SLOEngine:
    """Snapshot → diff → burn-rate evaluator. One per process (the
    metrics registry it reads is process-global); ``ensure_started``
    is idempotent so multi-node-in-process tests boot it once."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._responses = telemetry.REGISTRY.counter(
            "minio_tpu_http_responses_total")
        self._duration = telemetry.REGISTRY.histogram(
            "minio_tpu_http_requests_duration_seconds")
        self._snaps: "deque[_Totals]" = deque(maxlen=256)
        self._breached: Dict[str, dict] = {}    # objective -> info
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_status: dict = {}

    # -- lifecycle ---------------------------------------------------------

    def ensure_started(self) -> None:
        with self._mu:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="slo-eval")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(
                timeout=knobs.get_float("MINIO_TPU_SLO_EVAL_S")):
            if not knobs.get_bool("MINIO_TPU_SLO"):
                continue
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — evaluation is passive
                pass

    # -- collection --------------------------------------------------------

    def _collect(self, now: float) -> _Totals:
        cls: Dict[str, List[int]] = {"read": [0, 0, 0],
                                     "write": [0, 0, 0]}
        for key, v in self._responses.series().items():
            labels = dict(key)
            c = api_class(labels.get("api", ""))
            if c is None:
                continue
            cls[c][0] += int(v)
            if labels.get("code_class") == "5xx":
                cls[c][1] += int(v)
        thresholds = {
            "read": knobs.get_float("MINIO_TPU_SLO_LAT_READ_MS") / 1e3,
            "write": knobs.get_float("MINIO_TPU_SLO_LAT_WRITE_MS") / 1e3,
        }
        buckets = self._duration.buckets
        for key, (counts, _total, _count) in \
                self._duration.series_snapshot().items():
            labels = dict(key)
            c = api_class(labels.get("api", ""))
            if c is None:
                continue
            # bucket i holds observations in (buckets[i-1], buckets[i]]
            # — everything from the first boundary PAST the threshold
            # is over it (thresholds default to exact boundaries)
            idx = bisect.bisect_right(buckets, thresholds[c])
            cls[c][2] += sum(counts[idx:])
        return _Totals(now, cls)

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _objectives() -> List[dict]:
        avail_budget = max(
            1e-9, 1 - knobs.get_float("MINIO_TPU_SLO_AVAIL_TARGET")
            / 100.0)
        lat_budget = max(
            1e-9, 1 - knobs.get_float("MINIO_TPU_SLO_LAT_TARGET")
            / 100.0)
        out = []
        for c in ("read", "write"):
            out.append({"name": f"{c}-availability", "cls": c,
                        "kind": "availability", "budget": avail_budget})
            out.append({"name": f"{c}-latency", "cls": c,
                        "kind": "latency", "budget": lat_budget})
        return out

    def _baseline(self, now: float, window: float) -> Optional[_Totals]:
        """Newest snapshot at least `window` old — None until the ring
        spans the window (a half-filled window must not alert)."""
        base = None
        for snap in self._snaps:
            if now - snap.ts >= window:
                base = snap
            else:
                break
        return base

    def evaluate_once(self, now: Optional[float] = None) -> dict:
        """One snapshot + burn-rate pass; returns (and retains) the
        /slo status document. Split out of the loop so tests drive
        evaluation synchronously."""
        now = time.time() if now is None else now
        cur = self._collect(now)
        with self._mu:
            self._snaps.append(cur)
        windows = _windows()
        threshold = knobs.get_float("MINIO_TPU_SLO_BURN_THRESHOLD")
        min_samples = knobs.get_int("MINIO_TPU_SLO_MIN_SAMPLES")
        objectives = []
        for obj in self._objectives():
            name, c, kind = obj["name"], obj["cls"], obj["kind"]
            budget = obj["budget"]
            bad_idx = 1 if kind == "availability" else 2
            win_stats: Dict[str, dict] = {}
            worst = (0.0, "")              # (burn, window label)
            breach_now = False
            for w in windows:
                base = self._baseline(now, w)
                if base is None:
                    continue
                reqs = cur.cls[c][0] - base.cls[c][0]
                bad = cur.cls[c][bad_idx] - base.cls[c][bad_idx]
                burn = (bad / reqs) / budget if reqs > 0 else 0.0
                label = f"{int(w)}s"
                win_stats[label] = {"burn": round(burn, 3),
                                    "samples": reqs}
                _BURN.set(round(burn, 6), objective=name,
                          window=label)
                if burn > worst[0]:
                    worst = (burn, label)
                if reqs >= min_samples and burn >= threshold:
                    breach_now = True
            remaining = max(0.0, 1.0 - min(1.0, worst[0]))
            _BUDGET.set(round(remaining, 6), objective=name)
            was = name in self._breached
            if breach_now and not was:
                self._breached[name] = {"window": worst[1],
                                        "burn": round(worst[0], 3),
                                        "since": now}
                eventlog.emit("slo.breach", objective=name,
                              window=worst[1],
                              burn=round(worst[0], 3))
            elif was and win_stats and worst[0] < threshold / 2.0:
                # hysteresis: clear only once every window cooled to
                # half the trip point
                del self._breached[name]
                eventlog.emit("slo.clear", objective=name)
            objectives.append({
                "objective": name, "class": c, "kind": kind,
                "budget": round(budget, 6),
                "windows": win_stats,
                "breached": name in self._breached,
                "breach": self._breached.get(name),
                "budget_remaining": round(remaining, 3),
            })
        status = {
            "enabled": knobs.get_bool("MINIO_TPU_SLO"),
            "burn_threshold": threshold,
            "windows_s": windows,
            "objectives": objectives,
        }
        with self._mu:
            self._last_status = status
        return status

    def status(self) -> dict:
        """The last evaluated document (admin /slo + incident
        bundles); evaluates once if the engine never ran."""
        with self._mu:
            last = self._last_status
        if last:
            return last
        return self.evaluate_once()

    def reset(self) -> None:
        """Forget snapshots and breach state (test isolation)."""
        with self._mu:
            self._snaps.clear()
            self._breached.clear()
            self._last_status = {}


ENGINE = SLOEngine()
