"""incidents — black-box capture bundles (the flight recorder).

A copy of minio_tpu/utils/incidents.py, plus ``detach`` (the last node of
a process to shut down detaches the recorder); nothing is left out. When a
trigger event lands in the journal (SLO breach, drive probation, network
partition, unrepaired fsck findings, registry fork; knob-configurable),
the recorder snapshots into one JSON bundle under drive 0's
``.minio.sys/incidents/``: the recent journal window, the slowest kept
span trees, the metric-registry delta since the last capture, and the
live state of its providers (healthtrack, membership, topology, SLO).
Bundles are bounded (retention), debounced per trigger class, and served
by the admin ``incidents`` route, its peer verbs and ``madmin``.

Knobs: MINIO_TPU_INCIDENTS, MINIO_TPU_INCIDENT_KEEP,
MINIO_TPU_INCIDENT_DEBOUNCE_S, MINIO_TPU_INCIDENT_EVENTS,
MINIO_TPU_INCIDENT_WINDOW.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from . import atomicfile, eventlog, knobs, telemetry


def _trigger_classes() -> set:
    return {c.strip() for c in
            knobs.get_str("MINIO_TPU_INCIDENT_EVENTS").split(",")
            if c.strip()}


class IncidentRecorder:
    """Journal-hub subscriber that turns trigger events into bundles.

    One per process (the journal it watches is process-global);
    ``attach()`` is idempotent so multi-node-in-process tests boot it
    once. State providers are callables registered at boot — they run
    at capture time, never on the hot path."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._dir: Optional[str] = None
        self._providers: Dict[str, Callable[[], object]] = {}
        self._last_capture: Dict[str, float] = {}   # class -> ts
        self._metrics_base: dict = {}
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.captured_total = 0

    # -- wiring ------------------------------------------------------------

    def attach(self, dir_path: str) -> None:
        with self._mu:
            if self._dir is not None:
                return
            os.makedirs(dir_path, exist_ok=True)
            self._dir = dir_path
            self._metrics_base = telemetry.REGISTRY.snapshot(
                "minio_tpu_")
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._watch, daemon=True,
                name="incident-capture")
            self._worker.start()

    def add_provider(self, name: str,
                     fn: Callable[[], object]) -> None:
        with self._mu:
            self._providers.setdefault(name, fn)

    def stop(self) -> None:
        self._stop.set()
        t = self._worker
        if t is not None and t.is_alive():
            t.join(timeout=5)

    def detach(self) -> None:
        """Stop and forget the bundle directory, so that the next
        ``attach`` (a node booted again in the process) starts anew."""
        self.stop()
        with self._mu:
            self._dir = None
            self._worker = None

    # -- trigger loop ------------------------------------------------------

    def _watch(self) -> None:
        with eventlog.JOURNAL.hub.subscribe() as sub:
            while not self._stop.is_set():
                entry = sub.get(timeout=0.5)
                if entry is None:
                    continue
                if not knobs.get_bool("MINIO_TPU_INCIDENTS"):
                    continue
                cls = entry.get("class", "")
                if cls not in _trigger_classes():
                    continue
                if not self._debounce_ok(cls):
                    continue
                try:
                    self.capture(entry)
                except Exception:  # noqa: BLE001 — capture is best-effort
                    pass

    def _debounce_ok(self, cls: str) -> bool:
        now = time.monotonic()
        window = knobs.get_float("MINIO_TPU_INCIDENT_DEBOUNCE_S")
        with self._mu:
            last = self._last_capture.get(cls, 0.0)
            if now - last < window:
                return False
            self._last_capture[cls] = now
            return True

    # -- capture -----------------------------------------------------------

    @staticmethod
    def _metrics_delta(base: dict, cur: dict) -> dict:
        """Series that moved since the last capture — counters as
        numeric deltas, histograms as {sum, count} deltas, gauges as
        their current value (a gauge's delta is meaningless)."""
        out: dict = {}
        for name, series in cur.items():
            base_series = base.get(name, {})
            moved = {}
            for lk, v in series.items():
                b = base_series.get(lk)
                if isinstance(v, dict):
                    db = b if isinstance(b, dict) else {}
                    d = {"sum": round(v.get("sum", 0)
                                      - db.get("sum", 0), 6),
                         "count": v.get("count", 0)
                         - db.get("count", 0)}
                    if d["count"]:
                        moved[lk] = d
                elif isinstance(b, (int, float)):
                    if v != b:
                        moved[lk] = round(v - b, 6)
                elif v:
                    moved[lk] = v
            if moved:
                out[name] = moved
        return out

    def capture(self, trigger: dict) -> Optional[str]:
        """Write one bundle; returns its incident id (None when the
        recorder is detached)."""
        with self._mu:
            dir_path = self._dir
            providers = dict(self._providers)
            base = self._metrics_base
        if dir_path is None:
            return None
        now = time.time()
        cls = trigger.get("class", "unknown")
        self.captured_total += 1
        inc_id = "inc-%d-%03d-%s" % (
            int(now), self.captured_total % 1000,
            cls.replace(".", "-"))
        cur = telemetry.REGISTRY.snapshot("minio_tpu_")
        state = {}
        for name, fn in providers.items():
            try:
                state[name] = fn()
            except Exception as e:  # noqa: BLE001 — a dead provider
                state[name] = {"error": f"{type(e).__name__}: {e}"}
        bundle = {
            "v": 1,
            "id": inc_id,
            "time": now,
            "node": eventlog.JOURNAL.node,
            "trigger": trigger,
            "events": eventlog.JOURNAL.recent(
                knobs.get_int("MINIO_TPU_INCIDENT_WINDOW")),
            "slow_spans": telemetry.SPANS.dump(5, slowest=True),
            "metrics_delta": self._metrics_delta(base, cur),
            "state": state,
        }
        with self._mu:
            self._metrics_base = cur
        path = os.path.join(dir_path, inc_id + ".json")
        atomicfile.write_atomic(
            path, (json.dumps(bundle) + "\n").encode())
        self._prune(dir_path)
        eventlog.emit("incident.captured", trigger=cls,
                      incident=inc_id, events=len(bundle["events"]))
        return inc_id

    def _prune(self, dir_path: str) -> None:
        keep = knobs.get_int("MINIO_TPU_INCIDENT_KEEP")
        try:
            names = sorted(n for n in os.listdir(dir_path)
                           if n.startswith("inc-")
                           and n.endswith(".json"))
        except OSError:
            return
        for old in names[:max(0, len(names) - keep)]:
            try:
                os.unlink(os.path.join(dir_path, old))
            except OSError:
                pass

    # -- readback ----------------------------------------------------------

    def list(self) -> List[dict]:
        """Newest-first bundle summaries (admin /incidents)."""
        with self._mu:
            dir_path = self._dir
        if dir_path is None:
            return []
        out = []
        try:
            names = sorted(n for n in os.listdir(dir_path)
                           if n.startswith("inc-")
                           and n.endswith(".json"))
        except OSError:
            return []
        for name in reversed(names):
            doc = self._read(os.path.join(dir_path, name))
            if doc is None:
                continue
            out.append({
                "id": doc.get("id", name[:-5]),
                "time": doc.get("time"),
                "node": doc.get("node", ""),
                "trigger": (doc.get("trigger") or {}).get("class", ""),
                "events": len(doc.get("events") or ()),
            })
        return out

    def get(self, inc_id: str) -> Optional[dict]:
        with self._mu:
            dir_path = self._dir
        if dir_path is None or "/" in inc_id or os.sep in inc_id:
            return None
        return self._read(os.path.join(dir_path, inc_id + ".json"))

    @staticmethod
    def _read(path: str) -> Optional[dict]:
        try:
            with open(path, "rb") as f:
                doc = atomicfile.load_json_doc(f.read())
        except OSError:
            return None
        return doc if isinstance(doc, dict) else None


RECORDER = IncidentRecorder()
