"""Per-stage wall-time accounting for the live-server data path.

A copy of minio_tpu/utils/stagetimer.py (stdlib only); nothing is left
out.

The reference answers "where does a PUT spend its time" with pprof; this
build needs the same answer without a profiler attached: a run script
(chip_smoke.py) enables the collector, the hot path marks stages (read,
split, encode+digest, shard write, commit), and the script prints the
aggregate breakdown. Disabled (the default) the cost is one dict lookup
and an `if` per stage — safe to leave in production paths.

Stages nest across threads; each accumulates exclusive wall time per
(name) key with a call count, summed over all threads. When enabled,
per-call durations are additionally sampled (bounded reservoir) so the
bench can report p50/p99 latencies, not just means.

Overlap accounting (the pipelined data path's observable): the pipeline
records, per stream, the WALL time of the whole pipelined section and
the SUM of its stage times. stage_sum > wall means the stages actually
ran concurrently; stage_sum / wall is the effective parallelism. Always
on (a few adds per stream) — `overlap_report()` reads it back.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

ENABLED = False

# per-stage duration samples kept for percentiles (per stage name);
# beyond the cap only sums/counts accumulate — the bench's runs fit
SAMPLE_CAP = 8192

_lock = threading.Lock()
_acc: "defaultdict[str, list]" = defaultdict(lambda: [0.0, 0])
_samples: "defaultdict[str, list]" = defaultdict(list)
# name -> [wall_s, stage_s, streams]
_overlap: "defaultdict[str, list]" = defaultdict(lambda: [0.0, 0.0, 0])


class _Stage:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0

    def __enter__(self):
        if ENABLED:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if ENABLED:
            dt = time.perf_counter() - self.t0
            with _lock:
                slot = _acc[self.name]
                slot[0] += dt
                slot[1] += 1
                s = _samples[self.name]
                if len(s) < SAMPLE_CAP:
                    s.append(dt)
        return False


def stage(name: str) -> _Stage:
    return _Stage(name)


def add(name: str, seconds: float, count: int = 1) -> None:
    """Record time measured externally (e.g. inside a hashing thread)."""
    if ENABLED:
        with _lock:
            slot = _acc[name]
            slot[0] += seconds
            slot[1] += count
            s = _samples[name]
            if len(s) < SAMPLE_CAP:
                s.append(seconds / max(count, 1))


def add_overlap(name: str, wall_s: float, stage_s: float) -> None:
    """Record one pipelined stream: its wall time vs the summed time of
    its stages. Always on — the pipeline metrics read this back."""
    with _lock:
        slot = _overlap[name]
        slot[0] += wall_s
        slot[1] += stage_s
        slot[2] += 1


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def reset() -> None:
    with _lock:
        _acc.clear()
        _samples.clear()
        _overlap.clear()


def report() -> Dict[str, dict]:
    """name -> {seconds, calls}, sorted by descending time."""
    with _lock:
        items = sorted(_acc.items(), key=lambda kv: -kv[1][0])
        return {k: {"seconds": round(v[0], 4), "calls": v[1]}
                for k, v in items}


def percentiles() -> Dict[str, dict]:
    """name -> {p50_ms, p99_ms, n} from the sampled per-call durations
    (requires ENABLED during the measured window)."""
    out: Dict[str, dict] = {}
    with _lock:
        snap = {k: list(v) for k, v in _samples.items() if v}
    for name, xs in sorted(snap.items()):
        xs.sort()
        n = len(xs)
        out[name] = {
            "p50_ms": round(xs[n // 2] * 1e3, 3),
            "p99_ms": round(xs[min(n - 1, (n * 99) // 100)] * 1e3, 3),
            "n": n,
        }
    return out


def overlap_report() -> Dict[str, dict]:
    """name -> {wall_s, stage_s, overlap_x, streams}: how much the
    pipelined sections actually overlapped (overlap_x = stage_s/wall_s;
    1.0 means fully serial)."""
    with _lock:
        return {k: {"wall_s": round(v[0], 4),
                    "stage_s": round(v[1], 4),
                    "overlap_x": round(v[1] / v[0], 3) if v[0] else 0.0,
                    "streams": v[2]}
                for k, v in _overlap.items()}
