"""Process-global profilers behind the admin ``profiling/start`` and
``profiling/stop`` routes and their peer verbs (reference
cmd/admin-handlers.go:461-525 globalProfiler). Two kinds: "cpu" is
cProfile and "mem" is tracemalloc (allocation sites by size). Live state
is exported as ``minio_tpu_profiler_running{kind=...}``.

A copy of minio_tpu/utils/profiling.py; nothing is left out. The port
adds no device profiler, as the reference has none.
"""

from __future__ import annotations

import cProfile
import io
import pstats
import threading
import tracemalloc
from typing import Optional

from . import telemetry

_mu = threading.Lock()


class _Kind:
    """One profiler kind: _begin/_end under the module lock, is_running
    without side effects. Subclasses own their runtime state."""

    def is_running(self) -> bool:
        raise NotImplementedError

    def _begin(self) -> bool:
        raise NotImplementedError

    def _end(self, top: int) -> Optional[str]:
        raise NotImplementedError


class _CpuKind(_Kind):
    def __init__(self) -> None:
        self._profiler: Optional[cProfile.Profile] = None

    def is_running(self) -> bool:
        return self._profiler is not None

    def _begin(self) -> bool:
        if self._profiler is not None:
            return False
        self._profiler = cProfile.Profile()
        self._profiler.enable()
        return True

    def _end(self, top: int) -> Optional[str]:
        prof, self._profiler = self._profiler, None
        if prof is None:
            return None
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative") \
            .print_stats(top)
        return buf.getvalue()


class _MemKind(_Kind):
    def __init__(self) -> None:
        self._running = False

    def is_running(self) -> bool:
        return self._running

    def _begin(self) -> bool:
        if self._running or tracemalloc.is_tracing():
            return False
        tracemalloc.start(10)           # keep 10 frames per alloc site
        self._running = True
        return True

    def _end(self, top: int) -> Optional[str]:
        if not self._running:
            return None
        self._running = False
        # snapshot + stop stay under the module lock (the caller holds
        # it): a concurrent start("mem") between flag-clear and stop()
        # would see is_tracing() True, report "already running", and
        # then have its tracing torn down here
        snap = tracemalloc.take_snapshot()
        current, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        lines = [f"traced current={current} peak={peak} bytes",
                 "top allocation sites by size:"]
        for stat in snap.statistics("lineno")[:top]:
            lines.append(f"  {stat.size:>12d} B  {stat.count:>8d} x  "
                         f"{stat.traceback}")
        return "\n".join(lines) + "\n"


_TABLE: dict[str, _Kind] = {"cpu": _CpuKind(), "mem": _MemKind()}
KINDS = tuple(_TABLE)


def parse_kinds(raw: str) -> list[str]:
    """One parser for every surface (admin HTTP, peer RPC): tolerant
    of whitespace, preserving order, silently dropping unknowns —
    callers that must REJECT unknowns compare against split_raw()."""
    return [k for k in split_raw(raw) if k in _TABLE]


def split_raw(raw: str) -> list[str]:
    return [k.strip() for k in raw.split(",") if k.strip()]


def start(kind: str = "cpu") -> bool:
    """Begin profiling `kind`; False when already running (or the kind
    is unknown)."""
    entry = _TABLE.get(kind)
    if entry is None:
        return False
    with _mu:
        return entry._begin()


def running(kind: str = "cpu") -> bool:
    entry = _TABLE.get(kind)
    if entry is None:
        return False
    with _mu:
        return entry.is_running()


def stop_text(kind: str = "cpu", top: int = 60) -> Optional[str]:
    """Stop `kind` and render the profile (None when not running)."""
    entry = _TABLE.get(kind)
    if entry is None:
        return None
    with _mu:
        return entry._end(top)


def _collect_profiler_metrics() -> None:
    g = telemetry.REGISTRY.gauge(
        "minio_tpu_profiler_running",
        "1 while the given profiler kind is collecting")
    with _mu:
        for kind, entry in _TABLE.items():
            g.set(int(entry.is_running()), kind=kind)


telemetry.REGISTRY.register_collector(_collect_profiler_metrics)
