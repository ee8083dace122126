"""In-process metrics registry: counters, gauges and histograms, with
collectors and the Prometheus text exposition.

Counterpart of the metrics half of minio_tpu/utils/telemetry.py: labelled
monotonic counters, settable gauges and fixed-bucket histograms; collector
callbacks (``register_collector``) that refresh live gauges at exposition
time; ``render(extra)``, the ``# HELP``/``# TYPE`` text every metrics
surface serves, where ``extra`` is a scrape's one-shot collector (so that
each of several nodes in one process reports its own drives); and
``snapshot``. Left out until the tracing plane is ported: the span tracer.
Locks are plain ``threading.Lock`` (the reference's lockcheck wrappers are
not ported).
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default latency buckets (seconds) — spans two orders of magnitude
# around typical object-op latencies on both tmpfs and spinning media
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers bare, floats plain."""
    if v == math.inf:
        return "+Inf"
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 1e15):
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _render_labels(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Family:
    """One metric family: name, help, type, samples keyed by labels."""

    kind = "untyped"

    def __init__(self, name: str, help_: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help_
        self._mu = threading.Lock()
        self._series: Dict[tuple, object] = {}

    def _check_labels(self, labels: dict) -> tuple:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name {k!r}")
        return _label_key(labels)

    def clear(self) -> None:
        """Forget every series (label churn hygiene: per-bucket gauges
        refreshed from a snapshot drop deleted buckets)."""
        with self._mu:
            self._series.clear()

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._mu:
            items = sorted(self._series.items())
        for key, value in items:
            lines.extend(self._render_series(key, value))
        return lines

    def _render_series(self, key: tuple, value) -> List[str]:
        return [f"{self.name}{_render_labels(key)} {_fmt(value)}"]


class Counter(_Family):
    """Monotonic counter (optionally labelled)."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._check_labels(labels)
        with self._mu:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._mu:
            return self._series.get(_label_key(labels), 0)

    def series(self) -> Dict[tuple, float]:
        """label-key -> value snapshot (the SLO engine aggregates
        status-class counts across label sets)."""
        with self._mu:
            return dict(self._series)


class Gauge(_Family):
    """Settable instantaneous value (optionally labelled)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._check_labels(labels)
        with self._mu:
            self._series[key] = value

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._check_labels(labels)
        with self._mu:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._mu:
            return self._series.get(_label_key(labels), 0)


class _HistSeries:
    __slots__ = ("counts", "total", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets     # per-bucket (non-cumulative)
        self.total = 0.0
        self.count = 0


class Histogram(_Family):
    """Fixed-bucket histogram; exposes `_bucket` (cumulative, with a
    +Inf bucket), `_sum` and `_count` series per label set."""

    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels) -> None:
        key = self._check_labels(labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._mu:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets) + 1)
            s.counts[idx] += 1
            s.total += value
            s.count += 1

    def count(self, **labels) -> int:
        with self._mu:
            s = self._series.get(_label_key(labels))
            return s.count if s is not None else 0

    def series_snapshot(self) -> Dict[tuple, tuple]:
        """label-key -> (per-bucket counts, sum, count), consistent
        per series — the SLO engine derives over-threshold fractions
        from bucket counts without reaching into family internals."""
        with self._mu:
            return {key: (list(s.counts), s.total, s.count)
                    for key, s in self._series.items()}

    def _render_series(self, key: tuple, s: "_HistSeries") -> List[str]:
        # snapshot under the family lock: a concurrent observe()
        # mutates counts/total/count together, and a torn read here
        # could emit _bucket{+Inf} < _count (breaks the histogram
        # invariant scrapers rely on)
        with self._mu:
            counts = list(s.counts)
            total, count = s.total, s.count
        out = []
        cum = 0
        for le, c in zip(self.buckets + (math.inf,), counts):
            cum += c
            le_pair = 'le="' + _fmt(le) + '"'
            out.append(f"{self.name}_bucket"
                       f"{_render_labels(key, le_pair)} {cum}")
        out.append(f"{self.name}_sum{_render_labels(key)} "
                   f"{_fmt(round(total, 9))}")
        out.append(f"{self.name}_count{_render_labels(key)} {count}")
        return out


class MetricsRegistry:
    """Process-global family registry. Getter methods are idempotent:
    the first call creates the family, later calls return it (and
    reject a kind mismatch — two subsystems silently sharing one name
    with different types is exactly the bug a registry exists to
    catch)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get(self, cls, name: str, help_: str, **kw):
        with self._mu:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help_, **kw)
            elif not isinstance(fam, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{fam.kind}, not {cls.kind}")
            return fam

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """`fn()` runs before every render — the hook live-value
        subsystems (queue depth, pool pressure) refresh gauges from."""
        with self._mu:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _run_collectors(self) -> None:
        with self._mu:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 — telemetry is passive
                pass

    def render(self, extra: Optional[Callable[[], None]] = None) -> str:
        """Prometheus text exposition of every family. `extra` is a
        one-shot collector run after the registered ones — a metrics
        endpoint passes its own server-scoped refresh here instead of
        registering globally, so several servers in one process each
        scrape THEIR values (last-registered-wins clobbering) and a
        dead server stops reporting."""
        self._run_collectors()
        if extra is not None:
            try:
                extra()
            except Exception:  # noqa: BLE001 — telemetry is passive
                pass
        with self._mu:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        lines: List[str] = []
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def snapshot(self, prefix: str = "") -> dict:
        """name -> {labels-json: value} (histograms: {sum, count}) —
        the bench's registry snapshot."""
        self._run_collectors()
        with self._mu:
            fams = [f for f in self._families.values()
                    if f.name.startswith(prefix)]
        out: dict = {}
        for fam in fams:
            series = {}
            with fam._mu:       # consistent sum/count pairs
                for key, v in fam._series.items():
                    lk = ",".join(f"{k}={val}" for k, val in key) or ""
                    if isinstance(v, _HistSeries):
                        series[lk] = {"sum": round(v.total, 6),
                                      "count": v.count}
                    else:
                        series[lk] = v
            out[fam.name] = series
        return out


REGISTRY = MetricsRegistry()
