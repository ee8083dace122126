"""In-process metrics registry: counters, gauges and histograms.

Counterpart of the metrics half of minio_tpu/utils/telemetry.py, trimmed
to what the port's modules bump: labelled monotonic counters, settable
gauges (the metacache's entry count) and fixed-bucket histograms, read
back with ``value()`` and ``count()``. Left out until the admin surface
is ported: collectors, the Prometheus text exposition, the snapshot, and
the span tracer. Locks are plain
``threading.Lock`` (the reference's lockcheck wrappers are not ported).
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Family:
    """One metric family: name, help, samples keyed by labels."""

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

    def series(self) -> dict:
        """label tuple -> value of every labelled series."""
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
    """Fixed-bucket histogram with a +Inf bucket, sum and count per label
    set."""

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


class MetricsRegistry:
    """Process-global family registry. The getters are idempotent: the
    first call creates the family, later calls return it, and a kind
    mismatch raises."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._families: Dict[str, _Family] = {}

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


REGISTRY = MetricsRegistry()
