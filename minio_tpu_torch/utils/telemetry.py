"""Telemetry: the in-process metrics registry and request-scoped spans.

Counterpart of minio_tpu/utils/telemetry.py. Two halves:

* :data:`REGISTRY`: labelled monotonic counters, settable gauges and
  fixed-bucket histograms; collector callbacks (``register_collector``)
  that refresh live gauges at exposition time; ``render(extra)``, the
  ``# HELP``/``# TYPE`` text every metrics surface serves, where
  ``extra`` is a scrape's one-shot collector (so that each of several
  nodes in one process reports its own drives); and ``snapshot``.

* the span tracer: ``contextvars``-propagated span trees. The HTTP
  middleware opens a root span per request (``trace``); ``with
  span(name):`` anywhere below attaches a child to the span current on
  this thread (stage threads and drive fan-out pools forward
  ``propagating_context()``); work done on a shared thread that no
  context reaches, such as the batch former's dispatch on the card, is
  attached after the fact with external timing (``attach_span``).
  ``span()`` returns a shared no-op when no trace is active. Sampling is
  tail-based (errors and slow traces always kept, the rest with
  probability MINIO_TPU_TRACE_SAMPLE), and each trace has a budget of
  MINIO_TPU_TRACE_MAX_SPANS spans past which ``span()`` no-ops and the
  root counts the drops. The internode transport injects the trace and
  span headers; the serving side opens a ``join()`` fragment, which
  ``SPANS.dump()`` grafts back into its parent tree.

Knobs: MINIO_TPU_TRACE_SLOW_MS, MINIO_TPU_TRACE_SAMPLE,
MINIO_TPU_TRACE_KEEP, MINIO_TPU_TRACE_MAX_SPANS. Locks are plain
``threading.Lock`` (the reference's lockcheck wrappers are not ported).
"""

from __future__ import annotations

import bisect
import contextvars
import math
import random
import re
import threading
import time
import uuid
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from . import knobs

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "Span", "SpanSink", "SPANS", "span", "trace", "join",
    "current_span", "attach_span", "propagating_context", "traced_iter",
]

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


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------


TRACE_HEADER = "x-minio-trace-id"
SPAN_HEADER = "x-minio-span-id"

SLOW_S = knobs.get_float("MINIO_TPU_TRACE_SLOW_MS") / 1e3
SAMPLE = knobs.get_float("MINIO_TPU_TRACE_SAMPLE")
KEEP = knobs.get_int("MINIO_TPU_TRACE_KEEP")
# spans per TRACE cap: a 10 GiB distributed PUT would otherwise
# materialize one span per block per drive (~100k objects) and the
# kept ring would pin all of them; past the budget span() returns the
# no-op and the root counts what was dropped
MAX_SPANS = knobs.get_int("MINIO_TPU_TRACE_MAX_SPANS")

_current: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("minio_tpu_span", default=None)


class Span:
    """One timed operation in a request's tree. Children append under
    the parent's lock — stage threads and drive fan-outs attach
    concurrently."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "t0", "duration_s", "attrs", "error", "children",
                 "remote", "_mu", "_token", "root", "has_error",
                 "slow_exempt", "n_spans", "n_dropped")

    def __init__(self, name: str, trace_id: str, parent_id: str = "",
                 attrs: Optional[dict] = None, remote: bool = False,
                 root: Optional["Span"] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:12]
        self.parent_id = parent_id
        self.start = time.time()
        self.t0 = time.perf_counter()
        self.duration_s = 0.0
        self.attrs = attrs or {}
        self.error = ""
        self.children: List[Span] = []
        self.remote = remote
        self._mu = threading.Lock()
        self._token = None
        # tree root (None when self IS the root): child errors set the
        # root's has_error so the tail-sampling keep decision is O(1)
        # instead of walking the whole tree per request
        self.root = root
        self.has_error = False
        # long-poll/streaming admin surfaces run for minutes by design:
        # exempt from the keep-if-slow rule (errors still keep)
        self.slow_exempt = False
        # per-trace span budget accounting (root only): spans created /
        # spans dropped past MAX_SPANS
        self.n_spans = 0
        self.n_dropped = 0

    def mark_error(self, msg: str) -> None:
        if not self.error:
            self.error = msg
        (self.root or self).has_error = True

    def _admit_child(self) -> bool:
        """Charge one span against this ROOT's budget; False = the
        trace is at MAX_SPANS and the caller should no-op."""
        with self._mu:
            if self.n_spans >= MAX_SPANS:
                self.n_dropped += 1
                return False
            self.n_spans += 1
            return True

    def add_child(self, child: "Span") -> None:
        with self._mu:
            self.children.append(child)

    def finish(self) -> None:
        self.duration_s = time.perf_counter() - self.t0

    def depth(self) -> int:
        with self._mu:
            kids = list(self.children)
        return 1 + max((c.depth() for c in kids), default=0)

    def walk(self) -> Iterable["Span"]:
        yield self
        with self._mu:
            kids = list(self.children)
        for c in kids:
            yield from c.walk()

    def to_dict(self) -> dict:
        with self._mu:
            kids = list(self.children)
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "start": round(self.start, 6),
            "duration_ms": round(self.duration_s * 1e3, 3),
        }
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.error:
            d["error"] = self.error
        if self.remote:
            d["remote"] = True
        if self.n_dropped:
            # spans not recorded past the per-trace MAX_SPANS budget —
            # "covered everything" must not be implied when it wasn't
            d["spans_dropped"] = self.n_dropped
        if kids:
            d["children"] = [c.to_dict() for c in kids]
        return d


class _SpanCtx:
    """Context manager that opens `span` on enter (making it current on
    this thread) and finishes it on exit. `root` spans are offered to
    the sink; `fragment` spans are recorded as RPC-join fragments."""

    __slots__ = ("span", "root", "fragment")

    def __init__(self, sp: Span, root: bool = False,
                 fragment: bool = False):
        self.span = sp
        self.root = root
        self.fragment = fragment

    def __enter__(self) -> Span:
        self.span._token = _current.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self.span
        if sp._token is not None:
            _current.reset(sp._token)
            sp._token = None
        if exc is not None:
            sp.mark_error(f"{type(exc).__name__}: {exc}")
        elif sp.error:
            (sp.root or sp).has_error = True
        sp.finish()
        if self.root:
            SPANS.offer(sp)
        elif self.fragment:
            SPANS.record_fragment(sp)
        return False


class _NoopSpanCtx:
    """Shared do-nothing context manager — the zero-cost path when no
    trace is active on this thread."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpanCtx()


def current_span() -> Optional[Span]:
    return _current.get()


def trace(name: str, trace_id: str = "", **attrs) -> _SpanCtx:
    """Open a ROOT span (a new trace). Used by the server middleware
    and the bench; everything below attaches via span()."""
    sp = Span(name, trace_id or uuid.uuid4().hex[:16],
              attrs=attrs or None)
    return _SpanCtx(sp, root=True)


def span(name: str, parent: Optional[Span] = None, **attrs):
    """Child span of `parent` (default: the current span on this
    thread). Returns a shared no-op when there is no active trace, so
    instrumented hot paths cost one context-var read when idle."""
    p = parent if parent is not None else _current.get()
    if p is None:
        return _NOOP
    root = p.root or p
    if not root._admit_child():
        return _NOOP
    sp = Span(name, p.trace_id, parent_id=p.span_id,
              attrs=attrs or None, root=root)
    p.add_child(sp)
    return _SpanCtx(sp)


def join(name: str, trace_id: str, parent_span_id: str = "",
         **attrs) -> _SpanCtx:
    """Server-side half of an internode RPC: open a span under the
    CALLER's trace identity. Finished joined spans are recorded as
    fragments; dump() grafts them back into the caller's tree."""
    sp = Span(name, trace_id, parent_id=parent_span_id,
              attrs=attrs or None, remote=True)
    return _SpanCtx(sp, fragment=True)


def traced_iter(name: str, it, **attrs):
    """Span over a CHUNK STREAM: yields from `it` with the span made
    current only WHILE the underlying iterator runs (set/reset around
    each next()), never across a yield. A plain `with span():` inside
    a generator would mutate the CONSUMER's context (PEP 567:
    generators don't get their own) and an abandoned generator (ranged
    reads, client hangups) would leak the span as that thread's
    current until GC — and then reset a foreign-context token. The
    span's duration covers first-to-last chunk; abandonment finishes
    it from the generator's close."""
    parent = _current.get()
    if parent is None:
        yield from it
        return
    root = parent.root or parent
    if not root._admit_child():
        yield from it
        return
    sp = Span(name, parent.trace_id, parent_id=parent.span_id,
              attrs=attrs or None, root=root)
    parent.add_child(sp)
    try:
        while True:
            token = _current.set(sp)
            try:
                try:
                    chunk = next(it)
                except StopIteration:
                    return
            finally:
                _current.reset(token)
            yield chunk
    except GeneratorExit:
        # the CONSUMER abandoned the stream (client hangup, ranged
        # probe) — routine, not an error: tail-keeping every
        # disconnect would crowd the ring with content-free trees
        sp.attrs["aborted"] = True
        raise
    except BaseException as e:
        sp.mark_error(f"{type(e).__name__}: {e}")
        raise
    finally:
        sp.finish()
        # abandonment (GeneratorExit) must close the inner generator
        # NOW, not at GC: its finally blocks release locks and join
        # in-flight prefetch work (`yield from` did this implicitly)
        close = getattr(it, "close", None)
        if close is not None:
            close()


def attach_span(parent: Span, name: str, start_wall: float,
                duration_s: float, **attrs) -> Optional[Span]:
    """Attach an externally-timed, already-finished span (work done on
    a shared thread no contextvar reaches, e.g. the batch scheduler's
    collector) under `parent`. Returns the new span (so the caller can
    attach stage children under it), or None past the trace's span
    budget."""
    root = parent.root or parent
    if not root._admit_child():
        return None
    sp = Span(name, parent.trace_id, parent_id=parent.span_id,
              attrs=attrs or None, root=root)
    sp.start = start_wall
    sp.duration_s = duration_s
    parent.add_child(sp)
    return sp


def propagating_context() -> Optional[contextvars.Context]:
    """A context copy carrying the current span, or None when no trace
    is active. Fan-out pools call this per task (`ctx.run(fn)`) —
    one Context object must not run in two threads at once, so every
    task needs its own copy."""
    if _current.get() is None:
        return None
    return contextvars.copy_context()


class SpanSink:
    """Tail-sampled store of finished traces + RPC-join fragments."""

    def __init__(self, capacity: int = KEEP,
                 slow_s: float = SLOW_S, sample: float = SAMPLE):
        self._mu = threading.Lock()
        self.capacity = capacity
        self.slow_s = slow_s
        self.sample = sample
        self._kept: "deque[Span]" = deque(maxlen=capacity)
        # trace_id -> [fragment spans]; bounded FIFO eviction
        self._fragments: Dict[str, List[Span]] = {}
        self._fragment_order: "deque[str]" = deque()
        self._fragment_cap = 4 * capacity
        self.kept_total = 0
        self.dropped_total = 0

    def configure(self, slow_s: Optional[float] = None,
                  sample: Optional[float] = None) -> None:
        if slow_s is not None:
            self.slow_s = slow_s
        if sample is not None:
            self.sample = sample

    # -- ingest ------------------------------------------------------------

    def offer(self, root: Span) -> bool:
        """Tail-sampling: always keep errors and slow traces; keep the
        rest with probability `sample`. O(1): child errors were
        propagated to root.has_error as each span finished."""
        keep = bool(root.error) or root.has_error \
            or (root.duration_s >= self.slow_s
                and not root.slow_exempt) \
            or (self.sample > 0 and random.random() < self.sample)
        with self._mu:
            if keep:
                self._kept.append(root)
                self.kept_total += 1
            else:
                self.dropped_total += 1
        return keep

    def record_fragment(self, sp: Span) -> None:
        with self._mu:
            frags = self._fragments.get(sp.trace_id)
            if frags is None:
                frags = self._fragments[sp.trace_id] = []
                self._fragment_order.append(sp.trace_id)
                while len(self._fragment_order) > self._fragment_cap:
                    evicted = self._fragment_order.popleft()
                    self._fragments.pop(evicted, None)
            if len(frags) < 64:           # bound one trace's fragments
                frags.append(sp)

    # -- readback ----------------------------------------------------------

    def _graft(self, tree: dict, frags: List[Span]) -> None:
        """Attach fragments under the span that made the RPC (matched
        by parent span id); unmatched fragments land under the root."""
        index: Dict[str, dict] = {}

        def walk(node: dict) -> None:
            index[node["span_id"]] = node
            for c in node.get("children", ()):
                walk(c)

        walk(tree)
        for f in frags:
            target = index.get(f.parent_id, tree)
            target.setdefault("children", []).append(f.to_dict())

    def dump(self, n: int = 50, slowest: bool = False,
             name: str = "", trace_id: str = "") -> List[dict]:
        """Most recent (or slowest) kept traces as dict trees, with
        matching fragments grafted in. `name` keeps only roots with
        that span name (the per-API filter: root names ARE api names
        under the server middleware); `trace_id` selects one trace.
        Filters apply BEFORE the count cut, so `n` counts matches."""
        with self._mu:
            kept = list(self._kept)
            frags = {tid: list(fs) for tid, fs in self._fragments.items()}
        if name:
            kept = [s for s in kept if s.name == name]
        if trace_id:
            kept = [s for s in kept if s.trace_id == trace_id]
        if slowest:
            kept.sort(key=lambda s: -s.duration_s)
        else:
            kept.reverse()                # newest first
        out = []
        for root in kept[:max(n, 0)]:
            tree = root.to_dict()
            if root.trace_id in frags:
                self._graft(tree, frags[root.trace_id])
            out.append(tree)
        return out

    def clear(self) -> None:
        with self._mu:
            self._kept.clear()
            self._fragments.clear()
            self._fragment_order.clear()


SPANS = SpanSink()
