"""eventlog — the structured event journal behind the incident plane.

A copy of minio_tpu/utils/eventlog.py. Two halves:

* the event-class registry, whole: every emit site names a registered
  class with its subsystem, severity and bounded attr keys. It holds the
  classes of planes the port has not ported too (``drive.*``,
  ``notify.*``, ``qos.*``, ``net.*``), so that a journal either package
  wrote reads the same in the other.

* the journal: a bounded in-memory ring, a pubsub hub for followers and
  a background segment flusher. ``emit()`` is a dict build, a ring append
  and a pending-list append under one lock; persistence and fan-out
  happen off-thread. Segments go under drive 0's
  ``.minio.sys/eventlog/`` through ``atomicfile``, with the
  ``eventlog.persist.segment`` crashpoint in the commit window, so a
  crash mid-persist leaves the previous segment set or the new one and
  a restart replays the surviving prefix.

The port adds ``EventJournal.detach``: the last node of a process to shut
down detaches the journal, so that a node booted again replays the
segments. Left out: the README table renderer (the reference's lint
generates its README table from the registry; the port has no such lint).

Knobs: MINIO_TPU_EVENTLOG, MINIO_TPU_EVENTLOG_RING,
MINIO_TPU_EVENTLOG_SEGMENT_EVENTS, MINIO_TPU_EVENTLOG_FLUSH_S,
MINIO_TPU_EVENTLOG_KEEP_SEGMENTS, MINIO_TPU_EVENTS_FOLLOW_MAX_S.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

SEVERITIES = ("info", "warn", "error", "crit")

# attr keys that name per-request / per-object identities — the same
# vocabulary the label-cardinality lint bans on metrics. An event
# journal is bounded; attrs that explode per object would turn it into
# an access log (the trace plane already is one).
UNBOUNDED_ATTR_KEYS = frozenset({
    "bucket", "object", "key", "obj", "etag", "version_id",
    "upload_id", "prefix", "trace_id", "request_id", "caller",
})


class EventClass:
    """One registered event class: the schema an emit site binds to."""

    __slots__ = ("name", "subsystem", "severity", "attrs", "doc")

    def __init__(self, name: str, subsystem: str, severity: str,
                 attrs: Tuple[str, ...], doc: str):
        self.name = name
        self.subsystem = subsystem
        self.severity = severity
        self.attrs = attrs
        self.doc = doc


EVENTS: Dict[str, EventClass] = {}


def define(name: str, subsystem: str, severity: str,
           attrs: Tuple[str, ...], doc: str) -> None:
    if name in EVENTS:
        raise ValueError(f"event class {name!r} already registered")
    if severity not in SEVERITIES:
        raise ValueError(f"event class {name!r}: unknown severity "
                         f"{severity!r} (one of {SEVERITIES})")
    for a in attrs:
        if a in UNBOUNDED_ATTR_KEYS:
            raise ValueError(
                f"event class {name!r}: attr {a!r} is in the unbounded"
                f" label vocabulary — journal attrs must be bounded")
    EVENTS[name] = EventClass(name, subsystem, severity, tuple(attrs),
                              doc)


def sev_rank(severity: str) -> int:
    """info=0 … crit=3; unknown ranks lowest (filters keep them out)."""
    try:
        return SEVERITIES.index(severity)
    except ValueError:
        return -1


# ---------------------------------------------------------------------------
# the registry (grouped by subsystem)
# ---------------------------------------------------------------------------

_S = "drive"
define("drive.suspect", _S, "warn", ("drive", "set"),
       "Drive health monitor marked a drive suspect (latency/error "
       "score over the conviction threshold)")
define("drive.probation", _S, "error", ("drive", "set"),
       "Suspect drive convicted into probation: reads deprioritized, "
       "writes steered away")
define("drive.reconvict", _S, "error", ("drive", "set"),
       "Probation probe failed — the quarantine clock restarts")
define("drive.readmit", _S, "info", ("drive", "set"),
       "Probation probes passed; the drive rejoins full duty")

_S = "heal"
define("mrf.enqueue", _S, "warn", ("queued",),
       "A degraded write enqueued its missing shards for background "
       "heal (MRF)")
define("mrf.drain", _S, "info", ("healed", "failed"),
       "An MRF entry finished draining (healed/failed are the "
       "queue's running totals)")

_S = "admission"
define("admission.shed", _S, "warn", ("reason",),
       "The admission plane refused a request with 503 SlowDown")

_S = "health"
define("health.transition", _S, "warn",
       ("kind", "target", "state", "event"),
       "A tracked entity (drive/peer) changed health state in the "
       "gray-failure tracker")

_S = "membership"
define("membership.generation", _S, "warn", ("peer", "generation"),
       "A peer came back under a new boot generation (restart "
       "detected; its locks and subscriptions are stale)")

_S = "net"
define("net.partition", _S, "error", ("rule", "peers"),
       "The network chaos plane partitioned this node from a peer set")
define("net.heal", _S, "info", ("peers",),
       "A network partition healed; cross-partition traffic resumed")

_S = "registry"
define("registry.fork", _S, "crit", ("epoch", "forks"),
       "fsck found divergent registry lineages under one epoch "
       "(split-brain residue); losers archived")

_S = "crash"
define("crashpoint.armed", _S, "warn", ("point", "nth"),
       "A crashpoint was armed (fault injection active in this "
       "process)")

_S = "device"
define("device.decline", _S, "info", ("stage", "reason"),
       "A device-path dispatch declined to CPU fallback "
       "(scheduler/scan/SSE)")

_S = "fsck"
define("fsck.complete", _S, "info",
       ("findings", "repaired", "unrepaired"),
       "An fsck sweep finished")
define("fsck.unrepaired", _S, "error", ("findings",),
       "fsck left findings it could not repair — operator attention "
       "needed (incident trigger)")

_S = "data"
define("rebalance.checkpoint", _S, "info", ("pool", "objects"),
       "Rebalance persisted a resumable progress checkpoint")
define("resync.checkpoint", _S, "info", ("target", "objects"),
       "Replication resync persisted a resumable progress checkpoint")

_S = "slo"
define("slo.breach", _S, "crit", ("objective", "window", "burn"),
       "An SLO burn rate crossed the alerting threshold (error budget "
       "burning too fast)")
define("slo.clear", _S, "info", ("objective",),
       "A breached SLO's burn rate dropped back under the clear "
       "threshold")

_S = "incident"
define("incident.captured", _S, "warn",
       ("trigger", "incident", "events"),
       "The black-box recorder wrote an incident bundle")

_S = "qos"
define("qos.update", _S, "info", ("epoch", "tenants", "tiers"),
       "The QoS budget registry committed a new epoch (budget set or "
       "removed)")
define("tenant.shed", _S, "warn", ("tenant", "reason"),
       "A tenant hit its QoS budget and was refused (first shed per "
       "tenant per debounce window)")

_S = "notify"
define("notify.update", _S, "info", ("epoch", "targets"),
       "The notification-target registry committed a new epoch "
       "(target added or removed)")
define("notify.offline", _S, "warn", ("target",),
       "A notification target failed a delivery and entered its "
       "offline window (first failure per window)")
define("notify.redrive", _S, "info", ("target", "delivered"),
       "A recovered notification target drained its persisted event "
       "backlog")
define("notify.drop", _S, "warn", ("target",),
       "An event record was dropped at a full per-target delivery "
       "queue (bounded backlog overflow)")

del _S


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

_SEGMENT_FMT = "seg-%016d.json"


class EventJournal:
    """Process-global bounded event recorder + segment persistence.

    In-memory the journal is a ring (newest RING events) plus a pubsub
    hub for followers; on disk it is a sequence of immutable JSON
    segments, each holding a contiguous seq range, pruned to the
    newest KEEP_SEGMENTS. ``attach()`` replays surviving segments into
    the ring so the timeline spans restarts — that is what lets
    ``drivehealth`` answer "when was this drive quarantined" after the
    process that quarantined it died.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.node = ""
        self._ring: "deque[dict]" = deque(maxlen=512)
        self._pending: List[dict] = []
        self._seq = 0
        self._hub = None                    # PubSub, created lazily
        self._dir: Optional[str] = None
        self._flusher: Optional[threading.Thread] = None
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._segment_events = 64
        self._flush_s = 2.0
        self._keep_segments = 16
        self.dropped_total = 0              # emits while disabled

    # -- config ------------------------------------------------------------

    @staticmethod
    def _enabled() -> bool:
        from . import knobs
        return knobs.get_bool("MINIO_TPU_EVENTLOG")

    @property
    def hub(self):
        """The follower hub (lazy: the registry half of this module
        must stay importable standalone, without the package)."""
        if self._hub is None:
            from .pubsub import PubSub
            self._hub = PubSub()
        return self._hub

    # -- emit --------------------------------------------------------------

    def emit(self, class_name: str, **attrs) -> Optional[dict]:
        """Record one event. The class must be registered. Returns the
        recorded entry, or None when the journal is off."""
        ec = EVENTS.get(class_name)
        if ec is None:
            raise ValueError(f"unregistered event class {class_name!r}")
        if not self._enabled():
            self.dropped_total += 1
            return None
        entry = {
            "ts": round(time.time(), 3),
            "class": ec.name,
            "sev": ec.severity,
            "sub": ec.subsystem,
            "node": self.node,
            "attrs": attrs,
        }
        kick = False
        with self._mu:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)
            if self._dir is not None:
                self._pending.append(entry)
                kick = len(self._pending) >= self._segment_events
        if kick:
            self._kick.set()
        hub = self._hub
        if hub is not None and hub.subscriber_count:
            hub.publish(entry)
        return entry

    # -- queries -----------------------------------------------------------

    @staticmethod
    def entry_matches(entry: dict, classes: Optional[set] = None,
                      subsystems: Optional[set] = None,
                      min_sev: int = 0) -> bool:
        """The /events filter semantics: `classes` keeps only those
        event classes, `subsystems` only those subsystems, `min_sev`
        the given severity rank and above."""
        if classes and entry.get("class") not in classes:
            return False
        if subsystems and entry.get("sub") not in subsystems:
            return False
        if min_sev and sev_rank(entry.get("sev", "")) < min_sev:
            return False
        return True

    def recent(self, n: int = 0, classes: Optional[set] = None,
               subsystems: Optional[set] = None,
               min_sev: int = 0,
               since_seq: int = 0) -> List[dict]:
        """Newest-last matching entries from the ring (the non-follow
        /events response). `n=0` means every ring entry."""
        with self._mu:
            entries = list(self._ring)
        out = [e for e in entries
               if e.get("seq", 0) > since_seq
               and self.entry_matches(e, classes, subsystems, min_sev)]
        return out[-n:] if n else out

    @property
    def seq(self) -> int:
        with self._mu:
            return self._seq

    # -- persistence -------------------------------------------------------

    def attach(self, dir_path: str, node: str = "",
               ring: int = 0, segment_events: int = 0,
               flush_s: float = 0.0, keep_segments: int = 0) -> None:
        """Bind the journal to `.minio.sys/eventlog/` on the first
        local drive: replay surviving segments into the ring, then
        start the background flusher. Idempotent — with several
        in-process nodes (tests) the first boot wins and later ones
        only refresh the node name if it was never set."""
        from . import knobs
        with self._mu:
            if not self.node and node:
                self.node = node
            if self._dir is not None:
                return
            ring = ring or knobs.get_int("MINIO_TPU_EVENTLOG_RING")
            self._segment_events = segment_events or knobs.get_int(
                "MINIO_TPU_EVENTLOG_SEGMENT_EVENTS")
            self._flush_s = flush_s or knobs.get_float(
                "MINIO_TPU_EVENTLOG_FLUSH_S")
            self._keep_segments = keep_segments or knobs.get_int(
                "MINIO_TPU_EVENTLOG_KEEP_SEGMENTS")
            if ring != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=ring)
            os.makedirs(dir_path, exist_ok=True)
            self._dir = dir_path
            self._replay_locked()
            self._stop.clear()
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True,
                name="eventlog-flush")
            self._flusher.start()

    def _segment_paths(self) -> List[str]:
        if self._dir is None:
            return []
        try:
            names = sorted(n for n in os.listdir(self._dir)
                           if n.startswith("seg-")
                           and n.endswith(".json"))
        except OSError:
            return []
        return [os.path.join(self._dir, n) for n in names]

    def _replay_locked(self) -> None:
        """Load surviving segments oldest-first into the ring and move
        seq past anything persisted — a torn segment (crash inside the
        commit window) reads as None and is skipped, serving the
        surviving prefix rather than nothing."""
        from . import atomicfile
        high = self._seq
        for path in self._segment_paths():
            try:
                with open(path, "rb") as f:
                    doc = atomicfile.load_json_doc(f.read())
            except OSError:
                continue
            if not isinstance(doc, dict):
                continue
            events = doc.get("events")
            if not isinstance(events, list):
                continue
            for e in events:
                if isinstance(e, dict):
                    self._ring.append(e)
                    high = max(high, int(e.get("seq", 0) or 0))
        self._seq = high

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(timeout=self._flush_s)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — journal is best-effort
                pass

    def flush(self) -> Optional[str]:
        """Persist pending events as one immutable segment; prune old
        segments past the retention bound. Returns the segment path
        (None when nothing was pending or the journal is detached)."""
        from . import atomicfile, crashpoint
        with self._mu:
            if self._dir is None or not self._pending:
                return None
            pending, self._pending = self._pending, []
            dir_path = self._dir
            keep = self._keep_segments
        doc = {
            "v": 1,
            "first_seq": pending[0].get("seq", 0),
            "last_seq": pending[-1].get("seq", 0),
            "events": pending,
        }
        path = os.path.join(dir_path,
                            _SEGMENT_FMT % doc["first_seq"])
        # the commit window: a crash here must leave either the old
        # segment set or the new one, never a torn segment the replay
        # would choke on (write_atomic's rename is the commit point)
        crashpoint.hit("eventlog.persist.segment",
                       segment=os.path.basename(path))
        atomicfile.write_atomic(
            path, (json.dumps(doc) + "\n").encode())
        paths = self._segment_paths()
        for old in paths[:max(0, len(paths) - keep)]:
            try:
                os.unlink(old)
            except OSError:
                pass
        return path

    def close(self) -> None:
        """Stop the flusher and persist what is pending (clean
        shutdown; SIGKILL relies on the flush cadence instead)."""
        self._stop.set()
        self._kick.set()
        t = self._flusher
        if t is not None and t.is_alive():
            t.join(timeout=5)
        try:
            self.flush()
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            pass

    def detach(self) -> None:
        """Close, then forget the directory, the ring and the node name,
        as the end of a process would: the next ``attach`` replays the
        persisted segments. The port's cluster calls it when the last
        node of the process shuts down (the reference's journal lives
        until its process ends)."""
        self.close()
        with self._mu:
            self._dir = None
            self._flusher = None
            self._ring.clear()
            self._pending = []
            self._seq = 0
            self.node = ""

    # -- streaming (the /events?follow=1 surface) --------------------------

    @staticmethod
    def _pump_peer(it, q: "queue.Queue", stop: threading.Event) -> None:
        """Reader thread for one peer event subscription: forwards
        entries into the merge queue until the stream ends or the
        consumer stops. A full queue drops (a slow follow client must
        not apply backpressure to a peer's hub)."""
        try:
            for entry in it:
                if stop.is_set():
                    return
                try:
                    q.put_nowait(entry)
                except queue.Full:
                    pass
        finally:
            it.close()

    def stream(self, max_entries: int = 0, idle_timeout: float = 10.0,
               follow: bool = False, classes: Optional[set] = None,
               subsystems: Optional[set] = None, min_sev: int = 0,
               peer_subs=None, max_s: float = 3600.0,
               backlog: int = 0):
        """JSON-line journal entries as they happen (admin /events).

        Same contract as the trace stream (s3/trace.py):
        `peer_subs` is a CALLABLE resolved lazily at the generator's
        first iteration, so a response abandoned before its first
        chunk never opens a peer subscription it could not unwind;
        each peer iterator gets a daemon pump thread that dies with
        the stream; follow mode emits bare-newline heartbeats that
        double as dead-client probes. `backlog` seeds the stream with
        that many ring entries before going live. Entries are deduped
        by (node, seq) — in-process multi-node tests share one
        journal, so a peer graft would otherwise echo local events."""
        q: "queue.Queue[dict]" = queue.Queue(maxsize=1000)
        stop = threading.Event()

        def gen():
            subs = list(peer_subs() if callable(peer_subs)
                        else peer_subs or [])
            for it in subs:
                threading.Thread(target=self._pump_peer,
                                 args=(it, q, stop), daemon=True,
                                 name="event-follow-peer").start()
            seen: set = set()
            sent = 0
            now = time.monotonic()
            deadline = now + max_s if follow else float("inf")
            last_entry = now
            last_beat = now
            try:
                with self.hub.subscribe() as sub:
                    got = self.recent(backlog, classes, subsystems,
                                      min_sev) if backlog else []
                    while time.monotonic() < deadline:
                        for e in got:
                            ident = (e.get("node", ""),
                                     e.get("seq", 0))
                            if ident in seen:
                                continue
                            seen.add(ident)
                            if not self.entry_matches(
                                    e, classes, subsystems, min_sev):
                                continue
                            yield (json.dumps(e) + "\n").encode()
                            # idle counts from the last MATCHED entry
                            # (a filtered stream that never writes
                            # must not live forever)
                            last_entry = now
                            last_beat = now
                            sent += 1
                            if max_entries and sent >= max_entries:
                                return
                        got = []
                        if follow or subs:
                            timeout = 0.25
                        else:
                            timeout = (last_entry + idle_timeout
                                       - time.monotonic())
                            if timeout <= 0:
                                return
                        entry = sub.get(timeout=timeout)
                        if entry is not None:
                            got.append(entry)
                        while True:
                            try:
                                got.append(q.get_nowait())
                            except queue.Empty:
                                break
                        now = time.monotonic()
                        if follow:
                            if now - last_beat >= 1.0:
                                yield b"\n"   # liveness + hangup probe
                                last_beat = now
                        elif now - last_entry >= idle_timeout:
                            return
            finally:
                stop.set()
                for it in subs:
                    it.close()

        return gen()


JOURNAL = EventJournal()


def emit(class_name: str, **attrs) -> Optional[dict]:
    """Module-level emit — what every instrumented site calls
    (``eventlog.emit("drive.suspect", pool=0, ...)``)."""
    return JOURNAL.emit(class_name, **attrs)


_ONCE: set = set()
_ONCE_MU = threading.Lock()


def emit_once(class_name: str, **attrs) -> Optional[dict]:
    """Emit deduplicated by (class, attrs) for the process lifetime —
    for per-call decision points (device declines, codec fallbacks)
    where the FIRST occurrence is the signal and a per-request stream
    would drown the ring."""
    key = (class_name, tuple(sorted(attrs.items())))
    with _ONCE_MU:
        if key in _ONCE:
            return None
        _ONCE.add(key)
    return JOURNAL.emit(class_name, **attrs)
