"""The bucket event notification plane: the N-th consumer of the ONE
namespace feed.

One listener on the engines' namespace-change feed (wired by
``ErasureServerSets.attach_notifications`` — the lint gate's
hook-coverage chain proves every mutation verb reaches this queue), a
bounded dedup queue of ``(bucket, key)`` events, and a worker pool
that:

  * **classifies** each touched key by reading its CURRENT state (the
    feed carries no verb — like replication, the plane converges from
    what is actually on disk): latest version a delete marker →
    ``s3:ObjectRemoved:DeleteMarkerCreated``; key gone →
    ``s3:ObjectRemoved:Delete``; a transitioned stub →
    ``s3:ObjectTransition:Complete``; a restored copy →
    ``s3:ObjectRestore:Completed``; multipart parts →
    ``s3:ObjectCreated:CompleteMultipartUpload``; else
    ``s3:ObjectCreated:Put``;
  * **filters** through the bucket's `NotificationConfiguration` rules
    (prefix/suffix/event patterns) against the registered target map;
  * **suppresses replica applies** by default (reference parity:
    replication does not re-fire source events at the replica site) —
    the event JSON's ``responseElements`` carries the ORIGIN site id
    and tier name so downstream consumers can tell local writes from
    replica applies when suppression is off;
  * **delivers at-least-once** per target through a durable (or
    in-memory) per-target queue: the record persists BEFORE the send
    (crashpoint ``notify.queue.persist`` pins the kill/replay window),
    failures open a per-target offline window and feed an MRF-style
    retry queue with capped exponential backoff, and a periodic
    redrive sweep guarantees a bounded outage drains with zero loss;
  * **yields to the foreground**: workers throttle off the shared
    foreground-pressure probe — a dead webhook never backs up the PUT
    hot path (``bench.py --ab-notify`` pins the p99 bound);
  * on multi-node clusters, only the bucket's OWNER node (rendezvous
    hash over the membership set) delivers: non-owners forward the
    event over the peer control plane (falling back to local delivery
    when the owner is unreachable — a duplicate beats a lost event).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import urllib.parse
import uuid as _uuid
from collections import OrderedDict, deque
from typing import Optional

from ..object import api_errors
from ..object.background import MRFHealer
from ..replicate.targets import is_replica, origin_of
from ..storage.datatypes import (TRANSITION_TIER_KEY, is_restored,
                                 is_transitioned)
from ..utils import crashpoint, eventlog, knobs, telemetry
from ..utils.pressure import ForegroundPressure
from .rules import BucketNotifyConfig, NotifyRuleError
from .targets import NotifyTargetRegistry

WORKERS = knobs.get_int("MINIO_TPU_NOTIFY_WORKERS")
QUEUE_SIZE = knobs.get_int("MINIO_TPU_NOTIFY_QUEUE")
BACKOFF_S = knobs.get_float("MINIO_TPU_NOTIFY_BACKOFF_S")
BACKOFF_MAX_S = knobs.get_float("MINIO_TPU_NOTIFY_BACKOFF_MAX_S")
BACKOFF_TRIES = knobs.get_int("MINIO_TPU_NOTIFY_BACKOFF_TRIES")

_LAG_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_notify_sent_total",
                    "Event records delivered to notification targets"),
        reg.counter("minio_tpu_notify_failed_total",
                    "Event deliveries that failed (kept in the "
                    "per-target queue, retried with backoff)"),
        reg.counter("minio_tpu_notify_dropped_total",
                    "Event records dropped at a full per-target queue "
                    "(bounded backlog: overflow drops, never blocks)"),
        reg.histogram("minio_tpu_notify_lag_seconds",
                      "Delivery lag: send completion minus the "
                      "namespace event's enqueue time",
                      buckets=_LAG_BUCKETS),
    )


def render_record(event_name: str, bucket: str, key: str, *,
                  region: str = "us-east-1", size: int = 0,
                  etag: str = "", version_id: str = "",
                  mod_time: float = 0.0, origin_site: str = "",
                  tier: str = "", node: str = "") -> dict:
    """The reference S3 event record (pkg/event/event.go shape), plus
    ``responseElements`` origin metadata: ``x-minio-origin-site`` (the
    site the version was originally written at) and ``x-minio-tier``
    (the remote tier of a transitioned/restored version)."""
    t = mod_time or time.time()
    now = time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime())
    return {"Records": [{
        "eventVersion": "2.0", "eventSource": "minio:s3",
        "awsRegion": region, "eventTime": now, "eventName": event_name,
        "userIdentity": {"principalId": "minio"},
        "requestParameters": {"sourceIPAddress": node or "127.0.0.1"},
        "responseElements": {
            "x-amz-request-id": _uuid.uuid4().hex[:16].upper(),
            "x-minio-origin-node": node,
            "x-minio-origin-site": origin_site,
            "x-minio-tier": tier},
        "s3": {"s3SchemaVersion": "1.0", "configurationId": "Config",
               "bucket": {"name": bucket,
                          "ownerIdentity": {"principalId": "minio"},
                          "arn": f"arn:aws:s3:::{bucket}"},
               "object": {"key": urllib.parse.quote(key),
                          "size": size, "eTag": etag,
                          "versionId": version_id,
                          "sequencer": format(int(t * 1e9), "016X")}},
    }]}


class _MemoryStore:
    """The in-memory twin of the durable per-target queue (same API:
    put/get/delete/keys) for embedders without a queue directory."""

    def __init__(self, limit: int):
        self.limit = limit
        self._mu = threading.Lock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()

    def put(self, record: dict) -> Optional[str]:
        with self._mu:
            if len(self._entries) >= self.limit:
                return None
            key = f"{time.time_ns():020d}-{_uuid.uuid4().hex[:8]}"
            self._entries[key] = record
            return key

    def get(self, key: str) -> Optional[dict]:
        with self._mu:
            return self._entries.get(key)

    def delete(self, key: str) -> None:
        with self._mu:
            self._entries.pop(key, None)

    def keys(self) -> list[str]:
        with self._mu:
            return sorted(self._entries)


def _owner_of(bucket: str, nodes: list[str]) -> str:
    """Rendezvous (highest-random-weight) hash: every node computes the
    same owner from the same membership set, and a membership change
    only moves the buckets that hashed to the lost/added node."""
    return max(nodes, key=lambda n: hashlib.sha1(
        f"{bucket}\x00{n}".encode()).digest())


class NotificationPlane:
    """One node's notification engine (queue + workers + retry)."""

    def __init__(self, object_layer, registry: NotifyTargetRegistry,
                 bucket_meta=None, region: str = "us-east-1",
                 queue_dir: Optional[str] = None,
                 node: str = "", nodes: Optional[list[str]] = None,
                 site_id: str = "",
                 workers: Optional[int] = None,
                 queue_size: Optional[int] = None,
                 busy_fn=None, throttle_s: Optional[float] = None):
        self.obj = object_layer
        self.registry = registry
        # bucket metadata system carrying notification_xml; embedders
        # without one (bench, unit tests) use set_config() instead
        self.bucket_meta = bucket_meta
        self.region = region
        self.queue_dir = queue_dir
        self.node = node
        self.nodes = sorted(nodes or [])
        self.site_id = site_id
        # injected by the cluster: forward one event to the bucket's
        # owner node over the peer control plane; returns True when the
        # owner accepted it
        self.forward_fn = None
        # injected by the cluster: broadcast a registry reload to every
        # peer after an admin target mutation (their boot-time loads
        # would otherwise serve a stale target map)
        self.reload_peers = None
        self._pressure = ForegroundPressure(object_layer, busy_fn=busy_fn)
        self._throttle_base = BACKOFF_S if throttle_s is None \
            else throttle_s
        self.queue_size = QUEUE_SIZE if queue_size is None else queue_size
        self.store_limit = knobs.get_int("MINIO_TPU_NOTIFY_STORE_LIMIT")
        self.offline_s = knobs.get_float("MINIO_TPU_NOTIFY_OFFLINE_S")
        self.replica_events = knobs.get_bool(
            "MINIO_TPU_NOTIFY_REPLICA_EVENTS")
        self._cond = threading.Condition()
        self._queue: deque = deque()   # (bucket, key, enq_t, owned)
        self._pending: set[tuple[str, str]] = set()
        self._inflight = 0
        self._stores: dict[str, object] = {}
        self._offline_until: dict[str, float] = {}
        self._local_xml: dict[str, str] = {}
        self._cfg_cache: dict[str, tuple[str, BucketNotifyConfig]] = {}
        self._target_stats: dict[str, dict] = {}
        self._stop = threading.Event()
        # stats (admin surface / tests)
        self.queued = 0
        self.delivered = 0
        self.failed_sends = 0
        self.dropped = 0
        self.suppressed = 0            # replica applies (default off)
        self.forwarded = 0             # handed to the owner node
        self.fallback_local = 0        # owner unreachable: sent here
        # failed deliveries retry here with capped exponential backoff
        # — the fault plane's queue, the backlog redrive as its heal fn
        self.mrf = MRFHealer(heal_fn=self._mrf_retry)
        self._threads = []
        for i in range(WORKERS if workers is None else workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"notify-{i}")
            t.start()
            self._threads.append(t)
        self._redrive_thread = threading.Thread(
            target=self._redrive_loop, daemon=True, name="notify-redrive")
        self._redrive_thread.start()
        # replay whatever the last process left in the durable queues
        self.redrive()

    # -- the namespace-feed listener ------------------------------------

    def on_namespace_change(self, bucket: str, key: str) -> None:
        """Enqueue one namespace event; never blocks (bounded queue,
        overflow drops + counts)."""
        if bucket.startswith(".") or not key:
            return
        if self._config(bucket) is None:
            return
        self._enqueue(bucket, key, owned=False)

    def ingest(self, bucket: str, key: str) -> None:
        """Peer-forwarded event (this node owns the bucket): enqueue
        for local delivery, no ownership re-resolution (divergent
        membership views must not ping-pong an event)."""
        if bucket.startswith(".") or not key:
            return
        self._enqueue(bucket, key, owned=True)

    def _enqueue(self, bucket: str, key: str, owned: bool) -> None:
        with self._cond:
            if self._stop.is_set() or (bucket, key) in self._pending:
                return
            if len(self._queue) >= self.queue_size:
                self.dropped += 1
                return
            self._pending.add((bucket, key))
            self._queue.append((bucket, key, time.time(), owned))
            self.queued += 1
            self._cond.notify_all()

    # -- per-bucket configuration ---------------------------------------

    def set_config(self, bucket: str, xml: str) -> None:
        """Static rule injection for embedders without a bucket
        metadata system (bench, unit tests)."""
        self._local_xml[bucket] = xml

    def _config(self, bucket: str) -> Optional[BucketNotifyConfig]:
        xml = None
        if self.bucket_meta is not None:
            try:
                xml = self.bucket_meta.get(bucket).notification_xml
            except Exception:  # noqa: BLE001 — meta unavailable: no rules
                return None
        else:
            xml = self._local_xml.get(bucket)
        if not xml:
            return None
        cached = self._cfg_cache.get(bucket)
        if cached is not None and cached[0] == xml:
            return cached[1]
        try:
            cfg = BucketNotifyConfig.from_xml(xml)
        except NotifyRuleError:
            return None
        self._cfg_cache[bucket] = (xml, cfg)
        return cfg

    # -- ownership -------------------------------------------------------

    def owner_of(self, bucket: str) -> str:
        if len(self.nodes) <= 1:
            return self.node
        return _owner_of(bucket, self.nodes)

    # -- lifecycle / observability ---------------------------------------

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self.mrf.close()

    def stats(self) -> dict:
        with self._cond:
            out = {"pending": len(self._queue) + self._inflight,
                   "queued": self.queued, "delivered": self.delivered,
                   "failed": self.failed_sends, "dropped": self.dropped,
                   "suppressed": self.suppressed,
                   "forwarded": self.forwarded,
                   "fallback_local": self.fallback_local}
        out["backlog"] = sum(len(self._store(a).keys())
                             for a in self.registry.arns())
        out["retry"] = self.mrf.stats()
        return out

    def _target_entry(self, arn: str) -> dict:
        # caller holds self._cond
        entry = self._target_stats.get(arn)
        if entry is None:
            entry = self._target_stats[arn] = {
                "delivered": 0, "failed": 0,
                "last_delivery": 0.0, "last_lag_s": None}
        return entry

    def target_status(self) -> dict:
        """Per-target delivery health for the admin plane: durable
        backlog depth, offline-window state, last delivery timestamp,
        last observed lag, cumulative delivered/failed — the JSON twin
        of ``minio_tpu_notify_lag_seconds{target}``."""
        now = time.monotonic()
        with self._cond:
            entries = {arn: dict(st)
                       for arn, st in self._target_stats.items()}
            offline = dict(self._offline_until)
        out: dict = {}
        for arn in sorted(self.registry.arns()):
            st = entries.get(arn) or {
                "delivered": 0, "failed": 0,
                "last_delivery": 0.0, "last_lag_s": None}
            st["backlog"] = len(self._store(arn).keys())
            st["offline"] = offline.get(arn, 0.0) > now
            out[arn] = st
        return out

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until the event queue, the retry queue AND every
        per-target backlog are empty. Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return False
                self._cond.wait(remaining)
        while time.monotonic() < deadline and not self._stop.is_set():
            self.mrf.drain(max(
                min(1.0, deadline - time.monotonic()), 0.001))
            if not any(self._store(a).keys()
                       for a in self.registry.arns()):
                return True
            self.redrive()
            time.sleep(0.02)
        return not any(self._store(a).keys()
                       for a in self.registry.arns())

    # -- workers ----------------------------------------------------------

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stop.is_set() and not self._queue:
                    self._cond.wait()
                if self._stop.is_set():
                    return
                bucket, key, enq_t, owned = self._queue.popleft()
                self._pending.discard((bucket, key))
                self._inflight += 1
            try:
                self._pressure.throttle(self._stop, self._throttle_base,
                                        BACKOFF_MAX_S, BACKOFF_TRIES)
                if not self._stop.is_set():
                    self._route(bucket, key, enq_t, owned)
            except Exception:  # noqa: BLE001 — feed is best-effort;
                pass           # per-target failures already queued
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _route(self, bucket: str, key: str, enq_t: float,
               owned: bool) -> None:
        if not owned:
            owner = self.owner_of(bucket)
            if owner and owner != self.node:
                if self.forward_fn is not None \
                        and self.forward_fn(owner, bucket, key):
                    with self._cond:
                        self.forwarded += 1
                    return
                # owner unreachable: deliver here — a duplicate at the
                # consumer beats an event lost to a dead peer
                with self._cond:
                    self.fallback_local += 1
        self._process(bucket, key, enq_t)

    # -- classification ----------------------------------------------------

    def classify(self, bucket: str, key: str):
        """Derive the S3 event name from the key's CURRENT state (the
        feed carries no verb). Returns (event_name, latest ObjectInfo
        or None when the key is gone)."""
        try:
            versions = self.obj.object_versions(bucket, key)
        except api_errors.ObjectApiError:
            versions = []
        if not versions:
            return "s3:ObjectRemoved:Delete", None
        latest = max(versions, key=lambda o: (o.mod_time or 0,
                                              o.version_id or ""))
        if latest.delete_marker:
            return "s3:ObjectRemoved:DeleteMarkerCreated", latest
        md = latest.user_defined or {}
        if is_transitioned(md):
            if is_restored(md):
                return "s3:ObjectRestore:Completed", latest
            return "s3:ObjectTransition:Complete", latest
        if len(latest.parts or []) > 1:
            return "s3:ObjectCreated:CompleteMultipartUpload", latest
        return "s3:ObjectCreated:Put", latest

    def _process(self, bucket: str, key: str, enq_t: float) -> None:
        event_name, info = self.classify(bucket, key)
        md = (info.user_defined or {}) if info is not None else {}
        if is_replica(md) and not self.replica_events:
            # reference parity: a replica apply never re-fires the
            # source event at the replica site
            with self._cond:
                self.suppressed += 1
            return
        cfg = self._config(bucket)
        if cfg is None:
            return
        arns = cfg.match(event_name, key) & self.registry.arns()
        if not arns:
            return
        record = render_record(
            event_name, bucket, key, region=self.region,
            size=(info.size or 0) if info is not None else 0,
            etag=(info.etag or "") if info is not None else "",
            version_id=(info.version_id or "")
            if info is not None else "",
            mod_time=(info.mod_time or 0.0)
            if info is not None else 0.0,
            origin_site=origin_of(md, self.site_id),
            tier=md.get(TRANSITION_TIER_KEY, ""), node=self.node)
        for arn in sorted(arns):
            self._deliver(arn, record, enq_t)

    # -- delivery ----------------------------------------------------------

    def _store(self, arn: str):
        with self._cond:
            store = self._stores.get(arn)
            if store is not None:
                return store
        if self.queue_dir is not None:
            from ..features.events import QueueStore
            safe = "".join(c if c.isalnum() or c in "-_." else "_"
                           for c in arn)
            store = QueueStore(os.path.join(self.queue_dir, safe),
                               limit=self.store_limit)
        else:
            store = _MemoryStore(self.store_limit)
        with self._cond:
            return self._stores.setdefault(arn, store)

    def _deliver(self, arn: str, record: dict, enq_t: float) -> None:
        _sent_c, _failed_c, dropped_c, _lag_h = _metrics()
        store = self._store(arn)
        ekey = store.put({"record": record, "t": enq_t})
        if ekey is None:
            # bounded backlog: overflow drops (and counts) rather than
            # growing without bound against a dead target
            with self._cond:
                self.dropped += 1
            dropped_c.inc(target=arn)
            eventlog.emit("notify.drop", target=arn)
            return
        # the record is durable and the target has not seen it: a kill
        # here must redrive exactly this entry after restart
        crashpoint.hit("notify.queue.persist")
        if self._offline_until.get(arn, 0.0) > time.monotonic():
            # offline window: don't burn a timeout per event against a
            # target that just failed — the retry queue probes it
            self.mrf.enqueue("notify", arn)
            return
        self._send_entry(arn, store, ekey)

    def _send_entry(self, arn: str, store, ekey: str) -> bool:
        entry = store.get(ekey)
        if entry is None:
            store.delete(ekey)          # torn/corrupt entry
            return True
        try:
            self.registry.sender(arn).send(entry["record"])
        except Exception:  # noqa: BLE001 — per-target isolation; the
            # durable entry stays put and the retry queue re-drives
            self._note_failure(arn)
            self.mrf.enqueue("notify", arn)
            return False
        store.delete(ekey)
        self._note_sent(arn, entry.get("t", 0.0))
        return True

    def _note_sent(self, arn: str, enq_t: float) -> None:
        sent_c, _failed_c, _dropped_c, lag_h = _metrics()
        lag = max(time.time() - (enq_t or time.time()), 0.0)
        with self._cond:
            self.delivered += 1
            entry = self._target_entry(arn)
            entry["delivered"] += 1
            entry["last_delivery"] = time.time()
            entry["last_lag_s"] = round(lag, 3)
            self._offline_until.pop(arn, None)
        sent_c.inc(target=arn)
        lag_h.observe(lag, target=arn)

    def _note_failure(self, arn: str) -> None:
        _sent_c, failed_c, _dropped_c, _lag_h = _metrics()
        with self._cond:
            self.failed_sends += 1
            self._target_entry(arn)["failed"] += 1
            was_online = self._offline_until.get(arn, 0.0) \
                <= time.monotonic()
            self._offline_until[arn] = time.monotonic() + self.offline_s
        failed_c.inc(target=arn)
        if was_online:
            eventlog.emit("notify.offline", target=arn)

    # -- retry / redrive ---------------------------------------------------

    def _mrf_retry(self, _bucket: str, arn: str, _version: str) -> None:
        """The retry queue's heal fn: redrive one target's WHOLE
        backlog, oldest first; a failure re-raises so the queue backs
        off, MRF-style."""
        try:
            self.registry.get(arn)
        except api_errors.ObjectApiError:
            return                      # target removed: converged
        store = self._store(arn)
        delivered = 0
        for ekey in store.keys():
            entry = store.get(ekey)
            if entry is None:
                store.delete(ekey)
                continue
            try:
                self.registry.sender(arn).send(entry["record"])
            except Exception:
                self._note_failure(arn)
                raise
            store.delete(ekey)
            self._note_sent(arn, entry.get("t", 0.0))
            delivered += 1
        if delivered:
            eventlog.emit("notify.redrive", target=arn,
                          delivered=delivered)

    def redrive(self) -> int:
        """Queue a retry for every target with persisted backlog
        (startup replay + the periodic sweep). Returns how many targets
        were queued."""
        n = 0
        for arn in self.registry.arns():
            if self._store(arn).keys():
                if self.mrf.enqueue("notify", arn):
                    n += 1
        return n

    def _redrive_loop(self) -> None:
        interval = knobs.get_float("MINIO_TPU_NOTIFY_REDRIVE_S")
        while not self._stop.wait(interval):
            try:
                self.redrive()
            except Exception:  # noqa: BLE001 — sweep is best-effort
                pass
