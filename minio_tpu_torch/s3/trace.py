"""HTTP request tracing and audit logging.

A copy of minio_tpu/s3/trace.py, nothing left out, with one departure:
the audit worker exits once its queue has stayed empty for AUDIT_IDLE_S,
and the next entry starts another (the reference's worker lives as long
as its process, so every server that ever shipped an entry, in a process
that boots and shuts down nodes, keeps an idle thread). The reference wraps
every route in httpTraceAll (cmd/http-tracer.go), publishes trace entries
to pkg/pubsub for `mc admin trace` (the admin ``trace`` route and its peer
fan-out), and ships structured audit entries to webhook targets
(cmd/logger/audit.go). Here: the record the edge middleware writes for
each request (method, path, status, duration, caller, API name, trace
id, TTFB, shed reason), a ring that peers pull, a hub that follow streams
subscribe to, and the audit webhook that config KV's ``audit_webhook``
sets.

Audit shipping runs on one bounded-queue worker thread: a full queue drops
the entry and counts it (``minio_tpu_audit_dropped_total``).
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request
from typing import Optional

from ..utils import telemetry
from ..utils.pubsub import PubSub

AUDIT_IDLE_S = 1.0     # an idle audit worker exits after this

_AUDIT_DROPPED = telemetry.REGISTRY.counter(
    "minio_tpu_audit_dropped_total",
    "Audit entries dropped because the webhook queue was full")


def api_name_of(method: str, path: str, query: dict,
                headers: Optional[dict] = None) -> str:
    """Best-effort S3 API name for one request (the reference tags
    every route with its api name in the router; here the label is
    derived at the HTTP edge so the per-API latency histograms need no
    plumbing through 60 handlers). Unrecognized calls fall into a
    small set of coarse buckets rather than exploding label
    cardinality."""
    headers = headers or {}
    p = path.lstrip("/")
    if path.startswith("/minio/admin"):
        return "Admin"
    if path.startswith("/minio/health"):
        return "Health"
    if path.startswith("/minio/prometheus"):
        return "Metrics"
    if path.startswith("/minio/storage"):
        return "StorageRPC"
    if path.startswith(("/minio/peer", "/minio/lock")):
        return "PeerRPC"
    if path.startswith("/minio/"):
        return "WebUI"
    parts = p.split("/", 1)
    bucket = parts[0]
    key = parts[1] if len(parts) > 1 else ""
    if not bucket:
        return "ListBuckets" if method == "GET" else "STS" \
            if method == "POST" else method
    if key:
        if method == "GET":
            if "uploadId" in query:
                return "ListParts"
            if "tagging" in query:
                return "GetObjectTagging"
            return "GetObject"
        if method == "HEAD":
            return "HeadObject"
        if method == "PUT":
            if "partNumber" in query:
                return "UploadPartCopy" \
                    if "x-amz-copy-source" in headers else "UploadPart"
            if "tagging" in query:
                return "PutObjectTagging"
            if "x-amz-copy-source" in headers:
                return "CopyObject"
            return "PutObject"
        if method == "POST":
            if "uploads" in query:
                return "CreateMultipartUpload"
            if "uploadId" in query:
                return "CompleteMultipartUpload"
            return "PostObject"
        if method == "DELETE":
            if "uploadId" in query:
                return "AbortMultipartUpload"
            return "DeleteObject"
        return method
    # bucket-level
    if method == "GET":
        if "versions" in query:
            return "ListObjectVersions"
        if "uploads" in query:
            return "ListMultipartUploads"
        if query.get("list-type") == ["2"] or \
                query.get("list-type") == "2":
            return "ListObjectsV2"
        sub = next((q for q in ("location", "versioning", "policy",
                                "tagging", "lifecycle", "encryption",
                                "object-lock", "replication",
                                "notification", "events") if q in query),
                   None)
        return f"GetBucket{sub.title().replace('-', '')}" if sub \
            else "ListObjectsV1"
    if method == "PUT":
        return "MakeBucket" if not query else "PutBucketConfig"
    if method == "HEAD":
        return "HeadBucket"
    if method == "DELETE":
        return "DeleteBucket" if not query else "DeleteBucketConfig"
    if method == "POST":
        if "delete" in query:
            return "DeleteMultipleObjects"
        return "PostPolicy"
    return method


class TraceSys:
    def __init__(self, node_name: str = "", ring_size: int = 200,
                 audit_queue_size: int = 512):
        from collections import deque
        self.hub = PubSub()
        self.node = node_name
        self.audit_webhook: str = ""           # POST target for audit
        self.requests_total = 0
        self.errors_total = 0
        self.audit_dropped = 0
        # recent-entry ring: peers pull this for cluster-wide trace
        # (the reference streams over peer REST; a pull ring is the
        # polling equivalent)
        self.recent: "deque[dict]" = deque(maxlen=ring_size)
        self._mu = threading.Lock()
        self._audit_q: "queue.Queue[dict]" = queue.Queue(
            maxsize=audit_queue_size)
        self._audit_worker: Optional[threading.Thread] = None

    # -- middleware --------------------------------------------------------

    def record(self, method: str, path: str, query: str, status: int,
               duration_s: float, caller: str = "",
               api: str = "", trace_id: str = "",
               ttfb_s: Optional[float] = None,
               shed_reason: str = "", tenant: str = "") -> None:
        entry = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "node": self.node,
            "api": api,
            "method": method,
            "path": path,
            "query": query,
            "status": status,
            "duration_ms": round(duration_s * 1e3, 3),
            "caller": caller,
        }
        if ttfb_s is not None:
            entry["ttfb_ms"] = round(ttfb_s * 1e3, 3)
        if shed_reason:
            # which admission signal refused this request (staging /
            # scheduler / admission / conns / deadline) — the trace
            # stream's answer to "why is my client seeing 503s"
            entry["shed_reason"] = shed_reason
        if tenant:
            # the QoS tenant the request resolved to (plane on only) —
            # lets `mc admin trace` split traffic per tenant
            entry["tenant"] = tenant
        if trace_id:
            # the span-tree key: `mc admin trace` output joins to the
            # /minio/admin/v3/spans dump through this id
            entry["trace_id"] = trace_id
        with self._mu:
            self.requests_total += 1
            if status >= 500:
                self.errors_total += 1
            # the ring is read concurrently by the admin trace/cluster
            # pull — mutate it under the same lock as the counters
            self.recent.append(entry)
        if self.hub.subscriber_count:
            self.hub.publish(entry)
        if self.audit_webhook:
            self._enqueue_audit(entry)

    # -- audit worker ------------------------------------------------------

    def _enqueue_audit(self, entry: dict) -> None:
        try:
            self._audit_q.put_nowait(entry)
        except queue.Full:
            with self._mu:
                self.audit_dropped += 1
            _AUDIT_DROPPED.inc()
            return
        if self._audit_worker is None or not self._audit_worker.is_alive():
            with self._mu:
                if self._audit_worker is None or \
                        not self._audit_worker.is_alive():
                    self._audit_worker = threading.Thread(
                        target=self._audit_loop, daemon=True,
                        name="audit-ship")
                    self._audit_worker.start()

    def _audit_loop(self) -> None:
        while True:
            try:
                entry = self._audit_q.get(timeout=AUDIT_IDLE_S)
            except queue.Empty:
                # idle: exit, unless an entry landed meanwhile (the
                # enqueue side starts a new worker once this one is gone)
                with self._mu:
                    if self._audit_q.empty():
                        self._audit_worker = None
                        return
                continue
            try:
                self._ship_audit(entry)
            except Exception:  # noqa: BLE001 — audit is best-effort
                pass

    def _ship_audit(self, entry: dict) -> None:
        try:
            req = urllib.request.Request(
                self.audit_webhook, data=json.dumps(entry).encode(),
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=3.0) as r:
                r.read()
        except Exception:  # noqa: BLE001 — audit is best-effort
            pass

    # -- admin streaming endpoint -----------------------------------------

    @staticmethod
    def entry_matches(entry: dict, apis: Optional[set] = None,
                      errors_only: bool = False) -> bool:
        """The /trace endpoint's filter semantics (`mc admin trace
        --api ... --errors` analog): `apis` keeps only those API names,
        `errors_only` keeps failed calls (HTTP >= 400)."""
        if apis and entry.get("api") not in apis:
            return False
        if errors_only and int(entry.get("status", 0) or 0) < 400:
            return False
        return True

    @staticmethod
    def _pump_peer(it, q: "queue.Queue", stop: threading.Event) -> None:
        """Reader thread for one peer trace subscription: forwards
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
               follow: bool = False, apis: Optional[set] = None,
               errors_only: bool = False, peer_subs=None,
               max_s: float = 3600.0):
        """JSON-line trace entries as they happen (admin /trace).

        Default mode ends after `idle_timeout` with no traffic or
        `max_entries` sent. `follow` mode is the
        `mc admin trace` analog: a long-lived stream that survives idle
        windows by emitting bare-newline heartbeats — which double as
        the disconnect detector: a dead client's next heartbeat write
        fails, unwinding the whole subscription (peers included)
        instead of leaking a worker. `peer_subs` grafts every node's
        records into this one stream: a CALLABLE returning the peer
        iterators (PeerRPCClient trace_stream) — called lazily at the
        generator's first iteration, so a response abandoned before
        its first chunk (client reset during the head write) never
        opens a peer subscription it could not unwind; each iterator
        gets a daemon pump thread that dies with the stream. `max_s`
        hard-caps a FOLLOW stream's life (non-follow keeps its
        idle/count bounds)."""
        q: "queue.Queue[dict]" = queue.Queue(maxsize=1000)
        stop = threading.Event()

        def gen():
            subs = list(peer_subs() if callable(peer_subs)
                        else peer_subs or [])
            for it in subs:
                threading.Thread(target=self._pump_peer,
                                 args=(it, q, stop), daemon=True,
                                 name="trace-follow-peer").start()
            sent = 0
            now = time.monotonic()
            deadline = now + max_s if follow else float("inf")
            last_entry = now
            last_beat = now
            try:
                with self.hub.subscribe() as sub:
                    while time.monotonic() < deadline:
                        got = []
                        if follow or subs:
                            # heartbeat cadence / peer-queue drain
                            # need sub-second wakeups
                            timeout = 0.25
                        else:
                            # plain bounded stream: block the whole
                            # remaining idle window in ONE get (no
                            # 4 Hz wakeup churn on an idle server)
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
                        for e in got:
                            if not self.entry_matches(e, apis,
                                                      errors_only):
                                continue
                            yield (json.dumps(e) + "\n").encode()
                            # idle counts from the last MATCHED entry:
                            # steady non-matching traffic must not
                            # keep a filtered non-follow stream (which
                            # never writes, so never detects a dead
                            # client) alive forever
                            last_entry = now
                            last_beat = now
                            sent += 1
                            if max_entries and sent >= max_entries:
                                return
                        if follow:
                            if now - last_beat >= 1.0:
                                yield b"\n"       # liveness + hangup probe
                                last_beat = now
                        elif now - last_entry >= idle_timeout:
                            return
            finally:
                stop.set()
                for it in subs:
                    it.close()

        return gen()
