"""The one admission gate — every shed decision is made HERE.

Counterpart of minio_tpu/s3/edge/admission.py. One controller folds the
pre-body signals into ONE verdict issued before any request-body byte is
read:

  * **staging** — the pipeline's staging rings (parallel/pipeline.py
    ``pool_pressure``) reported a timeout within the shed window: new data
    writes would only queue into a stalled pipeline, so they shed
    immediately;
  * **scheduler** — the live ``BatchScheduler`` has more blocks queued for
    device batches than ``MINIO_TPU_ADMIT_SCHED_QUEUE`` (0 = off);
  * **admission** — the RAM/CPU ``maxClients`` budget (reference
    cmd/handler-api.go:46-57) is exhausted and no slot freed within
    ``MINIO_TPU_REQUEST_DEADLINE``;
  * **conns** / **deadline** — edge-only signals (connection budget,
    slowloris header deadline) recorded through the same counter;
  * **tenant** — the multi-tenant QoS plane (``s3/qos.py``, attached by
    the handlers that build it) found the request's tenant over one of
    its budgets: request rate, byte budget, or weighted admission share.
    Off by default; when off the probe is never consulted.

Every shed lands in ``minio_tpu_requests_shed_total{reason}``. Shed
responses are built here too: 503 ``SlowDown`` with a ``Retry-After``
hint and ``Connection: close``.

The exposition-time gauges of the most recently built gate
(``minio_tpu_admission_capacity`` and ``_in_use``) are the reference's.
Each shed emits an ``admission.shed`` journal record and rides its reason
on the response (``shed_reason``) into the request's trace record.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ...utils import eventlog, knobs, telemetry

# requests shed with 503 SlowDown, by trigger: "staging" (BytePool
# exhaustion window), "scheduler" (device-batch queue saturation),
# "admission" (the maxClients budget wait timed out), "conns" (edge
# connection budget), "deadline" (edge header/slowloris deadline)
_SHED_TOTAL = telemetry.REGISTRY.counter(
    "minio_tpu_requests_shed_total",
    "Requests shed with 503 SlowDown, by reason")

# the APIs that stage payload bytes through the BytePool rings —
# metadata ops on object paths (tagging, CompleteMultipartUpload)
# never touch staging, and completing an upload under pressure
# RELIEVES it
_DATA_WRITE_APIS = ("PutObject", "UploadPart", "PostObject")


def _collect_admission_metrics() -> None:
    """Exposition-time gauges for the live gate (no polling thread)."""
    c = _LIVE[0]
    if c is None:
        return
    telemetry.REGISTRY.gauge(
        "minio_tpu_admission_capacity",
        "Size of the maxClients admission gate").set(c.capacity)
    telemetry.REGISTRY.gauge(
        "minio_tpu_admission_in_use",
        "Admission slots currently held by in-flight requests").set(
        c.in_use())


_LIVE: list = [None]        # most-recently constructed controller
telemetry.REGISTRY.register_collector(_collect_admission_metrics)


class ShedDecision:
    """One refused request: the reason label plus everything a
    transport needs to answer it (status, Retry-After, close)."""

    __slots__ = ("reason", "message", "retry_after")

    def __init__(self, reason: str, message: str, retry_after: int = 1):
        self.reason = reason
        self.message = message
        self.retry_after = max(int(retry_after), 1)

    def response(self, path: str = "/"):
        """The 503 SlowDown HTTPResponse every frontend serves for this
        decision — Retry-After + Connection: close semantics are pinned
        identical across the edge and the threaded oracle."""
        import uuid
        # lazy import: handlers imports this module at init
        from .. import xmlgen
        from ..handlers import HTTPResponse
        from ..s3errors import S3Error
        err = S3Error("SlowDown", self.message)
        body = xmlgen.error_response(err.code, err.message, path,
                                     str(uuid.uuid4()))
        resp = HTTPResponse(status=err.status)
        resp.with_xml(body)
        resp.headers["Retry-After"] = str(self.retry_after)
        resp.headers["Connection"] = "close"
        # the middleware's trace record says which signal refused it
        # (the edge's loop-side sheds record directly)
        resp.shed_reason = self.reason
        return resp


class AdmissionTicket:
    """One admitted request's slot. ``release()`` is idempotent — the
    handler's finally AND a streaming response's close both funnel
    here, whichever runs first wins. The ticket binds its semaphore at
    admit time: ``resize()`` may swap the controller's gate mid-request
    and acquire/release must hit the same object."""

    __slots__ = ("_sem", "_released", "_qos", "tenant")

    def __init__(self, sem: Optional[threading.BoundedSemaphore],
                 qos=None, tenant: str = ""):
        self._sem = sem
        self._released = False
        # the QoS slot rides the same ticket: release() returns the
        # tenant's in-flight share exactly once, alongside the budget
        self._qos = qos
        self.tenant = tenant

    def release(self) -> None:
        if not self._released:
            self._released = True
            if self._sem is not None:
                self._sem.release()
            if self._qos is not None and self.tenant:
                self._qos.release(self.tenant)


class AdmissionController:
    """The RAM-budgeted concurrency gate in front of everything.

    ``admit()`` is the full decision (pre-body signals + budget wait);
    ``pre_admit()`` is the non-blocking half the event loop runs inline
    so saturation sheds cost no worker thread. Both run before any body
    byte is read. ``shed()`` records edge-originated refusals (conns,
    deadline) in the same counter family.
    """

    def __init__(self, max_clients: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        # Default is CPU-proportional: each data-path request runs real
        # erasure and hashing work, so admitting far more streams than
        # cores only convoys the GIL and splits the cache working set.
        # The cluster boot overrides this with the full RAM+CPU budget
        # (requests_budget) via resize().
        if max_clients is None:
            max_clients = knobs.get_int("MINIO_TPU_MAX_CLIENTS") \
                or max(4, 4 * (os.cpu_count() or 1))
        self.capacity = max(max_clients, 1)
        self._sem = threading.BoundedSemaphore(self.capacity)
        self.deadline = knobs.get_float("MINIO_TPU_REQUEST_DEADLINE") \
            if deadline_s is None else deadline_s
        # staging-pressure shed window: baselined at construction so
        # pre-existing process-global counters don't trip a fresh
        # controller. The fields race benignly across handler threads
        # and the edge loop (monotonic float/int stores), exactly like
        # the handler-resident window they replaced.
        from ...parallel import pipeline as _pl
        self.shed_window_s = knobs.get_float("MINIO_TPU_SHED_WINDOW_S")
        self._shed_last_exhausted = _pl.pool_pressure()["exhausted"]
        self._shed_until = 0.0
        # scheduler-occupancy signal: the object layer is late-bound by
        # the cluster boot (the controller exists before the drives
        # format); 0 disables the signal
        self.sched_queue_limit = knobs.get_int(
            "MINIO_TPU_ADMIT_SCHED_QUEUE")
        self.layer = None
        # the multi-tenant QoS plane (s3/qos.py), attached by the
        # handlers that own this gate; None = no tenant enforcement
        self.qos = None
        _LIVE[0] = self

    # -- sizing ----------------------------------------------------------

    def resize(self, n: int) -> None:
        """Re-size the gate once topology is known (the reference
        computes maxClients from RAM + drive count)."""
        self.capacity = max(n, 1)
        self._sem = threading.BoundedSemaphore(self.capacity)

    def in_use(self) -> int:
        return self.capacity - self._sem._value

    # -- signal probes ---------------------------------------------------

    @staticmethod
    def is_data_write(method: str, path: str, query: dict,
                      headers: dict) -> bool:
        """True for requests that will stage payload bytes through the
        BytePool rings — the only class the load-pressure signals shed
        (reads and metadata ops are never refused for staging)."""
        if method not in ("PUT", "POST"):
            return False
        if "/" not in path.lstrip("/"):
            return False              # bucket-level op, not a data write
        from .dispatch import api_name_of
        return api_name_of(method, path, query, headers) \
            in _DATA_WRITE_APIS

    def _staging_stalled(self) -> bool:
        """True within the shed window after a BytePool get() timeout:
        the pipeline is stalled, new writes would only queue into the
        wreck — keep the retry loop on the client, where it belongs."""
        from ...parallel import pipeline as _pl
        now = time.monotonic()
        exhausted = _pl.pool_pressure()["exhausted"]
        if exhausted > self._shed_last_exhausted:
            self._shed_last_exhausted = exhausted
            self._shed_until = now + self.shed_window_s
        return now < self._shed_until

    def _scheduler_saturated(self) -> bool:
        """True when the device batch former's queue crossed the knob
        threshold (queued blocks summed over every set's former)."""
        limit = self.sched_queue_limit
        if limit <= 0 or self.layer is None:
            return False
        queued = 0
        layers = getattr(self.layer, "server_sets", None) or [self.layer]
        for z in layers:
            for eng in getattr(z, "sets", ()) or ():
                sched = getattr(eng, "scheduler", None)
                if sched is not None:
                    queued += sched.stats()["queued_blocks"]
                    if queued > limit:
                        return True
        return queued > limit

    # -- the decision ----------------------------------------------------

    def pre_admit(self, method: str, path: str, query: dict,
                  headers: dict) -> Optional[ShedDecision]:
        """The non-blocking half: load-pressure signals that refuse a
        request with ZERO body bytes read and no budget slot taken.
        Cheap enough for the event loop to run inline."""
        if self.qos is not None:
            refusal = self.qos.pre_check(method, path, query, headers)
            if refusal is not None:
                return self.shed("tenant", refusal.message,
                                 refusal.retry_after)
        if not self.is_data_write(method, path, query, headers):
            return None
        if self._staging_stalled():
            retry = self._shed_until - time.monotonic()
            return self.shed(
                "staging", "staging buffers exhausted, retry the request",
                retry_after=-(-retry // 1) if retry > 0 else 1)
        if self._scheduler_saturated():
            return self.shed(
                "scheduler", "device batch queue is saturated, retry "
                "the request")
        return None

    def admit(self, method: str, path: str, query: dict, headers: dict,
              pre_checked: bool = False):
        """The full decision: pre-body signals, then the maxClients
        budget (bounded wait — saturated slots shed with 503, never
        wedge every caller forever). Returns an AdmissionTicket or a
        ShedDecision; either way no body byte has been read."""
        if not pre_checked:
            shed = self.pre_admit(method, path, query, headers)
            if shed is not None:
                return shed
        tenant = ""
        if self.qos is not None:
            got = self.qos.admit_slot(method, path, query, headers,
                                      self.capacity)
            if not isinstance(got, str):
                return self.shed("tenant", got.message, got.retry_after)
            tenant = got
        sem = self._sem
        if not sem.acquire(timeout=self.deadline):
            if tenant:
                self.qos.release(tenant)
            return self.shed("admission",
                             "server is busy, retry the request")
        return AdmissionTicket(sem, qos=self.qos if tenant else None,
                               tenant=tenant)

    def shed(self, reason: str, message: str,
             retry_after: int = 1) -> ShedDecision:
        """Record one refusal (the ONLY requests_shed_total increment
        site in the tree) and hand back the decision to serve."""
        _SHED_TOTAL.inc(reason=reason)
        eventlog.emit("admission.shed", reason=reason)
        return ShedDecision(reason, message, retry_after)
