"""ScanEngine: the SelectObjectContent seam between the card and the CPU
evaluator.

Counterpart of minio_tpu/scan/engine.py. ``event_stream(req, data)``
answers a Select as ``s3select.select.event_stream`` does: compile the
predicate (scan/plan.py) and flatten it for the kernel
(ops/scan_program.py), tokenize pages (scan/pager.py), and evaluate them
on the engine's device, through the batch former's ``scan`` verb when a
former is attached (concurrent Selects of one plan coalesce into one
launch) or in one call of scan/kernels.run_batch otherwise. The device
decides which rows pass and the COUNT sums; the passing rows are then
serialized by the evaluator's own `_emit` and `frame_records` over the
same row dicts, so the framed response is the evaluator's byte for byte.

Semantic declines go to the CPU evaluator with identical output, each
counted in ``minio_tpu_scan_fallbacks_total{reason}``: the plan
(compile_plan's labels, and "program-depth" for a program deeper than
the kernel's stacks), the pages (build_pages' labels),
"sql-error", "too-large", "declined" (the former closed), "no-device"
(MINIO_TPU_SCAN_DEVICE=off), and "error" for input the CPU path turns
into an S3 error (bad JSON, a corrupt GZIP/BZIP2 stream).

Departure from the reference, which answers from the CPU on any
exception: a failure of the kernel's build or launch, or of a scan
dispatch, raises, and the Select fails (a 500 through the handlers)
instead of being answered by the evaluator. So the device work runs when
event_stream is called, before the first frame, and only the serializing
of frames is left to the returned iterator.

Metrics (the port's registry): minio_tpu_scan_requests_total{path},
minio_tpu_scan_fallbacks_total{reason}, minio_tpu_scan_pages_total,
minio_tpu_scan_rows_total, minio_tpu_scan_seconds{path}. Stage seconds
(utils/stagetimer): select.rows, select.pages, select.dispatch,
select.emit (records and framing). The rows and pages of a device scan
run in the reference's ``scan.page`` span, and each decline reason emits
one ``device.decline`` record (stage "scan") per process.
"""

from __future__ import annotations

import csv as _csv
import threading
import time
import zlib
from typing import Iterator

import numpy as np

from .. import device as device_mod
from ..ops import scan_program
from ..s3.s3errors import S3Error
from ..s3select import select as sel
from ..s3select import sql as _sql
from ..utils import eventlog, knobs, stagetimer, telemetry
from . import kernels, pager
from .plan import Decline, compile_plan

#: device-path input cap: the pages and row dicts take many times the
#: raw bytes, so larger objects go to the CPU evaluator
MAX_SCAN_BYTES = knobs.get_int("MINIO_TPU_SCAN_MAX_BYTES")

# what the readers raise on bad input; the CPU path reproduces each as the
# client's error, so the device path declines them
_INPUT_ERRORS = (S3Error, ValueError, OSError, EOFError, zlib.error,
                 _csv.Error)


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_scan_requests_total",
                    "SelectObjectContent requests by serving path"),
        reg.counter("minio_tpu_scan_fallbacks_total",
                    "Device-scan declines by reason (request fell back "
                    "to the CPU evaluator, output identical)"),
        reg.counter("minio_tpu_scan_pages_total",
                    "Tokenized pages submitted to the scan verb"),
        reg.counter("minio_tpu_scan_rows_total",
                    "Records scanned through the device path"),
        reg.histogram("minio_tpu_scan_seconds",
                      "SelectObjectContent wall time by serving path"),
    )


class ScanEngine:
    """Routes Select requests between the device and the CPU evaluator.
    One per server; `scheduler` is the shared batch former (None: each
    request launches on its own), `device` where the kernel runs (None:
    the card)."""

    def __init__(self, scheduler=None, device=None):
        self.scheduler = scheduler
        self.device = device
        self._m = _metrics()
        # handler threads finish Selects at once: a bare += on the stats
        # can lose counts between its read and its write
        self._mu = threading.Lock()
        self.device_serves = 0
        self.fallbacks = 0
        self.fallback_reasons: dict[str, int] = {}

    # -- public seam -------------------------------------------------------

    def event_stream(self, req, data: bytes) -> Iterator[bytes]:
        """The SelectObjectContent response body. The device work runs
        now; the returned iterator yields the frames."""
        t0 = time.monotonic()
        try:
            frames = self._try_device(req, data)
        except Decline as d:
            self._count_fallback(d.reason)
            return self._host(req, data, t0)
        return self._served(frames, t0)

    def stats(self) -> dict:
        with self._mu:
            return {"device_serves": self.device_serves,
                    "fallbacks": self.fallbacks,
                    "fallback_reasons": dict(self.fallback_reasons)}

    # -- paths -------------------------------------------------------------

    def _host(self, req, data: bytes, t0: float) -> Iterator[bytes]:
        yield from sel.event_stream(req, data)
        self._m[0].inc(path="fallback")
        self._m[4].observe(time.monotonic() - t0, path="fallback")

    def _served(self, frames, t0: float) -> Iterator[bytes]:
        yield from frames
        with self._mu:
            self.device_serves += 1
        self._m[0].inc(path="device")
        self._m[4].observe(time.monotonic() - t0, path="device")

    def _count_fallback(self, reason: str) -> None:
        with self._mu:
            self.fallbacks += 1
            self.fallback_reasons[reason] = \
                self.fallback_reasons.get(reason, 0) + 1
        self._m[1].inc(reason=reason)
        eventlog.emit_once("device.decline", stage="scan", reason=reason)

    def _try_device(self, req, data: bytes):
        """The device-served frame iterator, or Decline. Everything that
        decides the response happens here, before the first frame."""
        mode = knobs.get_str("MINIO_TPU_SCAN_DEVICE").lower()
        if mode in ("off", "0", "false", "no"):
            raise Decline("no-device")
        try:
            q = _sql.parse(req.expression)
        except _sql.SQLError:
            raise Decline("sql-error") from None   # CPU raises properly
        plan = compile_plan(q, req.input_format, req.json_type)
        program = scan_program.program_for(plan)
        with telemetry.span("scan.page", fmt=req.input_format):
            with stagetimer.stage("select.rows"):
                try:
                    payload = sel._decompress(data, req.compression)
                    if len(payload) > MAX_SCAN_BYTES:
                        raise Decline("too-large")
                    if req.input_format == "JSON":
                        rows = list(sel._rows_json(payload, req))
                    else:
                        rows = list(sel._rows_csv(payload, req))
                except _INPUT_ERRORS:
                    raise Decline("error") from None
            with stagetimer.stage("select.pages"):
                pages = pager.build_pages(rows, plan)
        with stagetimer.stage("select.dispatch"):
            mask, counts = self._run_pages(pages, program)
        self._m[2].inc(pages.n_pages)
        self._m[3].inc(pages.n_rows)
        rowmask = mask.reshape(-1)[:pages.n_rows]
        totals = counts.sum(axis=0, dtype=np.int64)
        return self._frames(req, q, plan, rows, rowmask, totals, data)

    def _run_pages(self, pages, program):
        """(mask [B, R], counts [B, K]) of one request's pages, through the
        batch former (coalescing with concurrent requests) or one launch
        of its own. A failed dispatch raises."""
        if self.scheduler is not None:
            out = self.scheduler.submit_scan(
                device_mod.resolve(self.device), pages, program).result()
            if out is None:
                raise Decline("declined")
            return out
        return kernels.run_batch(pages.plan, pages.arrays, self.device)

    # -- byte-identical emission -------------------------------------------

    def _records(self, req, q, plan, rows, rowmask, totals
                 ) -> Iterator[bytes]:
        """Serialized output records: run_select's loop with the WHERE
        decision replaced by the device mask."""
        try:
            if plan.counts is not None:
                yield sel._emit(self._count_result(q, plan, totals), req)
                return
            emitted = 0
            for i in np.flatnonzero(rowmask):
                row = rows[i]
                if q.star:
                    out = dict(row)
                else:
                    out = {}
                    for j, (e, alias) in enumerate(q.projections):
                        name = alias or (e.name
                                         if isinstance(e, _sql.Col)
                                         else f"_{j + 1}")
                        out[name] = _sql.evaluate(e, row, q.alias)
                yield sel._emit(out, req)
                emitted += 1
                if q.limit is not None and emitted >= q.limit:
                    return
        except _sql.SQLError as e:
            raise S3Error("InvalidArgument", f"SQL: {e}") from None

    @staticmethod
    def _count_result(q, plan, totals) -> dict:
        """The Aggregator.result() dict of a COUNT-only query from the
        device's sums (one per non-None entry of plan.counts, in order)."""
        out = {}
        sums = iter(totals.tolist())
        for i, ((_e, alias), spec) in enumerate(
                zip(q.projections, plan.counts)):
            out[alias or f"_{i + 1}"] = None if spec is None else \
                int(next(sums))
        return out

    def _frames(self, req, q, plan, rows, rowmask, totals, data: bytes
                ) -> Iterator[bytes]:
        """The CPU path's own framing loop over the device-masked
        records; its own seconds (not the consumer's) go to select.emit."""
        frames = sel.frame_records(
            self._records(req, q, plan, rows, rowmask, totals), len(data))
        spent, t = 0.0, time.perf_counter()
        for frame in frames:
            spent += time.perf_counter() - t
            yield frame
            t = time.perf_counter()
        stagetimer.add("select.emit", spent + time.perf_counter() - t)
