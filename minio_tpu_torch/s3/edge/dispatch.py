"""Per-request middleware shared by BOTH HTTP frontends.

Counterpart of minio_tpu/s3/edge/dispatch.py; nothing is left out. The
threaded server (``s3/server.py``) and the event-loop edge
(``edge/server.py``) feed the same request snapshot through this one
pipeline (the root span, extra-router matching, ``S3ApiHandlers.handle``,
the per-API duration, TTFB and response counters, the admin trace
record), so the two transports cannot drift: the threaded server stays a
byte-level correctness oracle for the edge (``MINIO_TPU_EDGE=off``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ...utils import telemetry
from ..trace import api_name_of

# per-API request latency + time-to-first-byte (reference
# cmd/metrics.go httpRequestsDuration, labelled by api name)
_HTTP_DURATION = telemetry.REGISTRY.histogram(
    "minio_tpu_http_requests_duration_seconds",
    "Full HTTP request latency (headers to last body byte) per API")
_HTTP_TTFB = telemetry.REGISTRY.histogram(
    "minio_tpu_http_ttfb_seconds",
    "Time to first response byte per API")
# status-class outcomes per API
_HTTP_RESPONSES = telemetry.REGISTRY.counter(
    "minio_tpu_http_responses_total",
    "HTTP responses per API and status class (2xx/3xx/4xx/5xx)")


def run_request(api, extra_routers, ctx, command: str, raw_path: str,
                respond: Callable, caller: str = "") -> int:
    """Route + handle one parsed request; ``respond(resp)`` writes it
    on whatever transport owns the socket. Returns the final status.

    Everything observable rides along: the root span covers routing,
    the handler AND the response body (a streaming GET's drive reads
    happen inside it); per-API histograms and the admin trace ring
    record in the finally. Keep-alive body drainage is the transport's
    job — it depends on close semantics only the transport knows.
    """
    api_name = api_name_of(command, ctx.req.path, ctx.req.query,
                           ctx.req.headers)
    t0 = time.perf_counter()
    status = [500]
    ttfb: list = [None]
    root_holder: list = [None]
    shed_reason = [""]

    def _respond(resp) -> None:
        status[0] = resp.status
        shed_reason[0] = getattr(resp, "shed_reason", "")
        # TTFB: handler work is done, the status line goes out now —
        # streaming body time lands in the full duration
        if ttfb[0] is None:
            ttfb[0] = time.perf_counter() - t0
        if resp.long_poll and root_holder[0] is not None:
            # an idle event stream runs for minutes by design — never
            # "slow"
            root_holder[0].slow_exempt = True
        respond(resp)

    trace_id = ""
    try:
        with telemetry.trace(api_name, method=command,
                             path=ctx.req.path) as root:
            root_holder[0] = root
            if api_name in ("Admin", "Health", "Metrics", "WebUI"):
                # admin surfaces stream on purpose (`mc admin trace`
                # idles for its whole window): keeping them as "slow"
                # would crowd the spans ring with content-free trees.
                # Errors still keep.
                root.slow_exempt = True
            trace_id = root.trace_id
            for prefix, router in extra_routers:
                if raw_path.startswith(prefix):
                    resp = router(ctx)
                    if resp is None:
                        # router declined (e.g. the web UI owns only
                        # exact paths under /minio/): keep matching
                        # later-registered routers
                        continue
                    _respond(resp)
                    if resp.status >= 500:
                        root.error = f"http {resp.status}"
                    return status[0]
            _respond(api.handle(ctx))
            if status[0] >= 500:
                root.error = f"http {status[0]}"
    finally:
        dur = time.perf_counter() - t0
        try:
            _HTTP_DURATION.observe(dur, api=api_name)
            _HTTP_RESPONSES.inc(api=api_name,
                                code_class=f"{status[0] // 100}xx")
            if ttfb[0] is not None:
                _HTTP_TTFB.observe(ttfb[0], api=api_name)
        except Exception:  # noqa: BLE001 — telemetry is passive
            pass
        if api.trace is not None:
            try:
                api.trace.record(command, ctx.req.path,
                                 ctx.req.raw_query, status[0], dur,
                                 caller=caller, api=api_name,
                                 trace_id=trace_id, ttfb_s=ttfb[0],
                                 shed_reason=shed_reason[0],
                                 tenant=getattr(ctx, "tenant", ""))
            except Exception:  # noqa: BLE001 — tracing is passive
                pass
    return status[0]


def finalize_headers(api, origin: Optional[str], resp,
                     command: str) -> tuple[bool, bool]:
    """Transport-independent response-header policy, applied in place:
    CORS reflection, Content-Length vs chunked framing. Returns
    (chunked, close_connection) so both frontends frame and tear down
    identically."""
    allow = api.cors_allow_origin
    if origin and allow and \
            "Access-Control-Allow-Origin" not in resp.headers:
        resp.headers["Access-Control-Allow-Origin"] = (
            origin if allow == "*" else allow)
        resp.headers["Access-Control-Expose-Headers"] = (
            "ETag, x-amz-version-id, x-amz-request-id")
    chunked = resp.stream is not None and \
        "Content-Length" not in resp.headers
    close = resp.headers.get("Connection", "").lower() == "close"
    if resp.stream is None and "Content-Length" not in resp.headers:
        resp.headers["Content-Length"] = str(len(resp.body))
    return chunked, close
