"""Per-request middleware shared by BOTH HTTP frontends.

Counterpart of minio_tpu/s3/edge/dispatch.py. The threaded server
(``s3/server.py``) and the event-loop edge (``edge/server.py``) feed the
same request snapshot through this one pipeline — extra-router matching
(the internode RPC routers), ``S3ApiHandlers.handle`` and the per-API
duration, TTFB and response counters —
so the two transports cannot drift: the threaded server stays a
byte-level correctness oracle for the edge (``MINIO_TPU_EDGE=off``).

``api_name_of`` is a copy of minio_tpu/s3/trace.py:34. Left out with the
rest of the trace plane: the root span and the admin trace records.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ...utils import telemetry

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


def run_request(api, extra_routers, ctx, command: str, raw_path: str,
                respond: Callable) -> int:
    """Route + handle one parsed request; ``respond(resp)`` writes it
    on whatever transport owns the socket. Returns the final status.
    ``extra_routers`` are (path prefix, fn(ctx) -> HTTPResponse or None)
    pairs checked before S3 routing, in registration order; a router
    that returns None declines and the next one is asked.
    The per-API histograms record in the finally, the duration covering
    the response body (a streaming GET's drive reads happen inside it).
    Keep-alive body drainage is the transport's job — it depends on close
    semantics only the transport knows."""
    api_name = api_name_of(command, ctx.req.path, ctx.req.query,
                           ctx.req.headers)
    t0 = time.perf_counter()
    status = [500]
    ttfb: list = [None]

    def _respond(resp) -> None:
        status[0] = resp.status
        # TTFB: handler work is done, the status line goes out now —
        # streaming body time lands in the full duration
        if ttfb[0] is None:
            ttfb[0] = time.perf_counter() - t0
        respond(resp)

    try:
        for prefix, router in extra_routers:
            if raw_path.startswith(prefix):
                resp = router(ctx)
                if resp is None:
                    continue
                _respond(resp)
                return status[0]
        _respond(api.handle(ctx))
    finally:
        dur = time.perf_counter() - t0
        _HTTP_DURATION.observe(dur, api=api_name)
        _HTTP_RESPONSES.inc(api=api_name,
                            code_class=f"{status[0] // 100}xx")
        if ttfb[0] is not None:
            _HTTP_TTFB.observe(ttfb[0], api=api_name)
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
