"""S3 HTTP server — wire transport for the handler layer.

Counterpart of minio_tpu/s3/server.py. The reference's L1 frontend (cmd/http/, cmd/routers.go) is an epoll Go
server with a middleware chain; here :class:`S3Server` mounts one of
two transports over the same ``S3ApiHandlers``:

  * the **event-loop edge** (``s3/edge/``, default) — parses headers on
    an asyncio loop, holds idle keep-alive connections for near-zero
    cost, and admits each request through the unified
    ``AdmissionController`` before any body byte is read;
  * the **threaded frontend** (``MINIO_TPU_EDGE=off``, and always for
    TLS listeners) — a thread-per-connection stdlib server kept as the
    escape hatch and correctness oracle.

Both feed the same request snapshot through the same middleware
(``edge/dispatch.py``), which checks the extra routers (the admin,
health and metrics routers, and the internode storage, lock, peer and
bootstrap RPC a distributed node mounts with ``register_router``) before
S3 routing. Streaming: response bodies may be chunk iterators (GET path
never buffers the whole object). ``iam`` (an IAMSys) authorises every S3
verb by action; the cluster boot passes it.
"""

from __future__ import annotations

import ssl
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import knobs
from . import signature as sig
from .credentials import Credentials
from .edge import EdgeServer
from .edge.dispatch import finalize_headers, run_request
from .handlers import HTTPResponse, RequestContext, S3ApiHandlers

SERVER_NAME = "MinIO-TPU"


class _DeepBacklogServer(ThreadingHTTPServer):
    """socketserver's default listen backlog is 5: a burst of concurrent
    clients overflows the accept queue and gets connection resets (the
    reference listener accepts with a deep backlog too). The depth is
    the MINIO_TPU_REQUEST_QUEUE knob (shared with the edge listeners)."""
    daemon_threads = True

    def __init__(self, *a, **kw):
        self.request_queue_size = knobs.get_int("MINIO_TPU_REQUEST_QUEUE")
        super().__init__(*a, **kw)


class _BodyReader:
    """Content-Length-bounded request-body reader that can drain what the
    handler left unread (keep-alive connection hygiene)."""

    def __init__(self, raw, length: int):
        self.raw = raw
        self.remaining = max(length, 0)

    def read(self, n: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        if n is None or n < 0 or n > self.remaining:
            n = self.remaining
        chunk = self.raw.read(n)
        self.remaining -= len(chunk)
        return chunk

    def readinto(self, b) -> int:
        """Zero-copy into the caller's buffer (the PUT hot loop reads
        straight into its encode buffer through here)."""
        if self.remaining <= 0:
            return 0
        mv = memoryview(b)
        if len(mv) > self.remaining:
            mv = mv[:self.remaining]
        n = self.raw.readinto(mv) or 0
        self.remaining -= n
        return n

    def drain(self) -> None:
        while self.remaining > 0:
            if not self.read(min(self.remaining, 1 << 16)):
                break


def _make_handler_class(api: S3ApiHandlers, extra_routers):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = SERVER_NAME

        def log_message(self, fmt, *args):  # silence default stderr log
            pass

        def _snapshot(self) -> RequestContext:
            parsed = urllib.parse.urlsplit(self.path)
            query = urllib.parse.parse_qs(parsed.query,
                                          keep_blank_values=True)
            headers = {k.lower(): v for k, v in self.headers.items()}
            req = sig.Request(method=self.command, path=parsed.path,
                              query=query, headers=headers,
                              raw_query=parsed.query)
            length = int(headers.get("content-length", 0) or 0)
            ctx = RequestContext(req, _BodyReader(self.rfile, length),
                                 length)
            ctx.remote_addr = self.client_address[0]
            ctx.secure = isinstance(self.connection, ssl.SSLSocket)
            return ctx

        def _respond(self, resp: HTTPResponse) -> None:
            # CORS reflection + framing policy shared with the edge
            # (cmd/generic-handlers.go corsHandler)
            chunked, wants_close = finalize_headers(
                api, self.headers.get("Origin"), resp, self.command)
            if wants_close:
                # honor a handler-requested close (load shedding): the
                # socket is being torn down, so the dispatch loop must
                # also skip draining the request body
                self.close_connection = True
            body = resp.body
            self.send_response(resp.status)
            for k, v in resp.headers.items():
                self.send_header(k, v)
            if chunked:
                self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            if self.command == "HEAD":
                if resp.stream is not None:
                    resp.stream.close()
                return
            try:
                if resp.stream is not None:
                    if chunked:
                        for chunk in resp.stream:
                            if chunk:
                                self.wfile.write(
                                    f"{len(chunk):x}\r\n".encode()
                                    + chunk + b"\r\n")
                        self.wfile.write(b"0\r\n\r\n")
                    else:
                        for chunk in resp.stream:
                            self.wfile.write(chunk)
                elif body:
                    self.wfile.write(body)
            except BrokenPipeError:
                pass
            finally:
                if resp.stream is not None:
                    # releases the admission slot a streaming response
                    # holds, even when the client hung up mid-body
                    close = getattr(resp.stream, "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:  # noqa: BLE001
                            pass

        def _dispatch(self) -> None:
            # chunked request bodies have no Content-Length: without
            # decoding them we can't find the next request's boundary,
            # so reject and close (prevents request smuggling)
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                self.close_connection = True
                body = (b'<?xml version="1.0" encoding="UTF-8"?>'
                        b"<Error><Code>NotImplemented</Code><Message>"
                        b"Transfer-Encoding: chunked is not supported"
                        b"</Message></Error>")
                self.send_response(501)
                self.send_header("Content-Type", "application/xml")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)
                return
            try:
                int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                self.close_connection = True
                self.send_response(400)
                self.send_header("Content-Length", "0")
                self.send_header("Connection", "close")
                self.end_headers()
                return
            ctx = self._snapshot()
            # telemetry + the admission-gated handler live in the
            # transport-shared middleware (edge/dispatch.py)
            run_request(api, extra_routers, ctx, self.command, self.path,
                        self._respond, caller=self.client_address[0])
            # keep-alive hygiene: any request-body bytes the handler
            # didn't consume (auth failure, early error, streaming
            # trailer) would otherwise be parsed as the next request.
            # Skipped when the connection is closing anyway (shed
            # responses) — draining a multi-GiB body into a closing
            # socket is exactly the load shedding exists to avoid.
            if not self.close_connection:
                ctx.body_stream.drain()

        def do_OPTIONS(self):
            # CORS preflight
            origin = self.headers.get("Origin", "")
            allow = api.cors_allow_origin
            resp = HTTPResponse(status=200 if (origin and allow) else 403)
            if origin and allow:
                resp.headers.update({
                    "Access-Control-Allow-Origin":
                        origin if allow == "*" else allow,
                    "Access-Control-Allow-Methods":
                        "GET, PUT, POST, DELETE, HEAD",
                    "Access-Control-Allow-Headers":
                        self.headers.get(
                            "Access-Control-Request-Headers", "*"),
                    "Access-Control-Max-Age": "3600",
                })
            self._respond(resp)

        do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _dispatch

    return Handler


class S3Server:
    """S3 endpoint over an object layer — edge or threaded transport.

    extra_routers: list of (path_prefix, fn(ctx) -> HTTPResponse) checked
    before S3 routing — the admin, health and metrics routers
(s3/admin.mount_admin) and the internode RPC routers of a distributed
node.
    """

    def __init__(self, object_layer, address: str = "127.0.0.1",
                 port: int = 0, region: str = "us-east-1",
                 creds: Optional[Credentials] = None, iam=None,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None):
        self.api = S3ApiHandlers(object_layer, region=region, creds=creds,
                                 iam=iam)
        self.extra_routers: list = []
        self.tls = bool(certfile)
        self._httpd = None
        self._edge: Optional[EdgeServer] = None
        # the edge speaks plaintext only today: TLS listeners keep the
        # threaded frontend (README "HTTP edge and admission")
        if knobs.get_bool("MINIO_TPU_EDGE") and not certfile:
            self._edge = EdgeServer(self.api, self.extra_routers,
                                    address, port)
        else:
            self._httpd = _DeepBacklogServer(
                (address, port),
                _make_handler_class(self.api, self.extra_routers))
            if certfile:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.load_cert_chain(certfile, keyfile)
                self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                     server_side=True)
        self._thread: Optional[threading.Thread] = None

    @property
    def edge_enabled(self) -> bool:
        return self._edge is not None

    @property
    def port(self) -> int:
        if self._edge is not None:
            return self._edge.port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        if self._edge is not None:
            host = self._edge._addr[0]
            return f"http://{host}:{self._edge.port}"
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{host}:{port}"

    def register_router(self, prefix: str, fn) -> None:
        self.extra_routers.append((prefix, fn))

    def start(self) -> "S3Server":
        if self._edge is not None:
            self._edge.start()
            return self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._edge is not None:
            self._edge.stop()
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
