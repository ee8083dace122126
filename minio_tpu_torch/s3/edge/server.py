"""Event-loop HTTP frontend (the reference's cmd/http/ epoll listener).

Counterpart of minio_tpu/s3/edge/server.py. The extra routers (the
internode RPC a distributed node mounts) bypass both halves of admission,
and a saturated worker pool gives a job a one-shot overflow thread rather
than queueing it, so a peer's storage or lock verb is never starved by
S3 requests that themselves wait on peers. The reference's counters
(``minio_tpu_edge_accepted_total``, ``_requests_total``) and
exposition-time gauges of the last edge built (``open_conns`` and the
worker pool's ``pool_size``, ``pool_busy``, ``pool_idle``,
``pool_pending``) are exported; each loop also counts its own accepts and
requests (``accepted``, ``requests``). The loop-lag sampler is the
reference's (``minio_tpu_edge_loop_lag_seconds``), with the ``loop``
label's value ``<listener port>:<loop index>`` (the reference's is the
index alone) so that the loops of several nodes in one process stay
apart, ticking every ``LAG_INTERVAL_S`` rather than at the reference's
``MINIO_TPU_EDGE_LAG_S`` (one value in use); each loop also keeps its
recent samples (``lag_samples``).

``stop()`` returns only once no loop accepts or serves and no worker runs
a request: it shuts down the sockets of requests in flight (a worker
blocked in a body read or a response write wakes at once) and waits for
their workers, where the reference's stop closes those sockets and joins
its pool for at most two seconds a thread, so that a request it stopped
could still commit after it returned.

One (or ``MINIO_TPU_EDGE_WORKERS``, via ``SO_REUSEPORT``) asyncio loop
owns every connection: it accepts, parses request lines + headers, and
holds idle keep-alive connections for the cost of a socket + a small
state object — no thread per connection, so tens of thousands of
mostly-idle clients fit where the threaded frontend held hundreds.

The loop never blocks and never reads a body byte:

  * a connection over the ``MINIO_TPU_EDGE_MAX_CONNS`` budget is shed
    (503, ``Connection: close``) straight from the accept callback;
  * a partial request line/header set that misses the
    ``MINIO_TPU_EDGE_HEADER_S`` deadline (slowloris) is shed the same
    way — a shed, not a stuck thread;
  * a complete header block runs ``AdmissionController.pre_admit``
    inline (staging window + scheduler occupancy — pure arithmetic)
    and sheds saturated data writes without occupying a worker;
  * an admitted request is handed, socket and all, to a bounded pool
    of worker threads where the unchanged blocking handler layer runs.
    The ``maxClients`` budget wait happens there, still before any
    body byte is read. Admitted bodies then read zero-copy
    (``recv_into``) through ``_EdgeBodyReader`` into whatever buffer
    the PUT pipeline hands down — the pinned staging rings of
    parallel/bpool.py, from which the batch is copied to the card.

After the response the socket returns to the loop for the next
keep-alive request (pipelined bytes carry over); shed and error paths
close. The threaded frontend (``MINIO_TPU_EDGE=off``) remains the
correctness oracle — both run the same middleware
(``edge/dispatch.py``), so behavior can only differ at the transport.
"""

from __future__ import annotations

import asyncio
import collections
import queue
import socket
import threading
import urllib.parse
from http.client import responses as _REASONS
from typing import Optional

from ...utils import knobs, telemetry
from .admission import AdmissionController
from .dispatch import finalize_headers, run_request

SERVER_NAME = "MinIO-TPU"
MAX_HEADER_BYTES = 64 << 10        # request line + headers cap
MAX_HEADER_COUNT = 100             # http.server's _MAXHEADERS parity
_RECV = 1 << 16
# how long stop() waits for the workers of requests in flight
STOP_WAIT_S = 30.0

_ACCEPTED_TOTAL = telemetry.REGISTRY.counter(
    "minio_tpu_edge_accepted_total",
    "Connections accepted by the event-loop frontend")
_REQUESTS_TOTAL = telemetry.REGISTRY.counter(
    "minio_tpu_edge_requests_total",
    "Requests parsed and dispatched by the event-loop frontend")

# the lag sampler's tick, seconds
LAG_INTERVAL_S = 1.0

# event-loop health: how late the loop runs a timer it armed — the one
# number that says "the loop thread is wedged behind a callback"
_LOOP_LAG_SECONDS = telemetry.REGISTRY.histogram(
    "minio_tpu_edge_loop_lag_seconds",
    "Event-loop timer lag per loop (scheduled vs actual fire time)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5))


def _collect_edge_metrics() -> None:
    srv = _LIVE[0]
    if srv is None:
        return
    g = telemetry.REGISTRY.gauge
    g("minio_tpu_edge_open_conns",
      "Connections currently held by the event-loop frontend").set(
        srv.conn_count())
    st = srv.pool.stats()
    g("minio_tpu_edge_pool_size",
      "Bounded worker-pool capacity behind the event loop").set(
        st["size"])
    g("minio_tpu_edge_pool_busy",
      "Edge worker threads currently running a request").set(
        st["busy"])
    g("minio_tpu_edge_pool_idle",
      "Edge worker threads parked waiting for work").set(st["idle"])
    g("minio_tpu_edge_pool_pending",
      "Jobs queued for the edge worker pool, not yet picked up").set(
        st["pending"])


_LIVE: list = [None]
telemetry.REGISTRY.register_collector(_collect_edge_metrics)


def _http_date() -> str:
    from email.utils import formatdate
    return formatdate(usegmt=True)


class _WorkerPool:
    """Bounded-then-elastic pool of DAEMON threads running the blocking
    handler layer behind the loop (stdlib ThreadPoolExecutor threads are
    non-daemon: a handler still blocked on a socket at shutdown would
    wedge interpreter exit). Threads spawn lazily up to `size`; when
    every pooled worker is busy a job gets a one-shot overflow thread
    instead of queueing, degrading to the threaded frontend's
    thread-per-request behaviour: in a distributed cluster an S3 request
    holds its worker while it waits on peers' storage verbs, and a
    queued peer verb would deadlock two nodes waiting on each other."""

    def __init__(self, size: int, name: str = "edge-worker"):
        self.size = max(size, 1)
        self._name = name
        self._q: "queue.Queue" = queue.Queue()
        self._mu = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._idle = 0
        self._pending = 0       # jobs queued, not yet picked up
        self._closed = False

    def submit(self, fn, *args) -> None:
        with self._mu:
            if self._closed:
                return
            # a queued-but-unpicked job consumes an idle worker's
            # credit, so two racing submits cannot both bank on the
            # same idle worker
            credits = self._idle - self._pending
            if credits <= 0 and len(self._threads) >= self.size:
                # pool saturated: one-shot overflow thread (exits with
                # the job; never parked in the pool)
                threading.Thread(target=self._run_one, args=(fn, args),
                                 daemon=True,
                                 name=f"{self._name}-ovf").start()
                return
            if credits <= 0:
                t = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"{self._name}-{len(self._threads)}")
                self._threads.append(t)
            else:
                t = None
            self._pending += 1
        self._q.put((fn, args))
        if t is not None:
            t.start()

    @staticmethod
    def _run_one(fn, args) -> None:
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — per-request isolation
            pass

    def _run(self) -> None:
        while True:
            with self._mu:
                self._idle += 1
            job = self._q.get()
            with self._mu:
                self._idle -= 1
                if job is not None:
                    self._pending -= 1
            if job is None:
                return
            fn, args = job
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — per-request isolation;
                pass           # the request's own error paths answered

    def stats(self) -> dict:
        """Live pool occupancy for the exposition-time collector."""
        with self._mu:
            threads = len(self._threads)
            return {"size": self.size, "threads": threads,
                    "idle": self._idle, "pending": self._pending,
                    "busy": max(threads - self._idle, 0)}

    def close(self, join_s: float = 2.0) -> None:
        with self._mu:
            self._closed = True
            threads = list(self._threads)
        for _ in threads:
            self._q.put(None)
        for t in threads:
            t.join(timeout=join_s)   # daemons: a stuck handler can't
            # wedge shutdown, and stop() already closed its socket


class _EdgeBodyReader:
    """Content-Length-bounded blocking request-body reader over the
    loop's leftover header buffer + the raw socket. ``readinto`` is the
    zero-copy seam: the PUT hot loop reads straight into its pinned
    staging buffer through here. Bytes buffered past the body are the
    next pipelined request — ``leftover()`` hands them back to the
    loop."""

    def __init__(self, sock: socket.socket, buf: bytearray, length: int):
        self._sock = sock
        self._buf = buf
        self.remaining = max(length, 0)

    def read(self, n: int = -1) -> bytes:
        """File-like semantics (the threaded frontend reads through a
        BufferedReader): return exactly `n` bytes unless the stream
        ends early — handlers call read_body(content_length) ONCE."""
        if self.remaining <= 0:
            return b""
        if n is None or n < 0 or n > self.remaining:
            n = self.remaining
        out = bytearray()
        if self._buf:
            take = min(n, len(self._buf))
            out += self._buf[:take]
            del self._buf[:take]
        while len(out) < n:
            try:
                chunk = self._sock.recv(min(n - len(out), _RECV))
            except OSError:
                break
            if not chunk:
                break
            out += chunk
        self.remaining -= len(out)
        return bytes(out)

    def readinto(self, b) -> int:
        """Zero-copy fill of the caller's buffer (full unless EOF —
        BufferedReader.readinto parity for the PUT hot loop)."""
        if self.remaining <= 0:
            return 0
        mv = memoryview(b)
        if len(mv) > self.remaining:
            mv = mv[:self.remaining]
        got = 0
        if self._buf:
            take = min(len(mv), len(self._buf))
            mv[:take] = self._buf[:take]
            del self._buf[:take]
            got = take
        while got < len(mv):
            try:
                n = self._sock.recv_into(mv[got:]) or 0
            except OSError:
                break
            if not n:
                break
            got += n
        self.remaining -= got
        return got

    def drain(self) -> None:
        while self.remaining > 0:
            if not self.read(min(self.remaining, _RECV)):
                break

    def leftover(self) -> bytes:
        return bytes(self._buf)


class _Conn:
    """One connection's loop-side state."""

    __slots__ = ("sock", "addr", "buf", "timer", "closed")

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.buf = bytearray()
        self.timer = None
        self.closed = False


class _EdgeLoop(threading.Thread):
    """One event loop + its listener (SO_REUSEPORT shards accepts across
    loops when MINIO_TPU_EDGE_WORKERS > 1)."""

    def __init__(self, edge: "EdgeServer", lsock: socket.socket,
                 idx: int):
        super().__init__(daemon=True, name=f"edge-loop-{idx}")
        self.edge = edge
        self.lsock = lsock
        self.idx = idx
        self.label = f"{lsock.getsockname()[1]}:{idx}"
        # this loop's own counts (the families above sum every loop)
        self.accepted = 0
        self.requests = 0
        self.loop = asyncio.new_event_loop()
        self.conns: set = set()
        self._started = threading.Event()
        self.lag_samples: collections.deque = collections.deque(
            maxlen=4096)
        self._lag_expected = 0.0

    def _arm_lag_sampler(self) -> None:
        """Periodic loop-lag probe: schedule a timer, measure how late
        the loop ran it. A blocking call on the loop, GC pauses and CPU
        starvation all show up as lag here."""
        interval = LAG_INTERVAL_S
        label = self.label

        def tick() -> None:
            if self.edge.closed:
                return
            now = self.loop.time()
            lag = max(now - self._lag_expected, 0.0)
            _LOOP_LAG_SECONDS.observe(lag, loop=label)
            self.lag_samples.append(lag)
            self._lag_expected = now + interval
            self.loop.call_later(interval, tick)

        self._lag_expected = self.loop.time() + interval
        self.loop.call_later(interval, tick)

    # -- lifecycle -------------------------------------------------------

    def run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.lsock.setblocking(False)
        self.loop.add_reader(self.lsock.fileno(), self._accept)
        self._arm_lag_sampler()
        self._started.set()
        try:
            self.loop.run_forever()
        finally:
            for conn in list(self.conns):
                self._close(conn)
            try:
                self.loop.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    def start_and_wait(self) -> None:
        self.start()
        self._started.wait(5.0)

    def stop(self) -> None:
        def _shutdown():
            try:
                self.loop.remove_reader(self.lsock.fileno())
            except Exception:  # noqa: BLE001 — already removed
                pass
            for conn in list(self.conns):
                self._close(conn)
            self.loop.stop()

        try:
            self.loop.call_soon_threadsafe(_shutdown)
        except RuntimeError:
            pass                    # loop already closed
        self.join(timeout=5.0)

    # -- accept ----------------------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self.lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            if self.edge.closed:
                sock.close()
                return
            if self.edge.conn_count() >= self.edge.max_conns:
                # over the connection budget: shed BEFORE any read —
                # the cheapest possible refusal
                decision = self.edge.admission.shed(
                    "conns", "connection budget exhausted, retry")
                self.edge.record_shed("", "/", decision)
                sock.setblocking(False)
                conn = _Conn(sock, addr)
                self.edge.track(conn, +1)
                self._send_close_raw(
                    conn, self.edge.render_response(decision.response("/")))
                continue
            sock.setblocking(False)
            conn = _Conn(sock, addr)
            self.conns.add(conn)
            self.edge.track(conn, +1)
            self.accepted += 1
            _ACCEPTED_TOTAL.inc()
            self._arm(conn, b"")

    # -- header read state machine ---------------------------------------

    def _arm(self, conn: _Conn, leftover: bytes) -> None:
        """(Re)register a connection for its next request. Runs on the
        loop thread (workers get here via call_soon_threadsafe)."""
        if conn.closed or self.edge.closed:
            self._close(conn)
            return
        conn.buf = bytearray(leftover)
        try:
            conn.sock.setblocking(False)
            self.loop.add_reader(conn.sock.fileno(), self._readable,
                                 conn)
        except (OSError, ValueError):
            self._close(conn)
            return
        self._set_timer(conn)
        if b"\r\n\r\n" in conn.buf:      # pipelined request complete
            self._maybe_process(conn)

    def _set_timer(self, conn: _Conn) -> None:
        if conn.timer is not None:
            conn.timer.cancel()
        if conn.buf:
            # partial request on the wire: the header deadline turns a
            # slowloris trickle into a shed, not a held resource
            conn.timer = self.loop.call_later(
                self.edge.header_deadline_s, self._on_header_deadline,
                conn)
        else:
            conn.timer = self.loop.call_later(
                self.edge.idle_deadline_s, self._on_idle, conn)

    def _readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        was_empty = not conn.buf
        conn.buf += data
        if was_empty:
            self._set_timer(conn)        # idle -> header deadline
        self._maybe_process(conn)

    def _on_idle(self, conn: _Conn) -> None:
        self._close(conn)                # quiet keep-alive reaping

    def _on_header_deadline(self, conn: _Conn) -> None:
        decision = self.edge.admission.shed(
            "deadline", "request headers not received in time")
        self.edge.record_shed("", "/", decision)
        self._send_close_raw(
            conn, self.edge.render_response(decision.response("/")))

    # -- parse + dispatch --------------------------------------------------

    def _maybe_process(self, conn: _Conn) -> None:
        head, sep, rest = bytes(conn.buf).partition(b"\r\n\r\n")
        # size check BEFORE the completeness check: a final recv chunk
        # can deliver the terminator and blow past the cap in one step
        # (threaded-oracle parity: http.server caps line + count too)
        if len(head) > MAX_HEADER_BYTES or \
                head.count(b"\r\n") > MAX_HEADER_COUNT:
            self._send_close_raw(conn, self.edge.render_simple(
                431, b"", close=True))
            return
        if not sep:
            return
        # the request leaves the loop here: no reader, no timer
        try:
            self.loop.remove_reader(conn.sock.fileno())
        except (OSError, ValueError):
            pass
        if conn.timer is not None:
            conn.timer.cancel()
            conn.timer = None
        parsed = self.edge.parse_head(head)
        if parsed is None:
            self._send_close_raw(conn, self.edge.render_simple(
                400, b"", close=True))
            return
        method, target, version, headers = parsed
        te = headers.get("transfer-encoding", "").lower()
        if "chunked" in te:
            # chunked request bodies have no Content-Length: without
            # decoding them we can't find the next request's boundary,
            # so reject and close (prevents request smuggling) —
            # threaded-frontend parity
            body = (b'<?xml version="1.0" encoding="UTF-8"?>'
                    b"<Error><Code>NotImplemented</Code><Message>"
                    b"Transfer-Encoding: chunked is not supported"
                    b"</Message></Error>")
            self._send_close_raw(conn, self.edge.render_simple(
                501, body, close=True,
                content_type="application/xml"))
            return
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            self._send_close_raw(conn, self.edge.render_simple(
                400, b"", close=True))
            return
        split = urllib.parse.urlsplit(target)
        path = split.path
        query = urllib.parse.parse_qs(split.query,
                                      keep_blank_values=True)
        # the loop-side half of admission: pure-arithmetic saturation
        # signals shed HERE, before a worker or a body byte is spent
        if not self.edge.is_router_path(path) and method != "OPTIONS":
            decision = self.edge.admission.pre_admit(
                method, path, query, headers)
            if decision is not None:
                self.edge.record_shed(method, path, decision,
                                      query=query, headers=headers)
                resp = decision.response(path)
                finalize_headers(self.edge.api, headers.get("origin"),
                                 resp, method)
                self._send_close_raw(conn,
                                     self.edge.render_response(resp))
                return
        self.conns.discard(conn)
        self.requests += 1
        _REQUESTS_TOTAL.inc()
        self.edge.pool.submit(
            self.edge.serve_request, self, conn, method, target, path,
            split.query, query, headers, version, length, rest)

    # -- loop-side writes --------------------------------------------------

    def _send_close_raw(self, conn: _Conn, payload: bytes) -> None:
        """Best-effort non-blocking write of a canned response, then
        close (shed/parse-error paths — tiny payloads)."""
        if conn.timer is not None:
            conn.timer.cancel()
            conn.timer = None
        try:
            self.loop.remove_reader(conn.sock.fileno())
        except (OSError, ValueError):
            pass

        async def _send():
            try:
                await asyncio.wait_for(
                    self.loop.sock_sendall(conn.sock, payload), 5.0)
            except Exception:  # noqa: BLE001 — client gone: close only
                pass
            finally:
                self._close(conn)

        self.loop.create_task(_send())

    def _close(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn.timer is not None:
            conn.timer.cancel()
            conn.timer = None
        try:
            self.loop.remove_reader(conn.sock.fileno())
        except (OSError, ValueError, RuntimeError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn in self.conns:
            self.conns.discard(conn)
        self.edge.track(conn, -1)


class EdgeServer:
    """The asyncio frontend: listeners + loops + the worker pool."""

    def __init__(self, api, extra_routers, address: str = "127.0.0.1",
                 port: int = 0):
        self.api = api
        self.extra_routers = extra_routers
        self.admission: AdmissionController = api.admission
        self.max_conns = knobs.get_int("MINIO_TPU_EDGE_MAX_CONNS")
        self.header_deadline_s = knobs.get_float("MINIO_TPU_EDGE_HEADER_S")
        self.idle_deadline_s = knobs.get_float("MINIO_TPU_EDGE_IDLE_S")
        pool_size = knobs.get_int("MINIO_TPU_EDGE_POOL")
        if pool_size <= 0:
            import os as _os
            pool_size = 8 * (_os.cpu_count() or 1) + 16
        self.pool = _WorkerPool(pool_size)
        self.closed = False
        self._conn_mu = threading.Lock()
        self._conns = 0
        self._live_conns: set = set()
        # requests a worker is serving: stop() waits for them
        self._serving = 0
        self._serving_cv = threading.Condition()

        workers = max(1, knobs.get_int("MINIO_TPU_EDGE_WORKERS"))
        self._socks: list[socket.socket] = []
        for i in range(workers):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if workers > 1:
                # one listener per loop: the kernel shards accepts
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            s.bind((address, port if i == 0 else self.port))
            if i == 0:
                self._addr = s.getsockname()
            s.listen(knobs.get_int("MINIO_TPU_REQUEST_QUEUE"))
            self._socks.append(s)
        self.loops = [_EdgeLoop(self, s, i)
                      for i, s in enumerate(self._socks)]
        _LIVE[0] = self

    # -- lifecycle -------------------------------------------------------

    @property
    def port(self) -> int:
        return self._addr[1]

    def start(self) -> "EdgeServer":
        for lp in self.loops:
            lp.start_and_wait()
        return self

    def stop(self) -> None:
        """Returns once no loop accepts or serves and no worker runs a
        request (bounded by STOP_WAIT_S)."""
        self.closed = True
        for lp in self.loops:
            lp.stop()              # removes the accept reader first
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        # the requests in flight: shutdown (not close) wakes a worker
        # blocked in recv or send on the socket and ends the peer's
        # stream; the worker's _finish then closes it
        with self._conn_mu:
            live = list(self._live_conns)
        for conn in live:
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        with self._serving_cv:
            self._serving_cv.wait_for(lambda: self._serving == 0,
                                      timeout=STOP_WAIT_S)
        with self._conn_mu:
            live = list(self._live_conns)
        for conn in live:
            # a connection a worker handed back to a loop that had
            # already stopped
            try:
                conn.sock.close()
            except OSError:
                pass
        self.pool.close()

    def serving(self) -> int:
        """Requests a worker is serving now."""
        with self._serving_cv:
            return self._serving

    def is_router_path(self, path: str) -> bool:
        return any(path.startswith(prefix)
                   for prefix, _fn in self.extra_routers)

    def record_shed(self, method: str, path: str, decision,
                    query: Optional[dict] = None,
                    headers: Optional[dict] = None) -> None:
        """Trace-record a loop-side refusal (conns/deadline/pre-admit):
        these never reach the middleware, so the `mc admin trace`
        stream would otherwise miss exactly the requests an overloaded
        server refuses. Runs on the loop thread — record() is a lock +
        a ring append, cheap by design."""
        trace = getattr(self.api, "trace", None)
        if trace is None:
            return
        try:
            from ..trace import api_name_of
            api = api_name_of(method, path, query or {}, headers or {}) \
                if method else ""
            trace.record(method, path, "", 503, 0.0, api=api,
                         shed_reason=decision.reason)
        except Exception:  # noqa: BLE001 — tracing is passive
            pass

    def conn_count(self) -> int:
        with self._conn_mu:
            return self._conns

    def track(self, conn: _Conn, delta: int) -> None:
        with self._conn_mu:
            self._conns += delta
            if delta > 0:
                self._live_conns.add(conn)
            else:
                self._live_conns.discard(conn)

    # -- parsing / rendering ---------------------------------------------

    @staticmethod
    def parse_head(head: bytes):
        """(method, target, version, lower-cased headers) or None."""
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, target, version = lines[0].split(" ", 2)
        except (UnicodeDecodeError, ValueError):
            return None
        if not version.startswith("HTTP/1."):
            return None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                return None
            headers[name.strip().lower()] = value.strip()
        return method, target, version, headers

    @staticmethod
    def render_simple(status: int, body: bytes, close: bool = False,
                      content_type: str = "") -> bytes:
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
                f"Server: {SERVER_NAME}\r\nDate: {_http_date()}\r\n"
                f"Content-Length: {len(body)}\r\n")
        if content_type:
            head += f"Content-Type: {content_type}\r\n"
        if close:
            head += "Connection: close\r\n"
        return head.encode("latin-1") + b"\r\n" + body

    @staticmethod
    def render_response(resp) -> bytes:
        """Serialize a non-streaming HTTPResponse (shed/canned paths)."""
        head = (f"HTTP/1.1 {resp.status} "
                f"{_REASONS.get(resp.status, '')}\r\n"
                f"Server: {SERVER_NAME}\r\nDate: {_http_date()}\r\n")
        if "Content-Length" not in resp.headers:
            head += f"Content-Length: {len(resp.body)}\r\n"
        for k, v in resp.headers.items():
            head += f"{k}: {v}\r\n"
        return head.encode("latin-1") + b"\r\n" + resp.body

    # -- the worker half ---------------------------------------------------

    def serve_request(self, lp: _EdgeLoop, conn: _Conn, method: str,
                      target: str, path: str, raw_query: str,
                      query: dict, headers: dict, version: str,
                      length: int, rest: bytes) -> None:
        """Blocking half of one request: budget admission, body,
        handler, response — then back to the loop (keep-alive) or
        close. Counted in ``serving()`` from here to the end, unless
        stop() began first."""
        with self._serving_cv:
            if self.closed:
                refused = True
            else:
                refused = False
                self._serving += 1
        if refused:
            # stop() began after the loop handed this request over
            self._finish(lp, conn, None, True)
            return
        try:
            self._serve(lp, conn, method, target, path, raw_query, query,
                        headers, version, length, rest)
        finally:
            with self._serving_cv:
                self._serving -= 1
                self._serving_cv.notify_all()

    def _serve(self, lp: _EdgeLoop, conn: _Conn, method: str,
               target: str, path: str, raw_query: str, query: dict,
               headers: dict, version: str, length: int,
               rest: bytes) -> None:
        from .. import signature as sig
        from ..handlers import HTTPResponse, RequestContext
        from .admission import AdmissionTicket

        sock = conn.sock
        ticket = None
        close_conn = [version.startswith("HTTP/1.0")
                      and headers.get("connection", "").lower()
                      != "keep-alive"
                      or headers.get("connection", "").lower() == "close"]
        try:
            sock.setblocking(True)
            if method == "OPTIONS":
                # CORS preflight (threaded do_OPTIONS parity)
                origin = headers.get("origin", "")
                allow = self.api.cors_allow_origin
                resp = HTTPResponse(
                    status=200 if (origin and allow) else 403)
                if origin and allow:
                    resp.headers.update({
                        "Access-Control-Allow-Origin":
                            origin if allow == "*" else allow,
                        "Access-Control-Allow-Methods":
                            "GET, PUT, POST, DELETE, HEAD",
                        "Access-Control-Allow-Headers": headers.get(
                            "access-control-request-headers", "*"),
                        "Access-Control-Max-Age": "3600",
                    })
                self._write_response(conn, method, headers, resp,
                                     close_conn)
                self._finish(lp, conn, None, close_conn[0])
                return
            if not self.is_router_path(path):
                # the budget half of admission — a bounded wait on the
                # worker, still BEFORE any body byte is read (internode
                # RPC bypasses the budget: a saturated S3 plane must not
                # deadlock peers' storage and lock traffic)
                got = self.admission.admit(method, path, query, headers,
                                           pre_checked=True)
                if not isinstance(got, AdmissionTicket):
                    self._write_response(conn, method, headers,
                                         got.response(path), close_conn)
                    close_conn[0] = True
                    self._finish(lp, conn, None, True)
                    return
                ticket = got
            if length > 0 and "100-continue" in headers.get(
                    "expect", "").lower():
                # admitted: NOW invite the body (the threaded frontend
                # 100-continues during parse, before admission — the
                # edge's whole point is deciding first)
                sock.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
            req = sig.Request(method=method, path=path, query=query,
                              headers=headers, raw_query=raw_query)
            body = _EdgeBodyReader(sock, bytearray(rest), length)
            ctx = RequestContext(req, body, length)
            ctx.remote_addr = conn.addr[0] if conn.addr else ""
            if ticket is not None:
                ctx.admission_ticket = ticket

            def respond(resp):
                self._write_response(conn, method, headers, resp,
                                     close_conn)

            run_request(self.api, self.extra_routers, ctx, method, path,
                        respond, caller=ctx.remote_addr)
            if not close_conn[0]:
                # keep-alive hygiene: unread body bytes would be parsed
                # as the next request; closing paths skip the drain
                # (shedding must unload the server)
                body.drain()
                self._finish(lp, conn, body.leftover(), False)
            else:
                self._finish(lp, conn, None, True)
        except Exception:  # noqa: BLE001 — client gone / transport torn
            self._finish(lp, conn, None, True)
        finally:
            if ticket is not None:
                ticket.release()       # idempotent: the handler (or its
                # streaming-response close) normally released already

    def _finish(self, lp: _EdgeLoop, conn: _Conn,
                leftover: Optional[bytes], close: bool) -> None:
        if close or self.closed or conn.closed:
            if not conn.closed:
                conn.closed = True
                try:
                    conn.sock.close()
                except OSError:
                    pass
                self.track(conn, -1)
            return

        def _rearm():
            conn.closed = False
            lp.conns.add(conn)
            lp._arm(conn, leftover or b"")

        try:
            lp.loop.call_soon_threadsafe(_rearm)
        except RuntimeError:           # loop stopped under us
            try:
                conn.sock.close()
            except OSError:
                pass
            self.track(conn, -1)

    def _write_response(self, conn: _Conn, method: str,
                        req_headers: dict, resp, close_conn: list
                        ) -> None:
        """Serialize one HTTPResponse on the worker's blocking socket —
        chunked framing, HEAD semantics and stream-close discipline
        identical to the threaded frontend."""
        chunked, wants_close = finalize_headers(
            self.api, req_headers.get("origin"), resp, method)
        if wants_close:
            close_conn[0] = True
        head = (f"HTTP/1.1 {resp.status} "
                f"{_REASONS.get(resp.status, '')}\r\n"
                f"Server: {SERVER_NAME}\r\nDate: {_http_date()}\r\n")
        for k, v in resp.headers.items():
            head += f"{k}: {v}\r\n"
        if chunked:
            head += "Transfer-Encoding: chunked\r\n"
        sock = conn.sock
        try:
            sock.sendall(head.encode("latin-1") + b"\r\n")
            if method == "HEAD":
                if resp.stream is not None:
                    resp.stream.close()
                return
            if resp.stream is not None:
                if chunked:
                    for chunk in resp.stream:
                        if chunk:
                            sock.sendall(f"{len(chunk):x}\r\n".encode()
                                         + chunk + b"\r\n")
                    sock.sendall(b"0\r\n\r\n")
                else:
                    for chunk in resp.stream:
                        sock.sendall(chunk)
            elif resp.body:
                sock.sendall(resp.body)
        except (BrokenPipeError, ConnectionResetError):
            close_conn[0] = True
        finally:
            if resp.stream is not None:
                # releases the admission slot a streaming response
                # holds, even when the client hung up mid-body
                close = getattr(resp.stream, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
