"""Internode RPC transport — thin authenticated HTTP-POST verbs.

The reference's cmd/rest/client.go: each RPC is
`POST /<service>/v1/<verb>?arg=...` with an opaque body stream and a
JWT bearer derived from the cluster credentials. The client keeps a
persistent connection pool, marks the host offline on network error and
probes it back online in the background (cmd/rest/client.go:179-).

Robustness semantics (the failure-plane PR):
  * every call runs under a wall-clock deadline; idempotent verbs get
    bounded, jittered, exponentially backed-off retries inside that
    deadline before the host is declared offline;
  * only TRUE transport failures (refused/reset/timeout/unreachable)
    flip `online` — a remote that answered with an error payload
    (RPCError) or sent a malformed response is alive;
  * the offline health probe backs off exponentially (capped at
    `MINIO_TPU_PEER_PROBE_S`) instead of hammering a dead peer once a
    second forever — and any SUCCESSFUL direct call to the host (from
    any client in this process) re-admits it immediately, so a peer
    provably back never stays dark for the rest of a backoff window;
  * every successful verb feeds the per-peer latency tracker
    (`minio_tpu_peer_latency_seconds{peer,verb}`) so gray-slow peers
    are visible on OBD/admin next to the drive health states.

Counterpart of minio_tpu/distributed/transport.py; the wire format, the
token and the identity headers are the reference's, so either package's
client speaks to the other's server. Added here: per-verb call and byte
counters (``verb_stats``), read by the chip smoke's internode report, and
a boot generation per client and handler (``generation``, beside the
reference's ``node_id``), so that each of several nodes in one process
is an incarnation of its own and a rebooted one fires the generation
listener as it would in a process of its own.
Each call runs in an ``rpc.<verb>`` span and carries the caller's trace
and span ids in the trace headers; the serving side runs the verb in a
``join``ed ``rpc.server.<verb>`` fragment, which the span sink grafts back
into the caller's tree. ``readline`` reads the trace and event follow
streams line by line.
The fault-injection hooks (naughtynet.py) sit where the reference's do:
before the dial, on a server-side drop's error kind, in the offline
probe, before the verb is served and around a streamed response; each
is one flag test while the controller is disarmed. Left out: the OBD
bundle's per-client counter report.
"""

from __future__ import annotations

import base64
import errno as _errno
import hashlib
import hmac
import http.client
import json
import random
import socket
import threading
import time
import urllib.parse
from typing import Callable, Optional

from ..utils import backoff_delay, healthtrack, knobs, telemetry
from . import membership, naughtynet

DEFAULT_TIMEOUT = 30.0

# process-wide transport fault counters (per-endpoint counts stay on
# each RestClient for the OBD bundle; these aggregates feed Prometheus)
_RPC_CALLS = telemetry.REGISTRY.counter(
    "minio_tpu_rpc_calls_total", "Internode RPC verbs attempted")
_RPC_NET_ERRORS = telemetry.REGISTRY.counter(
    "minio_tpu_rpc_net_errors_total",
    "Internode RPC transport failures (per attempt)")
_RPC_RETRIES = telemetry.REGISTRY.counter(
    "minio_tpu_rpc_retries_total", "Internode RPC retry attempts")
_RPC_OFFLINE_TRIPS = telemetry.REGISTRY.counter(
    "minio_tpu_rpc_offline_trips_total",
    "Peer online->offline transitions")
# per verb, client side: attempts, request-body bytes sent, response
# bytes received (streamed responses count as they are read)
_RPC_VERB_CALLS = telemetry.REGISTRY.counter(
    "minio_tpu_rpc_verb_calls_total", "Internode RPC attempts per verb")
_RPC_VERB_SENT = telemetry.REGISTRY.counter(
    "minio_tpu_rpc_verb_sent_bytes_total",
    "Internode RPC request-body bytes sent per verb")
_RPC_VERB_RECV = telemetry.REGISTRY.counter(
    "minio_tpu_rpc_verb_received_bytes_total",
    "Internode RPC response bytes received per verb")


def verb_stats() -> dict:
    """verb -> {calls, sent_bytes, received_bytes} since process start
    (counters only grow: callers diff two readings)."""
    out: dict = {}
    for name, fam in (("calls", _RPC_VERB_CALLS),
                      ("sent_bytes", _RPC_VERB_SENT),
                      ("received_bytes", _RPC_VERB_RECV)):
        for labels, v in fam.series().items():
            verb = dict(labels).get("verb", "")
            out.setdefault(verb, {"calls": 0, "sent_bytes": 0,
                                  "received_bytes": 0})[name] = int(v)
    return out
HEALTH_PROBE_INTERVAL = 1.0
HEALTH_PROBE_MAX = knobs.get_float("MINIO_TPU_PEER_PROBE_S")
# retries for idempotent verbs (attempts = retries + 1), inside the
# per-call deadline
RPC_RETRIES = knobs.get_int("MINIO_TPU_RPC_RETRIES")
RPC_RETRY_BACKOFF = knobs.get_float("MINIO_TPU_RPC_RETRY_BACKOFF")
RPC_RETRY_BACKOFF_MAX = knobs.get_float("MINIO_TPU_RPC_RETRY_BACKOFF_MAX")
# tolerated clock skew between nodes on token expiry (internode auth
# must not flap because two hosts' clocks drift a few seconds apart)
TOKEN_CLOCK_SKEW = 30.0


class RPCError(Exception):
    """Error returned by the remote handler (payload survived)."""

    def __init__(self, kind: str, message: str = ""):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.message = message


class NetworkError(Exception):
    """Transport-level failure — the peer may be down.

    `conn_failure` distinguishes connection-level failures (refused,
    reset, timeout, unreachable — the peer process is likely gone) from
    protocol-level ones (malformed response, mid-stream disconnect —
    the peer answered, so `online` must not flip)."""

    def __init__(self, message: str = "", conn_failure: bool = False):
        super().__init__(message)
        self.conn_failure = conn_failure


_CONN_ERRNOS = {_errno.ECONNREFUSED, _errno.ECONNRESET,
                _errno.ECONNABORTED, _errno.EPIPE, _errno.ETIMEDOUT,
                _errno.EHOSTUNREACH, _errno.ENETUNREACH,
                _errno.EHOSTDOWN if hasattr(_errno, "EHOSTDOWN") else
                _errno.EHOSTUNREACH}


def _is_conn_failure(e: Exception) -> bool:
    """True for failures that mean 'the peer is unreachable' rather than
    'the peer misbehaved' — only these flip a host offline."""
    if isinstance(e, (ConnectionError, socket.timeout, socket.gaierror,
                      TimeoutError)):
        return True
    if isinstance(e, OSError) and e.errno in _CONN_ERRNOS:
        return True
    return isinstance(e, (http.client.NotConnected,
                          http.client.ImproperConnectionState))


# ---------------------------------------------------------------------------
# internode auth: HMAC token over (access_key, expiry) with the secret key
# (the reference uses JWT with the same claims, cmd/jwt.go)
# ---------------------------------------------------------------------------

def make_token(access_key: str, secret_key: str,
               ttl: float = 15 * 60) -> str:
    expiry = int(time.time() + ttl)
    msg = f"{access_key}:{expiry}"
    mac = hmac.new(secret_key.encode(), msg.encode(),
                   hashlib.sha256).hexdigest()
    return base64.urlsafe_b64encode(
        f"{msg}:{mac}".encode()).decode()


def verify_token(token: str, access_key: str, secret_key: str) -> bool:
    try:
        decoded = base64.urlsafe_b64decode(token.encode()).decode()
        ak, expiry, mac = decoded.rsplit(":", 2)
        # tolerate small clock skew: a token minted by a slightly-slow
        # peer clock must not flap internode auth at the expiry edge
        expired = int(expiry) + TOKEN_CLOCK_SKEW < time.time()
    except (ValueError, UnicodeDecodeError):
        return False
    if ak != access_key or expired:
        return False
    want = hmac.new(secret_key.encode(), f"{ak}:{expiry}".encode(),
                    hashlib.sha256).hexdigest()
    return hmac.compare_digest(want, mac)


# every live RestClient per (host, port): a successful call through
# ANY of them proves the host back, so siblings still sitting out a
# probe backoff re-admit immediately (the MRFHealer.kick-on-
# re-admission pattern applied to peers). WeakSets: clients must not
# outlive their owners just because the registry saw them once.
_CLIENTS_MU = threading.Lock()
_CLIENTS: dict = {}


def _register_client(c: "RestClient") -> None:
    import weakref
    with _CLIENTS_MU:
        _CLIENTS.setdefault((c.host, c.port),
                            weakref.WeakSet()).add(c)


def _note_host_alive(host: str, port: int,
                     exclude: Optional["RestClient"] = None) -> None:
    """A verb against (host, port) just SUCCEEDED: flip every sibling
    client of that host back online — a host proven alive must not
    stay dark for the rest of a 30 s probe backoff."""
    with _CLIENTS_MU:
        peers = list(_CLIENTS.get((host, port), ()))
    for c in peers:
        if c is not exclude and not c._online:
            c._online = True        # the probe loop exits on this flag


def _on_peer_generation_change(peer: str, old_gen: int,
                               new_gen: int) -> None:
    """Generation fencing, transport side: latency evidence and
    offline markers gathered against the peer's PREVIOUS incarnation
    must not poison the new one — a restarted peer neither inherits
    its predecessor's slow-conviction windows nor stays dark for the
    rest of a probe backoff."""
    healthtrack.TRACKER.clear_samples("peer", peer)
    host, _, port = peer.rpartition(":")
    if host and port.isdigit():
        _note_host_alive(host, int(port))


membership.TRACKER.add_listener(_on_peer_generation_change)


class RestClient:
    """One peer endpoint. call() POSTs a verb; on connection failure the
    host is marked offline and a background probe re-enables it."""

    def __init__(self, host: str, port: int, service_path: str,
                 access_key: str, secret_key: str,
                 timeout: float = DEFAULT_TIMEOUT):
        self.host, self.port = host, port
        self.service_path = service_path.rstrip("/")
        self.access_key, self.secret_key = access_key, secret_key
        self.timeout = timeout
        # owning node's id and boot generation for the membership
        # headers; "" and 0 fall back to the process-local identity (one
        # node per process — the subprocess/deployment case)
        self.node_id = ""
        self.generation = 0
        self._online = True
        self._mu = threading.Lock()
        self._prober: Optional[threading.Thread] = None
        self._probe_delay = HEALTH_PROBE_INTERVAL
        _register_client(self)
        # fault counters (the reference surfaces them per drive in its
        # OBD bundle): calls = verbs attempted, net_errors = transport failures
        # observed (per attempt), retries = extra attempts made,
        # offline_trips = online→offline transitions
        self.calls = 0
        self.net_errors = 0
        self.retries = 0
        self.offline_trips = 0

    @property
    def online(self) -> bool:
        return self._online

    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.service_path}"

    def call(self, verb: str, args: Optional[dict] = None,
             body: bytes = b"", stream_response: bool = False,
             body_length: Optional[int] = None,
             idempotent: bool = False,
             deadline: Optional[float] = None):
        """POST the verb. Returns response bytes (or a streamed reader
        when stream_response for large reads).

        `body` may be bytes, OR an iterable/file-like streamed to the
        wire in chunks with `body_length` as Content-Length — large
        shard bodies (CreateFile, heal writes) never materialize on
        the sending side (reference storage-rest streaming verbs).

        `idempotent` verbs with a replayable (bytes) body retry bounded
        times with jittered exponential backoff on transport failures;
        `deadline` (default `timeout`) bounds when new attempts/backoffs
        may START and caps each attempt's per-socket-op timeout — a peer
        that keeps trickling bytes can still hold one attempt past it
        (socket timeouts reset per recv). The host is marked offline
        only when a connection-level failure survives the retries."""
        if not self._online:
            raise NetworkError(f"{self.host}:{self.port} is offline",
                               conn_failure=True)
        with self._mu:
            self.calls += 1
        _RPC_CALLS.inc()
        end = time.monotonic() + (deadline if deadline is not None
                                  else self.timeout)
        attempts = 1
        if idempotent and isinstance(body, (bytes, bytearray, memoryview)):
            attempts += RPC_RETRIES
        last: Optional[NetworkError] = None
        with telemetry.span(f"rpc.{verb}",
                            host=f"{self.host}:{self.port}"):
            for attempt in range(attempts):
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
                if attempt:
                    with self._mu:
                        self.retries += 1
                    _RPC_RETRIES.inc()
                try:
                    t0 = time.perf_counter()
                    out = self._call_once(verb, args, body,
                                          stream_response, body_length,
                                          timeout=min(self.timeout,
                                                      remaining))
                    # feed the gray-failure plane: per-peer latency
                    # (streamed verbs time the OPEN; the drive-level
                    # read tracker times the body) — and a successful
                    # non-probe verb proves the host alive for every
                    # sibling client still sitting out its backoff
                    healthtrack.observe_peer(
                        f"{self.host}:{self.port}", verb,
                        time.perf_counter() - t0)
                    _note_host_alive(self.host, self.port, exclude=self)
                    return out
                except NetworkError as e:
                    with self._mu:
                        self.net_errors += 1
                    _RPC_NET_ERRORS.inc()
                    last = e
                    if attempt + 1 >= attempts:
                        break
                    backoff = backoff_delay(RPC_RETRY_BACKOFF,
                                            RPC_RETRY_BACKOFF_MAX,
                                            attempt)
                    if time.monotonic() + backoff >= end:
                        break
                    time.sleep(backoff)
        if last is None:
            last = NetworkError(
                f"{self.host}:{self.port} {verb}: deadline exceeded",
                conn_failure=True)
        if last.conn_failure:
            self.mark_offline()
        raise last

    def _call_once(self, verb: str, args: Optional[dict], body,
                   stream_response: bool, body_length: Optional[int],
                   timeout: float):
        if naughtynet.NET.enabled:
            # deterministic chaos: a partitioned link fails like an
            # unreachable host (conn failure → retries → offline), an
            # armed delay schedule sleeps before the dial
            act = naughtynet.NET.on_call(
                self.node_id, f"{self.host}:{self.port}", verb)
            if act.delay > 0:
                time.sleep(act.delay)
            if act.blocked:
                raise NetworkError(
                    f"naughtynet: link to {self.host}:{self.port} "
                    "partitioned", conn_failure=True)
        qs = urllib.parse.urlencode(args or {})
        path = f"{self.service_path}/{verb}" + (f"?{qs}" if qs else "")
        if isinstance(body, (bytes, bytearray, memoryview)):
            length = len(body)
        else:
            assert body_length is not None, \
                "streaming bodies need body_length"
            length = body_length
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        headers = {
            "Authorization":
                "Bearer " + make_token(self.access_key,
                                       self.secret_key),
            "Content-Length": str(length),
        }
        # membership: advertise who is calling and which incarnation,
        # so the serving side positively detects our restarts
        src_id = self.node_id or membership.local_node()
        if src_id:
            headers[membership.NODE_HEADER] = src_id
        headers[membership.GEN_HEADER] = str(
            self.generation or membership.local_generation())
        cur = telemetry.current_span()
        if cur is not None:
            # propagate the trace identity so the serving side joins
            # this request's span tree (fragment, grafted by span id)
            headers[telemetry.TRACE_HEADER] = cur.trace_id
            headers[telemetry.SPAN_HEADER] = cur.span_id
        _RPC_VERB_CALLS.inc(verb=verb)
        _RPC_VERB_SENT.inc(length, verb=verb)
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            self._observe_peer_generation(resp)
            if resp.status != 200:
                payload = resp.read()
                conn.close()
                try:
                    err = json.loads(payload.decode())
                except ValueError:
                    err = None
                if isinstance(err, dict):
                    if err.get("kind") == naughtynet.PARTITIONED_KIND:
                        # server-side injected drop: surface it exactly
                        # like an unreachable host
                        raise NetworkError(
                            f"naughtynet: {self.host}:{self.port} "
                            "dropped the call (partitioned)",
                            conn_failure=True)
                    raise RPCError(err.get("kind", "error"),
                                   err.get("message", ""))
                raise RPCError("http", f"status {resp.status}")
            if stream_response:
                return _StreamedResponse(conn, resp, verb=verb)
            data = resp.read()
            conn.close()
            _RPC_VERB_RECV.inc(len(data), verb=verb)
            return data
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            # the peer answering garbage (BadStatusLine, short body) is
            # NOT a dead peer: only connection-level failures may flip
            # the host offline (decided by call() after retries)
            raise NetworkError(str(e),
                               conn_failure=_is_conn_failure(e)) from e

    def _observe_peer_generation(self, resp) -> None:
        """Feed the membership tracker from a response's identity
        headers — a changed boot generation fires the stale-state
        fencing listeners (healthtrack windows, offline markers)."""
        gen = resp.getheader(membership.GEN_HEADER)
        if not gen:
            return
        try:
            membership.TRACKER.observe(
                f"{self.host}:{self.port}", int(gen),
                resp.getheader(membership.NODE_HEADER) or "")
        except ValueError:
            pass

    def call_json(self, verb: str, args: Optional[dict] = None,
                  payload=None):
        body = json.dumps(payload).encode() if payload is not None else b""
        out = self.call(verb, args, body)
        return json.loads(out.decode()) if out else None

    def mark_offline(self) -> None:
        """Start the background health probe (reference MarkOffline,
        cmd/rest/client.go:179)."""
        with self._mu:
            if not self._online:
                return
            self._online = False
            self.offline_trips += 1
            _RPC_OFFLINE_TRIPS.inc()
            # a fresh offline spell probes FAST again even when the
            # prober thread is reused below (its backoff may have
            # grown to the cap during an earlier spell)
            self._probe_delay = HEALTH_PROBE_INTERVAL
            if self._prober is not None and self._prober.is_alive():
                # a prober from an earlier offline spell is still in
                # its backoff sleep (a sibling's success flipped the
                # flag without joining it): it re-reads _online under
                # _mu at its loop top and keeps going — spawning
                # another would stack probers per flap. The prober
                # clears self._prober under _mu before exiting, so it
                # cannot be observed alive here AND miss this spell.
                return
            self._prober = threading.Thread(target=self._probe_loop,
                                            daemon=True)
            self._prober.start()

    def _probe_loop(self) -> None:
        # exponential backoff (capped): a host that stays dead gets
        # probed ever less often instead of a fixed 1 s hammer; the
        # first probe still fires fast so a blip recovers quickly
        # (mark_offline resets _probe_delay per spell — this thread
        # may serve several spells back to back). The ONLY exit is the
        # top-of-loop check under _mu, which also hands the prober
        # slot back — so mark_offline can never observe a live prober
        # that has already decided to die (the stuck-offline race).
        while True:
            with self._mu:
                if self._online:
                    self._prober = None
                    return
                delay = self._probe_delay
                self._probe_delay = min(delay * 2, HEALTH_PROBE_MAX)
            time.sleep(delay * (0.75 + random.random() / 2))
            if naughtynet.NET.enabled and naughtynet.NET.blocked(
                    self.node_id or membership.local_node(),
                    f"{self.host}:{self.port}"):
                # the link is (chaos-)partitioned: the probe must not
                # re-admit a host we cannot actually reach
                continue
            try:
                conn = http.client.HTTPConnection(self.host, self.port,
                                                  timeout=2.0)
                src_id = self.node_id or membership.local_node()
                conn.request("GET", self.service_path + "/health",
                             headers={membership.NODE_HEADER: src_id}
                             if src_id else {})
                resp = conn.getresponse()
                resp.read()
                conn.close()
                if resp.status in (200, 404):
                    self._online = True
                    # one prober's good news re-admits every sibling;
                    # the loop top hands the prober slot back
                    _note_host_alive(self.host, self.port, exclude=self)
            except (OSError, http.client.HTTPException):
                continue

    def close(self) -> None:
        self._online = True  # stop any probe loop


class _StreamedResponse:
    def __init__(self, conn, resp, read_timeout: Optional[float] = None,
                 verb: str = ""):
        self._conn = conn
        self.resp = resp
        self._verb = verb
        # per-READ deadline: a peer that goes silent mid-stream
        # (partition after headers) must fail the reader, not park it
        # forever — armed on the socket before every read, so a
        # trickling-but-alive stream resets it each time
        self._read_timeout = (
            knobs.get_float("MINIO_TPU_RPC_STREAM_READ_S")
            if read_timeout is None else read_timeout)

    def _arm_read_deadline(self) -> None:
        sock = getattr(self._conn, "sock", None)
        if sock is not None and self._read_timeout > 0:
            sock.settimeout(self._read_timeout)

    def read(self, n: int = -1) -> bytes:
        self._arm_read_deadline()
        try:
            data = self.resp.read(n)
            if self._verb:
                _RPC_VERB_RECV.inc(len(data), verb=self._verb)
            return data
        except socket.timeout as e:
            # the peer went silent past the per-read deadline: that is
            # an unreachable host, not a malformed response
            self._conn.close()
            raise NetworkError(
                f"mid-stream: read deadline "
                f"({self._read_timeout:g}s) exceeded",
                conn_failure=True) from e
        except (OSError, http.client.HTTPException) as e:
            # a mid-stream disconnect is a RETRYABLE transport fault,
            # not a generic storage error — hedged readers re-read from
            # another drive; the peer is not declared offline for it
            self._conn.close()
            raise NetworkError(f"mid-stream: {e}") from e

    def readline(self) -> bytes:
        """One line, incrementally: read(n) on a chunked response
        blocks until n bytes accumulate, which on a trickle stream
        (follow heartbeats) means minutes; readline reads at most one
        chunk. Empty bytes = end of stream."""
        self._arm_read_deadline()
        try:
            data = self.resp.readline()
            if self._verb:
                _RPC_VERB_RECV.inc(len(data), verb=self._verb)
            return data
        except socket.timeout as e:
            self._conn.close()
            raise NetworkError(
                f"mid-stream: read deadline "
                f"({self._read_timeout:g}s) exceeded",
                conn_failure=True) from e
        except (OSError, http.client.HTTPException, ValueError) as e:
            self._conn.close()
            raise NetworkError(f"mid-stream: {e}") from e

    def close(self) -> None:
        self._conn.close()


# ---------------------------------------------------------------------------
# server side: verb table mounted under a path prefix on any HTTP server
# ---------------------------------------------------------------------------

class RPCHandler:
    """Routes `POST <prefix>/<verb>` to registered python callables.

    handler(args: dict[str, str], body: bytes) -> bytes | dict | None.
    Raised exceptions are serialized as {"kind", "message"} with a 500.
    Mount into the S3Server via register_router(prefix, self.route) or
    serve standalone via serve().
    """

    def __init__(self, prefix: str, access_key: str, secret_key: str,
                 node_id: str = ""):
        self.prefix = prefix.rstrip("/")
        self.access_key, self.secret_key = access_key, secret_key
        # serving node's id and boot generation ("" and 0 = the
        # process-local identity): stamped on every response so callers
        # track our boot generation
        self.node_id = node_id
        self.generation = 0
        self._verbs: dict[str, Callable] = {}
        self._stream_verbs: set[str] = set()

    def register(self, verb: str, fn: Callable,
                 stream_body: bool = False) -> None:
        """stream_body verbs receive the request-body READER instead of
        bytes — big uploads (CreateFile) pass through to the drive
        without staging in RAM."""
        self._verbs[verb] = fn
        if stream_body:
            self._stream_verbs.add(verb)

    def _identity_headers(self) -> dict:
        out = {membership.GEN_HEADER: str(
            self.generation or membership.local_generation())}
        nid = self.node_id or membership.local_node()
        if nid:
            out[membership.NODE_HEADER] = nid
        return out

    def route(self, ctx) -> "HTTPResponse":
        from ..s3.handlers import HTTPResponse
        path = ctx.req.path
        verb = path[len(self.prefix):].lstrip("/")
        ident = self._identity_headers()
        peer_id = ctx.header(membership.NODE_HEADER)
        if naughtynet.NET.enabled:
            # inbound chaos: a partitioned caller's verbs (health
            # probes included) are dropped BEFORE dispatch — the
            # PARTITIONED_KIND payload maps back to an unreachable-host
            # failure on the calling side
            act = naughtynet.NET.on_serve(
                peer_id, self.node_id or membership.local_node(), verb)
            if act.delay > 0:
                time.sleep(act.delay)
            if act.blocked:
                return HTTPResponse(status=503, body=json.dumps(
                    {"kind": naughtynet.PARTITIONED_KIND,
                     "message": "inbound link partitioned"}).encode(),
                    headers=ident)
        if verb == "health":
            return HTTPResponse(body=b"OK", headers=ident)
        auth = ctx.header("authorization")
        if not (auth.startswith("Bearer ") and verify_token(
                auth[7:], self.access_key, self.secret_key)):
            return HTTPResponse(status=403, body=json.dumps(
                {"kind": "auth", "message": "invalid token"}).encode(),
                headers=ident)
        # membership: a caller advertising a NEW boot generation is a
        # fresh incarnation — fire the stale-state fencing listeners
        peer_gen = ctx.header(membership.GEN_HEADER)
        if peer_id and peer_gen:
            try:
                membership.TRACKER.observe(peer_id, int(peer_gen),
                                           peer_id)
            except ValueError:
                pass
        fn = self._verbs.get(verb)
        if fn is None:
            return HTTPResponse(status=404, body=json.dumps(
                {"kind": "unknown-verb", "message": verb}).encode(),
                headers=ident)
        args = {k: v[0] for k, v in ctx.req.query.items()}
        body = ctx.body_stream if verb in self._stream_verbs \
            else ctx.read_body()
        # join the caller's trace when it sent one: the handler runs
        # under a remote-side span recorded as a fragment and grafted
        # back into the caller's tree by span id
        tid = ctx.header(telemetry.TRACE_HEADER)
        join_cm = telemetry.join(
            f"rpc.server.{verb}", tid,
            ctx.header(telemetry.SPAN_HEADER)) if tid else None
        try:
            if join_cm is not None:
                with join_cm:
                    out = fn(args, body)
            else:
                out = fn(args, body)
        except Exception as e:  # noqa: BLE001 — serialize to the caller
            return HTTPResponse(status=500, body=json.dumps(
                {"kind": type(e).__name__, "message": str(e)}).encode(),
                headers=ident)
        if out is None:
            return HTTPResponse(body=b"", headers=ident)
        if isinstance(out, (bytes, bytearray)):
            return HTTPResponse(body=bytes(out), headers=ident)
        if hasattr(out, "__next__") or hasattr(out, "read"):
            # streamed response (big shard reads): chunked on the wire
            if hasattr(out, "read"):
                reader = out

                def gen():
                    try:
                        while True:
                            chunk = reader.read(1 << 20)
                            if not chunk:
                                return
                            yield chunk
                    finally:
                        close = getattr(reader, "close", None)
                        if close is not None:
                            close()
                out = gen()
            if naughtynet.NET.enabled:
                # chaos may reset the stream after the first chunk or
                # go silent when a partition opens mid-stream
                out = naughtynet.NET.wrap_stream(
                    peer_id, self.node_id or membership.local_node(),
                    verb, out)
            return HTTPResponse(stream=out, headers=ident)
        headers = {"Content-Type": "application/json"}
        headers.update(ident)
        return HTTPResponse(body=json.dumps(out).encode(),
                            headers=headers)


class RPCServer:
    """Standalone HTTP host for one or more RPCHandlers (a node's
    internode port when no S3 frontend is wanted, e.g. tests or
    storage-only processes)."""

    def __init__(self, address: str = "127.0.0.1", port: int = 0):
        import urllib.parse as _up
        from http.server import BaseHTTPRequestHandler
        from ..s3 import signature as sig
        from ..s3.handlers import RequestContext

        handlers: list[tuple[str, RPCHandler]] = []
        self._handlers = handlers

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _go(self):
                from ..s3.server import _BodyReader
                parsed = _up.urlsplit(self.path)
                headers = {k.lower(): v for k, v in self.headers.items()}
                req = sig.Request(
                    method=self.command, path=parsed.path,
                    query=_up.parse_qs(parsed.query,
                                       keep_blank_values=True),
                    headers=headers, raw_query=parsed.query)
                length = int(headers.get("content-length", 0) or 0)
                # lazy bounded reader: stream verbs (CreateFile) pass
                # big bodies straight to the drive; drain() afterwards
                # keeps the keep-alive socket clean either way
                body_reader = _BodyReader(self.rfile, length)
                ctx = RequestContext(req, body_reader, length)
                try:
                    resp = None
                    for prefix, h in handlers:
                        if parsed.path.startswith(prefix):
                            resp = h.route(ctx)
                            break
                finally:
                    body_reader.drain()
                if resp is None:
                    from ..s3.handlers import HTTPResponse
                    resp = HTTPResponse(status=404, body=b"not found")
                self.send_response(resp.status)
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                if resp.stream is not None:
                    # chunked streamed response (big shard reads)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    try:
                        for chunk in resp.stream:
                            if chunk:
                                self.wfile.write(
                                    f"{len(chunk):x}\r\n".encode()
                                    + chunk + b"\r\n")
                        self.wfile.write(b"0\r\n\r\n")
                    except BrokenPipeError:
                        self.close_connection = True
                    finally:
                        close = getattr(resp.stream, "close", None)
                        if close is not None:
                            try:
                                close()
                            except Exception:  # noqa: BLE001
                                pass
                    return
                body = resp.body
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body:
                    self.wfile.write(body)

            do_GET = do_POST = _go

        from ..s3.server import _DeepBacklogServer
        self._httpd = _DeepBacklogServer((address, port), _H)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def mount(self, handler: RPCHandler) -> None:
        self._handlers.append((handler.prefix, handler))

    def mount_route(self, prefix: str, handler: RPCHandler) -> None:
        self._handlers.append((prefix, handler))

    def start(self) -> "RPCServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
