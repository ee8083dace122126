"""Peer control plane + bootstrap verify.

The reference fans control operations out to every node over peer REST
(cmd/peer-rest-client.go / cmd/peer-rest-server.go, aggregated by
NotificationSys, cmd/notification.go) and verifies cluster config
consistency at startup against the first node
(cmd/bootstrap-peer-server.go verifyServerSystemConfig).

Counterpart of minio_tpu/distributed/peer_rpc.py, with the verbs whose
planes the port has: ``server-info``, ``locks``,
``reload-bucket-metadata``, ``reload-iam``, ``iam-delta``,
``metrics-text``, ``storage-info``, ``bucket-usage``, ``signal``,
``net-probe``, ``tracker-rotate``, and the tracing plane's ``trace``,
``trace-stream``, ``events``, ``event-stream``, ``incidents``,
``incident``, ``profiling-start``, ``profiling-stop`` and
``console-log``, the gray-failure plane's ``obd`` (utils/obd.py over
``obd_drive_paths``), the notification plane's ``notify-event`` (a
non-owner's namespace event handed to the bucket's owner) and
``notify-reload``, their client calls and NotificationSys fan-outs
(``obd_all``, ``net_obd``, ``notify_reload``), and the bootstrap verify
whole. The JSON-metrics and bandwidth verbs are not registered: a peer
asking for one gets the transport's own 404 ``unknown-verb``. Departure: the federated scrape's
per-peer pull waits its whole deadline (``MINIO_TPU_CLUSTER_SCRAPE_S``);
the reference tightens it from the peer's observed latency under
``MINIO_TPU_PEER_SHED_DEADLINE_X``, which is not ported.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Callable, Optional

from ..utils import telemetry
from .transport import NetworkError, RestClient, RPCError, RPCHandler

PEER_RPC_PREFIX = "/minio/peer/v1"
BOOTSTRAP_RPC_PREFIX = "/minio/bootstrap/v1"

# per-peer partition sheds: fan-out calls that failed fast because the
# peer's transport was already marked offline — bounded degradation's
# "we didn't even dial" counter
_PARTITION_SHED = telemetry.REGISTRY.counter(
    "minio_tpu_net_partition_shed_total",
    "Cross-peer fan-out calls shed fast (peer transport offline)")


class PeerRPCServer:
    """This node's control-plane verbs. Hooks are injected so the server
    stays decoupled from the subsystems it pokes."""

    def __init__(self, access_key: str, secret_key: str,
                 node_id: str = ""):
        self.handler = RPCHandler(PEER_RPC_PREFIX, access_key,
                                  secret_key, node_id=node_id)
        self.node_id = node_id
        self.started = time.time()
        # injectable hooks
        self.get_server_info: Callable[[], dict] = lambda: {}
        self.get_locks: Callable[[], dict] = lambda: {}
        self.reload_bucket_metadata: Callable[[str], None] = lambda b: None
        self.signal_service: Callable[[str], None] = lambda sig: None
        self.get_storage_info: Callable[[], dict] = lambda: {}
        self.get_bucket_usage: Callable[[], dict] = lambda: {}
        # IAM: wholesale reload, and the per-entity delta a mutating
        # peer sends (None: every delta reloads wholesale)
        self.reload_iam: Callable[[], None] = lambda: None
        self.apply_iam_delta: Optional[Callable[[str, str], None]] = None
        # this node's Prometheus exposition (the admin metrics handler)
        self.get_metrics_text: Callable[[], str] = lambda: ""
        # leader heal-scanner pulls + rotates this node's data-update
        # tracker each pass (None until the cluster wires it)
        self.get_update_tracker: Optional[Callable[[], dict]] = None
        # the tracing plane: this node's trace ring and live TraceSys
        # hub, the event journal's hub and recent window, and the
        # incident readback (None / empty until the cluster wires them)
        self.get_trace: Callable[[], list] = lambda: []
        self.trace_hub = None
        self.event_hub = None
        self.get_events: Callable[[], list] = lambda: []
        self.list_incidents: Callable[[], list] = lambda: []
        self.get_incident: Callable[[str], Optional[dict]] = \
            lambda inc_id: None
        # the drive paths the OBD verb probes (the cluster sets them)
        self.obd_drive_paths: list[str] = []
        # bucket event notification plane: owner-node delivery hand-off
        # (a non-owner forwards the namespace event here) and registry
        # reload after an admin target mutation elsewhere
        self.notify_event: Callable[[str, str], None] = lambda b, k: None
        self.notify_reload: Callable[[], object] = lambda: None

        h = self.handler
        h.register("server-info", lambda a, b: {
            "node": self.node_id, "uptime": time.time() - self.started,
            **self.get_server_info()})
        h.register("locks", lambda a, b: self.get_locks())
        h.register("reload-bucket-metadata", self._reload_bm)
        h.register("reload-iam", lambda a, b: self.reload_iam())
        h.register("iam-delta", self._iam_delta)
        h.register("signal", self._signal)
        h.register("metrics-text",
                   lambda a, b: self.get_metrics_text().encode())
        h.register("storage-info", lambda a, b: self.get_storage_info())
        h.register("bucket-usage", lambda a, b: self.get_bucket_usage())
        # OBD net perf: the caller times pushing a payload here; this
        # side only confirms how much arrived (cmd/obdinfo.go's
        # peer-to-peer net throughput probes)
        h.register("net-probe", lambda a, b: {
            "node": self.node_id, "received": len(b)})
        h.register("tracker-rotate", self._tracker_rotate)
        h.register("trace", lambda a, b: self.get_trace())
        h.register("trace-stream", self._trace_stream)
        h.register("events", lambda a, b: self.get_events())
        h.register("event-stream", self._event_stream)
        h.register("incidents", lambda a, b: self.list_incidents())
        h.register("incident", self._incident)
        # profiling fan-out (cmd/admin-handlers.go:461-525 peer verbs)
        # the console-log ring and the OBD bundle (peer-rest-common.go:
        # 29-56)
        h.register("profiling-start", self._profiling_start)
        h.register("profiling-stop", self._profiling_stop)
        h.register("console-log", self._console_log)
        h.register("obd", self._obd)
        h.register("notify-event", self._notify_event)
        h.register("notify-reload", lambda a, b: self.notify_reload())

    def _trace_stream(self, args, body):
        """Live trace subscription (the peer half of a cluster-wide
        ?follow=1 stream): ND-JSON entries from this node's TraceSys
        hub as a chunked response. Idle windows emit bare newline
        heartbeats so a dead subscriber's next write fails and the
        subscription unwinds instead of leaking; blank lines are
        skipped by the merging side. `max_s` bounds the stream's life
        (the caller re-subscribes — a forgotten stream can't pin the
        hub forever)."""
        if self.trace_hub is None:
            return b""
        try:
            max_s = float(args.get("max_s", "3600") or 3600)
        except ValueError:
            max_s = 3600.0
        hub = self.trace_hub

        def gen():
            deadline = time.monotonic() + max(max_s, 1.0)
            with hub.subscribe() as sub:
                while time.monotonic() < deadline:
                    entry = sub.get(timeout=1.0)
                    if entry is None:
                        yield b"\n"              # heartbeat
                        continue
                    yield (json.dumps(entry) + "\n").encode()

        return gen()

    def _event_stream(self, args, body):
        """Live event-journal subscription (the peer half of a
        cluster-wide /events?follow=1): same ND-JSON + heartbeat +
        max_s contract as _trace_stream, fed by the EventJournal
        hub."""
        if self.event_hub is None:
            return b""
        try:
            max_s = float(args.get("max_s", "3600") or 3600)
        except ValueError:
            max_s = 3600.0
        hub = self.event_hub

        def gen():
            deadline = time.monotonic() + max(max_s, 1.0)
            with hub.subscribe() as sub:
                while time.monotonic() < deadline:
                    entry = sub.get(timeout=1.0)
                    if entry is None:
                        yield b"\n"              # heartbeat
                        continue
                    yield (json.dumps(entry) + "\n").encode()

        return gen()

    def _incident(self, args, body):
        doc = self.get_incident(args.get("id", ""))
        return doc if isinstance(doc, dict) else {}

    def _profiling_start(self, args, body):
        from ..utils import profiling
        kinds = profiling.parse_kinds(args.get("kinds", "cpu")) or ["cpu"]
        return {"node": self.node_id,
                "started": {k: profiling.start(k) for k in kinds}}

    def _profiling_stop(self, args, body):
        from ..utils import profiling
        kinds = profiling.parse_kinds(args.get("kinds", "cpu")) or ["cpu"]
        return {"node": self.node_id,
                "profiles": {k: profiling.stop_text(k) or ""
                             for k in kinds}}

    def _console_log(self, args, body):
        from ..utils.console import get_console
        try:
            n = int(args.get("count", "0") or 0)
        except ValueError:
            n = 0
        return {"node": self.node_id,
                "entries": get_console().recent(n)}

    def _obd(self, args, body):
        from ..utils.obd import local_obd
        out = local_obd(self.obd_drive_paths)
        out["node"] = self.node_id
        return out

    def _tracker_rotate(self, args, body):
        if self.get_update_tracker is None:
            return {}
        return self.get_update_tracker()

    def _iam_delta(self, args, body):
        # one RPC carries the whole mutation cascade (remove_user emits
        # user + mapping + every derived svcacct/sts in one batch)
        pairs: list = []
        if body:
            # malformed body MUST error (-> 500 -> the sender falls
            # back to a wholesale reload); a silent 200 ack would drop
            # the delta with no recovery until the periodic refresh
            raw = json.loads(body.decode())
            pairs = [(str(k), str(n)) for k, n in raw]
        elif args.get("kind"):
            pairs = [(args.get("kind", ""), args.get("name", ""))]
        if not pairs:
            raise ValueError("empty iam-delta")
        if self.apply_iam_delta is not None:
            for kind, name in pairs:
                self.apply_iam_delta(kind, name)
        else:
            self.reload_iam()

    def _reload_bm(self, args, body):
        self.reload_bucket_metadata(args.get("bucket", ""))

    def _notify_event(self, args, body):
        self.notify_event(args.get("bucket", ""), args.get("key", ""))

    def _signal(self, args, body):
        self.signal_service(args.get("sig", ""))

    def route(self, ctx):
        return self.handler.route(ctx)


class PeerRPCClient:
    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str, timeout: float = 5.0,
                 node_id: str = ""):
        self.rc = RestClient(host, port, PEER_RPC_PREFIX, access_key,
                             secret_key, timeout=timeout)
        self.rc.node_id = node_id

    def _shed(self) -> bool:
        """Fail-fast gate for fan-out verbs: a peer whose transport is
        already marked offline (partitioned / down) is shed without
        dialing — counted per peer so a partition window is visible as
        sheds, not as silent Nones."""
        if self.rc.online:
            return False
        _PARTITION_SHED.inc(peer=self.addr)
        return True

    def server_info(self) -> Optional[dict]:
        if self._shed():
            return None
        try:
            return self.rc.call_json("server-info")
        except (NetworkError, RPCError):
            return None

    def locks(self) -> dict:
        try:
            return self.rc.call_json("locks") or {}
        except (NetworkError, RPCError):
            return {}

    def reload_bucket_metadata(self, bucket: str) -> bool:
        try:
            self.rc.call("reload-bucket-metadata", {"bucket": bucket})
            return True
        except (NetworkError, RPCError):
            return False

    def reload_iam(self) -> bool:
        try:
            self.rc.call("reload-iam")
            return True
        except (NetworkError, RPCError):
            return False

    def notify_event(self, bucket: str, key: str) -> bool:
        """Hand one namespace event to this peer (the bucket's owner)
        for notification delivery."""
        if self._shed():
            return False
        try:
            self.rc.call("notify-event", {"bucket": bucket, "key": key})
            return True
        except (NetworkError, RPCError):
            return False

    def notify_reload(self) -> bool:
        try:
            self.rc.call("notify-reload")
            return True
        except (NetworkError, RPCError):
            return False

    def iam_delta(self, pairs: list) -> bool:
        try:
            self.rc.call_json("iam-delta", payload=list(pairs))
            return True
        except (NetworkError, RPCError):
            return False

    def metrics_text(self, deadline: float = 2.0) -> Optional[str]:
        """This peer's Prometheus text exposition, or None on failure:
        the federated scrape's per-peer pull, bounded by `deadline` so
        one dead peer degrades the cluster scrape instead of stalling
        it."""
        if self._shed():
            return None
        try:
            out = self.rc.call("metrics-text", deadline=deadline)
        except (NetworkError, RPCError):
            return None
        try:
            return out.decode()
        except UnicodeDecodeError:
            return None

    def signal_service(self, sig: str) -> bool:
        try:
            self.rc.call("signal", {"sig": sig})
            return True
        except (NetworkError, RPCError):
            return False

    @property
    def addr(self) -> str:
        return f"{self.rc.host}:{self.rc.port}"

    def storage_info(self) -> dict:
        if self._shed():
            return {}
        try:
            return self.rc.call_json("storage-info") or {}
        except (NetworkError, RPCError):
            return {}

    def bucket_usage(self) -> dict:
        try:
            return self.rc.call_json("bucket-usage") or {}
        except (NetworkError, RPCError):
            return {}

    def trace_stream(self, max_s: float = 3600.0):
        """Open this peer's live trace subscription: returns an
        iterator of entry dicts (ends on peer death / stream close),
        or None when the peer is unreachable. `.close()` on the
        returned iterator tears the connection down."""
        if self._shed():
            return None
        try:
            resp = self.rc.call("trace-stream",
                                {"max_s": str(max_s)},
                                stream_response=True,
                                deadline=max(max_s, 60.0))
        except (NetworkError, RPCError):
            return None
        return _TraceLineIter(resp, self.addr)

    def event_stream(self, max_s: float = 3600.0):
        """Open this peer's live event-journal subscription — same
        contract as trace_stream (entry-dict iterator or None;
        `.close()` tears the connection down)."""
        if self._shed():
            return None
        try:
            resp = self.rc.call("event-stream",
                                {"max_s": str(max_s)},
                                stream_response=True,
                                deadline=max(max_s, 60.0))
        except (NetworkError, RPCError):
            return None
        return _TraceLineIter(resp, self.addr)

    def events(self) -> list:
        """This peer's recent journal window (?cluster=1 merges)."""
        if self._shed():
            return []
        try:
            return self.rc.call_json("events") or []
        except (NetworkError, RPCError):
            return []

    def incidents(self) -> list:
        if self._shed():
            return []
        try:
            return self.rc.call_json("incidents") or []
        except (NetworkError, RPCError):
            return []

    def incident(self, inc_id: str) -> Optional[dict]:
        if self._shed():
            return None
        try:
            doc = self.rc.call_json("incident", {"id": inc_id})
        except (NetworkError, RPCError):
            return None
        return doc if isinstance(doc, dict) and doc else None

    def trace(self) -> list:
        if self._shed():
            return []
        try:
            return self.rc.call_json("trace") or []
        except (NetworkError, RPCError):
            return []

    def profiling_start(self, kinds: str = "cpu") -> Optional[dict]:
        try:
            return self.rc.call_json("profiling-start",
                                     {"kinds": kinds})
        except (NetworkError, RPCError):
            return None

    def profiling_stop(self, kinds: str = "cpu") -> Optional[dict]:
        try:
            return self.rc.call_json("profiling-stop",
                                     {"kinds": kinds})
        except (NetworkError, RPCError):
            return None

    def console_log(self, count: int = 0) -> Optional[dict]:
        try:
            return self.rc.call_json("console-log",
                                     {"count": str(count)})
        except (NetworkError, RPCError):
            return None

    def obd(self) -> Optional[dict]:
        try:
            return self.rc.call_json("obd")
        except (NetworkError, RPCError):
            return None

    def net_probe(self, size: int = 4 << 20) -> Optional[dict]:
        """Timed payload push to this peer: internode throughput + a
        small-ping RTT (the OBD net perf section). Each RestClient call
        opens a fresh connection, so a warm-up ping runs first and the
        empty-call baseline (connect + request overhead) is subtracted
        from the payload timing — the reported throughput approximates
        the transfer itself, not TCP setup."""
        import json as _json
        try:
            self.rc.call("net-probe", body=b"")     # warm-up, untimed
            rtt = None
            for _ in range(2):
                t0 = time.perf_counter()
                self.rc.call("net-probe", body=b"")
                dt = time.perf_counter() - t0
                rtt = dt if rtt is None else min(rtt, dt)
            payload = b"\x00" * size
            t0 = time.perf_counter()
            raw = self.rc.call("net-probe", body=payload)
            dt = max(time.perf_counter() - t0 - (rtt or 0.0), 1e-9)
            out = _json.loads(raw.decode()) if raw else None
        except (NetworkError, RPCError, ValueError):
            return None
        if not isinstance(out, dict):
            return None
        if out.get("received") != size:
            # reachable but truncated (proxy/body limit) — distinct
            # from peer-down so the operator chases the right problem
            return {"peer": f"{self.rc.host}:{self.rc.port}",
                    "error": "short receive",
                    "expected": size, "received": out.get("received")}
        return {"peer": f"{self.rc.host}:{self.rc.port}",
                "bytes": size,
                "rtt_us": round((rtt or 0.0) * 1e6),
                "throughput_mib_s": round(size / dt / 2**20, 2)}

    def tracker_rotate(self) -> Optional[dict]:
        try:
            return self.rc.call_json("tracker-rotate")
        except (NetworkError, RPCError):
            return None

    @property
    def online(self) -> bool:
        return self.rc.online

    def close(self) -> None:
        self.rc.close()


class _TraceLineIter:
    """ND-JSON line iterator over a streamed trace-stream response:
    yields entry dicts, skips heartbeat blanks, ends (never raises) on
    any transport fault. close() tears down the underlying connection
    — the unblocking lever the merging side pulls from another
    thread."""

    def __init__(self, resp, peer: str):
        self._resp = resp
        self.peer = peer
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while not self._closed:
            try:
                # readline, not read(n): chunked read(n) waits for n
                # bytes, and a mostly-idle peer trickles 1-byte
                # heartbeats — lines must surface as they arrive
                line = self._resp.readline()
            except Exception:  # noqa: BLE001 — peer died: end of stream
                raise StopIteration from None
            if not line:
                raise StopIteration
            if not line.strip():
                continue                          # heartbeat
            try:
                entry = json.loads(line.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            if isinstance(entry, dict):
                return entry
        raise StopIteration

    def close(self) -> None:
        self._closed = True
        try:
            self._resp.close()
        except Exception:  # noqa: BLE001 — already torn down
            pass


class NotificationSys:
    """Fan-out aggregator over all peer clients (cmd/notification.go):
    each call broadcasts concurrently and returns per-peer results."""

    def __init__(self, peers: list[PeerRPCClient]):
        self.peers = peers

    def _broadcast(self, fn: Callable[[PeerRPCClient], object]) -> list:
        out: list = [None] * len(self.peers)
        threads = []
        for i, p in enumerate(self.peers):
            def run(i=i, p=p):
                try:
                    out[i] = fn(p)
                except Exception as e:  # noqa: BLE001 — per-peer result
                    out[i] = e
            t = threading.Thread(target=run, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=10)
        return out

    def server_info_all(self) -> list:
        return self._broadcast(lambda p: p.server_info())

    def reload_bucket_metadata(self, bucket: str) -> list:
        return self._broadcast(
            lambda p: p.reload_bucket_metadata(bucket))

    def reload_iam(self) -> list:
        return self._broadcast(lambda p: p.reload_iam())

    def notify_reload(self) -> list:
        """Reload every peer's notification-target registry (after an
        admin target mutation here — their boot-time loads are stale)."""
        return self._broadcast(lambda p: p.notify_reload())

    def iam_delta(self, pairs: list) -> list:
        """Per-entity IAM propagation: one small RPC per peer carrying
        the mutation's whole (kind, name) batch. A peer that misses the
        delta gets a wholesale reload attempt instead; one that misses
        both is offline and re-syncs through its periodic refresh or
        its boot-time load."""
        def one(p: PeerRPCClient) -> bool:
            return p.iam_delta(pairs) or p.reload_iam()
        return self._broadcast(one)

    def metrics_text_all(self, deadline: float = 2.0
                         ) -> list[tuple[str, Optional[str]]]:
        """One (peer_addr, exposition_text | None) per peer: the
        federated scrape's fan-out; None marks a peer the caller counts
        as scrape-failed rather than failing the whole scrape."""
        results = self._broadcast(
            lambda p: p.metrics_text(deadline=deadline))
        return [(p.addr, r if isinstance(r, str) else None)
                for p, r in zip(self.peers, results)]

    def top_locks(self) -> dict:
        merged: dict = {}
        for locks in self._broadcast(lambda p: p.locks()):
            if isinstance(locks, dict):
                for res, holders in locks.items():
                    merged.setdefault(res, []).extend(holders)
        return merged

    def signal_all(self, sig: str) -> list:
        return self._broadcast(lambda p: p.signal_service(sig))

    def storage_info_all(self) -> list:
        return self._broadcast(lambda p: p.storage_info())

    def trace_all(self) -> list[dict]:
        """Cluster-wide recent trace entries, time-ordered."""
        merged: list[dict] = []
        for entries in self._broadcast(lambda p: p.trace()):
            if isinstance(entries, list):
                merged.extend(e for e in entries if isinstance(e, dict))
        merged.sort(key=lambda e: e.get("time", ""))
        return merged

    def trace_stream_all(self, max_s: float = 3600.0) -> list:
        """One live trace-entry iterator per reachable peer (see
        PeerRPCClient.trace_stream)."""
        return self._stream_all(
            lambda p: p.trace_stream(max_s=max_s))

    def event_stream_all(self, max_s: float = 3600.0) -> list:
        """One live event-journal iterator per reachable peer (see
        PeerRPCClient.event_stream) — the /events?follow=1&cluster=1
        fan-out."""
        return self._stream_all(
            lambda p: p.event_stream(max_s=max_s))

    def _stream_all(self, open_one: Callable[[PeerRPCClient],
                                             object]) -> list:
        """Open one live subscription per reachable peer.
        Subscriptions open concurrently; unreachable peers are simply
        absent — a follow stream degrades to the nodes it can hear. A
        peer that answers only AFTER the collection window has its
        subscription closed by the opener thread itself (nobody else
        will ever see it — an unclosed late iterator would pin that
        peer's hub + a worker for max_s)."""
        results: list = [None] * len(self.peers)
        mu = threading.Lock()
        done = [False]

        def run(i: int, p: PeerRPCClient) -> None:
            r = None
            try:
                r = open_one(p)
            except Exception:  # noqa: BLE001 — peer absent
                r = None
            late = None
            with mu:
                if done[0]:
                    late = r
                else:
                    results[i] = r
            if late is not None:
                late.close()

        threads = [threading.Thread(target=run, args=(i, p),
                                    daemon=True)
                   for i, p in enumerate(self.peers)]
        for t in threads:
            t.start()
        # ONE shared deadline across peers: per-thread join(10) would
        # stall a follow stream's start ~10s PER black-holed peer
        end = time.monotonic() + 10
        for t in threads:
            t.join(timeout=max(end - time.monotonic(), 0))
        with mu:
            done[0] = True
            return [r for r in results
                    if isinstance(r, _TraceLineIter)]

    def events_all(self) -> list[dict]:
        """Cluster-wide recent journal entries, time-ordered (the
        /events?cluster=1 merge)."""
        merged: list[dict] = []
        for entries in self._broadcast(lambda p: p.events()):
            if isinstance(entries, list):
                merged.extend(e for e in entries
                              if isinstance(e, dict))
        merged.sort(key=lambda e: e.get("ts", 0))
        return merged

    def incidents_all(self) -> list[dict]:
        """Cluster-wide incident-bundle summaries, newest first."""
        merged: list[dict] = []
        for entries in self._broadcast(lambda p: p.incidents()):
            if isinstance(entries, list):
                merged.extend(e for e in entries
                              if isinstance(e, dict))
        merged.sort(key=lambda e: e.get("time") or 0, reverse=True)
        return merged

    def incident_any(self, inc_id: str) -> Optional[dict]:
        """Fetch one bundle from whichever peer holds it (bundles are
        node-local; 'retrievable from either node' means asking
        around)."""
        for doc in self._broadcast(lambda p: p.incident(inc_id)):
            if isinstance(doc, dict) and doc:
                return doc
        return None

    def profiling_start_all(self, kinds: str = "cpu") -> list:
        return self._broadcast(lambda p: p.profiling_start(kinds))

    def profiling_stop_all(self, kinds: str = "cpu") -> list:
        return self._broadcast(lambda p: p.profiling_stop(kinds))

    def console_log_all(self, count: int = 0) -> list[dict]:
        """Cluster-wide console entries, time-ordered."""
        merged: list[dict] = []
        for res in self._broadcast(lambda p: p.console_log(count)):
            if isinstance(res, dict):
                merged.extend(e for e in res.get("entries", [])
                              if isinstance(e, dict))
        merged.sort(key=lambda e: e.get("ts", 0))
        return merged

    def obd_all(self) -> list[dict]:
        return [r for r in self._broadcast(lambda p: p.obd())
                if isinstance(r, dict)]

    def net_obd(self, size: int = 4 << 20) -> list[dict]:
        """This node's view of the interconnect: timed payload push to
        every peer, SEQUENTIALLY — concurrent probes would share the
        NIC and report contention, not per-link capacity (the reference
        probes peers one at a time for the same reason). Unreachable
        peers are reported as such rather than dropped."""
        out = []
        for p in self.peers:
            r = None
            try:
                r = p.net_probe(size)
            except Exception:  # noqa: BLE001 — per-peer result
                r = None
            if isinstance(r, dict):
                out.append(r)
            else:
                out.append({"peer": f"{p.rc.host}:{p.rc.port}",
                            "error": "unreachable"})
        return out

    def tracker_rotate_all(self) -> list[Optional[dict]]:
        """One entry per peer: the rotated tracker snapshot, or None
        for an unreachable peer (the scanner must then assume-changed
        for that peer's window)."""
        return [r if isinstance(r, dict) else None
                for r in self._broadcast(lambda p: p.tracker_rotate())]

# ---------------------------------------------------------------------------
# bootstrap verify
# ---------------------------------------------------------------------------

def system_config_hash(endpoints: list[str], access_key: str,
                       secret_key: str) -> str:
    """Digest of the node's view of cluster topology + credentials
    (the reference compares ServerSystemConfig field-by-field; a digest
    keeps secrets off the wire)."""
    blob = json.dumps({
        "endpoints": sorted(endpoints),
        "cred": hashlib.sha256(
            f"{access_key}:{secret_key}".encode()).hexdigest(),
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


class BootstrapRPCServer:
    def __init__(self, access_key: str, secret_key: str,
                 endpoints: list[str]):
        self.handler = RPCHandler(BOOTSTRAP_RPC_PREFIX, access_key,
                                  secret_key)
        self.config_hash = system_config_hash(endpoints, access_key,
                                              secret_key)
        self.handler.register(
            "verify", lambda a, b: {"hash": self.config_hash})

    def route(self, ctx):
        return self.handler.route(ctx)


def verify_server_system_config(peers: list[tuple[str, int]],
                                endpoints: list[str], access_key: str,
                                secret_key: str, retries: int = 30,
                                interval: float = 1.0,
                                node_id: str = "",
                                generation: int = 0) -> None:
    """Block until every peer reports the same config digest
    (cmd/server-main.go:464-478 retry loop). Raises RuntimeError on a
    real mismatch; keeps retrying while peers are unreachable. `node_id`
    and `generation` are the calling node's address and boot generation,
    carried on every call (a peer that knew an earlier generation of this
    node fires its generation listeners, which re-admit it)."""
    want = system_config_hash(endpoints, access_key, secret_key)
    remaining = {f"{h}:{p}" for h, p in peers}
    for _ in range(retries):
        for h, p in list(peers):
            key = f"{h}:{p}"
            if key not in remaining:
                continue
            rc = RestClient(h, p, BOOTSTRAP_RPC_PREFIX, access_key,
                            secret_key, timeout=2.0)
            rc.node_id, rc.generation = node_id, generation
            try:
                got = rc.call_json("verify")
            except (NetworkError, RPCError):
                continue
            finally:
                rc.close()
            if got and got.get("hash") == want:
                remaining.discard(key)
            elif got:
                raise RuntimeError(
                    f"peer {key} has a different cluster config "
                    "(endpoints or credentials mismatch)")
        if not remaining:
            return
        time.sleep(interval)
    raise RuntimeError(f"peers unreachable during bootstrap: "
                       f"{sorted(remaining)}")
