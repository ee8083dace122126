"""Admin API + healthcheck + Prometheus metrics routers.

Counterpart of minio_tpu/s3/admin.py: the reference's /minio/admin/v3
surface (cmd/admin-handlers*.go, cmd/admin-router.go),
/minio/health/{live,ready,cluster} (cmd/healthcheck-*.go) and
/minio/prometheus/metrics (cmd/metrics.go), mounted as extra routers on
the S3 server. Admin calls are SigV4-authenticated: the root credential,
or an IAM identity whose policies allow the admin:* action (an STS
credential must present its session token).

The routes of the planes the port has: info, storageinfo, datausageinfo,
top/locks; heal and heal/status (the heal sequence heals object by object
through the layer, so each heal's recovery runs ``heal_step`` on the
card), mrf, fsck, metacache; rebalance (POST, GET, DELETE) and topology
(GET, POST); tier and tier/stats; metrics (``?cluster=1`` merges every
node's exposition, utils/promfed.py); get-config, set-config,
config-history, restore-config; the user, policy and service-account
routes; service, set-bucket-quota and get-bucket-quota; and the tracing
plane's trace (``?follow=1`` grafts every peer's records), trace/cluster,
spans, events (``?follow=1``, ``?cluster=1``), incidents, slo, consolelog
and profiling/start, profiling/stop; the gray-failure plane's drivehealth
(tracked latencies, quarantine states, the disk monitor's recent
transitions and the journal's ``drive.*`` / ``health.*`` records) and
obdinfo (every node's OBD bundle, utils/obd.py, and the internode net
probes); the checking plane's test-only naughtynet (POST, answered only
with MINIO_TPU_NAUGHTYNET=on). Beside them,
upstream's update-group-members (the reference's router has no route that
fills a group; its IAMSys has the verbs). The routes of the
planes not ported answer a JSON NotImplemented that names the plane
(``_UNPORTED``), as the port's S3 verbs do.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
import uuid
from typing import Optional

from . import signature as sig
# imported at module scope so their metric families and collectors are
# registered as soon as the admin plane exists (minio_tpu_sched_*,
# minio_tpu_pipeline_*, minio_tpu_rpc_*)
from ..distributed import transport as _transport  # noqa: F401
from ..parallel import pipeline as _pipeline  # noqa: F401
from ..parallel import scheduler as _scheduler  # noqa: F401
from ..utils import knobs, telemetry
from .handlers import HTTPResponse, RequestContext
from .s3errors import S3Error

ADMIN_PREFIX = "/minio/admin/v3"
HEALTH_PREFIX = "/minio/health"
METRICS_PREFIX = "/minio/prometheus/metrics"

# federated-scrape degradation accounting: a peer that missed the
# per-peer deadline (or is down) costs its samples, never the scrape —
# this counter is the alert an operator wires to notice
_SCRAPE_FAILED = telemetry.REGISTRY.counter(
    "minio_tpu_cluster_scrape_failed_total",
    "Peer scrapes that failed during a federated ?cluster=1 metrics "
    "render")

# (method, route) -> the unported plane that serves it in the reference
_UNPORTED = {
    ("GET", "bandwidth"): "bandwidth",
    ("GET", "qos"): "QoS",
    ("PUT", "qos"): "QoS",
    ("DELETE", "qos"): "QoS",
    ("GET", "replicate"): "replication",
    ("GET", "replicate/key"): "replication",
    ("PUT", "replicate/target"): "replication",
    ("DELETE", "replicate/target"): "replication",
    ("POST", "replicate/resync"): "replication",
    ("GET", "replicate/resync"): "replication",
    ("DELETE", "replicate/resync"): "replication",
    ("GET", "notify"): "notify",
    ("PUT", "notify/target"): "notify",
    ("DELETE", "notify/target"): "notify",
    ("PUT", "set-remote-target"): "remote targets",
    ("GET", "list-remote-targets"): "remote targets",
    ("DELETE", "remove-remote-target"): "remote targets",
}


class HealSequence:
    """One background heal run, queryable by token
    (cmd/admin-heal-ops.go healSequence)."""

    def __init__(self, object_layer, bucket: str, prefix: str):
        self.token = str(uuid.uuid4())
        self.bucket = bucket
        self.prefix = prefix
        self.status = "running"
        self.items_scanned = 0
        self.items_healed = 0
        self.failures = 0
        self.started = time.time()
        self._obj = object_layer
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        from ..object import api_errors
        try:
            buckets = ([self.bucket] if self.bucket else
                       [v.name for v in self._obj.list_buckets()])
            for b in buckets:
                try:
                    self._obj.heal_bucket(b)
                except api_errors.ObjectApiError:
                    pass
                marker = ""
                while True:
                    objs, _, trunc = self._obj.list_objects(
                        b, self.prefix, marker, "", 1000)
                    for oi in objs:
                        self.items_scanned += 1
                        try:
                            self._obj.heal_object(b, oi.name)
                            self.items_healed += 1
                        except api_errors.ObjectApiError:
                            self.failures += 1
                    if not trunc or not objs:
                        break
                    marker = objs[-1].name
            self.status = "done"
        except Exception:  # noqa: BLE001 — surfaced via status
            self.status = "failed"

    def to_dict(self) -> dict:
        return {"token": self.token, "status": self.status,
                "bucket": self.bucket, "prefix": self.prefix,
                "items_scanned": self.items_scanned,
                "items_healed": self.items_healed,
                "failures": self.failures,
                "elapsed": round(time.time() - self.started, 3)}


class AdminHandlers:
    """Router for /minio/admin/v3/* (mount via S3Server extra routers)."""

    def __init__(self, api, node=None):
        """api: S3ApiHandlers; node: optional ClusterNode (peer plane)."""
        self.api = api
        self.node = node
        self.started = time.time()
        self._heals: dict[str, HealSequence] = {}
        # the metrics endpoint's handler (mount_admin wires it): the
        # admin /metrics route and the peer metrics-text verb both
        # render through it so every surface reports the SAME scrape
        self.metrics: Optional["MetricsHandler"] = None

    # -- auth --------------------------------------------------------------

    def _auth(self, ctx: RequestContext, action: str) -> None:
        at = ctx.auth_type
        if at not in (sig.AUTH_SIGNED, sig.AUTH_PRESIGNED):
            raise S3Error("AccessDenied")
        if at == sig.AUTH_SIGNED:
            body_sha = ctx.header("x-amz-content-sha256",
                                  sig.UNSIGNED_PAYLOAD)
            cred = sig.verify_v4(ctx.req, self.api._cred_lookup,
                                 self.api.region, body_sha)
        else:
            cred = sig.verify_v4_presigned(ctx.req, self.api._cred_lookup,
                                           self.api.region)
        if cred.is_temp():
            # STS credentials must present their session token, same as
            # the S3 authenticate path — a leaked access/secret pair
            # alone must not authorize admin calls.
            token = ctx.header("x-amz-security-token") or \
                ctx.query1("X-Amz-Security-Token")
            if token != cred.session_token:
                raise S3Error("AccessDenied", "invalid security token")
        if cred.access_key == self.api.root_cred.access_key or \
                cred.parent_user == self.api.root_cred.access_key:
            return
        if self.api.iam is not None and self.api.iam.is_allowed(
                cred, action, "", "",
                self.api._policy_conditions(ctx)):
            return
        raise S3Error("AccessDenied")

    # -- dispatch ----------------------------------------------------------

    def route(self, ctx: RequestContext) -> HTTPResponse:
        try:
            return self._route(ctx)
        except S3Error as e:
            return HTTPResponse(
                status=e.status,
                body=json.dumps({"Code": e.code,
                                 "Message": e.message}).encode(),
                headers={"Content-Type": "application/json"})
        except sig.SigError as e:
            return HTTPResponse(
                status=403,
                body=json.dumps({"Code": e.code}).encode(),
                headers={"Content-Type": "application/json"})

    def _route(self, ctx: RequestContext) -> HTTPResponse:
        path = urllib.parse.unquote(ctx.req.path)
        sub = path[len(ADMIN_PREFIX):].strip("/")
        m = ctx.req.method
        plane = _UNPORTED.get((m, sub))
        if plane is not None:
            raise S3Error("NotImplemented",
                          f"the {plane} plane is not served by this port")

        if sub == "info" and m == "GET":
            self._auth(ctx, "admin:ServerInfo")
            return self._json(self.server_info())
        if sub == "storageinfo" and m == "GET":
            self._auth(ctx, "admin:StorageInfo")
            return self._json(self.api.obj.storage_info())
        if sub == "datausageinfo" and m == "GET":
            self._auth(ctx, "admin:DataUsageInfo")
            usage = self.api.usage.usage if self.api.usage is not None \
                else {}
            return self._json(usage)
        if sub == "top/locks" and m == "GET":
            self._auth(ctx, "admin:TopLocksInfo")
            return self._json(self.top_locks())
        if sub == "profiling/start" and m == "POST":
            self._auth(ctx, "admin:Profiling")
            return self._json(self._profiling_start(
                ctx.query1("profilerType", "cpu")))
        if sub == "profiling/stop" and m == "POST":
            self._auth(ctx, "admin:Profiling")
            return self._profiling_stop(
                ctx.query1("profilerType", "cpu"))
        if sub == "consolelog" and m == "GET":
            self._auth(ctx, "admin:ConsoleLog")
            try:
                n = int(ctx.query1("count", "0") or 0)
            except ValueError:
                n = 0
            from ..utils.console import get_console
            entries = list(get_console().recent(n))
            if self.node is not None:
                entries.extend(self.node.notification.console_log_all(n))
            entries.sort(key=lambda e: e.get("ts", 0))
            return self._json({"entries": entries[-1000:]})
        if sub == "drivehealth" and m == "GET":
            # the gray-failure plane's state: per-drive / per-peer latency
            # summaries, quarantine states, recent transitions
            self._auth(ctx, "admin:OBDInfo")
            from ..utils import eventlog, healthtrack
            events: list = []
            mon = getattr(self.node, "disk_monitor", None) \
                if self.node is not None else None
            if mon is not None:
                events = [{"drive": k, "event": e}
                          for k, e in list(mon.quarantine_events)[-100:]]
            return self._json({
                "drives": healthtrack.TRACKER.snapshot("drive"),
                "peers": healthtrack.TRACKER.snapshot("peer"),
                "events": events,
                # journal-backed transition history: replayed from the
                # persisted segments at boot, so convictions survive a
                # restart (the in-memory deque above does not)
                "journal": eventlog.JOURNAL.recent(
                    100, subsystems={"drive", "health"})})
        if sub == "obdinfo" and m == "GET":
            self._auth(ctx, "admin:OBDInfo")
            from ..utils.obd import local_obd
            drives = list(self.node.spec.drives) \
                if self.node is not None else []
            # live StorageAPI objects (any wrapper depth) for the per-drive
            # fault counters; FS layers have no erasure sets and report none
            storage_drives: list = []
            layers = getattr(self.api.obj, "server_sets", None) \
                or [self.api.obj]
            for layer in layers:
                for eng in getattr(layer, "sets", None) or []:
                    storage_drives.extend(eng.disks)
            nodes = [local_obd(drives,
                               storage_drives=storage_drives or None)]
            net: list = []
            if self.node is not None:
                nodes[0]["node"] = self.node.spec.addr
                nodes.extend(self.node.notification.obd_all())
                # internode throughput/RTT from this node's viewpoint
                net = self.node.notification.net_obd(size=1 << 20)
            return self._json({"nodes": nodes, "net": net})
        if sub == "trace/cluster" and m == "GET":
            self._auth(ctx, "admin:ServerTrace")
            entries = list(self.api.trace.recent)
            if self.node is not None:
                entries.extend(self.node.notification.trace_all())
            entries.sort(key=lambda e: e.get("time", ""))
            return self._json({"entries": entries[-500:]})
        if sub == "metrics" and m == "GET":
            # authenticated metrics scrape; ?cluster=1 federates over
            # peer RPC into ONE exposition (counters summed, gauges
            # node-labelled, histograms bucket-merged) — the reference
            # /minio/v2/metrics/cluster analog
            self._auth(ctx, "admin:Prometheus")
            if self.metrics is None:
                raise S3Error("NotImplemented",
                              "metrics handler not mounted")
            if ctx.query1("cluster") == "1" and self.node is not None:
                text = self.cluster_metrics_text()
            else:
                text = self.metrics.local_text()
            return HTTPResponse(body=text.encode(),
                                headers={"Content-Type": "text/plain"})
        if sub == "spans" and m == "GET":
            # tail-sampled span trees (errors, slow requests, sampled
            # ordinary traffic), RPC fragments grafted in — the "where
            # did this slow PUT spend its time" endpoint. ?api= keeps
            # one API's roots (root names ARE api names under the
            # middleware), ?trace_id= selects the tree a trace-stream
            # entry named.
            self._auth(ctx, "admin:ServerTrace")
            try:
                n = int(ctx.query1("count", "50") or 50)
            except ValueError:
                raise S3Error("AdminInvalidArgument",
                              "bad count") from None
            slowest = ctx.query1("sort", "recent") == "slowest"
            return self._json({
                "spans": telemetry.SPANS.dump(
                    n, slowest=slowest, name=ctx.query1("api", ""),
                    trace_id=ctx.query1("trace_id", "")),
                "kept_total": telemetry.SPANS.kept_total,
                "dropped_total": telemetry.SPANS.dropped_total,
                "slow_threshold_ms": round(
                    telemetry.SPANS.slow_s * 1e3, 3),
                "sample": telemetry.SPANS.sample,
            })
        if sub == "trace" and m == "GET":
            # live ND-JSON request records. Default: bounded stream
            # that ends on idle. ?follow=1 is the `mc admin
            # trace` analog — a long-lived stream with heartbeats, and
            # (on a cluster node) every PEER's records grafted in via
            # trace-stream subscriptions, so one client watches the
            # whole cluster. ?api=PutObject,GetObject and ?err=1
            # filter; filters apply to peer records too.
            self._auth(ctx, "admin:ServerTrace")
            follow = ctx.query1("follow", "") in ("1", "true")
            apis = {a for a in ctx.query1("api", "").split(",") if a} \
                or None
            errors_only = ctx.query1("err", "") in ("1", "true")
            try:
                n = int(ctx.query1("count", "0") or 0)
                idle = float(ctx.query1("idle", "10") or 10)
            except ValueError:
                raise S3Error("AdminInvalidArgument",
                              "bad count/idle") from None
            idle = min(max(idle, 1.0), 3600.0)
            max_s = knobs.get_float("MINIO_TPU_TRACE_FOLLOW_MAX_S")
            peer_subs = None
            if follow and self.node is not None:
                # a CALLABLE: the subscriptions open at the stream's
                # first iteration, so a response abandoned before its
                # first chunk never opens peers it cannot close
                node = self.node
                peer_subs = (lambda:
                             node.notification.trace_stream_all(
                                 max_s=max_s))
            return HTTPResponse(
                headers={"Content-Type": "application/x-ndjson"},
                stream=self.api.trace.stream(
                    max_entries=n, idle_timeout=idle, follow=follow,
                    apis=apis, errors_only=errors_only,
                    peer_subs=peer_subs, max_s=max_s),
                long_poll=follow)
        if sub == "events" and m == "GET":
            # the incident plane's journal. Default: the recent ring
            # window as JSON (?cluster=1 merges peer windows, deduped
            # by (node, seq) — in-process test clusters share one
            # journal). ?follow=1 streams ND-JSON live with peer
            # grafting — same contract (and lazy-subscription lesson)
            # as /trace?follow=1. Filters: ?class=a,b ?sub=drive,net
            # ?sev=warn (minimum severity); they apply to peer
            # entries too.
            self._auth(ctx, "admin:ServerTrace")
            from ..utils import eventlog
            classes = {c for c in ctx.query1("class", "").split(",")
                       if c} or None
            subsys = {s for s in ctx.query1("sub", "").split(",")
                      if s} or None
            sev = ctx.query1("sev", "")
            min_sev = eventlog.sev_rank(sev) if sev else 0
            follow = ctx.query1("follow", "") in ("1", "true")
            try:
                n = int(ctx.query1("count", "0") or 0)
                idle = float(ctx.query1("idle", "10") or 10)
            except ValueError:
                raise S3Error("AdminInvalidArgument",
                              "bad count/idle") from None
            if follow:
                idle = min(max(idle, 1.0), 3600.0)
                max_s = knobs.get_float(
                    "MINIO_TPU_EVENTS_FOLLOW_MAX_S")
                peer_subs = None
                if self.node is not None:
                    # a CALLABLE: subscriptions open at the stream's
                    # first iteration, so a response abandoned before
                    # its first chunk never opens peers it cannot
                    # close
                    node = self.node
                    peer_subs = (lambda:
                                 node.notification.event_stream_all(
                                     max_s=max_s))
                return HTTPResponse(
                    headers={"Content-Type":
                             "application/x-ndjson"},
                    stream=eventlog.JOURNAL.stream(
                        max_entries=n, idle_timeout=idle,
                        follow=True, classes=classes,
                        subsystems=subsys, min_sev=min_sev,
                        peer_subs=peer_subs, max_s=max_s),
                    long_poll=True)
            entries = eventlog.JOURNAL.recent(n, classes, subsys,
                                              min_sev)
            if ctx.query1("cluster") == "1" and self.node is not None:
                seen = {(e.get("node"), e.get("seq"))
                        for e in entries}
                for e in self.node.notification.events_all():
                    k = (e.get("node"), e.get("seq"))
                    if k in seen:
                        continue
                    if eventlog.JOURNAL.entry_matches(
                            e, classes, subsys, min_sev):
                        seen.add(k)
                        entries.append(e)
                entries.sort(key=lambda e: e.get("ts", 0))
            return self._json({"events": entries[-1000:]})
        if sub == "incidents" and m == "GET":
            # black-box capture bundles. ?id= fetches one bundle —
            # asking every peer when it is not local (bundles live on
            # the node that captured them); default lists summaries,
            # ?cluster=1 merging peer lists.
            self._auth(ctx, "admin:OBDInfo")
            from ..utils import incidents as inc_mod
            inc_id = ctx.query1("id", "")
            if inc_id:
                doc = inc_mod.RECORDER.get(inc_id)
                if doc is None and self.node is not None:
                    doc = self.node.notification.incident_any(inc_id)
                if doc is None:
                    raise S3Error("AdminInvalidArgument",
                                  "unknown incident id")
                return self._json(doc)
            out = inc_mod.RECORDER.list()
            if ctx.query1("cluster") == "1" and self.node is not None:
                have = {i.get("id") for i in out}
                for i in self.node.notification.incidents_all():
                    if i.get("id") not in have:
                        have.add(i.get("id"))
                        out.append(i)
                out.sort(key=lambda i: i.get("time") or 0,
                         reverse=True)
            return self._json({"incidents": out})
        if sub == "slo" and m == "GET":
            # burn-rate status per objective — what `mc admin` would
            # render as the error-budget dashboard
            self._auth(ctx, "admin:ServerInfo")
            from ..utils import slo
            return self._json(slo.ENGINE.status())
        if sub == "heal" and m == "POST":
            self._auth(ctx, "admin:Heal")
            bucket = ctx.query1("bucket")
            prefix = ctx.query1("prefix")
            seq = HealSequence(self.api.obj, bucket, prefix)
            self._heals[seq.token] = seq
            return self._json({"token": seq.token})
        if sub == "heal/status" and m == "GET":
            self._auth(ctx, "admin:Heal")
            seq = self._heals.get(ctx.query1("token"))
            if seq is None:
                raise S3Error("AdminInvalidArgument", "unknown heal token")
            return self._json(seq.to_dict())
        if sub == "mrf" and m == "GET":
            # MRF ("most recently failed") heal-queue stats: pending /
            # healed / requeued / failed / dropped per backend that has
            # a queue (erasure sets and zones; FS/gateway report {})
            self._auth(ctx, "admin:Heal")
            fn = getattr(self.api.obj, "mrf_stats", None)
            return self._json(fn() if callable(fn) else {})
        if sub == "fsck" and m in ("GET", "POST"):
            # crash-consistency auditor (object/fsck.py): GET audits,
            # POST audits AND repairs (repairable classes feed the
            # heal/delete/rebuild machinery; lost data is reported).
            # ?bucket= narrows, ?tmp_age=0 treats ALL staged tmp as
            # stale (boot/harness mode — nothing can be in flight)
            self._auth(ctx, "admin:Heal")
            from ..object.fsck import run_fsck
            bucket = ctx.query1("bucket")
            try:
                age = float(ctx.query1("tmp_age", "-1") or -1)
            except ValueError:
                raise S3Error("AdminInvalidArgument",
                              "bad tmp_age") from None
            report = run_fsck(self.api.obj, repair=(m == "POST"),
                              tiers=self.api.tiers,
                              buckets=[bucket] if bucket else None,
                              tmp_age_s=age if age >= 0 else None)
            return self._json(report.to_dict())
        if sub == "naughtynet" and m == "POST":
            # test-only network chaos control (distributed/naughtynet):
            # a harness partitions/heals/configures a LIVE node's fault
            # injector from outside the process. Gated off by default —
            # a production node must not expose a verb that severs its
            # own links
            self._auth(ctx, "admin:ServerUpdate")
            if not knobs.get_bool("MINIO_TPU_NAUGHTYNET"):
                raise S3Error(
                    "NotImplemented",
                    "network chaos is disabled "
                    "(MINIO_TPU_NAUGHTYNET=on enables this verb)")
            from ..distributed import naughtynet
            try:
                payload = json.loads(ctx.read_body().decode() or "{}")
                return self._json(naughtynet.handle_admin(payload))
            except (ValueError, TypeError) as e:
                raise S3Error("AdminInvalidArgument", str(e)) from None
        if sub == "metacache" and m == "GET":
            # bucket metacache visibility (ROADMAP item 2 `mc.stats()`
            # remainder): per-bucket index state (entries, building/
            # ready, invalid, dirty names, generation), pending journal
            # deltas, and the serve/fallback/drop/reconcile counters —
            # ?bucket= narrows to one bucket's entry
            self._auth(ctx, "admin:ServerInfo")
            mc = getattr(self.api.obj, "metacache", None)
            if mc is None:
                return self._json({"enabled": False})
            st = mc.stats()
            st["enabled"] = True
            bucket = ctx.query1("bucket")
            if bucket:
                st["buckets"] = {b: v for b, v in st["buckets"].items()
                                 if b == bucket}
            return self._json(st)

        # -- topology plane: pool states, decommission, rebalance ----------
        if sub == "rebalance" and m == "POST":
            # start draining a pool: its objects migrate to the active
            # pools in the background (upstream decommission start)
            self._auth(ctx, "admin:Rebalance")
            try:
                pool = int(ctx.query1("pool", "-1"))
            except ValueError:
                raise S3Error("AdminInvalidArgument",
                              "bad pool index") from None
            return self._json(self._topology_call(
                "start_decommission", pool))
        if sub == "rebalance" and m == "GET":
            self._auth(ctx, "admin:Rebalance")
            return self._json(self._topology_call("rebalance_status"))
        if sub == "rebalance" and m == "DELETE":
            self._auth(ctx, "admin:Rebalance")
            return self._json(self._topology_call("cancel_rebalance"))
        if sub == "topology" and m == "GET":
            self._auth(ctx, "admin:Rebalance")
            topo = getattr(self.api.obj, "topology", None)
            if topo is None:
                raise S3Error("NotImplemented",
                              "backend has no pool topology")
            return self._json(topo.to_dict())
        if sub == "topology" and m == "POST":
            # suspend/resume a pool for writes without draining it
            self._auth(ctx, "admin:Rebalance")
            try:
                pool = int(ctx.query1("pool", "-1"))
            except ValueError:
                raise S3Error("AdminInvalidArgument",
                              "bad pool index") from None
            state = ctx.query1("state", "")
            epoch = self._topology_call("set_pool_state", pool, state)
            return self._json({"pool": pool, "state": state,
                               "epoch": epoch})

        # -- tiering plane: remote tier registry (cmd/tier-handlers.go) ----
        if sub == "tier" and m == "GET":
            self._auth(ctx, "admin:ListTier")
            tiers = self._tiers()
            return self._json({"epoch": tiers.epoch,
                               "tiers": tiers.list(redact=True)})
        if sub == "tier" and m == "PUT":
            # add (or with ?force=true update) one named remote tier
            self._auth(ctx, "admin:SetTier")
            from ..tier.config import TierConfig, TierConfigError
            try:
                body = json.loads(ctx.read_body().decode() or "{}")
                cfg = TierConfig.from_dict(body)
            except (ValueError, TierConfigError) as e:
                raise S3Error("AdminInvalidArgument", str(e)) from None
            update = ctx.query1("force", "") == "true"
            try:
                epoch = self._tiers().add(cfg, update=update)
            except TierConfigError as e:
                code = "XMinioAdminTierAlreadyExists" \
                    if "already exists" in str(e) \
                    else "AdminInvalidArgument"
                raise S3Error(code, str(e)) from None
            return self._json({"name": cfg.name, "epoch": epoch})
        if sub == "tier" and m == "DELETE":
            self._auth(ctx, "admin:SetTier")
            from ..object import api_errors as _oerr
            name = ctx.query1("name", "")
            # removing a tier that lifecycle rules still reference
            # strands every transitioned stub behind an unrestorable
            # pointer — refuse unless ?force=true
            if ctx.query1("force", "") != "true" and \
                    self._tier_in_use(name):
                raise S3Error(
                    "XMinioAdminTierBackendInUse",
                    f"tier {name!r} is referenced by a lifecycle "
                    "Transition rule; detach the rule or pass "
                    "force=true")
            try:
                epoch = self._tiers().remove(name)
            except _oerr.TierNotFound:
                raise S3Error("XMinioAdminTierNotFound", name) from None
            return self._json({"name": name, "epoch": epoch})
        if sub == "tier/stats" and m == "GET":
            # transition-worker queue/throughput counters (the madmin
            # tier-status surface)
            self._auth(ctx, "admin:ListTier")
            worker = getattr(self.node, "transition_worker", None) \
                if self.node is not None else None
            return self._json(worker.stats() if worker is not None
                              else {})

        # -- config KV (cmd/admin-handlers-config-kv.go) -------------------
        if sub == "get-config" and m == "GET":
            self._auth(ctx, "admin:ConfigUpdate")
            return self._json(self._config().dump())
        if sub == "set-config" and m == "PUT":
            self._auth(ctx, "admin:ConfigUpdate")
            subsys = ctx.query1("subsys")
            kv = json.loads(ctx.read_body().decode() or "{}")
            cfg = self._config()
            from ..config import kv as _kvmod
            try:
                cfg.set_kv(subsys, **{k: str(v) for k, v in kv.items()})
            except _kvmod.ConfigError as e:
                raise S3Error("AdminInvalidArgument", str(e)) from None
            cfg.apply(self.api, trace=self.api.trace)
            return self._json({})
        if sub == "config-history" and m == "GET":
            self._auth(ctx, "admin:ConfigUpdate")
            return self._json({"entries": self._config().history()})
        if sub == "restore-config" and m == "PUT":
            self._auth(ctx, "admin:ConfigUpdate")
            cfg = self._config()
            cfg.restore(ctx.query1("entry"))
            cfg.apply(self.api, trace=self.api.trace)
            return self._json({})

        # -- IAM management (cmd/admin-handlers-users.go) ------------------
        if sub == "add-user" and m == "PUT":
            self._auth(ctx, "admin:CreateUser")
            body = json.loads(ctx.read_body().decode() or "{}")
            self._iam().add_user(ctx.query1("accessKey"),
                                 body.get("secretKey", ""),
                                 body.get("status", "on"))
            return self._json({})
        if sub == "remove-user" and m == "DELETE":
            self._auth(ctx, "admin:DeleteUser")
            self._iam().remove_user(ctx.query1("accessKey"))
            return self._json({})
        if sub == "list-users" and m == "GET":
            self._auth(ctx, "admin:ListUsers")
            return self._json({"users": self._iam().list_users()})
        if sub == "set-user-status" and m == "PUT":
            self._auth(ctx, "admin:EnableUser")
            self._iam().set_user_status(ctx.query1("accessKey"),
                                        ctx.query1("status"))
            return self._json({})
        if sub == "add-canned-policy" and m == "PUT":
            self._auth(ctx, "admin:CreatePolicy")
            from ..iam.policy import Policy
            self._iam().set_policy(
                ctx.query1("name"),
                Policy.from_json(ctx.read_body().decode()))
            return self._json({})
        if sub == "remove-canned-policy" and m == "DELETE":
            self._auth(ctx, "admin:DeletePolicy")
            self._iam().delete_policy(ctx.query1("name"))
            return self._json({})
        if sub == "list-canned-policies" and m == "GET":
            self._auth(ctx, "admin:ListUserPolicies")
            return self._json({
                "policies": sorted(self._iam().policies)})
        if sub == "set-user-or-group-policy" and m == "PUT":
            self._auth(ctx, "admin:AttachUserOrGroupPolicy")
            self._iam().attach_policy(
                ctx.query1("policyName"),
                user=ctx.query1("userOrGroup")
                if ctx.query1("isGroup") != "true" else "",
                group=ctx.query1("userOrGroup")
                if ctx.query1("isGroup") == "true" else "")
            return self._json({})
        if sub == "service" and m == "POST":
            self._auth(ctx, "admin:ServiceRestart")
            action = ctx.query1("action", "")
            if action not in ("restart", "stop"):
                raise S3Error("AdminInvalidArgument",
                              f"unknown service action {action!r}")
            if self.node is not None:
                self.node.notification.signal_all(action)
            # defer the local action so this response reaches the client
            # (reference cmd/service.go restarts via exec after reply)
            import threading as _threading
            _threading.Timer(0.2, self.service_action, (action,)).start()
            return self._json({"status": "success", "action": action})
        if sub == "set-bucket-quota" and m == "PUT":
            self._auth(ctx, "admin:SetBucketQuota")
            bucket = ctx.query1("bucket", "")
            self._require_bucket(bucket)
            body = json.loads(ctx.read_body().decode() or "{}")
            quota = int(body.get("quota", 0))
            qtype = (body.get("quotatype") or body.get("type")
                     or "hard").lower()
            if quota < 0 or qtype not in ("hard", "fifo"):
                raise S3Error("AdminInvalidArgument", "bad quota spec")
            self.api.bucket_meta.update(
                bucket, quota={"quota": quota, "type": qtype}
                if quota else {})
            return self._json({})
        if sub == "get-bucket-quota" and m == "GET":
            self._auth(ctx, "admin:GetBucketQuota")
            bucket = ctx.query1("bucket", "")
            return self._json(
                self.api.bucket_meta.get(bucket).quota or {})
        if sub == "update-group-members" and m == "PUT":
            # upstream's route (cmd/admin-handlers-users.go
            # UpdateGroupMembers); the reference's router has none
            self._auth(ctx, "admin:AddUserToGroup")
            body = json.loads(ctx.read_body().decode() or "{}")
            group = str(body.get("group", ""))
            members = [str(u) for u in body.get("members") or []]
            if not group:
                raise S3Error("AdminInvalidArgument", "group is required")
            from ..iam.sys import IAMError
            try:
                if body.get("isRemove"):
                    self._iam().remove_members_from_group(group, members)
                else:
                    self._iam().add_members_to_group(group, members)
            except IAMError as e:
                raise S3Error("AdminInvalidArgument", str(e)) from None
            return self._json({})
        if sub == "add-service-account" and m == "PUT":
            self._auth(ctx, "admin:CreateServiceAccount")
            body = json.loads(ctx.read_body().decode() or "{}")
            cred = self._iam().new_service_account(
                body.get("parent", ""), body.get("accessKey", ""),
                body.get("secretKey", ""))
            return self._json({"accessKey": cred.access_key,
                               "secretKey": cred.secret_key})

        raise S3Error("AdminInvalidArgument",
                      f"unknown admin call {m} {sub!r}")

    def _iam(self):
        if self.api.iam is None:
            raise S3Error("NotImplemented", "IAM is not configured")
        return self.api.iam

    def _tiers(self):
        if self.api.tiers is None:
            raise S3Error("NotImplemented",
                          "backend has no tier configuration")
        return self.api.tiers

    def _tier_in_use(self, name: str) -> bool:
        """True when any bucket's lifecycle Transition rule names this
        tier (best-effort: an unlistable namespace blocks nothing)."""
        from ..features.lifecycle import Lifecycle
        try:
            buckets = [v.name for v in self.api.obj.list_buckets()]
        except Exception:  # noqa: BLE001 — can't enumerate: don't block
            return False
        for b in buckets:
            xml = self.api.bucket_meta.get(b).lifecycle_xml
            if not xml:
                continue
            try:
                lc = Lifecycle.from_xml(xml)
            except Exception:  # noqa: BLE001 — malformed config
                continue
            for r in lc.rules:
                if r.enabled and name in (r.transition_tier,
                                          r.noncurrent_transition_tier):
                    return True
        return False

    def _topology_call(self, method: str, *args):
        """Dispatch a topology-plane verb on the object layer; backends
        without pools (FS, gateways) answer NotImplemented and invalid
        transitions map to AdminInvalidArgument."""
        from ..object.topology import TopologyError
        fn = getattr(self.api.obj, method, None)
        if not callable(fn):
            raise S3Error("NotImplemented",
                          "backend has no pool topology")
        try:
            return fn(*args)
        except TopologyError as e:
            raise S3Error("AdminInvalidArgument", str(e)) from None

    def _require_bucket(self, bucket: str) -> None:
        """Quota/remote-target admin must target a REAL bucket —
        bucket_meta.get() silently defaults for unknown names, so the
        existence check has to hit the object layer (review r3)."""
        from ..object import api_errors
        try:
            self.api.obj.get_bucket_info(bucket)
        except api_errors.BucketNotFound:
            raise S3Error("NoSuchBucket",
                          f"bucket {bucket!r} does not exist") from None

    def service_action(self, action: str) -> None:
        """Local service restart/stop. Overridable hook; the default
        re-execs the process for restart (reference cmd/service.go
        restartProcess) and exits for stop."""
        import os
        import sys
        if action == "restart":
            os.execv(sys.executable, [sys.executable] + sys.argv)
        elif action == "stop":
            os._exit(0)

    def _config(self):
        cfg = getattr(self.api, "config", None)
        if cfg is None:
            from ..config import ConfigSys
            cfg = ConfigSys(self.api.obj,
                            secret=self.api.root_cred.secret_key)
            self.api.config = cfg
        return cfg

    @staticmethod
    def _json(payload: dict) -> HTTPResponse:
        return HTTPResponse(body=json.dumps(payload).encode(),
                            headers={"Content-Type": "application/json"})

    # -- info --------------------------------------------------------------

    def server_info(self) -> dict:
        info = {
            "version": "minio-tpu-dev",
            "uptime": round(time.time() - self.started, 3),
            "region": self.api.region,
            "storage": self.api.obj.storage_info()
            if self.api.obj is not None else {},
        }
        if self.node is not None:
            info["node"] = self.node.spec.addr
            info["sets"] = self.node.set_count
            info["drives_per_set"] = self.node.set_drive_count
            peers = self.node.notification.server_info_all()
            info["peers"] = [p for p in peers if isinstance(p, dict)]
        return info

    def _profiling_start(self, kinds: str = "cpu") -> dict:
        """Start profiling on EVERY node: locally via the process
        profilers, cluster-wide via the peer fan-out (reference admin
        profiling/start?profilerType=cpu,mem,
        cmd/admin-handlers.go:461-525 + peerRESTMethodStartProfiling;
        cProfile = pprof-cpu, tracemalloc = pprof-heap)."""
        from ..utils import profiling
        wanted = profiling.parse_kinds(kinds)
        bad = [k for k in profiling.split_raw(kinds)
               if k not in profiling.KINDS]
        if bad or not wanted:
            raise S3Error("AdminInvalidArgument",
                          f"unknown profiler type(s) {bad or kinds!r}; "
                          f"supported: {', '.join(profiling.KINDS)}")
        out = {"kinds": {k: ("started" if profiling.start(k)
                             else "already running") for k in wanted}}
        if self.node is not None:
            peers = self.node.notification.profiling_start_all(
                ",".join(wanted))
            out["peers"] = [p for p in peers if isinstance(p, dict)]
        return out

    def _profiling_stop(self, kinds: str = "cpu") -> HTTPResponse:
        """Stop everywhere and return one zip with a profile per
        (kind, node) (reference downloads a zip of all nodes'
        profiles)."""
        import io
        import zipfile
        from ..utils import profiling
        wanted = profiling.parse_kinds(kinds)
        bad = [k for k in profiling.split_raw(kinds)
               if k not in profiling.KINDS]
        if bad or not wanted:
            # stop must reject what start rejects — a typo'd stop
            # otherwise tears down someone else's cpu profile
            raise S3Error("AdminInvalidArgument",
                          f"unknown profiler type(s) {bad or kinds!r}; "
                          f"supported: {', '.join(profiling.KINDS)}")
        local_name = self.node.spec.addr if self.node is not None \
            else "local"
        profiles: list[tuple[str, str, str]] = []
        for k in wanted:
            local = profiling.stop_text(k)
            if local is not None:
                profiles.append((k, local_name, local))
        if self.node is not None:
            for res in self.node.notification.profiling_stop_all(
                    ",".join(wanted)):
                if not isinstance(res, dict):
                    continue
                for k, text in (res.get("profiles") or {}).items():
                    if text:
                        profiles.append((k, res.get("node", "peer"),
                                         text))
                if res.get("profile"):          # legacy single-kind
                    profiles.append(("cpu", res.get("node", "peer"),
                                     res["profile"]))
        if not profiles:
            raise S3Error("AdminInvalidArgument", "profiling not running")
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for kind, node, text in profiles:
                safe = node.replace(":", "_").replace("/", "_")
                zf.writestr(f"profile-{kind}-{safe}.txt", text)
        return HTTPResponse(body=buf.getvalue(),
                            headers={"Content-Type": "application/zip"})

    def top_locks(self) -> dict:
        merged: dict = {}
        if self.node is not None:
            merged.update(self.node.notification.top_locks())
            local = self.node.locker.dump()
        else:
            local = {}
        for res, holders in local.items():
            merged.setdefault(res, []).extend(holders)
        return merged

    def cluster_metrics_text(self) -> str:
        """The federated scrape: pull every peer's exposition (bounded
        by the per-peer MINIO_TPU_CLUSTER_SCRAPE_S deadline), count
        failures, then merge with this node's OWN render — local render
        runs AFTER the failure counting so the degraded-scrape counter
        appears in the very response that degraded."""
        from ..utils import promfed
        deadline = knobs.get_float("MINIO_TPU_CLUSTER_SCRAPE_S")
        peers = self.node.notification.metrics_text_all(
            deadline=deadline) if self.node is not None else []
        for addr, text in peers:
            if text is None:
                _SCRAPE_FAILED.inc(node=addr)
        local_name = self.node.spec.addr if self.node is not None \
            else "local"
        nodes = [(local_name, self.metrics.local_text())]
        nodes.extend((a, t) for a, t in peers if t is not None)
        return promfed.merge_expositions(nodes)


class HealthHandlers:
    """/minio/health/{live,ready,cluster} (cmd/healthcheck-handler.go)."""

    def __init__(self, api):
        self.api = api

    def route(self, ctx: RequestContext) -> HTTPResponse:
        sub = ctx.req.path[len(HEALTH_PREFIX):].strip("/")
        if sub == "live":
            return HTTPResponse(status=200)
        if sub in ("ready", "cluster"):
            obj = self.api.obj
            if obj is None:
                return HTTPResponse(status=503)
            try:
                info = obj.storage_info()
            except Exception:  # noqa: BLE001 — failure = not ready
                return HTTPResponse(status=503)
            total = info["online_disks"] + info["offline_disks"]
            # ready when a write quorum of drives is online
            if total and info["online_disks"] > total // 2:
                return HTTPResponse(status=200)
            return HTTPResponse(status=503)
        return HTTPResponse(status=404)


class MetricsHandler:
    """Prometheus text exposition (cmd/metrics.go analog).

    Every sample now comes out of the shared telemetry registry
    (utils/telemetry.REGISTRY): subsystems that own live state
    (pipeline overlap, scheduler queue, admission gate, RPC transport)
    register their own collectors; the server-topology gauges below
    are refreshed here because only this handler holds the api/node
    handles. Metric names predate the registry and stay stable."""

    def __init__(self, api, node=None):
        self.api = api
        self.node = node
        self.reg = telemetry.REGISTRY

    def _collect(self) -> None:
        g = self.reg.gauge
        try:
            info = self.api.obj.storage_info() if self.api.obj else {}
        except Exception:  # noqa: BLE001
            info = {}
        g("minio_disks_online", "Online drives").set(
            info.get("online_disks", 0))
        g("minio_disks_offline", "Offline drives").set(
            info.get("offline_disks", 0))
        g("minio_capacity_raw_total_bytes", "Raw capacity").set(
            info.get("total", 0))
        g("minio_capacity_raw_free_bytes", "Raw free").set(
            info.get("free", 0))
        if self.api.usage is not None:
            u = self.api.usage.usage
            g("minio_usage_object_total", "Objects").set(
                u.get("objects_total", 0))
            g("minio_usage_size_total_bytes", "Logical bytes").set(
                u.get("size_total", 0))
            bg = g("minio_bucket_usage_size_bytes",
                   "Logical bytes per bucket")
            bg.clear()          # deleted buckets must drop off
            for b, v in u.get("buckets", {}).items():
                bg.set(v["size"], bucket=b)
        # MRF heal queue (degraded reads/writes awaiting re-redundancy)
        mrf_fn = getattr(self.api.obj, "mrf_stats", None)
        if callable(mrf_fn):
            try:
                mrf = mrf_fn()
            except Exception:  # noqa: BLE001
                mrf = {}
            g("minio_heal_mrf_pending",
              "Objects queued for MRF heal").set(mrf.get("pending", 0))
            g("minio_heal_mrf_healed_total",
              "Objects healed via MRF").set(mrf.get("healed", 0))
            g("minio_heal_mrf_failed_total",
              "MRF heals that exhausted retries").set(
                mrf.get("failed", 0))
            g("minio_heal_mrf_dropped_total",
              "MRF enqueues dropped (queue full)").set(
                mrf.get("dropped", 0))
        # background plane liveness: consecutive scan failures per loop
        if self.node is not None:
            for attr, name in (("disk_monitor", "disk_monitor"),
                               ("heal_scanner", "heal_scanner"),
                               ("crawler", "crawler")):
                loop = getattr(self.node, attr, None)
                if loop is not None:
                    g(f"minio_{name}_consecutive_errors",
                      f"Consecutive failed {name} scans").set(
                        getattr(loop, "consecutive_errors", 0))

    def local_text(self) -> str:
        """This node's full exposition with the server-scoped refresh
        applied — what /minio/prometheus/metrics serves, what the admin
        /metrics route returns, and what the peer `metrics-text` verb
        hands a federating scraper. One renderer, three surfaces."""
        return self.reg.render(self._collect)

    def route(self, ctx: RequestContext) -> HTTPResponse:
        # _collect runs as this scrape's one-shot collector, NOT a
        # globally registered one: with several servers in one process
        # each metrics endpoint must report ITS api/node values, and a
        # stopped server must stop reporting (registered collectors
        # live as long as the process-global registry)
        return HTTPResponse(body=self.local_text().encode(),
                            headers={"Content-Type": "text/plain"})


def mount_admin(server, node=None) -> AdminHandlers:
    """Attach admin/health/metrics routers to an S3Server."""
    admin = AdminHandlers(server.api, node)
    server.admin = admin       # reachable from the server handle
    admin.metrics = MetricsHandler(server.api, node)
    server.register_router(ADMIN_PREFIX, admin.route)
    server.register_router(HEALTH_PREFIX, HealthHandlers(server.api).route)
    server.register_router(METRICS_PREFIX, admin.metrics.route)
    return admin
