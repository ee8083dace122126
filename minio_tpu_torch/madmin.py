"""Admin client SDK (reference pkg/madmin): a typed Python client for
the /minio/admin/v3 surface, /minio/health, and the metrics endpoint —
what `mc admin ...` scripts against.

Counterpart of minio_tpu/madmin.py for the routes the port's admin router
serves (s3/admin.py), the tracing plane's among them (trace and
trace_follow, cluster_trace, events and events_follow, incidents and
incident, slo, spans, profiling_start and profiling_stop, console_log) and
the gray-failure plane's (obd_info, drive_health), the checking
plane's naughtynet, the QoS plane's qos_get, qos_set and qos_remove,
the notification plane's notify_status, add_notify_target and
remove_notify_target, the replication plane's replicate_status,
replicate_key_versions, add_replicate_target, remove_replicate_target,
start_replicate_resync, replicate_resync_status and
cancel_replicate_resync, and the bucket remote targets' set_remote_target,
list_remote_targets and remove_remote_target. ``update_group_members``
drives a route the reference's router lacks (upstream's
update-group-members); the other calls are the reference's. Left out
with its plane: bandwidth."""

from __future__ import annotations

import hashlib
import http.client
import json
import urllib.parse
from typing import Iterator, Optional

from .s3 import signature as sig
from .s3.credentials import Credentials

ADMIN_PREFIX = "/minio/admin/v3"


class AdminClientError(Exception):
    def __init__(self, status: int, payload: dict):
        super().__init__(f"{status}: {payload}")
        self.status = status
        self.payload = payload


class AdminClient:
    def __init__(self, host: str, port: int, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 timeout: float = 30.0):
        self.host, self.port = host, port
        self.creds = Credentials(access_key, secret_key)
        self.region = region
        self.timeout = timeout

    # -- plumbing ----------------------------------------------------------

    def _request(self, method: str, sub: str,
                 query: Optional[dict] = None, body: bytes = b"",
                 prefix: str = ADMIN_PREFIX, sign: bool = True):
        path = f"{prefix}/{sub}" if sub else prefix
        query = {k: [v] for k, v in (query or {}).items()}
        qs = urllib.parse.urlencode({k: v[0] for k, v in query.items()})
        hdrs = {"host": f"{self.host}:{self.port}"}
        if sign:
            hdrs = sig.sign_v4(method, path, query, hdrs,
                               hashlib.sha256(body).hexdigest(),
                               self.creds, self.region)
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        conn.request(method, path + (f"?{qs}" if qs else ""), body=body,
                     headers=hdrs)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        if resp.status >= 300:
            try:
                payload = json.loads(data.decode())
            except ValueError:
                payload = {"raw": data.decode(errors="replace")}
            raise AdminClientError(resp.status, payload)
        return data

    def _json(self, method, sub, query=None, body: bytes = b""):
        out = self._request(method, sub, query, body)
        return json.loads(out.decode()) if out else {}

    # -- info / health -----------------------------------------------------

    def server_info(self) -> dict:
        return self._json("GET", "info")

    def storage_info(self) -> dict:
        return self._json("GET", "storageinfo")

    def data_usage_info(self) -> dict:
        return self._json("GET", "datausageinfo")

    def top_locks(self) -> dict:
        return self._json("GET", "top/locks")

    def alive(self) -> bool:
        try:
            self._request("GET", "live", prefix="/minio/health",
                          sign=False)
            return True
        except AdminClientError:
            return False

    def metrics_text(self) -> str:
        return self._request("GET", "", prefix="/minio/prometheus/metrics",
                             sign=False).decode()

    def cluster_metrics(self) -> str:
        """ONE Prometheus exposition for the whole cluster: the serving
        node scrapes every peer over RPC and merges (counters summed,
        gauges carrying a `node` label, histograms bucket-merged). A
        dead peer degrades the scrape — check
        `minio_tpu_cluster_scrape_failed_total` in the output."""
        return self._request("GET", "metrics",
                             {"cluster": "1"}).decode()

    def node_metrics(self) -> str:
        """The serving node's own exposition via the authenticated
        admin route (the anonymous endpoint's SigV4 twin)."""
        return self._request("GET", "metrics").decode()

    # -- heal --------------------------------------------------------------

    def fsck(self, repair: bool = False, bucket: str = "",
             tmp_age_s: Optional[float] = None) -> dict:
        """Run the crash-consistency auditor; ``repair=True`` also
        repairs (POST). ``tmp_age_s=0`` reaps ALL staged tmp leftovers
        (safe only when nothing is in flight)."""
        q = {}
        if bucket:
            q["bucket"] = bucket
        if tmp_age_s is not None:
            q["tmp_age"] = str(tmp_age_s)
        return self._json("POST" if repair else "GET", "fsck", query=q)

    def naughtynet(self, payload: dict) -> dict:
        """Drive the node's network chaos injector (test-only; the node
        must run with MINIO_TPU_NAUGHTYNET=on). ``payload`` is the
        distributed/naughtynet admin op: {"op": "partition"|"heal"|
        "configure"|"arm"|"disarm"|"status"|"reset", ...}."""
        return self._json("POST", "naughtynet",
                          body=json.dumps(payload).encode())

    def heal_start(self, bucket: str = "", prefix: str = "") -> str:
        out = self._json("POST", "heal",
                         {"bucket": bucket, "prefix": prefix})
        return out["token"]

    def heal_status(self, token: str) -> dict:
        return self._json("GET", "heal/status", {"token": token})

    # -- topology / rebalance ----------------------------------------------

    def start_rebalance(self, pool: int) -> dict:
        """Begin decommissioning `pool`: mark it draining and start the
        background rebalance moving its objects to the active pools."""
        return self._json("POST", "rebalance", {"pool": str(pool)})

    def rebalance_status(self) -> dict:
        return self._json("GET", "rebalance")

    def cancel_rebalance(self) -> dict:
        return self._json("DELETE", "rebalance")

    def topology(self) -> dict:
        return self._json("GET", "topology")

    def set_pool_state(self, pool: int, state: str) -> dict:
        """Suspend ("suspended") or resume ("active") a pool for new
        writes without draining it."""
        return self._json("POST", "topology",
                          {"pool": str(pool), "state": state})

    def mrf_status(self) -> dict:
        """MRF heal-queue stats (pending/healed/requeued/failed/dropped;
        zones nested for server-sets backends)."""
        return self._json("GET", "mrf")

    def metacache_stats(self, bucket: str = "") -> dict:
        """Bucket metacache state: per-bucket index entries/state/
        invalid/dirty/generation, pending journal deltas, and the
        serve/fallback/drop/reconcile counters ({"enabled": False}
        when the node runs without the index)."""
        query = {"bucket": bucket} if bucket else None
        return self._json("GET", "metacache", query)

    # -- tiering -----------------------------------------------------------

    def add_tier(self, name: str, type_: str, update: bool = False,
                 **params) -> dict:
        """Register a remote tier (type_: fs|s3|azure|gcs|hdfs; params
        are backend-specific — fs: path; s3: host/port/bucket/prefix/
        access_key/secret_key/region)."""
        query = {"force": "true"} if update else None
        return self._json("PUT", "tier", query,
                          json.dumps({"name": name, "type": type_,
                                      "params": params}).encode())

    def list_tiers(self) -> list[dict]:
        """Registered tiers (secrets redacted)."""
        return self._json("GET", "tier")["tiers"]

    def remove_tier(self, name: str, force: bool = False) -> dict:
        """Remove a tier; `force` overrides the in-use refusal (a tier
        still named by lifecycle Transition rules answers 409)."""
        query = {"name": name}
        if force:
            query["force"] = "true"
        return self._json("DELETE", "tier", query)

    def tier_stats(self) -> dict:
        """Transition-worker queue/throughput counters."""
        return self._json("GET", "tier/stats")

    # -- multi-tenant QoS --------------------------------------------------

    def qos_get(self) -> dict:
        """QoS plane state: enabled flag, registry epoch, tenant/tier
        budgets, and live per-tenant stats."""
        return self._json("GET", "qos")

    def qos_set(self, name: str, scope: str = "tenant",
                share: float = 0.0, rps: float = 0.0,
                rx_bps: float = 0.0, tx_bps: float = 0.0) -> dict:
        """Set (or replace) one tenant/tier budget; 0 means
        default/unlimited for that dimension."""
        return self._json("PUT", "qos", None,
                          json.dumps({"scope": scope, "name": name,
                                      "share": share, "rps": rps,
                                      "rx_bps": rx_bps,
                                      "tx_bps": tx_bps}).encode())

    def qos_remove(self, name: str, scope: str = "tenant") -> dict:
        return self._json("DELETE", "qos",
                          {"scope": scope, "name": name})

    # -- active-active replication (replicate/) ----------------------------

    def replicate_status(self) -> dict:
        """Site id, persisted target registry, plane stats, resync —
        plus per-target health under ``targets_status`` (queue depth,
        oldest-pending age, last-sync timestamp, last observed lag)."""
        return self._json("GET", "replicate")

    def replicate_key_versions(self, bucket: str, key: str) -> dict:
        """Every version of one key as replayable specs (the peer-sync
        read HTTPReplClient drives)."""
        return self._json("GET", "replicate/key",
                          {"bucket": bucket, "key": key})

    def add_replicate_target(self, bucket: str, host: str, port: int,
                             dest_bucket: str, access_key: str,
                             secret_key: str, prefix: str = "",
                             bw_bps: int = 0, arn: str = "",
                             update: bool = False) -> str:
        """Register an active-active wire target; returns its ARN.
        Updating an existing target requires passing its `arn` back
        (the server mints a fresh one otherwise, which would register
        a duplicate instead of replacing)."""
        doc = {"bucket": bucket, "dest_bucket": dest_bucket,
               "prefix": prefix, "bw_bps": bw_bps, "type": "s3",
               "params": {"host": host, "port": port,
                          "access_key": access_key,
                          "secret_key": secret_key}}
        if arn:
            doc["arn"] = arn
        out = self._json("PUT", "replicate/target",
                         {"update": "true"} if update else None,
                         json.dumps(doc).encode())
        return out["arn"]

    def remove_replicate_target(self, arn: str) -> None:
        self._request("DELETE", "replicate/target", {"arn": arn})

    def start_replicate_resync(self, arn: str) -> dict:
        return self._json("POST", "replicate/resync", {"arn": arn})

    def replicate_resync_status(self) -> dict:
        return self._json("GET", "replicate/resync")

    def cancel_replicate_resync(self) -> dict:
        return self._json("DELETE", "replicate/resync")

    # -- bucket event notification plane -----------------------------------

    def notify_status(self) -> dict:
        """Notification target registry, plane stats, and per-target
        delivery health under ``targets_status`` (backlog depth,
        offline window, last delivery lag)."""
        return self._json("GET", "notify")

    def add_notify_target(self, type: str = "webhook", name: str = "",
                          arn: str = "", update: bool = False,
                          **params) -> str:
        """Register an event notification target; returns its ARN.
        ``params`` is the type-specific config — ``endpoint`` (and
        optional ``auth_token``, ``timeout``) for webhooks, ``path``
        for log targets. Updating an existing target requires passing
        its ``arn`` back (the server mints a fresh one otherwise)."""
        doc = {"type": type, "params": params}
        if name:
            doc["name"] = name
        if arn:
            doc["arn"] = arn
        out = self._json("PUT", "notify/target",
                         {"update": "true"} if update else None,
                         json.dumps(doc).encode())
        return out["arn"]

    def remove_notify_target(self, arn: str) -> None:
        self._request("DELETE", "notify/target", {"arn": arn})

    # -- bucket remote targets ----------------------------------------------

    def set_remote_target(self, bucket: str, host: str, port: int,
                          target_bucket: str, access_key: str,
                          secret_key: str, region: str = "us-east-1"
                          ) -> str:
        """Register a replication destination; returns its ARN."""
        return self._json(
            "PUT", "set-remote-target", {"bucket": bucket},
            body=json.dumps({"host": host, "port": port,
                             "targetbucket": target_bucket,
                             "accesskey": access_key,
                             "secretkey": secret_key,
                             "region": region}).encode())["arn"]

    def list_remote_targets(self, bucket: str) -> list[dict]:
        return json.loads(self._request(
            "GET", "list-remote-targets", {"bucket": bucket}))

    def remove_remote_target(self, bucket: str, arn: str) -> None:
        self._json("DELETE", "remove-remote-target",
                   {"bucket": bucket, "arn": arn})

    # -- IAM ---------------------------------------------------------------

    def add_user(self, access_key: str, secret_key: str) -> None:
        self._json("PUT", "add-user", {"accessKey": access_key},
                   json.dumps({"secretKey": secret_key}).encode())

    def remove_user(self, access_key: str) -> None:
        self._json("DELETE", "remove-user", {"accessKey": access_key})

    def list_users(self) -> list[str]:
        return self._json("GET", "list-users")["users"]

    def set_user_status(self, access_key: str, status: str) -> None:
        self._json("PUT", "set-user-status",
                   {"accessKey": access_key, "status": status})

    def add_canned_policy(self, name: str, policy_json: str) -> None:
        self._json("PUT", "add-canned-policy", {"name": name},
                   policy_json.encode())

    def remove_canned_policy(self, name: str) -> None:
        self._json("DELETE", "remove-canned-policy", {"name": name})

    def list_canned_policies(self) -> list[str]:
        return self._json("GET", "list-canned-policies")["policies"]

    def set_policy(self, policy_name: str, user_or_group: str,
                   is_group: bool = False) -> None:
        self._json("PUT", "set-user-or-group-policy",
                   {"policyName": policy_name,
                    "userOrGroup": user_or_group,
                    "isGroup": "true" if is_group else "false"})

    def update_group_members(self, group: str, members: list[str],
                             is_remove: bool = False) -> None:
        """Add members to a group (created on first add) or remove them
        (a group left empty is deleted)."""
        self._json("PUT", "update-group-members", None,
                   json.dumps({"group": group, "members": list(members),
                               "isRemove": is_remove}).encode())

    def add_service_account(self, parent: str, access_key: str = "",
                            secret_key: str = "") -> dict:
        return self._json("PUT", "add-service-account", None,
                          json.dumps({"parent": parent,
                                      "accessKey": access_key,
                                      "secretKey": secret_key}).encode())

    # -- trace / profiling -------------------------------------------------

    def trace(self, count: int = 10, idle: float = 5.0,
              api: str = "", errors_only: bool = False
              ) -> Iterator[dict]:
        """Stream live trace entries (blocks until idle/count).
        `api` is a comma list of API names to keep; `errors_only`
        keeps failed calls (HTTP >= 400)."""
        query = {"count": str(count), "idle": str(idle)}
        if api:
            query["api"] = api
        if errors_only:
            query["err"] = "1"
        data = self._request("GET", "trace", query)
        for line in data.splitlines():
            if line.strip():
                yield json.loads(line)

    def trace_follow(self, count: int = 0, api: str = "",
                     errors_only: bool = False,
                     timeout: Optional[float] = None) -> Iterator[dict]:
        """The `mc admin trace` analog: a LIVE cluster-wide stream —
        the serving node grafts every peer's records in. Yields entry
        dicts as they arrive; ends at `count` entries (0 = until the
        connection drops / `timeout`). Unlike trace(), this reads the
        chunked response incrementally."""
        query = {"follow": "1", "count": str(count)}
        if api:
            query["api"] = api
        if errors_only:
            query["err"] = "1"
        return self._follow("trace", query, count, timeout)

    def _follow(self, sub: str, query: dict, count: int = 0,
                timeout: Optional[float] = None) -> Iterator[dict]:
        """Incremental ND-JSON reader behind the follow streams
        (trace_follow / events_follow): yields entry dicts as they
        arrive, skipping heartbeat blanks."""
        qs = urllib.parse.urlencode(query)
        path = f"{ADMIN_PREFIX}/{sub}"
        hdrs = sig.sign_v4("GET", path,
                           {k: [v] for k, v in query.items()},
                           {"host": f"{self.host}:{self.port}"},
                           hashlib.sha256(b"").hexdigest(), self.creds,
                           self.region)
        conn = http.client.HTTPConnection(
            self.host, self.port,
            timeout=timeout if timeout is not None else self.timeout)
        try:
            conn.request("GET", f"{path}?{qs}", headers=hdrs)
            resp = conn.getresponse()
            if resp.status >= 300:
                raise AdminClientError(
                    resp.status, {"raw": resp.read().decode(
                        errors="replace")})
            sent = 0
            while True:
                # readline, not read(n): a chunked read(n) blocks for n
                # bytes while the stream trickles heartbeats
                line = resp.readline()
                if not line:
                    return
                if not line.strip():
                    continue                       # heartbeat
                yield json.loads(line)
                sent += 1
                if count and sent >= count:
                    return
        finally:
            conn.close()

    def cluster_trace(self) -> list[dict]:
        return self._json("GET", "trace/cluster")["entries"]

    def events(self, count: int = 0, classes: str = "",
               subsystems: str = "", severity: str = "",
               cluster: bool = False) -> list[dict]:
        """Recent journal entries. `classes`/`subsystems` are comma
        lists, `severity` a minimum (info/warn/error/crit);
        `cluster=True` merges every peer's window."""
        query = {"count": str(count)}
        if classes:
            query["class"] = classes
        if subsystems:
            query["sub"] = subsystems
        if severity:
            query["sev"] = severity
        if cluster:
            query["cluster"] = "1"
        return self._json("GET", "events", query)["events"]

    def events_follow(self, count: int = 0, classes: str = "",
                      subsystems: str = "", severity: str = "",
                      timeout: Optional[float] = None
                      ) -> Iterator[dict]:
        """LIVE journal stream with peer grafting — the `mc admin
        events` analog of trace_follow."""
        query = {"follow": "1", "count": str(count)}
        if classes:
            query["class"] = classes
        if subsystems:
            query["sub"] = subsystems
        if severity:
            query["sev"] = severity
        return self._follow("events", query, count, timeout)

    def incidents(self, cluster: bool = False) -> list[dict]:
        """Black-box bundle summaries, newest first."""
        query = {"cluster": "1"} if cluster else None
        return self._json("GET", "incidents", query)["incidents"]

    def incident(self, inc_id: str) -> dict:
        """One full bundle — served by whichever node holds it."""
        return self._json("GET", "incidents", {"id": inc_id})

    def slo(self) -> dict:
        """Burn-rate status per objective (the error-budget view)."""
        return self._json("GET", "slo")

    def spans(self, count: int = 50, sort: str = "recent",
              api: str = "", trace_id: str = "") -> dict:
        """Kept span trees (+ keep/drop counters). `api` filters to
        one API's roots, `trace_id` selects the tree a trace entry
        named, `sort=slowest` orders by duration."""
        query = {"count": str(count), "sort": sort}
        if api:
            query["api"] = api
        if trace_id:
            query["trace_id"] = trace_id
        return self._json("GET", "spans", query)

    def profiling_start(self, profiler_type: str = "cpu") -> dict:
        """profiler_type: comma list of 'cpu' (cProfile) and 'mem'
        (tracemalloc) — the reference's profilerType=cpu,mem."""
        return self._json("POST", "profiling/start",
                          {"profilerType": profiler_type})

    def profiling_stop(self, profiler_type: str = "cpu"
                       ) -> dict[str, str]:
        """Stop cluster-wide profiling; returns
        {profile-<kind>-<node>.txt: text} extracted from the server's
        zip (one entry per kind per node)."""
        import io
        import zipfile
        blob = self._request("POST", "profiling/stop",
                             {"profilerType": profiler_type})
        out: dict[str, str] = {}
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            for name in zf.namelist():
                out[name] = zf.read(name).decode()
        return out

    def console_log(self, count: int = 0) -> list[dict]:
        """Merged cluster console-log ring entries."""
        return self._json("GET", "consolelog",
                          {"count": str(count)})["entries"]

    def obd_info(self) -> list[dict]:
        """Per-node OBD bundles (drive latency probes, cpu/mem)."""
        return self._json("GET", "obdinfo")["nodes"]

    def drive_health(self) -> dict:
        """Gray-failure plane snapshot: per-drive/per-peer tracked
        latency + quarantine states + recent transition events."""
        return self._json("GET", "drivehealth")

    # -- config KV ---------------------------------------------------------

    def get_config(self) -> dict:
        return self._json("GET", "get-config")

    def set_config(self, subsys: str, **kv) -> None:
        self._json("PUT", "set-config", {"subsys": subsys},
                   json.dumps(kv).encode())

    def config_history(self) -> list[str]:
        return self._json("GET", "config-history")["entries"]

    def restore_config(self, entry: str) -> None:
        self._json("PUT", "restore-config", {"entry": entry})

    def service_action(self, action: str) -> dict:
        """Cluster-wide service restart/stop (mc admin service)."""
        return self._json("POST", "service", {"action": action})

    def set_bucket_quota(self, bucket: str, quota: int,
                         quota_type: str = "hard") -> None:
        self._json("PUT", "set-bucket-quota", {"bucket": bucket},
                   body=json.dumps({"quota": quota,
                                    "quotatype": quota_type}).encode())

    def get_bucket_quota(self, bucket: str) -> dict:
        return self._json("GET", "get-bucket-quota", {"bucket": bucket})
