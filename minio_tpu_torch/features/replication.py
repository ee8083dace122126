"""LEGACY one-way bucket replication (reference
cmd/bucket-replication.go replicateObject/mustReplicate +
cmd/bucket-targets.go). Counterpart of minio_tpu/features/replication.py.

The production multi-site story lives in ``minio_tpu_torch/replicate/``:
bidirectional active-active sync riding the engine namespace-change
feed, with loop suppression, deterministic conflict resolution,
version-faithful replay, resync seeding and MRF-style retry — cluster
boot wires THAT plane. This module remains as (a) the replication
CONFIG surface (``ReplicationConfig``/``ReplicationRule`` XML parsing,
which the new plane consults to gate keys per bucket rule) and (b) a
standalone fire-and-forget copier for embedders that want the simple
one-way shape.

A replication config (XML) names a destination bucket ARN; a target
registry maps ARNs to S3 endpoints+credentials. Every PUT/DELETE that
matches an enabled rule enqueues a replication task; a worker pool
re-reads the object from the local layer and PUTs (or DELETEs) it at the
destination with our own SigV4 client.
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.client
import queue
import threading
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Optional

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _findall(el, tag):
    return list(el.findall(tag)) + list(el.findall(_NS + tag))


def _text(el, tag, default=""):
    r = el.find(tag)
    if r is None:
        r = el.find(_NS + tag)
    return (r.text or "").strip() if r is not None else default


@dataclasses.dataclass
class ReplicationRule:
    rule_id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    target_arn: str = ""               # Destination/Bucket
    delete_replication: bool = False   # DeleteMarkerReplication status

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"


class ReplicationConfig:
    def __init__(self, rules: list[ReplicationRule], role: str = ""):
        self.rules = rules
        self.role = role

    @classmethod
    def from_xml(cls, raw: str | bytes) -> "ReplicationConfig":
        root = ET.fromstring(raw)
        role = _text(root, "Role")
        rules = []
        for rel in _findall(root, "Rule"):
            r = ReplicationRule(
                rule_id=_text(rel, "ID"),
                status=_text(rel, "Status", "Enabled"))
            fel = rel.find("Filter")
            if fel is None:
                fel = rel.find(_NS + "Filter")
            if fel is not None:
                r.prefix = _text(fel, "Prefix")
            else:
                r.prefix = _text(rel, "Prefix")
            del_el = rel.find("DeleteMarkerReplication")
            if del_el is None:
                del_el = rel.find(_NS + "DeleteMarkerReplication")
            if del_el is not None:
                r.delete_replication = \
                    _text(del_el, "Status") == "Enabled"
            dest = rel.find("Destination")
            if dest is None:
                dest = rel.find(_NS + "Destination")
            if dest is not None:
                r.target_arn = _text(dest, "Bucket")
            rules.append(r)
        return cls(rules, role)

    def rule_for(self, object_name: str) -> Optional[ReplicationRule]:
        for r in self.rules:
            if r.enabled and object_name.startswith(r.prefix):
                return r
        return None


@dataclasses.dataclass
class ReplicationTarget:
    """One destination endpoint (cmd/bucket-targets.go TargetClient)."""
    arn: str
    host: str
    port: int
    bucket: str
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    secure: bool = False


class _S3MiniClient:
    """Just enough SigV4 client for replication traffic."""

    def __init__(self, t: ReplicationTarget):
        self.t = t

    def _request(self, method: str, key: str, body: bytes = b"",
                 headers: Optional[dict] = None) -> int:
        from ..s3 import signature as sig
        from ..s3.credentials import Credentials
        path = f"/{self.t.bucket}/{key}"
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        hdrs["host"] = f"{self.t.host}:{self.t.port}"
        payload_hash = hashlib.sha256(body).hexdigest()
        hdrs = sig.sign_v4(method, urllib.parse.quote(path), {}, hdrs,
                           payload_hash,
                           Credentials(self.t.access_key,
                                       self.t.secret_key), self.t.region)
        conn = http.client.HTTPConnection(self.t.host, self.t.port,
                                          timeout=30)
        try:
            conn.request(method, urllib.parse.quote(path), body=body,
                         headers=hdrs)
            resp = conn.getresponse()
            resp.read()
            return resp.status
        finally:
            conn.close()

    def put_object(self, key: str, body: bytes, metadata: dict) -> bool:
        hdrs = {"x-amz-replication-status": "REPLICA"}
        for k, v in metadata.items():
            if k.lower().startswith("x-amz-meta-") or k.lower() in (
                    "content-type", "content-encoding", "cache-control"):
                hdrs[k] = v
        return self._request("PUT", key, body, hdrs) == 200

    def delete_object(self, key: str) -> bool:
        return self._request("DELETE", key) in (200, 204)


class ReplicationPool:
    """Async replication workers (cmd/bucket-replication.go pool).

    With a queue_dir, every pending task is persisted BEFORE dispatch
    and deleted only after the destination accepted it — pending
    replication survives a process restart (the reference re-drives
    lost work via MRF/status headers; here the queuestore pattern from
    features/events.py serves both subsystems)."""

    def __init__(self, object_layer, bucket_meta_sys, workers: int = 2,
                 queue_size: int = 10000,
                 queue_dir: Optional[str] = None,
                 redrive_interval: float = 60.0):
        self.obj = object_layer
        self.bucket_meta = bucket_meta_sys
        self.targets: dict[str, ReplicationTarget] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self.replicated = 0            # counters for admin/metrics
        self.failed = 0
        self._mu = threading.Lock()
        self._inflight: set[str] = set()
        self.store = None
        if queue_dir is not None:
            from .events import QueueStore
            self.store = QueueStore(queue_dir)
            threading.Thread(target=self._redrive_loop, args=(
                redrive_interval,), daemon=True).start()
        for _ in range(workers):
            threading.Thread(target=self._worker, daemon=True).start()

    def register_target(self, t: ReplicationTarget) -> None:
        self.targets[t.arn] = t
        if self.store is not None:
            self.redrive()             # replay pre-restart backlog

    def mount_target_entry(self, entry: dict) -> None:
        """Register a persisted bucket-metadata target dict (the admin
        remote-target registry's on-disk shape)."""
        self.register_target(ReplicationTarget(
            arn=entry["arn"], host=entry["host"],
            port=int(entry.get("port", 9000)),
            bucket=entry["bucket"],
            access_key=entry.get("access_key", ""),
            secret_key=entry.get("secret_key", ""),
            region=entry.get("region", "us-east-1"),
            secure=bool(entry.get("secure", False))))

    def mount_persisted_targets(self, buckets: list[str]) -> None:
        """Boot-time re-registration of every bucket's remote targets
        from bucket metadata (reference loads the target registry at
        startup, cmd/bucket-targets.go)."""
        for b in buckets:
            try:
                for entry in self.bucket_meta.get(b).replication_targets:
                    self.mount_target_entry(entry)
            except Exception:  # noqa: BLE001 — per-bucket best effort
                continue

    def close(self) -> None:
        self._stop.set()

    def redrive(self) -> int:
        """Queue persisted-but-unqueued tasks (startup replay + the
        periodic loop). Tasks whose target isn't registered yet stay
        persisted."""
        if self.store is None:
            return 0
        n = 0
        for skey in self.store.keys():
            with self._mu:
                if skey in self._inflight:
                    continue
            task = self.store.get(skey)
            if task is None:
                self.store.delete(skey)
                continue
            if task.get("arn") not in self.targets:
                continue
            if self._queue_task(task, skey):
                n += 1
        return n

    def _redrive_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.redrive()

    def _queue_task(self, task: dict, skey: Optional[str]) -> bool:
        if skey is not None:
            with self._mu:
                if skey in self._inflight:
                    return False
                self._inflight.add(skey)
        try:
            self._q.put_nowait((task, skey))
            return True
        except queue.Full:
            if skey is not None:
                with self._mu:
                    self._inflight.discard(skey)
            else:
                self.failed += 1
            return False

    # -- enqueue hooks (called from the S3 handlers) -----------------------

    def _config(self, bucket: str) -> Optional[ReplicationConfig]:
        xml = self.bucket_meta.get(bucket).replication_xml
        if not xml:
            return None
        try:
            return ReplicationConfig.from_xml(xml)
        except ET.ParseError:
            return None

    def must_replicate(self, bucket: str, key: str) -> bool:
        cfg = self._config(bucket)
        return cfg is not None and cfg.rule_for(key) is not None

    def on_put(self, bucket: str, key: str) -> None:
        self._enqueue("put", bucket, key)

    def on_delete(self, bucket: str, key: str) -> None:
        self._enqueue("delete", bucket, key)

    def _enqueue(self, op: str, bucket: str, key: str) -> None:
        cfg = self._config(bucket)
        if cfg is None:
            return
        rule = cfg.rule_for(key)
        if rule is None:
            return
        if op == "delete" and not rule.delete_replication:
            return
        target = self.targets.get(rule.target_arn)
        if target is None:
            return
        task = {"op": op, "bucket": bucket, "key": key,
                "arn": rule.target_arn}
        skey = self.store.put(task) if self.store is not None else None
        self._queue_task(task, skey)

    # -- workers -----------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                task, skey = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                target = self.targets.get(task["arn"])
                if target is None:
                    raise OSError(f"no target {task['arn']}")
                self._replicate(task["op"], task["bucket"], task["key"],
                                target)
                self.replicated += 1
                if skey is not None and self.store is not None:
                    self.store.delete(skey)
            except Exception:  # noqa: BLE001 — counted; durable entries
                # stay persisted for the redrive loop / next restart
                self.failed += 1
            finally:
                if skey is not None:
                    with self._mu:
                        self._inflight.discard(skey)
                self._q.task_done()

    def _replicate(self, op: str, bucket: str, key: str,
                   target: ReplicationTarget) -> None:
        client = _S3MiniClient(target)
        if op == "delete":
            client.delete_object(key)
            return
        from ..object import api_errors
        try:
            info, stream = self.obj.get_object(bucket, key)
        except api_errors.ObjectApiError:
            return                      # deleted since enqueue
        body = b"".join(stream)
        md = dict(info.user_defined or {})
        if info.content_type:
            md["content-type"] = info.content_type
        if info.content_encoding:
            md["content-encoding"] = info.content_encoding
        client.put_object(key, body, md)

    def drain(self, timeout: float = 10.0) -> None:
        done = threading.Event()

        def waiter():
            self._q.join()
            done.set()

        threading.Thread(target=waiter, daemon=True).start()
        done.wait(timeout)
