"""Resync: seed (or re-seed) a replication target from scratch.
Counterpart of minio_tpu/replicate/resync.py; its checkpoints are the
reference's documents, so either package resumes the other's resync.

The rebalance walker's shape applied to a remote site (reference
``mc admin replicate resync``): walk every bucket the target covers —
names from the metacache namespace feed when attached (the one
amortized walk), marker-paged version listings otherwise — and push
every version the target lacks, oldest first, with full fidelity
(multipart boundaries, markers, stubs as metadata). Unlike the
steady-state sync, a resync pushes EVERY missing version regardless of
origin (a disaster-recovery seed must restore the target's own lost
writes too) and never prunes.

Progress checkpoints (bucket + key marker + counters) persist under
``.minio.sys/replicate/resync-<arn>.json`` on every pool after every
``MINIO_TPU_REPL_RESYNC_CHECKPOINT_EVERY`` keys — a kill mid-resync
resumes from the marker instead of re-listing the site, and the
re-pass is idempotent (the target-lacks check skips what already
landed). Failed keys feed the plane's MRF retry queue.
"""

from __future__ import annotations

import json
import threading
import time
from typing import TYPE_CHECKING, Optional

from ..object import api_errors
from ..utils import atomicfile, crashpoint, eventlog
from ..storage.xl_storage import MINIO_META_BUCKET
from ..utils import knobs, telemetry
from .targets import REPL_PREFIX, TargetRegistry

if TYPE_CHECKING:  # pragma: no cover — typing only
    from .plane import ReplicationPlane

CHECKPOINT_EVERY = knobs.get_int("MINIO_TPU_REPL_RESYNC_CHECKPOINT_EVERY")
PAGE = knobs.get_int("MINIO_TPU_REPL_RESYNC_PAGE")


def _checkpoint_object(arn: str) -> str:
    # ARNs contain ':' — keep the object key filesystem-tame
    return f"{REPL_PREFIX}resync-{arn.replace(':', '_').replace('/', '_')}.json"


class Resyncer:
    """One target seed: a daemon thread walking the local namespace and
    pushing every missing version to the target."""

    def __init__(self, object_layer, registry: TargetRegistry, arn: str,
                 plane: Optional["ReplicationPlane"] = None,
                 resume: bool = True,
                 checkpoint_every: Optional[int] = None,
                 page: Optional[int] = None):
        self.obj = object_layer
        self.registry = registry
        self.arn = arn
        self.plane = plane
        self.checkpoint_every = checkpoint_every or CHECKPOINT_EVERY
        self.page = page or PAGE
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._mu = threading.Lock()
        self.state = {
            "arn": arn, "status": "pending",
            "bucket": "", "marker": "",
            "keys_scanned": 0, "versions_pushed": 0, "keys_failed": 0,
            "started": time.time(), "updated": time.time(),
        }
        if resume:
            doc = self.load_checkpoint(object_layer, arn)
            if doc is not None and doc.get("status") != "complete":
                for k in ("bucket", "marker", "keys_scanned",
                          "versions_pushed", "keys_failed"):
                    if k in doc:
                        self.state[k] = doc[k]
                self.state["resumed"] = True

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Resyncer":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repl-resync")
        self._thread.start()
        return self

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout: float = 10.0) -> bool:
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout)
        return not self.running()

    def status(self) -> dict:
        with self._mu:
            out = dict(self.state)
        out["running"] = self.running()
        return out

    # -- the walk -------------------------------------------------------

    def _run(self) -> None:
        self._set(status="seeding")
        try:
            self.run_pass()
            if self._stop.is_set():
                self._set(status="stopped")
            else:
                self._set(status="complete", bucket="", marker="")
            self._save_checkpoint()
        except Exception as e:  # noqa: BLE001 — surfaced via status
            self._set(status="failed", error=repr(e))
            self._save_checkpoint()

    def run_pass(self) -> tuple[int, int]:
        """One sweep from the current checkpoint. Returns
        (keys pushed-through, keys failed)."""
        target = self.registry.get(self.arn)
        client = self.registry.client(self.arn)
        client.ensure_bucket()
        done = failed = since_ckpt = 0
        buckets = sorted(v.name for v in self.obj.list_buckets()
                         if v.name == target.bucket or not target.bucket)
        start_bucket = self.state["bucket"]
        for bucket in buckets:
            if self._stop.is_set():
                break
            if start_bucket and bucket < start_bucket:
                continue
            marker = self.state["marker"] \
                if bucket == start_bucket else ""
            for name in self._bucket_names(bucket, marker):
                if self._stop.is_set():
                    break
                if not target.matches(name):
                    continue
                with telemetry.trace("replicate.resync", bucket=bucket,
                                     object=name, target=self.arn):
                    try:
                        pushed = self.plane.sync_key(bucket, name, target,
                                                     resync=True) \
                            if self.plane is not None else 0
                    except Exception:  # noqa: BLE001 — per-key isolation
                        failed += 1
                        with self._mu:
                            self.state["keys_failed"] += 1
                        if self.plane is not None:
                            self.plane.mrf.enqueue(bucket, name, self.arn)
                    else:
                        done += 1
                        with self._mu:
                            self.state["keys_scanned"] += 1
                            self.state["versions_pushed"] += pushed
                self._set(bucket=bucket, marker=name)
                since_ckpt += 1
                if since_ckpt >= self.checkpoint_every:
                    self._save_checkpoint()
                    since_ckpt = 0
        if since_ckpt:
            self._save_checkpoint()
        return done, failed

    def _bucket_names(self, bucket: str, marker: str):
        """Sorted key names after `marker`: the metacache namespace
        feed when attached (versions=True so marker-latest keys are
        covered), else marker-paged version listings."""
        mc = getattr(self.obj, "metacache", None)
        feed = mc.namespace_feed(bucket, versions=True,
                                 consumer="resync") \
            if mc is not None else None
        if feed is not None:
            for name, _vers in feed:
                if marker and name <= marker:
                    continue
                yield name
            return
        from ..object.metacache import walks_counter
        walks_counter().inc(consumer="resync", source="merge")
        vid_marker = ""
        last = None
        while not self._stop.is_set():
            try:
                page, _pfx, nkm, nvm, trunc = \
                    self.obj.list_object_versions(bucket, "", marker,
                                                  self.page, vid_marker)
            except api_errors.ObjectApiError:
                return
            for oi in page:
                if oi.name != last:
                    last = oi.name
                    yield oi.name
            if not trunc:
                return
            marker, vid_marker = nkm, nvm

    # -- checkpoint persistence -----------------------------------------

    def _set(self, **kw) -> None:
        with self._mu:
            self.state.update(kw)
            self.state["updated"] = time.time()

    def _save_checkpoint(self) -> None:
        with self._mu:
            doc = dict(self.state)
        eventlog.emit("resync.checkpoint", target=self.arn,
                      objects=doc.get("versions_pushed", 0))
        payload = json.dumps(doc).encode()
        layers = getattr(self.obj, "server_sets", None) or [self.obj]
        for z in layers:
            try:
                # one hit per pool (arm :<nth>): resume re-covers the
                # un-checkpointed tail idempotently
                crashpoint.hit("resync.checkpoint")
                z.put_object(MINIO_META_BUCKET,
                             _checkpoint_object(self.arn), payload)
            except Exception:  # noqa: BLE001 — best-effort per pool
                pass

    @staticmethod
    def load_checkpoint(object_layer, arn: str) -> Optional[dict]:
        best: Optional[dict] = None
        layers = getattr(object_layer, "server_sets", None) \
            or [object_layer]
        for z in layers:
            try:
                _, stream = z.get_object(MINIO_META_BUCKET,
                                         _checkpoint_object(arn))
                # torn checkpoint (crash mid-write) = absent, never a
                # boot-path crash
                doc = atomicfile.load_json_doc(b"".join(stream))
            except api_errors.ObjectApiError:
                continue
            if doc is None:
                continue
            if best is None or doc.get("updated", 0) > \
                    best.get("updated", 0):
                best = doc
        return best
