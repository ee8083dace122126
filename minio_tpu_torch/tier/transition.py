"""ILM transitions and RestoreObject: moving cold data to remote tiers.

Counterpart of minio_tpu/tier/transition.py. The reference enforces
lifecycle ``Transition`` rules from the data crawler (cmd/data-crawler.go
applyActions -> transitionObject; cmd/erasure-object.go TransitionObject
and RestoreTransitionedObject): the object's data streams to the
configured tier, the local ``xl.meta`` becomes a zero-data stub carrying
the tier name and remote key, GETs answer ``InvalidObjectState`` until
``RestoreObject`` pulls an expiring local copy back, and the
restore-expiry sweep reclaims that copy.

  * crawler actions (``transition_action`` for current versions,
    ``noncurrent_transition_action`` per bucket,
    ``restore_reclaim_action`` for expired restored copies) feed a
    bounded :class:`TransitionWorker` queue;
  * the worker reads the object through the layer (a degraded read
    decodes on the card), moves its stored bytes (ciphertext for an SSE
    object) through the tier client, verifies the remote copy's size
    BEFORE the engine rewrites xl.meta and frees the local shards, and
    yields to the batch former's occupancy and the staging rings' waits
    (utils/pressure.py);
  * a restore writes the object back through the layer's PUT (the encode
    dispatch on the card; a multipart object through a multipart replay
    that keeps its parts and ``-N`` ETag). A dispatch that fails raises
    and leaves the stub as it was: no path moves the encode to the host;
  * a failed transition goes to the source's MRF heal queue (heal first,
    retry on the next crawler pass) and counts in
    ``minio_tpu_tier_failed_total{tier}``.

A transition, a reclaim and a restore are each the root of a trace of
their own (``tier.transition``, ``tier.reclaim``, ``tier.restore``).

Per-tier QoS budgets: the boot sets ``budget_lookup`` to the QoS
registry's ``tier`` scope (s3/qos.py), so a tier with a budget paces its
pushes by request rate and bytes.
"""

from __future__ import annotations

import threading
import time
import xml.etree.ElementTree as ET
from collections import deque
from email.utils import formatdate
from typing import Optional

from ..object import api_errors
from ..object.engine import GetOptions, PutOptions
from ..storage.datatypes import (RESTORE_EXPIRY_KEY, RESTORE_KEY,
                                 RESTORE_ONGOING, TRANSITION_TIER_KEY,
                                 TRANSITIONED_OBJECT_KEY,
                                 TRANSITIONED_VERSION_KEY, is_restored,
                                 is_transitioned)
from ..utils import knobs, telemetry
from ..utils.bandwidth import PacedReader, TokenBucket
from ..utils.pressure import ForegroundPressure
from ..utils.streams import IterStream
from .client import TierClientError, TierObjectNotFound
from .config import TierManager

QUEUE_SIZE = knobs.get_int("MINIO_TPU_TIER_QUEUE_SIZE")
BACKOFF_S = knobs.get_float("MINIO_TPU_TIER_BACKOFF_S")
BACKOFF_MAX_S = knobs.get_float("MINIO_TPU_TIER_BACKOFF_MAX_S")
BACKOFF_TRIES = knobs.get_int("MINIO_TPU_TIER_BACKOFF_TRIES")


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_tier_objects_total",
                    "Object versions transitioned to remote tiers"),
        reg.counter("minio_tpu_tier_bytes_total",
                    "Bytes moved to remote tiers"),
        reg.counter("minio_tpu_tier_failed_total",
                    "Transitions that failed (fed to MRF, retried on "
                    "the next crawler pass)"),
        reg.counter("minio_tpu_tier_restored_total",
                    "RestoreObject pulls completed"),
    )


def _throttle_metrics():
    return telemetry.REGISTRY.counter(
        "minio_tpu_tier_throttled_total",
        "Tier pushes stalled by a per-tier QoS budget (request-rate "
        "waits and byte-pacing stalls)")


def _mrf_enqueue(object_layer, bucket: str, name: str) -> bool:
    """Feed a failed transition into the MRF heal queue of the layer
    holding the object."""
    layers = getattr(object_layer, "server_sets", None) or [object_layer]
    for z in layers:
        mrf = getattr(z, "mrf", None)
        if mrf is None:
            continue
        try:
            if len(layers) > 1 and not z.has_object_versions(bucket, name):
                continue
        except api_errors.ObjectApiError:
            continue
        mrf.enqueue(bucket, name)
        return True
    return False


def free_remote(tiers: Optional[TierManager], metadata: dict) -> bool:
    """Best-effort delete of a transitioned version's remote copy, when
    the stub (or its restored copy) is deleted or expired. Never raises:
    a tier outage must not fail the local delete."""
    if tiers is None or not is_transitioned(metadata):
        return False
    tier = metadata.get(TRANSITION_TIER_KEY, "")
    key = metadata.get(TRANSITIONED_OBJECT_KEY, "")
    if not tier or not key:
        return False
    try:
        tiers.client(tier).delete(key)
        return True
    except Exception:  # noqa: BLE001 — best-effort remote cleanup
        return False


class _StrictSizeReader(IterStream):
    """Iterator reader that refuses to end short: a truncated tier stream
    aborts the local put (the engine cleans its staging up) instead of
    committing a short restored copy over the stub."""

    def __init__(self, it, expected: int):
        super().__init__(it)
        self.expected = expected
        self._got = 0

    def read(self, n: int = -1) -> bytes:
        out = super().read(n)
        self._got += len(out)
        if not out and 0 <= self._got < self.expected:
            raise TierClientError(
                f"short tier read: {self._got} of {self.expected} bytes")
        return out


class TransitionWorker:
    """Bounded background queue moving object versions to remote tiers,
    and running the large restores the S3 handler answers 202 for.

    Entries dedup on (verb, bucket, object, version) while queued;
    overflow drops the hint (the next crawler pass finds the object
    again). One daemon drains them, throttled by the foreground-pressure
    probe."""

    def __init__(self, object_layer, tiers: TierManager,
                 maxsize: Optional[int] = None,
                 busy_fn=None, throttle_s: Optional[float] = None):
        self.obj = object_layer
        self.tiers = tiers
        self.maxsize = QUEUE_SIZE if maxsize is None else maxsize
        self._pressure = ForegroundPressure(object_layer, busy_fn=busy_fn)
        self._throttle_base = BACKOFF_S if throttle_s is None \
            else throttle_s
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._pending: set[tuple[str, str, str, str]] = set()
        self._inflight = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-tier QoS budgets: name -> Budget or None (the boot sets it
        # from the QoS registry); pushes pace through per-tier buckets
        self.budget_lookup = None
        self._tier_buckets: dict = {}   # tier -> (rps, bps, rps_b, byte_b)
        self.queued = 0
        self.moved = 0
        self.failed = 0
        self.skipped = 0               # object changed or vanished
        self.dropped = 0
        self.restored = 0              # async RestoreObject pulls done
        self.restore_failed = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TransitionWorker":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tier-transition")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    # -- producer ----------------------------------------------------------

    def enqueue(self, bucket: str, name: str, version_id: str,
                tier: str, etag: str = "") -> bool:
        return self._enqueue(("move", bucket, name, version_id, tier,
                              etag))

    def enqueue_restore(self, bucket: str, name: str, version_id: str,
                        days: int = 1) -> bool:
        """Queue an async RestoreObject pull (the 202 path): the handler
        marked the version ongoing and answered; the worker pulls."""
        return self._enqueue(("restore", bucket, name, version_id,
                              days, ""))

    def _enqueue(self, entry: tuple) -> bool:
        key = (entry[0], entry[1], entry[2], entry[3])
        with self._cond:
            if self._stop.is_set() or key in self._pending:
                return False
            if len(self._queue) >= self.maxsize:
                self.dropped += 1
                return False
            self._pending.add(key)
            self._queue.append(entry)
            self.queued += 1
            self._cond.notify_all()
            return True

    # -- observability -----------------------------------------------------

    def pending(self) -> int:
        with self._cond:
            return len(self._queue) + self._inflight

    def stats(self) -> dict:
        with self._cond:
            return {"pending": len(self._queue) + self._inflight,
                    "queued": self.queued, "moved": self.moved,
                    "failed": self.failed, "skipped": self.skipped,
                    "dropped": self.dropped, "restored": self.restored,
                    "restore_failed": self.restore_failed}

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every queued entry finished (moved, failed or
        skipped). False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return not (self._queue or self._inflight)
                self._cond.wait(remaining)
        return True

    # -- consumer ----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop.is_set() and not self._queue:
                    self._cond.wait()
                if self._stop.is_set():
                    return
                entry = self._queue.popleft()
                self._pending.discard((entry[0], entry[1], entry[2],
                                       entry[3]))
                self._inflight += 1
            try:
                self._pressure.throttle(self._stop, self._throttle_base,
                                        BACKOFF_MAX_S, BACKOFF_TRIES)
                if self._stop.is_set():
                    return
                if entry[0] == "restore":
                    self._restore_one(entry[1], entry[2], entry[3],
                                      entry[4])
                else:
                    self._move_one(entry[1], entry[2], entry[3],
                                   entry[4], entry[5])
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _move_one(self, bucket: str, name: str, vid: str, tier: str,
                  etag: str) -> None:
        objects_c, bytes_c, failed_c, _ = _metrics()
        with telemetry.trace("tier.transition", bucket=bucket,
                             object=name, tier=tier):
            try:
                moved = self._move(bucket, name, vid, tier, etag)
            except (api_errors.ObjectNotFound, api_errors.VersionNotFound,
                    api_errors.MethodNotAllowed,
                    api_errors.InvalidObjectState,
                    api_errors.PreConditionFailed):
                # deleted, markered, already tiered or overwritten since
                # the scan: converged, nothing to do
                with self._cond:
                    self.skipped += 1
            except Exception:  # noqa: BLE001 — per-object isolation
                with self._cond:
                    self.failed += 1
                failed_c.inc(tier=tier)
                # heal first: a degraded source heals through MRF, and the
                # next crawler pass retries the transition
                _mrf_enqueue(self.obj, bucket, name)
            else:
                with self._cond:
                    if moved < 0:
                        self.skipped += 1
                    else:
                        self.moved += 1
                if moved >= 0:
                    objects_c.inc(tier=tier)
                    bytes_c.inc(moved, tier=tier)

    def _tier_byte_bucket(self, tier: str) -> Optional[TokenBucket]:
        """Enforce the tier's request-rate budget (blocking: the worker
        waits rather than sheds) and return its byte-pacing bucket, or
        None when the tier has no budget."""
        if self.budget_lookup is None:
            return None
        b = self.budget_lookup(tier)
        rps = float(b.rps) if b is not None else 0.0
        bps = float(b.tx_bps) if b is not None else 0.0
        if rps <= 0 and bps <= 0:
            return None
        with self._cond:
            cached = self._tier_buckets.get(tier)
            if cached is None or cached[0] != rps or cached[1] != bps:
                cached = (rps, bps, TokenBucket(rps), TokenBucket(bps))
                self._tier_buckets[tier] = cached
        if cached[2].take(1) > 0:
            _throttle_metrics().inc(tier=tier)
        return cached[3]

    def _move(self, bucket: str, name: str, vid: str, tier: str,
              etag: str) -> int:
        """Move ONE version's data to `tier`. Returns the bytes moved, or
        -1 when the object changed under us. The local shards are freed
        only after the remote write verified."""
        # the budget gate before the source stream opens: a paced worker
        # must not sit on open drive streams while it waits
        byte_bucket = self._tier_byte_bucket(tier)
        info, stream = self.obj.get_object(
            bucket, name, opts=GetOptions(version_id=vid))
        reader = IterStream(stream)
        if byte_bucket is not None and byte_bucket.rate > 0:
            reader = PacedReader(
                reader, byte_bucket,
                on_wait=lambda s: _throttle_metrics().inc(tier=tier))
        try:
            md = info.user_defined or {}
            if is_transitioned(md):
                return -1               # already tiered (or restored)
            if not vid and etag and info.etag != etag:
                return -1               # overwritten since the scan
            client = self.tiers.client(tier)
            remote_key = self.tiers.remote_key(bucket, name,
                                               info.version_id)
            remote_version = client.put(remote_key, reader, info.size)
        finally:
            reader.close()
        # verify the remote copy BEFORE the stub rewrite frees the local
        # shards: a tier that lied about the write must not eat data
        got = client.head(remote_key)
        if got != info.size:
            try:
                client.delete(remote_key)
            except TierClientError:
                pass
            raise TierClientError(
                f"remote verify failed: {got} != {info.size} bytes")
        try:
            # etag and mod time pin the version INSIDE the commit's write
            # lock: an overwrite during the upload aborts the stub
            self.obj.transition_object(
                bucket, name, version_id=info.version_id, tier=tier,
                remote_object=remote_key, remote_version=remote_version,
                expect_etag=info.etag, expect_mod_time=info.mod_time)
        except api_errors.ObjectApiError:
            # the object is still fully local: free the orphaned remote
            # copy, then surface
            try:
                client.delete(remote_key)
            except TierClientError:
                pass
            raise
        return info.size

    def _restore_one(self, bucket: str, name: str, vid: str,
                     days: int) -> None:
        """One async RestoreObject pull. A failed pull CLEARS the ongoing
        marker, or every later restore would answer
        RestoreAlreadyInProgress."""
        try:
            restore_object(self.obj, self.tiers, bucket, name,
                           version_id=vid, days=days)
        except (api_errors.ObjectNotFound, api_errors.VersionNotFound,
                api_errors.MethodNotAllowed):
            with self._cond:
                self.skipped += 1       # deleted or markered since
        except Exception:  # noqa: BLE001 — per-object isolation
            with self._cond:
                self.restore_failed += 1
            clear_restore_ongoing(self.obj, bucket, name, vid)
            _mrf_enqueue(self.obj, bucket, name)
        else:
            with self._cond:
                self.restored += 1


# ---------------------------------------------------------------------------
# crawler actions
# ---------------------------------------------------------------------------

def transition_action(bucket_meta_sys, worker: TransitionWorker,
                      now_fn=time.time):
    """Per-object crawler action: enqueue current versions whose
    Transition rule is due (expiry wins when both apply)."""
    from ..features.lifecycle import Lifecycle

    def act(bucket: str, oi) -> None:
        bm = bucket_meta_sys.get(bucket)
        if not bm.lifecycle_xml:
            return
        try:
            lc = Lifecycle.cached(bm.lifecycle_xml)
        except ET.ParseError:
            return
        if is_transitioned(oi.user_defined or {}):
            return                      # already tiered or restored
        tier = lc.transition_due(oi.name, oi.mod_time, now_fn())
        if tier:
            worker.enqueue(bucket, oi.name, oi.version_id, tier,
                           etag=oi.etag)

    return act


def noncurrent_transition_action(bucket_meta_sys,
                                 worker: TransitionWorker,
                                 now_fn=time.time):
    """Per-bucket crawler action enforcing NoncurrentVersionTransition
    over the version-group walk (a version's clock starts when it became
    noncurrent: its successor's mod time)."""
    from ..features.lifecycle import Lifecycle, iter_version_groups

    def act(bucket: str) -> None:
        bm = bucket_meta_sys.get(bucket)
        if not bm.lifecycle_xml:
            return
        try:
            lc = Lifecycle.cached(bm.lifecycle_xml)
        except ET.ParseError:
            return
        if not any(r.enabled and r.noncurrent_transition_days
                   and r.noncurrent_transition_tier for r in lc.rules):
            return
        now = now_fn()
        for name, vs in iter_version_groups(worker.obj, bucket,
                                            consumer="transition"):
            days, tier = lc.noncurrent_transition(name)
            if not days or not tier:
                continue
            vs = sorted(vs, key=lambda v: -v.mod_time)
            for i in range(1, len(vs)):         # index 0 = current
                v = vs[i]
                if v.delete_marker or \
                        is_transitioned(v.user_defined or {}):
                    continue
                if vs[i - 1].mod_time < now - days * 86400:
                    worker.enqueue(bucket, name, v.version_id, tier,
                                   etag=v.etag)

    return act


def restore_reclaim_action(object_layer, tiers: TierManager,
                           now_fn=time.time):
    """Per-object crawler action reclaiming EXPIRED restored copies: the
    local data is freed and the version returns to its zero-data stub
    (the restore never touched the remote copy, so nothing uploads)."""

    def act(bucket: str, oi) -> None:
        md = oi.user_defined or {}
        if not is_transitioned(md) or not is_restored(md):
            return
        try:
            expiry = float(md.get(RESTORE_EXPIRY_KEY, 0) or 0)
        except ValueError:
            expiry = 0.0
        if not expiry or expiry > now_fn():
            return
        with telemetry.trace("tier.reclaim", bucket=bucket,
                             object=oi.name):
            try:
                object_layer.transition_object(
                    bucket, oi.name, version_id=oi.version_id,
                    tier=md.get(TRANSITION_TIER_KEY, ""),
                    remote_object=md.get(TRANSITIONED_OBJECT_KEY, ""),
                    remote_version=md.get(TRANSITIONED_VERSION_KEY, ""),
                    # identity pin: a restored copy overwritten since the
                    # scan must not be re-stubbed over the stale pointer
                    expect_etag=oi.etag)
            except api_errors.ObjectApiError:
                pass                        # the next pass retries

    return act


# ---------------------------------------------------------------------------
# RestoreObject (POST ?restore)
# ---------------------------------------------------------------------------

def _http_date(t: float) -> str:
    return formatdate(t, usegmt=True)


def restore_object(object_layer, tiers: TierManager, bucket: str,
                   name: str, version_id: str = "", days: int = 1,
                   now_fn=time.time) -> dict:
    """Pull a transitioned version back as an expiring local copy.

    Returns {"status": "restored"|"updated", "expiry": ts}. The restored
    copy keeps its version id, mod time and etag (and a multipart
    object its parts), plus the ``x-amz-restore`` state and the absolute
    expiry the reclaim sweep reads. Raises InvalidObjectState when the
    version was never transitioned."""
    if days < 1:
        raise api_errors.InvalidObjectState("restore Days must be >= 1")
    info = object_layer.get_object_info(
        bucket, name, GetOptions(version_id=version_id))
    md = dict(info.user_defined or {})
    if not is_transitioned(md):
        raise api_errors.InvalidObjectState(
            f"{bucket}/{name} is not in a remote tier")
    expiry = now_fn() + days * 86400
    restore_val = (f'ongoing-request="false", '
                   f'expiry-date="{_http_date(expiry)}"')
    if is_restored(md):
        # already local: only the expiry window moves (S3: 200 OK)
        md[RESTORE_KEY] = restore_val
        md[RESTORE_EXPIRY_KEY] = str(expiry)
        md["etag"] = info.etag
        if info.content_type:
            md["content-type"] = info.content_type
        object_layer.update_object_metadata(bucket, name, md,
                                            version_id=version_id)
        return {"status": "updated", "expiry": expiry}

    tier = md.get(TRANSITION_TIER_KEY, "")
    with telemetry.trace("tier.restore", bucket=bucket, object=name,
                         tier=tier):
        try:
            stream = tiers.client(tier).get(
                md.get(TRANSITIONED_OBJECT_KEY, ""))
        except TierObjectNotFound:
            raise api_errors.InvalidObjectState(
                f"remote copy of {bucket}/{name} is gone") from None
        metadata = dict(md)
        metadata["etag"] = info.etag
        if info.content_type:
            metadata["content-type"] = info.content_type
        if info.content_encoding:
            metadata["content-encoding"] = info.content_encoding
        metadata[RESTORE_KEY] = restore_val
        metadata[RESTORE_EXPIRY_KEY] = str(expiry)
        reader = _StrictSizeReader(stream, info.size)
        try:
            if len(info.parts or []) > 1:
                # a multipart stub replays its recorded part boundaries, so
                # ranged reads and the -N etag survive the round trip
                from ..object.faithful import replay_version, spec_of
                spec = spec_of(info)
                spec.metadata = {k: v for k, v in metadata.items()
                                 if k != "etag"}
                # no conflict gate: the restore rewrites the same identity
                # over its own stub (equal mod time and etag)
                replay_version(object_layer, bucket, name, spec,
                               reader=reader, conflict_gate=False)
            else:
                object_layer.put_object(
                    bucket, name, reader, info.size,
                    PutOptions(metadata=metadata,
                               version_id=info.version_id,
                               versioned=bool(info.version_id),
                               mod_time=info.mod_time))
        finally:
            reader.close()
        _metrics()[3].inc(tier=tier)
        return {"status": "restored", "expiry": expiry}


def mark_restore_ongoing(object_layer, bucket: str, name: str,
                         version_id: str = "") -> None:
    """Record S3's ``ongoing-request="true"`` on a transitioned version
    (the async 202 path): GETs and HEADs report it, a second restore
    answers RestoreAlreadyInProgress, and the worker's completed pull
    overwrites it with the final state."""
    info = object_layer.get_object_info(
        bucket, name, GetOptions(version_id=version_id))
    md = dict(info.user_defined or {})
    md[RESTORE_KEY] = RESTORE_ONGOING
    md["etag"] = info.etag
    if info.content_type:
        md["content-type"] = info.content_type
    object_layer.update_object_metadata(bucket, name, md,
                                        version_id=version_id)


def clear_restore_ongoing(object_layer, bucket: str, name: str,
                          version_id: str = "") -> None:
    """Best-effort removal of the ongoing marker after a FAILED async
    pull, so the client can retry."""
    try:
        info = object_layer.get_object_info(
            bucket, name, GetOptions(version_id=version_id))
        md = dict(info.user_defined or {})
        if RESTORE_ONGOING not in md.get(RESTORE_KEY, ""):
            return
        md.pop(RESTORE_KEY, None)
        md.pop(RESTORE_EXPIRY_KEY, None)
        md["etag"] = info.etag
        if info.content_type:
            md["content-type"] = info.content_type
        object_layer.update_object_metadata(bucket, name, md,
                                            version_id=version_id)
    except api_errors.ObjectApiError:
        pass
