"""Cross-request batch scheduler: one device dispatch for many requests.

Counterpart of minio_tpu/parallel/scheduler.py:126-675. The engine
batches blocks within one request; this former batches across CONCURRENT
requests (BASELINE config #2: 32 concurrent 16 MiB PutObject streams) —
the reference's per-set shared buffer pool and RAM-gated admission
generalized into a device-batch former (cmd/erasure-sets.go:374,
cmd/handler-api.go:46-57). Verbs:

  * ``encode``  — fused RS-encode + per-shard bitrot digest (PUT);
  * ``decode``  — fused verify + reconstruct-missing-data (degraded GET);
  * ``recover`` — fused verify + rebuild-rows + re-digest (heal);
  * ``decipher`` — the ChaCha20 keystream XOR of an encrypted GET's
    verified packages (object/codec.decipher_packages). The reference
    ciphers GETs on its handler threads; here they come to the former,
    so that no handler thread touches the card and the packages of
    concurrent GETs share one launch;
  * ``scan`` — S3 Select's predicate over one request's tokenized pages
    (scan/kernels.run_packed, the scan_eval kernel). Pages of one plan
    signature and page shape (rows, slots, string width) stack along the
    batch axis, one page counting as one block, so concurrent Selects of
    one query share a launch; each gets its own rows of the mask and of
    the per-page COUNT sums back.

Concurrent callers hand (B_i, k, S) block groups to the submit_* methods;
a collector thread coalesces groups with identical (verb, device,
geometry, algorithm, survivor pattern) into one fused (sum B_i, k, S)
call through object/codec.py and scatters the results back. The key holds
no codec identity: the groups of every erasure set and pool that share
one former (config 5's cross-set batching) merge into one dispatch, run on
the first group's codec. A bucket that
already holds >= max_batch blocks dispatches at once instead of sleeping
the grace window. Up to MINIO_TPU_SCHED_INFLIGHT dispatches run at once,
each on its own thread; on the card each holds one of the codec's
in-flight slots, whose CUDA stream is current on that thread while it
copies and launches, so the copy of batch N+1 overlaps the kernels of
batch N. With a CPU codec the dispatch runs the kernels' plain versions.

A failure inside a dispatch reaches every waiter of that dispatch as the
same exception; nothing falls back to the host. A batch the codec routes
to the host by its size gate resolves to None and the caller takes its
local path (counted in ``host_routed``), as does every waiter when the
scheduler closes.

Encrypted PUTs and degraded GETs (``sse=(keys, nonces, pkg_bytes)``)
carry their per-row ChaCha20 key and nonce words as the group's payload;
the bucket key holds only their geometry (package count and size), so
encrypted groups under different keys share one dispatch, which
concatenates the payloads as it stacks the shards.

The scan verb rides the same in-flight dispatches and codec slots as the
other verbs. The reference gives it a slot of its own
(minio_tpu/parallel/scheduler.py:224) because a new plan pays an XLA
compile inside its dispatch; the port's one interpreter kernel compiles
nothing per query.

Each dispatch's stage split is observed in
``minio_tpu_device_dispatch_seconds{verb, stage}`` under the reference's
stage names (queue, transfer, compute, fetch), and attached to every
submitter's span tree: ``sched.dispatch`` (verb, blocks, coalesced) with
``sched.queue`` and the ``sched.transfer``/``sched.compute``/
``sched.fetch`` children, whose durations are the codec's spans between
CUDA events for that dispatch, laid end to end from the dispatch's start
(reference :527-548). The submitter's span is captured at submit, since
the collector and dispatch threads serve many requests. A dispatch the
codec's size gate routes to the host gets no stage children. A declined
submission emits one ``device.decline`` record per reason.

Left out: the mesh split points and the MINIO_TPU_SCHED_ATTRIB switch
(attribution is always on).

Knobs: MINIO_TPU_SCHED_MAX_BATCH (32 blocks per fused dispatch),
MINIO_TPU_SCHED_MAX_WAIT_MS (3, the coalescing grace window),
MINIO_TPU_SCHED_INFLIGHT (2 dispatches in flight).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..utils import eventlog, knobs, telemetry

MAX_BATCH_BLOCKS = knobs.get_int("MINIO_TPU_SCHED_MAX_BATCH")
MAX_WAIT_S = knobs.get_float("MINIO_TPU_SCHED_MAX_WAIT_MS") / 1e3
INFLIGHT = max(1, knobs.get_int("MINIO_TPU_SCHED_INFLIGHT"))

VERBS = ("encode", "decode", "recover", "decipher", "scan")

_BATCHES_TOTAL = telemetry.REGISTRY.counter(
    "minio_tpu_sched_batches_total", "Fused device dispatches issued")
_COALESCED_TOTAL = telemetry.REGISTRY.counter(
    "minio_tpu_sched_coalesced_total",
    "Groups that shared another request's dispatch")
# where a fused dispatch spends its time, per verb: "queue" (submit ->
# dispatch start) and the codec's spans (object/codec.py STEP_STAGES:
# batch assembly + copy onto the device, launches to completion, copy
# back; spans between CUDA events, which hold host gaps, not device time)
_STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                  0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)
DISPATCH_STAGE_SECONDS = telemetry.REGISTRY.histogram(
    "minio_tpu_device_dispatch_seconds",
    "Fused device dispatch stage timings (queue and the codec's "
    "transfer/compute/fetch spans) per verb", buckets=_STAGE_BUCKETS)
# the codec's stage names (object/codec.py STEP_STAGES) -> the stage
# label values and span names the reference uses
STAGE_NAMES = {"transfer_span_s": "transfer", "compute_span_s": "compute",
               "fetch_span_s": "fetch"}


# every live former, for the exposition-time collector (a node's former
# and, in one process, its peers')
_SCHEDULERS: "weakref.WeakSet[BatchScheduler]" = weakref.WeakSet()


def _collect_scheduler_metrics() -> None:
    reg = telemetry.REGISTRY
    queued_groups = queued_blocks = batches = blocks = inflight = 0
    verbs: dict[str, list[int]] = {v: [0, 0] for v in VERBS}
    for s in list(_SCHEDULERS):
        st = s.stats()
        queued_groups += st["queued_groups"]
        queued_blocks += st["queued_blocks"]
        batches += st["batches"]
        blocks += st["dispatched_blocks"]
        inflight += st["inflight"]
        for v, vs in st["verbs"].items():
            verbs[v][0] += vs["batches"]
            verbs[v][1] += vs["coalesced"]
    reg.gauge("minio_tpu_sched_inflight_dispatches",
              "Device dispatches currently airborne (transfer/compute "
              "overlap depth)").set(inflight)
    reg.gauge("minio_tpu_sched_queue_depth",
              "Work groups waiting on the batch former").set(
        queued_groups)
    reg.gauge("minio_tpu_sched_queued_blocks",
              "Blocks waiting on the batch former").set(queued_blocks)
    reg.gauge("minio_tpu_sched_batch_occupancy_blocks",
              "Mean blocks per fused dispatch (the card's batch fill)").set(
        round(blocks / batches, 3) if batches else 0)
    g = reg.gauge("minio_tpu_sched_batch_occupancy_groups",
                  "Mean request groups per fused dispatch, by verb")
    for v, (b, c) in verbs.items():
        g.set(round((b + c) / b, 3) if b else 0, verb=v)


telemetry.REGISTRY.register_collector(_collect_scheduler_metrics)


class _Pending:
    __slots__ = ("codec", "data", "payload", "blocks", "event", "out",
                 "error", "t_submit", "span")

    def __init__(self, codec, data: np.ndarray, payload=None):
        self.codec = codec
        self.data = data
        # SSE groups: (keys (B, 8), nonces (B, P, 3)) u32 word arrays;
        # scan groups: the ops/scan_program.Program of their plan
        self.payload = payload
        self.blocks = int(data.shape[0])
        self.event = threading.Event()
        self.out = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        # the submitter's span: the collector and dispatch threads are
        # shared across requests, so dispatch spans are attached to it
        # explicitly
        self.span = telemetry.current_span()


class DispatchFuture:
    """Handle for one submitted work group: the caller submits and moves
    on, and resolves the future when it needs the result.

    result() returns the verb's tuple — encode (parity, digests); decode
    (missing, missing_idx, survivor_digests); recover (out, idxs,
    survivor_digests, out_digests) — or None when the work must take the
    caller's local path; it raises the dispatch's exception."""

    __slots__ = ("_pending", "_value")

    def __init__(self, pending: Optional[_Pending] = None, value=None):
        self._pending = pending
        self._value = value

    def done(self) -> bool:
        return self._pending is None or self._pending.event.is_set()

    def result(self, timeout: Optional[float] = None):
        p = self._pending
        if p is None:
            return self._value
        if not p.event.wait(timeout):
            raise TimeoutError("batch dispatch did not complete")
        if p.error is not None:
            raise p.error
        return p.out


class BatchScheduler:
    """Geometry-bucketed multi-verb device-batch former."""

    def __init__(self, max_batch: int = MAX_BATCH_BLOCKS,
                 max_wait: float = MAX_WAIT_S,
                 inflight: int = INFLIGHT):
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._mu = threading.Lock()
        # (verb, device, k, m, S, algo value, extra) -> [_Pending]: no
        # codec identity, so groups of different engines (erasure sets,
        # pools) of one geometry share a dispatch (reference
        # minio_tpu/parallel/scheduler.py:202, 322-327); `extra` holds the
        # survivor pattern and, for SSE groups, ("sse", P, pkg_bytes)
        self._buckets: dict[tuple, list[_Pending]] = {}
        self._bucket_blocks: dict[tuple, int] = {}
        self._kick = threading.Condition(self._mu)
        self._stop = False
        self.batches = 0              # dispatches issued
        self.coalesced = 0            # groups that shared a dispatch
        self.dispatched_blocks = 0    # blocks through the dispatches
        self.declined = 0             # submissions refused at the door
        self.host_routed = 0          # dispatches the codec sent to host
        self.verb_stats = {v: {"batches": 0, "coalesced": 0, "blocks": 0,
                               "host_routed": 0} for v in VERBS}
        self._airborne = 0            # dispatches currently in flight
        self._inflight = threading.BoundedSemaphore(max(1, inflight))
        self._pool = ThreadPoolExecutor(max_workers=max(1, inflight),
                                        thread_name_prefix="sched-dispatch")
        self._thread = threading.Thread(target=self._collector,
                                        name="sched-collector", daemon=True)
        self._thread.start()
        _SCHEDULERS.add(self)

    def stats(self) -> dict:
        """Queue depth and dispatch occupancy."""
        with self._mu:
            plists = list(self._buckets.values())
            return {"queued_groups": sum(len(pl) for pl in plists),
                    "queued_blocks": sum(p.blocks for pl in plists
                                         for p in pl),
                    "batches": self.batches,
                    "coalesced": self.coalesced,
                    "dispatched_blocks": self.dispatched_blocks,
                    "declined": self.declined,
                    "host_routed": self.host_routed,
                    "inflight": self._airborne,
                    "verbs": {v: dict(s)
                              for v, s in self.verb_stats.items()}}

    def close(self) -> None:
        """Flush pending groups (their waiters resolve to None and take
        their local paths), join the collector, and drain the in-flight
        dispatches. This is shutdown, not a device failure."""
        with self._mu:
            if self._stop:
                return
            self._stop = True
            self._kick.notify_all()
        self._thread.join(timeout=10)
        self._pool.shutdown(wait=True)

    # -- caller side -------------------------------------------------------

    def _declined(self, codec, algo) -> bool:
        """The codec's own device cannot run this verb's fused steps for
        `algo` (no device hash kernel, or no parity)."""
        if codec.fused_route(algo):
            return False
        with self._mu:
            self.declined += 1
        eventlog.emit_once("device.decline", stage="scheduler",
                           reason="no-parity" if codec.m == 0 else "algo")
        return True

    def _enqueue(self, key: tuple, codec, data: np.ndarray, sse=None,
                 payload=None) -> DispatchFuture:
        if sse is not None:
            payload = (np.ascontiguousarray(sse[0], np.uint32),
                       np.ascontiguousarray(sse[1], np.uint32))
        p = _Pending(codec, np.ascontiguousarray(data, np.uint8), payload)
        with self._mu:
            if self._stop:
                return DispatchFuture()
            self._buckets.setdefault(key, []).append(p)
            self._bucket_blocks[key] = \
                self._bucket_blocks.get(key, 0) + p.blocks
            self._kick.notify_all()
        return DispatchFuture(p)

    def submit(self, codec, data: np.ndarray, algo, sse=None
               ) -> DispatchFuture:
        """Non-blocking fused encode+digest dispatch of one (B, k, S)
        group. The future resolves to (parity, digests), or to None when
        the work takes the caller's local path; a declined submission
        returns an already-done future.

        sse = (keys (B, 8), nonces (B, P, 3), pkg_bytes) makes it the
        fused cipher+encode+digest dispatch
        (codec.encrypt_encode_and_hash_batch): the future then resolves
        to (full (B, k+m, S) with CIPHERTEXT data rows, digests)."""
        if self._declined(codec, algo):
            return DispatchFuture()
        extra = None if sse is None else ("sse", sse[1].shape[1], sse[2])
        key = ("encode", codec.device, codec.k, codec.m, data.shape[-1],
               algo.value, extra)
        return self._enqueue(key, codec, data, sse)

    def submit_decode(self, codec, survivors: np.ndarray,
                      present_mask: int, shard_len: int, algo, sse=None
                      ) -> DispatchFuture:
        """Non-blocking fused verify+decode dispatch for a degraded-GET
        bucket: survivors (B, k, S) stacked in missing_data_matrix `used`
        order. Resolves to (missing, missing_idx, survivor_digests) or
        None. With sse = (keys, nonces, pkg_bytes) it is the fused
        verify+decode+decipher dispatch
        (codec.verify_decode_decrypt_batch): the first element is then the
        deciphered (B, k, S) data shards in shard-index order."""
        if self._declined(codec, algo):
            return DispatchFuture()
        extra = (present_mask, shard_len) if sse is None else \
            (present_mask, shard_len, "sse", sse[1].shape[1], sse[2])
        key = ("decode", codec.device, codec.k, codec.m,
               survivors.shape[-1], algo.value, extra)
        return self._enqueue(key, codec, survivors, sse)

    def submit_recover(self, codec, survivors: np.ndarray,
                       present_mask: int, rows, shard_len: int, algo
                       ) -> DispatchFuture:
        """Non-blocking fused verify+recover+rehash dispatch for a heal
        bucket: survivors (B, k, S) in recover_matrix `used` order.
        Resolves to (out, idxs, survivor_digests, out_digests) or None."""
        if self._declined(codec, algo):
            return DispatchFuture()
        key = ("recover", codec.device, codec.k, codec.m,
               survivors.shape[-1], algo.value,
               (present_mask, frozenset(rows), shard_len))
        return self._enqueue(key, codec, survivors)

    def submit_decipher(self, device, rows: np.ndarray, keys: np.ndarray,
                        nonces: np.ndarray) -> DispatchFuture:
        """Non-blocking decipher of an encrypted GET's verified packages:
        rows (N, Lp) uint8, one package each zero-padded to a 64-byte
        multiple, keys (N, 8) and nonces (N, 3) u32 words. Packages of
        every GET with the same padded width share a dispatch; each
        package counts as one block (max_batch, stats()). Resolves to
        the (N, Lp) plaintext rows, or to None when the scheduler closed
        (the caller then deciphers on its own)."""
        key = ("decipher", device, 0, 0, rows.shape[-1], None, None)
        return self._enqueue(key, None, rows, (keys, nonces))

    def submit_scan(self, device, pages, program) -> DispatchFuture:
        """Non-blocking predicate scan of one Select's tokenized pages
        (scan/pager.Pages) on `device` under `program` (the
        ops/scan_program.Program of pages.plan). Pages bucket by (device,
        plan signature, page shape), so concurrent requests of one query
        coalesce into one launch. Resolves to (mask bool [B, R], counts
        int32 [B, K]) for the request's B pages, or to None when the
        scheduler closed (the caller then answers from the CPU
        evaluator); a failed dispatch raises."""
        from ..ops import scan_cuda
        key = ("scan", device, 0, 0, pages.shape_key(), program.signature,
               None)
        return self._enqueue(key, None, scan_cuda.pack_pages(pages.arrays),
                             payload=program)

    def encode_and_hash(self, codec, data: np.ndarray, algo
                        ) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Blocking fused encode+digest via the shared batch former."""
        return self.submit(codec, data, algo).result()

    # -- collector ---------------------------------------------------------

    def _full_bucket_locked(self) -> bool:
        return any(b >= self.max_batch
                   for b in self._bucket_blocks.values())

    def _collector(self) -> None:
        while True:
            with self._mu:
                while not self._buckets and not self._stop:
                    self._kick.wait(0.25)
                if not self._stop and not self._full_bucket_locked():
                    # a short grace window lets concurrent streams
                    # coalesce; a bucket that is already full, or fills
                    # mid-window, dispatches now
                    deadline = time.monotonic() + self.max_wait
                    while (not self._stop
                           and not self._full_bucket_locked()):
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            break
                        self._kick.wait(rem)
                # drain every ready bucket this wakeup: mixed verbs and
                # geometries must not serialize behind each other's
                # grace windows
                ready = list(self._buckets.items())
                self._buckets.clear()
                self._bucket_blocks.clear()
                stopping = self._stop
            for key, plist in ready:
                if stopping:
                    for p in plist:      # shutdown: local paths
                        p.event.set()
                else:
                    self._split_dispatch(key, plist)
            if stopping:
                return

    def _split_dispatch(self, key: tuple, plist: list) -> None:
        """Split one bucket into <= max_batch-block groups and launch them
        on the dispatch pool (at most `inflight` airborne at once)."""
        groups: list[list] = []
        cur: list = []
        n_blocks = 0
        for p in plist:
            if cur and n_blocks + p.blocks > self.max_batch:
                groups.append(cur)
                cur, n_blocks = [], 0
            cur.append(p)
            n_blocks += p.blocks
        if cur:
            groups.append(cur)
        for group in groups:
            self._inflight.acquire()
            try:
                self._pool.submit(self._dispatch_group, key, group)
            except RuntimeError:       # the pool shut down (close race)
                self._inflight.release()
                for p in group:
                    p.event.set()

    def _dispatch_group(self, key: tuple, group: list) -> None:
        with self._mu:
            self._airborne += 1
        try:
            self._dispatch_one(key, group)
        except Exception as e:  # noqa: BLE001 — to every waiter
            for p in group:
                if not p.event.is_set():
                    p.error = e
                    p.event.set()
        finally:
            with self._mu:
                self._airborne -= 1
            self._inflight.release()

    def _dispatch_one(self, key: tuple, group: list) -> None:
        verb = key[0]
        stages: dict[str, float] = {}
        t0_wall, t0 = time.time(), time.perf_counter()
        run = {"decipher": self._run_decipher,
               "scan": self._run_scan}.get(verb, self._run_erasure)
        out = run(key, group,
                  lambda name, s: stages.__setitem__(STAGE_NAMES[name], s))
        dt = time.perf_counter() - t0
        nb = sum(p.blocks for p in group)
        with self._mu:
            self.batches += 1
            self.coalesced += len(group) - 1
            self.dispatched_blocks += nb
            vs = self.verb_stats[verb]
            vs["batches"] += 1
            vs["coalesced"] += len(group) - 1
            vs["blocks"] += nb
            if out is None:
                self.host_routed += 1
                vs["host_routed"] += 1
        _BATCHES_TOTAL.inc(verb=verb)
        if len(group) > 1:
            _COALESCED_TOTAL.inc(len(group) - 1, verb=verb)
        for p in group:
            if p.span is not None:
                self._attach_spans(p, verb, nb, len(group), t0_wall, t0,
                                   dt, stages if out is not None else None)
        if out is None:
            for p in group:      # the codec's size gate: local paths
                p.event.set()
            return
        for p in group:
            DISPATCH_STAGE_SECONDS.observe(max(t0 - p.t_submit, 0.0),
                                           verb=verb, stage="queue")
        for stage, sdt in stages.items():
            DISPATCH_STAGE_SECONDS.observe(sdt, verb=verb, stage=stage)
        at = 0
        for p in group:
            b = p.blocks
            if verb == "decipher":
                p.out = out[at:at + b]
            elif verb == "scan":
                mask, counts = out
                p.out = (mask[at:at + b], counts[at:at + b])
            elif verb == "encode":
                parity, digests = out
                p.out = (parity[at:at + b], digests[at:at + b])
            elif verb == "decode":
                missing, missing_idx, sdig = out
                p.out = (missing[at:at + b], missing_idx, sdig[at:at + b])
            else:
                rec, idxs, sdig, odig = out
                p.out = (rec[at:at + b], idxs, sdig[at:at + b],
                         odig[at:at + b])
            at += b
            p.event.set()

    @staticmethod
    def _attach_spans(p: _Pending, verb: str, blocks: int, groups: int,
                      t0_wall: float, t0: float, dt: float,
                      stages: Optional[dict]) -> None:
        """Attach one dispatch to a submitter's tree as an externally
        timed ``sched.dispatch`` span, with the queue wait and the codec's
        stage spans (None when the codec routed the batch to the host)
        as its children, laid end to end from the dispatch's start."""
        d = telemetry.attach_span(p.span, "sched.dispatch", t0_wall, dt,
                                  verb=verb, blocks=blocks,
                                  coalesced=groups - 1)
        if d is None or stages is None:
            return
        qw = max(t0 - p.t_submit, 0.0)
        telemetry.attach_span(d, "sched.queue", t0_wall - qw, qw)
        off = t0_wall
        for stage in ("transfer", "compute", "fetch"):
            sdt = stages.get(stage)
            if sdt is not None:
                telemetry.attach_span(d, f"sched.{stage}", off, sdt)
                off += sdt

    @staticmethod
    def _run_decipher(key: tuple, group: list, stage_cb):
        from ..object.codec import decipher_packages
        return decipher_packages(
            key[1], [p.data for p in group],
            np.concatenate([p.payload[0] for p in group]),
            np.concatenate([p.payload[1] for p in group]),
            stage_cb=stage_cb)

    @staticmethod
    def _run_scan(key: tuple, group: list, stage_cb):
        from ..scan import kernels as scan_kernels
        # one plan signature per bucket: the first group's program serves
        return scan_kernels.run_packed(key[1], group[0].payload, key[4],
                                       [p.data for p in group],
                                       stage_cb=stage_cb)

    @staticmethod
    def _run_erasure(key: tuple, group: list, stage_cb):
        from .. import bitrot as bitrot_mod
        verb, _dev, _k, _m, _s, algo_value, extra = key
        algo = bitrot_mod.BitrotAlgorithm.from_string(algo_value)
        # every group of the bucket has this geometry and device, so the
        # first group's codec serves the merged batch
        codec = group[0].codec
        # the groups are stacked by the codec, straight into the pinned
        # input staging of the dispatch's slot on the card
        parts = [p.data for p in group]
        if extra is not None and "sse" in extra:
            # per-row key and nonce words stack like the shards do
            keys = np.concatenate([p.payload[0] for p in group])
            nonces = np.concatenate([p.payload[1] for p in group])
            pkg_bytes = extra[-1]
        if verb == "encode":
            if extra is not None:
                return codec.encrypt_encode_and_hash_batch(
                    parts, keys, nonces, pkg_bytes, algo, stage_cb=stage_cb)
            return codec.encode_and_hash_batch(parts, algo,
                                               stage_cb=stage_cb)
        if verb == "decode":
            mask, shard_len = extra[:2]
            if len(extra) > 2:
                return codec.verify_decode_decrypt_batch(
                    parts, mask, shard_len, keys, nonces, pkg_bytes, algo,
                    stage_cb=stage_cb)
            return codec.verify_and_decode_batch(parts, mask, shard_len,
                                                 algo, stage_cb=stage_cb)
        mask, rows, shard_len = extra
        return codec.verify_and_recover_batch(parts, mask, set(rows),
                                              shard_len, algo,
                                              stage_cb=stage_cb)


# ---------------------------------------------------------------------------
# RAM-budgeted request admission (cmd/handler-api.go:46-57)
# ---------------------------------------------------------------------------

def requests_budget(block_size: int, set_drive_count: int,
                    ram_fraction: float = 0.5) -> int:
    """max in-flight object requests = min(RAM budget, CPU budget).

    RAM: RAM/2 / (blockSize*driveCount + 2*blockSize), the reference's
    per-request staging footprint (cmd/handler-api.go:46-57). CPU: each
    data-path request runs real erasure and hash work between GIL
    releases, so admitting far more streams than cores only splits the
    cache working set. Waiters queue on the admission semaphore, so
    capped requests are delayed, not refused."""
    total = _total_ram()
    per_req = block_size * set_drive_count + 2 * block_size
    ram_budget = int(total * ram_fraction) // max(per_req, 1)
    cpu_budget = 8 * (os.cpu_count() or 1)
    return max(8, min(ram_budget, cpu_budget))


def _total_ram() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30
