"""Double-buffered stage pipeline for the object data paths.

Counterpart of minio_tpu/parallel/pipeline.py:58-353. The fork wins its
throughput by overlap: MD5 runs asynchronously while erasure encode and
shard writes proceed (cmd/erasure-encode.go:113-124). This module
generalizes that to the whole data path:

  * :class:`StagePipeline` — each stage runs on its own thread, connected
    by BOUNDED queues; the bounds are the back-pressure, so staging RAM is
    capped by queue depth x buffer size.
  * the :class:`~minio_tpu_torch.parallel.bpool.BytePool` staging rings,
    keyed by buffer width (and, in the port, by whether the buffers are
    pinned for a CUDA engine): PUT streams borrow their (B, k*S) encode
    buffers here.
  * :data:`STATS` — always-on overlap accounting (wall vs sum-of-stage
    seconds, GET prefetch savings, pool pressure), exported as the
    ``minio_tpu_pipeline_*`` gauges by an exposition-time collector.

Stage threads inherit the creating request's span context, so spans of
stage bodies land in the request's tree.

Knobs (utils/knobs.py): MINIO_TPU_PIPELINE (off selects the serial
loops), MINIO_TPU_PIPELINE_DEPTH, MINIO_TPU_PIPELINE_POOL,
MINIO_TPU_PIPELINE_POOL_TIMEOUT_S.
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from ..utils import knobs, telemetry
from .bpool import BytePool

ENABLED = knobs.get_bool("MINIO_TPU_PIPELINE")
DEPTH = max(1, knobs.get_int("MINIO_TPU_PIPELINE_DEPTH"))
# staging ring size: the pool is SHARED by every stream of a geometry, so
# it must scale with the admitted concurrency (each admitted stream keeps
# ~2 batches in flight); configure_pool_buffers() re-derives it from the
# admission budget, and the env knob always wins
_POOL_ENV_SET = knobs.is_set("MINIO_TPU_PIPELINE_POOL")
POOL_BUFFERS = max(4, knobs.get_int("MINIO_TPU_PIPELINE_POOL"))
POOL_TIMEOUT_S = knobs.get_float("MINIO_TPU_PIPELINE_POOL_TIMEOUT_S")


def configure_pool_buffers(requests_budget: int) -> int:
    """Size the staging rings from the RAM-gated admission budget (~2
    staging buffers per admitted request). Applies to rings created
    after the call; MINIO_TPU_PIPELINE_POOL overrides. Returns the
    effective size."""
    global POOL_BUFFERS
    if not _POOL_ENV_SET:
        POOL_BUFFERS = max(4, 2 * int(requests_budget))
    return POOL_BUFFERS


# GET lookahead reads run here, NOT on the drive-io pool: a prefetch task
# fans its per-reader reads out onto that pool, and a task that waits on
# subtasks of its own pool can deadlock when the pool saturates
PREFETCH_POOL = ThreadPoolExecutor(
    max_workers=max(16, 4 * (os.cpu_count() or 4)),
    thread_name_prefix="get-prefetch")

_EOT = object()          # end-of-stream sentinel on the stage queues


# ---------------------------------------------------------------------------
# staging buffer rings
# ---------------------------------------------------------------------------

_pools: dict[tuple[int, bool], BytePool] = {}
_pools_mu = threading.Lock()


def staging_pool(width: int, pinned: bool = False) -> BytePool:
    """The shared staging ring for `width`-byte encode buffers — one ring
    per geometry, shared by every stream with that geometry. `pinned`
    selects page-locked buffers (a CUDA engine's ring)."""
    with _pools_mu:
        pool = _pools.get((width, pinned))
        if pool is None:
            pool = BytePool(width, POOL_BUFFERS, pinned=pinned)
            _pools[(width, pinned)] = pool
        return pool


def pool_pressure() -> dict:
    """Aggregate wait/exhaustion counters across every staging ring."""
    with _pools_mu:
        pools = list(_pools.values())
    return {"waits": sum(p.waits for p in pools),
            "exhausted": sum(p.exhausted for p in pools),
            "rings": len(pools)}


# ---------------------------------------------------------------------------
# overlap accounting
# ---------------------------------------------------------------------------

class PipelineStats:
    """Always-on counters for the pipelined data path (a handful of float
    adds per stream, not per block). wall < stage_sum means the stages
    actually overlapped; stage_sum / wall is the effective parallelism."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.put_streams = 0
        self.put_batches = 0
        self.put_wall_s = 0.0
        self.put_stage_s = 0.0
        self.get_groups = 0
        self.get_prefetched = 0
        self.get_prefetch_wait_s = 0.0     # time spent waiting on lookahead
        self.get_prefetch_read_s = 0.0     # what the read actually cost

    def record_put(self, wall_s: float, stage_s: float,
                   batches: int) -> None:
        with self._mu:
            self.put_streams += 1
            self.put_batches += batches
            self.put_wall_s += wall_s
            self.put_stage_s += stage_s

    def record_get_group(self, prefetched: bool, wait_s: float = 0.0,
                         read_s: float = 0.0) -> None:
        with self._mu:
            self.get_groups += 1
            if prefetched:
                self.get_prefetched += 1
                self.get_prefetch_wait_s += wait_s
                self.get_prefetch_read_s += read_s

    def snapshot(self) -> dict:
        with self._mu:
            out = {
                "enabled": int(ENABLED),
                "put_streams": self.put_streams,
                "put_batches": self.put_batches,
                "put_wall_s": round(self.put_wall_s, 4),
                "put_stage_s": round(self.put_stage_s, 4),
                "get_groups": self.get_groups,
                "get_prefetched": self.get_prefetched,
                "get_prefetch_wait_s": round(self.get_prefetch_wait_s, 4),
                "get_prefetch_saved_s": round(
                    max(self.get_prefetch_read_s
                        - self.get_prefetch_wait_s, 0.0), 4),
            }
        out.update({f"bpool_{k}": v for k, v in pool_pressure().items()
                    if k != "rings"})
        return out


STATS = PipelineStats()

_PIPELINE_GAUGE_HELP = {
    "enabled": "1 when the pipelined PUT/GET hot loops are selected",
    "put_streams_total": "PUT streams run through the stage pipeline",
    "put_batches_total": "Encode batches fed through the PUT pipeline",
    "put_wall_seconds_total": "Wall seconds inside pipelined PUT loops",
    "put_stage_seconds_total":
        "Summed per-stage seconds (ingest+encode+write) of pipelined "
        "PUT loops; ratio vs wall = achieved overlap",
    "get_groups_total": "GET block groups read",
    "get_prefetched_total":
        "GET block groups served via the one-group lookahead",
    "get_prefetch_saved_seconds_total":
        "Drive-read seconds hidden behind verify+decode by the GET "
        "lookahead",
    "bpool_waits_total":
        "Staging-buffer gets that had to block (back-pressure)",
    "bpool_exhausted_total":
        "Staging-buffer gets that timed out (pipeline stalled)",
}
# snapshot key -> exported suffix (names predate the registry and are
# kept stable for dashboards/tests)
_PIPELINE_GAUGE_KEYS = {
    "enabled": "enabled",
    "put_streams": "put_streams_total",
    "put_batches": "put_batches_total",
    "put_wall_s": "put_wall_seconds_total",
    "put_stage_s": "put_stage_seconds_total",
    "get_groups": "get_groups_total",
    "get_prefetched": "get_prefetched_total",
    "get_prefetch_saved_s": "get_prefetch_saved_seconds_total",
    "bpool_waits": "bpool_waits_total",
    "bpool_exhausted": "bpool_exhausted_total",
}


def _collect_pipeline_metrics() -> None:
    """Registry collector: refresh minio_tpu_pipeline_* from STATS at
    exposition time (no polling thread)."""
    snap = STATS.snapshot()
    for key, suffix in _PIPELINE_GAUGE_KEYS.items():
        if key in snap:
            telemetry.REGISTRY.gauge(
                f"minio_tpu_pipeline_{suffix}",
                _PIPELINE_GAUGE_HELP[suffix]).set(snap[key])


telemetry.REGISTRY.register_collector(_collect_pipeline_metrics)


# ---------------------------------------------------------------------------
# the stage executor
# ---------------------------------------------------------------------------

class StagePipeline:
    """Run items through `stages` (each fn(item) -> next item) with one
    thread per stage and bounded hand-off queues.

    * Order-preserving: one worker per stage + FIFO queues, so shard
      frames land on the writers in block order.
    * Back-pressure: `submit()` blocks when the first queue is full; a
      stage blocked on a full downstream queue stops pulling upstream.
    * Fail-fast: the FIRST stage exception is kept and re-raised (the
      original object, so quorum errors keep their type) from the next
      `submit()` or from `close()`. After a failure workers keep draining
      but stop processing — queued items go to `on_drop` so pooled
      buffers return to their ring instead of leaking with the wreck.
    """

    def __init__(self, stages: Sequence[Callable], depth: int = DEPTH,
                 name: str = "pipeline",
                 on_drop: Optional[Callable] = None):
        assert stages, "a pipeline needs at least one stage"
        self._stages = list(stages)
        self._on_drop = on_drop
        self._queues = [queue.Queue(maxsize=max(1, depth))
                        for _ in stages]
        self._error: Optional[BaseException] = None
        self._err_mu = threading.Lock()
        # stage workers inherit the creating request's span context so
        # stage-body spans land in the right tree (one Context copy per
        # thread — a Context must not run concurrently)
        tracing = telemetry.current_span() is not None

        def _target(i: int) -> Callable:
            if not tracing:
                return lambda: self._run(i)
            cctx = contextvars.copy_context()
            return lambda: cctx.run(self._run, i)

        self._threads = [
            threading.Thread(target=_target(i),
                             name=f"{name}-stage{i}", daemon=True)
            for i in range(len(stages))]
        for t in self._threads:
            t.start()

    # -- producer side -----------------------------------------------------

    def submit(self, item) -> None:
        """Feed one item to stage 0; raises the pipeline's pending error
        (dropping `item` via on_drop) instead of queueing into a wreck."""
        while True:
            err = self._error
            if err is not None:
                self._drop(item)
                raise err
            try:
                self._queues[0].put(item, timeout=0.1)
                return
            except queue.Full:
                continue        # re-check the error while blocked

    def close(self, abort: bool = False) -> None:
        """End of stream: wait for in-flight items, join the workers, and
        re-raise the first stage error (unless `abort`, the caller's-own-
        exception path, where the pipeline error would mask it)."""
        if abort:
            with self._err_mu:
                if self._error is None:
                    self._error = _Aborted()
        self._queues[0].put(_EOT)
        for t in self._threads:
            t.join()
        if not abort and self._error is not None \
                and not isinstance(self._error, _Aborted):
            raise self._error

    @property
    def failed(self) -> bool:
        return self._error is not None

    # -- workers -----------------------------------------------------------

    def _drop(self, item) -> None:
        if self._on_drop is not None and item is not _EOT:
            try:
                self._on_drop(item)
            except Exception:  # noqa: BLE001 — drop hooks are best-effort
                pass

    def _run(self, idx: int) -> None:
        fn = self._stages[idx]
        q = self._queues[idx]
        nxt = self._queues[idx + 1] if idx + 1 < len(self._queues) \
            else None
        while True:
            item = q.get()
            if item is _EOT:
                if nxt is not None:
                    nxt.put(_EOT)
                return
            if self._error is not None:
                self._drop(item)
                continue
            try:
                out = fn(item)
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                with self._err_mu:
                    if self._error is None:
                        self._error = e
                self._drop(item)
                continue
            if nxt is None:
                continue
            while True:
                if self._error is not None:
                    self._drop(out)
                    break
                try:
                    nxt.put(out, timeout=0.1)
                    break
                except queue.Full:
                    continue


class _Aborted(Exception):
    """Internal sentinel error: the caller aborted the stream (its own
    exception is in flight) — workers drain, nothing re-raises."""
