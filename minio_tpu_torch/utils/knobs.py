"""Registry of the ``MINIO_TPU_*`` tuning knobs the port reads.

Counterpart of minio_tpu/utils/knobs.py, trimmed to the knobs of the
pipelined data path, the batch former, heal, the MRF queue, the disk
monitor, the SSE cipher choice, the scan plane, the tier plane, the
bucket metacache, the hot-object read cache, the admission gate, the
multi-tenant QoS plane, the HTTP edge, the internode RPC transport, the gray-failure plane, the IAM
refresh, the federated metrics scrape, and the tracing and incident
planes, with the reference's names, types and defaults
(minio_tpu/utils/knobs.py:160-197, :203-206, :220-235, :261-281, :284-306,
:238-264, :310-346, :356-359, :370-383, :403-410, :434-435, :438-485, :535-586),
and the checking plane's naughtynet and lock-order watchdog (:350-353,
:590-600). Left out: the README table renderer and every knob no ported
module reads. No knob here is one the reference lacks.

Getters read the environment at call time: tests flip knobs with
``monkeypatch.setenv`` and modules that want an import-time snapshot call
the getter at module scope. A value that does not parse falls back to the
declared default. Booleans accept ``on/1/true/yes`` and ``off/0/false/no``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Union

_TRUE = ("on", "1", "true", "yes")
_FALSE = ("off", "0", "false", "no")

Default = Union[str, int, float, bool, Callable[[], Union[int, float, str]]]


class Knob:
    """One declared knob: name, type, default, one-line doc."""

    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, type_: str, default: Default, doc: str):
        assert name.startswith("MINIO_TPU_"), name
        assert type_ in ("str", "int", "float", "bool"), type_
        self.name, self.type, self.default, self.doc = \
            name, type_, default, doc

    def resolve_default(self):
        d = self.default
        return d() if callable(d) else d


KNOBS: Dict[str, Knob] = {}


def define(name: str, type_: str, default: Default, doc: str) -> Knob:
    assert name not in KNOBS, f"knob {name} declared twice"
    KNOBS[name] = k = Knob(name, type_, default, doc)
    return k


def get(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(f"unregistered knob {name!r}") from None


def is_set(name: str) -> bool:
    get(name)
    return name in os.environ


def get_str(name: str) -> str:
    k = get(name)
    v = os.environ.get(name)
    return str(k.resolve_default()) if v is None else v


def get_int(name: str) -> int:
    k = get(name)
    v = os.environ.get(name)
    if v is not None:
        try:
            return int(v)
        except ValueError:
            pass
    return int(k.resolve_default())


def get_float(name: str) -> float:
    k = get(name)
    v = os.environ.get(name)
    if v is not None:
        try:
            return float(v)
        except ValueError:
            pass
    return float(k.resolve_default())


def get_bool(name: str) -> bool:
    k = get(name)
    v = os.environ.get(name)
    if v is not None:
        s = v.strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
    return bool(k.resolve_default())


# -- data path ---------------------------------------------------------------
define("MINIO_TPU_PIPELINE", "bool", True,
       "`off` selects the serial PUT/GET hot loops")
define("MINIO_TPU_PIPELINE_DEPTH", "int", 2,
       "bounded queue depth between pipeline stages")
define("MINIO_TPU_PIPELINE_POOL", "int",
       lambda: 2 * (os.cpu_count() or 4),
       "staging buffers per geometry ring (2 x cores)")
define("MINIO_TPU_PIPELINE_POOL_TIMEOUT_S", "float", 60.0,
       "staging-buffer wait before the PUT fails loudly")
define("MINIO_TPU_ENCODE_BATCH", "int", 8,
       "blocks fused per PUT encode+digest call")
define("MINIO_TPU_GET_BATCH", "int", 8,
       "blocks fused per GET verify/decode call")
define("MINIO_TPU_HEAL_BATCH", "int", 8,
       "blocks fused per heal recover call")
define("MINIO_TPU_DEVICE_MIN_BYTES", "int", 8 << 20,
       "batch bytes below which the codec stays on the host path")

# -- batch former ------------------------------------------------------------
define("MINIO_TPU_SCHED_MAX_BATCH", "int", 32,
       "blocks per fused device dispatch")
define("MINIO_TPU_SCHED_MAX_WAIT_MS", "float", 3.0,
       "cross-request coalescing grace window, milliseconds")
define("MINIO_TPU_SCHED_INFLIGHT", "int", 2,
       "concurrent dispatches in flight (transfer/compute overlap)")

# -- MRF heal queue ----------------------------------------------------------
define("MINIO_TPU_MRF_QUEUE_SIZE", "int", 10000,
       "bounded MRF heal-queue entries (overflow drops the hint)")
define("MINIO_TPU_MRF_MAX_RETRIES", "int", 10,
       "MRF heal attempts before an entry counts as failed")
define("MINIO_TPU_MRF_BACKOFF_BASE", "float", 0.05,
       "first MRF retry delay, seconds (doubles per attempt)")
define("MINIO_TPU_MRF_BACKOFF_MAX", "float", 15.0,
       "MRF retry delay cap, seconds")

# -- disk monitor ------------------------------------------------------------
define("MINIO_TPU_DISK_PROBE_S", "float", 10.0,
       "DiskMonitor scan interval: dead-slot re-probes AND slow-drive "
       "health evaluation run on this cadence")

# -- gray-failure plane (minio_tpu/utils/knobs.py:310-346) --------------------
define("MINIO_TPU_LAT_WINDOW", "int", 64,
       "latency samples retained per (drive/peer, verb) window")
define("MINIO_TPU_HEDGE", "bool", True,
       "`off` disables latency-hedged shard reads (error-triggered "
       "hedging stays)")
define("MINIO_TPU_HEDGE_K", "float", 3.0,
       "hedge deadline = healthy read p95 x this")
define("MINIO_TPU_HEDGE_FLOOR_S", "float", 0.05,
       "hedge deadline floor, seconds")
define("MINIO_TPU_HEDGE_CEIL_S", "float", 2.0,
       "hedge deadline ceiling, seconds (also the cold-start value "
       "before any latency samples exist)")
define("MINIO_TPU_QUORUM_ACK", "bool", True,
       "`off` makes every shard-write fan-out wait for ALL drives "
       "again instead of acking at write quorum and abandoning "
       "laggards to the MRF-fed background lane")
define("MINIO_TPU_WRITE_STALL_K", "float", 4.0,
       "write-straggler grace = healthy write p95 x this")
define("MINIO_TPU_WRITE_STALL_FLOOR_S", "float", 0.5,
       "write-straggler grace floor, seconds")
define("MINIO_TPU_WRITE_STALL_CEIL_S", "float", 10.0,
       "write-straggler grace ceiling, seconds (cold-start value)")
define("MINIO_TPU_QUARANTINE", "bool", True,
       "`off` disables the slow-drive suspect/probation state machine")
define("MINIO_TPU_QUAR_LATENCY_S", "float", 0.25,
       "absolute p95 latency above which a drive turns suspect")
define("MINIO_TPU_QUAR_RATIO", "float", 8.0,
       "relative conviction bar: suspect needs p95 above healthy-peer "
       "p95 x this too (uniformly slow media quarantine nothing)")
define("MINIO_TPU_QUAR_MIN_SAMPLES", "int", 8,
       "read/write samples required before a drive can be convicted")
define("MINIO_TPU_QUAR_PROBATION_S", "float", 15.0,
       "suspect dwell before probation re-probes begin")
define("MINIO_TPU_QUAR_PROBES", "int", 3,
       "consecutive healthy probation probes before the heal-verified "
       "re-admission")

# -- SSE -------------------------------------------------------------------
define("MINIO_TPU_SSE_CIPHER", "str", "aes-gcm",
       "package cipher for NEW SSE writes: `aes-gcm` (CPU DARE packages) "
       "or `chacha20` (ChaCha20-Poly1305, ciphered on the card); reads "
       "dispatch on each object's recorded cipher")

# -- scan plane ------------------------------------------------------------
define("MINIO_TPU_SCAN_DEVICE", "str", "on",
       "`off` answers every Select from the CPU evaluator; `on` and "
       "`force` ride the scan engine's device")
define("MINIO_TPU_SCAN_PAGE_ROWS", "int", 2048,
       "rows per tokenized column page")
define("MINIO_TPU_SCAN_MAX_STR", "int", 128,
       "widest string cell a page holds; wider cells decline to the CPU")
define("MINIO_TPU_SCAN_KERNEL_CACHE", "int", 64,
       "bounded LRU of flattened scan programs (signatures bake in "
       "query literals)")
define("MINIO_TPU_SCAN_MAX_BYTES", "int", 64 << 20,
       "device-path input cap; bigger objects go to the CPU evaluator")

# -- bucket metacache ---------------------------------------------------------
define("MINIO_TPU_METACACHE", "bool", True,
       "`off` = exactly the old merge-walk listing behavior")
define("MINIO_TPU_METACACHE_FEED", "bool", True,
       "scanners consume the index namespace feed")
define("MINIO_TPU_METACACHE_STALENESS_S", "float", 2.0,
       "serve-time staleness bound (older deltas drain synchronously)")
define("MINIO_TPU_METACACHE_FLUSH_S", "float", 0.2,
       "journal drain cadence, seconds")
define("MINIO_TPU_METACACHE_PERSIST_S", "float", 30.0,
       "min seconds between persisted segment writes")
define("MINIO_TPU_METACACHE_RECONCILE_S", "float", 300.0,
       "drift-repair walk cadence, seconds")
define("MINIO_TPU_METACACHE_SEGMENT_KEYS", "int", 5000,
       "keys per persisted index segment")
define("MINIO_TPU_METACACHE_JOURNAL", "int", 100000,
       "max pending deltas (overflow invalidates the bucket until "
       "reconcile — never a silent wrong listing)")

# -- tier plane ---------------------------------------------------------------
define("MINIO_TPU_TIER_QUEUE_SIZE", "int", 10000,
       "max queued tier-transition entries")
define("MINIO_TPU_TIER_BACKOFF_S", "float", 0.05,
       "first transition backoff when the foreground is busy")
define("MINIO_TPU_TIER_BACKOFF_MAX_S", "float", 1.0,
       "transition backoff cap, seconds")
define("MINIO_TPU_TIER_BACKOFF_TRIES", "int", 8,
       "busy polls before a transition proceeds anyway")
define("MINIO_TPU_RESTORE_ASYNC_BYTES", "int", 64 << 20,
       "RestoreObject switches to 202 + background tier pull at this "
       "size (0 = always synchronous)")

# -- replication plane ----------------------------------------------------------
define("MINIO_TPU_REPL_WORKERS", "int", 2,
       "sync workers draining the replication queue")
define("MINIO_TPU_REPL_QUEUE", "int", 10000,
       "max queued (bucket, key) sync tasks (overflow drops; the "
       "resync verb is the backstop)")
define("MINIO_TPU_REPL_BACKOFF_S", "float", 0.05,
       "first replication backoff when the foreground is busy")
define("MINIO_TPU_REPL_BACKOFF_MAX_S", "float", 1.0,
       "replication backoff cap, seconds")
define("MINIO_TPU_REPL_BACKOFF_TRIES", "int", 8,
       "busy polls before a sync proceeds anyway")
define("MINIO_TPU_REPL_BW_BPS", "int", 0,
       "default per-target push bandwidth budget, bytes/sec "
       "(0 = unlimited; a target's own bw_bps wins)")
define("MINIO_TPU_REPL_RESYNC_CHECKPOINT_EVERY", "int", 16,
       "keys pushed between resync checkpoints")
define("MINIO_TPU_REPL_RESYNC_PAGE", "int", 256,
       "resync listing page size")

# -- registries, topology, durability and fsck ---------------------------------
define("MINIO_TPU_FSYNC", "bool", False,
       "`on` = fsync barriers on commit paths (fsync before rename, "
       "directory fsync after; shard files synced at close) — "
       "power-loss durability at real I/O cost")
define("MINIO_TPU_REGISTRY_WRITE_QUORUM", "str", "1",
       "pools an epoch-registry write must land on before the commit "
       "is acked: a count, or `majority` — below it the write refuses "
       "instead of bumping the epoch on a minority side")
define("MINIO_TPU_REBALANCE_MPU_GRACE_S", "float", 30.0,
       "live multipart sessions idle less than this get a grace "
       "before the decommission drain migrates them off the pool")
define("MINIO_TPU_REBALANCE_CHECKPOINT_EVERY", "int", 16,
       "objects moved between drain checkpoints")
define("MINIO_TPU_REBALANCE_PAGE", "int", 256,
       "rebalance listing page size")
define("MINIO_TPU_REBALANCE_BACKOFF_S", "float", 0.05,
       "first drain backoff when the foreground is busy")
define("MINIO_TPU_REBALANCE_BACKOFF_MAX_S", "float", 1.0,
       "drain backoff cap, seconds")
define("MINIO_TPU_REBALANCE_BACKOFF_TRIES", "int", 8,
       "busy polls before the drain proceeds anyway")
define("MINIO_TPU_FSCK_BOOT", "bool", False,
       "`on` runs the fsck consistency auditor (repair mode) at "
       "cluster boot, feeding repairable findings to heal/MRF")
define("MINIO_TPU_FSCK_TMP_AGE_S", "float", 3600.0,
       "staged tmp writes older than this count as crash leftovers "
       "for fsck (younger ones may be in-flight PUTs)")

# -- hot-object read cache ----------------------------------------------------
define("MINIO_TPU_CACHE", "bool", False,
       "master switch for the erasure-aware read cache")
define("MINIO_TPU_CACHE_DIR", "str", "",
       "cache entry directory (empty: <first-drive>/.minio.sys/cache)")
define("MINIO_TPU_CACHE_BUDGET_BYTES", "int", 1 << 30,
       "watermark LRU budget")
define("MINIO_TPU_CACHE_ADMIT", "int", 2,
       "GETs inside the window before an object is admitted")
define("MINIO_TPU_CACHE_ADMIT_WINDOW_S", "float", 300.0,
       "access-frequency admission window, seconds")

# -- server: admission -------------------------------------------------------
define("MINIO_TPU_MAX_CLIENTS", "int", 0,
       "admission-gate size; 0 derives it from the RAM+CPU budget")
define("MINIO_TPU_REQUEST_DEADLINE", "float", 10.0,
       "seconds a request waits on admission before SlowDown")
define("MINIO_TPU_SHED_WINDOW_S", "float", 5.0,
       "shed data writes this long after a staging-pool timeout")
define("MINIO_TPU_ADMIT_SCHED_QUEUE", "int", 0,
       "queued device-batch blocks above which data writes shed "
       "(scheduler-occupancy admission signal; 0 disables)")
define("MINIO_TPU_REQUEST_QUEUE", "int", 128,
       "threaded-listener accept backlog (socketserver "
       "request_queue_size)")

# -- multi-tenant QoS ----------------------------------------------------------
define("MINIO_TPU_QOS", "bool", False,
       "enforce per-tenant admission shares and budgets at the "
       "admission gate (off = byte-identical legacy behavior)")
define("MINIO_TPU_QOS_DEFAULT_SHARE", "float", 1.0,
       "admission-share weight for tenants without a registered "
       "budget")
define("MINIO_TPU_QOS_DEFAULT_RPS", "float", 0.0,
       "default per-tenant request-rate budget (requests/s); "
       "0 = unlimited")
define("MINIO_TPU_QOS_DEFAULT_RX_BPS", "float", 0.0,
       "default per-tenant request-body byte budget (bytes/s); "
       "0 = unlimited")
define("MINIO_TPU_QOS_DEFAULT_TX_BPS", "float", 0.0,
       "default per-tenant response-body byte budget (bytes/s); "
       "0 = unlimited")
define("MINIO_TPU_QOS_ACTIVE_S", "float", 2.0,
       "seconds since last request a tenant stays in the active set "
       "the share math divides the gate across")
define("MINIO_TPU_QOS_SHED_WINDOW_S", "float", 5.0,
       "debounce window for tenant.shed journal events (first shed "
       "per tenant per window)")

# -- HTTP edge ---------------------------------------------------------------
define("MINIO_TPU_EDGE", "bool", True,
       "`off` selects the threaded frontend (escape hatch and "
       "correctness oracle; TLS listeners always use it)")
define("MINIO_TPU_EDGE_WORKERS", "int", 1,
       "event-loop threads; >1 binds one SO_REUSEPORT listener per "
       "loop")
define("MINIO_TPU_EDGE_MAX_CONNS", "int", 8192,
       "open-connection budget per edge server; beyond it new "
       "connections shed 503 before any read")
define("MINIO_TPU_EDGE_HEADER_S", "float", 10.0,
       "deadline for a complete request line + headers (slowloris "
       "partial requests shed at expiry)")
define("MINIO_TPU_EDGE_IDLE_S", "float", 120.0,
       "idle keep-alive connection deadline (quiet close)")
define("MINIO_TPU_EDGE_POOL", "int", 0,
       "blocking handler worker threads behind the event loop "
       "(0 = 8 x cores + 16)")

# -- internode RPC, peers and locks --------------------------------------------
define("MINIO_TPU_RPC_RETRIES", "int", 2,
       "extra attempts for idempotent RPC verbs")
define("MINIO_TPU_RPC_RETRY_BACKOFF", "float", 0.05,
       "first RPC retry delay, seconds")
define("MINIO_TPU_RPC_RETRY_BACKOFF_MAX", "float", 2.0,
       "RPC retry delay cap, seconds")
define("MINIO_TPU_PEER_PROBE_S", "float", 30.0,
       "offline peer health-probe backoff cap, seconds (any "
       "successful direct call re-admits the host immediately)")
define("MINIO_TPU_NAUGHTYNET", "bool", False,
       "`on` exposes the test-only naughtynet admin verb so harnesses "
       "can partition a live node's internode transport")
define("MINIO_TPU_NAUGHTYNET_SEED", "int", 0,
       "default seed for the naughtynet fault schedule (chaos tests "
       "print the seed they armed)")
define("MINIO_TPU_RPC_STREAM_READ_S", "float", 30.0,
       "per-read socket deadline on streamed RPC responses: a peer "
       "that goes silent mid-stream fails the reader instead of "
       "parking it forever (0 disables)")

# -- tracing and incident planes (minio_tpu/utils/knobs.py:370-383,
# :535-586) --------------------------------------------------------------------
define("MINIO_TPU_TRACE_SLOW_MS", "float", 500.0,
       "span trees at least this slow are always kept")
define("MINIO_TPU_TRACE_SAMPLE", "float", 0.0,
       "keep-probability for ordinary (fast, error-free) traces")
define("MINIO_TPU_TRACE_KEEP", "int", 128,
       "kept span-tree ring size")
define("MINIO_TPU_TRACE_MAX_SPANS", "int", 512,
       "span budget per trace; extras no-op and are counted as "
       "`spans_dropped`")
define("MINIO_TPU_TRACE_FOLLOW_MAX_S", "float", 3600.0,
       "hard lifetime cap on a ?follow=1 trace stream (a forgotten "
       "client cannot hold peer subscriptions forever)")
define("MINIO_TPU_EVENTLOG", "bool", True,
       "`off` disables the structured event journal (emits drop; the "
       "overhead A/B escape hatch)")
define("MINIO_TPU_EVENTLOG_RING", "int", 2048,
       "in-memory journal ring size (the /events backlog bound)")
define("MINIO_TPU_EVENTLOG_SEGMENT_EVENTS", "int", 64,
       "pending events that force an early segment flush")
define("MINIO_TPU_EVENTLOG_FLUSH_S", "float", 2.0,
       "journal segment flush cadence, seconds")
define("MINIO_TPU_EVENTLOG_KEEP_SEGMENTS", "int", 16,
       "persisted journal segments retained (older ones pruned)")
define("MINIO_TPU_EVENTS_FOLLOW_MAX_S", "float", 3600.0,
       "hard lifetime cap on a ?follow=1 event stream (a forgotten "
       "client cannot hold peer subscriptions forever)")
define("MINIO_TPU_SLO", "bool", True,
       "`off` disables the SLO burn-rate engine (gauges stop, no "
       "breach events)")
define("MINIO_TPU_SLO_EVAL_S", "float", 5.0,
       "SLO evaluation cadence, seconds")
define("MINIO_TPU_SLO_WINDOWS_S", "str", "60,300",
       "comma-separated burn-rate windows, seconds (multi-window "
       "alerting: short catches fast burn, long catches slow leaks)")
define("MINIO_TPU_SLO_AVAIL_TARGET", "float", 99.9,
       "availability objective, percent of non-5xx responses per API "
       "class")
define("MINIO_TPU_SLO_LAT_TARGET", "float", 99.0,
       "latency objective, percent of requests under the class "
       "threshold")
define("MINIO_TPU_SLO_LAT_READ_MS", "float", 250.0,
       "read-class latency threshold, milliseconds")
define("MINIO_TPU_SLO_LAT_WRITE_MS", "float", 1000.0,
       "write-class latency threshold, milliseconds")
define("MINIO_TPU_SLO_BURN_THRESHOLD", "float", 4.0,
       "burn rate at which an objective breaches (clears at half "
       "this — hysteresis stops breach/clear flapping)")
define("MINIO_TPU_SLO_MIN_SAMPLES", "int", 10,
       "requests a window must hold before its burn rate can breach "
       "(a single early 500 must not page)")
define("MINIO_TPU_INCIDENTS", "bool", True,
       "`off` disables black-box incident capture")
define("MINIO_TPU_INCIDENT_KEEP", "int", 16,
       "incident bundles retained on disk (older ones pruned)")
define("MINIO_TPU_INCIDENT_DEBOUNCE_S", "float", 30.0,
       "min seconds between captures for the same trigger class "
       "(a flapping trigger must not fill the retention window)")
define("MINIO_TPU_INCIDENT_EVENTS", "str",
       "slo.breach,drive.probation,net.partition,fsck.unrepaired,"
       "registry.fork",
       "comma-separated journal event classes that trigger a capture")
define("MINIO_TPU_INCIDENT_WINDOW", "int", 256,
       "journal entries snapshotted into each bundle")

# -- identity and operator planes (minio_tpu/utils/knobs.py:234, :379) ----
define("MINIO_TPU_IAM_REFRESH_S", "float", 300.0,
       "full IAM cache refresh interval (bounded staleness)")
define("MINIO_TPU_CLUSTER_SCRAPE_S", "float", 2.0,
       "per-peer deadline for the federated metrics scrape "
       "(?cluster=1); a peer past it degrades the scrape and counts in "
       "minio_tpu_cluster_scrape_failed_total")

# -- events and notifications (minio_tpu/utils/knobs.py:488-512) --------------
define("MINIO_TPU_QUEUE_FSYNC", "bool", False,
       "fsync durable event-queue writes (survives power loss)")
define("MINIO_TPU_NOTIFY_WORKERS", "int", 2,
       "delivery workers draining the notification queue")
define("MINIO_TPU_NOTIFY_QUEUE", "int", 10000,
       "max queued (bucket, key) namespace events (overflow drops + "
       "counts; delivery never blocks a mutation)")
define("MINIO_TPU_NOTIFY_BACKOFF_S", "float", 0.05,
       "first delivery backoff when the foreground is busy")
define("MINIO_TPU_NOTIFY_BACKOFF_MAX_S", "float", 1.0,
       "delivery backoff cap, seconds")
define("MINIO_TPU_NOTIFY_BACKOFF_TRIES", "int", 8,
       "busy polls before a delivery proceeds anyway")
define("MINIO_TPU_NOTIFY_STORE_LIMIT", "int", 10000,
       "per-target delivery backlog cap (overflow drops + counts — "
       "bounded memory/disk against a dead target)")
define("MINIO_TPU_NOTIFY_OFFLINE_S", "float", 2.0,
       "offline window after a failed delivery: new events for that "
       "target queue without burning a send timeout each")
define("MINIO_TPU_NOTIFY_REDRIVE_S", "float", 5.0,
       "periodic backlog redrive cadence, seconds")
define("MINIO_TPU_NOTIFY_REPLICA_EVENTS", "bool", False,
       "`on` = replica-apply writes fire bucket notifications too "
       "(reference parity keeps them suppressed: replication does not "
       "re-fire source events)")

# -- the checking plane (minio_tpu/utils/knobs.py:590-600) ---------------------
define("MINIO_TPU_LOCKCHECK", "bool", False,
       "instrument named locks: record the cross-thread acquisition "
       "graph, fail on order cycles (on under the chaos/concurrency "
       "suites)")
define("MINIO_TPU_LOCKCHECK_RAISE", "bool", True,
       "raise LockOrderError at the acquire that closes a cycle "
       "(off = record only)")
define("MINIO_TPU_LOCKCHECK_BLOCK_MS", "float", 200.0,
       "acquire wait above this while holding another lock is flagged "
       "held-while-blocking")
define("MINIO_TPU_LOCKCHECK_HELD_MS", "float", 1000.0,
       "hold duration above this is flagged as a long hold")
