"""Registry of the ``MINIO_TPU_*`` tuning knobs the port reads.

Counterpart of minio_tpu/utils/knobs.py, trimmed to the knobs of the
pipelined data path, the batch former, heal, the MRF queue, the disk
monitor, the SSE cipher choice, the scan plane, the tier plane, the
bucket metacache, the hot-object read cache, the admission gate and the
HTTP edge, with the reference's names, types and defaults
(minio_tpu/utils/knobs.py:160-197, :203-206, :220-233, :261-281,
:284-291, :299-301, :310-331, :403-410, :434-435, :438-485). Left out:
the README table renderer and every knob no ported module reads. No knob here is one the reference lacks.

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
       "DiskMonitor scan interval: dead-slot re-probes run on this "
       "cadence")

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

# -- HTTP edge ---------------------------------------------------------------
define("MINIO_TPU_EDGE", "bool", True,
       "`off` selects the threaded frontend (escape hatch and "
       "correctness oracle; TLS listeners always use it)")
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
