"""Background plane: the MRF heal queue, the disk monitor (replaced-drive
admission and sweep), the hinted heal scanner and the data-usage crawler.

Counterpart of minio_tpu/object/background.py. The reference runs these
from serverMain (cmd/server-main.go:487-493):
  * the MRF ("most recently failed") heal queue
    (cmd/background-heal-ops.go + maintainMRFList,
    cmd/erasure-sets.go:1641): writes that succeeded at quorum but lost
    some drives, and reads that had to reconstruct, enqueue the object
    for an immediate background heal;
  * monitorLocalDisksAndHeal (cmd/background-newdisks-heal-ops.go) +
    connectDisks (cmd/erasure-sets.go:200-281): dead drive slots are
    re-probed, returning drives re-admitted after a format check, fresh
    (wiped/replaced) drives formatted for their slot and then swept —
    every object they should hold is healed onto them (healErasureSet,
    cmd/global-heal.go); the heals run the fused heal step on the set's
    device like every other heal;
  * the bloom-hinted heal scanner over the data-update tracker
    (object/update_tracker.py);
  * the data crawler (cmd/data-crawler.go:61-157): walks every bucket and
    keeps per-bucket object counts and bytes, which quota reads, persisted
    to .minio.sys/datausage/usage.json; its per-object `actions` and
    per-bucket `bucket_actions` enforce lifecycle (features/lifecycle.py:
    expiry, noncurrent expiry, stale multipart aborts).

Both scanners take their namespace from the bucket metacache's feed
(object/metacache.py ``namespace_feed``) when the layer has one, and fall
back to paged listings (the merge walk) otherwise; every walk counts on
``walks_counter(consumer, source)``. The heal scanner also sweeps the
index's own segment objects each pass.

The disk monitor covers every pool: a pool that online expansion
appends after boot registers through ``add_pool`` and is probed and
sweep-healed like a boot-time one.

The MRF queue emits the reference's ``mrf.enqueue`` and ``mrf.drain``
journal records.

The disk monitor also runs the slow-drive quarantine (utils/healthtrack's
state machine: ok -> suspect -> probation -> heal-verified re-admission)
with its ``drive.suspect``, ``drive.probation``, ``drive.reconvict`` and
``drive.readmit`` journal records.

Left out: the reference's crash points. The MRF lock is a plain threading.Condition
(lockcheck is not ported).

Knobs: MINIO_TPU_MRF_QUEUE_SIZE, MINIO_TPU_MRF_MAX_RETRIES,
MINIO_TPU_MRF_BACKOFF_BASE, MINIO_TPU_MRF_BACKOFF_MAX (the retry schedule
spans ~40 s with the defaults), MINIO_TPU_DISK_PROBE_S (the disk
monitor's scan interval, which is also the slow-drive health cadence),
MINIO_TPU_QUARANTINE and MINIO_TPU_QUAR_* (utils/knobs.py).
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Callable, Optional

from ..storage import errors as serr
from ..storage.format import (MINIO_META_BUCKET, read_format_from,
                              write_format_to)
from ..storage.xl_storage import XLStorage
from ..utils import backoff_delay, crashpoint, eventlog, healthtrack, knobs
from . import api_errors

if TYPE_CHECKING:  # sets.py imports MRFHealer: no cycle at runtime
    from .sets import ErasureSets

DATA_USAGE_OBJECT = "datausage/usage.json"

MRF_QUEUE_SIZE = knobs.get_int("MINIO_TPU_MRF_QUEUE_SIZE")
MRF_MAX_RETRIES = knobs.get_int("MINIO_TPU_MRF_MAX_RETRIES")
MRF_BACKOFF_BASE = knobs.get_float("MINIO_TPU_MRF_BACKOFF_BASE")
MRF_BACKOFF_MAX = knobs.get_float("MINIO_TPU_MRF_BACKOFF_MAX")


def paged_list_objects(obj, bucket: str):
    """The scanners' merge-walk feed: every listable object in one
    bucket, paged through list_objects (1000/page)."""
    marker = ""
    while True:
        try:
            objs, _, trunc = obj.list_objects(bucket, "", marker, "",
                                              1000)
        except api_errors.ObjectApiError:
            return
        yield from objs
        if not trunc or not objs:
            return
        marker = objs[-1].name


class MRFHealer:
    """Bounded background heal queue with retry + exponential backoff.

    Fed by the engine's degraded-read AND degraded-write hooks: an
    object written (or read) with fewer than N healthy drives enqueues
    `(bucket, object, version)` and a daemon drains entries through
    `heal_fn` immediately — the reference's healMRFRoutine
    (cmd/background-heal-ops.go) rather than waiting for the scanner.

    * entries dedup on (bucket, object, version) while queued/in-flight;
    * a failed heal requeues with capped exponential backoff up to
      `max_retries`, then counts as `failed` (the scanner's sweep is the
      backstop);
    * the queue is bounded: overflow drops the entry (`dropped` stat) —
      losing an MRF hint is safe, losing memory under a fault storm is
      not.
    """

    def __init__(self, heal_fn: Callable[[str, str, str], object],
                 maxsize: Optional[int] = None,
                 max_retries: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 backoff_max: Optional[float] = None):
        self.heal_fn = heal_fn
        # None means "env default"; explicit zeros are honored
        # (max_retries=0 = heal once, backoff_base=0 = retry instantly)
        self.maxsize = MRF_QUEUE_SIZE if maxsize is None else maxsize
        self.max_retries = (MRF_MAX_RETRIES if max_retries is None
                            else max_retries)
        self.backoff_base = (MRF_BACKOFF_BASE if backoff_base is None
                             else backoff_base)
        self.backoff_max = (MRF_BACKOFF_MAX if backoff_max is None
                            else backoff_max)
        self._cond = threading.Condition()
        self._heap: list[tuple] = []   # (ready_at, seq, b, o, v, attempt)
        self._seq = 0
        # keys currently queued in the heap (dedup)
        self._pending: set[tuple[str, str, str]] = set()
        # keys whose heal is RUNNING -> re-arm flag: a hint arriving
        # mid-heal (object re-degraded) requeues a fresh entry when the
        # running heal finishes, instead of being silently dropped
        self._inflight: dict[tuple[str, str, str], bool] = {}
        self._closed = False
        # stats (admin `mrf` endpoint / metrics)
        self.queued = 0
        self.healed = 0
        self.requeued = 0
        self.failed = 0
        self.dropped = 0
        self.skipped = 0               # object vanished before heal
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- producer ----------------------------------------------------------

    def enqueue(self, bucket: str, object_name: str,
                version_id: str = "") -> bool:
        key = (bucket, object_name, version_id)
        with self._cond:
            if self._closed or key in self._pending:
                return False
            if key in self._inflight:
                # heal already running on possibly-stale state: re-arm
                # so it requeues once finished (the hint is preserved)
                self._inflight[key] = True
                return True
            pushed = self._push(key, 0)
            depth = len(self._heap)
        if pushed:
            eventlog.emit("mrf.enqueue", queued=depth)
        return pushed

    def _push(self, key: tuple, attempt: int,
              delay: float = 0.0) -> bool:
        """Queue (or requeue) an entry; caller holds the lock."""
        if len(self._heap) >= self.maxsize:
            self.dropped += 1
            return False
        self._pending.add(key)
        self._seq += 1
        heapq.heappush(self._heap, (time.monotonic() + delay, self._seq,
                                    key[0], key[1], key[2], attempt))
        if attempt == 0:
            self.queued += 1
        else:
            self.requeued += 1
        # notify_all: drain() waiters share this condition — waking only
        # the FIFO-head waiter could wake a drainer instead of the
        # consumer loop and leave the new entry sitting unprocessed
        self._cond.notify_all()
        return True

    # -- consumer ----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if not self._heap:
                        self._cond.wait()     # idle: block until notify
                    else:
                        self._cond.wait(max(
                            self._heap[0][0] - time.monotonic(), 0.001))
                if self._closed:
                    return
                _, _, bucket, obj, vid, attempt = heapq.heappop(self._heap)
                key = (bucket, obj, vid)
                self._pending.discard(key)
                self._inflight[key] = False
            done = True
            try:
                # dequeued, not yet healed: a crash loses only the retry
                # (the object itself is intact; fsck or the scanner
                # re-finds the degradation)
                crashpoint.hit("mrf.drain.before_heal")
                res = self.heal_fn(bucket, obj, vid)
                if getattr(res, "missing_after", 0):
                    # partial heal: copies are STILL missing (a target
                    # drive stayed offline) — retry, don't count healed
                    done = self._retry(key, attempt)
                else:
                    with self._cond:
                        self.healed += 1
            except (api_errors.ObjectNotFound, api_errors.BucketNotFound,
                    api_errors.VersionNotFound):
                with self._cond:
                    self.skipped += 1   # deleted since: converged
            except Exception:  # noqa: BLE001 — background heal best-effort
                done = self._retry(key, attempt)
            finally:
                with self._cond:
                    rearm = self._inflight.pop(key, False)
                    if done and rearm and not self._closed:
                        # the object re-degraded while this heal ran:
                        # fresh entry so the new damage is covered
                        self._push(key, 0)
                    self._cond.notify_all()
                if done:
                    eventlog.emit("mrf.drain", healed=self.healed,
                                  failed=self.failed)

    def _retry(self, key: tuple, attempt: int) -> bool:
        """Requeue with backoff; True when the entry is finished
        (retries exhausted)."""
        attempt += 1
        if attempt > self.max_retries:
            with self._cond:
                self.failed += 1
            return True
        backoff = backoff_delay(self.backoff_base, self.backoff_max,
                                attempt - 1)
        with self._cond:
            if self._closed:
                return True
            return not self._push(key, attempt, delay=backoff)

    def kick(self) -> int:
        """Make every queued entry ready NOW, collapsing pending retry
        backoffs — called when a drive is re-admitted so its objects
        heal immediately instead of waiting out the fixed retry window
        (DiskMonitor re-admission hook). Returns entries re-armed."""
        with self._cond:
            if not self._heap:
                return 0
            now = time.monotonic()
            self._heap = [(min(ready, now), seq, b, o, v, attempt)
                          for ready, seq, b, o, v, attempt in self._heap]
            heapq.heapify(self._heap)
            self._cond.notify_all()
            return len(self._heap)

    # -- observability / lifecycle ----------------------------------------

    def pending(self) -> int:
        with self._cond:
            return len(self._heap) + len(self._inflight)

    def stats(self) -> dict:
        with self._cond:
            return {"pending": len(self._heap) + len(self._inflight),
                    "queued": self.queued, "healed": self.healed,
                    "requeued": self.requeued, "failed": self.failed,
                    "dropped": self.dropped, "skipped": self.skipped}

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait for every queued entry to finish (healed, skipped, or
        retries exhausted). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._heap or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return not (self._heap or self._inflight)
                self._cond.wait(remaining)
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class _ScanLoop:
    """Shared lifecycle + failure bookkeeping of the background scan
    loops: run scan_once() every `interval` seconds on a daemon thread,
    counting failures instead of swallowing them silently — a wedged
    background plane must be observable (`errors`, `consecutive_errors`,
    `last_error`)."""

    interval: float

    def _init_loop(self) -> None:
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.errors = 0
        self.consecutive_errors = 0
        self.last_error = ""

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()

    def scan_once(self):  # pragma: no cover — subclasses implement
        raise NotImplementedError

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.scan_once()
                self.consecutive_errors = 0
            except Exception as e:  # noqa: BLE001 — keep scanning
                self.errors += 1
                self.consecutive_errors += 1
                self.last_error = repr(e)


class DiskMonitor(_ScanLoop):
    """Re-admit returning drives; format + sweep-heal fresh ones; walk
    slow (gray-failing) drives through quarantine — over every pool of a
    single node (``add_pool`` registers the pools that online expansion
    appends).

    Health states (the gray-failure plane): beyond online/offline, a
    drive whose tracked read/write latency stays past the quarantine
    threshold turns **suspect** — excluded from read plans and hedge
    targets (capacity-permitting) while still written-and-MRF'd. After
    ``MINIO_TPU_QUAR_PROBATION_S`` it enters **probation**: each scan
    runs a timed direct probe, and ``MINIO_TPU_QUAR_PROBES``
    consecutive healthy probes earn a heal-verified re-admission
    (sweep-heal the set, flip back to ok, kick MRF). A slow probe
    re-convicts straight back to suspect."""

    def __init__(self, sets: "ErasureSets",
                 interval: Optional[float] = None):
        self.pools: list["ErasureSets"] = [sets]
        self.interval = knobs.get_float("MINIO_TPU_DISK_PROBE_S") \
            if interval is None else interval
        self.healed_slots: list[tuple[int, int]] = []   # for tests/admin
        # quarantine bookkeeping for admin and tests, bounded: a drive
        # flapping every scan for the life of the process must not grow it
        self.quarantine_events: "deque[tuple[str, str]]" = deque(
            maxlen=1000)
        self._init_loop()

    @property
    def sets(self) -> "ErasureSets":
        """First (boot-time) pool."""
        return self.pools[0]

    def add_pool(self, sets: "ErasureSets") -> None:
        """Register a pool appended after boot (ClusterNode.add_pool)
        so its drive slots are probed from the next scan on."""
        if sets not in self.pools:
            self.pools.append(sets)

    # -- one scan ----------------------------------------------------------

    def scan_once(self) -> int:
        """Probe every slot of every pool; returns drives (re)admitted."""
        admitted = 0
        for pool in list(self.pools):
            admitted += self._scan_pool(pool)
            self._scan_pool_health(pool)
        return admitted

    def _scan_pool(self, pool: "ErasureSets") -> int:
        if pool.format_ref is None or pool.slot_sources is None:
            return 0
        admitted = 0
        for i, eng in enumerate(pool.sets):
            for j in range(len(eng.disks)):
                if self._probe_slot(pool, i, j):
                    admitted += 1
        if admitted and pool.mrf is not None:
            # a returning drive makes queued MRF heals winnable NOW:
            # collapse their retry backoffs instead of waiting them out
            pool.mrf.kick()
        return admitted

    def _probe_slot(self, pool: "ErasureSets", i: int, j: int) -> bool:
        from ..storage.diskid_check import DiskIDCheck
        eng = pool.sets[i]
        cur = eng.disks[j]
        want_uuid = pool.format_ref.sets[i][j]

        def unwrap(d):
            return getattr(d, "inner", d)

        def fmt_of(d):
            """format, or None (fresh), or 'err' (unreachable)."""
            try:
                return read_format_from(d)
            except (serr.UnformattedDisk, serr.FileNotFound,
                    serr.VolumeNotFound, serr.CorruptedFormat):
                return None
            except serr.StorageError:
                return "err"

        if cur is not None:
            fmt = fmt_of(unwrap(cur))
            if fmt not in (None, "err") and fmt.this == want_uuid \
                    and fmt.id == pool.deployment_id:
                return False         # healthy and in place
            if fmt == "err" and not isinstance(unwrap(cur), XLStorage):
                return False         # remote hiccup: transport re-probes

        # slot is dead, wiped, or replaced: (re)open from its source
        src = pool.slot_sources[i][j]
        if isinstance(src, str):
            try:
                drive = XLStorage(src)
            except serr.StorageError:
                return False
        else:
            drive = unwrap(src) if src is not None else unwrap(cur)
        if drive is None:
            return False

        fmt = fmt_of(drive)
        if fmt == "err":
            return False             # unreachable/IO error: try later

        if fmt is not None:
            if fmt.this != want_uuid or fmt.id != pool.deployment_id:
                return False         # foreign drive: never adopt
            if cur is not None and unwrap(cur) is drive:
                return False
            eng.disks[j] = DiskIDCheck(drive, want_uuid)
            return True

        # fresh/wiped drive: format it for this slot, admit, sweep-heal
        # (reference HealFormat + healErasureSet)
        nf = dataclasses.replace(pool.format_ref, this=want_uuid)
        try:
            write_format_to(drive, nf)
        except serr.StorageError:
            return False
        eng.disks[j] = DiskIDCheck(drive, want_uuid)
        self.healed_slots.append((i, j))
        try:
            self.heal_set_sweep(i, pool)
        except Exception:  # noqa: BLE001 — MRF/next sweep will retry
            pass
        return True

    # -- slow-drive quarantine (the gray-failure plane) --------------------

    def _scan_pool_health(self, pool: "ErasureSets") -> None:
        """One health-evaluation pass (reference :447-516): convict slow
        drives, advance suspects to probation, probe probationers,
        re-admit after enough healthy probes and a heal-verify sweep."""
        if not healthtrack.quarantine_enabled():
            return
        tr = healthtrack.TRACKER
        for si, eng in enumerate(pool.sets):
            for d in eng.disks:
                if d is None:
                    continue
                key = healthtrack.disk_key(d)
                state = tr.state_of("drive", key)
                if state == healthtrack.STATE_OK:
                    if tr.should_quarantine("drive", key):
                        tr.set_state("drive", key,
                                     healthtrack.STATE_SUSPECT,
                                     event="suspect")
                        self.quarantine_events.append((key, "suspect"))
                        eventlog.emit("drive.suspect", drive=key, set=si)
                    continue
                if state == healthtrack.STATE_SUSPECT and \
                        tr.state_age("drive", key) >= knobs.get_float(
                            "MINIO_TPU_QUAR_PROBATION_S"):
                    tr.set_state("drive", key,
                                 healthtrack.STATE_PROBATION,
                                 event="probation")
                    self.quarantine_events.append((key, "probation"))
                    eventlog.emit("drive.probation", drive=key, set=si)
                    state = healthtrack.STATE_PROBATION
                if state != healthtrack.STATE_PROBATION:
                    continue
                dur, ok = self._probe_drive(d)
                tr.observe("drive", key, "probe", dur)
                passed = ok and dur <= tr.quarantine_threshold("drive", key)
                probes_ok = tr.note_probe("drive", key, passed)
                if not passed:
                    # still slow: note_probe re-convicted it to suspect
                    self.quarantine_events.append((key, "reconvict"))
                    eventlog.emit("drive.reconvict", drive=key, set=si)
                    continue
                if probes_ok >= knobs.get_int("MINIO_TPU_QUAR_PROBES"):
                    # heal-verified re-admission: the drive took its writes
                    # while quarantined only as MRF hints, so the set is
                    # swept (heal step on the set's device) before read
                    # plans trust it again
                    try:
                        self.heal_set_sweep(si, pool)
                    except Exception:  # noqa: BLE001 — MRF backstop
                        pass
                    # drop the pre-recovery evidence: the drive took no
                    # reads while convicted, so its old slow samples would
                    # re-convict it on the next scan
                    tr.clear_samples("drive", key)
                    tr.set_state("drive", key, healthtrack.STATE_OK,
                                 event="readmit")
                    self.quarantine_events.append((key, "readmit"))
                    eventlog.emit("drive.readmit", drive=key, set=si)
                    if pool.mrf is not None:
                        pool.mrf.kick()

    @staticmethod
    def _probe_drive(d) -> tuple[float, bool]:
        """One timed direct probe against the drive (through the whole
        wrapper chain, so injected stalls are felt)."""
        t0 = time.perf_counter()
        try:
            d.disk_info()
            ok = True
        except serr.StorageError:
            ok = False
        return time.perf_counter() - t0, ok

    def heal_set_sweep(self, set_index: int,
                       pool: Optional["ErasureSets"] = None) -> int:
        """Heal every bucket + object of one set of `pool` (the first
        pool by default) (healErasureSet, cmd/global-heal.go). Returns
        objects healed."""
        eng = (pool or self.sets).sets[set_index]
        healed = 0
        for vol in eng.list_buckets():
            try:
                eng.heal_bucket(vol.name)
            except api_errors.ObjectApiError:
                continue
            for name in eng._merged_names(vol.name, ""):
                try:
                    eng.heal_object(vol.name, name)
                    healed += 1
                except api_errors.ObjectApiError:
                    continue
        return healed


class HealScanner(_ScanLoop):
    """Bloom-hinted background heal (the consumer that makes the
    data-update tracker load-bearing — reference data-update-tracker
    feeds the heal crawl the same way): each pass heals only objects
    the tracker says could have changed since the last COMPLETED pass,
    pruning unchanged buckets outright. False positives cost a redundant
    heal check; false negatives cannot happen (the tracker answers
    "changed" whenever its history can't prove otherwise).

    The namespace comes from the metacache feed when the layer has one,
    else from paged listings (the merge walk), which walks_counter(
    consumer="heal", source="merge") counts."""

    def __init__(self, object_layer, tracker, interval: float = 300.0,
                 peer_snapshots: Optional[Callable] = None):
        self.obj = object_layer
        self.tracker = tracker
        self.interval = interval
        # cluster fan-in: callable returning one rotated tracker snapshot
        # per peer (None for an unreachable one); a single node has none
        self.peer_snapshots = peer_snapshots
        self._peer_covered: dict[int, int] = {}
        self.last_cycle = 0          # 0 = never ran: full first pass
        self.healed = 0
        self.skipped_buckets = 0
        self.scanned = 0
        self._init_loop()

    def scan_once(self) -> int:
        """One hinted heal pass; returns objects heal-checked."""
        from .update_tracker import TrackerSnapshot
        # everything marked from here on belongs to the NEXT pass
        pass_cycle = self.tracker.advance_cycle() - 1
        # the last completed pass covered every cycle <= last_cycle, so
        # this pass needs mutations from the cycles AFTER it
        since = self.last_cycle + 1

        snaps: list[tuple[int, Optional[TrackerSnapshot]]] = []
        degraded = False
        if self.peer_snapshots is not None:
            for idx, raw in enumerate(self.peer_snapshots()):
                if raw:
                    snaps.append((idx, TrackerSnapshot(raw)))
                else:
                    # unreachable peer: its mutation window is unknown,
                    # so this pass cannot prune anything
                    degraded = True
                    snaps.append((idx, None))
        full = not self.last_cycle or degraded

        def changed(b: str, o: str = "") -> bool:
            if full:
                return True
            if self.tracker.changed_since(since, b, o):
                return True
            return any(
                s.changed_since(self._peer_covered.get(idx, 0) + 1,
                                b, o)
                for idx, s in snaps if s is not None)

        checked = 0
        mc = getattr(self.obj, "metacache", None)
        for vol in self.obj.list_buckets():
            b = vol.name
            if not changed(b):
                self.skipped_buckets += 1
                continue
            for oi in self._bucket_objects(mc, b):
                if not changed(b, oi.name):
                    continue
                self.scanned += 1
                checked += 1
                try:
                    res = self.obj.heal_object(b, oi.name)
                    if getattr(res, "disks_healed", 0):
                        self.healed += res.disks_healed
                except api_errors.ObjectApiError:
                    pass
        self._heal_metacache_segments(mc)
        self.last_cycle = pass_cycle
        # every reachable peer's rotated window was covered this pass
        for idx, s in snaps:
            if s is not None:
                self._peer_covered[idx] = s.cycle - 1
        return checked

    def _bucket_objects(self, mc, bucket: str):
        """One bucket's listable objects: the metacache namespace feed
        when available (no walk), else the paged merge-walk."""
        from .metacache import walks_counter
        feed = mc.namespace_feed(bucket, consumer="heal") \
            if mc is not None else None
        if feed is not None:
            yield from feed
            return
        walks_counter().inc(consumer="heal", source="merge")
        yield from paged_list_objects(self.obj, bucket)

    def _heal_metacache_segments(self, mc) -> int:
        """Sweep-heal the index's own manifest and segment objects: they
        are ordinary erasure-coded objects, but live under the hidden
        meta bucket the bucket walk never visits — without this a
        replaced drive would never regain its index shards."""
        if mc is None:
            return 0
        healed = 0
        for key in mc.segment_objects():
            try:
                self.obj.heal_object(MINIO_META_BUCKET, key)
                healed += 1
            except api_errors.ObjectApiError:
                continue
        return healed


class DataUsageCrawler(_ScanLoop):
    """Periodic bucket/object scan feeding usage accounting (quota reads
    bucket_usage), per-object `actions` (lifecycle expiry) and per-bucket
    `bucket_actions` (stale multipart aborts, noncurrent expiry). The
    namespace comes from the metacache feed when the layer has one, else
    from paged listings, which walks_counter(consumer="crawler",
    source="merge") counts."""

    def __init__(self, object_layer, interval: float = 60.0,
                 actions: Optional[list[Callable]] = None,
                 bucket_actions: Optional[list[Callable]] = None,
                 persist: bool = True):
        self.obj = object_layer
        self.interval = interval
        # each action: fn(bucket: str, info: ObjectInfo) -> None
        self.actions = list(actions or [])
        # each bucket action: fn(bucket: str) -> None, once per scan
        self.bucket_actions = list(bucket_actions or [])
        self.persist = persist
        self.usage: dict = {"buckets": {}, "objects_total": 0,
                            "size_total": 0, "last_update": 0.0}
        self._init_loop()

    def scan_once(self) -> dict:
        from .metacache import walks_counter
        mc = getattr(self.obj, "metacache", None)
        buckets: dict[str, dict] = {}
        for vol in self.obj.list_buckets():
            b = vol.name
            for baction in self.bucket_actions:
                try:
                    baction(b)
                except Exception:  # noqa: BLE001 — per-bucket
                    pass
            count = size = 0
            feed = mc.namespace_feed(b, consumer="crawler") \
                if mc is not None else None
            if feed is None:
                walks_counter().inc(consumer="crawler", source="merge")
                feed = paged_list_objects(self.obj, b)
            for oi in feed:
                count += 1
                size += oi.size
                for action in self.actions:
                    try:
                        action(b, oi)
                    except Exception:  # noqa: BLE001 — per-object
                        pass
            buckets[b] = {"objects": count, "size": size}
        self.usage = {
            "buckets": buckets,
            "objects_total": sum(v["objects"] for v in buckets.values()),
            "size_total": sum(v["size"] for v in buckets.values()),
            "last_update": time.time(),
        }
        if self.persist:
            try:
                self.obj.put_object(MINIO_META_BUCKET, DATA_USAGE_OBJECT,
                                    json.dumps(self.usage).encode())
            except api_errors.ObjectApiError:
                pass
        return self.usage

    def bucket_usage(self, bucket: str) -> Optional[int]:
        """Cached bytes for a bucket; None before the first scan."""
        if not self.usage["last_update"]:
            return None
        info = self.usage["buckets"].get(bucket)
        return int(info["size"]) if info else 0

    @classmethod
    def load_snapshot(cls, object_layer) -> Optional[dict]:
        try:
            _, stream = object_layer.get_object(MINIO_META_BUCKET,
                                                DATA_USAGE_OBJECT)
            return json.loads(b"".join(stream).decode())
        except (api_errors.ObjectApiError, ValueError):
            return None
