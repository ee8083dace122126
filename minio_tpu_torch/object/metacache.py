"""Persisted bucket metacache: indexed listings + ONE namespace feed.

Counterpart of minio_tpu/object/metacache.py (the reference MinIO
lineage's cmd/metacache*.go pattern), ported whole:

  * a per-bucket, incrementally maintained index of every object's
    quorum-merged version list, held sorted in memory and PERSISTED as
    ordinary erasure-coded objects under
    ``.minio.sys/buckets/<bucket>/.metacache/`` (sorted key segments +
    a manifest, document for document the reference's, so either
    package loads an index the other persisted). A segment of 5,000 keys
    is ~1 MB, under the codec's 8 MiB device gate: the index is coded
    and hashed on the host, as in the reference;
  * fed by the engines' ``on_namespace_change`` deltas; the write path
    only appends to a bounded journal. A background drainer re-reads
    each touched name's merged versions and installs them;
  * listings are served from the index with BOUNDED staleness
    (``MINIO_TPU_METACACHE_STALENESS_S``); the merge-walk stays the
    fallback and the oracle, and the page shape comes from the very same
    ``engine.paginate_objects`` / ``paginate_versions`` loops;
  * a reconcile walker repairs drift (missed hooks, journal overflow,
    segment corruption) against the merge-walk;
  * the index is the scanners' one namespace feed
    (:meth:`MetacacheManager.namespace_feed`);
    ``minio_tpu_namespace_walks_total`` counts who still walks.

One departure, a fix of the reference's staleness bound. The reference's
drainer pops the claimed names from the journal under the lock and
refreshes them outside it; a listing arriving in between finds nothing
pending and cuts its page before the refresh is installed, so a write
acknowledged before the listing can be missing from it even with the
bound at 0; and nothing orders two refreshes of one name, so a slow
read can install over a newer one. Here (the guarded drain):

  * a claimed name stays visible as in flight (``_inflight``) until its
    refresh is installed. ``_ensure_fresh`` re-reads the journaled names
    and waits for the in-flight ones while installs keep landing; only
    what a claimant that installs nothing for ``_STALL_S`` holds is
    re-read on the request thread;
  * every read takes a ticket under the lock before it starts, and an
    index installs a name's read only when its ticket is newer than the
    one installed (or than the build's, for a name the build read). A
    read that started after a write was acknowledged therefore cannot
    be replaced by one that started before it.

A build and a reconcile are each the root of a trace of their own
(``metacache.build``, ``metacache.reconcile``); a served page runs in a
``metacache.serve`` span of the listing's request. The lock is the
watchdog's ``metacache.cond`` (utils/lockcheck.py), as in the reference.

Knobs (README "Listing and the bucket metacache"):

  MINIO_TPU_METACACHE=on|off            master switch (off = exactly the
                                        old merge-walk behavior)
  MINIO_TPU_METACACHE_FEED=on|off       scanners consume the index feed
  MINIO_TPU_METACACHE_STALENESS_S=2.0   serve-time staleness bound
  MINIO_TPU_METACACHE_FLUSH_S=0.2       journal drain cadence
  MINIO_TPU_METACACHE_PERSIST_S=30      min seconds between segment writes
  MINIO_TPU_METACACHE_SEGMENT_KEYS=5000 keys per persisted segment
  MINIO_TPU_METACACHE_JOURNAL=100000    max pending deltas (overflow
                                        invalidates the bucket until the
                                        next reconcile — never a silent
                                        wrong listing)
  MINIO_TPU_METACACHE_RECONCILE_S=300   drift-repair walk cadence
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import uuid as _uuid
from typing import Iterator, Optional

from ..storage.datatypes import ObjectInfo, ObjectPartInfo
from ..storage.xl_storage import MINIO_META_BUCKET
from ..utils import crashpoint, knobs, lockcheck, telemetry
from . import api_errors
from .engine import paginate_objects, paginate_versions

_FORMAT = 1
# seconds without an install after which a claimant is taken to be
# stalled and a listing re-reads the names it holds
_STALL_S = 1.0


def enabled() -> bool:
    return knobs.get_bool("MINIO_TPU_METACACHE")


def feed_enabled() -> bool:
    return enabled() and knobs.get_bool("MINIO_TPU_METACACHE_FEED")


def mc_prefix(bucket: str) -> str:
    return f"buckets/{bucket}/.metacache/"


def manifest_key(bucket: str) -> str:
    return mc_prefix(bucket) + "manifest.json"


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_metacache_serves_total",
                    "Listing pages served from the bucket index"),
        reg.counter("minio_tpu_metacache_fallbacks_total",
                    "Listing pages that fell back to the merge-walk"),
        reg.counter("minio_tpu_metacache_deltas_total",
                    "Namespace deltas journaled from the write paths"),
        reg.counter("minio_tpu_metacache_delta_drops_total",
                    "Deltas dropped on journal overflow (bucket is "
                    "invalidated until reconciled — never served stale "
                    "beyond the bound)"),
        reg.counter("minio_tpu_metacache_sync_drains_total",
                    "Serve-time synchronous drains forced by the "
                    "staleness bound"),
        reg.counter("minio_tpu_metacache_reconcile_repairs_total",
                    "Index entries repaired by the reconcile walker"),
        reg.gauge("minio_tpu_metacache_entries",
                  "Object names currently indexed across buckets"),
    )


def listing_histogram():
    return telemetry.REGISTRY.histogram(
        "minio_tpu_listing_page_seconds",
        "Listing page latency by verb and serving path "
        "(source=index|walk)")


def walks_counter():
    """Full-namespace walk counter — the A/B's proof that ONE
    reconcile/build walk replaced the per-subsystem walks. Labelled by
    consumer (crawler, heal, lifecycle, transition, rebalance,
    metacache) and source (merge = a real cross-drive walk, index = a
    feed read)."""
    return telemetry.REGISTRY.counter(
        "minio_tpu_namespace_walks_total",
        "Full-namespace walks by consumer and source")


# ---------------------------------------------------------------------------
# (de)serialization — one compact dict per version
# ---------------------------------------------------------------------------

def _oi_to_doc(o: ObjectInfo) -> dict:
    d = {"v": o.version_id, "t": o.mod_time, "s": o.size,
         "as": o.actual_size, "e": o.etag}
    if o.delete_marker:
        d["dm"] = 1
    if not o.is_latest:
        d["nl"] = 1
    if o.content_type:
        d["ct"] = o.content_type
    if o.content_encoding:
        d["ce"] = o.content_encoding
    if o.storage_class and o.storage_class != "STANDARD":
        d["sc"] = o.storage_class
    if o.user_defined:
        d["ud"] = o.user_defined
    if o.parts:
        d["p"] = [[p.number, p.size, p.actual_size, p.etag]
                  for p in o.parts]
    if o.data_blocks:
        d["db"] = o.data_blocks
    if o.parity_blocks:
        d["pb"] = o.parity_blocks
    return d


def _doc_to_oi(bucket: str, name: str, d: dict) -> ObjectInfo:
    return ObjectInfo(
        bucket=bucket, name=name, version_id=d.get("v", ""),
        mod_time=d.get("t", 0.0), size=d.get("s", 0),
        actual_size=d.get("as", 0), etag=d.get("e", ""),
        delete_marker=bool(d.get("dm")), is_latest=not d.get("nl"),
        content_type=d.get("ct", ""), content_encoding=d.get("ce", ""),
        storage_class=d.get("sc", "STANDARD"),
        user_defined=dict(d.get("ud") or {}),
        parts=[ObjectPartInfo(number=p[0], size=p[1], actual_size=p[2],
                              etag=p[3]) for p in d.get("p", [])],
        data_blocks=d.get("db", 0), parity_blocks=d.get("pb", 0))


class _BucketIndex:
    """In-memory sorted index of one bucket (guarded by the manager's
    lock): `names` sorted asc, `entries[name]` = quorum-merged versions
    newest-first (exactly `engine.object_versions` output), plus the
    persisted-segment map and the dirty set driving incremental segment
    rewrites."""

    __slots__ = ("bucket", "names", "entries", "state", "invalid",
                 "dirty", "segments", "gen", "last_persist", "base",
                 "tickets")

    READY = "ready"
    BUILDING = "building"

    def __init__(self, bucket: str):
        self.bucket = bucket
        self.names: list[str] = []
        self.entries: dict[str, list[ObjectInfo]] = {}
        self.state = self.BUILDING
        # invalid: journal overflowed (a delta was LOST) — listings
        # fall back until the next reconcile walk restores truth
        self.invalid = False
        self.dirty: set[str] = set()
        # persisted layout: [{"key","first","count"}] sorted by first;
        # segment i covers [first_i, first_{i+1}); None = never persisted
        self.segments: Optional[list[dict]] = None
        self.gen = 0
        self.last_persist = 0.0
        # read tickets: `base` was taken before the build's reads, and
        # `tickets[name]` is the ticket of the read installed for name
        self.base = 0
        self.tickets: dict[str, int] = {}

    def apply(self, name: str, versions: list[ObjectInfo],
              ticket: int) -> bool:
        """Install one name's refreshed version list (empty = gone),
        read under `ticket`. A read older than the one installed is
        dropped. Returns True when the index actually changed."""
        if ticket < self.tickets.get(name, self.base):
            return False
        self.tickets[name] = ticket
        have = self.entries.get(name)
        if versions:
            if have is None:
                bisect.insort(self.names, name)
            elif _same_versions(have, versions):
                return False
            self.entries[name] = versions
        else:
            if have is None:
                return False
            i = bisect.bisect_left(self.names, name)
            if i < len(self.names) and self.names[i] == name:
                del self.names[i]
            del self.entries[name]
        self.dirty.add(name)
        return True

    def replace(self, entries: dict[str, list[ObjectInfo]]) -> None:
        """Install a build's or a load's reads wholesale, keeping what a
        refresh newer than `base` installed meanwhile."""
        for n in self.tickets:
            if n in self.entries:
                entries[n] = self.entries[n]
            else:
                entries.pop(n, None)
        self.entries = entries
        self.names = sorted(entries)


def _same_versions(a: list[ObjectInfo], b: list[ObjectInfo]) -> bool:
    if len(a) != len(b):
        return False
    return all(x.version_id == y.version_id and x.mod_time == y.mod_time
               and x.etag == y.etag
               and x.delete_marker == y.delete_marker
               and x.user_defined == y.user_defined
               for x, y in zip(a, b))


class MetacacheManager:
    """Owns every bucket's index, the bounded delta journal, the
    drain/persist/reconcile daemon, and the serve/feed surface.

    Attach with ``server_sets.attach_metacache(mgr)`` — that points the
    engines' ``on_namespace_change`` hooks at :meth:`record` and makes
    the listing paths consult :meth:`serve_list_objects` /
    :meth:`serve_list_object_versions` (which return None whenever the
    caller must fall back to the merge-walk)."""

    def __init__(self, object_layer,
                 staleness_s: Optional[float] = None,
                 flush_s: Optional[float] = None,
                 persist_s: Optional[float] = None,
                 reconcile_s: Optional[float] = None,
                 segment_keys: Optional[int] = None,
                 journal_max: Optional[int] = None):
        self.obj = object_layer
        self._staleness = staleness_s
        self._flush_s = flush_s
        self._persist_s = persist_s
        self._reconcile_s = reconcile_s
        self._segment_keys = segment_keys
        self._journal_max = journal_max
        self._cond = lockcheck.condition("metacache.cond")
        # metric families resolved ONCE — record() runs per PUT/DELETE
        # and must not pay seven registry-lock lookups each call
        self._m = _metrics()
        self._indexes: dict[str, _BucketIndex] = {}
        # pending deltas: bucket -> {name: oldest-enqueue monotonic ts}
        self._pending: dict[str, dict[str, float]] = {}
        self._pending_count = 0
        # claimed, not yet installed: bucket -> {name: [oldest-enqueue
        # ts, claims]}; a name leaves only when its last claim installs
        self._inflight: dict[str, dict[str, list]] = {}
        # the last read ticket handed out, and claims released so far
        # (a listing waiting on in-flight names watches the latter)
        self._ticket = 0
        self._released = 0
        self._build_q: list[str] = []
        self._last_reconcile = time.monotonic()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # stats (tests/admin)
        self.serves = 0
        self.fallbacks = 0
        self.deltas = 0
        self.drops = 0
        self.sync_drains = 0
        self.builds = 0
        self.reconciles = 0
        self.repairs = 0
        self.persist_errors = 0

    # -- knobs (env read per call so tests can flip them) ------------------

    def staleness_s(self) -> float:
        return self._staleness if self._staleness is not None else \
            knobs.get_float("MINIO_TPU_METACACHE_STALENESS_S")

    def flush_s(self) -> float:
        return self._flush_s if self._flush_s is not None else \
            knobs.get_float("MINIO_TPU_METACACHE_FLUSH_S")

    def persist_s(self) -> float:
        return self._persist_s if self._persist_s is not None else \
            knobs.get_float("MINIO_TPU_METACACHE_PERSIST_S")

    def reconcile_s(self) -> float:
        return self._reconcile_s if self._reconcile_s is not None else \
            knobs.get_float("MINIO_TPU_METACACHE_RECONCILE_S")

    def segment_keys(self) -> int:
        return self._segment_keys if self._segment_keys is not None else \
            knobs.get_int("MINIO_TPU_METACACHE_SEGMENT_KEYS")

    def journal_max(self) -> int:
        return self._journal_max if self._journal_max is not None else \
            knobs.get_int("MINIO_TPU_METACACHE_JOURNAL")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MetacacheManager":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metacache")
        self._thread.start()
        return self

    def close(self, flush: bool = True) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        # join the flusher: an in-flight _persist keeps writing segment
        # objects (staging tmps and all) after the flag flips — callers
        # (shutdown, fsck-after-close tests) need the drives quiescent
        # once close() returns
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
        if flush:
            for b, idx in list(self._indexes.items()):
                if idx.state == _BucketIndex.READY and idx.dirty:
                    try:
                        self._persist(b)
                    except Exception:  # noqa: BLE001 — shutdown path
                        pass

    # -- hot-path producer -------------------------------------------------

    def record(self, bucket: str, name: str) -> None:
        """Journal one namespace delta. O(1), never blocks on I/O —
        this runs inside the PUT/DELETE hot path."""
        now = time.monotonic()
        with self._cond:
            if self._closed:
                return
            if self._pending_count >= self.journal_max():
                # a LOST delta means unbounded staleness: invalidate
                # the bucket (serves fall back) until reconcile repairs
                self.drops += 1
                idx = self._indexes.get(bucket)
                if idx is not None:
                    idx.invalid = True
                self._m[3].inc()
                return
            pend = self._pending.setdefault(bucket, {})
            if name not in pend:
                pend[name] = now
                self._pending_count += 1
            self.deltas += 1
            self._m[2].inc()
            self._cond.notify_all()

    # -- the daemon --------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                self._cond.wait(self.flush_s())
                if self._closed:
                    return
                build = self._build_q.pop(0) if self._build_q else None
            try:
                if build is not None:
                    self.build(build)
                self._drain_once()
                self._persist_due()
                if time.monotonic() - self._last_reconcile \
                        >= self.reconcile_s():
                    self._last_reconcile = time.monotonic()
                    for b in list(self._indexes):
                        self.reconcile(b)
            except Exception:  # noqa: BLE001 — the daemon must survive
                pass

    def _drain_once(self) -> int:
        """Apply every pending delta (background cadence). Each claimed
        name moves from the journal to ``_inflight`` in one step under
        the lock and leaves it only when its refresh is installed."""
        with self._cond:
            work: dict[str, list[str]] = {}
            for b in list(self._pending):
                idx = self._indexes.get(b)
                if idx is not None and idx.state != _BucketIndex.READY:
                    # a build is in flight: its walk may already have
                    # passed these names — keep them journaled so the
                    # post-build drain re-reads them
                    continue
                pend = self._pending.pop(b)
                if idx is None:
                    continue    # never built: a future build reads truth
                self._claim(b, pend)
                work[b] = list(pend)
            self._pending_count = sum(len(v)
                                      for v in self._pending.values())
        applied = 0
        if work:
            # claimed deltas die with the process here: acked writes
            # must still surface via rebuild/reconcile after restart
            crashpoint.hit("metacache.journal.drain")
        for bucket, names in work.items():
            for name in names:
                self._refresh(bucket, name, claimed=True)
                applied += 1
        return applied

    def _claim(self, bucket: str, names: dict[str, float]) -> None:
        """Mark ``names`` ({name: enqueue ts}) in flight, one claim each
        (caller holds the lock)."""
        fl = self._inflight.setdefault(bucket, {})
        for name, ts in names.items():
            ent = fl.get(name)
            if ent is None:
                fl[name] = [ts, 1]
            else:
                ent[0] = min(ent[0], ts)
                ent[1] += 1

    def _release(self, bucket: str, name: str) -> None:
        """Drop one claim (caller holds the lock)."""
        fl = self._inflight.get(bucket)
        ent = fl.get(name) if fl else None
        if ent is None:
            return
        ent[1] -= 1
        self._released += 1
        if ent[1] <= 0:
            del fl[name]
            if not fl:
                del self._inflight[bucket]

    def _take_ticket(self) -> int:
        """A read ticket (caller holds the lock)."""
        self._ticket += 1
        return self._ticket

    def _refresh(self, bucket: str, name: str,
                 claimed: bool = False) -> None:
        """Re-read one name's quorum-merged cross-pool versions and
        install them (the read runs OUTSIDE the lock, off the PUT hot
        path, under a ticket taken just before it). A claimed name leaves
        ``_inflight`` in the same critical section that installs it; a
        refresh that raises puts the delta back in the journal."""
        with self._cond:
            ticket = self._take_ticket()
        try:
            versions = self._read_versions(bucket, name)
        except BaseException:
            if claimed:
                with self._cond:
                    ts = (self._inflight.get(bucket, {}).get(name)
                          or [time.monotonic()])[0]
                    self._release(bucket, name)
                    if bucket in self._indexes:
                        pend = self._pending.setdefault(bucket, {})
                        if name not in pend:
                            pend[name] = ts
                            self._pending_count += 1
                    self._cond.notify_all()
            raise
        with self._cond:
            idx = self._indexes.get(bucket)
            if idx is not None:
                idx.apply(name, versions, ticket)
                self._m[6].set(sum(len(i.names)
                                   for i in self._indexes.values()))
            if claimed:
                self._release(bucket, name)
                self._cond.notify_all()

    def _read_versions(self, bucket: str, name: str) -> list[ObjectInfo]:
        """One name's cross-pool quorum-merged versions — the layer's
        own object_versions does the pool dedup + newest-first sort."""
        try:
            return self.obj.object_versions(bucket, name)
        except api_errors.ObjectApiError:
            return []

    # -- staleness ---------------------------------------------------------

    def _ensure_fresh(self, bucket: str) -> None:
        """Enforce the staleness bound at serve time: when any delta of
        the bucket, journaled or claimed by a drainer that has not
        installed it yet, is older than the bound, the journaled names
        are refreshed SYNCHRONOUSLY and the claimed ones are waited for
        before a page is cut from the index. A claimed name's read
        starts after its claim, so after the write it stands for."""
        bound = self.staleness_s()
        with self._cond:
            pend = self._pending.get(bucket) or {}
            fl = self._inflight.get(bucket) or {}
            if not pend and not fl:
                return
            oldest = min([*pend.values(), *(e[0] for e in fl.values())])
            if bound > 0 and time.monotonic() - oldest <= bound:
                return
            names = list(pend)
            claimed = [n for n in fl if n not in pend]
            self._claim(bucket, pend)
            self._pending.pop(bucket, None)
            self._pending_count -= len(pend)
            self.sync_drains += 1
            self._m[4].inc()
        for name in names:
            self._refresh(bucket, name, claimed=True)
        if claimed:
            self._await_claimed(bucket, claimed)

    def _await_claimed(self, bucket: str, names: list[str]) -> None:
        """Wait until none of ``names`` is in flight, for as long as
        claims keep being released; what is still claimed after
        ``_STALL_S`` with no release is re-read here (the tickets keep
        the stalled claimant's late install from replacing it)."""
        with self._cond:
            seen, last = self._released, time.monotonic()
            while True:
                fl = self._inflight.get(bucket) or {}
                names = [n for n in names if n in fl]
                if not names:
                    return
                now = time.monotonic()
                if self._released != seen:
                    seen, last = self._released, now
                elif now - last >= _STALL_S:
                    break
                self._cond.wait(_STALL_S - (now - last))
            self._claim(bucket, {n: fl[n][0] for n in names})
        for name in names:
            self._refresh(bucket, name, claimed=True)

    # -- build / load / persist / reconcile --------------------------------

    def _walk_names(self, bucket: str) -> set[str]:
        """One full merge-walk of the bucket's names across every pool
        and set — THE amortized walk."""
        walks_counter().inc(consumer="metacache", source="merge")
        names: set[str] = set()
        layers = getattr(self.obj, "server_sets", None) or [self.obj]
        for z in layers:
            for eng in getattr(z, "sets", [z]):
                try:
                    names.update(eng._merged_names(bucket, ""))
                except api_errors.ObjectApiError:
                    continue
        return names

    def build(self, bucket: str) -> bool:
        """Build (or rebuild) one bucket's index: try the persisted
        segments first, else a full merge-walk + per-name refresh.
        Returns True when the bucket is ready afterwards."""
        try:
            self.obj.get_bucket_info(bucket)
        except api_errors.BucketNotFound:
            self.drop_bucket(bucket, purge=True)
            return False
        except api_errors.ObjectApiError:
            # transient (quorum) failure: keep persisted artifacts
            self.drop_bucket(bucket)
            return False
        with self._cond:
            idx = self._indexes.get(bucket)
            if idx is not None and idx.state == _BucketIndex.READY \
                    and not idx.invalid:
                return True
            idx = _BucketIndex(bucket)
            # every read of the build (and a load's reconcile) starts
            # after this ticket; an older read in flight installs nothing
            idx.base = self._take_ticket()
            self._indexes[bucket] = idx
            drops0 = self.drops
        self.builds += 1
        with telemetry.trace("metacache.build", bucket=bucket):
            if self._load_persisted(bucket, idx):
                # the persisted snapshot may predate downtime mutations
                # (and, when the old index overflowed, the lost delta):
                # presence drift alone cannot prove version freshness —
                # an overwrite changes versions without changing the
                # name set — so stay invalid (serves fall back) until
                # the immediate reconcile has refreshed EVERY name
                with self._cond:
                    idx.state = _BucketIndex.READY
                    idx.invalid = True
                self.reconcile(bucket)
                return True
            names = sorted(self._walk_names(bucket))
            entries: dict[str, list[ObjectInfo]] = {}
            for n in names:
                vers = self._read_versions(bucket, n)
                if vers:
                    entries[n] = vers
            with self._cond:
                idx.replace(entries)
                idx.state = _BucketIndex.READY
                # an overflow DURING this walk lost a delta the walk
                # may already have passed — stay invalid for reconcile
                idx.invalid = self.drops != drops0
                idx.dirty = set(idx.names)
                self._m[6].set(sum(len(i.names)
                                   for i in self._indexes.values()))
            return True

    def _load_persisted(self, bucket: str, idx: _BucketIndex) -> bool:
        """Load manifest + segments written by a previous process. Any
        read/parse failure (drive loss beyond parity, bitrot the GET
        path could not reconstruct) abandons the load — the caller
        rebuilds from the walk, never serves a wrong listing."""
        try:
            doc = json.loads(self._get_bytes(manifest_key(bucket)))
            if doc.get("format") != _FORMAT or doc.get("bucket") != bucket:
                return False
            entries: dict[str, list[ObjectInfo]] = {}
            for seg in doc.get("segments", []):
                payload = json.loads(self._get_bytes(seg["key"]))
                for name, vdocs in payload:
                    entries[name] = [_doc_to_oi(bucket, name, d)
                                     for d in vdocs]
            with self._cond:
                idx.replace(entries)
                idx.segments = sorted(doc.get("segments", []),
                                      key=lambda s: s["first"])
                idx.gen = int(doc.get("gen", 0))
                idx.dirty = set()
        except (api_errors.ObjectApiError, ValueError, KeyError,
                TypeError, IndexError, AttributeError):
            # AttributeError covers a torn manifest whose truncated
            # prefix still parses as valid non-dict JSON
            return False
        return True

    def _get_bytes(self, key: str) -> bytes:
        _info, stream = self.obj.get_object(MINIO_META_BUCKET, key)
        try:
            return b"".join(stream)
        finally:
            close = getattr(stream, "close", None)
            if close:
                close()

    def _persist_due(self) -> None:
        now = time.monotonic()
        for bucket, idx in list(self._indexes.items()):
            if idx.state != _BucketIndex.READY or not idx.dirty:
                continue
            if now - idx.last_persist < self.persist_s():
                continue
            try:
                self._persist(bucket)
            except Exception:  # noqa: BLE001 — retried next interval
                self.persist_errors += 1

    def _persist(self, bucket: str) -> None:
        """Write dirty segments + a fresh manifest. Incremental: only
        segments whose key range contains a dirty name are rewritten;
        oversized segments split, emptied ones drop. The lock covers
        only the range math + entry-ref snapshot (version lists are
        replaced wholesale, never mutated in place) — serialization and
        the erasure-coded object writes run outside it so record()
        never stalls behind a persist."""
        seg_max = self.segment_keys()
        with self._cond:
            idx = self._indexes.get(bucket)
            if idx is None or idx.state != _BucketIndex.READY:
                return
            dirty = set(idx.dirty)
            idx.dirty.clear()
            names = idx.names
            old = idx.segments
            if old is None or not old:
                keep: list[dict] = []
                rewrite_ranges = [(0, len(names))]
                replaced_keys: list[str] = []
            else:
                firsts = [s["first"] for s in old]
                affected: set[int] = set()
                for dn in dirty:
                    j = bisect.bisect_right(firsts, dn) - 1
                    affected.add(max(j, 0))
                keep = [s for j, s in enumerate(old) if j not in affected]
                replaced_keys = [old[j]["key"] for j in sorted(affected)]
                rewrite_ranges = []
                for j in sorted(affected):
                    lo = 0 if j == 0 else bisect.bisect_left(
                        names, firsts[j])
                    hi = len(names) if j + 1 >= len(old) else \
                        bisect.bisect_left(names, firsts[j + 1])
                    rewrite_ranges.append((lo, hi))
            # copy only the name slices under the lock; the version
            # lists are resolved lock-free below (apply() replaces
            # them wholesale, and a name deleted mid-persist simply
            # drops out of the chunk — reconcile/journal converge it)
            name_chunks: list[list[str]] = []
            for lo, hi in rewrite_ranges:
                chunk_names = names[lo:hi]
                if not chunk_names and old:
                    continue            # emptied segment: drop it
                for c0 in range(0, max(len(chunk_names), 1), seg_max):
                    name_chunks.append(chunk_names[c0:c0 + seg_max])
                    if not chunk_names:
                        break
            entries = idx.entries
            gen = idx.gen + 1
            count = len(names)
        # (key, [(name, version-list ref)], first, count)
        chunks: list[tuple[str, list, str, int]] = []
        for chunk in name_chunks:
            pairs = [(n, vers) for n in chunk
                     for vers in [entries.get(n)] if vers]
            key = (mc_prefix(bucket)
                   + f"seg-{_uuid.uuid4().hex[:12]}.json")
            chunks.append((key, pairs,
                           chunk[0] if chunk else "", len(pairs)))
        if old is None:
            # this index never knew its persisted layout (walk rebuild
            # after a failed load): the stored manifest's segments are
            # about to become unreferenced — collect them for reclaim
            try:
                prior = json.loads(self._get_bytes(manifest_key(bucket)))
                replaced_keys = [s["key"]
                                 for s in prior.get("segments", [])]
            except Exception:  # noqa: BLE001 — no readable prior manifest
                pass
        written: list[str] = []
        try:
            for key, pairs, _first, _count in chunks:
                body = json.dumps(
                    [[n, [_oi_to_doc(o) for o in vers]]
                     for n, vers in pairs]).encode()
                self.obj.put_object(MINIO_META_BUCKET, key, body)
                written.append(key)
                # one hit per segment (arm :<nth>): segments without a
                # manifest are the orphan class fsck reclaims
                crashpoint.hit("metacache.persist.segment")
            segments = sorted(
                keep + [{"key": k, "first": f, "count": c}
                        for k, _p, f, c in chunks],
                key=lambda s: s["first"])
            # every segment landed, the manifest has not: restart
            # loads the PRIOR manifest (or walk-rebuilds) and this
            # attempt's segments are orphans
            crashpoint.hit("metacache.persist.before_manifest")
            manifest = json.dumps({
                "format": _FORMAT, "bucket": bucket, "gen": gen,
                "updated": time.time(), "count": count,
                "segments": segments}).encode()
            self.obj.put_object(MINIO_META_BUCKET, manifest_key(bucket),
                                manifest)
        except Exception:
            with self._cond:
                idx.dirty |= dirty      # retry next interval
            # the retry mints fresh uuid keys: reclaim this attempt's
            # segment objects or they leak unreferenced forever
            for key in written:
                try:
                    self.obj.delete_object(MINIO_META_BUCKET, key)
                except Exception:  # noqa: BLE001 — best-effort
                    pass
            raise
        with self._cond:
            idx.segments = segments
            idx.gen = gen
            idx.last_persist = time.monotonic()
        # old segment objects are garbage now (manifest no longer
        # references them) — reclaim best-effort
        for key in replaced_keys:
            try:
                self.obj.delete_object(MINIO_META_BUCKET, key)
            except Exception:  # noqa: BLE001 — orphans are harmless
                pass

    def reconcile(self, bucket: str) -> int:
        """Repair index drift against the merge-walk: names the walk
        has but the index misses (lost deltas) and names the index has
        but the walk lost (stale entries) are re-read and fixed. THE
        periodic amortized walk; also the recovery path after journal
        overflow or a failed segment load. Returns entries repaired."""
        with self._cond:
            idx = self._indexes.get(bucket)
            if idx is None or idx.state != _BucketIndex.READY:
                return 0
            have = set(idx.names)
            invalid = idx.invalid
            drops0 = self.drops
        self.reconciles += 1
        with telemetry.trace("metacache.reconcile", bucket=bucket):
            try:
                walked = self._walk_names(bucket)
            except Exception:  # noqa: BLE001 — try again next interval
                return 0
            if invalid:
                # a delta was LOST (journal overflow): name-set drift
                # alone cannot prove freshness — an overwrite changes
                # versions without changing presence. Refresh EVERY
                # name before trusting the index again.
                drift = sorted(walked | have)
            else:
                drift = sorted(walked.symmetric_difference(have))
            for name in drift:
                self._refresh(bucket, name)
            with self._cond:
                # an overflow DURING this walk lost a delta the walk may
                # have already passed — leave invalid for the next round
                if self.drops == drops0:
                    idx.invalid = False
            if drift:
                self.repairs += len(drift)
                self._m[5].inc(len(drift))
            return len(drift)

    def drop_bucket(self, bucket: str, purge: bool = False) -> None:
        """Forget a bucket's in-memory state; with ``purge`` also delete
        the persisted manifest + segments — a DELETEd bucket's index
        must not be reloadable by a later same-name incarnation."""
        with self._cond:
            self._indexes.pop(bucket, None)
            pend = self._pending.pop(bucket, None)
            if pend:
                self._pending_count -= len(pend)
            self._inflight.pop(bucket, None)
        if purge:
            self._purge_persisted(bucket)

    def _purge_persisted(self, bucket: str) -> None:
        keys: list[str] = []
        try:
            doc = json.loads(self._get_bytes(manifest_key(bucket)))
            keys = [s["key"] for s in doc.get("segments", [])]
        except Exception:  # noqa: BLE001 — no manifest, nothing to purge
            pass
        for key in keys + [manifest_key(bucket)]:
            try:
                self.obj.delete_object(MINIO_META_BUCKET, key)
            except Exception:  # noqa: BLE001 — best-effort reclaim
                pass

    # -- serving -----------------------------------------------------------

    def _ready_index(self, bucket: str,
                     build_sync: bool = False) -> Optional[_BucketIndex]:
        if not enabled():
            return None
        with self._cond:
            idx = self._indexes.get(bucket)
            ok = idx is not None and idx.state == _BucketIndex.READY \
                and not idx.invalid
            if not ok and not build_sync:
                if bucket not in self._build_q:
                    self._build_q.append(bucket)
                    self._cond.notify_all()
                return None
        if not ok:
            if not self.build(bucket):
                return None
            with self._cond:
                idx = self._indexes.get(bucket)
                if idx is None or idx.state != _BucketIndex.READY \
                        or idx.invalid:
                    return None
        self._ensure_fresh(bucket)
        return idx

    def _iter_names_chunked(self, idx: _BucketIndex, prefix: str,
                            marker: str, inclusive: bool = False,
                            chunk: int = 1024) -> Iterator[str]:
        """Scan the live index WITHOUT holding the manager lock across
        the whole page (record() — the PUT hot path — takes the same
        lock): grab a bounded chunk under the lock, yield it lock-free,
        re-anchor by bisect on the last yielded name. A concurrent
        insert/delete lands before or after the anchor exactly like a
        write racing a merge-walk page."""
        last, inc = marker, inclusive
        while True:
            with self._cond:
                batch = _slice_names(idx.names, prefix, last, inc, chunk)
            yield from batch
            if len(batch) < chunk:
                return
            last, inc = batch[-1], False

    def serve_list_objects(self, bucket: str, prefix: str, marker: str,
                           delimiter: str, max_keys: int):
        """One list_objects page from the index, or None (caller falls
        back to the merge-walk). Page shape comes from the SAME
        paginate_objects loop the engine runs."""
        idx = self._ready_index(bucket)
        if idx is None:
            self.fallbacks += 1
            self._m[1].inc()
            return None
        # existence parity with the merge path: a deleted bucket must
        # raise BucketNotFound, not serve a stale page
        self.obj.get_bucket_info(bucket)
        with telemetry.span("metacache.serve", bucket=bucket,
                            verb="list"):
            # lock-free entry reads: dict get is GIL-atomic and apply()
            # replaces version lists wholesale, never mutates in place
            entries = idx.entries

            def read_latest(name: str):
                vers = entries.get(name)
                if not vers or vers[0].delete_marker:
                    return None
                return vers[0]

            page = paginate_objects(
                self._iter_names_chunked(idx, prefix, marker),
                read_latest, prefix, marker, delimiter, max_keys)
        self.serves += 1
        self._m[0].inc()
        return page

    def serve_list_object_versions(self, bucket: str, prefix: str,
                                   marker: str, max_keys: int,
                                   version_marker: str = "",
                                   delimiter: str = ""):
        """One list_object_versions page (the engine's 5-tuple,
        CommonPrefixes included) from the index, or None to fall back.
        Page shape comes from the SAME paginate_versions loop the
        merge-walk runs."""
        idx = self._ready_index(bucket)
        if idx is None:
            self.fallbacks += 1
            self._m[1].inc()
            return None
        self.obj.get_bucket_info(bucket)
        with telemetry.span("metacache.serve", bucket=bucket,
                            verb="versions"):
            entries = idx.entries
            page = paginate_versions(
                self._iter_names_chunked(idx, prefix, marker,
                                         inclusive=bool(version_marker)),
                lambda n: entries.get(n) or [],
                prefix, marker, version_marker, delimiter, max_keys)
        self.serves += 1
        self._m[0].inc()
        return page

    # -- the namespace feed ------------------------------------------------

    def namespace_feed(self, bucket: str, versions: bool = False,
                       consumer: str = "feed") -> Optional[Iterator]:
        """THE shared scanner walk: an iterator over the bucket's
        indexed namespace — latest listable ObjectInfos, or
        ``(name, versions)`` pairs with ``versions=True``. Returns None
        when the feed is unavailable (disabled, or the bucket cannot be
        built) so consumers fall back to their own merge-walk.

        The first consumer to ask builds the index synchronously —
        that build IS the one amortized walk; every later consumer
        reads memory."""
        if not feed_enabled():
            return None
        idx = self._ready_index(bucket, build_sync=True)
        if idx is None:
            return None
        with self._cond:
            names = list(idx.names)
            entries = idx.entries
        walks_counter().inc(consumer=consumer, source="index")

        def it():
            for n in names:
                with self._cond:
                    vers = list(entries.get(n) or ())
                if not vers:
                    continue
                if versions:
                    yield n, vers
                else:
                    if vers[0].delete_marker:
                        continue
                    yield vers[0]
        return it()

    # -- heal surface ------------------------------------------------------

    def segment_objects(self) -> list[str]:
        """Meta-bucket keys of every live manifest + segment — the heal
        scanner sweeps these like ordinary objects so the index
        survives drive replacement."""
        out: list[str] = []
        with self._cond:
            for bucket, idx in self._indexes.items():
                if idx.segments is None:
                    continue
                out.append(manifest_key(bucket))
                out.extend(s["key"] for s in idx.segments)
        return out

    # -- tests / admin -----------------------------------------------------

    def drain(self, timeout: float = 10.0) -> bool:
        """Apply every pending delta NOW and wait for the ones a
        drainer has claimed to be installed (tests; also the bench's
        settle step). Returns False when new deltas kept arriving past
        the deadline."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._drain_once()
            with self._cond:
                if not self._pending_count and not self._inflight:
                    return True
                if not self._pending_count:
                    self._cond.wait(min(0.05, max(
                        0.0, deadline - time.monotonic())))
        return False

    def stats(self) -> dict:
        with self._cond:
            return {
                "buckets": {b: {"state": i.state, "invalid": i.invalid,
                                "names": len(i.names), "gen": i.gen,
                                "dirty": len(i.dirty)}
                            for b, i in self._indexes.items()},
                "pending": self._pending_count,
                "inflight": sum(len(v) for v in self._inflight.values()),
                "serves": self.serves, "fallbacks": self.fallbacks,
                "deltas": self.deltas, "drops": self.drops,
                "sync_drains": self.sync_drains, "builds": self.builds,
                "reconciles": self.reconciles, "repairs": self.repairs,
                "persist_errors": self.persist_errors,
            }


def _slice_names(names: list[str], prefix: str, marker: str,
                 inclusive: bool, k: int) -> list[str]:
    """Up to ``k`` sorted prefix-matching names starting after (or at,
    with ``inclusive``) the marker — the index-side analog of the
    engine's `_merged_names` contract, bounded so the caller never
    holds the manager lock across a whole-bucket scan."""
    start = 0
    if marker and marker >= prefix:
        start = bisect.bisect_left(names, marker) if inclusive \
            else bisect.bisect_right(names, marker)
    elif prefix:
        start = bisect.bisect_left(names, prefix)
    out: list[str] = []
    for i in range(start, len(names)):
        n = names[i]
        if prefix and not n.startswith(prefix):
            break               # sorted: past the prefix range
        out.append(n)
        if len(out) >= k:
            break
    return out
