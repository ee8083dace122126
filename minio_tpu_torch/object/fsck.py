"""fsck — the boot-time / on-demand consistency auditor.

Counterpart of minio_tpu/object/fsck.py. A crash at any registered
crashpoint (utils/crashpoint.py) leaves one of a small set of on-disk
inconsistency classes behind: staged tmp garbage, a data dir no xl.meta
references, an object whose xl.meta landed on fewer drives than it
should, metacache segments without a manifest, a torn registry or
checkpoint JSON on one pool, a multipart session that was consumed by a
migration, a tier stub whose remote copy is gone. This module walks EVERY
pool and classifies what it finds:

  * ``repairable`` — fed straight to the existing repair machinery
    (per-object heal, orphan/tmp deletion, manifest drop -> walk
    rebuild, registry rewrite-from-best-copy) when ``repair=True``;
  * ``lost`` — data no machinery can recover (shards below the data
    quorum) — reported, never silently dropped.

Surfaces: ``run_fsck`` in the library and the boot under
``MINIO_TPU_FSCK_BOOT=on`` (cluster.py). Every finding and repair counts
in ``minio_tpu_fsck_findings_total{class}`` /
``minio_tpu_fsck_repaired_total{class}``.

The audit holds no long-lived locks: repairs go through the same locked
verbs (heal_object, delete_object) the foreground uses, so a
``missing_shards`` repair of an object at or above the codec's size gate
recovers its shards through ``heal_step`` on the card, and a smaller one
on the host, as every heal does.

Left out: the ``fsck.run`` span and the ``fsck.complete`` /
``fsck.unrepaired`` event-log records (the tracing and incident planes
are not ported), and the admin route, madmin client and CLI verb that
drive the audit over HTTP (they come with the admin router).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, List, Optional

from ..storage import errors as serr
from ..storage.datatypes import (TRANSITION_TIER_KEY,
                                 TRANSITIONED_OBJECT_KEY,
                                 is_restored, is_transitioned)
from ..storage.xl_storage import (MINIO_META_BUCKET,
                                  MINIO_META_MULTIPART_BUCKET,
                                  MINIO_META_TMP_BUCKET,
                                  XL_STORAGE_FORMAT_FILE, XLStorage)
from ..utils import atomicfile, knobs, regfence, telemetry
from . import api_errors
from .metacache import manifest_key, mc_prefix

__all__ = ["Finding", "FsckReport", "run_fsck", "CLASSES"]

# every class fsck can report; the metrics/table vocabulary
CLASSES = (
    "meta_missing",            # xl.meta absent on some drives (quorum ok)
    "meta_below_quorum",       # too few xl.meta copies to read (dangling)
    "missing_shards",          # data dir absent on some meta-bearing drives
    "lost_data",               # data dirs below the decode quorum
    "orphan_data",             # data dir no version on any drive references
    "stale_tmp",               # staged 2-phase-commit leftovers
    "stale_multipart",         # consumed/torn multipart session dirs
    "orphan_metacache_segment",  # index segment no manifest references
    "broken_metacache_manifest",  # torn manifest / dangling segment refs
    "dangling_stub",           # transitioned stub whose remote is gone
    "torn_registry",           # unparseable registry/checkpoint JSON copy
    "origin_divergence",       # replication origin markers disagree
    "registry_epoch_fork",     # same epoch, divergent lineage (split brain)
)

# registry / checkpoint document prefixes audited per pool (the docs
# deliberately written to every pool — topology epochs, tier config,
# replication targets, rebalance/resync checkpoints)
REGISTRY_PREFIXES = ("topology/", "tier/", "replicate/", "qos/",
                     "notify/")

_REPL_ORIGIN_KEY = "X-Minio-Internal-replication-origin"


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_fsck_findings_total",
                    "fsck consistency findings by class"),
        reg.counter("minio_tpu_fsck_repaired_total",
                    "fsck findings repaired by class"),
    )


@dataclasses.dataclass
class Finding:
    cls: str
    pool: int
    bucket: str = ""
    object: str = ""
    detail: str = ""
    repairable: bool = True
    repaired: bool = False
    repair_error: str = ""
    # bound repair action (set by the auditor, run by repair_all)
    _repair: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def to_dict(self) -> dict:
        return {"class": self.cls, "pool": self.pool,
                "bucket": self.bucket, "object": self.object,
                "detail": self.detail, "repairable": self.repairable,
                "repaired": self.repaired,
                "repair_error": self.repair_error}


class FsckReport:
    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.started = time.time()
        self.duration_s = 0.0
        self.pools = 0
        self.objects_scanned = 0
        self.supported = True
        self.repair_ran = False

    def add(self, f: Finding) -> Finding:
        self.findings.append(f)
        _metrics()[0].inc(1, **{"class": f.cls})
        return f

    @property
    def unrepaired(self) -> List[Finding]:
        """Repairable findings whose repair has not (successfully)
        run, plus every lost finding — what the crash harness asserts
        is EMPTY after a repair pass."""
        return [f for f in self.findings if not f.repaired]

    @property
    def clean(self) -> bool:
        return not self.findings

    def counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.cls] = out.get(f.cls, 0) + 1
        return out

    def repaired_counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            if f.repaired:
                out[f.cls] = out.get(f.cls, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "supported": self.supported,
            "clean": self.clean,
            "repair": self.repair_ran,
            "pools": self.pools,
            "objects_scanned": self.objects_scanned,
            "duration_s": round(self.duration_s, 3),
            "counts": self.counts(),
            "repaired": self.repaired_counts(),
            "unrepaired": len(self.unrepaired),
            "findings": [f.to_dict() for f in self.findings],
        }


def _server_sets(object_layer):
    """Unwrap to the ErasureServerSets (through the read-cache
    wrapper); None for FS/gateway backends — fsck audits erasure
    layouts only."""
    for layer in (object_layer, getattr(object_layer, "inner", None)):
        if layer is not None and hasattr(layer, "server_sets") \
                and hasattr(layer, "topology"):
            return layer
    return None


def run_fsck(object_layer, repair: bool = False, tiers=None,
             buckets: Optional[Iterable[str]] = None,
             tmp_age_s: Optional[float] = None) -> FsckReport:
    """Audit every pool; with ``repair=True`` run each finding's
    repair action immediately (counters prove the path ran)."""
    report = FsckReport()
    ss = _server_sets(object_layer)
    if ss is None:
        report.supported = False
        return report
    if tmp_age_s is None:
        tmp_age_s = knobs.get_float("MINIO_TPU_FSCK_TMP_AGE_S")
    report.pools = len(ss.server_sets)
    want = set(buckets) if buckets else None
    try:
        all_buckets = [v.name for v in ss.list_buckets()]
    except api_errors.ObjectApiError:
        all_buckets = []
    _audit_registry_forks(report, ss)
    for p, pool in enumerate(ss.server_sets):
        _audit_registry_docs(report, ss, p, pool)
        _audit_tmp(report, p, pool, tmp_age_s)
        _audit_multipart(report, p, pool)
        for bucket in all_buckets:
            if want is not None and bucket not in want:
                continue
            _audit_metacache(report, p, pool, bucket)
            for eng in pool.sets:
                _audit_namespace(report, p, eng, bucket, tiers,
                                 tmp_age_s)
    if repair:
        report.repair_ran = True
        for f in report.findings:
            _run_repair(f)
    report.duration_s = time.time() - report.started
    return report


def _run_repair(f: Finding) -> None:
    if not f.repairable or f._repair is None:
        return
    try:
        f._repair()
        f.repaired = True
        _metrics()[1].inc(1, **{"class": f.cls})
    except Exception as e:  # noqa: BLE001 — report, never abort the pass
        f.repair_error = repr(e)


# ---------------------------------------------------------------------------
# namespace walk: per-set object audit
# ---------------------------------------------------------------------------

def _live_disks(eng) -> list:
    return [d for d in eng.disks if d is not None and d.is_online()]


def _walk_object_paths(disks, bucket: str):
    """Union of object paths (dirs holding xl.meta) and bare data dirs
    across the set's drives, by recursive listing."""
    paths: set[str] = set()

    def walk(d, rel: str) -> None:
        try:
            entries = d.list_dir(bucket, rel)
        except serr.StorageError:
            return
        if XL_STORAGE_FORMAT_FILE in entries:
            paths.add(rel)
            return
        has_files = any(not e.endswith("/") for e in entries)
        subdirs = [e for e in entries if e.endswith("/")]
        if has_files and rel:
            # part files without xl.meta anywhere: an orphaned object
            # dir (meta deleted mid-crash) — surface it
            paths.add(rel)
            return
        for e in subdirs:
            sub = os.path.join(rel, e.rstrip("/")) if rel \
                else e.rstrip("/")
            walk(d, sub)

    for d in disks:
        walk(d, "")
    # a drive that lost its xl.meta walks INTO the object dir and
    # surfaces the data dir itself ("a/b/<uuid>") while a healthy
    # drive surfaces "a/b": keep only the ancestor — auditing the
    # descendant as its own object would misread committed data as an
    # orphan and reclaim it
    out: list[str] = []
    for rel in sorted(paths):
        if out and (rel + "/").startswith(out[-1] + "/"):
            continue
        out.append(rel)
    return out


def _audit_namespace(report: FsckReport, p: int, eng, bucket: str,
                     tiers, tmp_age: float) -> None:
    disks = _live_disks(eng)
    if not disks:
        return
    for path in _walk_object_paths(disks, bucket):
        report.objects_scanned += 1
        _audit_object(report, p, eng, disks, bucket, path, tiers,
                      tmp_age)


def _audit_object(report: FsckReport, p: int, eng, disks, bucket: str,
                  path: str, tiers, tmp_age: float) -> None:
    n = len(disks)
    per_disk_versions: list = []
    for d in disks:
        try:
            per_disk_versions.append(d.read_versions(bucket, path))
        except serr.StorageError:
            per_disk_versions.append(None)
    with_meta = sum(1 for v in per_disk_versions if v is not None)

    # union of versions (by version id) and referenced data dirs
    by_vid: dict = {}
    referenced: set[str] = set()
    for vers in per_disk_versions:
        for fi in vers or []:
            by_vid.setdefault(fi.version_id or "", []).append(fi)
            if fi.data_dir:
                referenced.add(fi.data_dir)

    if with_meta == 0:
        # a dir with files/data dirs but no readable xl.meta anywhere:
        # nothing references this data — reclaim it whole
        report.add(Finding(
            "orphan_data", p, bucket, path,
            detail="object dir with no readable xl.meta on any drive",
            _repair=_delete_on_all(disks, bucket, path)))
        return

    if with_meta < n:
        dangling = with_meta < n - eng.parity_shards
        report.add(Finding(
            "meta_below_quorum" if dangling else "meta_missing",
            p, bucket, path,
            detail=f"xl.meta on {with_meta}/{n} drives",
            _repair=_heal_versions(eng, bucket, path, by_vid)))

    # replication origin markers must agree per version across drives
    for vid, fis in by_vid.items():
        origins = {fi.metadata.get(_REPL_ORIGIN_KEY, "")
                   for fi in fis if fi.metadata}
        origins.discard("")
        if len(origins) > 1:
            report.add(Finding(
                "origin_divergence", p, bucket, path,
                detail=f"version {vid or 'null'}: origin markers "
                       f"{sorted(origins)}",
                _repair=_heal_versions(eng, bucket, path,
                                       {vid: fis})))

    # per-version data-dir presence
    dir_entries: list = []
    for d in disks:
        try:
            dir_entries.append(set(d.list_dir(bucket, path)))
        except serr.StorageError:
            dir_entries.append(set())
    for vid, fis in by_vid.items():
        fi = fis[0]
        if fi.deleted:
            continue
        if is_transitioned(fi.metadata or {}) \
                and not is_restored(fi.metadata or {}):
            # stubs hold no local shards (data_dir cleared): their
            # consistency question is whether the remote still exists
            _audit_stub(report, p, eng, bucket, path, fi, tiers)
            continue
        if not fi.data_dir:
            continue
        have = sum(1 for i, vers in enumerate(per_disk_versions)
                   if vers is not None
                   and fi.data_dir + "/" in dir_entries[i])
        if have >= with_meta:
            continue
        k = fi.erasure.data_blocks if fi.erasure else 1
        if have < k:
            report.add(Finding(
                "lost_data", p, bucket, path, repairable=False,
                detail=f"version {vid or 'null'}: data dir on "
                       f"{have}/{n} drives < decode quorum {k}"))
        else:
            report.add(Finding(
                "missing_shards", p, bucket, path,
                detail=f"version {vid or 'null'}: data dir on "
                       f"{have}/{n} drives",
                _repair=_heal_versions(eng, bucket, path, {vid: fis})))

    # orphan data dirs: present on a drive, referenced by no version
    # on ANY drive (the storage.rename_data.before_meta window); plus
    # write_atomic temp siblings (xl.meta.<hex>.tmp — a crash between
    # the temp write and the rename), age-gated like the tmp bucket
    for i, d in enumerate(disks):
        for e in dir_entries[i]:
            if e.endswith(".tmp"):
                if _older_than(d, bucket, f"{path}/{e}", tmp_age):
                    report.add(Finding(
                        "stale_tmp", p, bucket, f"{path}/{e}",
                        detail=f"atomic-commit temp sibling on {d}",
                        _repair=_delete_dir(d, bucket,
                                            f"{path}/{e}")))
                continue
            if not e.endswith("/"):
                continue
            dd = e.rstrip("/")
            if dd in referenced:
                continue
            report.add(Finding(
                "orphan_data", p, bucket, path,
                detail=f"data dir {dd} on {d} referenced by no "
                       "version",
                _repair=_delete_dir(d, bucket, f"{path}/{dd}")))


def _audit_stub(report: FsckReport, p: int, eng, bucket: str, path: str,
                fi, tiers) -> None:
    """Only a POSITIVE not-found from the tier backend classifies a
    stub as dangling: a transient head failure (tier restarting,
    network not up at boot) or an unmounted tier name is 'cannot
    check', never 'safe to drop' — the repair is an irreversible
    delete of the only reference to the remote data."""
    if tiers is None:
        return
    from ..tier.client import TierObjectNotFound
    tier = (fi.metadata or {}).get(TRANSITION_TIER_KEY, "")
    rkey = (fi.metadata or {}).get(TRANSITIONED_OBJECT_KEY, "")
    try:
        client = tiers.client(tier)
        client.head(rkey)
        return                              # remote intact
    except TierObjectNotFound:
        gone = f"remote object {rkey!r} missing on tier {tier!r}"
    except Exception:  # noqa: BLE001 — unreachable/unknown: skip the
        return         # stub this pass rather than risk dropping it
    vid = fi.version_id or ""

    def drop():
        eng.delete_object(bucket, path, version_id=vid)

    report.add(Finding(
        "dangling_stub", p, bucket, path,
        detail=f"{gone}; repair drops the stub version "
               f"{vid or 'null'} (data is unrecoverable)",
        _repair=drop))


def _heal_versions(eng, bucket: str, path: str, by_vid: dict):
    def heal():
        for vid in by_vid:
            eng.heal_object(bucket, path, version_id=vid or "")
    return heal


def _delete_dir(d, bucket: str, rel: str):
    def rm():
        try:
            d.delete_file(bucket, rel, recursive=True)
        except serr.FileNotFound:
            pass
    return rm


def _delete_on_all(disks, bucket: str, rel: str):
    def rm():
        for d in disks:
            try:
                d.delete_file(bucket, rel, recursive=True)
            except serr.StorageError:
                pass
    return rm


# ---------------------------------------------------------------------------
# tmp staging + multipart sessions (per pool)
# ---------------------------------------------------------------------------

def _audit_tmp(report: FsckReport, p: int, pool, tmp_age_s: float
               ) -> None:
    for eng in pool.sets:
        for d in _live_disks(eng):
            try:
                entries = d.list_dir(MINIO_META_TMP_BUCKET, "")
            except serr.StorageError:
                continue
            for e in entries:
                rel = e.rstrip("/")
                if not _older_than(d, MINIO_META_TMP_BUCKET, rel,
                                   tmp_age_s):
                    continue
                report.add(Finding(
                    "stale_tmp", p, MINIO_META_TMP_BUCKET, rel,
                    detail=f"staged write leftover on {d}",
                    _repair=_delete_dir(d, MINIO_META_TMP_BUCKET, rel)))


def _older_than(d, volume: str, rel: str, age_s: float) -> bool:
    """Age gate so an in-flight PUT's staging is never reaped: local
    drives stat the dir; remote drives only pass under an explicit
    age_s=0 (boot-time/harness mode — nothing can be in flight)."""
    if age_s <= 0:
        return True
    if not isinstance(d, XLStorage):
        return False
    try:
        st = os.stat(os.path.join(d.root, volume, rel))
    except OSError:
        return False
    return (time.time() - st.st_mtime) >= age_s


def _audit_multipart(report: FsckReport, p: int, pool) -> None:
    for eng in pool.sets:
        disks = _live_disks(eng)
        if not disks:
            continue
        sessions: dict[str, list] = {}
        for d in disks:
            try:
                shas = d.list_dir(MINIO_META_MULTIPART_BUCKET, "")
            except serr.StorageError:
                continue
            for sha in shas:
                try:
                    ids = d.list_dir(MINIO_META_MULTIPART_BUCKET,
                                     sha.rstrip("/"))
                except serr.StorageError:
                    continue
                for uid in ids:
                    path = f"{sha.rstrip('/')}/{uid.rstrip('/')}"
                    sessions.setdefault(path, [])
        for path in sorted(sessions):
            metas = []
            for d in disks:
                try:
                    metas.append(d.read_version(
                        MINIO_META_MULTIPART_BUCKET, path))
                except serr.StorageError:
                    pass
            if not metas:
                report.add(Finding(
                    "stale_multipart", p, MINIO_META_MULTIPART_BUCKET,
                    path,
                    detail="session dir with no readable session meta",
                    _repair=_delete_on_all(
                        disks, MINIO_META_MULTIPART_BUCKET, path)))
            elif any((fi.metadata or {}).get("x-minio-internal-migrated")
                     for fi in metas):
                report.add(Finding(
                    "stale_multipart", p, MINIO_META_MULTIPART_BUCKET,
                    path,
                    detail="consumed (migrated) session leftover",
                    _repair=_delete_on_all(
                        disks, MINIO_META_MULTIPART_BUCKET, path)))


# ---------------------------------------------------------------------------
# metacache segments/manifest (per pool, per bucket)
# ---------------------------------------------------------------------------

def _list_meta_keys(pool, prefix: str) -> list[str]:
    keys: list[str] = []
    marker = ""
    while True:
        objs, _prefixes, truncated = pool.list_objects(
            MINIO_META_BUCKET, prefix=prefix, marker=marker,
            max_keys=1000)
        for o in objs:
            keys.append(o.name)
        if not truncated or not objs:
            return keys
        marker = objs[-1].name


def _get_pool_bytes(pool, key: str) -> bytes:
    _info, stream = pool.get_object(MINIO_META_BUCKET, key)
    try:
        return b"".join(stream)
    finally:
        close = getattr(stream, "close", None)
        if close:
            close()


def _metacache_state(pool, bucket: str):
    """One consistent-ish snapshot: (broken_reason, gen, referenced,
    all_keys). Raises ObjectApiError upward only for the key listing."""
    prefix = mc_prefix(bucket)
    keys = set(_list_meta_keys(pool, prefix))
    mkey = manifest_key(bucket)
    referenced: set[str] = set()
    broken, gen = "", -1
    if mkey in keys:
        try:
            doc = atomicfile.load_json_doc(_get_pool_bytes(pool, mkey))
        except api_errors.ObjectApiError:
            doc = None
        if doc is None:
            broken = "manifest unreadable/torn"
        else:
            gen = int(doc.get("gen", -1) or -1)
            try:
                referenced = {s["key"] for s in doc.get("segments", [])}
            except (TypeError, KeyError):
                broken = "manifest segment list malformed"
            else:
                missing = referenced - keys
                if missing:
                    broken = (f"manifest references {len(missing)} "
                              "missing segment(s)")
    return broken, gen, referenced, keys


def _audit_metacache(report: FsckReport, p: int, pool, bucket: str
                     ) -> None:
    # a LIVE manager may be persisting a new generation while we read
    # (segments land before their manifest; old segments are reclaimed
    # after): require TWO consecutive agreeing snapshots before
    # reporting, so an in-flight persist never reads as damage
    try:
        prev = _metacache_state(pool, bucket)
        settled = not prev[0] and not (prev[3] - prev[2]
                                       - {manifest_key(bucket)})
        for _ in range(3):
            if settled:
                break
            time.sleep(0.15)
            cur = _metacache_state(pool, bucket)
            settled = cur == prev
            prev = cur
    except api_errors.ObjectApiError:
        return
    if not settled:
        # still changing after every retry: a live persist is mid-
        # flight — skip this bucket this pass; reporting (and under
        # repair, deleting) a moving target would damage healthy state
        return
    broken, _gen, referenced, keys = prev
    mkey = manifest_key(bucket)
    if broken:
        drop = sorted((keys | referenced) - {mkey}) + [mkey]

        def rm(drop=drop):
            # drop manifest + segments: the next manager start walk-
            # rebuilds (a missing manifest is the SUPPORTED cold path)
            for k in drop:
                try:
                    pool.delete_object(MINIO_META_BUCKET, k)
                except api_errors.ObjectApiError:
                    pass

        report.add(Finding(
            "broken_metacache_manifest", p, bucket, mkey,
            detail=broken + "; repair drops the persisted index "
                   "(walk rebuild)",
            _repair=rm))
        return
    for k in sorted(keys - referenced - {mkey}):
        def rm_one(k=k):
            try:
                pool.delete_object(MINIO_META_BUCKET, k)
            except api_errors.ObjectApiError:
                pass
        report.add(Finding(
            "orphan_metacache_segment", p, bucket, k,
            detail="segment object referenced by no manifest",
            _repair=rm_one))


# ---------------------------------------------------------------------------
# registry / checkpoint documents (per pool)
# ---------------------------------------------------------------------------

def _audit_registry_docs(report: FsckReport, ss, p: int, pool) -> None:
    for prefix in REGISTRY_PREFIXES:
        try:
            keys = _list_meta_keys(pool, prefix)
        except api_errors.ObjectApiError:
            continue
        for key in keys:
            try:
                raw = _get_pool_bytes(pool, key)
            except api_errors.ObjectApiError:
                continue
            if atomicfile.load_json_doc(raw) is not None:
                continue
            repair = _registry_repair(ss, pool, p, key)
            report.add(Finding(
                "torn_registry", p, MINIO_META_BUCKET, key,
                detail="unparseable registry/checkpoint JSON"
                       + ("; repair rewrites from the best pool copy"
                          if repair else "; no healthy copy — repair "
                          "deletes the torn doc (loaders fall back)"),
                _repair=repair or _registry_drop(pool, key)))


def _registry_repair(ss, pool, p: int, key: str):
    """A parseable copy from ANY other pool wins (the epoch loaders
    already pick highest-epoch across pools — convergence, not
    authority, is the goal here)."""
    for q, other in enumerate(ss.server_sets):
        if q == p:
            continue
        try:
            raw = _get_pool_bytes(other, key)
        except api_errors.ObjectApiError:
            continue
        if atomicfile.load_json_doc(raw) is None:
            continue

        def rewrite(raw=raw):
            pool.put_object(MINIO_META_BUCKET, key, raw)
        return rewrite
    return None


def _registry_drop(pool, key: str):
    def rm():
        try:
            pool.delete_object(MINIO_META_BUCKET, key)
        except api_errors.ObjectApiError:
            pass
    return rm


def _audit_registry_forks(report: FsckReport, ss) -> None:
    """Split-brain detection across POOL copies of each lineage-fenced
    registry doc: two copies claiming the same epoch with different
    lineage hashes can only come from divergent histories (both sides
    of a partition committed "the next epoch"). The epoch loaders pick
    a deterministic winner but never merge — this audit is where the
    fork becomes VISIBLE, and the repair is the explicit convergence:
    the highest (epoch, writer, lineage) doc wins everywhere, each
    losing copy is archived to ``<key>.fork-<lineage>`` in its pool
    (never deleted — an operator can diff what the losing side
    committed), then every pool is rewritten with the winner."""
    pools = ss.server_sets
    if len(pools) < 2:
        return
    keys: set[str] = set()
    for pool in pools:
        for prefix in REGISTRY_PREFIXES:
            try:
                keys.update(_list_meta_keys(pool, prefix))
            except api_errors.ObjectApiError:
                continue
    for key in sorted(keys):
        if ".fork-" in key:
            continue                # archived losers are not re-audited
        copies: list = []           # (pool_idx, doc, raw)
        for q, pool in enumerate(pools):
            try:
                raw = _get_pool_bytes(pool, key)
            except api_errors.ObjectApiError:
                continue
            doc = atomicfile.load_json_doc(raw)
            if doc is None:         # torn copies: the torn_registry class
                continue
            copies.append((q, doc, raw))
        docs = [doc for _q, doc, _raw in copies]
        forks = regfence.find_forks(docs)
        if not forks:
            continue
        winner = regfence.pick_best(docs)
        win_lineage = str(winner.get("lineage", ""))
        win_raw = next(raw for _q, doc, raw in copies if doc is winner)
        forked = {str(d.get("lineage", ""))
                  for pair in forks for d in pair}
        losers = []                 # (pool_idx, lineage, raw)
        seen: set = set()
        for q, doc, raw in copies:
            lin = str(doc.get("lineage", ""))
            if lin == win_lineage or lin not in forked \
                    or (q, lin) in seen:
                continue
            seen.add((q, lin))
            losers.append((q, lin, raw))
        if not losers:
            continue

        def converge(key=key, losers=losers, win_raw=win_raw):
            for q, lin, raw in losers:
                pools[q].put_object(MINIO_META_BUCKET,
                                    f"{key}.fork-{lin}", raw)
            for pool in pools:
                pool.put_object(MINIO_META_BUCKET, key, win_raw)

        report.add(Finding(
            "registry_epoch_fork", losers[0][0], MINIO_META_BUCKET, key,
            detail=f"epoch {int(winner.get('epoch', 0))} fork: winner "
                   f"lineage {win_lineage} (writer "
                   f"{winner.get('writer', '')!r}), "
                   f"{len(losers)} losing cop"
                   f"{'y' if len(losers) == 1 else 'ies'} on pool(s) "
                   f"{sorted({q for q, _l, _r in losers})}; repair "
                   "archives losers and converges every pool on the "
                   "winner",
            _repair=converge))
