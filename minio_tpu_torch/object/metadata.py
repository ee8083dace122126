"""Erasure metadata quorum algebra.

The distributed-correctness core of the object engine: reading xl.meta
from every drive, agreeing on the valid copy, and deciding whether enough
drives succeeded (reference: cmd/erasure-metadata.go,
cmd/erasure-metadata-utils.go).

Errors are classified by type (the reference compares sentinel error
values); None means success. Quorums: readQuorum = dataBlocks,
writeQuorum = dataBlocks (+1 when data == parity)
(objectQuorumFromMeta, cmd/erasure-metadata.go:320-340).
"""

from __future__ import annotations

import contextvars
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from ..storage import errors as serr
from ..storage.api import StorageAPI
from ..storage.datatypes import FileInfo
from ..utils import telemetry
from . import api_errors

# Per-drive errors ignored during object ops (reference objectOpIgnoredErrs:
# a gone disk shouldn't mask the real outcome).
OBJECT_OP_IGNORED_ERRS = (serr.DiskNotFound, serr.FaultyDisk,
                          serr.DiskAccessDenied)


def _err_key(err: Optional[Exception]):
    return None if err is None else type(err)


def reduce_errs(errs: Sequence[Optional[Exception]],
                ignored: tuple = ()) -> tuple[int, Optional[Exception]]:
    """(count, representative) of the most frequent error class, preferring
    success (None) on ties (reference reduceErrs,
    cmd/erasure-metadata-utils.go:34-57)."""
    counts: dict = {}
    rep: dict = {}
    for e in errs:
        if e is not None and ignored and isinstance(e, ignored):
            continue
        k = _err_key(e)
        counts[k] = counts.get(k, 0) + 1
        rep.setdefault(k, e)
    best_k, best_n = None, 0
    for k, n in counts.items():
        if n > best_n or (n == best_n and k is None):
            best_k, best_n = k, n
    return best_n, rep.get(best_k)


def reduce_read_quorum_errs(errs, ignored, read_quorum: int
                            ) -> Optional[Exception]:
    n, err = reduce_errs(errs, ignored)
    if n >= read_quorum:
        return err
    return api_errors.InsufficientReadQuorum(
        f"{n} agreeing drives < read quorum {read_quorum}")


def reduce_write_quorum_errs(errs, ignored, write_quorum: int
                             ) -> Optional[Exception]:
    n, err = reduce_errs(errs, ignored)
    if n >= write_quorum:
        return err
    return api_errors.InsufficientWriteQuorum(
        f"{n} agreeing drives < write quorum {write_quorum}")


# ---------------------------------------------------------------------------
# Parallel per-drive fan-out (the reference's errgroup-per-disk pattern)
# ---------------------------------------------------------------------------

_POOL = ThreadPoolExecutor(max_workers=64, thread_name_prefix="drive-io")


def for_each_disk(disks: Sequence[Optional[StorageAPI]],
                  fn: Callable[[int, StorageAPI], object]
                  ) -> tuple[list, list[Optional[Exception]]]:
    """Run fn(index, disk) on every non-None drive concurrently.

    Returns (results, errors) — per index; a None disk yields
    DiskNotFound (same shape as the reference's errgroup pattern)."""
    results: list = [None] * len(disks)
    errs: list[Optional[Exception]] = [None] * len(disks)

    def run(i: int):
        d = disks[i]
        if d is None:
            errs[i] = serr.DiskNotFound(f"drive {i}")
            return
        try:
            results[i] = fn(i, d)
        except Exception as e:  # noqa: BLE001 — per-drive fault isolation
            errs[i] = e

    if telemetry.current_span() is not None:
        # carry the caller's span into the pool workers so per-drive
        # I/O attaches to the request tree; one Context copy per task
        # (a Context must never run in two threads at once)
        futures = [_POOL.submit(contextvars.copy_context().run, run, i)
                   for i in range(len(disks))]
    else:
        futures = [_POOL.submit(run, i) for i in range(len(disks))]
    for f in futures:
        f.result()
    return results, errs


def submit_disk_task(fn, *args):
    """One task on the shared drive-io pool, carrying the caller's span
    context (the for_each_disk discipline)."""
    if telemetry.current_span() is not None:
        return _POOL.submit(contextvars.copy_context().run, fn, *args)
    return _POOL.submit(fn, *args)


def for_each_disk_quorum(disks: Sequence[Optional[StorageAPI]],
                         fn: Callable[[int, StorageAPI], object],
                         quorum: int, stall_s: Optional[float] = None,
                         stage: str = "write",
                         on_settle: Optional[Callable[[int], None]]
                         = None
                         ) -> tuple[list, list[Optional[Exception]]]:
    """for_each_disk with quorum-ack semantics: returns once every
    drive finished OR `quorum` successes are in and the laggards have
    outlived `stall_s` (measured from fan-out start). Stragglers keep
    running on the drive-io pool — the bounded background lane — and
    are reported as serr.StorageStalled so the caller's quorum reduce
    counts them as missed writes (the MRF degraded-write feed).

    `on_settle(i)` fires when an ABANDONED straggler finally completes
    (however it ends). Namespace-mutating laggards (a rename) need it:
    by the time the op lands, the commit lock is long released and a
    NEWER write may have committed — the callback lets the caller
    re-queue an MRF check so a late-landing stale op is healed back to
    quorum state instead of silently de-replicating the newer version.

    stall_s=None (quorum-ack off) degrades to exactly for_each_disk."""
    if stall_s is None:
        return for_each_disk(disks, fn)
    import time as _time
    from concurrent.futures import FIRST_COMPLETED
    from concurrent.futures import wait as _fwait
    from ..utils import healthtrack

    results: list = [None] * len(disks)
    errs: list[Optional[Exception]] = [None] * len(disks)
    settled = [False] * len(disks)
    futs: dict = {}
    traced = telemetry.current_span() is not None
    for i in range(len(disks)):
        if disks[i] is None:
            errs[i] = serr.DiskNotFound(f"drive {i}")
            settled[i] = True
            continue

        def run(i=i):
            return fn(i, disks[i])

        fut = _POOL.submit(contextvars.copy_context().run, run) \
            if traced else _POOL.submit(run)
        futs[fut] = i
    deadline = _time.monotonic() + stall_s
    while futs:
        ok = sum(1 for i in range(len(disks))
                 if settled[i] and errs[i] is None)
        remaining = deadline - _time.monotonic()
        if ok >= quorum and remaining <= 0:
            break
        # below quorum the wait is unbounded — quorum durability is
        # the correctness line; each task is itself bounded by its
        # drive/RPC deadline, so this cannot hang past the slowest
        # drive's own timeout
        done, _ = _fwait(set(futs), return_when=FIRST_COMPLETED,
                         timeout=remaining if ok >= quorum else None)
        for f in done:
            i = futs.pop(f)
            settled[i] = True
            try:
                results[i] = f.result(timeout=0)
            except Exception as e:  # noqa: BLE001 — per-drive isolation
                errs[i] = e
    for f, i in futs.items():
        # abandoned to the background lane: the future keeps the
        # task (and this slot's eventual completion) alive; nothing
        # joins it — that is the point
        errs[i] = serr.StorageStalled(
            f"drive {i}: {stage} abandoned after {stall_s:.3f}s "
            "(write quorum already durable)")
        healthtrack.note_laggard(stage)
        if on_settle is not None:
            f.add_done_callback(lambda _f, i=i: on_settle(i))
    return results, errs


def read_all_file_info(disks: Sequence[Optional[StorageAPI]], bucket: str,
                       object_path: str, version_id: str = ""
                       ) -> tuple[list[Optional[FileInfo]],
                                  list[Optional[Exception]]]:
    """Read xl.meta from every drive (reference readAllFileInfo,
    cmd/erasure-metadata-utils.go:118)."""
    results, errs = for_each_disk(
        disks, lambda i, d: d.read_version(bucket, object_path, version_id))
    return results, errs


# ---------------------------------------------------------------------------
# Agreement
# ---------------------------------------------------------------------------

def _fi_fingerprint(fi: FileInfo) -> tuple:
    """Equality class of one xl.meta copy, excluding per-drive fields
    (index/checksums) — reference findFileInfoInQuorum's meta hash."""
    return (round(fi.mod_time, 6), fi.size, fi.deleted, fi.version_id,
            fi.data_dir, fi.erasure.data_blocks, fi.erasure.parity_blocks,
            fi.erasure.block_size, tuple(fi.erasure.distribution),
            tuple((p.number, p.size) for p in fi.parts))


def find_file_info_in_quorum(metas: Sequence[Optional[FileInfo]],
                             quorum: int) -> FileInfo:
    """The FileInfo content attested by >= quorum drives
    (cmd/erasure-metadata.go findFileInfoInQuorum)."""
    counts: dict = {}
    for fi in metas:
        if fi is None:
            continue
        counts[_fi_fingerprint(fi)] = counts.get(_fi_fingerprint(fi), 0) + 1
    if not counts:
        raise api_errors.InsufficientReadQuorum("no readable xl.meta")
    best = max(counts.items(), key=lambda kv: kv[1])
    if best[1] < quorum:
        raise api_errors.InsufficientReadQuorum(
            f"best xl.meta agreement {best[1]} < quorum {quorum}")
    for fi in metas:
        if fi is not None and _fi_fingerprint(fi) == best[0]:
            return fi
    raise api_errors.InsufficientReadQuorum("unreachable")


def pick_valid_file_info(metas, quorum: int) -> FileInfo:
    return find_file_info_in_quorum(metas, quorum)


def get_latest_file_info(metas: Sequence[Optional[FileInfo]],
                         errs: Sequence[Optional[Exception]]
                         ) -> FileInfo:
    """Latest (max modTime) FileInfo present on >= half the drives
    (reference getLatestFileInfo)."""
    live = [fi for fi in metas if fi is not None]
    if not live:
        err = reduce_read_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS, 1)
        raise err if err else api_errors.InsufficientReadQuorum()
    mod_time = max(fi.mod_time for fi in live)
    count = sum(1 for fi in live if fi.mod_time == mod_time)
    if count < len(metas) // 2:
        raise api_errors.InsufficientReadQuorum(
            f"latest xl.meta on {count} < N/2 drives")
    for fi in live:
        if fi.mod_time == mod_time:
            return fi
    raise api_errors.InsufficientReadQuorum("unreachable")


def write_quorum_for(data_blocks: int, parity_blocks: int) -> int:
    """writeQuorum = data (+1 when data == parity)
    (cmd/erasure-metadata.go:333-336) — the single home of this rule."""
    return data_blocks + 1 if data_blocks == parity_blocks else data_blocks


def object_quorum_from_meta(metas, errs, default_parity: int
                            ) -> tuple[int, int]:
    """(readQuorum, writeQuorum) for an object from its stored geometry
    (reference objectQuorumFromMeta, cmd/erasure-metadata.go:320)."""
    latest = get_latest_file_info(metas, errs)
    data = latest.erasure.data_blocks
    parity = latest.erasure.parity_blocks or default_parity or data
    return data, write_quorum_for(data, parity)


def list_online_disks(disks: Sequence[Optional[StorageAPI]],
                      metas: Sequence[Optional[FileInfo]],
                      errs: Sequence[Optional[Exception]]
                      ) -> tuple[list[Optional[StorageAPI]], float]:
    """(onlineDisks, latest modTime): drives whose xl.meta carries the
    latest modTime stay; others become None (reference listOnlineDisks,
    cmd/erasure-healing-common.go)."""
    mod_time = 0.0
    for fi in metas:
        if fi is not None and fi.mod_time > mod_time:
            mod_time = fi.mod_time
    online: list[Optional[StorageAPI]] = [None] * len(disks)
    for i, fi in enumerate(metas):
        if fi is not None and fi.mod_time == mod_time:
            online[i] = disks[i]
    return online, mod_time


# ---------------------------------------------------------------------------
# Distribution shuffles
# ---------------------------------------------------------------------------

def shuffle_disks(disks: Sequence[Optional[StorageAPI]],
                  distribution: Sequence[int]
                  ) -> list[Optional[StorageAPI]]:
    """Order drives into shard-index order: shuffled[dist[i]-1] = disks[i]
    (reference shuffleDisks). Entry j then holds shard j."""
    if not distribution:
        return list(disks)
    out: list[Optional[StorageAPI]] = [None] * len(disks)
    for i, d in enumerate(disks):
        out[distribution[i] - 1] = d
    return out


def shuffle_parts_metadata(metas: Sequence[Optional[FileInfo]],
                           distribution: Sequence[int]
                           ) -> list[Optional[FileInfo]]:
    if not distribution:
        return list(metas)
    out: list[Optional[FileInfo]] = [None] * len(metas)
    for i, m in enumerate(metas):
        out[distribution[i] - 1] = m
    return out


def eval_disks(disks: Sequence[Optional[StorageAPI]],
               errs: Sequence[Optional[Exception]]
               ) -> list[Optional[StorageAPI]]:
    """Null out drives whose last op failed (reference evalDisks)."""
    return [d if e is None else None for d, e in zip(disks, errs)]


def write_unique_file_info(disks: Sequence[Optional[StorageAPI]],
                           bucket: str, prefix: str,
                           files: Sequence[FileInfo], quorum: int,
                           stall_s: Optional[float] = None
                           ) -> list[Optional[StorageAPI]]:
    """Write per-drive xl.meta (Erasure.Index = i+1) to all drives,
    enforcing write quorum (reference writeUniqueFileInfo,
    cmd/erasure-metadata.go:294). `stall_s` selects the quorum-ack
    lane: laggard metadata writers past it are abandoned (and counted
    lost by the caller) once quorum is durable."""
    def write(i: int, d: StorageAPI):
        files[i].erasure.index = i + 1
        d.write_metadata(bucket, prefix, files[i])

    _, errs = for_each_disk_quorum(disks, write, quorum,
                                   stall_s=stall_s, stage="meta")
    err = reduce_write_quorum_errs(errs, OBJECT_OP_IGNORED_ERRS, quorum)
    if err is not None:
        raise err
    return eval_disks(disks, errs)
