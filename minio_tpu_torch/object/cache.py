"""Hot-object read cache: an ObjectLayer wrapper (cmd/disk-cache.go
cacheObjects).

Counterpart of minio_tpu/object/cache.py. GETs are served from a local
cache directory when the cached copy's ETag still matches the backend;
misses read through and populate:

  * **Block-framed entries** — cache files store ``[digest || block]``
    frames (HighwayHash-256 on the host, the cache-side bitrot framing of
    cmd/disk-cache-backend.go:573), so hits verify block by block as
    bytes stream out, and a corrupt block is detected where it sits.
  * **Range entries** — a ranged miss caches the block-aligned span it
    read; later ranged hits serve from any cached span that covers them.
    Whole-object entries cover [0, size).
  * **Streamed fills** — a fill tees the backend stream into the entry
    file while yielding to the client: constant memory, and a partial
    fill (client hangup, backend error) is discarded, never served.
  * **Watermark LRU** — usage above HIGH_WATERMARK purges
    least-recently-used entries down to LOW_WATERMARK; every hit
    refreshes the entry's clock.
  * **Admission by access frequency** — only objects read ``admit_hits``
    times inside ``admit_window_s`` are filled.
  * **Invalidation off the namespace feed** — the engines'
    ``on_namespace_change`` hook fans out to :meth:`on_namespace_change`
    (``server_sets.attach_read_cache``), so mutations that bypass the
    wrapper (lifecycle expiry, heal) still evict; the mutating verbs
    through the wrapper evict too, and the per-GET ETag check is the
    backstop.
  * **Tiering interplay** — a transition's stub rewrite reports on the
    namespace feed, which evicts the entry, and the serve path re-checks
    the backend metadata, so a cached copy never answers for a
    transitioned version without a restored copy: the GET reaches the
    layer's InvalidObjectState gate.

At the boot the wrapper sits in FRONT of ErasureServerSets as the S3
surface's layer: a hit serves a GET, or a Select's object read, from the
local entry without the erasure shard read, verify and decode. The
entries hold the object's stored bytes, so an encrypted object's hit is
still deciphered by the handler (the batch former's ``decipher`` verb).

One departure, a fix of the reference's hit fallback. When a frame fails
its check (or the file vanished) mid-stream, the reference resumes the
response from the backend at ``offset + sent`` without checking that the
backend still holds the same generation, and without the GET's options;
an overwrite that landed meanwhile gets spliced into the response under
the old ETag and length. Here the fallback reads with the GET's options
and aborts the stream (``ObjectApiError``) when the read's ETag is not
the one the response started with, as the fill paths already refuse a
changed generation. The locks are the watchdog's ``cache.tracker``,
``cache.meta`` and ``cache.purge`` (utils/lockcheck.py), as in the
reference.

Env (cluster boot; constructor args override):
  MINIO_TPU_CACHE=on|off            master switch (default off)
  MINIO_TPU_CACHE_DIR=<path>        entry directory (default
                                    <first-drive>/.minio.sys/cache)
  MINIO_TPU_CACHE_BUDGET_BYTES      watermark budget (default 1 GiB)
  MINIO_TPU_CACHE_ADMIT=2           GETs within the window to admit
  MINIO_TPU_CACHE_ADMIT_WINDOW_S    frequency window (default 300)
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import threading
import time
from typing import Iterator, Optional

from .. import bitrot as bitrot_mod
from ..storage.datatypes import is_restored, is_transitioned
from ..utils import knobs, lockcheck, telemetry
from . import api_errors
from .engine import GetOptions, PutOptions

DEFAULT_BUDGET = 1 << 30
HIGH_WATERMARK = 0.9
LOW_WATERMARK = 0.7
MAX_ENTRY_FRACTION = 0.1
CACHE_BLOCK = 1 << 20                 # frame payload size
_ALGO = bitrot_mod.BitrotAlgorithm.HIGHWAYHASH256
_DIG = 32                             # digest bytes per frame
_FILL_SEQ = itertools.count()         # unique in-flight fill suffixes
_TRACKER_MAX = 100_000                # bounded access-frequency table


def enabled() -> bool:
    return knobs.get_bool("MINIO_TPU_CACHE")


def _metrics():
    reg = telemetry.REGISTRY
    return (
        reg.counter("minio_tpu_cache_hits_total",
                    "GET/Select reads served from the hot-object "
                    "cache (no erasure decode)"),
        reg.counter("minio_tpu_cache_misses_total",
                    "Cache lookups that read through to the backend"),
        reg.counter("minio_tpu_cache_fills_total",
                    "Entries admitted and filled"),
        reg.counter("minio_tpu_cache_evictions_total",
                    "Entry evictions by cause (mutation, namespace "
                    "delta, watermark purge, bitrot, transition)"),
        reg.counter("minio_tpu_cache_bitrot_fallbacks_total",
                    "Corrupt cache frames detected; response continued "
                    "from the backend"),
        reg.counter("minio_tpu_cache_admit_rejects_total",
                    "Misses below the access-frequency admission bar"),
        reg.histogram("minio_tpu_cache_object_access",
                      "Access count within the admission window "
                      "observed at each GET (the admission signal)"),
    )


class AccessTracker:
    """Decaying per-object GET frequency — the admission signal. An
    object qualifies once it was read `admit_hits` times within
    `window_s`; the table is bounded (oldest half dropped on overflow)
    so hot-key tracking never grows with the namespace."""

    def __init__(self, admit_hits: int, window_s: float):
        self.admit_hits = max(1, admit_hits)
        self.window_s = window_s
        self._mu = lockcheck.mutex("cache.tracker")
        self._t: dict[tuple[str, str], tuple[int, float]] = {}

    def record(self, bucket: str, key: str) -> int:
        """Count one access; returns the in-window count."""
        now = time.monotonic()
        k = (bucket, key)
        with self._mu:
            count, first = self._t.get(k, (0, now))
            if now - first > self.window_s:
                count, first = 0, now          # window expired: restart
            count += 1
            self._t[k] = (count, first)
            if len(self._t) > _TRACKER_MAX:
                # overflow runs inside the GET hot path: single-pass
                # drops of expired then older-half windows — never a
                # full sort under the lock
                for cutoff in (now - self.window_s,
                               now - self.window_s / 2):
                    self._t = {k: v for k, v in self._t.items()
                               if v[1] >= cutoff}
                    if len(self._t) <= _TRACKER_MAX:
                        break
                else:
                    # uniform churn inside the half-window: drop
                    # arbitrary entries to keep the table bounded
                    it = iter(self._t)
                    for k in [next(it)
                              for _ in range(len(self._t) // 2)]:
                        del self._t[k]
        return count

    def admitted(self, count: int) -> bool:
        return count >= self.admit_hits


class CacheObjects:
    """ObjectLayer wrapper with a block-framed read cache on a local
    path."""

    def __init__(self, inner, cache_dir: str,
                 budget_bytes: int = DEFAULT_BUDGET,
                 block_size: int = CACHE_BLOCK,
                 admit_hits: int = 1,
                 admit_window_s: float = 300.0):
        self.inner = inner
        self.dir = os.path.abspath(cache_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.budget = budget_bytes
        self.block = block_size
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0
        self.admit_rejects = 0
        self.tracker = AccessTracker(admit_hits, admit_window_s)
        self._m = _metrics()
        self._mu = lockcheck.mutex("cache.meta")
        self._purge_mu = lockcheck.mutex("cache.purge")

    @classmethod
    def from_env(cls, inner, default_dir: str) -> "CacheObjects":
        """The cluster-boot constructor: every knob from the
        MINIO_TPU_CACHE_* environment."""
        return cls(
            inner,
            knobs.get_str("MINIO_TPU_CACHE_DIR") or default_dir,
            budget_bytes=knobs.get_int("MINIO_TPU_CACHE_BUDGET_BYTES"),
            admit_hits=knobs.get_int("MINIO_TPU_CACHE_ADMIT"),
            admit_window_s=knobs.get_float(
                "MINIO_TPU_CACHE_ADMIT_WINDOW_S"))

    # everything not overridden passes straight through
    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- entry layout ------------------------------------------------------

    def _entry_dir(self, bucket: str, key: str) -> str:
        # first level keyed by BUCKET so delete_bucket purges one
        # subtree instead of json-scanning every entry on the node
        bh = hashlib.sha256(bucket.encode()).hexdigest()[:16]
        h = hashlib.sha256(f"{bucket}/{key}".encode()).hexdigest()
        return os.path.join(self.dir, bh, h)

    def _load_entry(self, bucket: str, key: str) -> Optional[dict]:
        d = self._entry_dir(bucket, key)
        try:
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_meta(self, d: str, meta: dict) -> None:
        tmp = os.path.join(d, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(d, "meta.json"))

    def _touch(self, bucket: str, key: str) -> None:
        """Refresh the entry's LRU clock (meta mtime is the clock)."""
        try:
            os.utime(os.path.join(self._entry_dir(bucket, key),
                                  "meta.json"))
        except OSError:
            pass

    def _drop(self, bucket: str, key: str, cause: str = "mutation"
              ) -> None:
        d = self._entry_dir(bucket, key)
        if os.path.isdir(d):
            self.evictions += 1
            self._m[3].inc(cause=cause)
        shutil.rmtree(d, ignore_errors=True)

    def on_namespace_change(self, bucket: str, key: str) -> None:
        """The engines' namespace-delta feed (PUT/DELETE/metadata/
        tier transition/stub — whatever mutated, the entry is stale):
        evict. Mutations that bypass this wrapper (lifecycle
        transitions, rebalance moves, heals, replication) reach the
        cache only through this hook."""
        self._drop(bucket, key, cause="namespace")

    def _drop_range(self, bucket: str, key: str, fname: str) -> None:
        """Remove one corrupt cache file and its meta reference."""
        d = self._entry_dir(bucket, key)
        # the meta.json read-modify-write IS the shared state the lock
        # exists for: one small-file rewrite, bounded, no backend I/O
        with self._mu:  # meta.json read-modify-write (one small file)
            meta = self._load_entry(bucket, key)
            try:
                os.remove(os.path.join(d, fname))
            except OSError:
                pass
            if meta is not None:
                meta["ranges"] = [r for r in meta.get("ranges", [])
                                  if r["file"] != fname]
                try:
                    self._write_meta(d, meta)
                except OSError:
                    # entry dir purged under us (watermark/namespace
                    # eviction) — the drop already happened
                    pass

    # -- framed file I/O ---------------------------------------------------

    def _read_frames(self, path: str, file_start: int, offset: int,
                     length: int) -> Iterator[bytes]:
        """Yield verified payload for [offset, offset+length) out of a
        framed cache file whose payload begins at absolute object
        offset file_start. Raises bitrot mismatch BEFORE yielding the
        affected block."""
        rel = offset - file_start
        first = rel // self.block
        skip = rel - first * self.block
        remaining = length
        with open(path, "rb") as f:
            f.seek(first * (_DIG + self.block))
            while remaining > 0:
                digest = f.read(_DIG)
                block = f.read(self.block)
                if len(digest) < _DIG or not block:
                    raise api_errors.ObjectApiError(
                        "truncated cache frame")
                if bitrot_mod.hash_shard(block, _ALGO) != digest:
                    raise api_errors.ObjectApiError(
                        "cache bitrot mismatch")
                piece = block[skip:skip + remaining]
                skip = 0
                remaining -= len(piece)
                if piece:
                    yield piece

    # -- covering-span lookup ----------------------------------------------

    def _covering(self, meta: dict, start: int, end: int
                  ) -> Optional[dict]:
        """A cached range record covering [start, end), or None."""
        for r in meta.get("ranges", []):
            if r["start"] <= start and r["end"] >= end:
                return r
        return None

    # -- streamed fill -----------------------------------------------------

    def _fill_stream(self, bucket: str, key: str, info, stream,
                     file_start: int, span_len: int,
                     yield_from: int, yield_len: int
                     ) -> Iterator[bytes]:
        """Tee `stream` (payload of [file_start, file_start+span_len))
        into a framed cache file while yielding the requested
        [yield_from, yield_from+yield_len) sub-span. Constant memory;
        a partial fill is discarded in `finally`."""
        d = self._entry_dir(bucket, key)
        os.makedirs(d, exist_ok=True)
        fname = "data" if (file_start == 0
                           and span_len == info.size) else \
            f"r{file_start}"
        # unique per fill: concurrent threads filling the same range
        # must never share a tmp inode
        tmp = os.path.join(
            d, f"{fname}.tmp{os.getpid()}.{next(_FILL_SEQ)}")
        done = 0
        want_skip = yield_from - file_start
        want_left = yield_len
        completed = False
        try:
            with open(tmp, "wb") as out:
                buf = bytearray()
                for chunk in stream:
                    buf += chunk
                    while len(buf) >= self.block:
                        block = bytes(buf[:self.block])
                        del buf[:self.block]
                        out.write(bitrot_mod.hash_shard(block, _ALGO))
                        out.write(block)
                        done += len(block)
                        piece = block[max(want_skip, 0):]
                        want_skip -= len(block)
                        if piece and want_left > 0:
                            piece = piece[:want_left]
                            want_left -= len(piece)
                            yield piece
                if buf:
                    block = bytes(buf)
                    out.write(bitrot_mod.hash_shard(block, _ALGO))
                    out.write(block)
                    done += len(block)
                    piece = block[max(want_skip, 0):]
                    if piece and want_left > 0:
                        yield piece[:want_left]
            completed = done == span_len
        finally:
            if not completed:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            else:
                self.fills += 1
                self._m[2].inc()
                self._commit(bucket, key, info, fname, tmp,
                             file_start, file_start + span_len)

    def _commit(self, bucket: str, key: str, info, fname: str,
                tmp: str, start: int, end: int) -> None:
        """Publish a completed fill. The entry dir (or the tmp file)
        may have been rmtree'd by a concurrent purge/invalidation —
        losing the cache entry is fine; failing a client whose bytes
        all arrived is not."""
        d = self._entry_dir(bucket, key)
        try:
            self._commit_locked(bucket, key, info, fname, tmp, d,
                                start, end)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return
        self._purge_if_needed()

    def _commit_locked(self, bucket, key, info, fname, tmp, d,
                       start, end) -> None:
        with self._mu:  # meta.json RMW (one small file); caller catches OSError

            meta = self._load_entry(bucket, key)
            if meta is None or meta.get("etag") != info.etag:
                # fresh entry (or a stale generation): ranges reset
                meta = {"bucket": bucket, "key": key,
                        "etag": info.etag, "size": info.size,
                        "content_type": info.content_type,
                        "user_defined": dict(info.user_defined or {}),
                        "mod_time": info.mod_time, "ranges": []}
                for r in list(os.listdir(d)):
                    if r != "meta.json" and ".tmp" not in r:
                        try:
                            os.remove(os.path.join(d, r))
                        except OSError:
                            pass
            os.replace(tmp, os.path.join(d, fname))
            ranges = [r for r in meta.get("ranges", [])
                      if r["file"] != fname]
            ranges.append({"start": start, "end": end, "file": fname})
            meta["ranges"] = sorted(ranges, key=lambda r: r["start"])
            self._write_meta(d, meta)

    # -- LRU purge ---------------------------------------------------------

    def _usage(self) -> int:
        total = 0
        for root, _, files in os.walk(self.dir):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
        return total

    def _purge_if_needed(self) -> None:
        """Watermark purge on its OWN serialization lock: the usage
        walk + rmtrees cover the whole cache tree and must not park
        fill commits (`_mu`, the meta.json critical section) behind a
        directory scan. A purge racing a commit is safe — `_commit`
        tolerates its entry dir vanishing — and a second caller
        arriving mid-purge simply skips (that purge is already doing
        the work)."""
        # non-blocking try-acquire: a second purger skips, not queues
        if not self._purge_mu.acquire(False):
            return
        try:
            usage = self._usage()
            if usage < self.budget * HIGH_WATERMARK:
                return
            entries = []               # (last_access, dir, bytes)
            for sub in os.listdir(self.dir):
                subdir = os.path.join(self.dir, sub)
                if not os.path.isdir(subdir):
                    continue
                for h in os.listdir(subdir):
                    d = os.path.join(subdir, h)
                    try:
                        atime = os.path.getmtime(
                            os.path.join(d, "meta.json"))
                    except OSError:
                        shutil.rmtree(d, ignore_errors=True)
                        continue
                    size = 0
                    for f in os.listdir(d):
                        try:
                            size += os.path.getsize(os.path.join(d, f))
                        except OSError:
                            pass
                    entries.append((atime, d, size))
            entries.sort()              # least recently used first
            target = self.budget * LOW_WATERMARK
            for _, d, size in entries:
                if usage <= target:
                    break
                shutil.rmtree(d, ignore_errors=True)
                self.evictions += 1
                self._m[3].inc(cause="watermark")
                usage -= size
        finally:
            self._purge_mu.release()

    # -- ObjectLayer overrides ---------------------------------------------

    def get_object(self, bucket: str, key: str, offset: int = 0,
                   length: int = -1,
                   opts: Optional[GetOptions] = None):
        if bucket.startswith("."):
            # .minio.sys carries config/index objects mutated by inner
            # layers the wrapper never sees — never cache them
            return self.inner.get_object(bucket, key, offset, length,
                                         opts)
        if opts is not None and getattr(opts, "version_id", ""):
            return self.inner.get_object(bucket, key, offset, length,
                                         opts)
        count = self.tracker.record(bucket, key)
        self._m[6].observe(count)
        meta = self._load_entry(bucket, key)
        if meta is None and not self.tracker.admitted(count):
            # common first-touch path: no entry and below the
            # admission bar — pass straight through WITHOUT the extra
            # quorum stat (the inner GET stats and gates itself)
            self.misses += 1
            self._m[1].inc()
            self.admit_rejects += 1
            self._m[5].inc()
            return self.inner.get_object(bucket, key, offset, length,
                                         opts)
        info = self.inner.get_object_info(bucket, key, opts)
        md = info.user_defined or {}
        if is_transitioned(md) and not is_restored(md):
            # the data lives in a remote tier with no restored copy: a
            # cached generation must NOT answer — the backend GET is
            # the single home of the InvalidObjectState gate
            self._drop(bucket, key, cause="transition")
            return self.inner.get_object(bucket, key, offset, length,
                                         opts)
        want_len = info.size - offset if length < 0 else length
        want_len = max(0, min(want_len, info.size - offset))
        end = offset + want_len

        if meta is not None and meta.get("etag") != info.etag:
            self._drop(bucket, key)     # stale generation
            meta = None
        if meta is not None:
            r = self._covering(meta, offset, end)
            if r is not None:
                d = self._entry_dir(bucket, key)
                path = os.path.join(d, r["file"])
                stream = self._serve_hit(bucket, key, info, path,
                                         r["file"], r["start"], offset,
                                         want_len, opts)
                self.hits += 1
                self._m[0].inc()
                self._touch(bucket, key)
                return info, stream
        self.misses += 1
        self._m[1].inc()
        if not self.tracker.admitted(count):
            # below the access-frequency bar: read through without
            # filling — one-shot scans must not churn the LRU
            self.admit_rejects += 1
            self._m[5].inc()
            return self.inner.get_object(bucket, key, offset, length,
                                         opts)
        return self._fill_or_passthrough(bucket, key, info, opts,
                                         offset, want_len)

    def _serve_hit(self, bucket, key, info, path, fname, file_start,
                   offset, length, opts=None) -> Iterator[bytes]:
        """Stream verified frames; on a corrupt/truncated frame, drop
        the bad cache file and continue the REST of the response from
        the backend (bytes already sent were verified) — only when the
        backend read still holds the generation the response started
        with; otherwise the stream aborts rather than splice two
        versions under one ETag."""
        sent = 0
        try:
            for piece in self._read_frames(path, file_start, offset,
                                           length):
                yield piece
                sent += len(piece)
        except (api_errors.ObjectApiError, OSError) as e:
            # ObjectApiError = a frame failed its bitrot check — real
            # corruption; OSError = purged under us (already counted
            # by its watermark/namespace eviction) OR a persistent
            # I/O error. Only corruption counts as bitrot, but the
            # range drops either way.
            if isinstance(e, api_errors.ObjectApiError):
                self._m[4].inc()
                self._m[3].inc(cause="bitrot")
                self.evictions += 1
            self._drop_range(bucket, key, fname)
            if sent < length:
                info2, rest = self.inner.get_object(
                    bucket, key, offset + sent, length - sent, opts)
                if info2.etag != info.etag:
                    close = getattr(rest, "close", None)
                    if close is not None:
                        close()
                    raise api_errors.ObjectApiError(
                        f"{bucket}/{key} changed mid-stream (etag "
                        f"{info.etag} -> {info2.etag}): response "
                        "aborted") from e
                yield from rest

    def _fill_or_passthrough(self, bucket, key, info, opts,
                             offset: int, length: int):
        """(info, stream) for a miss. The info returned is the one the
        actual backend READ produced — a concurrent overwrite between
        the stat and the read must not label new bytes with old
        etag/size. A changed generation skips the fill (the span
        arithmetic came from the stale stat; _fill_stream's
        completion check would refuse the commit anyway)."""
        max_entry = self.budget * MAX_ENTRY_FRACTION
        if length <= 0:
            return self.inner.get_object(bucket, key, offset, length,
                                         opts)
        # whole-object fill
        if offset == 0 and length == info.size and \
                info.size <= max_entry:
            info2, stream = self.inner.get_object(bucket, key, 0,
                                                  info.size, opts)
            if info2.etag != info.etag:
                return info2, stream
            self._ensure_meta(bucket, key, info2)
            return info2, self._fill_stream(bucket, key, info2, stream,
                                            0, info2.size, 0,
                                            info2.size)
        # ranged fill: cache the block-aligned covering span
        astart = offset - offset % self.block
        aend = min(info.size,
                   -(-(offset + length) // self.block) * self.block)
        if aend - astart <= max_entry:
            info2, stream = self.inner.get_object(bucket, key, astart,
                                                  aend - astart, opts)
            if info2.etag != info.etag:
                # new generation: the aligned span was computed from
                # the stale stat — re-read exactly what was asked
                close = getattr(stream, "close", None)
                if close is not None:
                    close()
                return self.inner.get_object(bucket, key, offset,
                                             length, opts)
            self._ensure_meta(bucket, key, info2)
            return info2, self._fill_stream(bucket, key, info2, stream,
                                            astart, aend - astart,
                                            offset, length)
        # too big to cache: read through
        return self.inner.get_object(bucket, key, offset, length, opts)

    def _ensure_meta(self, bucket: str, key: str, info) -> None:
        """Entry skeleton so concurrent fills of different ranges merge
        under one meta generation."""
        d = self._entry_dir(bucket, key)
        os.makedirs(d, exist_ok=True)
        with self._mu:  # meta.json read-modify-write (one small file)
            meta = self._load_entry(bucket, key)
            if meta is None or meta.get("etag") != info.etag:
                try:
                    self._write_meta(d, {
                        "bucket": bucket, "key": key,
                        "etag": info.etag, "size": info.size,
                        "content_type": info.content_type,
                        "user_defined": dict(info.user_defined or {}),
                        "mod_time": info.mod_time, "ranges": []})
                except OSError:
                    # entry dir purged between makedirs and the write —
                    # losing the skeleton only skips this fill
                    pass

    def put_object(self, bucket: str, key: str, reader, size: int = -1,
                   opts: Optional[PutOptions] = None):
        self._drop(bucket, key)
        return self.inner.put_object(bucket, key, reader, size, opts)

    def delete_object(self, bucket: str, key: str, version_id: str = "",
                      versioned: bool = False):
        self._drop(bucket, key)
        return self.inner.delete_object(bucket, key, version_id,
                                        versioned)

    def delete_objects(self, bucket: str, objects: list[str]):
        for o in objects:
            self._drop(bucket, o)
        return self.inner.delete_objects(bucket, objects)

    def update_object_metadata(self, bucket: str, key: str,
                               metadata: dict, version_id: str = ""):
        self._drop(bucket, key)
        return self.inner.update_object_metadata(bucket, key, metadata,
                                                 version_id)

    def delete_bucket(self, bucket: str, force: bool = False):
        """Purge every entry of the deleted bucket — a recreated
        same-name bucket must start cold. The entry layout's first
        level is the bucket hash, so the purge is one rmtree."""
        out = self.inner.delete_bucket(bucket, force)
        bh = hashlib.sha256(bucket.encode()).hexdigest()[:16]
        shutil.rmtree(os.path.join(self.dir, bh), ignore_errors=True)
        return out

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "fills": self.fills, "evictions": self.evictions,
                "admit_rejects": self.admit_rejects,
                "usage": self._usage(), "budget": self.budget}
