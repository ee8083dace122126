"""NaughtyDisk — deterministic fault injection for the storage plane.

Counterpart of minio_tpu/storage/naughty.py, whole: the failure-plane
analog of the reference's naughtyDisk (cmd/naughty-disk_test.go), a
StorageAPI wrapper that misbehaves on schedule so quorum writes, hedged
reads, bitrot verification, MRF healing, and the background plane can be
driven through realistic drive faults in-process.

Two programming models compose:

  * **Programmed faults** — ``fail_verbs[verb] = err`` fails every call
    of a verb; ``verb_errors[verb][n] = err`` fails exactly the n-th
    call (the reference's ``errors map[int]error``); ``offline = True``
    makes every verb raise DiskNotFound until cleared;
    ``stall_verbs[verb] = seconds`` stalls every call of a verb and
    ``verb_stalls[verb][n] = seconds`` stalls exactly the n-th call —
    the gray-failure injector (the drive ANSWERS, just slowly).
  * **Scheduled faults** — a seeded :class:`FaultSchedule` decides per
    (verb, call#) whether to raise an error, inject latency, flip
    payload bytes (bitrot), truncate a read stream / short-write a
    payload, hold the drive offline for an op-count window, or stall
    the call on a heavy-tail duration (``stall_rate``/``stall_s``/
    ``stall_pareto`` + ``stall_windows`` op-count windows during which
    EVERY faultable call stalls).

Stalls on ``read_file_stream`` are deferred to the FIRST read of the
returned stream rather than the open — a gray-failing drive typically
accepts the request and then takes forever to move bytes, which is
exactly the shape the hedged reader must race.

Schedule decisions are pure functions of ``(seed, verb, call#)`` — the
same seed replays the same fault pattern per verb sequence regardless
of thread interleaving, so any chaos-test failure reproduces from its
printed seed. The wrapper has no ``has_appender``: shard frames reach
the drive through ``append_file``, inside the fault gate.
"""

from __future__ import annotations

import io
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import BinaryIO, Iterator, Optional

from . import errors as serr
from .api import BitrotVerifier, StorageAPI
from .datatypes import DiskInfo, FileInfo, VolInfo

# Verbs that move shard payload; the default fault surface.
DATA_VERBS = ("read_file", "read_file_stream", "read_all", "append_file",
              "create_file", "write_all")
META_VERBS = ("write_metadata", "read_version", "read_versions",
              "delete_version", "rename_data", "rename_file",
              "delete_file", "check_parts", "check_file", "verify_file",
              "list_dir", "walk", "make_vol", "stat_vol", "list_vols",
              "delete_vol")
ALL_VERBS = DATA_VERBS + META_VERBS

# Verbs whose *result* carries payload (bitrot / truncation on read).
_READ_PAYLOAD_VERBS = ("read_file", "read_all")
# Verbs whose *argument* carries payload (bitrot / truncation on write).
_WRITE_PAYLOAD_VERBS = ("append_file", "write_all")


@dataclass(frozen=True)
class FaultSchedule:
    """Seeded, deterministic fault plan.

    Every decision derives from ``crc32(seed:verb:call#:salt)`` — a pure
    hash, no shared RNG state — so concurrent callers observe the same
    per-verb fault sequence for the same seed.
    """

    seed: int = 0
    # probability a faulted verb call raises `error_cls`
    error_rate: float = 0.0
    # probability a call sleeps `latency` seconds before proceeding
    latency_rate: float = 0.0
    latency: float = 0.002
    # probability a payload byte gets flipped (reads AND writes)
    bitrot_rate: float = 0.0
    # probability a payload is truncated (short read / silent short write)
    truncate_rate: float = 0.0
    # [start, end) windows in the drive's TOTAL op count during which the
    # drive is gone (go-offline/come-back transitions)
    offline_windows: tuple = ()
    # probability a faulted verb call STALLS (answers, slowly): the
    # duration is `stall_s`, heavy-tailed by `stall_pareto` > 0
    # (duration = stall_s / (1-u)^pareto, capped at stall_max_s — a
    # deterministic Pareto-ish tail from the same pure hash)
    stall_rate: float = 0.0
    stall_s: float = 0.5
    stall_pareto: float = 0.0
    stall_max_s: float = 5.0
    # [start, end) windows in the TOTAL op count during which every
    # faultable verb call stalls `stall_s` — a drive that goes gray for
    # a stretch, then recovers
    stall_windows: tuple = ()
    # which verbs the error/latency faults apply to
    fault_verbs: tuple = DATA_VERBS
    error_cls: type = serr.FaultyDisk

    # -- decision primitives ----------------------------------------------

    def _roll(self, verb: str, n: int, salt: str) -> float:
        h = zlib.crc32(f"{self.seed}:{verb}:{n}:{salt}".encode())
        return (h & 0xFFFFFFFF) / 2 ** 32

    def error_for(self, verb: str, n: int) -> Optional[Exception]:
        if verb in self.fault_verbs and \
                self._roll(verb, n, "err") < self.error_rate:
            return self.error_cls(f"naughty[{self.seed}]: {verb}#{n}")
        return None

    def latency_for(self, verb: str, n: int) -> float:
        if verb in self.fault_verbs and \
                self._roll(verb, n, "lat") < self.latency_rate:
            return self.latency
        return 0.0

    def corrupts(self, verb: str, n: int) -> bool:
        return self._roll(verb, n, "rot") < self.bitrot_rate

    def truncates(self, verb: str, n: int) -> bool:
        return self._roll(verb, n, "trunc") < self.truncate_rate

    def offline_at(self, op_no: int) -> bool:
        return any(a <= op_no < b for a, b in self.offline_windows)

    def stall_for(self, verb: str, n: int, op_no: int) -> float:
        """Stall duration for this call (0.0 = none): the op-count
        window first, then the seeded per-call roll with its
        deterministic heavy tail."""
        if verb in self.fault_verbs and \
                any(a <= op_no < b for a, b in self.stall_windows):
            return self.stall_s
        if verb in self.fault_verbs and self.stall_rate > 0 and \
                self._roll(verb, n, "stall") < self.stall_rate:
            if self.stall_pareto > 0:
                u = self._roll(verb, n, "stall-dur")
                return min(self.stall_s / max(1.0 - u, 1e-6)
                           ** self.stall_pareto, self.stall_max_s)
            return self.stall_s
        return 0.0

    # deterministic "where" for payload mutation
    def fault_offset(self, verb: str, n: int, size: int) -> int:
        if size <= 0:
            return 0
        return int(self._roll(verb, n, "off") * size) % size


@dataclass
class FaultStats:
    """What the wrapper actually injected (for test assertions)."""
    errors: int = 0
    latency: int = 0
    bitrot: int = 0
    truncated: int = 0
    offline_hits: int = 0
    stalls: int = 0
    stall_s: float = 0.0
    calls: dict = field(default_factory=dict)


class _TruncatedStream:
    """Reader that serves only a prefix of the inner stream, optionally
    flipping one byte — a mid-stream disconnect / rotted sector."""

    def __init__(self, inner, limit: int, flip_at: int = -1):
        self._inner = inner
        self._limit = limit
        self._flip_at = flip_at
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        if self._limit >= 0:
            if self._pos >= self._limit:
                return b""
            budget = self._limit - self._pos
            n = budget if n is None or n < 0 else min(n, budget)
        data = self._inner.read(n)
        if data and self._flip_at >= 0 and \
                self._pos <= self._flip_at < self._pos + len(data):
            i = self._flip_at - self._pos
            data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        self._pos += len(data)
        return data

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


class _StallFirstReadStream:
    """Defers a stall to the first read of a shard stream: the open
    returns instantly (the drive 'answered'), the payload takes
    `dur` seconds to start moving — the gray-failure read shape the
    hedged reader must race."""

    def __init__(self, inner, dur: float, stall_fn):
        self._inner = inner
        self._dur = dur
        self._stall_fn = stall_fn

    def read(self, n: int = -1) -> bytes:
        if self._dur > 0:
            dur, self._dur = self._dur, 0.0
            self._stall_fn(dur)
        return self._inner.read(n)

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


def _flip_byte(data: bytes, at: int) -> bytes:
    if not data:
        return data
    at %= len(data)
    return data[:at] + bytes([data[at] ^ 0xFF]) + data[at + 1:]


class NaughtyDisk(StorageAPI):
    """Fault-injecting StorageAPI wrapper (reference naughtyDisk)."""

    def __init__(self, inner: StorageAPI,
                 schedule: Optional[FaultSchedule] = None,
                 enabled: bool = True):
        self.inner = inner
        self.schedule = schedule
        # schedule gate: build/format the fixture quietly, then arm()
        self.enabled = enabled
        self.fail_verbs: dict[str, Exception] = {}
        self.verb_errors: dict[str, dict[int, Exception]] = {}
        # programmed stalls: every call of a verb / exactly the n-th
        self.stall_verbs: dict[str, float] = {}
        self.verb_stalls: dict[str, dict[int, float]] = {}
        self.offline = False
        self.stats = FaultStats()
        self.total_ops = 0
        self._mu = threading.Lock()

    # -- control -----------------------------------------------------------

    def arm(self) -> "NaughtyDisk":
        self.enabled = True
        return self

    def disarm(self) -> "NaughtyDisk":
        self.enabled = False
        return self

    # -- fault gate --------------------------------------------------------

    def _begin(self, verb: str) -> int:
        """Count the call, apply offline/error/latency faults; returns the
        verb's call# for payload-fault decisions."""
        with self._mu:
            n = self.stats.calls.get(verb, 0) + 1
            self.stats.calls[verb] = n
            self.total_ops += 1
            op = self.total_ops
        sched = self.schedule if self.enabled else None
        if self.offline or (sched is not None and sched.offline_at(op)):
            with self._mu:
                self.stats.offline_hits += 1
            raise serr.DiskNotFound(f"naughty: offline ({self.inner})")
        one_shot = self.verb_errors.get(verb)
        if one_shot is not None and n in one_shot:
            raise one_shot.pop(n)
        if verb in self.fail_verbs:
            raise self.fail_verbs[verb]
        if sched is not None:
            err = sched.error_for(verb, n)
            if err is not None:
                with self._mu:
                    self.stats.errors += 1
                raise err
            lat = sched.latency_for(verb, n)
            if lat > 0:
                with self._mu:
                    self.stats.latency += 1
                time.sleep(lat)
        if verb != "read_file_stream":
            dur = self._stall_duration(verb, n, op, sched)
            if dur > 0:
                self._stall(dur)
        # read_file_stream defers its stall to the first read of the
        # returned stream (read_file_stream computes it there)
        return n

    def _stall_duration(self, verb: str, n: int, op: int,
                        sched) -> float:
        one_shot = self.verb_stalls.get(verb)
        if one_shot is not None and n in one_shot:
            return one_shot.pop(n)
        dur = self.stall_verbs.get(verb, 0.0)
        if dur <= 0 and sched is not None:
            dur = sched.stall_for(verb, n, op)
        return dur

    def _stall(self, dur: float) -> None:
        with self._mu:
            self.stats.stalls += 1
            self.stats.stall_s += dur
        time.sleep(dur)

    def _mangle_read(self, verb: str, n: int, data: bytes) -> bytes:
        sched = self.schedule if self.enabled else None
        if sched is None or not data:
            return data
        if sched.truncates(verb, n):
            with self._mu:
                self.stats.truncated += 1
            data = data[:max(1, len(data) // 2)]
        if sched.corrupts(verb, n):
            with self._mu:
                self.stats.bitrot += 1
            data = _flip_byte(data, sched.fault_offset(verb, n, len(data)))
        return data

    def _mangle_write(self, verb: str, n: int, data) -> bytes:
        return self._mangle_read(verb, n, bytes(data))

    # -- identity / health -------------------------------------------------

    def __str__(self) -> str:
        return f"naughty({self.inner})"

    def is_online(self) -> bool:
        if self.offline:
            return False
        if self.enabled and self.schedule is not None and \
                self.schedule.offline_at(self.total_ops + 1):
            return False
        return self.inner.is_online()

    def is_local(self) -> bool:
        return self.inner.is_local()

    def hostname(self) -> str:
        return self.inner.hostname()

    def endpoint(self) -> str:
        return self.inner.endpoint()

    def close(self) -> None:
        self.inner.close()

    def get_disk_id(self) -> str:
        return self.inner.get_disk_id()

    def set_disk_id(self, disk_id: str) -> None:
        self.inner.set_disk_id(disk_id)

    def healing(self) -> bool:
        return self.inner.healing()

    def disk_info(self) -> DiskInfo:
        self._begin("disk_info")
        return self.inner.disk_info()

    # -- volumes -----------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        self._begin("make_vol")
        self.inner.make_vol(volume)

    def list_vols(self) -> list[VolInfo]:
        self._begin("list_vols")
        return self.inner.list_vols()

    def stat_vol(self, volume: str) -> VolInfo:
        self._begin("stat_vol")
        return self.inner.stat_vol(volume)

    def delete_vol(self, volume: str, force: bool = False) -> None:
        self._begin("delete_vol")
        self.inner.delete_vol(volume, force)

    # -- metadata ----------------------------------------------------------

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._begin("write_metadata")
        self.inner.write_metadata(volume, path, fi)

    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo:
        self._begin("read_version")
        return self.inner.read_version(volume, path, version_id)

    def read_versions(self, volume: str, path: str) -> list[FileInfo]:
        self._begin("read_versions")
        return self.inner.read_versions(volume, path)

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        self._begin("delete_version")
        self.inner.delete_version(volume, path, fi)

    def rename_data(self, src_volume: str, src_path: str, data_dir: str,
                    dst_volume: str, dst_path: str,
                    version_id: str = "") -> None:
        self._begin("rename_data")
        self.inner.rename_data(src_volume, src_path, data_dir,
                               dst_volume, dst_path, version_id)

    # -- files -------------------------------------------------------------

    def list_dir(self, volume: str, dir_path: str,
                 count: int = -1) -> list[str]:
        self._begin("list_dir")
        return self.inner.list_dir(volume, dir_path, count)

    def read_file(self, volume: str, path: str, offset: int, length: int,
                  verifier: Optional[BitrotVerifier] = None) -> bytes:
        n = self._begin("read_file")
        data = self.inner.read_file(volume, path, offset, length, verifier)
        return self._mangle_read("read_file", n, data)

    def append_file(self, volume: str, path: str, buf) -> None:
        n = self._begin("append_file")
        self.inner.append_file(volume, path,
                               self._mangle_write("append_file", n, buf))

    def create_file(self, volume: str, path: str, size: int,
                    reader: BinaryIO) -> None:
        n = self._begin("create_file")
        sched = self.schedule if self.enabled else None
        if sched is not None and (sched.truncates("create_file", n)
                                  or sched.corrupts("create_file", n)):
            # silent short write / rotted sector: stage, mangle, store
            data = self._mangle_write("create_file", n, reader.read())
            self.inner.create_file(volume, path, len(data),
                                   io.BytesIO(data))
            return
        self.inner.create_file(volume, path, size, reader)

    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int) -> BinaryIO:
        n = self._begin("read_file_stream")
        stream = self.inner.read_file_stream(volume, path, offset, length)
        # stalls ride the FIRST read, not the open: a gray drive
        # accepts the request fast and then dribbles bytes
        dur = self._stall_duration("read_file_stream", n, self.total_ops,
                                   self.schedule if self.enabled
                                   else None)
        if dur > 0:
            stream = _StallFirstReadStream(stream, dur, self._stall)
        sched = self.schedule if self.enabled else None
        if sched is None:
            return stream
        limit = -1
        flip_at = -1
        if sched.truncates("read_file_stream", n):
            with self._mu:
                self.stats.truncated += 1
            limit = max(1, length // 2)
        if sched.corrupts("read_file_stream", n):
            flip_at = sched.fault_offset("read_file_stream", n, length)
            if 0 <= limit <= flip_at:
                # the flip lands past the truncation point: no byte is
                # actually mutated, so the stat must not claim one
                # (FaultStats records what was INJECTED, not rolled)
                flip_at = -1
            else:
                with self._mu:
                    self.stats.bitrot += 1
        if limit < 0 and flip_at < 0:
            return stream
        return _TruncatedStream(stream, limit, flip_at)

    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None:
        self._begin("rename_file")
        self.inner.rename_file(src_volume, src_path, dst_volume, dst_path)

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        self._begin("check_parts")
        self.inner.check_parts(volume, path, fi)

    def check_file(self, volume: str, path: str) -> None:
        self._begin("check_file")
        self.inner.check_file(volume, path)

    def delete_file(self, volume: str, path: str,
                    recursive: bool = False) -> None:
        self._begin("delete_file")
        self.inner.delete_file(volume, path, recursive)

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        self._begin("verify_file")
        self.inner.verify_file(volume, path, fi)

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        n = self._begin("write_all")
        self.inner.write_all(volume, path,
                             self._mangle_write("write_all", n, data))

    def read_all(self, volume: str, path: str) -> bytes:
        n = self._begin("read_all")
        return self._mangle_read("read_all", n,
                                 self.inner.read_all(volume, path))

    # -- listing / crawling ------------------------------------------------

    def walk(self, volume: str, dir_path: str = "", marker: str = "",
             recursive: bool = True) -> Iterator[FileInfo]:
        self._begin("walk")
        return self.inner.walk(volume, dir_path, marker, recursive)

    def walk_versions(self, volume: str, dir_path: str = "",
                      marker: str = "", recursive: bool = True):
        self._begin("walk")
        return self.inner.walk_versions(volume, dir_path, marker, recursive)

    # extras some callers probe for (appender capability must NOT leak
    # through, or framed writes would bypass the fault gate)
    def __getattr__(self, name):
        raise AttributeError(name)
