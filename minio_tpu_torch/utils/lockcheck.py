"""Runtime lock-order watchdog: named locks + an acquisition-order graph.

A copy of minio_tpu/utils/lockcheck.py. The static side of the
correctness plane bans blocking work *inside* a lock body; this module
covers what static analysis cannot see — the ORDER in which threads nest
locks across call chains. Two subsystems each correct in isolation can
deadlock when their critical sections nest in opposite orders under
concurrency. A cycle in the lock-order graph is exactly that hazard, and
it is detectable the first time both orders are *recorded* — no unlucky
interleaving required.

How it works (the lockdep idea, sized for this codebase):

  * hot modules create their locks through :func:`mutex` /
    :func:`rlock` / :func:`condition`, passing a stable ROLE name.
    Graph nodes are names, not instances — like lockdep's lock classes,
    so an ABBA between two *schedulers* still flags even though the
    instances differ (consistent order by role is the discipline being
    checked);
  * each acquire records edges ``held → acquiring`` for every lock the
    thread already holds, then checks whether the new edge closes a
    cycle. Cycles are recorded as violations and (by default) raised as
    :class:`LockOrderError` at the offending acquire;
  * an acquire that blocks longer than ``MINIO_TPU_LOCKCHECK_BLOCK_MS``
    while the thread holds another lock is flagged *held-while-blocking*
    (the convoy precursor); holds longer than
    ``MINIO_TPU_LOCKCHECK_HELD_MS`` are flagged *long-hold*.

The port's named roles. The reference's (its ``mesh.dispatch`` waits
for the multi-card mesh):

  sched.buckets        parallel/scheduler.py BatchScheduler (its _kick
                       Condition is over the same lock)
  bpool.created        parallel/bpool.py BytePool
  metacache.cond       object/metacache.py BucketMetacache
  cache.tracker        object/cache.py AccessTracker
  cache.meta           object/cache.py CacheObjects (entry bookkeeping)
  cache.purge          object/cache.py CacheObjects (the purge pass)
  mrf.queue            object/background.py MRFQueue
  telemetry.registry   utils/telemetry.py MetricsRegistry
  telemetry.spans      utils/telemetry.py SpanSink

and the card's path, which the reference's dispatch did not have:

  codec.steps          object/codec.py the per-verb dispatch seconds
  codec.slots          object/codec.py the CUDA-stream slot queues
  bpool.copies         parallel/bpool.py pinned staging's pending copies
  kernels.build        ops/kernels.py the nvcc build and library load
  kernels.count        ops/kernels.py the launch counters

Beside the reference's surface, :func:`roles` lists every role taken
while the watchdog was on, nested or not: chip_smoke.py prints it.

Always-installed, env-gated: the factories return the checked wrapper
unconditionally, but every acquire first consults a cached enabled
flag, so the disabled cost is one attribute test. Tests flip
``MINIO_TPU_LOCKCHECK`` and call :func:`refresh`; the port's chaos,
concurrency and lockcheck suites run with the watchdog on, and
chip_smoke.py runs its concurrent-PUT and gray-failure phases under it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from . import knobs

__all__ = [
    "LockOrderError", "Violation", "mutex", "rlock", "condition",
    "enabled", "refresh", "reset", "violations", "check", "graph",
    "roles",
]


class LockOrderError(RuntimeError):
    """An acquire would close a cycle in the lock-order graph."""


class Violation:
    __slots__ = ("kind", "lock", "held", "path", "thread", "detail",
                 "when")

    def __init__(self, kind: str, lock: str, held: List[str],
                 path: List[str], thread: str, detail: str):
        self.kind = kind          # "cycle" | "held-while-blocking" | "long-hold"
        self.lock = lock
        self.held = held
        self.path = path          # the cycle, for kind == "cycle"
        self.thread = thread
        self.detail = detail
        self.when = time.time()

    def __repr__(self) -> str:
        return (f"<lockcheck {self.kind} lock={self.lock!r} "
                f"held={self.held} {self.detail} [{self.thread}]>")


# -- global state ------------------------------------------------------------

# a REAL lock (never a checked one) guarding the graph + violation list
_mu = threading.Lock()
_edges: Dict[str, Set[str]] = {}          # held-name -> {acquired-names}
_edge_threads: Dict[tuple, str] = {}      # edge -> first thread that made it
_violations: List[Violation] = []
_roles: Set[str] = set()                  # every role acquired while on
_local = threading.local()

_enabled = False
_raise_on_cycle = True
_block_s = 0.2
_held_s = 1.0


def refresh() -> None:
    """Re-read the MINIO_TPU_LOCKCHECK_* knobs (tests flip them at
    runtime; per-acquire reads would put an environ lookup on every
    hot-path lock)."""
    global _enabled, _raise_on_cycle, _block_s, _held_s
    _enabled = knobs.get_bool("MINIO_TPU_LOCKCHECK")
    _raise_on_cycle = knobs.get_bool("MINIO_TPU_LOCKCHECK_RAISE")
    _block_s = knobs.get_float("MINIO_TPU_LOCKCHECK_BLOCK_MS") / 1e3
    _held_s = knobs.get_float("MINIO_TPU_LOCKCHECK_HELD_MS") / 1e3


refresh()


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop the recorded graph and violations (test isolation)."""
    with _mu:
        _edges.clear()
        _edge_threads.clear()
        _violations.clear()
        _roles.clear()


def violations(kind: Optional[str] = None) -> List[Violation]:
    with _mu:
        vs = list(_violations)
    return [v for v in vs if kind is None or v.kind == kind]


def graph() -> Dict[str, Set[str]]:
    with _mu:
        return {k: set(v) for k, v in _edges.items()}


def roles() -> List[str]:
    """Every role acquired while the watchdog was on since the last
    reset(), nested or not (the graph holds only nested ones)."""
    with _mu:
        return sorted(_roles)


def check() -> None:
    """Raise on any recorded cycle (suites call this at teardown so
    cycles detected on daemon threads — where a raise is swallowed —
    still fail the test)."""
    cycles = violations("cycle")
    if cycles:
        raise LockOrderError("; ".join(v.detail for v in cycles))


def _held_stack() -> List[str]:
    st = getattr(_local, "held", None)
    if st is None:
        st = _local.held = []
    return st


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """Existing edge path src -> ... -> dst (DFS under _mu)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_acquire(name: str, wait_s: float) -> None:
    held = _held_stack()
    if not held:
        return
    tname = threading.current_thread().name
    cycle_detail = None
    with _mu:
        for h in held:
            if h == name:
                continue                  # reentrant by role: no edge
            # adding h -> name: a cycle exists iff name already
            # reaches h through recorded orders
            back = _find_path(name, h)
            if back is not None and (h, name) not in _edge_threads:
                path = [h] + back
                other = _edge_threads.get((back[0], back[1]),
                                          "?") if len(back) > 1 else "?"
                cycle_detail = (
                    f"lock-order cycle {' -> '.join(path)}: this "
                    f"thread ({tname}) holds {h!r} while acquiring "
                    f"{name!r}, but the opposite order was recorded "
                    f"(first by thread {other})")
                _violations.append(Violation(
                    "cycle", name, list(held), path, tname,
                    cycle_detail))
            _edges.setdefault(h, set()).add(name)
            _edge_threads.setdefault((h, name), tname)
        if wait_s > _block_s:
            _violations.append(Violation(
                "held-while-blocking", name, list(held), [], tname,
                f"blocked {wait_s * 1e3:.0f}ms acquiring {name!r} "
                f"while holding {held}"))
    if cycle_detail is not None and _raise_on_cycle:
        raise LockOrderError(cycle_detail)


def _record_release(name: str, held_for_s: float) -> None:
    if held_for_s > _held_s:
        tname = threading.current_thread().name
        with _mu:
            _violations.append(Violation(
                "long-hold", name, [], [], tname,
                f"held {name!r} for {held_for_s * 1e3:.0f}ms"))


class _CheckedLock:
    """threading.Lock/RLock wrapper carrying a role name. Compatible
    with threading.Condition (acquire/release/locked surface)."""

    __slots__ = ("_inner", "name", "_t_acquired", "_depth",
                 "_reentrant", "_owner")

    def __init__(self, inner, name: str, reentrant: bool = False):
        self._inner = inner
        self.name = name
        self._t_acquired = 0.0
        self._depth = 0
        self._reentrant = reentrant
        self._owner = None        # ident of the holding thread (mutex only)

    # -- lock protocol -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            return self._inner.acquire(blocking, timeout)
        if not self._reentrant and blocking and \
                self._owner == threading.get_ident():
            # the simplest deadlock: this thread re-acquiring a mutex
            # it already holds. The inner acquire would block FOREVER
            # before any recording could happen — flag it instead.
            # (Only the owner ever writes _owner, so owner == me can
            # never be a stale read.)
            tname = threading.current_thread().name
            detail = (f"self-deadlock: thread {tname} re-acquired "
                      f"non-reentrant mutex {self.name!r} it already "
                      "holds")
            with _mu:
                _violations.append(Violation(
                    "cycle", self.name, [self.name], [self.name],
                    tname, detail))
            raise LockOrderError(detail)
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        wait = time.perf_counter() - t0
        if self.name not in _roles:
            with _mu:
                _roles.add(self.name)
        held = _held_stack()
        reentrant = self.name in held
        held.append(self.name)
        self._depth += 1
        if self._depth == 1:
            self._t_acquired = time.perf_counter()
            self._owner = threading.get_ident()
        if not reentrant:
            try:
                self._record_acquire_safe(wait)
            except LockOrderError:
                # the caller never got the lock as far as it knows —
                # unwind EVERY piece of state this acquire installed
                # (a stale _owner would make the thread's next
                # legitimate acquire a false self-deadlock)
                held.pop()
                self._depth -= 1
                if self._depth == 0:
                    self._owner = None
                self._inner.release()
                raise
        return True

    def _record_acquire_safe(self, wait: float) -> None:
        # the held stack already includes self.name — record against
        # the OUTER holds only
        held = _held_stack()
        saved = held.pop()
        try:
            _record_acquire(self.name, wait)
        finally:
            held.append(saved)

    def release(self) -> None:
        # bookkeeping is unconditional: a lock ACQUIRED while the
        # watchdog was on must unwind its held-stack entry even if the
        # watchdog was flipped off mid-hold (tests refresh() at
        # teardown; a daemon mid-critical-section would otherwise
        # "hold" its role name forever and poison later enabled runs).
        # Threads that never ran enabled have no stack — one getattr.
        held = getattr(_local, "held", None)
        popped = False
        if held:
            # remove the innermost occurrence (LIFO discipline is the
            # common case; out-of-order release still unwinds correctly)
            for i in range(len(held) - 1, -1, -1):
                if held[i] == self.name:
                    del held[i]
                    popped = True
                    break
        if popped:
            # unbalanced pops only happen when the watchdog was flipped
            # on mid-hold — never decrement past the acquires we saw
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                if _enabled:
                    _record_release(
                        self.name,
                        time.perf_counter() - self._t_acquired)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition support: wait() must drop EVERY recursion level of an
    # RLock-backed condition (threading's own _release_save contract)
    # and restore them on wake, with the watchdog bookkeeping unwound
    # and rebuilt so the wait never reads as a hold.
    def _release_save(self):
        depth = 0
        if _enabled:
            depth = self._depth
            held = getattr(_local, "held", None)
            for _ in range(depth):
                if held:
                    for i in range(len(held) - 1, -1, -1):
                        if held[i] == self.name:
                            del held[i]
                            break
            if depth:
                self._depth = 0
                self._owner = None
                _record_release(
                    self.name, time.perf_counter() - self._t_acquired)
        inner_rs = getattr(self._inner, "_release_save", None)
        if inner_rs is not None:
            inner_state = inner_rs()
        else:
            self._inner.release()
            inner_state = None
        return (depth, inner_state)

    def _acquire_restore(self, saved) -> None:
        depth, inner_state = saved
        t0 = time.perf_counter()
        inner_ar = getattr(self._inner, "_acquire_restore", None)
        if inner_ar is not None:
            inner_ar(inner_state)
        else:
            self._inner.acquire()
        if _enabled:
            wait = time.perf_counter() - t0
            held = _held_stack()
            reentrant = self.name in held
            for _ in range(max(depth, 1)):
                held.append(self.name)
            self._depth = max(depth, 1)
            self._t_acquired = time.perf_counter()
            self._owner = threading.get_ident()
            if not reentrant:
                self._record_acquire_safe(wait)

    def _is_owned(self) -> bool:
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:       # RLock: exact owner answer
            return inner_owned()
        if self.acquire(False):
            self.release()
            return False
        return True


def mutex(name: str) -> _CheckedLock:
    """A named non-reentrant lock (threading.Lock under the hood).
    Re-acquiring it on the holding thread raises LockOrderError when
    the watchdog is on (it would block forever before any recording)."""
    return _CheckedLock(threading.Lock(), name)


def rlock(name: str) -> _CheckedLock:
    """A named reentrant lock."""
    return _CheckedLock(threading.RLock(), name, reentrant=True)


def condition(name: str) -> threading.Condition:
    """A Condition whose underlying lock is watchdog-instrumented.
    RLock-backed, matching ``threading.Condition()``'s default, so
    swapping a plain Condition for a named one never changes reentrancy
    semantics. ``wait()`` rides the checked release/re-acquire
    protocol, so a cond.wait never shows as a long hold."""
    return threading.Condition(rlock(name))
