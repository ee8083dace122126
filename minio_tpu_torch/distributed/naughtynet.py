"""NaughtyNet — seeded deterministic network fault injection.

NaughtyDisk's schedule/seed/replay discipline applied to the wire: the
internode transport consults a process-global controller on every
outbound dial (`RestClient._call_once`), every inbound verb
(`RPCHandler.route`) and every streamed response chunk. All of it is a
pure function of (seed, verb, call #), so a failing chaos test prints
one integer that replays the exact fault sequence.

Fault classes:

  * partitions — directional rules between named node ids
    ("host:port"), installed by `partition(a, b)`: full (both
    directions), asymmetric (`oneway=True` — A still reaches B while
    B's calls to A fail), timed windows (`after_s`/`duration_s`).
    A blocked outbound dial raises like an unreachable host
    (`conn_failure=True`); a blocked inbound verb is refused with the
    `PARTITIONED_KIND` error payload which the calling transport maps
    back to the same unreachable-host failure — so one side's admin
    verb is enough to cut a link for real subprocess clusters.
  * per-verb delay/jitter schedules (`NetSchedule.delay_rate`) —
    injected latency before the dial / before serving.
  * mid-stream resets and stalls (`NetSchedule.reset_rate`, and any
    partition that opens while a response is streaming) — exercises
    the streamed-read deadline instead of parking readers forever.

Identity: subprocess nodes set the process-local id once at boot
(`membership.set_local_node`); in-process nodes (the port's ClusterNode
stamps its address and boot generation on every RPC client and handler
it owns, `ClusterNode._identify`) are told apart through
`RestClient.node_id` / `RPCHandler.node_id`, so one global controller
can still tell the nodes apart. A rule names a node id, not an
incarnation: a node rebooted in place keeps its address, so a partition
still cuts its next generation. Rules match "*" as a wildcard on either
end.

Everything is OFF until `arm()` — the `enabled` flag is the only cost
on the hot path when chaos is not running.

A copy of minio_tpu/distributed/naughtynet.py; the hooks sit at the
reference's five places in the port's transport.py.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from ..utils import eventlog, knobs, telemetry
from . import membership

# error kind a server-side drop returns; the transport maps it to
# NetworkError(conn_failure=True) so both injection sides look like an
# unreachable host to the caller
PARTITIONED_KIND = "naughtynet-partitioned"

_NET_DROPS = telemetry.REGISTRY.counter(
    "minio_tpu_net_partition_drops_total",
    "RPC exchanges dropped by an armed naughtynet partition rule",
    )
_NET_DELAYS = telemetry.REGISTRY.counter(
    "minio_tpu_net_chaos_delays_total",
    "RPC exchanges delayed by the naughtynet schedule")
_NET_RESETS = telemetry.REGISTRY.counter(
    "minio_tpu_net_chaos_resets_total",
    "streamed RPC responses reset/stalled mid-stream by naughtynet")


@dataclass(frozen=True)
class NetSchedule:
    """Deterministic per-verb fault schedule. Every decision is a pure
    function of (seed, verb, per-verb call #): replaying the same seed
    against the same call sequence reproduces the same faults."""

    seed: int = 0
    delay_rate: float = 0.0      # fraction of calls delayed
    delay_s: float = 0.0         # fixed component of injected delay
    jitter_s: float = 0.0        # seeded-uniform extra in [0, jitter_s)
    reset_rate: float = 0.0      # fraction of streamed responses reset
    fault_verbs: Tuple[str, ...] = ()   # empty = every verb

    def _roll(self, verb: str, n: int, salt: str) -> float:
        h = zlib.crc32(f"{self.seed}:{verb}:{n}:{salt}".encode())
        return (h & 0xFFFFFFFF) / 2 ** 32

    def _applies(self, verb: str) -> bool:
        return not self.fault_verbs or verb in self.fault_verbs

    def delay_for(self, verb: str, n: int) -> float:
        if not self._applies(verb) or self.delay_rate <= 0:
            return 0.0
        if self._roll(verb, n, "delay") >= self.delay_rate:
            return 0.0
        return self.delay_s + self.jitter_s * self._roll(verb, n, "jit")

    def resets(self, verb: str, n: int) -> bool:
        return (self._applies(verb) and self.reset_rate > 0
                and self._roll(verb, n, "reset") < self.reset_rate)

    def to_dict(self) -> dict:
        return {"seed": self.seed, "delay_rate": self.delay_rate,
                "delay_s": self.delay_s, "jitter_s": self.jitter_s,
                "reset_rate": self.reset_rate,
                "fault_verbs": list(self.fault_verbs)}


@dataclass
class _Rule:
    src: str                     # node id or "*"
    dst: str                     # node id or "*"
    opens: float = 0.0           # monotonic time the window opens
    closes: float = 0.0          # 0 = never (until heal())

    def active(self, now: float) -> bool:
        if now < self.opens:
            return False
        return self.closes <= 0 or now < self.closes

    def expired(self, now: float) -> bool:
        return 0 < self.closes <= now

    def matches(self, src: str, dst: str) -> bool:
        return ((self.src == "*" or self.src == src)
                and (self.dst == "*" or self.dst == dst))


@dataclass(frozen=True)
class _Action:
    blocked: bool = False
    delay: float = 0.0


_PASS = _Action()


class NaughtyNet:
    """Process-global fault controller the transport consults."""

    def __init__(self):
        self._mu = threading.Lock()
        self.enabled = False
        self._rules: List[_Rule] = []
        self._sched: Optional[NetSchedule] = None
        self._counts: dict = {}          # verb -> per-verb call #
        self.stats = {"blocked": 0, "delayed": 0, "resets": 0,
                      "stream_stalls": 0}

    # -- control surface ---------------------------------------------------

    def arm(self, schedule: Optional[NetSchedule] = None) -> None:
        with self._mu:
            if schedule is not None:
                self._sched = schedule
            self.enabled = True

    def disarm(self) -> None:
        """Stop injecting; rules stay installed for a later re-arm."""
        self.enabled = False

    def reset(self) -> None:
        """Back to factory: no rules, no schedule, disabled (tests)."""
        with self._mu:
            self.enabled = False
            self._rules.clear()
            self._sched = None
            self._counts.clear()
            for k in self.stats:
                self.stats[k] = 0

    def partition(self, a: str, b: str, oneway: bool = False,
                  after_s: float = 0.0,
                  duration_s: float = 0.0) -> None:
        """Cut a→b (and b→a unless `oneway`). `after_s` delays the
        window opening, `duration_s` auto-heals it — both relative to
        now. Arms the controller."""
        now = time.monotonic()
        opens = now + after_s
        closes = opens + duration_s if duration_s > 0 else 0.0
        with self._mu:
            self._rules.append(_Rule(a, b, opens, closes))
            if not oneway:
                self._rules.append(_Rule(b, a, opens, closes))
            self.enabled = True
        eventlog.emit("net.partition",
                      rule="oneway" if oneway else "both",
                      peers=f"{a}|{b}")

    def heal(self, a: Optional[str] = None,
             b: Optional[str] = None) -> None:
        """Remove partition rules touching (a, b) in either direction;
        with no arguments, remove every rule."""
        with self._mu:
            if a is None and b is None:
                self._rules.clear()
            else:
                ends = {x for x in (a, b) if x is not None}
                self._rules = [r for r in self._rules
                               if not ends & {r.src, r.dst}]
        eventlog.emit("net.heal",
                      peers=f"{a or '*'}|{b or '*'}")

    # -- decision points (transport hot path; enabled-flag gated there) ----

    def blocked(self, src: str, dst: str) -> bool:
        now = time.monotonic()
        with self._mu:
            if any(r.expired(now) for r in self._rules):
                self._rules = [r for r in self._rules
                               if not r.expired(now)]
            return any(r.active(now) and r.matches(src, dst)
                       for r in self._rules)

    def _next(self, verb: str) -> int:
        with self._mu:
            n = self._counts.get(verb, 0)
            self._counts[verb] = n + 1
            return n

    def _decide(self, src: str, dst: str, verb: str) -> _Action:
        if self.blocked(src, dst):
            with self._mu:
                self.stats["blocked"] += 1
            _NET_DROPS.inc()
            return _Action(blocked=True)
        sched = self._sched
        if sched is None:
            return _PASS
        delay = sched.delay_for(verb, self._next(verb))
        if delay > 0:
            with self._mu:
                self.stats["delayed"] += 1
            _NET_DELAYS.inc()
        return _Action(delay=delay)

    def on_call(self, src: str, dst: str, verb: str) -> _Action:
        """Client side, before the dial."""
        return self._decide(src or membership.local_node(), dst, verb)

    def on_serve(self, src: str, dst: str, verb: str) -> _Action:
        """Server side, before dispatching the verb. `src` comes from
        the caller's identity header ("" when it sent none)."""
        return self._decide(src, dst or membership.local_node(), verb)

    def wrap_stream(self, src: str, dst: str, verb: str,
                    it: Iterator[bytes]) -> Iterator[bytes]:
        """Server side, around a streamed response body: a schedule
        reset kills the connection after the first chunk; a partition
        that opens mid-stream goes SILENT (the classic partition-after-
        headers) until the client's streamed-read deadline fires, then
        kills the connection so the serving thread is not parked
        forever."""
        reset_after = (self._sched is not None
                       and self._sched.resets(verb, self._next(verb)))

        def gen():
            try:
                for chunk in it:
                    # a partition opening mid-stream stalls the writer
                    stalled = 0.0
                    while (self.enabled
                           and self.blocked(src, dst)
                           and stalled < 60.0):
                        if stalled == 0.0:
                            with self._mu:
                                self.stats["stream_stalls"] += 1
                            _NET_RESETS.inc()
                        time.sleep(0.25)
                        stalled += 0.25
                    if stalled >= 60.0:
                        raise ConnectionResetError(
                            "naughtynet: stream partitioned")
                    yield chunk
                    if reset_after and self.enabled:
                        with self._mu:
                            self.stats["resets"] += 1
                        _NET_RESETS.inc()
                        raise ConnectionResetError(
                            "naughtynet: mid-stream reset")
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 — teardown
                        pass
        return gen()

    # -- admin surface -----------------------------------------------------

    def status(self) -> dict:
        now = time.monotonic()
        with self._mu:
            return {
                "enabled": self.enabled,
                "local_node": membership.local_node(),
                "rules": [{"src": r.src, "dst": r.dst,
                           "active": r.active(now),
                           "closes_in_s": (round(r.closes - now, 3)
                                           if r.closes > 0 else None)}
                          for r in self._rules],
                "schedule": (self._sched.to_dict()
                             if self._sched else None),
                "stats": dict(self.stats),
            }


NET = NaughtyNet()


def handle_admin(payload: dict) -> dict:
    """Ops for the test-only admin verb (gated on MINIO_TPU_NAUGHTYNET
    by the admin plane): partition / heal / configure / arm / disarm /
    status / reset. Returns the post-op status."""
    op = payload.get("op", "status")
    if op == "partition":
        NET.partition(payload.get("src", "*"), payload.get("dst", "*"),
                      oneway=bool(payload.get("oneway")),
                      after_s=float(payload.get("after_s", 0.0)),
                      duration_s=float(payload.get("duration_s", 0.0)))
    elif op == "heal":
        NET.heal(payload.get("src"), payload.get("dst"))
    elif op == "configure":
        NET.arm(NetSchedule(
            seed=int(payload.get(
                "seed", knobs.get_int("MINIO_TPU_NAUGHTYNET_SEED"))),
            delay_rate=float(payload.get("delay_rate", 0.0)),
            delay_s=float(payload.get("delay_s", 0.0)),
            jitter_s=float(payload.get("jitter_s", 0.0)),
            reset_rate=float(payload.get("reset_rate", 0.0)),
            fault_verbs=tuple(payload.get("fault_verbs", ()))))
    elif op == "arm":
        NET.arm()
    elif op == "disarm":
        NET.disarm()
    elif op == "reset":
        NET.reset()
    elif op != "status":
        raise ValueError(f"naughtynet: unknown op {op!r}")
    return NET.status()
