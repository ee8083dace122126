"""What the lock-order watchdog (minio_tpu_torch/utils/lockcheck.py) costs
on one card's host, off and on.

    python3 tools/watchdog_cost.py [--rounds N]

Run from the repository's root on a machine with a CUDA card. It prints
one JSON line per measurement, each with the card's name and power limit:

  * ``lock``: nanoseconds per acquire and release (``with lk: pass``,
    best of 5 rounds of 1,000,000) of a plain ``threading.Lock``, a named
    lock with the watchdog off, and a named lock with it on;
  * ``phase5``: chip_smoke.py's concurrent-PUT phase once, watchdog off,
    with every named lock's acquires counted: acquires, kernel launches
    and wall seconds, and what the disabled watchdog's extra nanoseconds
    per acquire come to over the phase;
  * ``gray``: chip_smoke.py's gray-failure phase (21) 4 x N times
    (``--rounds``, default 1), the watchdog off, on, on, off in each
    round: each pass's OFF and ON PUT and GET p99 and its seconds; then
    once more, watchdog off, with every named lock's acquires counted.

It stops at the first failure with a non-zero exit, as chip_smoke.py
does.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS, PAIRS = 5, 1_000_000


def ns_per_pair(lk) -> float:
    """Best of ROUNDS: nanoseconds per `with lk: pass`."""
    best = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter_ns()
        for _ in range(PAIRS):
            with lk:
                pass
        best = min(best, (time.perf_counter_ns() - t0) / PAIRS)
    return best


def lock_costs(lockcheck) -> dict:
    out = {"plain_ns": ns_per_pair(threading.Lock())}
    for mode in ("off", "on"):
        os.environ["MINIO_TPU_LOCKCHECK"] = mode
        lockcheck.refresh()
        out[f"named_{mode}_ns"] = ns_per_pair(lockcheck.mutex("cost.probe"))
    os.environ.pop("MINIO_TPU_LOCKCHECK")
    lockcheck.refresh()
    lockcheck.reset()
    return {k: round(v, 1) for k, v in out.items()}


class Counted:
    """Counts every named lock's acquires while it is open (the watchdog
    stays as it is)."""

    def __init__(self, lockcheck):
        self.cls = lockcheck._CheckedLock
        self.plain = self.cls.acquire
        self.count = itertools.count()

    def __enter__(self) -> "Counted":
        plain, count = self.plain, self.count

        def counted(lk, *a, **kw):
            next(count)
            return plain(lk, *a, **kw)
        self.cls.acquire = counted
        return self

    def __exit__(self, *exc) -> None:
        self.cls.acquire = self.plain
        self.n = next(self.count)


def main() -> int:
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) \
        if "--rounds" in sys.argv else 1
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from minio_tpu_torch.object import engine as eng_mod
    from minio_tpu_torch.ops import (chacha20_cuda, highwayhash_cuda, kernels,
                                     rs_cuda, scan_cuda, sha256_cuda)
    from minio_tpu_torch.parallel.scheduler import BatchScheduler
    from minio_tpu_torch.utils import lockcheck, stagetimer

    card = cs.card_line()
    kernels.build()
    counts = cs.LaunchCounts(rs_cuda, highwayhash_cuda, sha256_cuda,
                             chacha20_cuda, scan_cuda)
    lock = lock_costs(lockcheck)
    cs.emit({"phase": "lock", **lock, "card": card})

    tmp = tempfile.mkdtemp(prefix="watchdog_cost_")
    try:
        extra_ns = lock["named_off_ns"] - lock["plain_ns"]
        # phase 5, watchdog off, every named lock's acquires counted
        sched = BatchScheduler()
        try:
            with Counted(lockcheck) as acquired:
                t0 = time.perf_counter()
                p5 = cs.run_concurrent_put(eng_mod, sched, stagetimer, tmp,
                                           card, counts, np)
                seconds = time.perf_counter() - t0
        finally:
            sched.close()
        n = acquired.n
        cs.emit({"phase": "phase5", "acquires": n,
                 "launches": sum(p5["launches"].values()),
                 "put_wall_s": p5["wall_s"], "seconds": round(seconds, 3),
                 "extra_ns_per_acquire": round(extra_ns, 1),
                 "extra_ms": round(n * extra_ns / 1e6, 3),
                 "extra_share": n * extra_ns / 1e9 / seconds,
                 "card": card})

        # phase 21: watchdog off, on, on, off in each round
        for i, mode in enumerate(("off", "on", "on", "off") * rounds):
            t0 = time.perf_counter()
            if mode == "on":
                with cs.Watchdog("gray", card):
                    g = cs.run_gray(tmp, card, counts, np)
            else:
                g = cs.run_gray(tmp, card, counts, np)
            cs.emit({"phase": "gray", "pass": i, "watchdog": mode,
                     "off_put_p99_ms": g["off"]["put"]["p99_ms"],
                     "on_put_p99_ms": g["on"]["put"]["p99_ms"],
                     "off_get_p99_ms": g["off"]["get"]["p99_ms"],
                     "on_get_p99_ms": g["on"]["get"]["p99_ms"],
                     "seconds": round(time.perf_counter() - t0, 3),
                     "card": card})
        with Counted(lockcheck) as acquired:
            t0 = time.perf_counter()
            cs.run_gray(tmp, card, counts, np)
            seconds = time.perf_counter() - t0
        cs.emit({"phase": "gray_acquires", "acquires": acquired.n,
                 "seconds": round(seconds, 3),
                 "extra_on_ns_per_acquire": round(
                     lock["named_on_ns"] - lock["plain_ns"], 1),
                 "card": card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
