"""Foreground-pressure probe of the background movers.

Counterpart of minio_tpu/utils/pressure.py. The tier transition worker
(tier/transition.py) yields to foreground traffic: it backs off while a
live batch former shows queued blocks or the shared staging rings report
fresh waits, the two signals the admission gate sheds on.
"""

from __future__ import annotations

from typing import Callable, Optional

from . import backoff_delay


class ForegroundPressure:
    """Samples the batch formers' occupancy and the staging-ring waits of
    an object layer (ErasureServerSets, ErasureSets, or anything with
    ``sets``). ``busy_fn`` overrides the probe (tests, custom gating)."""

    def __init__(self, object_layer,
                 busy_fn: Optional[Callable[[], bool]] = None):
        self.obj = object_layer
        self._busy_fn = busy_fn
        self._last_pool_waits: Optional[int] = None

    def _layers(self):
        return getattr(self.obj, "server_sets", None) or [self.obj]

    def busy(self) -> bool:
        """True when foreground traffic is visibly queued: an engine's
        former holds blocks waiting for a device batch, or the staging
        rings counted new waits since the last sample."""
        if self._busy_fn is not None:
            return bool(self._busy_fn())
        queued = 0
        for z in self._layers():
            for eng in getattr(z, "sets", ()) or ():
                sched = getattr(eng, "scheduler", None)
                if sched is not None:
                    queued += sched.stats()["queued_blocks"]
        if queued > 0:
            return True
        from ..parallel import pipeline
        waits = pipeline.pool_pressure()["waits"]
        last, self._last_pool_waits = self._last_pool_waits, waits
        return last is not None and waits > last

    def throttle(self, stop_event, base_s: float, max_s: float,
                 tries: int) -> None:
        """Back off while busy, up to `tries` capped-exponential waits;
        then proceed anyway (a loaded node still makes background
        progress, at the slow cadence)."""
        for attempt in range(tries):
            if stop_event.is_set() or not self.busy():
                return
            stop_event.wait(backoff_delay(base_s, max_s, attempt))
