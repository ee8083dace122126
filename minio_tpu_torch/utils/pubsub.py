"""In-process pub/sub hub: trace, event-journal and console-log streams
fan out to any number of subscribers; slow subscribers drop messages
rather than block publishers.

A copy of minio_tpu/utils/pubsub.py; nothing is left out.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional


class PubSub:
    def __init__(self, buffer: int = 1000):
        self._mu = threading.Lock()
        self._subs: list[queue.Queue] = []
        self.buffer = buffer

    def subscribe(self) -> "Subscription":
        q: queue.Queue = queue.Queue(maxsize=self.buffer)
        with self._mu:
            self._subs.append(q)
        return Subscription(self, q)

    def _unsubscribe(self, q: queue.Queue) -> None:
        with self._mu:
            try:
                self._subs.remove(q)
            except ValueError:
                pass

    def publish(self, item) -> None:
        with self._mu:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(item)
            except queue.Full:
                pass                    # slow subscriber: drop

    @property
    def subscriber_count(self) -> int:
        with self._mu:
            return len(self._subs)


class Subscription:
    def __init__(self, hub: PubSub, q: queue.Queue):
        self._hub = hub
        self._q = q

    def get(self, timeout: Optional[float] = None):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._hub._unsubscribe(self._q)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
