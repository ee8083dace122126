"""In-memory console log ring, served to `mc admin console` through the
admin ``consolelog`` route and the peer ``console-log`` verb.

A copy of minio_tpu/utils/console.py. One ring per process: subsystems
log through the standard ``logging`` machinery (a handler bridges the
``minio_tpu_torch`` logger tree in) or the direct ``log_line()``; the
admin and peer planes read ``recent()`` and merge rings across nodes.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Optional


class ConsoleLogSys(logging.Handler):
    def __init__(self, capacity: int = 1000, node: str = ""):
        super().__init__()
        self.node = node
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=capacity)
        self._mu = threading.Lock()

    # -- logging.Handler bridge -------------------------------------------

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = record.getMessage()
        except Exception:  # noqa: BLE001 — logging must never throw
            msg = str(record.msg)
        self.log_line(record.levelname, msg)

    # -- direct API --------------------------------------------------------

    def log_line(self, level: str, message: str) -> None:
        entry = {"time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime()),
                 "ts": time.time(), "level": level,
                 "node": self.node, "message": message}
        with self._mu:
            self._ring.append(entry)

    def recent(self, n: int = 0) -> list[dict]:
        with self._mu:
            entries = list(self._ring)
        return entries[-n:] if n else entries

    def install(self, logger_name: str = "minio_tpu_torch",
                level: int = logging.INFO) -> None:
        lg = logging.getLogger(logger_name)
        if self not in lg.handlers:
            lg.addHandler(self)
        if lg.level == logging.NOTSET or lg.level > level:
            lg.setLevel(level)


_console: Optional[ConsoleLogSys] = None
_mu = threading.Lock()


def get_console() -> ConsoleLogSys:
    """Process-wide ring (lazily created, handler installed on the
    minio_tpu_torch logger tree)."""
    global _console
    with _mu:
        if _console is None:
            _console = ConsoleLogSys()
            _console.install()
        return _console
