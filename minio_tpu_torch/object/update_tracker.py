"""Data-update tracker: bloom-filtered "what changed since cycle N"
hints for the heal scanner.

Counterpart of minio_tpu/object/update_tracker.py, whole (reference
cmd/data-update-tracker.go:63-103): every object mutation marks a bloom
filter; each scan cycle rotates the current filter into a bounded
history, and a scanner asks "could this path have changed since my last
cycle?" to skip unchanged work. False positives only cost a rescan, never
correctness.

numpy bit-array bloom with double hashing (two independent sha256-based
hashes combined k times — standard Kirsch-Mitzenmacher), persisted
atomically so the history survives restart. The file's bytes are the
reference's, so either package reads the other's.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
from typing import Optional

import numpy as np

from ..utils import atomicfile

M_BITS = 1 << 20          # 128 KiB per filter
K_HASHES = 7              # ~1e-4 fp at ~10k entries, fine to 100k
MAX_HISTORY = 16          # cycles kept (reference dataUpdateTrackerHistory)


def _hashes(path: str) -> list[int]:
    d = hashlib.sha256(path.encode()).digest()
    h1 = int.from_bytes(d[:8], "big")
    h2 = int.from_bytes(d[8:16], "big") | 1
    return [(h1 + i * h2) % M_BITS for i in range(K_HASHES)]


class _Bloom:
    def __init__(self, bits: Optional[np.ndarray] = None):
        self.bits = bits if bits is not None else np.zeros(
            M_BITS // 8, dtype=np.uint8)

    def add(self, path: str) -> None:
        for h in _hashes(path):
            self.bits[h >> 3] |= np.uint8(1 << (h & 7))

    def contains(self, path: str) -> bool:
        return all(self.bits[h >> 3] & (1 << (h & 7))
                   for h in _hashes(path))

    @property
    def empty(self) -> bool:
        return not self.bits.any()


class DataUpdateTracker:
    """Current-cycle filter + rotated history, persisted to one file."""

    def __init__(self, path: str = ""):
        self.path = path
        self._mu = threading.Lock()
        self.cycle = 1
        self._current = _Bloom()
        self._history: dict[int, _Bloom] = {}   # cycle -> filter
        if path:
            self._load()

    # -- mutation side (object write path) ---------------------------------

    def mark(self, bucket: str, object_name: str = "") -> None:
        """Record a mutation. Both the full path and the bucket alone
        are marked, so scanners can prune whole buckets."""
        with self._mu:
            self._current.add(bucket)
            if object_name:
                self._current.add(f"{bucket}/{object_name}")

    # -- scanner side ------------------------------------------------------

    def current_cycle(self) -> int:
        return self.cycle

    def advance_cycle(self) -> int:
        """Rotate the current filter into history and start a fresh
        cycle (the crawler calls this once per full scan). Returns the
        NEW cycle number."""
        with self._mu:
            self._history[self.cycle] = self._current
            self._current = _Bloom()
            self.cycle += 1
            for c in sorted(self._history):
                if c < self.cycle - MAX_HISTORY:
                    del self._history[c]
            self._persist_locked()
            return self.cycle

    def changed_since(self, cycle: int, bucket: str,
                      object_name: str = "") -> bool:
        """Could this path have been mutated at/after `cycle`? True on
        any bloom hit in the relevant cycles or when the history no
        longer reaches back that far (unknown => assume changed)."""
        path = f"{bucket}/{object_name}" if object_name else bucket
        with self._mu:
            if cycle < self.cycle - MAX_HISTORY or cycle < 1:
                return True            # history gone: must rescan
            if self._current.contains(path):
                return True
            return any(self._history[c].contains(path)
                       for c in self._history if c >= cycle)

    # -- cluster fan-in (peer plane) ---------------------------------------

    def rotate_snapshot(self) -> dict:
        """Advance the cycle and export every retained filter — the
        peer-RPC payload the leader's HealScanner pulls each pass so
        mutations through OTHER nodes' S3 endpoints are never missed
        (each process tracks only its own funnel)."""
        self.advance_cycle()
        with self._mu:
            return {"cycle": self.cycle,
                    "filters": {str(c): base64.b64encode(
                        f.bits.tobytes()).decode()
                        for c, f in self._history.items()
                        if not f.empty}}

    # -- persistence -------------------------------------------------------

    def _persist_locked(self) -> None:
        if not self.path:
            return
        blob = {
            "cycle": self.cycle,
            "history": {str(c): base64.b64encode(
                f.bits.tobytes()).decode()
                for c, f in self._history.items() if not f.empty},
        }
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # the shared commit recipe (utils/atomicfile)
        atomicfile.write_atomic(self.path, json.dumps(blob).encode())

    def flush(self) -> None:
        with self._mu:
            self._persist_locked()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(blob, dict):
            return      # torn write truncated to a non-dict JSON prefix
        self.cycle = int(blob.get("cycle", 1))
        for c, b64 in blob.get("history", {}).items():
            bits = np.frombuffer(base64.b64decode(b64),
                                 dtype=np.uint8).copy()
            if bits.size == M_BITS // 8:
                self._history[int(c)] = _Bloom(bits)


class TrackerSnapshot:
    """Query wrapper over a rotate_snapshot() payload (possibly from a
    remote node). Decodes filters lazily, once."""

    def __init__(self, snap: dict):
        self.cycle = int(snap.get("cycle", 1))
        self._raw = dict(snap.get("filters", {}))
        self._filters: dict[int, _Bloom] = {}

    def _filter(self, c: int) -> Optional[_Bloom]:
        if c not in self._filters:
            raw = self._raw.get(str(c))
            if raw is None:
                return None
            bits = np.frombuffer(base64.b64decode(raw),
                                 dtype=np.uint8).copy()
            self._filters[c] = _Bloom(bits) \
                if bits.size == M_BITS // 8 else _Bloom()
        return self._filters[c]

    def changed_since(self, cycle: int, bucket: str,
                      object_name: str = "") -> bool:
        path = f"{bucket}/{object_name}" if object_name else bucket
        if cycle < self.cycle - MAX_HISTORY or cycle < 1:
            return True                # history gone: assume changed
        for c in range(max(cycle, 1), self.cycle):
            f = self._filter(c)
            if f is not None and f.contains(path):
                return True
        return False
