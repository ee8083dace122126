"""Atomic file commits with optional fsync/dirsync discipline.

Every raw-file commit follows one recipe: write a temp sibling, then
atomically ``os.replace`` it over the final name. Without an fsync barrier
before the rename and a directory fsync after it, a power cut can surface
the rename while the data blocks are still unwritten, so the barriers
follow ``MINIO_TPU_FSYNC`` (the reference's default: off), read at call
time.
"""

from __future__ import annotations

import json
import os
import uuid as _uuid
from typing import Optional

from . import knobs


def fsync_enabled() -> bool:
    """fsync barriers on commit paths (MINIO_TPU_FSYNC, default off)."""
    return knobs.get_bool("MINIO_TPU_FSYNC")


def fsync_file(f) -> None:
    """Flush + fsync an open file object (or raw fd) when the
    discipline is on. Best-effort on filesystems that refuse."""
    if not fsync_enabled():
        return
    try:
        if hasattr(f, "flush"):
            f.flush()
        os.fsync(f.fileno() if hasattr(f, "fileno") else f)
    except OSError:
        pass


def fsync_dir(path: str) -> None:
    """fsync the DIRECTORY so a just-committed rename survives power
    loss (the rename itself lives in the directory's data blocks)."""
    if not fsync_enabled():
        return
    try:
        dfd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def write_atomic(path: str, data: bytes) -> None:
    """write-temp → (fsync) → rename → (dirsync): the one sanctioned
    raw-file commit. Cleans up the temp on any failure. Callers map
    OSError to their own error taxonomy."""
    tmp = path + "." + _uuid.uuid4().hex[:8] + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            fsync_file(f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path) or ".")


def load_json_doc(raw: bytes) -> Optional[dict]:
    """Parse a persisted JSON document tolerantly: a torn/truncated
    file (crash inside the write) or a valid-JSON-but-wrong-type
    prefix (``b"12"`` from a truncated ``{"epoch": 12, ...}`` would
    parse as an int) returns None — the caller falls back to its
    previous copy — instead of raising into a boot path."""
    try:
        doc = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    return doc if isinstance(doc, dict) else None
