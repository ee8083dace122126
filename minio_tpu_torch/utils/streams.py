"""Shared stream adapters.

IterStream is the single home of the file-like-over-chunk-iterator
shim that the rebalancer, the tier transition worker, and the S3
handlers all need (each previously carried its own copy): buffer the
iterator, serve .read(n), forward close() to the source so abandoned
generators release their locks.
"""

from __future__ import annotations

from typing import Iterator


class IterStream:
    """File-like adapter over an iterator of byte chunks."""

    def __init__(self, it: Iterator[bytes]):
        self._it = it
        self._buf = b""
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            try:
                self._buf += next(self._it)
            except StopIteration:
                self._eof = True
        if n < 0:
            out, self._buf = self._buf, b""
        else:
            out, self._buf = self._buf[:n], self._buf[n:]
        return bytes(out)

    def close(self) -> None:
        close = getattr(self._it, "close", None)
        if close is not None:
            close()
