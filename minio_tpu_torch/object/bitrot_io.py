"""Bitrot-framed shard I/O over StorageAPI.

The streaming algorithm (HighwayHash256S, the default) interleaves a digest
before every shard block inside the shard file — ``[h(block) || block]*`` —
so reads verify incrementally without a separate checksum file (reference:
cmd/bitrot-streaming.go:46-58 writer, :111-150 reader). Whole-file
algorithms are not ported yet.
"""

from __future__ import annotations

from .. import bitrot as bitrot_mod
from ..storage import errors
from ..storage.api import StorageAPI

BitrotAlgorithm = bitrot_mod.BitrotAlgorithm


def _require_streaming(algo: BitrotAlgorithm) -> None:
    if not algo.streaming:
        raise NotImplementedError(
            f"bitrot algorithm {algo.value!r}: only streaming framing is "
            "ported")


def new_bitrot_writer(disk: StorageAPI, volume: str, path: str,
                      algo: BitrotAlgorithm, shard_size: int):
    """Factory mirroring reference newBitrotWriter (cmd/bitrot.go:99)."""
    _require_streaming(algo)
    return StreamingBitrotWriter(disk, volume, path, shard_size, algo)


def new_bitrot_reader(disk: StorageAPI, volume: str, path: str,
                      till_offset: int, algo: BitrotAlgorithm,
                      shard_size: int):
    """Factory mirroring reference newBitrotReader (cmd/bitrot.go:105)."""
    _require_streaming(algo)
    return StreamingBitrotReader(disk, volume, path, till_offset, algo,
                                 shard_size)


class StreamingBitrotWriter:
    """Writes [digest || block] frames into a persistent append handle;
    every frame is exactly one shard block (the last may be short)."""

    def __init__(self, disk: StorageAPI, volume: str, path: str,
                 shard_size: int, algo: BitrotAlgorithm):
        self.disk, self.volume, self.path = disk, volume, path
        self.shard_size, self.algo = shard_size, algo
        # opened lazily so writer construction never touches the drive
        # (per-drive faults must surface inside the write fan-out)
        self._file = None

    def write(self, block) -> None:
        """Frame a block, digesting it on the host."""
        self.write_with_digest(
            block, bitrot_mod.hash_shard(bytes(block), self.algo))

    def write_with_digest(self, block, digest) -> None:
        """Frame a block whose digest was already computed (by the batched
        device or native hasher)."""
        try:
            if self._file is None:
                self._file = self.disk.open_appender(self.volume, self.path)
            self._file.write(digest)
            self._file.write(block)
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e

    def close(self) -> None:
        try:
            if self._file is None:
                # 0-byte objects still commit an (empty) shard file
                self._file = self.disk.open_appender(self.volume, self.path)
            self._file.close()
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        finally:
            self._file = None


class StreamingBitrotReader:
    """Positional reads of shard blocks.

    offset/length are in *payload* coordinates; the frame location on disk
    is derived from the shard size (cmd/bitrot-streaming.go:111-150)."""

    def __init__(self, disk: StorageAPI, volume: str, path: str,
                 till_offset: int, algo: BitrotAlgorithm, shard_size: int):
        self.disk, self.volume, self.path = disk, volume, path
        self.algo, self.shard_size = algo, shard_size
        # till_offset is in payload coords; on-disk adds digest framing
        self.till_offset = bitrot_mod.bitrot_shard_file_size(
            till_offset, shard_size, algo)
        self._stream = None
        self._pos = -1  # next on-disk offset the stream will yield

    def read_at(self, offset: int, length: int) -> bytes:
        """Read payload bytes [offset, offset+length), verifying every
        frame on the host before returning."""
        out = bytearray()
        for digest, block in self.read_frames(offset, length):
            got = bitrot_mod.hash_shard(block, self.algo)
            if got != digest:
                raise errors.BitrotHashMismatch(digest.hex(), got.hex())
            out += block
        return bytes(out)

    def read_frames(self, offset: int, length: int
                    ) -> list[tuple[bytes, bytes]]:
        """Raw (expected_digest, payload) frames WITHOUT verifying — the
        deferred-verify seam: the engine batches many shards' frames into
        one device step that hashes and reconstructs together
        (models/pipeline.get_step), then compares digests host-side."""
        if length == 0:
            return []
        if offset % self.shard_size:
            raise errors.UnexpectedError(
                f"unaligned bitrot read at {offset}")
        block_idx = offset // self.shard_size
        disk_off = block_idx * (self.algo.digest_size + self.shard_size)
        if self._stream is None or disk_off != self._pos:
            if self._stream is not None:
                self._stream.close()
            self._stream = self.disk.read_file_stream(
                self.volume, self.path, disk_off,
                self.till_offset - disk_off)
            self._pos = disk_off

        frames: list[tuple[bytes, bytes]] = []
        remaining = length
        while remaining > 0:
            digest = self._read_exact(self.algo.digest_size)
            n = min(self.shard_size, remaining)
            block = self._read_exact(n)
            self._pos += self.algo.digest_size + n
            frames.append((digest, block))
            remaining -= n
        return frames

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._stream.read(n - len(buf))
            if not chunk:
                raise errors.FileCorrupt(
                    f"{self.path}: truncated bitrot frame")
            buf += chunk
        return buf

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

