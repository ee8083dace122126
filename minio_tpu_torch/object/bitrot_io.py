"""Bitrot-framed shard I/O over StorageAPI.

Streaming algorithms (HighwayHash256S, the default) interleave a digest
before every shard block inside the shard file — ``[h(block) || block]*`` —
so reads verify incrementally without a separate checksum file (reference:
cmd/bitrot-streaming.go:46-58 writer, :111-150 reader). Whole-file
algorithms (sha256, blake2b, highwayhash256) hash the entire shard file and
store the digest in xl.meta's checksum list, one per drive
(cmd/bitrot-whole.go; minio_tpu/object/bitrot_io.py:126-150, 231-256).
"""

from __future__ import annotations

import io
from typing import Optional

from .. import bitrot as bitrot_mod
from ..storage import errors
from ..storage.api import StorageAPI

BitrotAlgorithm = bitrot_mod.BitrotAlgorithm


def new_bitrot_writer(disk: StorageAPI, volume: str, path: str,
                      length: int, algo: BitrotAlgorithm,
                      shard_size: int):
    """Factory mirroring reference newBitrotWriter (cmd/bitrot.go:99).
    `length` is the shard file's expected size (-1: unknown), unused by
    both writers, as in the reference."""
    if algo.streaming:
        return StreamingBitrotWriter(disk, volume, path, shard_size, algo)
    return WholeBitrotWriter(disk, volume, path, algo)


def new_bitrot_reader(disk: StorageAPI, volume: str, path: str,
                      till_offset: int, algo: BitrotAlgorithm,
                      expected_digest: bytes, shard_size: int):
    """Factory mirroring reference newBitrotReader (cmd/bitrot.go:105).
    `expected_digest` is the whole-file digest from xl.meta (ignored by
    streaming readers, whose digests live in the frames)."""
    if algo.streaming:
        return StreamingBitrotReader(disk, volume, path, till_offset,
                                     algo, shard_size)
    return WholeBitrotReader(disk, volume, path, algo, expected_digest,
                             shard_size)


class StreamingBitrotWriter:
    """Writes [digest || block] frames; every frame is exactly one shard
    block (the last may be short). A local drive takes them through its
    persistent append handle; a remote drive (no ``has_appender``) takes
    buffered batches through append_file, one RPC per FLUSH_THRESHOLD
    bytes of frames, not one per frame (reference
    minio_tpu/object/bitrot_io.py:51-105)."""

    FLUSH_THRESHOLD = 8 << 20  # bound writer memory on huge parts

    def __init__(self, disk: StorageAPI, volume: str, path: str,
                 shard_size: int, algo: BitrotAlgorithm):
        self.disk, self.volume, self.path = disk, volume, path
        self.shard_size, self.algo = shard_size, algo
        # opened lazily so writer construction never touches the drive
        # (per-drive faults must surface inside the write fan-out)
        self._file = None
        self._buf = io.BytesIO()
        self._started = False
        try:
            probe = getattr(disk, "has_appender", None)
            self._use_appender = bool(probe is not None and probe())
        except Exception:  # noqa: BLE001 — capability probe only
            self._use_appender = False

    def write(self, block) -> None:
        """Frame a block, digesting it on the host; an empty block writes
        no frame."""
        if len(block) == 0:
            return
        self.write_with_digest(
            block, bitrot_mod.hash_shard(bytes(block), self.algo))

    def write_with_digest(self, block, digest) -> None:
        """Frame a block whose digest was already computed (by the batched
        device or native hasher). Both may be views of a staging slot the
        caller recycles after this returns: the appender writes them out
        and the buffer copies them before returning."""
        if self._use_appender:
            try:
                if self._file is None:
                    self._file = self.disk.open_appender(self.volume,
                                                         self.path)
                self._file.write(digest)
                self._file.write(block)
            except OSError as e:
                raise errors.FaultyDisk(str(e)) from e
            return
        self._buf.write(digest)
        self._buf.write(block)
        if self._buf.tell() >= self.FLUSH_THRESHOLD:
            self._flush()

    def _flush(self) -> None:
        # a view of the buffer, not a copy; the first flush always goes
        # out, so a 0-byte object still commits an (empty) shard file
        data = self._buf.getbuffer()
        if not data.nbytes and self._started:
            return
        self.disk.append_file(self.volume, self.path, data)
        self._started = True
        del data
        self._buf = io.BytesIO()

    def close(self) -> None:
        if not self._use_appender:
            self._flush()
            return
        try:
            if self._file is None:
                # 0-byte objects still commit an (empty) shard file
                self._file = self.disk.open_appender(self.volume, self.path)
            self._file.close()
        except OSError as e:
            raise errors.FaultyDisk(str(e)) from e
        finally:
            self._file = None

    def digest(self) -> bytes:
        return b""  # streaming: digests live in the frames


class WholeBitrotWriter:
    """Buffers the whole shard file, hashing it as it grows, and writes it
    with one create_file at close; digest() is the whole-file digest the
    commit stores in this drive's xl.meta."""

    def __init__(self, disk: StorageAPI, volume: str, path: str,
                 algo: BitrotAlgorithm):
        self.disk, self.volume, self.path = disk, volume, path
        self.algo = algo
        self._hasher = bitrot_mod.new_hasher(algo)
        self._buf = io.BytesIO()

    def write(self, block) -> None:
        self._hasher.update(block)
        self._buf.write(block)

    def write_with_digest(self, block, digest) -> None:
        # a per-block digest from the batched hasher covers one block, not
        # the file: rehash into the running state (reference :138-141)
        self.write(block)

    def close(self) -> None:
        data = self._buf.getvalue()
        self.disk.create_file(self.volume, self.path, len(data),
                              io.BytesIO(data))

    def digest(self) -> bytes:
        return self._hasher.digest()


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


class WholeBitrotReader:
    """Reads the whole shard once, verifies the single digest, then serves
    positional reads from memory (reference wholeBitrotReader)."""

    def __init__(self, disk: StorageAPI, volume: str, path: str,
                 algo: BitrotAlgorithm, expected_digest: bytes,
                 shard_size: int):
        self.disk, self.volume, self.path = disk, volume, path
        self.algo, self.expected = algo, expected_digest
        self.shard_size = shard_size
        self._data: Optional[bytes] = None

    def read_at(self, offset: int, length: int) -> bytes:
        if self._data is None:
            data = self.disk.read_all(self.volume, self.path)
            if self.expected:
                got = bitrot_mod.hash_shard(data, self.algo)
                if got != self.expected:
                    raise errors.BitrotHashMismatch(
                        self.expected.hex(), got.hex())
            self._data = data
        return self._data[offset:offset + length]

    def close(self) -> None:
        self._data = None
