"""The port's pipelined data path on the CPU, modelled on
tests/test_pipeline.py: StagePipeline order and error propagation, the
staging rings, pipelined PUTs whose shard files are byte-identical to the
serial loop's and to minio_tpu's (with and without the batch former), and
the GET's one-group lookahead, healthy and degraded.

Six temp drives at 4+2 and 16 KiB blocks; the codec's size gate is lowered
so the fused device steps run on CPU tensors (the kernels' plain
versions). Tolerance 0: bytes. A fused encode or decode dispatch that
fails raises to the caller: no path carries on on the host.
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import time

import numpy as np
import pytest

from minio_tpu.object.sets import ErasureSets
from minio_tpu_torch.object import api_errors, codec, engine
from minio_tpu_torch.parallel import pipeline as pl
from minio_tpu_torch.parallel.scheduler import BatchScheduler
from minio_tpu_torch.storage.xl_storage import XLStorage

K, M, BS = 4, 2, 1 << 14


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(codec, "DEVICE_MIN_BYTES", 1024)
    monkeypatch.setattr(engine, "ENCODE_BATCH_BLOCKS", 2)
    monkeypatch.setattr(engine, "GET_BATCH_BLOCKS", 2)


def _payload(size, seed=7) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


def _engine(tmp_path, tag="d", **kw):
    paths = [str(tmp_path / f"{tag}{i}") for i in range(K + M)]
    eng = engine.from_reference_layout(paths, K, M, block_size=BS,
                                       device="cpu", **kw)
    eng.make_bucket("b")
    return eng, paths


def _read(eng, name):
    _, it = eng.get_object("b", name)
    return b"".join(it)


def _read_slowly(eng, name):
    """GET with a pause after each chunk, so every lookahead read has
    started on the prefetch pool before the stream asks for its group (a
    lookahead still queued is cancelled and read inline)."""
    out = []
    _, it = eng.get_object("b", name)
    for chunk in it:
        out.append(chunk)
        time.sleep(0.02)
    return b"".join(out)


def _shards(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if re.fullmatch(r"part\.\d+", f):
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                parts = rel.split(os.sep)
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.sep.join(parts[:-2] + [parts[-1]])] = fh.read()
    return out


# ---------------------------------------------------------------------------
# StagePipeline and the staging rings
# ---------------------------------------------------------------------------

def test_stage_pipeline_preserves_order():
    seen: list[int] = []
    pipe = pl.StagePipeline([lambda x: x * 10, seen.append], depth=2)
    for i in range(50):
        pipe.submit(i)
    pipe.close()
    assert seen == [i * 10 for i in range(50)]


def test_stage_pipeline_raises_original_error_and_drops():
    class Boom(RuntimeError):
        pass

    dropped: list = []

    def stage2(x):
        if x == 3:
            raise Boom("writer died")

    pipe = pl.StagePipeline([lambda x: x, stage2], depth=1,
                            on_drop=dropped.append)
    with pytest.raises(Boom):
        for i in range(100):
            pipe.submit(i)
    assert pipe.failed
    pipe.close(abort=True)          # must not re-raise
    assert dropped


def test_stage_pipeline_close_reraises_tail_error():
    class Boom(RuntimeError):
        pass

    def stage(x):
        raise Boom("late failure")

    pipe = pl.StagePipeline([stage], depth=4)
    pipe.submit(1)
    with pytest.raises(Boom):
        pipe.close()


def test_staging_pool_is_shared_per_width(monkeypatch):
    monkeypatch.setattr(pl, "POOL_BUFFERS", pl.POOL_BUFFERS)
    a = pl.staging_pool(12345)
    assert pl.staging_pool(12345) is a and a.width == 12345
    assert not a.pinned and pl.staging_pool(12345, pinned=True) is not a
    assert pl.pool_pressure()["rings"] >= 2
    assert pl.configure_pool_buffers(3) >= 4


# ---------------------------------------------------------------------------
# pipelined PUT
# ---------------------------------------------------------------------------

def test_pipelined_put_roundtrip_sizes(tmp_path, small):
    """Zero-byte, single-block, short-last-block and multi-batch objects
    through the pipelined loop (an unknown length skips the fits-one-batch
    serial shortcut)."""
    eng, _ = _engine(tmp_path)
    for size in [0, 1, 100, BS - 1, BS, BS + 1, 2 * BS, 5 * BS + 12345]:
        data = _payload(size, seed=size)
        oi = eng.put_object("b", f"o{size}", io.BytesIO(data), size=-1)
        assert oi.size == size
        assert oi.etag == hashlib.md5(data).hexdigest()
        assert _read(eng, f"o{size}") == data, size
    data = _payload(4 * BS, seed=99)           # known size, batch multiple
    eng.put_object("b", "exact", data)
    assert _read(eng, "exact") == data


@pytest.mark.parametrize("with_scheduler", [False, True])
def test_pipelined_shards_identical_to_serial_and_reference(
        tmp_path, small, monkeypatch, with_scheduler):
    objs = {f"obj{n}": _payload(n, seed=n)
            for n in (7 * BS, 9 * BS + 5, 2 * BS + 1)}
    sched = BatchScheduler(max_wait=0.001) if with_scheduler else None
    pipe_eng, pipe_paths = _engine(tmp_path, "p", scheduler=sched)
    before = pl.STATS.snapshot()
    try:
        for name, data in objs.items():
            pipe_eng.put_object("b", name, data)
    finally:
        if sched is not None:
            sched.close()
    after = pl.STATS.snapshot()
    assert after["put_streams"] == before["put_streams"] + len(objs)
    monkeypatch.setattr(pl, "ENABLED", False)
    serial_eng, serial_paths = _engine(tmp_path, "s")
    for name, data in objs.items():
        serial_eng.put_object("b", name, data)
    ref_paths = [str(tmp_path / f"r{i}") for i in range(K + M)]
    ref = ErasureSets.from_drives(ref_paths, set_count=1,
                                  set_drive_count=K + M, parity=M,
                                  block_size=BS)
    try:
        ref.make_bucket("b")
        for name, data in objs.items():
            ref.put_object("b", name, data)
    finally:
        ref.close()
    for i in range(K + M):
        got = _shards(os.path.join(pipe_paths[i], "b"))
        assert len(got) == len(objs)
        assert got == _shards(os.path.join(serial_paths[i], "b")), i
        assert got == _shards(os.path.join(ref_paths[i], "b")), i
    if with_scheduler:
        # the two short last blocks (5 and 1 bytes) stay under the gate
        st = sched.stats()["verbs"]["encode"]
        assert st["batches"] > 2 and st["host_routed"] == 2
    for name, data in objs.items():
        assert _read(pipe_eng, name) == data


def test_pipelined_put_records_overlap_stats(tmp_path, small):
    eng, _ = _engine(tmp_path)
    before = pl.STATS.snapshot()
    eng.put_object("b", "o", io.BytesIO(_payload(6 * BS)), size=-1)
    after = pl.STATS.snapshot()
    assert after["put_streams"] == before["put_streams"] + 1
    assert after["put_batches"] >= before["put_batches"] + 3
    assert after["put_wall_s"] > before["put_wall_s"]


class _FailingAppends(XLStorage):
    """A drive whose shard appends fail."""

    def open_appender(self, volume, path):
        raise OSError("drive write failed")


def test_pipelined_put_quorum_error_propagates(tmp_path, small):
    eng, paths = _engine(tmp_path)
    for i in range(3):                  # write quorum is 4 of 6
        eng.disks[i] = _FailingAppends(paths[i])
    pool = pl.staging_pool(engine.ENCODE_BATCH_BLOCKS * K * (BS // K))
    with pytest.raises(api_errors.InsufficientWriteQuorum):
        eng.put_object("b", "o", io.BytesIO(_payload(9 * BS)), size=-1)
    # every staging buffer went back to the ring
    assert pool._q.qsize() == pool._created


@pytest.mark.parametrize("serial", [False, True])
def test_failed_encode_dispatch_raises(tmp_path, small, monkeypatch,
                                       serial):
    def boom(*a, **kw):
        raise RuntimeError("encode dispatch failed on the device")

    monkeypatch.setattr(codec.Codec, "encode_and_hash_batch", boom)
    monkeypatch.setattr(codec.Codec, "encode_parity_batch",
                        lambda *a, **kw: pytest.fail("host fallback ran"))
    monkeypatch.setattr(pl, "ENABLED", not serial)
    sched = BatchScheduler(max_wait=0.001)
    eng, _ = _engine(tmp_path, scheduler=sched)
    try:
        with pytest.raises(RuntimeError, match="encode dispatch failed"):
            eng.put_object("b", "o", _payload(5 * BS))
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# GET lookahead
# ---------------------------------------------------------------------------

def test_get_prefetch_multigroup_roundtrip(tmp_path, small):
    eng, _ = _engine(tmp_path)
    data = _payload(9 * BS + 17, seed=9)
    eng.put_object("b", "o", data)
    before = pl.STATS.snapshot()
    assert _read_slowly(eng, "o") == data
    after = pl.STATS.snapshot()
    assert after["get_prefetched"] > before["get_prefetched"]
    _, it = eng.get_object("b", "o", offset=3 * BS + 5, length=4 * BS)
    assert b"".join(it) == data[3 * BS + 5:7 * BS + 5]


@pytest.mark.parametrize("with_scheduler", [False, True])
def test_get_prefetch_degraded_reconstructs(tmp_path, small,
                                            with_scheduler):
    """Two drives gone: every group reconstructs through the fused
    verify+decode step (the former's decode verb when there is one), the
    bytes equal the PUT, and the object is flagged for heal."""
    from minio_tpu_torch.storage.datatypes import hash_order
    eng, _ = _engine(tmp_path)
    data = _payload(8 * BS + 99, seed=11)
    eng.put_object("b", "o", data)
    dist = hash_order("b/o", K + M)
    gone = {dist.index(1), dist.index(2)}   # data shards 0 and 1
    sched = BatchScheduler(max_wait=0.001) if with_scheduler else None
    deg = engine.ErasureObjects(
        [None if i in gone else d for i, d in enumerate(eng.disks)],
        K, M, block_size=BS, device="cpu", scheduler=sched)
    flagged = []
    deg.on_degraded_read = lambda b, o: flagged.append((b, o))
    try:
        before = pl.STATS.snapshot()
        assert _read_slowly(deg, "o") == data
        assert pl.STATS.snapshot()["get_prefetched"] > \
            before["get_prefetched"]
    finally:
        if sched is not None:
            sched.close()
    assert flagged == [("b", "o")]
    if with_scheduler:
        st = sched.stats()["verbs"]["decode"]
        assert st["batches"] > 0 and st["blocks"] >= 8


def test_get_prefetch_off_is_serial(tmp_path, small, monkeypatch):
    monkeypatch.setattr(pl, "ENABLED", False)
    eng, _ = _engine(tmp_path)
    data = _payload(6 * BS, seed=3)
    eng.put_object("b", "o", data)
    before = pl.STATS.snapshot()
    assert _read(eng, "o") == data
    after = pl.STATS.snapshot()
    assert after["get_prefetched"] == before["get_prefetched"]
    assert after["get_groups"] > before["get_groups"]


def test_failed_decode_dispatch_raises(tmp_path, small, monkeypatch):
    eng, _ = _engine(tmp_path)
    eng.put_object("b", "o", _payload(4 * BS, seed=5))
    deg = engine.ErasureObjects([None] + eng.disks[1:], K, M,
                                block_size=BS, device="cpu")

    def boom(*a, **kw):
        raise RuntimeError("decode dispatch failed on the device")

    monkeypatch.setattr(codec.Codec, "verify_and_decode_batch", boom)
    monkeypatch.setattr(codec.Codec, "recover_stacked",
                        lambda *a, **kw: pytest.fail("host fallback ran"))
    with pytest.raises(RuntimeError, match="decode dispatch failed"):
        _read(deg, "o")
