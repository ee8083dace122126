"""The port's cross-request batch former (minio_tpu_torch.parallel.
scheduler) on the CPU, modelled on tests/test_scheduler.py: coalescing of
concurrent groups, max_batch splits, no head-of-line block across
geometries, an error fanned out to every waiter, declines, close, the
size gate, and the staging pool's back-pressure; the GET decipher verb
held against minio_tpu's xor_packages.

Coalesced encode/decode/recover outputs are held against minio_tpu's
codec (encode_and_hash_batch / verify_and_decode_batch /
verify_and_recover_batch, forced onto its device path, run on the JAX
CPU backend without Pallas) on the same seeded numpy inputs, tolerance 0.
The port's codec runs on CPU tensors (the kernels' plain versions) with
its size gate set to 0. Also: the launch, step and registry counters are
exact when 8 threads each make 50 calls.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from minio_tpu import bitrot as ref_bitrot
from minio_tpu.object.codec import Codec as RefCodec
from minio_tpu.ops import rs_ref, rs_tpu
from minio_tpu.parallel.scheduler import requests_budget as ref_budget
from minio_tpu_torch.bitrot import BitrotAlgorithm
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.codec import Codec
from minio_tpu_torch.ops import kernels, rs_matrix
from minio_tpu_torch.parallel.bpool import BytePool, BytePoolExhausted
from minio_tpu_torch.parallel.scheduler import (BatchScheduler,
                                                requests_budget)
from minio_tpu_torch.utils import telemetry

HH = BitrotAlgorithm.HIGHWAYHASH256S
RHH = ref_bitrot.BitrotAlgorithm.HIGHWAYHASH256S


@pytest.fixture(autouse=True)
def _jax_cpu_path():
    prev = rs_tpu.default_use_pallas()
    rs_tpu.set_default_use_pallas(False)
    yield
    rs_tpu.set_default_use_pallas(prev)


@pytest.fixture
def gate(monkeypatch):
    """The codec's size gate at 0: every batch takes the fused steps."""
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)


def _data(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _degraded(seed, b, k, m, s, lost):
    """(survivors in missing_data_matrix `used` order, mask, full)."""
    data = _data(seed, (b, k, s))
    full = np.stack([rs_ref.encode(blk, m) for blk in data])
    mask = sum(1 << i for i in range(k + m) if i not in lost)
    _dm, used, _missing = rs_matrix.missing_data_matrix(k, m, mask)
    return np.ascontiguousarray(full[:, list(used)]), mask, full


def _run_threads(jobs: dict) -> tuple[dict, list]:
    results, errs = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errs.append((name, e))

    threads = [threading.Thread(target=run, args=kv) for kv in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), f"{t.name} still running"
    return results, errs


def test_concurrent_encodes_coalesce_and_equal_reference(gate):
    sched = BatchScheduler(max_batch=64, max_wait=0.05)
    codec = Codec(4, 2, 4 * 512, device="cpu")
    inputs = [_data(i, (2, 4, 512)) for i in range(6)]
    outs, errs = _run_threads({
        i: (lambda x=x: sched.encode_and_hash(codec, x, HH))
        for i, x in enumerate(inputs)})
    sched.close()
    assert not errs, errs
    ref = RefCodec(4, 2, 4 * 512)
    for i, x in enumerate(inputs):
        parity, digests = outs[i]
        full, rdig = ref.encode_and_hash_batch(x, RHH, force="device")
        assert (parity == full[:, 4:]).all()
        assert (digests == np.asarray(rdig)).all()
    st = sched.stats()
    assert st["batches"] < len(inputs) and st["coalesced"] > 0
    assert st["dispatched_blocks"] == 12 and st["host_routed"] == 0


def test_concurrent_deciphers_coalesce_and_equal_reference():
    """GET decipher groups of three GETs (one package per row, under
    their own keys and nonces) share one dispatch; each GET gets its own
    rows back, equal to minio_tpu's xor_packages."""
    from minio_tpu.ops import chacha20_jax
    sched = BatchScheduler(max_batch=64, max_wait=0.05)
    rng = np.random.default_rng(31)
    groups = [(_data(40 + i, (n, 192)),
               rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64).astype(
                   np.uint32),
               rng.integers(0, 1 << 32, (n, 3), dtype=np.uint64).astype(
                   np.uint32)) for i, n in enumerate((2, 5, 1))]
    dev = torch.device("cpu")
    outs, errs = _run_threads({
        i: (lambda g=g: sched.submit_decipher(dev, *g).result())
        for i, g in enumerate(groups)})
    sched.close()
    assert not errs, errs
    for i, (rows, keys, nonces) in enumerate(groups):
        assert (outs[i] == chacha20_jax.xor_packages(rows, keys,
                                                     nonces)).all()
    st = sched.stats()["verbs"]["decipher"]
    assert st["batches"] < 3 and st["coalesced"] > 0 and st["blocks"] == 8
    assert sched.submit_decipher(dev, *groups[0]).result() is None


def test_max_batch_splits_dispatches(gate):
    sched = BatchScheduler(max_batch=3, max_wait=0.05)
    codec = Codec(4, 2, 4 * 256, device="cpu")
    inputs = [_data(10 + i, (2, 4, 256)) for i in range(4)]
    outs, errs = _run_threads({
        i: (lambda x=x: sched.encode_and_hash(codec, x, HH))
        for i, x in enumerate(inputs)})
    sched.close()
    assert not errs, errs
    for i, x in enumerate(inputs):
        want = codec.encode_and_hash_batch(x, HH)
        assert all((a == b).all() for a, b in zip(outs[i], want))
    st = sched.stats()
    # groups of 2 blocks never share a dispatch of at most 3
    assert st["batches"] == 4 and st["coalesced"] == 0
    assert st["dispatched_blocks"] == 8


def test_no_head_of_line_across_geometries(gate):
    """Buckets of three geometries dispatch in the SAME collector wakeup:
    one grace window in all, not one per geometry."""
    sched = BatchScheduler(max_batch=64, max_wait=0.4)
    geos = [(4, 2, 512), (6, 2, 256), (8, 4, 128)]
    codecs = [Codec(k, m, k * s, device="cpu") for k, m, s in geos]
    datas = [_data(20 + i, (2, k, s)) for i, (k, m, s) in enumerate(geos)]
    for c, d in zip(codecs, datas):      # warm the plain path first
        c.encode_and_hash_batch(d, HH)
    t0 = time.perf_counter()
    outs, errs = _run_threads({
        i: (lambda c=c, d=d: sched.encode_and_hash(c, d, HH))
        for i, (c, d) in enumerate(zip(codecs, datas))})
    elapsed = time.perf_counter() - t0
    sched.close()
    assert not errs and all(outs[i] is not None for i in range(3))
    assert elapsed < 0.4 * len(geos) - 0.05, \
        f"geometry buckets serialized: {elapsed:.2f}s"


def test_mixed_verbs_coalesce_and_equal_reference(gate):
    """Concurrent encode + decode + recover groups of two geometries:
    same-key groups share dispatches, and every verb's scatter equals
    minio_tpu's fused codec step on the same inputs."""
    sched = BatchScheduler(max_batch=64, max_wait=0.2)
    k, m, s = 4, 2, 256
    codec = Codec(k, m, k * s, device="cpu")
    codec6 = Codec(6, 2, 6 * 128, device="cpu")
    enc_in = [_data(30 + i, (2, k, s)) for i in range(2)]
    surv, mask, full = _degraded(31, 2, k, m, s, lost=(1, 4))
    rmask = mask
    _rec, used_r, _miss = rs_matrix.recover_matrix(k, m, rmask)
    rsurv = np.ascontiguousarray(full[:, list(used_r)])
    surv6, mask6, full6 = _degraded(32, 2, 6, 2, 128, lost=(0,))
    lost_rows = {1, 4}
    results, errs = _run_threads({
        "enc0": lambda: sched.encode_and_hash(codec, enc_in[0], HH),
        "enc1": lambda: sched.encode_and_hash(codec, enc_in[1], HH),
        "dec0": lambda: sched.submit_decode(
            codec, surv, mask, s, HH).result(60),
        "dec1": lambda: sched.submit_decode(
            codec, surv, mask, s, HH).result(60),
        "dec6": lambda: sched.submit_decode(
            codec6, surv6, mask6, 128, HH).result(60),
        "rec0": lambda: sched.submit_recover(
            codec, rsurv, rmask, lost_rows, s, HH).result(60),
    })
    sched.close()
    assert not errs, errs
    ref = RefCodec(k, m, k * s)
    for i in range(2):
        parity, dg = results[f"enc{i}"]
        rfull, rdg = ref.encode_and_hash_batch(enc_in[i], RHH,
                                               force="device")
        assert (parity == rfull[:, k:]).all() and (dg == rdg).all()
    want = ref.verify_and_decode_batch(surv, mask, s, RHH, force="device")
    for name in ("dec0", "dec1"):
        out, missing_idx, sdig = results[name]
        assert tuple(missing_idx) == tuple(want[1])
        assert (out == want[0]).all() and (sdig == want[2]).all()
    out6, midx6, _ = results["dec6"]
    assert (out6[:, 0] == full6[:, 0]).all() and tuple(midx6) == (0,)
    want = ref.verify_and_recover_batch(rsurv, rmask, lost_rows, s, RHH,
                                        force="device")
    rout, idxs, sdig, odig = results["rec0"]
    assert list(idxs) == list(want[1]) == sorted(lost_rows)
    for got, exp in ((rout, want[0]), (sdig, want[2]), (odig, want[3])):
        assert (got == np.asarray(exp)).all()
    assert (rout == full[:, sorted(lost_rows)]).all()
    st = sched.stats()["verbs"]
    assert st["decode"]["coalesced"] >= 1 and st["decode"]["batches"] < 3
    assert st["encode"]["batches"] >= 1 and st["recover"]["batches"] == 1


def test_dispatch_error_fans_out_to_every_waiter(gate, monkeypatch):
    sched = BatchScheduler(max_batch=64, max_wait=0.2)
    k, m, s = 4, 2, 128
    codec = Codec(k, m, k * s, device="cpu")
    surv, mask, _full = _degraded(40, 1, k, m, s, lost=(0,))

    def boom(*a, **kw):
        raise RuntimeError("decode device on fire")

    monkeypatch.setattr(Codec, "verify_and_decode_batch", boom)
    _res, errs = _run_threads({
        i: (lambda: sched.submit_decode(codec, surv, mask, s,
                                        HH).result(60))
        for i in range(3)})
    sched.close()
    assert sorted(str(e) for _n, e in errs) == ["decode device on fire"] * 3
    # one coalesced dispatch failed: every waiter holds its exception
    assert len({id(e) for _n, e in errs}) == 1


def test_declines_what_the_device_cannot_run():
    sched = BatchScheduler(max_wait=0.01)
    data = np.zeros((1, 4, 128), np.uint8)
    # blake2b has no device kernel, at any geometry
    for codec in (Codec(4, 2, 512, device="cpu"),
                  Codec(4, 3, 512, device="cpu")):
        fut = sched.submit(codec, data, BitrotAlgorithm.BLAKE2B512)
        assert fut.done() and fut.result() is None
    assert sched.stats()["declined"] == 2
    assert sched.stats()["batches"] == 0
    # sha256 has one (ops/sha256_cuda.py): it is not declined, and this
    # batch, below the size gate, dispatches to the host route
    fut = sched.submit(Codec(4, 2, 512, device="cpu"), data,
                       BitrotAlgorithm.SHA256)
    assert fut.result(60) is None
    st = sched.stats()
    assert st["declined"] == 2 and st["batches"] == 1
    assert st["host_routed"] == 1
    sched.close()


def test_below_the_size_gate_takes_the_local_path():
    sched = BatchScheduler(max_wait=0.01)
    codec = Codec(4, 2, 4 * 256, device="cpu")
    assert sched.encode_and_hash(codec, _data(5, (2, 4, 256)), HH) is None
    st = sched.stats()
    assert st["batches"] == 1 and st["host_routed"] == 1
    sched.close()


def test_close_with_pending_resolves_waiters_to_none(gate):
    sched = BatchScheduler(max_batch=64, max_wait=30.0)
    codec = Codec(4, 2, 4 * 128, device="cpu")
    data = np.zeros((1, 4, 128), np.uint8)
    fut = sched.submit(codec, data, HH)
    assert not fut.done()          # parked in the 30 s grace window
    t0 = time.perf_counter()
    sched.close()
    assert fut.result(timeout=5) is None
    assert time.perf_counter() - t0 < 10
    assert not sched._thread.is_alive()
    assert sched.submit(codec, data, HH).result() is None


def test_full_bucket_dispatches_immediately(gate):
    codec = Codec(4, 2, 4 * 256, device="cpu")
    data = _data(21, (4, 4, 256))
    codec.encode_and_hash_batch(data, HH)
    sched = BatchScheduler(max_batch=4, max_wait=5.0)
    try:
        t0 = time.perf_counter()
        assert sched.encode_and_hash(codec, data, HH) is not None
        assert time.perf_counter() - t0 < 2.0
    finally:
        sched.close()


def test_counts_exact_under_threads(gate):
    """8 threads x 50 calls each: the kernels' launch counter, the codec's
    step counts and the registry's counters add up exactly."""

    def counted():
        pass

    counted.launches = 0
    codec_mod.reset_step_seconds()
    codec = Codec(4, 2, 4 * 64, device="cpu")
    data = _data(7, (1, 4, 64))
    ctr = telemetry.REGISTRY.counter("minio_tpu_test_exact_total")
    hist = telemetry.REGISTRY.histogram("minio_tpu_test_exact_seconds")
    base = ctr.value(verb="encode")
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        for _ in range(50):
            kernels.count_launch(counted)
            assert codec.encode_parity_batch(data).shape == (1, 2, 64)
            ctr.inc(verb="encode")
            hist.observe(0.001, verb="encode")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)      # switch threads very often
    try:
        _res, errs = _run_threads({i: worker for i in range(8)})
    finally:
        sys.setswitchinterval(prev)
    assert not errs, errs
    assert counted.launches == 400
    assert codec_mod.step_seconds()["encode"]["calls"] == 400
    assert ctr.value(verb="encode") == base + 400
    assert hist.count(verb="encode") == 400


def test_bytepool_backpressure():
    pool = BytePool(1024, 2)
    a, b = pool.get(), pool.get()
    with pytest.raises(BytePoolExhausted):
        pool.get(timeout=0.05)
    assert pool.exhausted == 1 and pool.waits >= 1
    pool.put(a)
    c = pool.get(timeout=1.0)
    assert c is a and len(c) == 1024 and c.dtype == np.uint8
    with pytest.raises(ValueError):
        pool.put(np.zeros(5, np.uint8))   # foreign width: rejected
    pool.put(b)
    pool.put(c)


def test_requests_budget_equals_reference():
    n = requests_budget(1 << 22, 16)
    assert n == ref_budget(1 << 22, 16) and n >= 8
    assert requests_budget(1 << 26, 16) <= n
