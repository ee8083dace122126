"""The port's SSE data path on the CPU, held byte for byte against
minio_tpu: the fused steps (models/pipeline sse_put_step / sse_get_step)
at k = 4, m = 2 and 64 KiB blocks as tests/test_sse_device.py sizes them;
the codec and batch former (encrypted groups under different keys share
one dispatch); engine PUT under features/crypto.DeviceSSE, whose shard
files must equal the reference engine's and whose stored stream must equal
ChaChaEncryptor's; sealed keys and stored objects read across both
packages; chacha_decrypt_ranged over ranges and corrupted packages; and a
failed launch, which must raise out of put_object with no host cipher in
its place.

The port's codec runs on CPU tensors (the kernels' plain versions) with its
size gate at 0; the reference's fused steps run on the JAX CPU backend
without Pallas. Inputs come from numpy seeds; tolerance 0 (bytes).
"""

from __future__ import annotations

import base64
import hashlib
import io
import os
import threading

import numpy as np
import pytest

from minio_tpu import bitrot as ref_bitrot
from minio_tpu.features import crypto as ref_sse
from minio_tpu.features import kms as ref_kms
from minio_tpu.models import pipeline as ref_pipeline
from minio_tpu.object import ErasureSetObjects as RefEngine
from minio_tpu.object import codec as ref_codec_mod
from minio_tpu.object import engine as ref_engine
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.ops import rs_tpu
from minio_tpu.storage import XLStorage as RefXL
from minio_tpu.storage import new_format_erasure_v3 as ref_format
import torch

from minio_tpu_torch.bitrot import BitrotAlgorithm
from minio_tpu_torch.features import crypto as sse
from minio_tpu_torch.features import kms
from minio_tpu_torch.models import pipeline
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object import engine
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.ops import chacha20_cuda, rs_cuda, rs_matrix
from minio_tpu_torch.parallel.scheduler import BatchScheduler
from minio_tpu_torch.s3.s3errors import S3Error

K, M = 4, 2
BLOCK = 1 << 16
PKG = sse.PKG_SIZE
HH = BitrotAlgorithm.HIGHWAYHASH256S
RHH = ref_bitrot.BitrotAlgorithm.HIGHWAYHASH256S
OEK = bytes(range(32))
BASE = bytes(range(100, 112))
MASTER = bytes(range(200, 232))


@pytest.fixture(autouse=True)
def _jax_cpu_path():
    prev = rs_tpu.default_use_pallas()
    rs_tpu.set_default_use_pallas(False)
    yield
    rs_tpu.set_default_use_pallas(prev)


@pytest.fixture
def gate(monkeypatch):
    """The port codec's size gate at 0: every batch takes the fused steps
    (on CPU tensors, the plain versions); 4-block encode batches."""
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)
    monkeypatch.setattr(engine, "ENCODE_BATCH_BLOCKS", 4)


def _payload(n, seed):
    return np.random.default_rng(seed).bytes(n)


def _oracle(pt, oek=OEK, base=BASE):
    enc = sse.ChaChaEncryptor(oek, base)
    return enc.update(pt) + enc.finalize()


def _paths(tmp_path, tag):
    return [str(tmp_path / f"{tag}{i}") for i in range(K + M)]


def _port_engine(tmp_path, tag="p", **kw):
    eng = engine.from_reference_layout(_paths(tmp_path, tag), K, M,
                                       block_size=BLOCK, device="cpu", **kw)
    eng.make_bucket("b")
    return eng


def _ref_engine(tmp_path, tag="r"):
    fmts = ref_format(1, K + M)
    disks = []
    for j, path in enumerate(_paths(tmp_path, tag)):
        d = RefXL(path)
        d.write_format(fmts[0][j])
        disks.append(d)
    e = RefEngine(disks, K, M, block_size=BLOCK)
    e.make_bucket("b")
    return e


def _stored(layer, name):
    _, it = layer.get_object("b", name)
    return b"".join(it)


def _shard_files(root):
    """object/part.N -> bytes (the per-write data-dir uuid left out)."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.startswith("part."):
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                parts = rel.split(os.sep)
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.sep.join(parts[:-2] + [parts[-1]])] = fh.read()
    return out


def _words(keys, nonces):
    return (chacha20_cuda.words(keys, "cpu"),
            chacha20_cuda.words(nonces, "cpu"))


# -- the fused steps ----------------------------------------------------------

@pytest.mark.parametrize("block", [BLOCK, 2 * BLOCK])
def test_sse_put_step_equals_reference(block):
    rng = np.random.default_rng(block)
    b, s, p = 3, -(-block // K), block // PKG
    flat = np.zeros((b, K * s), np.uint8)
    flat[:, :block] = rng.integers(0, 256, (b, block), dtype=np.uint8)
    data = flat.reshape(b, K, s)
    keys = rng.integers(0, 1 << 32, (b, 8), dtype=np.uint32)
    nonces = rng.integers(0, 1 << 32, (b, p, 3), dtype=np.uint32)
    want_rows, want_dig = ref_pipeline.sse_put_step(data, keys, nonces, K, M,
                                                    PKG)
    rows, dig = pipeline.sse_put_step(torch.from_numpy(data.copy()),
                                      *_words(keys, nonces), K, M, PKG)
    assert np.array_equal(rows.numpy(), np.asarray(want_rows))
    assert np.array_equal(dig.numpy(), np.asarray(want_dig))
    # pad columns past the plaintext span stay zero
    assert not rows.numpy()[:, :K].reshape(b, -1)[:, block:].any()


@pytest.mark.parametrize("lost", [(1,), (0, 3), (2, 5)])
def test_sse_get_step_equals_reference(lost):
    rng = np.random.default_rng(sum(lost))
    b, s = 2, BLOCK // K
    data = rng.integers(0, 256, (b, K, s), dtype=np.uint8)
    keys = rng.integers(0, 1 << 32, (b, 8), dtype=np.uint32)
    nonces = rng.integers(0, 1 << 32, (b, 1, 3), dtype=np.uint32)
    full, _ = pipeline.sse_put_step(torch.from_numpy(data),
                                    *_words(keys, nonces), K, M, PKG)
    full = full.numpy()
    mask = sum(1 << i for i in range(K + M) if i not in lost)
    dm, used, missing = rs_matrix.missing_data_matrix(K, M, mask)
    surv = np.ascontiguousarray(full[:, list(used)])
    data_src = tuple((0, used.index(j)) if j in used
                     else (1, missing.index(j)) for j in range(K))
    m2 = rs_tpu._bit_expand_cached(dm.tobytes(), dm.shape)
    want = ref_pipeline.sse_get_step(surv, m2, keys, nonces, dm.shape[0], K,
                                     data_src, PKG, s)
    got = pipeline.sse_get_step(torch.from_numpy(surv.copy()),
                                rs_cuda.matrix_bits(dm, "cpu"),
                                *_words(keys, nonces), dm.shape[0], K,
                                data_src, PKG, s)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0].numpy(), data)


# -- codec and batch former ---------------------------------------------------

def test_two_encrypted_puts_share_one_dispatch(gate):
    """Concurrent encrypted groups under DIFFERENT keys coalesce into one
    dispatch; each group's rows equal the reference codec's under its own
    key."""
    sched = BatchScheduler(max_wait=0.2)
    codec = codec_mod.Codec(K, M, BLOCK, device="cpu")
    ref = ref_codec_mod.Codec(K, M, BLOCK)
    rng = np.random.default_rng(21)
    specs = [sse.DeviceSSE(rng.bytes(32), rng.bytes(12)) for _ in range(2)]
    datas = [rng.integers(0, 256, (2, K, codec.shard_size), dtype=np.uint8)
             for _ in range(2)]
    outs = [None, None]
    barrier = threading.Barrier(2)

    def put(i):
        kn = specs[i].batch_params(0, 2, BLOCK)
        barrier.wait()
        outs[i] = sched.submit(codec, datas[i], HH,
                               sse=(kn[0], kn[1], PKG)).result(timeout=60)

    try:
        b0, c0 = sched.batches, sched.coalesced
        threads = [threading.Thread(target=put, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert sched.batches - b0 == 1 and sched.coalesced - c0 == 1
        assert sched.host_routed == 0
    finally:
        sched.close()
    for i in range(2):
        kn = specs[i].batch_params(0, 2, BLOCK)
        want = ref.encrypt_encode_and_hash_batch(datas[i], kn[0], kn[1], PKG,
                                                 RHH, force="device")
        assert np.array_equal(outs[i][0], want[0])
        assert np.array_equal(outs[i][1], want[1])


def test_decode_decrypt_through_the_former_equals_reference(gate):
    rng = np.random.default_rng(31)
    codec = codec_mod.Codec(K, M, BLOCK, device="cpu")
    ref = ref_codec_mod.Codec(K, M, BLOCK)
    spec = sse.DeviceSSE(rng.bytes(32), rng.bytes(12))
    keys, nonces = spec.batch_params(0, 3, BLOCK)
    data = rng.integers(0, 256, (3, K, codec.shard_size), dtype=np.uint8)
    full, _ = codec.encrypt_encode_and_hash_batch(data, keys, nonces, PKG,
                                                  HH)
    mask = sum(1 << i for i in range(K + M) if i not in (0, 2))
    _dm, used, _missing = rs_matrix.missing_data_matrix(K, M, mask)
    surv = np.ascontiguousarray(full[:, list(used)])
    sched = BatchScheduler()
    try:
        got = sched.submit_decode(codec, surv, mask, codec.shard_size, HH,
                                  sse=(keys, nonces, PKG)).result(timeout=60)
        assert sched.verb_stats["decode"]["batches"] == 1
    finally:
        sched.close()
    want = ref.verify_decode_decrypt_batch(surv, mask, codec.shard_size,
                                           keys, nonces, PKG, RHH,
                                           force="device")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert np.array_equal(got[2], want[2])
    assert np.array_equal(got[0], data)


# -- engine PUT under DeviceSSE -----------------------------------------------

@pytest.mark.parametrize("n,known", [(3 * BLOCK + 17, True),
                                     (8 * BLOCK, True),
                                     (9 * BLOCK + PKG // 2 + 5, False)])
def test_engine_put_equals_reference_and_oracle(tmp_path, gate, n, known):
    """A short tail (serial loop), an exact batch multiple, and an unknown
    size (pipelined loop): the stored stream equals ChaChaEncryptor's, the
    shard files equal the reference engine's, drive for drive."""
    pt = _payload(n, n)
    port, ref = _port_engine(tmp_path), _ref_engine(tmp_path)
    for layer, crypto, eng_mod in ((port, sse, engine),
                                   (ref, ref_sse, ref_engine)):
        opts = eng_mod.PutOptions(sse_spec=crypto.DeviceSSE(OEK, BASE))
        if known:
            info = layer.put_object("b", "o", pt, opts=opts)
        else:
            info = layer.put_object("b", "o", io.BytesIO(pt), size=-1,
                                    opts=opts)
        assert info.size == sse.encrypted_size(n)
        assert info.etag == hashlib.md5(pt).hexdigest()
    assert _stored(port, "o") == _oracle(pt) == _stored(ref, "o")
    for i, (p, r) in enumerate(zip(_paths(tmp_path, "p"),
                                   _paths(tmp_path, "r"))):
        got, want = _shard_files(p), _shard_files(r)
        assert got and got == want, f"drive {i}"


def test_engine_put_through_the_former(tmp_path, gate):
    sched = BatchScheduler()
    try:
        eng = _port_engine(tmp_path, scheduler=sched)
        pt = _payload(6 * BLOCK + 99, 3)
        eng.put_object("b", "o", pt, opts=engine.PutOptions(
            sse_spec=sse.DeviceSSE(OEK, BASE)))
        assert _stored(eng, "o") == _oracle(pt)
        enc = sched.verb_stats["encode"]
        # two batches of full blocks (4 + 2), which the former may merge
        assert enc["blocks"] == 6 and enc["host_routed"] == 0
    finally:
        sched.close()


def test_host_routed_batch_ciphers_on_the_host(tmp_path, monkeypatch):
    # below the codec's size gate the batch stays on the host (the
    # reference's routing): same bytes, and no step runs
    monkeypatch.setattr(engine, "ENCODE_BATCH_BLOCKS", 4)
    monkeypatch.setattr(pipeline, "sse_put_step", None)
    eng = _port_engine(tmp_path)
    pt = _payload(5 * BLOCK + 3, 4)
    eng.put_object("b", "o", pt, opts=engine.PutOptions(
        sse_spec=sse.DeviceSSE(OEK, BASE)))
    assert _stored(eng, "o") == _oracle(pt)


@pytest.mark.parametrize("with_former", [False, True])
def test_launch_error_raises_out_of_put_object(tmp_path, gate, monkeypatch,
                                               with_former):
    def boom(*a, **kw):
        raise RuntimeError("chacha20 launch: CUDA error 1")

    def host_cipher(*a, **kw):
        raise AssertionError("a failed dispatch fell back to the host "
                             "cipher")

    monkeypatch.setattr(chacha20_cuda, "keystream_xor", boom)
    monkeypatch.setattr(sse.DeviceSSE, "cpu_encrypt_rows", host_cipher)
    sched = BatchScheduler() if with_former else None
    try:
        eng = _port_engine(tmp_path, scheduler=sched)
        with pytest.raises(RuntimeError, match="chacha20 launch"):
            eng.put_object("b", "o", _payload(2 * BLOCK + 5, 5),
                           opts=engine.PutOptions(
                               sse_spec=sse.DeviceSSE(OEK, BASE)))
        with pytest.raises(Exception):
            eng.get_object_info("b", "o")
    finally:
        if sched is not None:
            sched.close()


def test_supports_sse_device(tmp_path):
    assert _port_engine(tmp_path).supports_sse_device
    odd = engine.from_reference_layout(_paths(tmp_path, "q"), K, M,
                                       block_size=BLOCK + 4096, device="cpu")
    assert not odd.supports_sse_device
    paths = [str(tmp_path / f"s{i}") for i in range(2 * (K + M))]
    sets = ErasureSets.from_drives(paths, 2, K + M, M, block_size=BLOCK,
                                   device="cpu")
    try:
        assert sets.supports_sse_device
    finally:
        sets.close()


# -- crypto helpers -----------------------------------------------------------

def test_batch_params_equal_reference():
    for off, rows, row_bytes in ((0, 3, PKG), (4 * PKG, 3, 2 * PKG),
                                 (PKG * 1000, 8, 16 * PKG)):
        got = sse.DeviceSSE(OEK, BASE).batch_params(off, rows, row_bytes)
        want = ref_sse.DeviceSSE(OEK, BASE).batch_params(off, rows,
                                                         row_bytes)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        p = row_bytes // PKG
        for i in range(rows):
            for j in range(p):
                assert got[1][i, j].astype("<u4").tobytes() == \
                    sse._pkg_nonce(BASE, off // PKG + i * p + j)


def test_setup_put_transforms_routes_as_reference(monkeypatch):
    from minio_tpu_torch.object.hash_reader import HashReader
    kms_ = kms.StaticKMS(MASTER)
    mib = 1 << 20

    def setup(size, **kw):
        md = {}
        args = dict(key_name="o", raw_reader=HashReader(io.BytesIO(b""), 0),
                    raw_size=size, metadata=md, ssec_key=None, sse_s3=True,
                    kms=kms_, compress=False)
        args.update(kw)
        return sse.setup_put_transforms(**args), md

    (r, size, spec), md = setup(mib, cipher=sse.CIPHER_CHACHA,
                                device_sse=True)
    assert isinstance(spec, sse.DeviceSSE) and size == sse.encrypted_size(mib)
    assert md[sse.MK_CIPHER] == sse.CIPHER_CHACHA and \
        md[sse.MK_ACTUAL] == str(mib) and md[sse.MK_SSE] == "S3"
    for kw in ({"raw_size": mib - 1}, {"raw_size": -1},
               {"device_sse": False}):
        args = dict(cipher=sse.CIPHER_CHACHA, device_sse=True)
        args.update(kw)
        size = args.pop("raw_size", mib)
        (r, _, spec), _ = setup(size, **args)
        assert spec is None and isinstance(r, sse.PutObjReader)
    assert not sse.device_sse_allowed(-1)
    # compression joins the chain: a compressing reader of unknown stored
    # size, whose compressed stream the fused cipher takes
    (r, size, spec), md = setup(mib, compress=True,
                                cipher=sse.CIPHER_CHACHA, device_sse=True)
    assert isinstance(r, sse.PutObjReader) and size == -1
    assert isinstance(spec, sse.DeviceSSE)
    assert md[sse.MK_COMPRESS] == sse.COMPRESS_S2 and \
        md[sse.MK_ACTUAL] == str(mib)
    with pytest.raises(S3Error):
        setup(mib, kms=None)
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "chacha20")
    assert sse.sse_cipher_for_new_writes() == sse.CIPHER_CHACHA
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "aes-gcm")
    assert sse.sse_cipher_for_new_writes() == sse.CIPHER_AES


@pytest.mark.parametrize("cipher", [sse.CIPHER_CHACHA, sse.CIPHER_AES])
def test_sealed_keys_cross_packages(cipher):
    if cipher == sse.CIPHER_AES:
        pytest.importorskip("cryptography")
    sealing, oek = bytes(range(40, 72)), bytes(range(72, 104))
    assert ref_sse.unseal_key(sealing, sse.seal_key(sealing, oek, cipher),
                              cipher) == oek
    assert sse.unseal_key(sealing, ref_sse.seal_key(sealing, oek, cipher),
                          cipher) == oek
    with pytest.raises(Exception):
        sse.unseal_key(bytes(32), ref_sse.seal_key(sealing, oek, cipher),
                       cipher)


def _put_transformed(layer, mod, name, pt, cipher, device_sse):
    """An SSE-S3 PUT as the handlers wire it (handlers.py:1392-1420)."""
    md = {}
    reader, size, spec = mod.setup_put_transforms(
        key_name=name, raw_reader=mod.HashReader(io.BytesIO(pt), len(pt)),
        raw_size=len(pt), metadata=md, ssec_key=None, sse_s3=True,
        kms=(kms if mod is sse else ref_kms).StaticKMS(MASTER),
        compress=False, cipher=cipher, device_sse=device_sse)
    opts_cls = engine.PutOptions if mod is sse else ref_engine.PutOptions
    return layer.put_object("b", name, reader, size,
                            opts_cls(metadata=md, sse_spec=spec))


def _get_plain(layer, mod, name, offset=0, length=-1, **kw):
    """A GET as the handlers wire it (handlers.py:1529-1570, :1641-1650)."""
    info = layer.get_object_info("b", name)
    oek, base = mod.resolve_get_key(
        info.user_defined, lambda h, d="": d,
        (kms if mod is sse else ref_kms).StaticKMS(MASTER))
    plain = int(info.actual_size)
    length = plain - offset if length < 0 else length

    def fetch(off, ln):
        return layer.get_object("b", name, off, ln)[1]

    if mod.stored_sse_cipher(info.user_defined) == sse.CIPHER_CHACHA:
        out = b"".join(mod.chacha_decrypt_ranged(fetch, info.size, oek,
                                                 base, offset, length, **kw))
        skip = offset % PKG
        return out[skip:skip + length]
    out = b"".join(mod.decrypt_stream(fetch(0, info.size), oek, base))
    return out[offset:offset + length]


@pytest.mark.parametrize("cipher", [sse.CIPHER_CHACHA, sse.CIPHER_AES])
def test_objects_cross_packages(tmp_path, gate, cipher):
    if cipher == sse.CIPHER_AES:
        pytest.importorskip("cryptography")
    paths = _paths(tmp_path, "x")
    port = engine.from_reference_layout(paths, K, M, block_size=BLOCK,
                                        device="cpu")
    ref = RefSets.from_drives(paths, set_count=1, set_drive_count=K + M,
                              parity=M, block_size=BLOCK)
    try:
        port.make_bucket("b")
        sizes = {"small": 1000, "tail": 17 * PKG + 321}
        objs = {f"{who}-{n}": _payload(size, i)
                for i, (n, size) in enumerate(sizes.items())
                for who in ("port", "ref")}
        for name, pt in objs.items():
            if name.startswith("port"):
                _put_transformed(port, sse, name, pt, cipher, True)
            else:
                _put_transformed(ref, ref_sse, name, pt, cipher, False)
        for name, pt in objs.items():
            assert _get_plain(port, sse, name, device="cpu") == pt, name
            assert _get_plain(ref, ref_sse, name) == pt, name
            if len(pt) > 2 * PKG + 7:
                assert _get_plain(port, sse, name, PKG + 7, PKG,
                                  device="cpu") == pt[PKG + 7:2 * PKG + 7]
    finally:
        ref.close()


def test_ssec_put_and_get(tmp_path, gate):
    key = bytes(range(1, 33))
    good = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(key).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(key).digest()).decode()}
    eng = _port_engine(tmp_path)
    pt = _payload(2 * BLOCK + 11, 8)
    md = {}
    reader, size, spec = sse.setup_put_transforms(
        key_name="c", raw_reader=sse.HashReader(io.BytesIO(pt), len(pt)),
        raw_size=len(pt), metadata=md,
        ssec_key=sse.parse_ssec_headers(lambda h, d="": good.get(h, d)),
        sse_s3=False, kms=None, compress=False, cipher=sse.CIPHER_CHACHA,
        device_sse=False)
    assert spec is None and md[sse.MK_SSE] == "C"
    eng.put_object("b", "c", reader, size, engine.PutOptions(metadata=md))
    info = eng.get_object_info("b", "c")
    oek, base = sse.resolve_get_key(info.user_defined,
                                    lambda h, d="": good.get(h, d), None)
    fetch = lambda off, ln: eng.get_object("b", "c", off, ln)[1]  # noqa
    assert b"".join(sse.chacha_decrypt_ranged(
        fetch, info.size, oek, base, 0, len(pt), device="cpu")) == pt
    with pytest.raises(S3Error, match="key required"):
        sse.resolve_get_key(info.user_defined, lambda h, d="": d, None)
    wrong = dict(good)
    other = bytes(32)
    wrong["x-amz-server-side-encryption-customer-key"] = \
        base64.b64encode(other).decode()
    wrong["x-amz-server-side-encryption-customer-key-md5"] = \
        base64.b64encode(hashlib.md5(other).digest()).decode()
    with pytest.raises(S3Error, match="does not match"):
        sse.resolve_get_key(info.user_defined,
                            lambda h, d="": wrong.get(h, d), None)


# -- chacha_decrypt_ranged ----------------------------------------------------

def _fetcher(stored: bytes):
    def fetch(off, ln):
        yield stored[off:off + ln]
    return fetch


def test_chacha_decrypt_ranged_equals_reference():
    # 66 packages: a full read and a range that start mid-package and
    # cross the 64-package decipher batch, and the last bytes
    rng = np.random.default_rng(16)
    oek, base = rng.bytes(32), rng.bytes(12)
    pt = rng.bytes(65 * PKG + 500)
    stored = _oracle(pt, oek, base)
    for off, ln in ((0, len(pt)), (PKG + 123, PKG + 77),
                    (62 * PKG + 100, 3 * PKG), (len(pt) - 5, 5)):
        got = b"".join(sse.chacha_decrypt_ranged(
            _fetcher(stored), len(stored), oek, base, off, ln,
            device="cpu"))
        want = b"".join(ref_sse.chacha_decrypt_ranged(
            _fetcher(stored), len(stored), oek, base, off, ln))
        assert got == want
        assert got[off % PKG:off % PKG + ln] == pt[off:off + ln]


def test_chacha_decrypt_ranged_rejects_corruption_before_plaintext():
    rng = np.random.default_rng(17)
    oek, base = rng.bytes(32), rng.bytes(12)
    pt = rng.bytes(2 * PKG + 100)
    stored = bytearray(_oracle(pt, oek, base))
    stored[PKG + 5] ^= 0x40          # ciphertext inside package 1
    yielded = []
    with pytest.raises(S3Error, match="authentication"):
        for chunk in sse.chacha_decrypt_ranged(
                _fetcher(bytes(stored)), len(stored), oek, base, 0,
                len(pt), device="cpu"):
            yielded.append(chunk)
    assert yielded == []
    # package 0 alone stays readable: the corruption is contained
    assert b"".join(sse.chacha_decrypt_ranged(
        _fetcher(bytes(stored)), len(stored), oek, base, 0, PKG,
        device="cpu")) == pt[:PKG]


def test_chacha_decrypt_ranged_rejects_tag_corruption():
    rng = np.random.default_rng(18)
    oek, base = rng.bytes(32), rng.bytes(12)
    pt = rng.bytes(PKG + 11)
    stored = bytearray(_oracle(pt, oek, base))
    stored[-1] ^= 0x01               # the last trailer byte
    with pytest.raises(S3Error):
        b"".join(sse.chacha_decrypt_ranged(
            _fetcher(bytes(stored)), len(stored), oek, base, PKG, 11,
            device="cpu"))


def test_static_kms_and_kes_shapes_equal_reference():
    static, ref_static = kms.StaticKMS(MASTER), ref_kms.StaticKMS(MASTER)
    assert static.generate_key({}) == ref_static.generate_key({})
    with pytest.raises(kms.KMSError):
        static.decrypt_key(b"x", {})

    class Conn:
        """A fake KES connection: answers generate and decrypt."""
        def request(self, method, path, body, headers):
            self.path = path

        def getresponse(self):
            class Resp:
                status = 200

                def read(self_):
                    return (b'{"plaintext": "' +
                            base64.b64encode(MASTER) +
                            b'", "ciphertext": "c2VhbGVk"}')
            return Resp()

        def close(self):
            pass

    got = kms.KESClient("http://kes:7373", "k1", connect=Conn)
    want = ref_kms.KESClient("http://kes:7373", "k1", connect=Conn)
    assert got.generate_key({"a": 1}) == want.generate_key({"a": 1})
    assert got.decrypt_key(b"sealed", {}, key_id="kes:k0") == \
        want.decrypt_key(b"sealed", {}, key_id="kes:k0")
