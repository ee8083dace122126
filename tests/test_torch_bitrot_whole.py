"""Whole-file bitrot on the port (minio_tpu_torch/object/bitrot_io.py),
held byte for byte against minio_tpu's writer and reader: sha256, blake2b
and highwayhash256 shard files and digests, a flipped byte raised as
bitrot, and objects under sha256 written by one package and read by the
other. Tolerance: 0 (exact bytes)."""

import hashlib
import os
import shutil

import numpy as np
import pytest

from minio_tpu.bitrot import BitrotAlgorithm as RefAlgo
from minio_tpu.object import bitrot_io as ref_bitrot_io
from minio_tpu.object.sets import ErasureSets
from minio_tpu.storage.xl_storage import XLStorage as RefXLStorage
from minio_tpu_torch.bitrot import BitrotAlgorithm
from minio_tpu_torch.object import bitrot_io, engine, open_erasure_set
from minio_tpu_torch.storage import errors
from minio_tpu_torch.storage.xl_storage import (MINIO_META_TMP_BUCKET,
                                                XLStorage)

WHOLE = ["sha256", "blake2b", "highwayhash256"]
K, M, BS = 4, 2, 1 << 14


def _blocks(seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in (1000, 4096, 0, 17, 3000)]


def _write(mod, disk, algo, blocks, path="obj/part.1"):
    w = mod.new_bitrot_writer(disk, MINIO_META_TMP_BUCKET, path, -1, algo,
                              4096)
    for i, b in enumerate(blocks):
        if i % 2:
            w.write(b)
        else:
            # a per-block digest is not the file's: the writer rehashes
            w.write_with_digest(b, b"\0" * algo.digest_size)
    w.close()
    return w.digest()


@pytest.mark.parametrize("name", WHOLE)
def test_writer_equals_reference(tmp_path, name):
    blocks = _blocks(len(name))
    d = XLStorage(str(tmp_path / "port"))
    r = RefXLStorage(str(tmp_path / "ref"))
    for disk in (d, r):
        disk.make_vol_bulk(".minio.sys", MINIO_META_TMP_BUCKET)
    dig = _write(bitrot_io, d, BitrotAlgorithm(name), blocks)
    ref_dig = _write(ref_bitrot_io, r, RefAlgo(name), blocks)
    data = b"".join(blocks)
    assert dig == ref_dig
    assert d.read_all(MINIO_META_TMP_BUCKET, "obj/part.1") == data
    assert r.read_all(MINIO_META_TMP_BUCKET, "obj/part.1") == data
    if name == "sha256":
        assert dig == hashlib.sha256(data).digest()
    elif name == "blake2b":
        assert dig == hashlib.blake2b(data).digest()


@pytest.mark.parametrize("name", WHOLE)
def test_reader_verifies_and_serves_ranges(tmp_path, name):
    algo = BitrotAlgorithm(name)
    blocks = _blocks(7)
    d = XLStorage(str(tmp_path))
    d.make_vol_bulk(".minio.sys", MINIO_META_TMP_BUCKET)
    dig = _write(bitrot_io, d, algo, blocks)
    data = b"".join(blocks)
    for mod, a in ((bitrot_io, algo), (ref_bitrot_io, RefAlgo(name))):
        rd = mod.new_bitrot_reader(d, MINIO_META_TMP_BUCKET, "obj/part.1",
                                   len(data), a, dig, 4096)
        assert rd.read_at(0, 4096) == data[:4096]
        assert rd.read_at(4096, len(data) - 4096) == data[4096:]
        rd.close()
    # one flipped byte: the whole-file digest no longer matches
    p = os.path.join(str(tmp_path), MINIO_META_TMP_BUCKET, "obj/part.1")
    with open(p, "r+b") as f:
        f.seek(2000)
        b = f.read(1)
        f.seek(2000)
        f.write(bytes([b[0] ^ 1]))
    rd = bitrot_io.new_bitrot_reader(d, MINIO_META_TMP_BUCKET, "obj/part.1",
                                     len(data), algo, dig, 4096)
    with pytest.raises(errors.BitrotHashMismatch):
        rd.read_at(0, 10)
    # no recorded digest: served unverified, as the reference does
    rd = bitrot_io.new_bitrot_reader(d, MINIO_META_TMP_BUCKET, "obj/part.1",
                                     len(data), algo, b"", 4096)
    assert len(rd.read_at(0, len(data))) == len(data)


def _paths(tmp_path, tag):
    return [str(tmp_path / f"{tag}{i}") for i in range(K + M)]


def _xl_checksums(root, bucket, name):
    fi = XLStorage(root).read_version(bucket, name)
    return fi, {c.part_number: c for c in fi.erasure.checksums}


@pytest.mark.parametrize("size", [0, 1000, 5 * BS + 123])
def test_sha256_put_port_get_reference(tmp_path, size):
    paths = _paths(tmp_path, "d")
    eng = engine.from_reference_layout(paths, K, M, block_size=BS,
                                       device="cpu",
                                       bitrot_algo=BitrotAlgorithm.SHA256)
    eng.make_bucket("b")
    data = np.random.default_rng(size).bytes(size)
    eng.put_object("b", "o", data)
    # each drive's xl.meta holds its own shard file's digest
    for root in paths:
        fi, csums = _xl_checksums(root, "b", "o")
        with open(os.path.join(root, "b", "o", fi.data_dir, "part.1"),
                  "rb") as f:
            assert csums[1].algorithm == "sha256"
            assert csums[1].hash == hashlib.sha256(f.read()).digest()
        XLStorage(root).verify_file("b", "o", fi)
    ref = ErasureSets.from_drives(paths, 1, K + M, M, block_size=BS,
                                  enable_mrf=False)
    _info, it = ref.get_object("b", "o")
    assert b"".join(it) == data
    ref.close()


def test_sha256_put_reference_get_port_and_bitrot(tmp_path):
    paths = _paths(tmp_path, "d")
    ref = ErasureSets.from_drives(paths, 1, K + M, M, block_size=BS,
                                  enable_mrf=False,
                                  bitrot_algo=RefAlgo.SHA256)
    data = np.random.default_rng(3).bytes(3 * BS + 5)
    ref.make_bucket("b")
    ref.put_object("b", "o", data)
    ref.close()
    eng = engine.from_reference_layout(paths, K, M, block_size=BS,
                                       device="cpu")
    _info, it = eng.get_object("b", "o")
    assert b"".join(it) == data
    # a flipped byte in one data shard file is found by its whole-file
    # digest and the block is rebuilt from the others
    fi = XLStorage(paths[0]).read_version("b", "o")
    p = os.path.join(paths[0], "b", "o", fi.data_dir, "part.1")
    with open(p, "r+b") as f:
        f.write(b"\xff\xff")
    _info, it = eng.get_object("b", "o")
    assert b"".join(it) == data
    with pytest.raises(errors.BitrotHashMismatch):
        XLStorage(paths[0]).verify_file("b", "o", fi)


def test_sha256_heal_rebuilds_lost_drive(tmp_path):
    paths = _paths(tmp_path, "d")
    eng = open_erasure_set(paths, K, M, block_size=BS, device="cpu",
                           bitrot_algo=BitrotAlgorithm.SHA256)
    eng.make_bucket("b")
    data = np.random.default_rng(4).bytes(4 * BS + 99)
    eng.put_object("b", "o", data)
    fi = XLStorage(paths[2]).read_version("b", "o")
    part = os.path.join(paths[2], "b", "o", fi.data_dir, "part.1")
    with open(part, "rb") as f:
        want = f.read()
    shutil.rmtree(os.path.join(paths[2], "b", "o"))
    res = eng.heal_object("b", "o")
    assert res.disks_healed == 1
    with open(part, "rb") as f:
        assert f.read() == want
    # the healed drive's xl.meta holds its own file's digest (minio_tpu
    # copies another drive's there), so the shard verifies
    healed = XLStorage(paths[2]).read_version("b", "o")
    assert healed.erasure.checksums[0].hash == \
        hashlib.sha256(want).digest()
    XLStorage(paths[2]).verify_file("b", "o", healed)
