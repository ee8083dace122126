"""The port's fused device steps against minio_tpu's, byte for byte.

put_step, get_step and heal_step of minio_tpu_torch.models.pipeline run on
CPU tensors (the kernels' plain versions) and must equal
minio_tpu.models.pipeline's on the same numpy-seeded inputs (the JAX
package's CPU path, no Pallas). Tolerance: 0 (exact bytes).
"""

import numpy as np
import pytest
import torch

from minio_tpu.models import pipeline as ref_pipeline
from minio_tpu.ops import rs_tpu
from minio_tpu_torch.models import pipeline
from minio_tpu_torch.ops import rs_cuda, rs_matrix

K, M = 4, 2


@pytest.fixture(autouse=True)
def _jax_cpu_path():
    prev = rs_tpu.default_use_pallas()
    rs_tpu.set_default_use_pallas(False)
    yield
    rs_tpu.set_default_use_pallas(prev)


def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("s,shard_len", [(1031, 0), (1040, 1031)])
def test_put_step_equals_reference(s, shard_len):
    data = _data((2, K, s), s)
    parity, digests = pipeline.put_step(torch.from_numpy(data), K, M,
                                        shard_len)
    rp, rd = ref_pipeline.put_step(data, K, M, shard_len)
    assert (parity.numpy() == np.asarray(rp)).all()
    assert (digests.numpy() == np.asarray(rd)).all()
    assert digests.shape == (2, K + M, 32)


def test_get_and_heal_step_equal_reference():
    n, s = K + M, 517
    full = np.stack([rs_cuda.encode(_data((K, s), b), K, M,
                                    device="cpu").numpy() for b in range(3)])
    lost = (1, 4)
    mask = sum(1 << i for i in range(n) if i not in lost)

    dm, used, missing = rs_matrix.missing_data_matrix(K, M, mask)
    bits = rs_cuda._bit_expand_cached(dm.tobytes(), dm.shape)
    surv = np.ascontiguousarray(full[:, list(used)])
    out, dig = pipeline.get_step(torch.from_numpy(surv), bits, len(missing),
                                 K, s - 3)
    rout, rdig = ref_pipeline.get_step(surv, bits, len(missing), K, s - 3)
    assert (out.numpy() == np.asarray(rout)).all()
    assert (dig.numpy() == np.asarray(rdig)).all()
    assert (out.numpy() == full[:, list(missing)]).all()

    rec, used, rmissing = rs_matrix.recover_matrix(K, M, mask)
    bits = rs_cuda._bit_expand_cached(rec.tobytes(), rec.shape)
    surv = np.ascontiguousarray(full[:, list(used)])
    got = pipeline.heal_step(torch.from_numpy(surv), bits, len(rmissing), K)
    want = ref_pipeline.heal_step(surv, bits, len(rmissing), K)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
    assert (got[0].numpy() == full[:, list(rmissing)]).all()


def test_sha256_and_bad_shapes_raise():
    # sha256 is ported (ops/sha256_cuda.py): put_step digests with it
    # byte for byte as the reference does; an unknown algorithm and bad
    # shapes raise
    raw = _data((1, K, 70), 1)
    data = torch.from_numpy(raw)
    parity, digests = pipeline.put_step(data, K, M, 67, algo="sha256")
    rp, rd = ref_pipeline.put_step(raw, K, M, 67, algo="sha256")
    assert (parity.numpy() == np.asarray(rp)).all()
    assert (digests.numpy() == np.asarray(rd)).all()
    with pytest.raises(ValueError):
        pipeline.put_step(data, K, M, algo="blake2b")
    with pytest.raises(ValueError):
        pipeline.put_step(data, K + 1, M)


def test_ecconfig_matches_reference():
    cfg = pipeline.ECConfig(12, 4, 1 << 22)
    ref = ref_pipeline.ECConfig(12, 4, 1 << 22)
    assert cfg.shard_size == ref.shard_size == 349526
    for size in (0, 1, (1 << 22) + 12345, 64 << 20):
        assert cfg.shard_file_size(size) == ref.shard_file_size(size)
