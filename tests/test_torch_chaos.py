"""The reference's chaos suite (tests/test_chaos.py) on the port, with the
port's lock-order watchdog on.

  * every non-slow case of tests/test_chaos.py rebound to the port
    (tests/test_torch_iam.rebound), its sets on device="cpu": seeded
    NaughtyDisk schedules of verb errors, bitrot, truncated streams,
    short writes and offline windows on <= parity drives under
    concurrent PUT/GET, converged through MRF and a deep-scan heal; a
    writer dying mid-batch in the pipelined PUT; a pool drain whose target
    pool dies; faults behind storage RPC; the tier plane's failed,
    crashed and truncated transitions and restores;
  * the encrypted-shard bitrot case, whose two routes are the port's own
    (``test_chaos_bitrot_on_encrypted_shards``);
  * the seeded fault schedules held against the reference's: the same
    seed gives the same decisions in both packages.

Every case prints its seed; MINIO_TPU_CHAOS_SEED=<seed> replays a
schedule. The long randomized mix stays in the reference's slow tier.
"""

from __future__ import annotations

import inspect

import pytest

import tests.test_chaos as ref_cases
from minio_tpu.storage.naughty import FaultSchedule as RefSchedule
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.naughty import FaultSchedule
from tests.test_torch_iam import _one_torch_thread, rebound  # noqa: F401
from tests.test_torch_lockcheck import port_watchdog  # noqa: F401

pytestmark = pytest.mark.chaos

K, M, BLOCK = ref_cases.K, ref_cases.M, ref_cases.BLOCK


class _CpuSets:
    """The port's ErasureSets as the reference's suites call it, on the
    CPU."""

    @staticmethod
    def from_storage(*args, **kw):
        return ErasureSets.from_storage(*args, device="cpu", **kw)

    @staticmethod
    def from_drives(*args, **kw):
        return ErasureSets.from_drives(*args, device="cpu", **kw)


_PORTED = ("test_chaos_bitrot_on_encrypted_shards",)
_ALL = sorted(name for name, fn in vars(ref_cases).items()
              if name.startswith("test_") and inspect.isfunction(fn)
              and not any(m.name == "slow" for m in
                          getattr(fn, "pytestmark", ())))
_CASES = [n for n in _ALL if n not in _PORTED]


def test_every_reference_case_is_rebound():
    assert len(_ALL) == 12, _ALL
    assert set(_PORTED) <= set(_ALL)


@pytest.mark.parametrize("name", _CASES)
def test_reference_chaos_cases(tmp_path, monkeypatch, name):
    fn = rebound(getattr(ref_cases, name), ErasureSets=_CpuSets)
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


@pytest.mark.parametrize("device", [False, True])
def test_chaos_bitrot_on_encrypted_shards(tmp_path, monkeypatch, device):
    """tests/test_chaos.py's case on the port: NaughtyDisk bitrot under an
    encrypted object has exactly two legal outcomes, reconstruction to
    byte-identical plaintext or a clean error (erasure quorum or Poly1305
    auth); wrong plaintext is the one forbidden outcome. The port has no
    host fallback of a card dispatch, so its two routes are these:
    ``True`` is the fused cipher+encode+digest PUT and the fused
    decode+decipher GET through the codec's device steps (the plain
    kernels on CPU tensors; the size gates at 0), ``False`` the host
    cipher and host erasure path under the codec's default size gate.
    Same seeds, schedules and assertions as the reference's."""
    from minio_tpu_torch.features import crypto as sse
    from minio_tpu_torch.object import codec as codec_mod
    from minio_tpu_torch.object import engine as engine_mod

    if device:
        monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)
    else:
        assert codec_mod.DEVICE_MIN_BYTES > 4 * BLOCK
    encodes = codec_mod.step_seconds()["encode"]["calls"]
    seed = ref_cases.chaos_seed(7801)
    ref_cases.announce(seed)
    oek, base = bytes(range(32)), bytes(range(50, 62))
    make_sets = rebound(ref_cases.make_chaos_sets, ErasureSets=_CpuSets)

    def decrypt_back(sets, name, n):
        def fetch(off, ln):
            _, it = sets.get_object("b", name, off, ln)
            return it
        return b"".join(sse.chacha_decrypt_ranged(
            fetch, sse.encrypted_size(n), oek, base, 0, n,
            device="cpu"))[:n]

    # phase 1: bitrot on <= parity drives -> reconstruct, byte-identical
    sched = {j: FaultSchedule(seed=seed + j, bitrot_rate=0.35,
                              fault_verbs=("read_file",
                                           "read_file_stream"))
             for j in range(M)}
    sets, naughty = make_sets(tmp_path / "lo", sched)
    datas = {}
    for i, n in enumerate((1000, BLOCK + 17, 2 * BLOCK + 999)):
        data = ref_cases.payload(n, seed=seed + i)
        sets.put_object("b", f"e{i}", data,
                        opts=engine_mod.PutOptions(
                            sse_spec=sse.DeviceSSE(oek, base)))
        datas[f"e{i}"] = data
    for nd in naughty:
        nd.arm()
    for name, data in datas.items():
        assert decrypt_back(sets, name, len(data)) == data, name
    for nd in naughty:
        nd.disarm()
    sets.close()
    routed = codec_mod.step_seconds()["encode"]["calls"] - encodes
    assert (routed > 0) == device, routed

    # phase 2: bitrot past parity -> clean failure or correct bytes,
    # never a silent wrong-plaintext success
    sched = {j: FaultSchedule(seed=seed + 100 + j, bitrot_rate=1.0,
                              fault_verbs=("read_file",
                                           "read_file_stream"))
             for j in range(M + 1)}
    sets, naughty = make_sets(tmp_path / "hi", sched)
    n = BLOCK + 4321
    data = ref_cases.payload(n, seed=seed + 9)
    sets.put_object("b", "hot", data,
                    opts=engine_mod.PutOptions(
                        sse_spec=sse.DeviceSSE(oek, base)))
    for nd in naughty:
        nd.arm()
    try:
        got = decrypt_back(sets, "hot", n)
    except Exception as exc:  # noqa: BLE001 — ANY clean error is legal
        print(f"clean failure (ok): {type(exc).__name__}: {exc}")
    else:
        assert got == data, "silent plaintext corruption leaked through"
    for nd in naughty:
        nd.disarm()
    sets.close()


def test_fault_schedules_equal_reference():
    """The seeds the cases print replay the same fault decisions in both
    packages: every verb, every call number, every fault class."""
    kw = dict(error_rate=0.2, bitrot_rate=0.15, truncate_rate=0.3,
              latency_rate=0.1, latency=0.001)
    for seed in (1101, 2202, 3303, 4404, 5505, 7801):
        ours, theirs = FaultSchedule(seed=seed, **kw), \
            RefSchedule(seed=seed, **kw)
        for verb in ("read_file", "read_file_stream", "append_file",
                     "rename_data", "write_metadata"):
            for n in range(64):
                assert (ours.error_for(verb, n) is None) == \
                    (theirs.error_for(verb, n) is None)
                assert ours.corrupts(verb, n) == theirs.corrupts(verb, n)
                assert ours.truncates(verb, n) == theirs.truncates(verb, n)
                assert ours.latency_for(verb, n) == \
                    theirs.latency_for(verb, n)
