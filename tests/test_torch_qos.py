"""The port's multi-tenant QoS plane (minio_tpu_torch/s3/qos.py, the tenant
probe of s3/edge/admission.py and the pacing of s3/handlers.py) held
against minio_tpu's.

  * tests/test_qos.py's fourteen cases rebound to the port
    (tests/test_torch_iam.rebound), on both transports where the reference
    runs them on both: the claimed-key parse of every auth flavour, the
    roll-up to the parent account, the tenant counters on the wire, the
    token bucket's probes, the weighted shares, refusals before the first
    body byte, the registry's persistence and fsck's fork repair, the
    admin routes, the default-off parity and the noisy tenant beside a
    polite one;
  * twin servers (the reference's and the port's, identities pinned) with
    the plane off, under both transports: equal statuses, bodies, headers
    and drive files, with budgets registered that would refuse every
    request were the plane on;
  * twin servers with the plane on and the same budgets: the same
    refusals, codes and Retry-After from both packages, and the same
    per-tenant shed counts;
  * a paced PUT body lands through ``PacedReader.readinto`` (the seam into
    the staging ring), charged as the reference's ``read`` charges, and
    leaves the reference's drive files.
Every comparison is byte for byte. Four data and two parity drives at
64 KiB blocks, device="cpu".
"""

from __future__ import annotations

import inspect
import io

import numpy as np
import pytest

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu.utils.bandwidth as ref_bandwidth
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
import minio_tpu_torch.utils.bandwidth as port_bandwidth
import tests.test_qos as ref_cases
from minio_tpu.iam.sys import IAMSys as RefIAMSys
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3.credentials import Credentials as RefCredentials
from minio_tpu.s3.qos import Budget as RefBudget
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.utils import telemetry as ref_telemetry
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.credentials import Credentials
from minio_tpu_torch.s3.edge import server as edge_server_mod
from minio_tpu_torch.s3.qos import Budget
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.utils import telemetry as port_telemetry
from tests.test_s3 import S3TestClient
from tests.test_torch_iam import rebound
from tests.test_torch_s3 import _norm, drive_files, pin

REGION = ref_cases.REGION
BLOCK = ref_cases.BLOCK
N, M = 4, 2


def _port_cred(c) -> Credentials:
    return Credentials(c.access_key, c.secret_key)


CREDS, ALICE, BOB = (_port_cred(c) for c in (ref_cases.CREDS,
                                             ref_cases.ALICE,
                                             ref_cases.BOB))


class _CpuSets:
    """The port's ErasureSets as tests/test_qos.py calls it, on the CPU."""

    @staticmethod
    def from_storage(*args, **kw):
        return ErasureSets.from_storage(*args, device="cpu", **kw)

    @staticmethod
    def from_drives(*args, **kw):
        return ErasureSets.from_drives(*args, device="cpu", **kw)


def _port(fn):
    return rebound(fn, CREDS=CREDS, ALICE=ALICE, BOB=BOB,
                   ErasureSets=_CpuSets)


_mk_iam = _port(ref_cases._mk_iam)
_mk_server = _port(ref_cases._mk_server)

_CASES = sorted(name for name, fn in vars(ref_cases).items()
                if name.startswith("test_") and inspect.isfunction(fn))
_ON_BOTH = ("test_auth_matrix_on_the_wire",
            "test_budget_refusal_reads_zero_body_bytes",
            "test_byte_budget_refuses_oversized_put_pre_body")


@pytest.fixture(scope="module")
def layer(tmp_path_factory):
    root = tmp_path_factory.mktemp("qosdrives")
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(6)],
                                   1, 6, 2, block_size=BLOCK, device="cpu")
    yield sets
    sets.close()


@pytest.fixture(params=["edge", "threaded"])
def any_server(request, layer, monkeypatch):
    monkeypatch.setenv("MINIO_TPU_QOS", "on")
    srv = _mk_server(layer, _mk_iam(), MINIO_TPU_EDGE="on"
                     if request.param == "edge" else "off")
    assert srv.edge_enabled == (request.param == "edge")
    yield srv
    srv.stop()


def test_every_reference_case_is_rebound():
    assert len(_CASES) == 14, _CASES


@pytest.mark.parametrize("name", _ON_BOTH)
def test_reference_case_on_both_transports(any_server, name):
    _port(getattr(ref_cases, name))(any_server)


@pytest.mark.parametrize("name", [
    "test_claimed_access_key_parses_every_auth_flavor",
    "test_tenant_resolution_rolls_up_to_parent",
    "test_token_bucket_probes_charge_and_peek"])
def test_reference_case_alone(name):
    _port(getattr(ref_cases, name))()


@pytest.mark.parametrize("name", [
    "test_lone_tenant_borrows_the_whole_gate",
    "test_equal_shares_split_the_gate",
    "test_bought_share_moves_the_bound"])
def test_reference_share_case(monkeypatch, name):
    _port(getattr(ref_cases, name))(monkeypatch)


@pytest.mark.parametrize("name", [
    "test_registry_persists_and_reloads_across_restart",
    "test_registry_fork_detected_and_repaired_by_fsck"])
def test_reference_registry_case(tmp_path, name):
    _port(getattr(ref_cases, name))(tmp_path)


def test_reference_admin_case(layer, monkeypatch):
    _port(ref_cases.test_admin_qos_roundtrip)(layer, monkeypatch)


@pytest.mark.parametrize("edge", ["on", "off"])
def test_reference_default_off_case(layer, edge, monkeypatch):
    _port(ref_cases.test_default_off_is_byte_identical)(layer, edge,
                                                       monkeypatch)


def test_reference_noisy_tenant_case(tmp_path, monkeypatch):
    _port(ref_cases.test_noisy_tenant_sheds_polite_tenant_lands)(
        tmp_path, monkeypatch)


# -- twin servers ------------------------------------------------------------

def _ref_iam() -> RefIAMSys:
    iam = RefIAMSys(root_cred=ref_cases.CREDS)
    for c in (ref_cases.ALICE, ref_cases.BOB):
        iam.add_user(c.access_key, c.secret_key)
        iam.attach_policy("readwrite", user=c.access_key)
    return iam


def _twins(tmp_path):
    """(ref server, port server, [ref sets, port sets]) over drives of
    their own, IAM with alice and bob on both."""
    out = []
    for tag, sets_cls, server_cls, iam, creds, kw in (
            ("ref", RefSets, RefServer, _ref_iam(), ref_cases.CREDS, {}),
            ("port", ErasureSets, S3Server, _mk_iam(), CREDS,
             {"device": "cpu"})):
        (tmp_path / tag).mkdir()
        sets = sets_cls.from_drives([str(tmp_path / tag / f"d{i}")
                                     for i in range(N + M)], 1, N + M, M,
                                    block_size=BLOCK, **kw)
        out.append((server_cls(sets, creds=creds, region=REGION,
                               iam=iam).start(), sets))
    return out


def _client(srv, cred):
    return S3TestClient("127.0.0.1", srv.port, RefCredentials(
        cred.access_key, cred.secret_key))


def _pin_both(monkeypatch):
    pin(monkeypatch, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(monkeypatch, port_engine, port_multipart, port_bmeta,
        port_handlers, port_crypto)


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_servers_with_the_plane_off(tmp_path, monkeypatch, edge):
    """The plane off (the default): both packages answer one signed
    sequence of alice, bob and root alike, byte for byte, and leave equal
    drive files, though each registry holds budgets that would refuse
    every alice and bob request were the plane on; no tenant counter
    moves in either package."""
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    monkeypatch.delenv("MINIO_TPU_QOS", raising=False)
    _pin_both(monkeypatch)
    (ref, ref_sets), (port, port_sets) = _twins(tmp_path)
    rng = np.random.default_rng(23)
    body = rng.bytes(3 * BLOCK + 99)
    counters = [t.REGISTRY.counter("minio_tpu_qos_tenant_requests_total")
                for t in (ref_telemetry, port_telemetry)]
    before = [c.series() for c in counters]
    try:
        for srv, budget in ((ref, RefBudget), (port, Budget)):
            # in memory only: the plane never reads them while off
            reg = srv.api.qos.registry
            for who in (ALICE, BOB):
                reg.tenants[who.access_key] = budget(
                    who.access_key, rps=0.001, rx_bps=1.0, tx_bps=1.0)
            reg.epoch += 1
        steps = [(CREDS, "PUT", "/qoff", b""),
                 (ALICE, "PUT", "/qoff/a", body),
                 (BOB, "PUT", "/qoff/b", body[:5000]),
                 (ALICE, "GET", "/qoff/a", b""),
                 (BOB, "GET", "/qoff/a", b""),
                 (ALICE, "PUT", "/qoff/a", body[::-1]),
                 (BOB, "HEAD", "/qoff/a", b""),
                 (ALICE, "GET", "/qoff", b""),
                 (BOB, "DELETE", "/qoff/b", b""),
                 (ALICE, "GET", "/qoff/b", b"")]
        for i, (cred, method, path, data) in enumerate(steps):
            a, b = (_norm(_client(s, cred).request(method, path, body=data))
                    for s in (ref, port))
            assert a == b, f"step {i} {method} {path}"
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()
    assert [c.series() for c in counters] == before
    want, got = drive_files(tmp_path / "ref"), drive_files(tmp_path / "port")
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k] != got[k]] == []


def _shed_counts(telemetry) -> dict:
    fam = telemetry.REGISTRY.counter("minio_tpu_qos_tenant_shed_total")
    return dict(fam.series())


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_servers_refuse_alike_with_the_plane_on(tmp_path, monkeypatch,
                                                     edge):
    """The plane on, the same budgets in both registries: bob's request
    rate and alice's byte budget run out alike, and both packages refuse
    the same requests with the same status, code, Retry-After and
    Connection: close, count the same sheds per tenant and kind, and
    serve root and the requests within budget alike."""
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    monkeypatch.setenv("MINIO_TPU_QOS", "on")
    _pin_both(monkeypatch)
    (ref, ref_sets), (port, port_sets) = _twins(tmp_path)
    before = [_shed_counts(t) for t in (ref_telemetry, port_telemetry)]
    try:
        for srv, budget in ((ref, RefBudget), (port, Budget)):
            reg = srv.api.qos.registry
            reg.set_budget("tenant", budget(BOB.access_key, rps=0.001))
            reg.set_budget("tenant", budget(ALICE.access_key,
                                            rx_bps=2000.0))
        steps = [(CREDS, "PUT", "/qon", b""),
                 (BOB, "GET", "/qon", b""),          # bob's one token
                 (BOB, "GET", "/qon", b""),          # rate: refused
                 (BOB, "PUT", "/qon/b", b"b" * 10),  # refused pre-body
                 (ALICE, "PUT", "/qon/a1", b"a" * 1500),
                 (ALICE, "PUT", "/qon/a2", b"a" * 1900),  # bytes: refused
                 (ALICE, "GET", "/qon/a1", b""),
                 (CREDS, "GET", "/qon/a1", b""),
                 (CREDS, "PUT", "/qon/r", b"r" * 5000)]
        outs = [[], []]
        for cred, method, path, data in steps:
            for i, srv in enumerate((ref, port)):
                outs[i].append(_norm(_client(srv, cred).request(
                    method, path, body=data)))
        assert outs[0] == outs[1]
        statuses = [o[0] for o in outs[1]]
        assert statuses == [200, 200, 503, 503, 200, 503, 200, 200, 200]
        for o in (outs[1][2], outs[1][3], outs[1][5]):
            assert b"<Code>SlowDown</Code>" in o[2]
            assert o[1]["connection"] == "close"
            assert int(o[1]["retry-after"]) >= 1
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()
    after = [_shed_counts(t) for t in (ref_telemetry, port_telemetry)]
    deltas = [{k: v - b.get(k, 0.0) for k, v in a.items()
               if v != b.get(k, 0.0)} for a, b in zip(after, before)]
    assert deltas[0] == deltas[1]
    assert deltas[1] == {(("kind", "rate"), ("tenant", BOB.access_key)): 2.0,
                         (("kind", "bytes"),
                          ("tenant", ALICE.access_key)): 1.0}


# -- the paced body into the staging ring ----------------------------------------

def test_paced_readinto_charges_as_read():
    """PacedReader.readinto lands the bytes read() returns and charges
    the bucket the same (the reference's read() charges after each
    read); a stream without readinto is read and copied."""
    data = np.random.default_rng(3).bytes(10_000)
    seen = {"ref": [], "port": []}
    ref_r = ref_bandwidth.PacedReader(
        io.BytesIO(data), ref_bandwidth.TokenBucket(0.0),
        on_bytes=seen["ref"].append)
    got_ref = b"".join(iter(lambda: ref_r.read(3000), b""))

    class _NoReadinto:
        def __init__(self, raw):
            self._b = io.BytesIO(raw)

        def read(self, n=-1):
            return self._b.read(n)

    for inner in (io.BytesIO(data), _NoReadinto(data)):
        seen["port"] = []
        r = port_bandwidth.PacedReader(
            inner, port_bandwidth.TokenBucket(0.0),
            on_bytes=seen["port"].append)
        buf = bytearray(len(data) + 100)
        mv, got = memoryview(buf), 0
        while True:
            n = r.readinto(mv[got:got + 3000])
            if not n:
                break
            got += n
        assert bytes(buf[:got]) == got_ref == data
        assert seen["port"] == seen["ref"]
    # a rated bucket: the same tokens taken by either call
    b1, b2 = (port_bandwidth.TokenBucket(1e9) for _ in range(2))
    port_bandwidth.PacedReader(io.BytesIO(data), b1).read(4096)
    port_bandwidth.PacedReader(io.BytesIO(data), b2).readinto(
        bytearray(4096))
    assert abs(b1._tokens - b2._tokens) < 1e9 * 0.05


def test_paced_put_lands_through_readinto(tmp_path, monkeypatch):
    """With the plane on and a byte budget on alice, her multi-block PUT
    through the edge reads into the staging ring through
    PacedReader.readinto, every byte charged to her rx counter, and both
    packages (the reference paces through read()) leave the same drive
    files and answer the GET alike."""
    monkeypatch.setenv("MINIO_TPU_EDGE", "on")
    monkeypatch.setenv("MINIO_TPU_QOS", "on")
    _pin_both(monkeypatch)
    calls = []
    real = port_bandwidth.PacedReader.readinto

    def readinto(self, b):
        n = real(self, b)
        calls.append(n)
        return n
    monkeypatch.setattr(port_bandwidth.PacedReader, "readinto", readinto)
    edge_calls = []
    real_edge = edge_server_mod._EdgeBodyReader.readinto

    def edge_readinto(self, b):
        n = real_edge(self, b)
        edge_calls.append(n)
        return n
    monkeypatch.setattr(edge_server_mod._EdgeBodyReader, "readinto",
                        edge_readinto)
    (ref, ref_sets), (port, port_sets) = _twins(tmp_path)
    body = np.random.default_rng(31).bytes(5 * BLOCK + 321)
    rx = port_telemetry.REGISTRY.counter(
        "minio_tpu_qos_tenant_rx_bytes_total")
    rx0 = rx.value(tenant=ALICE.access_key)
    try:
        for srv, budget in ((ref, RefBudget), (port, Budget)):
            srv.api.qos.registry.set_budget(
                "tenant", budget(ALICE.access_key, rx_bps=float(64 << 20)))
        outs = [[], []]
        for i, srv in enumerate((ref, port)):
            outs[i].append(_norm(_client(srv, CREDS).request(
                "PUT", "/paced")))
            outs[i].append(_norm(_client(srv, ALICE).request(
                "PUT", "/paced/o", body=body)))
            outs[i].append(_norm(_client(srv, ALICE).request(
                "GET", "/paced/o")))
        assert outs[0] == outs[1]
        assert outs[1][2][2] == body
        assert sum(calls) == len(body) == sum(edge_calls)
        assert rx.value(tenant=ALICE.access_key) - rx0 == len(body)
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()
    want, got = drive_files(tmp_path / "ref"), drive_files(tmp_path / "port")
    want = {k: v for k, v in want.items() if "/qos/" not in k}
    got = {k: v for k, v in got.items() if "/qos/" not in k}
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k] != got[k]] == []
