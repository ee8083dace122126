"""The port's object lock (minio_tpu_torch/features/objectlock.py and the
lock verbs of s3/handlers.py) and browser POST uploads (s3/postpolicy.py)
held against minio_tpu's.

  * tests/test_objectlock_postpolicy.py's eleven cases rebound to the
    port's server (tests/test_torch_iam.rebound), in the reference's
    order over one module-scoped server, as the reference runs them:
    COMPLIANCE and GOVERNANCE retention on version deletes, the bypass
    header, ``?legal-hold`` and ``?retention`` with the bucket's default,
    a corrupt retain-until date failing closed, and POST uploads (signed
    policy, bad signature, conditions, the request's bucket, a policy
    without an expiration);
  * twin servers (the reference's and the port's, identities and the
    lock clock pinned) take one signed sequence of lock and POST verbs:
    a bucket made with ``x-amz-bucket-object-lock-enabled``, its
    ``?object-lock`` config with a default retention, PUTs under explicit
    and default retention, refused and bypassed deletes, legal holds,
    retention updates, delete markers, POST uploads whole and refused;
    equal statuses, bodies and headers at every step, and equal drive
    files at the end;
  * the departure: DeleteObjects on a locked bucket fails a locked
    version's own entry (ObjectLocked), where the reference's removes it.
Every comparison is byte for byte. Two data and two parity drives at
64 KiB blocks (the reference's fixture), device="cpu".
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.features.objectlock as ref_olock
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.features.objectlock as port_olock
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
import tests.test_objectlock_postpolicy as ref_cases
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.credentials import Credentials
from minio_tpu_torch.s3.server import S3Server
from tests.test_torch_iam import rebound
from tests.test_torch_s3 import _norm, drive_files, pin

CREDS = Credentials(ref_cases.CREDS.access_key, ref_cases.CREDS.secret_key)
REGION = ref_cases.REGION
BS = 1 << 16
NOW = 1.75e9            # the pinned lock clock of the twin sequence


def _port(fn):
    return rebound(fn, CREDS=CREDS)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("lockdrives")
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(4)],
                                   set_count=1, set_drive_count=4,
                                   parity=2, block_size=BS, device="cpu")
    srv = S3Server(sets, creds=CREDS, region=REGION).start()
    yield srv
    srv.stop()
    sets.close()


@pytest.fixture(scope="module")
def client(server):
    """The reference's client fixture: a lock-enabled bucket with
    versioning on."""
    c = ref_cases.Client(server.port)
    st, _, _ = c.request(
        "PUT", "/lockb",
        headers={"x-amz-bucket-object-lock-enabled": "true"})
    assert st == 200
    c.request("PUT", "/lockb", query={"versioning": ""},
              body=b"<VersioningConfiguration><Status>Enabled"
                   b"</Status></VersioningConfiguration>")
    return c


# the reference file's order: its module-scoped server carries state from
# one case to the next (the POST cases reuse the bucket the first makes)
_SERVED = ["test_compliance_retention_blocks_version_delete",
           "test_governance_retention_bypass",
           "test_legal_hold_subresource",
           "test_retention_subresource_and_default",
           "test_governance_retention_bypass_header",
           "test_post_policy_upload",
           "test_post_policy_rejects_bad_signature",
           "test_post_policy_enforces_conditions",
           "test_post_policy_bound_to_request_bucket",
           "test_post_policy_requires_expiration"]


def test_every_reference_case_is_rebound():
    cases = sorted(n for n in vars(ref_cases) if n.startswith("test_"))
    assert cases == sorted(
        _SERVED + ["test_check_deletable_fails_closed_on_corrupt_date"])


@pytest.mark.parametrize("name", _SERVED)
def test_reference_case_on_the_port(client, server, name):
    fn = _port(getattr(ref_cases, name))
    if fn.__code__.co_argcount == 2:
        fn(client, server)
    else:
        fn(client)


def test_reference_pure_case():
    _port(ref_cases.test_check_deletable_fails_closed_on_corrupt_date)()


# -- twin servers ----------------------------------------------------------------

def _twins(tmp_path):
    out = []
    for tag, sets_cls, server_cls, creds, kw in (
            ("ref", RefSets, RefServer, ref_cases.CREDS, {}),
            ("port", ErasureSets, S3Server, CREDS, {"device": "cpu"})):
        (tmp_path / tag).mkdir()
        sets = sets_cls.from_drives([str(tmp_path / tag / f"d{i}")
                                     for i in range(4)], 1, 4, 2,
                                    block_size=BS, **kw)
        out.append((server_cls(sets, creds=creds, region=REGION).start(),
                    sets))
    return out


def _pin_lock_clock(monkeypatch):
    clock = types.SimpleNamespace(time=lambda: NOW)
    for mod in (ref_olock, port_olock):
        monkeypatch.setattr(mod, "time", clock)


def _retention(mode: str, until_s: float) -> bytes:
    return (f"<Retention><Mode>{mode}</Mode><RetainUntilDate>"
            f"{port_olock.iso(until_s)}</RetainUntilDate>"
            "</Retention>").encode()


_LOCK_CFG = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
             b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>"
             b"COMPLIANCE</Mode><Days>1</Days></DefaultRetention></Rule>"
             b"</ObjectLockConfiguration>")


def _lock_sequence(data: dict):
    """Steps (client, state) -> (status, headers, body). Version ids come
    back in headers and go into later steps through `state`."""
    day = 86400

    def put(path, body, hdrs=None, keep=None):
        def step(c, st):
            out = c.request("PUT", path, body=body, headers=hdrs)
            if keep:
                st[keep] = out[1].get("x-amz-version-id", "")
            return out
        return step

    def req(method, path, query=None, body=b"", hdrs=None, vid=None):
        def step(c, st):
            q = dict(query or {})
            if vid:
                q["versionId"] = st[vid]
            return c.request(method, path, query=q, body=body,
                             headers=hdrs)
        return step

    def post(fields_of, body, bucket="postb", filename="upload.bin"):
        def step(c, st):
            status, data = _post_form(c.port, bucket, fields_of(), body,
                                      filename)
            return status, {}, data
        return step

    until = NOW + day
    return [
        put("/lockb", b"",
            {"x-amz-bucket-object-lock-enabled": "true"}),
        req("GET", "/lockb", {"object-lock": ""}),
        req("GET", "/lockb", {"versioning": ""}),
        put("/lockb/comp", data["big"],
            {"x-amz-object-lock-mode": "COMPLIANCE",
             "x-amz-object-lock-retain-until-date": port_olock.iso(until)},
            keep="comp"),
        req("GET", "/lockb/comp", {"retention": ""}),
        req("DELETE", "/lockb/comp", vid="comp"),
        req("DELETE", "/lockb/comp"),              # a marker: allowed
        req("GET", "/lockb", {"versions": ""}),
        req("PUT", "/lockb", {"object-lock": ""}, _LOCK_CFG),
        req("GET", "/lockb", {"object-lock": ""}),
        put("/lockb/dflt", data["small"], keep="dflt"),
        req("GET", "/lockb/dflt", {"retention": ""}, vid="dflt"),
        req("DELETE", "/lockb/dflt", vid="dflt"),
        put("/lockb/gov", data["small"][::-1],
            {"x-amz-object-lock-mode": "GOVERNANCE",
             "x-amz-object-lock-retain-until-date": port_olock.iso(until)},
            keep="gov"),
        req("PUT", "/lockb/gov", {"retention": ""},
            _retention("GOVERNANCE", NOW + 60), vid="gov"),
        req("PUT", "/lockb/gov", {"retention": ""},
            _retention("GOVERNANCE", NOW + 60),
            {"x-amz-bypass-governance-retention": "true"}, vid="gov"),
        req("GET", "/lockb/gov", {"retention": ""}, vid="gov"),
        req("PUT", "/lockb/gov", {"legal-hold": ""},
            b"<LegalHold><Status>ON</Status></LegalHold>", vid="gov"),
        req("GET", "/lockb/gov", {"legal-hold": ""}, vid="gov"),
        req("DELETE", "/lockb/gov",
            hdrs={"x-amz-bypass-governance-retention": "true"},
            vid="gov"),                            # the hold wins
        req("PUT", "/lockb/gov", {"legal-hold": ""},
            b"<LegalHold><Status>OFF</Status></LegalHold>", vid="gov"),
        req("DELETE", "/lockb/gov", vid="gov"),    # governance: refused
        req("DELETE", "/lockb/gov",
            hdrs={"x-amz-bypass-governance-retention": "true"},
            vid="gov"),
        req("PUT", "/lockb/comp", {"retention": ""},
            _retention("GOVERNANCE", NOW + 60), vid="comp"),
        req("PUT", "/lockb/comp", {"legal-hold": ""}, b"<LegalHold/>",
            vid="comp"),
        put("/plain", b""),
        req("PUT", "/plain/o", {"retention": ""},
            _retention("GOVERNANCE", NOW + 60)),
        req("GET", "/plain", {"object-lock": ""}),
        put("/postb", b""),
        post(lambda: _port(ref_cases._signed_policy_fields)("uploads/"),
             data["post"], filename="hello.bin"),
        req("GET", "/postb/uploads/hello.bin"),
        req("HEAD", "/postb/uploads/hello.bin"),
        post(lambda: {**_port(ref_cases._signed_policy_fields)("uploads/"),
                      "x-amz-signature": "0" * 64}, b"nope"),
        post(lambda: {**_port(ref_cases._signed_policy_fields)("uploads/"),
                      "key": "outside/x"}, b"x"),
        post(lambda: _port(ref_cases._signed_policy_fields)(
            "uploads/", max_size=4), b"toolarge"),
        post(lambda: {**_port(ref_cases._signed_policy_fields)("uploads/"),
                      "success_action_status": "201"}, data["small"],
             filename="made.bin"),
        req("GET", "/postb", {"list-type": "2"}),
    ]


def _post_form(port, bucket, fields, body, filename):
    client = types.SimpleNamespace(port=port)
    return ref_cases._post_form(client, bucket, fields, body, filename)


def test_twin_lock_and_post_sequence(tmp_path, monkeypatch):
    pin(monkeypatch, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(monkeypatch, port_engine, port_multipart, port_bmeta,
        port_handlers, port_crypto)
    _pin_lock_clock(monkeypatch)
    rng = np.random.default_rng(41)
    data = {"big": rng.bytes(3 * BS + 17), "small": rng.bytes(999),
            "post": rng.bytes(2 * BS + 5)}
    (ref, ref_sets), (port, port_sets) = _twins(tmp_path)
    try:
        clients = [ref_cases.Client(s.port) for s in (ref, port)]
        states = [{}, {}]
        statuses, bodies = [], []
        for i, step in enumerate(_lock_sequence(data)):
            a = _norm(step(clients[0], states[0]))
            b = _norm(step(clients[1], states[1]))
            assert a == b, f"step {i}: {a[0]} {a[2][:200]!r} != " \
                f"{b[0]} {b[2][:200]!r}"
            statuses.append(b[0])
            bodies.append(b[2])
        assert statuses == [
            200, 200, 200, 200, 200, 400, 204, 200, 200, 200, 200, 200,
            400, 200, 400, 200, 200, 200, 200, 400, 200, 400, 204, 400,
            400, 200, 400, 404, 200, 204, 200, 200, 403, 403, 400, 201,
            200]
        # the refused version deletes and retention shortening
        for i in (5, 12, 14, 19, 21, 23):
            assert b"<Code>ObjectLocked</Code>" in bodies[i], i
    finally:
        ref.stop()
        port.stop()
        ref_sets.close()
        port_sets.close()
    want, got = drive_files(tmp_path / "ref"), drive_files(tmp_path / "port")
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k] != got[k]] == []


def test_delete_objects_holds_locked_versions(server, client):
    """DeleteObjects on a locked bucket: the locked version's entry fails
    with ObjectLocked and the version stays; an unlocked key's version
    goes (the reference's DeleteObjects removes both)."""
    c = client
    st, h, _ = c.request("PUT", "/lockb/batch-locked", body=b"L",
                         headers={"x-amz-object-lock-mode": "COMPLIANCE",
                                  "x-amz-object-lock-retain-until-date":
                                      ref_cases._iso(86400)})
    assert st == 200
    locked = h["x-amz-version-id"]
    assert c.request("PUT", "/plainb")[0] == 200
    assert c.request("PUT", "/plainb/free", body=b"F")[0] == 200
    body = (f"<Delete><Object><Key>batch-locked</Key><VersionId>{locked}"
            "</VersionId></Object></Delete>").encode()
    st, _, out = c.request("POST", "/lockb", query={"delete": ""},
                           body=body)
    assert st == 200 and b"<Code>ObjectLocked</Code>" in out
    st, _, got = c.request("GET", "/lockb/batch-locked",
                           query={"versionId": locked})
    assert st == 200 and got == b"L"
    st, _, out = c.request(
        "POST", "/plainb", query={"delete": ""},
        body=b"<Delete><Object><Key>free</Key></Object></Delete>")
    assert st == 200 and b"<Deleted>" in out
    assert c.request("GET", "/plainb/free")[0] == 404
