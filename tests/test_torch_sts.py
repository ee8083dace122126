"""STS federation on the port (minio_tpu_torch/iam/providers.py and the
STS half of s3/handlers.py) held against minio_tpu's.

tests/test_sts_federation.py's cases rebound to the port (each case's code
runs with the names it imports from minio_tpu bound to their
minio_tpu_torch counterparts, tests/test_torch_iam.rebound): OpenID
HS256 tokens and their failure modes, the policy claim's shapes, an RS256
token through ``cryptography``, the LDAP simple bind against the fake
directory, DN escaping, a fragmented BindResponse, and over HTTP the
web-identity, client-grants and LDAP flows and the cap of a minted
credential at its token's expiry. Beside them, the providers the
handlers build from the config KV (``identity_openid`` and
``identity_ldap``, no provider attached by hand) on twin servers: the
same statuses from both packages.
"""

from __future__ import annotations

import json

import pytest

import tests.test_sts_federation as ref_cases
from minio_tpu.config import ConfigSys as RefConfigSys
from minio_tpu.iam import IAMSys as RefIAMSys
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu_torch.config import ConfigSys
from minio_tpu_torch.iam import IAMSys
from minio_tpu_torch.iam.providers import OpenIDProvider
from minio_tpu_torch.s3.server import S3Server
from tests.test_sts_federation import (FakeLDAPServer, claims, hs_jwks,
                                       make_jwt, sts_post)
from tests.test_torch_iam import (CREDS, REGION, _ref_sets, _sets,
                                  rebound)

DN_FORMAT = "uid=%s,ou=people,dc=example,dc=org"


@pytest.fixture()
def ldap_server():
    s = FakeLDAPServer({"uid=bob,ou=people,dc=example,dc=org": "bobsecret"})
    yield s
    s.close()


@pytest.fixture()
def fed_server(tmp_path):
    layer = _sets(tmp_path)
    iam = IAMSys(layer, root_cred=CREDS)
    srv = S3Server(layer, creds=CREDS, region=REGION, iam=iam).start()
    srv.api.openid_provider = OpenIDProvider(
        {"jwks": hs_jwks(), "client_id": "minio-app"})
    yield srv, iam
    srv.stop()
    layer.close()


def _case(name, **subs):
    return rebound(getattr(ref_cases, name), CREDS=CREDS, **subs)


@pytest.mark.parametrize("name", ["test_openid_happy_path",
                                  "test_openid_failure_modes"])
def test_reference_openid_provider_cases(name):
    _case(name)(OpenIDProvider({"jwks": hs_jwks(),
                                "client_id": "minio-app"}))


@pytest.mark.parametrize("name", ["test_openid_policy_claim_shapes",
                                  "test_openid_rs256_roundtrip",
                                  "test_ldap_fragmented_response"])
def test_reference_standalone_cases(name):
    _case(name)()


@pytest.mark.parametrize("name", ["test_ldap_bind_success_and_failures",
                                  "test_ldap_dn_injection_escaped"])
def test_reference_ldap_cases(ldap_server, name):
    _case(name)(ldap_server)


@pytest.mark.parametrize("name", ["test_e2e_web_identity",
                                  "test_minted_cred_capped_by_token_exp"])
def test_reference_http_cases(fed_server, name):
    _case(name)(fed_server)


def test_reference_http_ldap_case(fed_server, ldap_server):
    _case("test_e2e_ldap_identity")(fed_server, ldap_server)


def test_config_built_providers_answer_as_reference(tmp_path, ldap_server):
    """identity_openid / identity_ldap set in each package's ConfigSys:
    the handlers build the providers from it, and both servers answer
    the same federation sequence with the same statuses."""
    out = []
    for tag, sets_fn, iam_cls, srv_cls, cfg_cls in (
            ("ref", _ref_sets, RefIAMSys, RefServer, RefConfigSys),
            ("port", _sets, IAMSys, S3Server, ConfigSys)):
        (tmp_path / tag).mkdir()
        layer = sets_fn(tmp_path / tag)
        iam = iam_cls(layer, root_cred=CREDS)
        srv = srv_cls(layer, creds=CREDS, region=REGION, iam=iam).start()
        cfg = cfg_cls(layer, secret=CREDS.secret_key)
        srv.api.config = cfg
        try:
            statuses = [sts_post(srv.port, {
                "Action": "AssumeRoleWithWebIdentity",
                "Version": "2011-06-15",
                "WebIdentityToken": make_jwt(claims())})[0]]
            cfg.set_kv("identity_openid", jwks=hs_jwks(),
                       client_id="minio-app")
            cfg.set_kv("identity_ldap",
                       server_addr=f"127.0.0.1:{ldap_server.port}",
                       user_dn_format=DN_FORMAT)
            iam.attach_policy(
                "readonly", user="ldap:" + DN_FORMAT % "bob")
            for form in (
                    {"Action": "AssumeRoleWithWebIdentity",
                     "WebIdentityToken": make_jwt(claims())},
                    {"Action": "AssumeRoleWithWebIdentity",
                     "WebIdentityToken": make_jwt(claims(), tamper=True)},
                    {"Action": "AssumeRoleWithClientGrants",
                     "Token": make_jwt(claims(policy="readonly"))},
                    {"Action": "AssumeRoleWithLDAPIdentity",
                     "LDAPUsername": "bob", "LDAPPassword": "bobsecret"},
                    {"Action": "AssumeRoleWithLDAPIdentity",
                     "LDAPUsername": "bob", "LDAPPassword": "wrong"},
                    {"Action": "NoSuchAction"}):
                form["Version"] = "2011-06-15"
                statuses.append(sts_post(srv.port, form)[0])
            out.append((statuses, json.dumps(cfg.get_subsys(
                "identity_ldap"), sort_keys=True)))
        finally:
            srv.stop()
            layer.close()
    assert out[0] == out[1]
    assert out[1][0] == [501, 200, 403, 200, 200, 403, 400]
