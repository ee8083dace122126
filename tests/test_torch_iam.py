"""The port's identity plane (minio_tpu_torch/iam/, the identity half of
s3/handlers.py) held against minio_tpu's.

  * tests/test_iam.py's cases rebound to the port (``rebound``: each case's
    code runs with the names it imports from minio_tpu bound to their
    minio_tpu_torch counterparts): policy evaluation, IAMSys in memory,
    persistence over an erasure set and the HTTP cases (denied then
    allowed, STS AssumeRole, anonymous access through a bucket policy);
  * IAM records written by either package over the same drives load in
    the other, the whole cache equal;
  * the policy matrix: for every S3 verb the port serves, a user allowed
    only that verb's action and one denied only that action, on twin
    servers (the reference's and the port's, identities pinned in both):
    the same statuses and masked bodies from both packages;
  * twin single-node servers with IAM and the admin router taking one
    signed sequence (users, a group, a custom policy, a service account,
    an AssumeRole credential with and without its token, anonymous GET
    through a bucket policy, a copy across buckets, a denied Select):
    equal statuses, masked bodies and headers, and equal drive files,
    ``.minio.sys/config/iam/`` included.
Every comparison is byte for byte (tolerance 0). Four drives at 2+2 and
64 KiB blocks, device="cpu".
"""

from __future__ import annotations

import builtins
import importlib
import json
import types
import urllib.parse

import numpy as np
import pytest
import torch

import minio_tpu.features.crypto as ref_crypto
import minio_tpu.iam.sys as ref_iam_sys
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.iam.sys as port_iam_sys
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
import tests.test_iam as ref_cases
from minio_tpu.iam import IAMSys as RefIAMSys
from minio_tpu.object.sets import ErasureSets as RefSets
from minio_tpu.s3.admin import mount_admin as ref_mount_admin
from minio_tpu.s3.credentials import Credentials as RefCredentials
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu_torch.iam import IAMSys
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.admin import mount_admin
from minio_tpu_torch.s3.credentials import Credentials
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.scripts import scan_cases
from tests.test_s3 import S3TestClient
from tests.test_torch_s3 import _norm, drive_files

CREDS = Credentials("rootiamkey", "rootiamsecretkey")
REGION = "us-east-1"
N, M, BS = 4, 2, 1 << 16


# -- rebinding the reference's cases to the port ------------------------------

def _port_name(name: str) -> str:
    return "minio_tpu_torch" + name[len("minio_tpu"):]


def _is_ref(name) -> bool:
    return isinstance(name, str) and (name == "minio_tpu"
                                      or name.startswith("minio_tpu."))


def port_of(v):
    """The port's counterpart of a reference module, class or function
    (same relative module, same qualified name); anything else as is."""
    if isinstance(v, types.ModuleType):
        return importlib.import_module(_port_name(v.__name__)) \
            if _is_ref(v.__name__) else v
    if isinstance(v, (type, types.FunctionType)) and _is_ref(v.__module__):
        obj = importlib.import_module(_port_name(v.__module__))
        for part in v.__qualname__.split("."):
            obj = getattr(obj, part)
        return obj
    return v


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and _is_ref(name):
        name = _port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


def rebound(fn, **subs):
    """`fn` (a function of a reference test module) with every global it
    reads, and every import it runs, bound to the port; the module's own
    helper functions are rebound alike. `subs` overrides globals."""
    def rebind(f, g):
        out = types.FunctionType(f.__code__, g, f.__name__, f.__defaults__,
                                 f.__closure__)
        out.__kwdefaults__ = f.__kwdefaults__
        return out

    g = {k: port_of(v) for k, v in fn.__globals__.items()}
    g["__builtins__"] = dict(vars(builtins), __import__=_import)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and \
                v.__module__ == fn.__module__:
            g[k] = rebind(v, g)
    g.update(subs)
    return rebind(fn, g)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PURE = ["test_policy_wildcards_and_deny_wins",
         "test_policy_bucket_level_actions",
         "test_policy_principal_matching", "test_policy_conditions",
         "test_policy_bool_and_negated_absent_key",
         "test_policy_ip_condition_cidr", "test_iamsys_user_policy_flow",
         "test_iamsys_group_policy", "test_iamsys_custom_policy_and_deny",
         "test_iamsys_service_account_inherits_parent",
         "test_iamsys_bucket_policy_grants_foreign_user",
         "test_condition_operator_matrix"]


@pytest.mark.parametrize("name", _PURE)
def test_reference_policy_and_iamsys_cases(name):
    rebound(getattr(ref_cases, name))()


def _sets(root, tag="d"):
    return ErasureSets.from_drives([str(root / f"{tag}{i}")
                                    for i in range(N)], 1, N, M,
                                   block_size=BS, device="cpu")


def _ref_sets(root, tag="d"):
    return RefSets.from_drives([str(root / f"{tag}{i}") for i in range(N)],
                               1, N, M, block_size=BS)


@pytest.mark.parametrize("name", [
    "test_iamsys_persistence_roundtrip",
    "test_federated_subject_policy_files_never_collide"])
def test_reference_persistence_cases(tmp_path, name):
    layer = _sets(tmp_path)
    try:
        rebound(getattr(ref_cases, name))(layer)
    finally:
        layer.close()


@pytest.mark.parametrize("name", [
    "test_e2e_user_denied_then_allowed", "test_e2e_sts_assume_role",
    "test_e2e_anonymous_via_bucket_policy"])
def test_reference_http_cases(tmp_path, name):
    layer = _sets(tmp_path)
    iam = IAMSys(layer, root_cred=CREDS)
    srv = S3Server(layer, creds=CREDS, region=REGION, iam=iam).start()
    iam.bucket_policy_lookup = \
        lambda b: srv.api.bucket_meta.get(b).policy_json
    try:
        rebound(getattr(ref_cases, name), CREDS=CREDS)((srv, iam))
    finally:
        srv.stop()
        layer.close()


# -- records across the packages ---------------------------------------------

def _cache(iam) -> dict:
    """The whole IAM cache in plain values."""
    def cred(c):
        return (c.access_key, c.secret_key, c.session_token, c.expiration,
                c.status, c.parent_user)
    return {"users": {k: cred(v) for k, v in iam.users.items()},
            "groups": iam.groups,
            "policies": {k: json.loads(v.to_json())
                         for k, v in iam.policies.items()},
            "user_policy": iam.user_policy,
            "group_policy": iam.group_policy,
            "svc": {k: cred(v) for k, v in iam.svc_accounts.items()},
            "sts": {k: cred(v) for k, v in iam.sts_creds.items()}}


def _fill(iam, pol_cls):
    iam.add_user("alice", "alicesecret1")
    iam.add_user("bob", "bobsecret123")
    iam.add_members_to_group("devs", ["alice", "bob"])
    iam.set_policy("rw-x", pol_cls.from_json(json.dumps({
        "Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Action": ["s3:*"],
            "Resource": ["arn:aws:s3:::x", "arn:aws:s3:::x/*"]}]})))
    iam.attach_policy("rw-x", group="devs")
    iam.attach_policy("readonly", user="bob")
    iam.new_service_account("alice", "svcaccess1", "svcsecret123")
    iam.assume_role(iam.get_credentials("bob"), 3600)
    iam.assume_role_with_claims("oidc:a/b", ["readonly"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_records_load_in_the_other_package(tmp_path, writer):
    from minio_tpu.iam import Policy as RefPolicy
    from minio_tpu_torch.iam import Policy
    if writer == "reference":
        w_layer, w_iam = _ref_sets(tmp_path), None
        w_iam = RefIAMSys(w_layer, root_cred=CREDS)
        _fill(w_iam, RefPolicy)
    else:
        w_layer = _sets(tmp_path)
        w_iam = IAMSys(w_layer, root_cred=CREDS)
        _fill(w_iam, Policy)
    want = _cache(w_iam)
    w_layer.close()
    if writer == "reference":
        r_layer = _sets(tmp_path)
        r_iam = IAMSys(r_layer, root_cred=CREDS)
    else:
        r_layer = _ref_sets(tmp_path)
        r_iam = RefIAMSys(r_layer, root_cred=CREDS)
    try:
        assert _cache(r_iam) == want
        assert len(want["sts"]) == 2 and want["svc"]
        # the reader serves what it loaded
        cred = r_iam.get_credentials("svcaccess1")
        assert r_iam.is_allowed(cred, "s3:PutObject", "x", "o")
        assert not r_iam.is_allowed(cred, "s3:PutObject", "y", "o")
        r_iam.remove_user("alice")
        assert r_iam.get_credentials("svcaccess1") is None
    finally:
        r_layer.close()


# -- twin servers with pinned identities ------------------------------------

class _PinnedIAM:
    """generate_credentials, secrets and time of an iam/sys.py module
    from counters, so that both packages mint the same keys, tokens and
    expirations."""

    def __init__(self, cred_cls):
        self.n = 0
        self.cred_cls = cred_cls
        self.rng = np.random.default_rng(5)

    def generate_credentials(self):
        self.n += 1
        return self.cred_cls(access_key=f"GENKEY{self.n:014d}",
                             secret_key=f"gensecret{self.n:031d}")

    def token_bytes(self, n):
        return self.rng.bytes(n)

    @staticmethod
    def time():
        # a fixed clock late enough that minted STS credentials are
        # still valid by the host's real clock
        return 4.0e9

    @staticmethod
    def perf_counter():
        import time
        return time.perf_counter()


def pin_both(monkeypatch):
    """Every source of identity pinned in both packages (ids, clocks, key
    material, minted credentials)."""
    from tests.test_torch_s3 import pin
    pin(monkeypatch, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(monkeypatch, port_engine, port_multipart, port_bmeta,
        port_handlers, port_crypto)
    for mod, cls in ((ref_iam_sys, RefCredentials),
                     (port_iam_sys, Credentials)):
        p = _PinnedIAM(cls)
        monkeypatch.setattr(mod, "generate_credentials",
                            p.generate_credentials)
        monkeypatch.setattr(mod, "secrets", p)
        monkeypatch.setattr(mod, "time", p)


def _twin_servers(root):
    """(reference, port) S3Servers with IAM over their sets and the admin
    router mounted, on drives under root/ref and root/port."""
    out = []
    for tag, sets_fn, iam_cls, srv_cls, mount in (
            ("ref", _ref_sets, RefIAMSys, RefServer, ref_mount_admin),
            ("port", _sets, IAMSys, S3Server, mount_admin)):
        (root / tag).mkdir()
        layer = sets_fn(root / tag)
        iam = iam_cls(layer, root_cred=CREDS)
        srv = srv_cls(layer, creds=CREDS, region=REGION, iam=iam)
        iam.bucket_policy_lookup = \
            (lambda s: lambda b: s.api.bucket_meta.get(b).policy_json)(srv)
        mount(srv)
        out.append((srv.start(), layer))
    return out


def _send(port, creds, method, path, query=None, body=b"", headers=None):
    """One request signed by `creds` (a temporary credential's session
    token rides in x-amz-security-token, as the signer puts it)."""
    return S3TestClient("127.0.0.1", port, creds).request(
        method, path, query=query, body=body, headers=headers)


def _anon(port, method, path):
    return S3TestClient("127.0.0.1", port).request(method, path,
                                                   sign=False)


# -- the policy matrix --------------------------------------------------------

def _select_body():
    return scan_cases.select_xml("SELECT COUNT(*) FROM S3Object", "CSV",
                                 "CSV", "NONE")


def _complete_xml(etag):
    return (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{etag}</ETag></Part></CompleteMultipartUpload>"
            ).encode()


def _upload(port, key):
    """A session on mx/key opened by root; its upload id."""
    import re
    out = _send(port, CREDS, "POST", f"/mtx/{key}", {"uploads": ""})
    return re.search(rb"<UploadId>([^<]+)</UploadId>", out[2])[1].decode()


# verb -> (action, request(port, creds, role) -> response, prep(port, role))
# prep runs as root just before the request; each role's request works on
# keys and buckets of its own, so that an allowed mutation leaves the
# other role's state as it was
_VERBS = {
    "ListBuckets": ("s3:ListAllMyBuckets",
                    lambda p, c, r: _send(p, c, "GET", "/"), None),
    "MakeBucket": ("s3:CreateBucket",
                   lambda p, c, r: _send(p, c, "PUT", f"/mk-{r}"), None),
    "HeadBucket": ("s3:ListBucket",
                   lambda p, c, r: _send(p, c, "HEAD", "/mtx"), None),
    "DeleteBucket": ("s3:DeleteBucket",
                     lambda p, c, r: _send(p, c, "DELETE", f"/del-{r}"),
                     lambda p, r: _send(p, CREDS, "PUT", f"/del-{r}")),
    "GetBucketLocation": ("s3:GetBucketLocation",
                          lambda p, c, r: _send(p, c, "GET", "/mtx",
                                                {"location": ""}), None),
    "GetBucketVersioning": ("s3:GetBucketVersioning",
                            lambda p, c, r: _send(p, c, "GET", "/mtx",
                                                  {"versioning": ""}),
                            None),
    "PutBucketVersioning": (
        "s3:PutBucketVersioning",
        lambda p, c, r: _send(p, c, "PUT", f"/vb-{r}", {"versioning": ""},
                              b"<VersioningConfiguration><Status>Suspended"
                              b"</Status></VersioningConfiguration>"),
        lambda p, r: _send(p, CREDS, "PUT", f"/vb-{r}")),
    "GetBucketPolicy": ("s3:GetBucketPolicy",
                        lambda p, c, r: _send(p, c, "GET", "/mtx",
                                              {"policy": ""}), None),
    "PutBucketPolicy": (
        "s3:PutBucketPolicy",
        lambda p, c, r: _send(p, c, "PUT", f"/pb-{r}", {"policy": ""},
                              b'{"Version":"2012-10-17"}'),
        lambda p, r: _send(p, CREDS, "PUT", f"/pb-{r}")),
    "DeleteBucketPolicy": ("s3:DeleteBucketPolicy",
                           lambda p, c, r: _send(p, c, "DELETE", "/mtx",
                                                 {"policy": ""}), None),
    "GetBucketTagging": ("s3:GetBucketTagging",
                         lambda p, c, r: _send(p, c, "GET", "/mtx",
                                               {"tagging": ""}), None),
    "PutBucketTagging": (
        "s3:PutBucketTagging",
        lambda p, c, r: _send(p, c, "PUT", "/mtx", {"tagging": ""},
                              b"<Tagging><TagSet><Tag><Key>k</Key><Value>"
                              b"v</Value></Tag></TagSet></Tagging>"), None),
    "DeleteBucketTagging": ("s3:PutBucketTagging",
                            lambda p, c, r: _send(p, c, "DELETE", "/mtx",
                                                  {"tagging": ""}), None),
    "GetBucketLifecycle": ("s3:GetLifecycleConfiguration",
                           lambda p, c, r: _send(p, c, "GET", "/mtx",
                                                 {"lifecycle": ""}), None),
    "PutBucketLifecycle": (
        "s3:PutLifecycleConfiguration",
        lambda p, c, r: _send(p, c, "PUT", "/mtx", {"lifecycle": ""},
                              b"<LifecycleConfiguration><Rule><ID>r</ID>"
                              b"<Status>Disabled</Status></Rule>"
                              b"</LifecycleConfiguration>"), None),
    "DeleteBucketLifecycle": ("s3:PutLifecycleConfiguration",
                              lambda p, c, r: _send(p, c, "DELETE", "/mtx",
                                                    {"lifecycle": ""}),
                              None),
    "GetBucketEncryption": ("s3:GetEncryptionConfiguration",
                            lambda p, c, r: _send(p, c, "GET", "/mtx",
                                                  {"encryption": ""}),
                            None),
    "PutBucketEncryption": (
        "s3:PutEncryptionConfiguration",
        lambda p, c, r: _send(p, c, "PUT", "/mtx", {"encryption": ""},
                              b"<ServerSideEncryptionConfiguration>"
                              b"</ServerSideEncryptionConfiguration>"),
        None),
    "DeleteBucketEncryption": ("s3:PutEncryptionConfiguration",
                               lambda p, c, r: _send(p, c, "DELETE", "/mtx",
                                                     {"encryption": ""}),
                               None),
    "ListObjectsV1": ("s3:ListBucket",
                      lambda p, c, r: _send(p, c, "GET", "/mtx"), None),
    "ListObjectsV2": ("s3:ListBucket",
                      lambda p, c, r: _send(p, c, "GET", "/mtx",
                                            {"list-type": "2"}), None),
    "ListObjectVersions": ("s3:ListBucketVersions",
                           lambda p, c, r: _send(p, c, "GET", "/mtx",
                                                 {"versions": ""}), None),
    "DeleteObjects": (
        "s3:DeleteObject",
        lambda p, c, r: _send(p, c, "POST", "/mtx", {"delete": ""},
                              f"<Delete><Object><Key>dm-{r}</Key></Object>"
                              f"</Delete>".encode()),
        lambda p, r: _send(p, CREDS, "PUT", f"/mtx/dm-{r}", body=b"dm")),
    "ListMultipartUploads": ("s3:ListBucketMultipartUploads",
                             lambda p, c, r: _send(p, c, "GET", "/mtx",
                                                   {"uploads": ""}), None),
    "PutObject": ("s3:PutObject",
                  lambda p, c, r: _send(p, c, "PUT", f"/mtx/put-{r}",
                                        body=b"put" * 100), None),
    "GetObject": ("s3:GetObject",
                  lambda p, c, r: _send(p, c, "GET", "/mtx/o"), None),
    "HeadObject": ("s3:GetObject",
                   lambda p, c, r: _send(p, c, "HEAD", "/mtx/o"), None),
    "DeleteObject": ("s3:DeleteObject",
                     lambda p, c, r: _send(p, c, "DELETE", f"/mtx/d-{r}"),
                     lambda p, r: _send(p, CREDS, "PUT", f"/mtx/d-{r}",
                                        body=b"d")),
    "RestoreObject": ("s3:RestoreObject",
                      lambda p, c, r: _send(p, c, "POST", "/mtx/o",
                                            {"restore": ""},
                                            b"<RestoreRequest><Days>1"
                                            b"</Days></RestoreRequest>"),
                      None),
    "CopyObject": ("s3:PutObject",
                   lambda p, c, r: _send(p, c, "PUT", f"/mtx/cp-{r}",
                                         headers={"x-amz-copy-source":
                                                  "/mtx/o"}), None),
    "CreateMultipartUpload": ("s3:PutObject",
                              lambda p, c, r: _send(p, c, "POST",
                                                    f"/mtx/mp-{r}",
                                                    {"uploads": ""}),
                              None),
    "UploadPart": ("s3:PutObject", lambda p, c, r: _send(
        p, c, "PUT", f"/mtx/up-{r}",
        {"uploadId": _STATE[p][f"up-{r}"], "partNumber": "1"}, b"part"),
        lambda p, r: _STATE[p].__setitem__(f"up-{r}",
                                           _upload(p, f"up-{r}"))),
    "UploadPartCopy": ("s3:PutObject", lambda p, c, r: _send(
        p, c, "PUT", f"/mtx/upc-{r}",
        {"uploadId": _STATE[p][f"upc-{r}"], "partNumber": "1"},
        headers={"x-amz-copy-source": "/mtx/o"}),
        lambda p, r: _STATE[p].__setitem__(f"upc-{r}",
                                           _upload(p, f"upc-{r}"))),
    "CompleteMultipartUpload": ("s3:PutObject", lambda p, c, r: _send(
        p, c, "POST", f"/mtx/cm-{r}", {"uploadId": _STATE[p][f"cm-{r}"]},
        _complete_xml(_STATE[p][f"cm-{r}-etag"])), lambda p, r: _prep_cm(
        p, r)),
    "AbortMultipartUpload": ("s3:AbortMultipartUpload", lambda p, c, r:
                             _send(p, c, "DELETE", f"/mtx/ab-{r}",
                                   {"uploadId": _STATE[p][f"ab-{r}"]}),
                             lambda p, r: _STATE[p].__setitem__(
                                 f"ab-{r}", _upload(p, f"ab-{r}"))),
    "ListParts": ("s3:ListMultipartUploadParts", lambda p, c, r:
                  _send(p, c, "GET", f"/mtx/lp-{r}",
                        {"uploadId": _STATE[p][f"lp-{r}"]}),
                  lambda p, r: _STATE[p].__setitem__(
                      f"lp-{r}", _upload(p, f"lp-{r}"))),
    "GetObjectTagging": ("s3:GetObjectTagging",
                         lambda p, c, r: _send(p, c, "GET", "/mtx/o",
                                               {"tagging": ""}), None),
    "PutObjectTagging": (
        "s3:PutObjectTagging",
        lambda p, c, r: _send(p, c, "PUT", "/mtx/o", {"tagging": ""},
                              b"<Tagging><TagSet><Tag><Key>t</Key><Value>"
                              b"1</Value></Tag></TagSet></Tagging>"), None),
    "DeleteObjectTagging": ("s3:DeleteObjectTagging",
                            lambda p, c, r: _send(p, c, "DELETE", "/mtx/o",
                                                  {"tagging": ""}), None),
    "SelectObjectContent": ("s3:GetObject",
                            lambda p, c, r: _send(p, c, "POST", "/mtx/t.csv",
                                                  {"select": "",
                                                   "select-type": "2"},
                                                  _select_body()), None),
}

_STATE: dict = {}


def _prep_cm(port, role):
    uid = _upload(port, f"cm-{role}")
    out = _send(port, CREDS, "PUT", f"/mtx/cm-{role}",
                {"uploadId": uid, "partNumber": "1"}, b"complete")
    _STATE[port][f"cm-{role}"] = uid
    _STATE[port][f"cm-{role}-etag"] = out[1]["etag"]


def _policy(effect_action: list) -> str:
    return json.dumps({"Version": "2012-10-17", "Statement": [
        {"Effect": e, "Action": [a], "Resource": ["arn:aws:s3:::*"]}
        for e, a in effect_action]})


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """Twin servers with one user per (action, role): `only-<action>` is
    allowed that action alone, `but-<action>` everything but it."""
    root = tmp_path_factory.mktemp("matrix")
    with pytest.MonkeyPatch.context() as mp:
        pin_both(mp)
        servers = _twin_servers(root)
        users = {}
        for (srv, _layer) in servers:
            _STATE[srv.port] = {}
            iam = srv.api.iam
            for action in sorted({v[0] for v in _VERBS.values()}):
                tag = action.split(":")[1].lower()
                for role, doc in (
                        ("only", [("Allow", action)]),
                        ("but", [("Allow", "s3:*"), ("Deny", action)])):
                    ak = f"{role}{tag}"[:20]
                    iam.add_user(ak, f"{ak}-secret")
                    policy_cls = type(iam.policies["readonly"])
                    iam.set_policy(f"{role}-{tag}",
                                   policy_cls.from_json(_policy(doc)))
                    iam.attach_policy(f"{role}-{tag}", user=ak)
                    users[(action, role)] = type(CREDS)(ak, f"{ak}-secret")
            p = srv.port
            assert _send(p, CREDS, "PUT", "/mtx")[0] == 200
            assert _send(p, CREDS, "PUT", "/mtx/o", body=b"object" * 99)[0] \
                == 200
            csv = scan_cases.csv_corpus(__import__("random").Random(3), 50)
            assert _send(p, CREDS, "PUT", "/mtx/t.csv", body=csv)[0] == 200
        yield servers, users, mp
        for srv, layer in servers:
            srv.stop()
            layer.close()


@pytest.mark.parametrize("verb", list(_VERBS))
def test_policy_matrix(matrix, verb):
    servers, users, _mp = matrix
    action, request, prep = _VERBS[verb]
    got = []
    for srv, _layer in servers:
        outs = []
        # the denied user first: a refused request changes nothing
        for role in ("but", "only"):
            if prep is not None:
                prep(srv.port, role)
            outs.append(_norm(request(srv.port, users[(action, role)],
                                      role)))
        got.append(outs)
    (ref_but, ref_only), (port_but, port_only) = got
    assert port_but == ref_but
    assert port_only == ref_only
    assert port_but[0] == 403
    assert b"AccessDenied" in port_but[2] or not port_but[2]    # HEAD
    assert port_only[0] != 403 or verb in ("CopyObject", "UploadPartCopy")


# -- the twin IAM sequence ----------------------------------------------------

def _admin(port, method, sub, query=None, body=b""):
    return _send(port, CREDS, method, f"/minio/admin/v3/{sub}", query, body)


def _sts_creds(body: bytes, cred_cls):
    import xml.etree.ElementTree as ET
    ns = {"sts": "https://sts.amazonaws.com/doc/2011-06-15/"}
    ce = ET.fromstring(body).find(".//sts:Credentials", ns)
    return cred_cls(access_key=ce.find("sts:AccessKeyId", ns).text,
                    secret_key=ce.find("sts:SecretAccessKey", ns).text,
                    session_token=ce.find("sts:SessionToken", ns).text)


def twin_iam_sequence():
    """Steps c(port, state) -> response, run against each server."""
    steps = []
    alice = Credentials("alice", "alicesecret1")
    bob = Credentials("bob", "bobsecret123")
    rw_a = json.dumps({"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Action": ["s3:*"],
        "Resource": ["arn:aws:s3:::bka", "arn:aws:s3:::bka/*"]}]}).encode()
    get_b = json.dumps({"Version": "2012-10-17", "Statement": [
        {"Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject"],
         "Resource": ["arn:aws:s3:::bkb/*"]},
        {"Effect": "Deny", "Action": ["s3:GetObject"],
         "Resource": ["arn:aws:s3:::bkb/secret*"]}]}).encode()
    anon_pol = json.dumps({"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Principal": {"AWS": ["*"]},
        "Action": ["s3:GetObject"],
        "Resource": ["arn:aws:s3:::pub/*"]}]}).encode()

    def s(fn):
        steps.append(fn)

    def admin(method, sub, query=None, body=b""):
        s(lambda p, st: _admin(p, method, sub, query, body))

    def as_(creds, method, path, query=None, body=b"", headers=None):
        s(lambda p, st: _send(p, creds, method, path, query, body, headers))

    for b in ("bka", "bkb", "pub"):
        as_(CREDS, "PUT", f"/{b}")
    admin("PUT", "add-user", {"accessKey": "alice"},
          json.dumps({"secretKey": "alicesecret1"}).encode())
    admin("PUT", "add-user", {"accessKey": "bob"},
          json.dumps({"secretKey": "bobsecret123"}).encode())
    admin("GET", "list-users")
    as_(alice, "PUT", "/bka/o", body=b"denied")
    admin("PUT", "add-canned-policy", {"name": "rw-a"}, rw_a)
    admin("PUT", "add-canned-policy", {"name": "get-b"}, get_b)
    admin("GET", "list-canned-policies")
    # the reference's router has no group route: the group is filled
    # through each server's IAMSys, as an operator of it would
    s(lambda p, st: (st["iam"].add_members_to_group("team",
                                                    ["alice", "bob"]),
                     (200, {}, b""))[1])
    admin("PUT", "set-user-or-group-policy",
          {"policyName": "rw-a", "userOrGroup": "team", "isGroup": "true"})
    admin("PUT", "set-user-or-group-policy",
          {"policyName": "get-b", "userOrGroup": "alice",
           "isGroup": "false"})
    as_(alice, "PUT", "/bka/o", body=b"alice-object" * 50)
    as_(bob, "PUT", "/bka/bob", body=b"bob-object" * 70)
    as_(alice, "GET", "/bka/o")
    as_(alice, "PUT", "/bkb/o", body=b"b-object")
    as_(alice, "PUT", "/bkb/secret1", body=b"s-object")
    as_(alice, "GET", "/bkb/secret1")
    as_(bob, "PUT", "/bkb/o2", body=b"x")
    # a copy across buckets: alice reads ba and writes bb; bob cannot
    as_(alice, "PUT", "/bkb/copy", headers={"x-amz-copy-source": "/bka/o"})
    as_(bob, "PUT", "/bka/copy", headers={"x-amz-copy-source": "/bkb/o"})
    # a service account inherits its parent's policies
    admin("PUT", "add-service-account", None, json.dumps(
        {"parent": "alice"}).encode())

    def svc(p, st):
        st["svc"] = Credentials(**dict(zip(
            ("access_key", "secret_key"),
            (lambda d: (d["accessKey"], d["secretKey"]))(
                json.loads(st["last"][2])))))
        return _send(p, st["svc"], "GET", "/bka/o")
    s(svc)
    s(lambda p, st: _send(p, st["svc"], "PUT", "/pub/x", body=b"no"))
    # STS AssumeRole, with and without its session token
    form = urllib.parse.urlencode({"Action": "AssumeRole",
                                   "Version": "2011-06-15",
                                   "DurationSeconds": "1800"}).encode()
    as_(bob, "POST", "/", body=form)

    def sts_get(p, st):
        st["sts"] = _sts_creds(st["last"][2], Credentials)
        return _send(p, st["sts"], "GET", "/bka/bob")
    s(sts_get)
    s(lambda p, st: _send(p, st["sts"], "PUT", "/bka/sts", body=b"temp" * 9))
    s(lambda p, st: _send(p, Credentials(st["sts"].access_key,
                                         st["sts"].secret_key),
                          "GET", "/bka/bob"))
    s(lambda p, st: _send(p, st["sts"], "POST", "/", body=form))
    # anonymous GET through a bucket policy
    as_(CREDS, "PUT", "/pub/o", body=b"public")
    s(lambda p, st: _anon(p, "GET", "/pub/o"))
    as_(CREDS, "PUT", "/pub", {"policy": ""}, anon_pol)
    s(lambda p, st: _anon(p, "GET", "/pub/o"))
    s(lambda p, st: _anon(p, "PUT", "/pub/o2"))
    # a Select by a user allowed GetObject, and a denied one
    csv = scan_cases.csv_corpus(__import__("random").Random(4), 80)
    as_(CREDS, "PUT", "/bkb/t.csv", body=csv)
    as_(CREDS, "PUT", "/bkb/secret.csv", body=csv)
    for key in ("t.csv", "secret.csv"):
        as_(alice, "POST", f"/bkb/{key}", {"select": "", "select-type": "2"},
            _select_body())
    # disable and remove
    admin("PUT", "set-user-status", {"accessKey": "bob", "status": "off"})
    as_(bob, "GET", "/bka/bob")
    admin("DELETE", "remove-user", {"accessKey": "alice"})
    s(lambda p, st: _send(p, st["svc"], "GET", "/bka/o"))
    admin("DELETE", "remove-canned-policy", {"name": "get-b"})
    admin("GET", "list-canned-policies")
    return steps


# what each step of twin_iam_sequence answers: refusals by policy (6, 18,
# 19, 21, 24, 31, 34, 38), by the missing session token (28), of a
# temporary credential re-assuming (29), of a disabled or removed user
# and of the removed user's service account (40, 42)
_TWIN_STATUSES = [200, 200, 200, 200, 200, 200, 403, 200, 200, 200, 200,
                  200, 200, 200, 200, 200, 200, 200, 403, 403, 200, 403,
                  200, 200, 403, 200, 200, 200, 403, 403, 200, 403, 204,
                  200, 403, 200, 200, 200, 403, 200, 403, 200, 403, 200,
                  200]


@pytest.mark.parametrize("edge", ["on", "off"])
def test_twin_iam_servers_answer_as_reference(tmp_path, monkeypatch, edge):
    monkeypatch.setenv("MINIO_TPU_EDGE", edge)
    pin_both(monkeypatch)
    servers = _twin_servers(tmp_path)
    try:
        states = [{"iam": srv.api.iam} for srv, _layer in servers]
        statuses = []
        for i, step in enumerate(twin_iam_sequence()):
            outs = []
            for (srv, _layer), st in zip(servers, states):
                out = step(srv.port, st)
                st["last"] = out
                outs.append(_norm(out))
            a, b = outs
            statuses.append(b[0])
            assert a[0] == b[0], f"step {i}: status {a[0]} != {b[0]}"
            assert a[1] == b[1], f"step {i}: headers differ"
            assert a[2] == b[2], f"step {i}: bodies differ"
        assert states[1]["sts"].access_key == states[0]["sts"].access_key
        assert statuses == _TWIN_STATUSES
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
    want = drive_files(tmp_path / "ref")
    got = drive_files(tmp_path / "port")
    assert sorted(want) == sorted(got)
    assert any("config/iam/sts/" in k for k in want)
    assert [k for k in want if want[k] != got[k]] == []
