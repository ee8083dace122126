"""The port's admin, health and Prometheus routers (minio_tpu_torch/s3/
admin.py), its madmin client and the federated merge (utils/promfed.py)
held against minio_tpu's.

  * tests/test_admin.py's cases for the ported routes rebound to the port
    (tests/test_torch_iam.rebound): health, auth and the STS session
    token, info and storage, MRF stats, the IAM and policy routes, the
    heal sequence, the metrics endpoint, the madmin SDK, the service
    action, the metacache stats (on and off) and the topology and
    rebalance surface; the quota / remote-target case (on a server of
    its own: the remote target mounts into the port's legacy replication
    pool and persists in the bucket metadata);
  * the one admin route of a plane the port has not got (bandwidth)
    answers a JSON NotImplemented that names the plane; the test-only
    naughtynet route
    refuses as the reference's does with its knob off, and answers the
    reference's status with it on;
  * upstream's update-group-members, which the reference's router lacks;
  * the notification plane's routes (GET notify, PUT and DELETE
    notify/target) through each package's madmin on twin servers, equal
    answers and refusals;
  * the replication plane's routes (replicate, replicate/key,
    replicate/target, replicate/resync with a resync run to its end) and
    the bucket remote-target routes through each package's madmin on
    twin servers, equal answers and refusals;
  * twin servers (reference and port, identities pinned) answer the
    admin GETs and a heal with equal JSON, volatile fields masked;
  * the Prometheus families both packages export after the same traffic
    (replication's push, failed sync and prune among it) agree in type
    and label names; every family the port exports is one
    the reference declares, but for the ones listed here (ROADMAP Queue
    C names those only the reference exports);
  * promfed's merge is the reference's on the same expositions.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import sys
import time

import pytest
import torch

import tests.test_admin as ref_cases
from minio_tpu.utils import promfed as ref_promfed
from minio_tpu_torch import device as device_mod
from minio_tpu_torch import madmin
from minio_tpu_torch.iam import IAMSys
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.s3.admin import _UNPORTED, mount_admin
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.utils import promfed
from tests.test_admin import CREDS, REGION, Client
from tests.test_torch_iam import CREDS as TWIN_CREDS
from tests.test_torch_iam import (_admin, _send, _twin_servers, pin_both,
                                  rebound)


@pytest.fixture
def cpu_default(monkeypatch):
    monkeypatch.setattr(device_mod, "resolve",
                        lambda d=None: torch.device("cpu" if d is None
                                                    else d))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """tests/test_admin.py's fixture on the port's sets."""
    root = tmp_path_factory.mktemp("admindrives")
    sets = ErasureSets.from_drives([str(root / f"d{i}") for i in range(4)],
                                   set_count=1, set_drive_count=4,
                                   parity=2, block_size=1 << 16,
                                   device="cpu")
    iam = IAMSys(sets, root_cred=CREDS)
    srv = S3Server(sets, creds=CREDS, region=REGION, iam=iam).start()
    mount_admin(srv)
    yield srv
    srv.stop()
    sets.close()


@pytest.fixture(scope="module")
def client(server):
    return Client(server.port)


def _case(name):
    return rebound(getattr(ref_cases, name))


@pytest.mark.parametrize("name", [
    "test_health_endpoints", "test_admin_requires_auth",
    "test_admin_sts_requires_session_token", "test_metrics_endpoint",
    "test_madmin_client_sdk"])
def test_reference_server_cases(server, name):
    _case(name)(server)


@pytest.mark.parametrize("name", ["test_admin_info_and_storage",
                                  "test_admin_policy_crud",
                                  "test_admin_metacache_stats_disabled"])
def test_reference_client_cases(client, name):
    _case(name)(client)


@pytest.mark.parametrize("name", ["test_admin_mrf_stats",
                                  "test_admin_iam_flow",
                                  "test_admin_heal_sequence",
                                  "test_admin_service_action"])
def test_reference_client_server_cases(client, server, name):
    _case(name)(client, server)


@pytest.mark.parametrize("name", ["test_admin_metacache_stats",
                                  "test_admin_topology_and_rebalance"])
def test_reference_layer_cases(tmp_path, cpu_default, name):
    _case(name)(tmp_path)


def test_bucket_quota(server):
    """The quota half of test_admin_bucket_quota_and_remote_targets."""
    mc = madmin.AdminClient("127.0.0.1", server.port, CREDS.access_key,
                            CREDS.secret_key)
    server.api.obj.make_bucket("qb")
    assert mc.get_bucket_quota("qb") == {}
    mc.set_bucket_quota("qb", 1 << 20, "hard")
    assert mc.get_bucket_quota("qb") == {"quota": 1 << 20, "type": "hard"}
    assert server.api.bucket_meta.get("qb").quota == {"quota": 1 << 20,
                                                      "type": "hard"}
    mc.set_bucket_quota("qb", 0)
    assert mc.get_bucket_quota("qb") == {}
    with pytest.raises(madmin.AdminClientError) as ei:
        mc.set_bucket_quota("nosuchbucket", 5)
    assert ei.value.status == 404


def test_reference_quota_and_remote_targets(tmp_path):
    """tests/test_admin.py's quota / remote-target case whole, on a server
    of its own (the module's server already holds its bucket)."""
    sets = ErasureSets.from_drives([str(tmp_path / f"d{i}")
                                    for i in range(4)],
                                   set_count=1, set_drive_count=4,
                                   parity=2, block_size=1 << 16,
                                   device="cpu")
    srv = S3Server(sets, creds=CREDS, region=REGION,
                   iam=IAMSys(sets, root_cred=CREDS)).start()
    mount_admin(srv)
    try:
        _case("test_admin_bucket_quota_and_remote_targets")(srv)
    finally:
        if srv.api.replication is not None:
            srv.api.replication.close()
        srv.stop()
        sets.close()


@pytest.mark.parametrize("route", sorted(_UNPORTED))
def test_unported_routes_answer_not_implemented(client, route):
    method, sub = route
    st, body = client.request(method, f"/minio/admin/v3/{sub}")
    assert st == 501
    out = json.loads(body)
    assert out["Code"] == "NotImplemented"
    assert f"the {_UNPORTED[route]} plane" in out["Message"]


@pytest.mark.parametrize("knob", ["off", "on"])
def test_naughtynet_route_answers_as_the_references(tmp_path, monkeypatch,
                                                    knob):
    """POST naughtynet on twin servers: with MINIO_TPU_NAUGHTYNET off both
    refuse alike (NotImplemented, the same message); with it on,
    {"op": "status"} gives the same status from both, each from its own
    package's controller."""
    from minio_tpu.distributed import membership as ref_membership
    from minio_tpu_torch.distributed import membership
    monkeypatch.setenv("MINIO_TPU_NAUGHTYNET", knob)
    servers = _twin_servers(tmp_path)
    got = []
    try:
        for srv, _layer in servers:
            st, _h, body = _admin(srv.port, "POST", "naughtynet",
                                  body=json.dumps({"op": "status"}).encode())
            got.append((st, json.loads(body)))
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
    (ref_st, ref_out), (st, out) = got
    assert st == ref_st
    if knob == "off":
        assert st == 501 and out["Code"] == ref_out["Code"] == \
            "NotImplemented"
        assert out["Message"] == ref_out["Message"]
        assert "MINIO_TPU_NAUGHTYNET=on" in out["Message"]
        return
    assert st == 200
    assert out.pop("local_node") == membership.local_node()
    assert ref_out.pop("local_node") == ref_membership.local_node()
    assert out == ref_out
    assert out["enabled"] is False and out["rules"] == []


def test_update_group_members(server):
    mc = madmin.AdminClient("127.0.0.1", server.port, CREDS.access_key,
                            CREDS.secret_key)
    iam = server.api.iam
    mc.add_user("gm-one", "gm-one-secret")
    mc.add_user("gm-two", "gm-two-secret")
    mc.update_group_members("gm", ["gm-one", "gm-two"])
    assert iam.groups["gm"]["members"] == ["gm-one", "gm-two"]
    mc.set_policy("readonly", "gm", is_group=True)
    assert iam.is_allowed(iam.get_credentials("gm-two"), "s3:GetObject",
                          "b", "o")
    mc.update_group_members("gm", ["gm-two"], is_remove=True)
    assert iam.groups["gm"]["members"] == ["gm-one"]
    mc.update_group_members("gm", ["gm-one"], is_remove=True)
    assert "gm" not in iam.groups
    with pytest.raises(madmin.AdminClientError) as ei:
        mc.update_group_members("gm", ["nosuchuser"])
    assert ei.value.status == 400
    # a user may not call it
    user = Client(server.port, type(CREDS)("gm-one", "gm-one-secret"))
    assert user.request("PUT", "/minio/admin/v3/update-group-members",
                        body=b'{"group": "x", "members": []}')[0] == 403


# -- twin admin JSON ----------------------------------------------------------

_VOLATILE = {"uptime", "elapsed", "token", "total", "free", "used",
             "seconds", "started", "duration_s", "timings"}


def _mask(v):
    if isinstance(v, dict):
        return {k: ("*" if k in _VOLATILE else _mask(x))
                for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x) for x in v]
    return v


def _poll_heal(port, token):
    deadline = time.monotonic() + 20
    while True:
        out = _admin(port, "GET", "heal/status", {"token": token})
        if json.loads(out[2])["status"] != "running" or \
                time.monotonic() > deadline:
            return out
        time.sleep(0.05)


def test_twin_admin_json_answers_as_reference(tmp_path, monkeypatch):
    pin_both(monkeypatch)
    servers = _twin_servers(tmp_path)
    try:
        got = [[], []]
        for i, (srv, _layer) in enumerate(servers):
            p = srv.port
            out = got[i]
            assert _send(p, TWIN_CREDS, "PUT", "/adm")[0] == 200
            for k in range(3):
                assert _send(p, TWIN_CREDS, "PUT", f"/adm/o{k}",
                             body=b"admin" * (k + 1) * 100)[0] == 200
            for method, sub, q, body in (
                    ("GET", "info", None, b""),
                    ("GET", "storageinfo", None, b""),
                    ("GET", "datausageinfo", None, b""),
                    ("GET", "top/locks", None, b""),
                    ("GET", "mrf", None, b""),
                    ("GET", "metacache", None, b""),
                    ("GET", "fsck", None, b""),
                    ("POST", "fsck", {"tmp_age": "0"}, b""),
                    ("GET", "tier", None, b""),
                    ("GET", "tier/stats", None, b""),
                    ("GET", "topology", None, b""),
                    ("GET", "rebalance", None, b""),
                    ("PUT", "add-user", {"accessKey": "twinuser"},
                     b'{"secretKey": "twinsecret12"}'),
                    ("GET", "list-users", None, b""),
                    ("PUT", "add-service-account", None,
                     b'{"parent": "twinuser"}'),
                    ("GET", "list-canned-policies", None, b""),
                    ("PUT", "set-config", {"subsys": "scanner"},
                     b'{"interval": "90s"}'),
                    ("PUT", "set-config", {"subsys": "api"},
                     b'{"requests_max": "bad"}'),
                    ("GET", "get-config", None, b""),
                    ("PUT", "set-bucket-quota", {"bucket": "adm"},
                     b'{"quota": 4096, "quotatype": "hard"}'),
                    ("GET", "get-bucket-quota", {"bucket": "adm"}, b""),
                    ("GET", "nosuchroute", None, b"")):
                st, _h, b = _admin(p, method, sub, q, body)
                out.append((method, sub, st, _mask(json.loads(b or b"{}"))))
            st, _h, b = _admin(p, "POST", "heal", {"bucket": "adm"})
            out.append(("heal", st, _mask(json.loads(
                _poll_heal(p, json.loads(b)["token"])[2]))))
        assert got[0] == got[1]
        assert got[1][-1][2]["status"] == "done"
        assert got[1][-1][2]["items_healed"] == 3
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()


# -- the gray-failure plane's routes -------------------------------------------

# timings and host facts: masked in the drivehealth and obdinfo answers
_GRAY_VOLATILE = {"p50_ms", "p95_ms", "ewma_ms", "state_age_s", "ts",
                  "seq", "time", "load1", "load5", "load15", "available",
                  "rss_bytes", "threads", "open_fds",
                  "write_latency_us", "read_latency_us"}


def _gray_mask(v, root: str):
    """Timings masked, this package's drive root named alike."""
    if isinstance(v, dict):
        return {k.replace(root, "<root>"):
                ("*" if k in _GRAY_VOLATILE else _gray_mask(x, root))
                for k, x in v.items()}
    if isinstance(v, list):
        return [_gray_mask(x, root) for x in v]
    if isinstance(v, str):
        return v.replace(root, "<root>")
    return v


def _gray_twins(tmp_path, monkeypatch):
    """Twin servers after one PUT and GET, each package's tracker reset
    just before, and drive 0 of each set turned suspect."""
    pin_both(monkeypatch)
    servers = _twin_servers(tmp_path)
    for pkg in ("minio_tpu", "minio_tpu_torch"):
        importlib.import_module(f"{pkg}.utils.healthtrack").TRACKER.reset()
    for srv, layer in servers:
        p = srv.port
        assert _send(p, TWIN_CREDS, "PUT", "/gray")[0] == 200
        assert _send(p, TWIN_CREDS, "PUT", "/gray/o",
                     body=b"g" * 70_000)[0] == 200
        assert _send(p, TWIN_CREDS, "GET", "/gray/o")[1] is not None
        ht = importlib.import_module(
            type(layer).__module__.split(".")[0] + ".utils.healthtrack")
        ht.TRACKER.set_state("drive", ht.disk_key(layer.sets[0].disks[0]),
                             ht.STATE_SUSPECT, event="suspect")
    return servers


def test_twin_drivehealth(tmp_path, monkeypatch):
    """drivehealth on twin servers: the tracked drives with their verbs'
    sample counts and states, no monitor events (no node), and the
    journal's health.transition record of the suspect drive, equal with
    timings masked."""
    servers = _gray_twins(tmp_path, monkeypatch)
    got = []
    try:
        for (srv, _layer), tag in zip(servers, ("ref", "port")):
            root = str(tmp_path / tag)
            st, _h, body = _admin(srv.port, "GET", "drivehealth")
            assert st == 200
            out = json.loads(body)
            out["drives"] = [d for d in out["drives"]
                             if d["key"].startswith(root)]
            out["journal"] = [e for e in out["journal"] if str(
                e["attrs"].get("target", "")).startswith(root)]
            out["peers"] = "*"     # the process's peers, not these servers'
            got.append(_gray_mask(out, root))
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
        for pkg in ("minio_tpu", "minio_tpu_torch"):
            importlib.import_module(f"{pkg}.utils.healthtrack").TRACKER \
                .reset()
    assert got[0] == got[1]
    drives = got[1]["drives"]
    assert len(drives) == 4 and drives[0]["state"] == "suspect"
    assert all(d["verbs"]["write"]["n"] >= 1 for d in drives)
    assert got[1]["events"] == []
    assert [(e["class"], e["attrs"]) for e in got[1]["journal"]] == [
        ("health.transition", {"kind": "drive", "target": "<root>/d0",
                               "state": "suspect", "event": "suspect"})]


def test_twin_obdinfo(tmp_path, monkeypatch):
    """obdinfo on twin servers: one node (no cluster), its cpu, memory and
    process facts and each drive's identity, online flag, health state
    and tracked verbs, equal with timings and host counters masked."""
    servers = _gray_twins(tmp_path, monkeypatch)
    got = []
    try:
        for (srv, _layer), tag in zip(servers, ("ref", "port")):
            st, _h, body = _admin(srv.port, "GET", "obdinfo")
            assert st == 200
            got.append(_gray_mask(json.loads(body),
                                  str(tmp_path / tag)))
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
        for pkg in ("minio_tpu", "minio_tpu_torch"):
            importlib.import_module(f"{pkg}.utils.healthtrack").TRACKER \
                .reset()
    assert got[0] == got[1]
    node = got[1]["nodes"][0]
    assert got[1]["net"] == [] and len(got[1]["nodes"]) == 1
    assert sorted(node) == ["cpu", "drive_faults", "drives", "hostname",
                            "mem", "peer_health", "process", "time"]
    faults = node["drive_faults"]
    assert [f["index"] for f in faults] == [0, 1, 2, 3]
    assert all(f["online"] for f in faults)
    assert faults[0]["health"]["state"] == "suspect"
    assert {f["health"]["state"] for f in faults[1:]} == {"ok"}


# -- Prometheus families ------------------------------------------------------

# families only the port exports: its own counters of earlier slices
PORT_ONLY = {"minio_tpu_erasure_get_streams_total",
             "minio_tpu_rpc_verb_calls_total",
             "minio_tpu_rpc_verb_received_bytes_total",
             "minio_tpu_rpc_verb_sent_bytes_total"}


def _naughtynet_traffic(nn) -> None:
    """One partition drop, one scheduled delay and one mid-stream reset
    through a package's naughtynet controller, which is left reset."""
    try:
        nn.NET.partition("a", "b", oneway=True)
        assert nn.NET.on_call("a", "b", "probe").blocked
        nn.NET.heal()
        nn.NET.arm(nn.NetSchedule(seed=1, delay_rate=1.0, delay_s=1e-6,
                                  reset_rate=1.0))
        assert nn.NET.on_call("a", "b", "probe").delay > 0
        with pytest.raises(ConnectionResetError):
            list(nn.NET.wrap_stream("a", "b", "probe", iter([b"x", b"y"])))
    finally:
        nn.NET.reset()


def _label_names(fam) -> set:
    return {k for (_n, labels) in fam.samples for k, _v in labels
            if k != "le"}


def _import_counterparts() -> None:
    """Every reference module whose port counterpart is loaded: each
    package registers its families when its modules import."""
    for name in sorted(sys.modules):
        if name.startswith("minio_tpu_torch."):
            try:
                importlib.import_module(
                    "minio_tpu" + name[len("minio_tpu_torch"):])
            except ImportError:
                pass            # a port-only module (kernels, scripts)


def _notify_plane(layer):
    """A notification plane of the layer's package over its layer, as the
    boot attaches one, with no target yet."""
    notify = importlib.import_module(
        type(layer).__module__.split(".")[0] + ".notify")
    reg = notify.NotifyTargetRegistry(layer)
    return notify.NotificationPlane(layer, reg, node="n1", site_id="twin",
                                    busy_fn=lambda: False)


def _notify_traffic(layer, monkeypatch) -> None:
    """One delivery, one failed send and one drop through the layer's
    package's notification plane (each of the four minio_tpu_notify_*
    families takes a sample)."""
    notify = importlib.import_module(
        type(layer).__module__.split(".")[0] + ".notify")
    ok, bad = "arn:minio:sqs::ok:queue", "arn:minio:sqs::bad:queue"

    class Failing:
        def send(self, record):
            raise ConnectionError("down")

    reg = notify.NotifyTargetRegistry()
    for arn in (ok, bad):
        reg.add(notify.NotifyTarget(arn=arn, type="queue"))
    sink = importlib.import_module(notify.__name__ + ".targets").QueueSender(ok)
    reg.set_sender(ok, sink)
    reg.set_sender(bad, Failing())
    doc = "<NotificationConfiguration>" + "".join(
        f"<QueueConfiguration><Queue>{a}</Queue>"
        "<Event>s3:ObjectCreated:*</Event></QueueConfiguration>"
        for a in (ok, bad)) + "</NotificationConfiguration>"
    plane = notify.NotificationPlane(layer, reg, busy_fn=lambda: False)
    with monkeypatch.context() as mp:       # every record drops
        mp.setenv("MINIO_TPU_NOTIFY_STORE_LIMIT", "0")
        full = notify.NotificationPlane(layer, reg, busy_fn=lambda: False)
    try:
        for p in (plane, full):
            p.set_config("prom", doc)
            p.on_namespace_change("prom", "o")
        assert sink.wait_for(1, 30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                (plane.stats()["failed"] < 1
                 or full.stats()["dropped"] < 1):
            time.sleep(0.02)
        assert plane.stats()["failed"] >= 1, plane.stats()
        assert full.stats()["dropped"] >= 1, full.stats()
    finally:
        plane.close()
        full.close()


def _mask_notify(doc):
    """The notify answers' fields that differ between twin servers: the
    registry's lineage and its update time, and the plane's clocks."""
    if isinstance(doc, dict):
        return {k: ("*" if k in ("lineage", "updated", "last_delivery",
                                 "last_lag_s", "offline_until")
                    else _mask_notify(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask_notify(v) for v in doc]
    return doc


def test_twin_notify_routes(tmp_path, monkeypatch):
    """GET notify and PUT / DELETE notify/target on twin servers through
    each package's madmin (add, update, a bad spec, an unknown ARN,
    remove), and GET notify with no plane attached: equal answers and
    statuses, clocks and lineage masked."""
    pin_both(monkeypatch)
    servers = _twin_servers(tmp_path)
    out = []
    try:
        for (srv, layer), mad in zip(servers, ("minio_tpu.madmin",
                                               "minio_tpu_torch.madmin")):
            mod = importlib.import_module(mad)
            mc = mod.AdminClient("127.0.0.1", srv.port,
                                 TWIN_CREDS.access_key,
                                 TWIN_CREDS.secret_key)
            got = []

            def call(fn, *a, **kw):
                try:
                    got.append(("ok", _mask_notify(fn(*a, **kw))))
                except mod.AdminClientError as e:
                    got.append(("err", e.status, str(e)))

            call(mc.notify_status)                  # no plane: 501
            srv.api.notify = _notify_plane(layer)
            try:
                call(mc.notify_status)
                arn = "arn:minio:sqs::hook:webhook"
                call(mc.add_notify_target, endpoint="http://127.0.0.1:1/h",
                     auth_token="tok", arn=arn)
                call(mc.add_notify_target, endpoint="http://127.0.0.1:1/h",
                     arn=arn)                       # exists: refused
                call(mc.add_notify_target, endpoint="http://127.0.0.1:2/h",
                     arn=arn, update=True)
                call(mc.add_notify_target, type="log", arn="arn:l",
                     path=str(tmp_path / "ev.log"))
                call(mc.add_notify_target, type="bogus", arn="arn:b")
                call(mc.add_notify_target, endpoint="", arn="arn:e")
                call(mc.notify_status)
                call(mc.remove_notify_target, "arn:minio:sqs::ghost:x")
                call(mc.remove_notify_target, arn)
                call(mc.notify_status)
            finally:
                srv.api.notify.close()
            out.append(got)
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
    ref, port = out
    assert port[0][:2] == ("err", 501)
    assert port[2] == ("ok", "arn:minio:sqs::hook:webhook")
    assert [g[0] for g in port] == ["err", "ok", "ok", "err", "ok", "ok",
                                    "err", "err", "ok", "err", "ok", "ok"]
    assert port == ref


_ARN_RE = re.compile(r"arn:minio:replication::[0-9a-f]{12}:")


def _mask_repl(doc):
    """The replicate answers' fields that differ between twin servers:
    the registry's lineage, the clocks, and the ARNs the servers mint."""
    if isinstance(doc, dict):
        return {_mask_repl(k): ("*" if k in ("lineage", "updated", "started",
                                             "last_sync", "last_lag_s",
                                             "oldest_pending_s")
                                else _mask_repl(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask_repl(v) for v in doc]
    if isinstance(doc, str):
        return _ARN_RE.sub("arn:minio:replication::*:", doc)
    return doc


def _repl_plane(layer, site, **kw):
    """A replication plane of the layer's package over its layer, as the
    boot attaches one, its site id pinned."""
    repl = importlib.import_module(
        type(layer).__module__.split(".")[0] + ".replicate")
    reg = repl.TargetRegistry(layer, site_id=site)
    return repl, repl.ReplicationPlane(layer, reg, busy_fn=lambda: False,
                                       **kw)


def _sets_like(layer, root):
    """Fresh sets of the layer's package over four drives under root."""
    pkg = type(layer).__module__.split(".")[0]
    sets_cls = importlib.import_module(pkg + ".object.sets").ErasureSets
    kw = {"device": "cpu"} if pkg == "minio_tpu_torch" else {}
    return sets_cls.from_drives([str(root / f"d{i}") for i in range(4)],
                                set_count=1, set_drive_count=4, parity=2,
                                block_size=1 << 16, **kw)


def test_twin_replicate_routes(tmp_path, monkeypatch):
    """The replication plane's routes and the bucket remote targets on
    twin servers through each package's madmin: GET replicate with no
    plane, then with one (its site id pinned); a wire target added,
    refused (no bucket, a missing bucket, an ARN that exists), updated
    and removed; GET replicate/key over two versions and a marker; a
    resync of an unknown ARN refused, one of a layer target run to its
    end, its status and a cancel; the three remote-target routes. Equal answers and
    statuses, clocks, lineage and minted ARNs masked."""
    pin_both(monkeypatch)
    servers = _twin_servers(tmp_path)
    out = []
    try:
        for (srv, layer), tag in zip(servers, ("ref", "port")):
            mod = importlib.import_module(
                type(layer).__module__.split(".")[0] + ".madmin")
            mc = mod.AdminClient("127.0.0.1", srv.port,
                                 TWIN_CREDS.access_key,
                                 TWIN_CREDS.secret_key)
            got = []

            def call(fn, *a, **kw):
                try:
                    got.append(("ok", _mask_repl(fn(*a, **kw))))
                except mod.AdminClientError as e:
                    got.append(("err", e.status, str(e)))

            p = srv.port
            assert _send(p, TWIN_CREDS, "PUT", "/rbk")[0] == 200
            assert _send(p, TWIN_CREDS, "PUT", "/rbk",
                         query={"versioning": ""},
                         body=b"<VersioningConfiguration><Status>Enabled"
                              b"</Status></VersioningConfiguration>")[0] \
                == 200
            for body in (b"one", b"two" * 100):
                assert _send(p, TWIN_CREDS, "PUT", "/rbk/k", body=body)[0] \
                    == 200
            assert _send(p, TWIN_CREDS, "DELETE", "/rbk/k")[0] == 204
            call(mc.replicate_status)               # no plane: 501
            repl, plane = _repl_plane(layer, "twin-site")
            srv.api.replication = plane
            dst = _sets_like(layer, tmp_path / f"{tag}-dst")
            try:
                call(mc.replicate_status)
                arn = "arn:minio:replication::wire:rbk"
                wire = dict(host="127.0.0.1", port=1, dest_bucket="rbk",
                            access_key="ak", secret_key="sk")
                call(mc.add_replicate_target, "rbk", arn=arn, **wire)
                call(mc.add_replicate_target, "rbk", arn=arn, **wire)
                call(mc.add_replicate_target, "", arn="arn:x", **wire)
                call(mc.add_replicate_target, "nosuchbucket", arn="arn:y",
                     **wire)
                call(mc.add_replicate_target, "rbk", arn=arn,
                     update=True, prefix="k", bw_bps=1 << 20, **wire)
                call(mc.replicate_status)
                call(mc.replicate_key_versions, "rbk", "k")
                call(mc.replicate_key_versions, "rbk", "nokey")
                call(mc.remove_replicate_target, "arn:ghost")
                call(mc.remove_replicate_target, arn)
                seed = "arn:minio:replication::seed:rbk"
                plane.registry.add(
                    repl.SiteTarget(arn=seed, bucket="rbk", dest_bucket="rbk",
                                    site="twin-dst", type="layer"),
                    client=repl.LayerReplClient(dst, "rbk", "twin-dst"))
                call(mc.replicate_resync_status)
                call(mc.start_replicate_resync, "arn:ghost")
                got.append(("started", mc.start_replicate_resync(seed)
                            ["arn"]))
                deadline = time.monotonic() + 30
                while plane.resync_status()["running"] and \
                        time.monotonic() < deadline:
                    time.sleep(0.02)
                call(mc.replicate_resync_status)
                call(mc.cancel_replicate_resync)
                got.append(("dst", [
                    (v.name, v.version_id, v.etag, v.delete_marker)
                    for v in dst.list_object_versions("rbk")[0]]))
                rt = mc.set_remote_target("rbk", "127.0.0.1", 1, "far",
                                          "rak12345", "rsk1234567")
                got.append(("remote", _mask_repl(rt)))
                call(mc.set_remote_target, "nosuchbucket", "127.0.0.1", 1,
                     "far", "rak12345", "rsk1234567")
                call(mc.list_remote_targets, "rbk")
                call(mc.replicate_status)
                call(mc.remove_remote_target, "rbk", rt)
                call(mc.list_remote_targets, "rbk")
                call(mc.replicate_status)
            finally:
                plane.close()
                dst.close()
            out.append(got)
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
    ref, port = out
    assert port[0][:2] == ("err", 501)
    assert [g[0] for g in port] == [
        "err", "ok", "ok", "err", "err", "err", "ok", "ok", "ok", "ok",
        "err", "ok", "ok", "err", "started", "ok", "ok", "dst", "remote",
        "err", "ok", "ok", "ok", "ok", "ok"]
    resync = port[15][1]
    assert resync["status"] == "complete" and resync["versions_pushed"] == 3
    assert len(port[17][1]) == 3
    assert port == ref


def _repl_traffic(layer, root) -> None:
    """One push, one failed sync and one prune through the layer's
    package's replication plane (each of the four minio_tpu_repl_*
    families takes a sample): a layer target over fresh sets takes a
    version, and its replica is pruned once the version is purged here;
    a second target refuses every apply."""
    pkg = type(layer).__module__.split(".")[0]
    put_opts = importlib.import_module(pkg + ".object.engine").PutOptions
    repl, plane = _repl_plane(layer, "prom-site")
    dst = _sets_like(layer, root)
    try:
        layer.make_bucket("promr")
        dst.make_bucket("promr")
        dst.make_bucket("promb")
        plane.registry.add(
            repl.SiteTarget(arn="arn:ok", bucket="promr",
                            dest_bucket="promr", site="prom-dst",
                            type="layer"),
            client=repl.LayerReplClient(dst, "promr", "prom-dst"))
        plane.registry.add(
            repl.SiteTarget(arn="arn:bad", bucket="promr",
                            dest_bucket="promb", site="prom-bad",
                            type="layer"),
            client=repl.NaughtyReplClient(
                repl.LayerReplClient(dst, "promb", "prom-bad"),
                fail_verbs={"apply": repl.ReplClientError("HTTP 503")}))
        info = layer.put_object("promr", "o", b"r" * 333,
                                opts=put_opts(versioned=True))
        plane.on_namespace_change("promr", "o")

        def wait(key):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and plane.stats()[key] < 1:
                time.sleep(0.02)
            assert plane.stats()[key] >= 1, plane.stats()

        wait("synced")
        wait("failed")
        layer.delete_object("promr", "o", version_id=info.version_id)
        plane.on_namespace_change("promr", "o")
        wait("pruned")
    finally:
        plane.close()
        dst.close()


def test_prometheus_families_agree(tmp_path, monkeypatch):
    _import_counterparts()
    pin_both(monkeypatch)
    servers = _twin_servers(tmp_path)
    texts = []
    try:
        for srv, layer in servers:
            p = srv.port
            assert _send(p, TWIN_CREDS, "PUT", "/prom")[0] == 200
            assert _send(p, TWIN_CREDS, "PUT", "/prom/o", body=b"m" * 999)[0] \
                == 200
            assert _send(p, TWIN_CREDS, "GET", "/prom/o")[0] == 200
            # the gray-failure plane's counters, once each: a latency
            # hedge and a quarantine transition of drive 0
            ht = importlib.import_module(
                type(layer).__module__.split(".")[0] + ".utils.healthtrack")
            key = ht.disk_key(layer.sets[0].disks[0])
            ht.note_hedge("latency")
            ht.TRACKER.set_state("drive", key, ht.STATE_SUSPECT,
                                 event="suspect")
            _naughtynet_traffic(importlib.import_module(
                type(layer).__module__.split(".")[0]
                + ".distributed.naughtynet"))
            _notify_traffic(layer, monkeypatch)
            _repl_traffic(layer, tmp_path / f"repl-{p}")
            c = Client(p, TWIN_CREDS)
            st, body = c.request("GET", "/minio/prometheus/metrics",
                                 sign=False)
            ht.TRACKER.set_state("drive", key, ht.STATE_OK)
            assert st == 200
            texts.append(body.decode())
    finally:
        for srv, layer in servers:
            srv.stop()
            layer.close()
    ref, port = (promfed.parse_exposition(t) for t in texts)
    for name in ("minio_tpu_drive_latency_seconds",
                 "minio_tpu_hedged_reads_total",
                 "minio_tpu_drive_quarantine_total",
                 "minio_tpu_drive_health",
                 "minio_tpu_net_partition_drops_total",
                 "minio_tpu_net_chaos_delays_total",
                 "minio_tpu_net_chaos_resets_total",
                 "minio_tpu_edge_accepted_total",
                 "minio_tpu_edge_requests_total",
                 "minio_tpu_edge_open_conns", "minio_tpu_edge_pool_size",
                 "minio_tpu_edge_pool_busy", "minio_tpu_edge_pool_idle",
                 "minio_tpu_edge_pool_pending",
                 "minio_tpu_notify_sent_total",
                 "minio_tpu_notify_failed_total",
                 "minio_tpu_notify_dropped_total",
                 "minio_tpu_notify_lag_seconds",
                 "minio_tpu_repl_synced_total",
                 "minio_tpu_repl_failed_total",
                 "minio_tpu_repl_pruned_total",
                 "minio_tpu_repl_lag_seconds"):
        assert port[name].samples and ref[name].samples, name
    # the edge's, the QoS plane's, the notification plane's and the
    # replication plane's families are no longer the reference's alone
    assert {n for n in set(ref) - set(port)
            if n.startswith(("minio_tpu_edge_", "minio_tpu_qos_",
                             "minio_tpu_notify_", "minio_tpu_repl_"))} \
        == set()
    assert port["minio_disks_online"].samples[
        ("minio_disks_online", ())] == 4
    # a family the reference registers only when its code first runs
    # counts where the reference's source declares it
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "minio_tpu")
    source = "".join(open(os.path.join(d, f)).read()
                     for d, _s, fs in os.walk(root)
                     for f in fs if f.endswith(".py"))
    assert {n for n in set(port) - set(ref)
            if f'"{n}"' not in source} <= PORT_ONLY
    for name in set(port) & set(ref):
        assert port[name].kind == ref[name].kind, name
        if port[name].samples and ref[name].samples:
            assert _label_names(port[name]) == _label_names(ref[name]), \
                name


def test_promfed_merge_is_the_references():
    a = ("# HELP c_total c\n# TYPE c_total counter\nc_total{x=\"1\"} 3\n"
         "# HELP g g\n# TYPE g gauge\ng 7\n"
         "# HELP h h\n# TYPE h histogram\nh_bucket{le=\"1\"} 1\n"
         "h_bucket{le=\"+Inf\"} 2\nh_sum 1.5\nh_count 2\n")
    b = a.replace("3\n", "4\n").replace("g 7", "g 9") + "junk line\n"
    nodes = [("n1:9000", a), ("n2:9000", b)]
    assert promfed.merge_expositions(nodes) == \
        ref_promfed.merge_expositions(nodes)
    merged = promfed.parse_exposition(promfed.merge_expositions(nodes))
    assert merged["c_total"].samples[("c_total", (("x", "1"),))] == 7
    assert merged["h"].samples[("h_count", ())] == 4
