"""The reference's partition suite (tests/test_partition.py) on the port's
naughtynet (minio_tpu_torch/distributed/naughtynet.py) and its hooks in
the internode transport.

  * every non-slow case of tests/test_partition.py that needs no
    replication target registry, rebound to the port
    (tests/test_torch_iam.rebound): schedule replay and its verb filter,
    timed partition windows, the admin ops, a partitioned dial that heals
    through the offline probe, a one-way partition, an inbound drop seen
    as an unreachable host, the federated scrape degrading and healing,
    a mid-stream partition bounded by the streamed-read deadline,
    generation fencing and the generation on the wire, and a partitioned
    lock holder fenced on return. The four registry cases wait for the
    replication plane;
  * the schedules and the admin ops held against the reference's: the
    same seed gives the same delays and resets, the same ops the same
    status;
  * a rule on a node id holds across the node's boot generations, which
    still reach the caller's membership tracker once the link heals;
  * the slow admin-verb case on the port's CLI as a subprocess (the
    two-node subprocess matrix waits for the port's S3 client).

Every schedule-driven case prints its seed; MINIO_TPU_CHAOS_SEED=<seed>
replays it.
"""

from __future__ import annotations

import inspect
import os
import signal
import subprocess
import sys
import time

import pytest

import minio_tpu.distributed.naughtynet as ref_nn
import tests.test_partition as ref_cases
from minio_tpu_torch.distributed import membership
from minio_tpu_torch.distributed.naughtynet import (NET, NetSchedule,
                                                    handle_admin)
from minio_tpu_torch.distributed.peer_rpc import PeerRPCClient, PeerRPCServer
from minio_tpu_torch.distributed.transport import (NetworkError, RPCHandler,
                                                   RPCServer, RestClient)
from tests.test_torch_iam import rebound

pytestmark = pytest.mark.chaos

AK, SK = ref_cases.AK, ref_cases.SK

# the replication plane's TargetRegistry is not ported yet
_WAITING = ("test_registry_write_quorum_refuses_minority_commit",
            "test_registry_write_quorum_default_keeps_legacy_behavior",
            "test_registry_fork_detected_and_repaired_never_merged",
            "test_fork_audit_ignores_legacy_and_agreeing_docs")
_NOT_PORTED = {"TargetRegistry": None, "ReplTargetError": None,
               "SiteTarget": None, "new_arn": None, "NET": NET}


@pytest.fixture(autouse=True)
def _clean_slate():
    """tests/test_partition.py's fixture on the port: the fault
    controller disarmed and a fresh membership incarnation."""
    NET.reset()
    membership.TRACKER.reset()
    membership.set_local_node("")
    yield
    NET.reset()
    membership.TRACKER.reset()
    membership.set_local_node("")


@pytest.fixture()
def duo():
    """tests/test_partition.py's two peer nodes on the port, node ids
    their wire addresses, one observer client per node."""
    hosts, servers, clients = [], [], []
    for i in range(2):
        host = RPCServer().start()
        nid = f"127.0.0.1:{host.port}"
        srv = PeerRPCServer(AK, SK, node_id=nid)
        srv.get_server_info = lambda i=i: {"idx": i}
        srv.get_metrics_text = \
            lambda i=i: f"# HELP probe node{i}\nprobe{{n=\"{i}\"}} 1\n"
        host.mount(srv.handler)
        hosts.append(host)
        servers.append(srv)
        clients.append(PeerRPCClient("127.0.0.1", host.port, AK, SK,
                                     timeout=3.0, node_id="observer"))
    yield hosts, servers, clients
    for c in clients:
        c.close()
    for h in hosts:
        h.stop()


_ALL = sorted(name for name, fn in vars(ref_cases).items()
              if name.startswith("test_") and inspect.isfunction(fn)
              and not any(m.name == "slow" for m in
                          getattr(fn, "pytestmark", ())))
_CASES = [n for n in _ALL if n not in _WAITING]


def test_every_reference_case_is_rebound():
    assert len(_ALL) == 16, _ALL
    assert set(_WAITING) <= set(_ALL)


@pytest.mark.parametrize("name", _CASES)
def test_reference_partition_cases(request, monkeypatch, name):
    fn = rebound(getattr(ref_cases, name), **_NOT_PORTED)
    params = inspect.signature(fn).parameters
    given = {"monkeypatch": monkeypatch}
    if "duo" in params:
        given["duo"] = request.getfixturevalue("duo")
    fn(**{p: given[p] for p in params})


# -- held against the reference -------------------------------------------------

def test_net_schedules_and_admin_ops_equal_reference():
    """One seed, one call sequence: the same delays and resets in both
    packages; one op sequence: the same status (the local node aside)."""
    seed = ref_cases.chaos_seed(4242)
    ref_cases.announce(seed)
    kw = dict(seed=seed, delay_rate=0.4, delay_s=0.002, jitter_s=0.003,
              reset_rate=0.4, fault_verbs=("read_file", "trace"))
    ours, theirs = NetSchedule(**kw), ref_nn.NetSchedule(**kw)
    for verb in ("read_file", "trace", "server-info"):
        for n in range(128):
            assert ours.delay_for(verb, n) == theirs.delay_for(verb, n)
            assert ours.resets(verb, n) == theirs.resets(verb, n)
    assert ours.to_dict() == theirs.to_dict()

    def strip(st):
        return {k: v for k, v in st.items() if k != "local_node"}

    ops = [{"op": "status"},
           {"op": "partition", "src": "a", "dst": "b", "oneway": True},
           {"op": "partition", "src": "c", "dst": "*"},
           {"op": "configure", "seed": 99, "delay_rate": 0.5,
            "delay_s": 0.001, "fault_verbs": ["x"]},
           {"op": "disarm"}, {"op": "arm"}, {"op": "heal", "src": "a"},
           {"op": "heal"}, {"op": "reset"}]
    ref_nn.NET.reset()
    try:
        for op in ops:
            assert strip(handle_admin(dict(op))) == \
                strip(ref_nn.handle_admin(dict(op))), op
        for bad in ({"op": "no-such-op"}, {"op": "partition",
                                            "after_s": "soon"}):
            with pytest.raises(ValueError):
                handle_admin(dict(bad))
            with pytest.raises(ValueError):
                ref_nn.handle_admin(dict(bad))
    finally:
        ref_nn.NET.reset()


def test_node_id_rule_holds_across_generations():
    """The port stamps a node id and a boot generation on each of an
    in-process node's clients and handlers (cluster.ClusterNode._identify).
    A rule names the node id: it cuts the node's next incarnation too,
    and once healed the caller's tracker sees the new generation."""
    h = RPCHandler("/gen/v1", AK, SK, node_id="node-b")
    h.generation = 1_000_001
    h.register("ping", lambda _args, _body: {"ok": True})
    host = RPCServer().start()
    host.mount(h)
    rc = RestClient("127.0.0.1", host.port, "/gen/v1", AK, SK, timeout=3.0)
    rc.node_id, rc.generation = "node-a", 2_000_001
    addr = f"127.0.0.1:{host.port}"
    events: list = []
    membership.TRACKER.add_listener(
        lambda p, o, n: events.append((p, o, n)))
    try:
        assert rc.call_json("ping") == {"ok": True}
        assert membership.TRACKER.generation_of(addr) == 1_000_001
        # the serving side saw the caller's id and its generation
        assert membership.TRACKER.generation_of("node-a") == 2_000_001
        NET.partition("node-a", "node-b")
        h.generation = 1_000_002          # node b rebooted in place
        with pytest.raises(NetworkError) as ei:
            rc.call_json("ping")
        assert ei.value.conn_failure and not rc.online
        assert NET.stats["blocked"] >= 1
        # a caller with another id is not cut
        other = RestClient("127.0.0.1", host.port, "/gen/v1", AK, SK,
                           timeout=3.0)
        other.node_id = "node-c"
        try:
            assert other.call_json("ping") == {"ok": True}
        finally:
            other.close()
        NET.heal()
        ref_cases.wait_until(lambda: rc.online, timeout=15.0,
                             what="post-heal probe re-admission")
        assert rc.call_json("ping") == {"ok": True}
        assert membership.TRACKER.generation_of(addr) == 1_000_002
        assert (addr, 1_000_001, 1_000_002) in events
    finally:
        rc.close()
        host.stop()


# -- the slow subprocess case ---------------------------------------------------

def _boot(tmp_path, name: str, **env):
    """The port's CLI as a subprocess over 4 drives, on the CPU."""
    from tests.test_torch_cli import CREDS, ROOT, _env, _free_port
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server",
         str(tmp_path / name / "d{1...4}"), "--address",
         f"127.0.0.1:{port}", "--device", "cpu"],
        cwd=ROOT, env=_env(**env), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    from minio_tpu_torch.madmin import AdminClient
    admin = AdminClient("127.0.0.1", port, CREDS.access_key,
                        CREDS.secret_key)
    deadline = time.monotonic() + 90.0
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"server exited {proc.returncode}: "
                                 f"{proc.stderr.read()}")
        try:
            admin.server_info()
            return proc, admin, f"127.0.0.1:{port}"
        except OSError:
            if time.monotonic() > deadline:
                proc.kill()
                raise
            time.sleep(0.2)


def _close(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.mark.slow
def test_naughtynet_admin_verb_gated_and_live(tmp_path):
    """tests/test_partition.py's admin-verb smoke on the port's CLI: the
    verb answers only with MINIO_TPU_NAUGHTYNET=on, rules install and
    heal, and a SIGSTOP/SIGCONT pause survives."""
    from minio_tpu_torch.madmin import AdminClientError
    proc, admin, addr = _boot(tmp_path, "nn", MINIO_TPU_NAUGHTYNET="on")
    try:
        st = admin.naughtynet({"op": "status"})
        assert st["enabled"] is False and st["rules"] == []
        assert st["local_node"] == addr
        st = admin.naughtynet({"op": "partition", "src": addr,
                               "dst": "10.0.0.2:9000"})
        assert st["enabled"] and len(st["rules"]) == 2
        st = admin.naughtynet({"op": "heal"})
        assert st["rules"] == []
        proc.send_signal(signal.SIGSTOP)
        time.sleep(0.3)
        proc.send_signal(signal.SIGCONT)
        assert admin.naughtynet({"op": "reset"})["enabled"] is False
    finally:
        _close(proc)
    # without the knob the verb refuses (it is a test-only surface)
    proc, admin, _addr = _boot(tmp_path, "nn2")
    try:
        with pytest.raises(AdminClientError):
            admin.naughtynet({"op": "status"})
    finally:
        _close(proc)
    assert os.path.isdir(tmp_path / "nn2" / "d1")
