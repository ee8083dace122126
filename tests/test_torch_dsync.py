"""The port's dsync (minio_tpu_torch/distributed/{dsync,local_locker,
lock_rpc}.py) held against minio_tpu's.

  * tests/test_dsync.py's cases, each run against both packages: the
    quorum algebra, the token, the local locker's semantics and expiry,
    DRWMutex over local lockers (quorum, shared readers, a minority down,
    no quorum with the partial grants rolled back, contention), the lock
    RPC (round trip, a wrong secret, DRWMutex and DistNSLockMap over RPC
    lockers) and the refresh that keeps a long hold alive;
  * the wire both ways: each package's lock client against the other's
    lock server, and a DRWMutex whose lockers mix the two;
  * DistNSLockMap behind the port's engine: an erasure set whose namespace
    lock is dsync over three RPC lockers serves PUT and GET alike, and a
    held key lock keeps a second node's writer out until it is released.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest

import minio_tpu.distributed.dsync as ref_dsync
import minio_tpu.distributed.local_locker as ref_ll
import minio_tpu.distributed.lock_rpc as ref_lock_rpc
import minio_tpu.distributed.transport as ref_transport
import minio_tpu_torch.distributed.dsync as port_dsync
import minio_tpu_torch.distributed.local_locker as port_ll
import minio_tpu_torch.distributed.lock_rpc as port_lock_rpc
import minio_tpu_torch.distributed.transport as port_transport

AK, SK = "internodekey", "internodesecret123"

PKGS = {
    "ref": types.SimpleNamespace(dsync=ref_dsync, ll=ref_ll,
                                 rpc=ref_lock_rpc, tr=ref_transport),
    "port": types.SimpleNamespace(dsync=port_dsync, ll=port_ll,
                                  rpc=port_lock_rpc, tr=port_transport),
}
both = pytest.mark.parametrize("pkg", ["ref", "port"])


# ---------------------------------------------------------------------------
# tests/test_dsync.py, against both packages
# ---------------------------------------------------------------------------

@both
def test_quorum_algebra(pkg):
    q = PKGS[pkg].dsync.quorum_for
    assert [q(n, w) for n, w in ((4, False), (4, True), (5, False),
                                 (5, True), (8, True), (1, True))] == \
        [2, 3, 3, 3, 5, 1]


@both
def test_token_roundtrip(pkg):
    tr = PKGS[pkg].tr
    tok = tr.make_token(AK, SK)
    assert tr.verify_token(tok, AK, SK)
    assert not tr.verify_token(tok, AK, "wrong")
    assert not tr.verify_token(tok, "other", SK)
    assert tr.verify_token(tr.make_token(AK, SK, ttl=-10), AK, SK)
    assert not tr.verify_token(tr.make_token(AK, SK, ttl=-60), AK, SK)


def test_tokens_cross_packages():
    """Either package's token verifies under the other's check."""
    assert port_transport.verify_token(ref_transport.make_token(AK, SK),
                                       AK, SK)
    assert ref_transport.verify_token(port_transport.make_token(AK, SK),
                                      AK, SK)
    assert not ref_transport.verify_token(
        port_transport.make_token(AK, SK), AK, "wrong")


@both
def test_local_locker_semantics(pkg):
    lk = PKGS[pkg].ll.LocalLocker()
    assert lk.lock("u1", ["res"], "o")
    assert not lk.lock("u2", ["res"], "o")       # exclusive
    assert not lk.rlock("u3", ["res"], "o")      # writer blocks readers
    assert lk.unlock("u1", ["res"])
    assert lk.rlock("u3", ["res"], "o")
    assert lk.rlock("u4", ["res"], "o")          # readers stack
    assert not lk.lock("u5", ["res"], "o")       # readers block writer
    lk.runlock("u3", ["res"])
    lk.runlock("u4", ["res"])
    assert lk.lock("u5", ["res"], "o")
    assert sorted(lk.dump()) == ["res"]
    assert lk.refresh("u5", ["res"]) and not lk.refresh("zz", ["res"])
    assert lk.force_unlock(["res"]) and not lk.dump()


@both
def test_local_locker_expiry(pkg):
    lk = PKGS[pkg].ll.LocalLocker()
    lk.lock("u1", ["a"], "o")
    assert lk.expire_old_locks(validity=0.0) == 1
    assert lk.lock("u2", ["a"], "o")             # stale grant swept


@both
def test_drwmutex_quorum_over_local_lockers(pkg):
    p = PKGS[pkg]
    lockers = [p.ll.LocalLocker() for _ in range(4)]
    dm = p.dsync.DRWMutex(lockers, ["bucket/obj"])
    assert dm.get_lock(timeout=2.0)
    dm2 = p.dsync.DRWMutex(lockers, ["bucket/obj"])
    assert not dm2.get_lock(timeout=0.5)
    assert dm.check()
    dm.unlock()
    assert dm2.get_lock(timeout=2.0)
    dm2.unlock()


@both
def test_drwmutex_readers_share(pkg):
    p = PKGS[pkg]
    lockers = [p.ll.LocalLocker() for _ in range(4)]
    r1 = p.dsync.DRWMutex(lockers, ["res"])
    r2 = p.dsync.DRWMutex(lockers, ["res"])
    assert r1.get_rlock(timeout=2.0)
    assert r2.get_rlock(timeout=2.0)
    w = p.dsync.DRWMutex(lockers, ["res"])
    assert not w.get_lock(timeout=0.5)
    r1.unlock()
    r2.unlock()
    assert w.get_lock(timeout=2.0)
    w.unlock()


@both
@pytest.mark.parametrize("dead,granted", [(1, True), (3, False)])
def test_drwmutex_quorum_with_dead_lockers(pkg, dead, granted):
    """1 of 5 lockers dead: writes proceed (tolerance 2); 3 of 5 dead:
    no write quorum, and the partial grants were rolled back."""
    p = PKGS[pkg]
    live = [p.ll.LocalLocker() for _ in range(5 - dead)]
    dm = p.dsync.DRWMutex(live + [None] * dead, ["res"])
    assert dm.get_lock(timeout=0.5) is granted
    if granted:
        dm.unlock()
    else:
        assert all(not lk.dump() for lk in live)


@both
def test_drwmutex_contention_one_winner(pkg):
    p = PKGS[pkg]
    lockers = [p.ll.LocalLocker() for _ in range(4)]
    wins = []

    def contender(i):
        dm = p.dsync.DRWMutex(lockers, ["hot"])
        if dm.get_lock(timeout=1.0):
            wins.append(i)
            time.sleep(0.8)
            dm.unlock()

    ts = [threading.Thread(target=contender, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert 1 <= len(wins) <= 2


@both
def test_refresh_keeps_long_hold_alive(pkg, monkeypatch):
    p = PKGS[pkg]
    monkeypatch.setattr(p.dsync, "REFRESH_INTERVAL", 0.05)
    lockers = [p.ll.LocalLocker() for _ in range(3)]
    dm = p.dsync.DRWMutex(lockers, ["bucket/long-op"])
    assert dm.get_lock(timeout=2.0)
    time.sleep(0.3)
    for lk in lockers:
        lk.expire_old_locks(validity=0.15)  # reaps only un-refreshed grants
    dm2 = p.dsync.DRWMutex(lockers, ["bucket/long-op"])
    assert not dm2.get_lock(timeout=0.3), "lock was lost while held"
    dm.unlock()
    assert dm2.get_lock(timeout=2.0)
    dm2.unlock()


# ---------------------------------------------------------------------------
# the lock RPC: servers of one package, clients of either
# ---------------------------------------------------------------------------

def _lock_servers(server_pkgs):
    """One lock RPC server per entry of server_pkgs, each on its own
    standalone RPC host of that package."""
    out = []
    for name in server_pkgs:
        p = PKGS[name]
        srv = p.rpc.LockRPCServer(p.ll.LocalLocker(), AK, SK,
                                  start_sweeper=False)
        host = p.tr.RPCServer().start()
        host.mount(srv.handler)
        out.append((srv, host))
    return out


@pytest.fixture()
def lock_hosts(request):
    servers = _lock_servers(request.param)
    yield servers
    for _srv, host in servers:
        host.stop()


def _clients(pkg, hosts, secret=SK):
    return [PKGS[pkg].rpc.LockRPCClient("127.0.0.1", h.port, AK, secret,
                                        timeout=2.0) for _s, h in hosts]


WIRES = [("ref", ["ref"] * 3), ("port", ["port"] * 3),
         ("port", ["ref"] * 3), ("ref", ["port"] * 3),
         ("port", ["ref", "port", "ref"])]
wires = pytest.mark.parametrize(
    "client,lock_hosts", WIRES, indirect=["lock_hosts"],
    ids=[f"{c}-to-{'+'.join(s)}" for c, s in WIRES])


@wires
def test_lock_rpc_roundtrip(client, lock_hosts):
    c = _clients(client, lock_hosts)[0]
    assert c.lock("uid1", ["b/o"], owner="me", source="test")
    assert not c.lock("uid2", ["b/o"])
    assert "b/o" in c.dump()
    assert c.refresh("uid1", ["b/o"])
    assert c.unlock("uid1", ["b/o"])
    assert c.lock("uid2", ["b/o"])
    assert c.force_unlock(["b/o"]) and c.dump() == {}
    assert c.online
    c.close()


@wires
def test_lock_rpc_auth_rejected(client, lock_hosts):
    bad = _clients(client, lock_hosts, secret="wrongsecret")[0]
    assert not bad.lock("uid", ["x"])
    assert bad.online              # the peer answered: it is alive
    assert not lock_hosts[0][0].locker.dump()
    bad.close()


@wires
def test_dist_drwmutex_over_rpc(client, lock_hosts):
    clients = _clients(client, lock_hosts)
    dm = PKGS[client].dsync.DRWMutex(list(clients), ["shared/obj"])
    assert dm.get_lock(timeout=3.0)
    # the grant sits on a write quorum of the servers, whichever package
    # serves it (the third may still be answering)
    assert sum("shared/obj" in srv.locker.dump()
               for srv, _h in lock_hosts) >= 2
    dm2 = PKGS[client].dsync.DRWMutex(list(clients), ["shared/obj"])
    assert not dm2.get_lock(timeout=0.5)
    dm.unlock()
    assert dm2.get_lock(timeout=3.0)
    dm2.unlock()


@wires
def test_dist_nslock_engine_interface(client, lock_hosts):
    """DistNSLockMap satisfies the engine's ns_lock seam."""
    ns = PKGS[client].dsync.DistNSLockMap(_clients(client, lock_hosts))
    with ns.new_lock("bucket/key").write_locked(timeout=3.0):
        other = ns.new_lock("bucket/key")
        assert not other.get_lock(timeout=0.3)
        assert not other.get_rlock(timeout=0.3)
    lk = ns.new_lock("bucket/key")
    assert lk.get_lock(timeout=3.0)
    lk.unlock()
    with ns.new_lock("bucket/key").read_locked(timeout=3.0):
        assert ns.new_lock("bucket/key").get_rlock(timeout=1.0)


@pytest.mark.parametrize("lock_hosts", [["port"] * 3], indirect=True)
def test_lock_timeout_raises_the_engines_error(lock_hosts):
    """A write_locked that times out raises the port's ObjectApiError,
    as object/nslock.py's own lock does."""
    from minio_tpu_torch.object import api_errors
    ns = port_dsync.DistNSLockMap(_clients("port", lock_hosts))
    held = ns.new_lock("b/k")
    assert held.get_lock(timeout=3.0)
    with pytest.raises(api_errors.ObjectApiError):
        with ns.new_lock("b/k").write_locked(timeout=0.3):
            pass
    held.unlock()


# ---------------------------------------------------------------------------
# DistNSLockMap behind the port's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lock_hosts", [["port"] * 3], indirect=True)
def test_engine_runs_on_dsync(tmp_path, lock_hosts):
    """Two port engines over the same drives, each with its own dsync
    map over the same three RPC lockers (two nodes of one cluster):
    objects written through one read back through the other, and a key
    lock held through one keeps the other's PUT of that key waiting."""
    from minio_tpu_torch.object.sets import ErasureSets
    drives = [str(tmp_path / f"d{i}") for i in range(6)]
    a = ErasureSets.from_drives(
        drives, 1, 6, 2, block_size=1 << 16, device="cpu",
        ns_lock=port_dsync.DistNSLockMap(_clients("port", lock_hosts),
                                         owner="node-a"))
    b = ErasureSets.from_drives(
        drives, 1, 6, 2, block_size=1 << 16, device="cpu",
        ns_lock=port_dsync.DistNSLockMap(_clients("port", lock_hosts),
                                         owner="node-b"))
    try:
        rng = np.random.default_rng(3)
        a.make_bucket("bk")
        data = rng.bytes(300_001)
        a.put_object("bk", "k", data)
        assert b"".join(b.get_object("bk", "k")[1]) == data
        held = a.sets[0].ns.new_lock("bk/k")
        assert held.get_lock(timeout=3.0)
        owners = {h["owner"] for srv, _h in lock_hosts
                  for h in srv.locker.dump().get("bk/k", [])}
        assert owners == {"node-a"}
        new = rng.bytes(70_000)
        done = threading.Event()
        t = threading.Thread(target=lambda: (b.put_object("bk", "k", new),
                                             done.set()))
        t.start()
        assert not done.wait(0.8)          # b's PUT waits on the lock
        held.unlock()
        t.join(timeout=30)
        assert done.is_set()
        assert b"".join(a.get_object("bk", "k")[1]) == new
    finally:
        a.close()
        b.close()
