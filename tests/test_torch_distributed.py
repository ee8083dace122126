"""The port's distributed node (minio_tpu_torch/cluster.py ClusterNode over
the internode plane, minio_tpu_torch/distributed/) held against
minio_tpu's, at the reference tests' size: 4 nodes x 4 drives, one 12+4
set, 64 KiB blocks (tests/test_cluster.py:48-91).

  * twin 4-node clusters in this process, one reference and one port
    (``device="cpu"``), take one signed S3 sequence with every identity
    pinned: a PUT through node 0 read through node 2, a multipart upload
    and an SSE-S3 object (ChaCha20) read whole and ranged through other
    nodes, listings; node 3's listener stopped, then every object read
    degraded and PUTs at write quorum; node 3 back, its drives brought to
    full redundancy by the writer's MRF queue; node 0's listener stopped
    and every object written during the loss read through the others.
    Statuses, masked bodies and headers are equal at every step, and
    every drive's files under the twin buckets are equal at each stage;
  * concurrent PUTs of one key through two port nodes (dsync): every
    GET returns one body whole and all 16 xl.meta agree;
  * a port node rebooted in place (shutdown, new ClusterNode on the same
    drives): its bootstrap verify, under the new node's boot generation,
    re-admits it on the peers at once (the generation listener) and
    their MRF queues heal what it missed;
  * the boot: the topology and one deployment id everywhere, the peer
    verbs the port serves (and the reference's 404 for the rest); the
    ``trace`` and ``events`` verbs answering alike;
  * IAM across nodes: a user added through node 0's admin router signs a
    PUT through node 2 (the iam-delta verb), and removed through node 1
    is refused on node 3; a ``?cluster=1`` scrape through node 1 carries
    all four nodes.

The boot's refusals and the CLI are in test_torch_distributed_boot.py.
"""

from __future__ import annotations

import hashlib
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import minio_tpu.cluster as ref_cluster
import minio_tpu.distributed.transport as ref_transport
import minio_tpu.features.crypto as ref_crypto
import minio_tpu.object.bucket_metadata as ref_bmeta
import minio_tpu.object.engine as ref_engine
import minio_tpu.object.multipart as ref_multipart
import minio_tpu.s3.handlers as ref_handlers
import minio_tpu_torch.cluster as port_cluster
import minio_tpu_torch.distributed.transport as port_transport
import minio_tpu_torch.features.crypto as port_crypto
import minio_tpu_torch.object.bucket_metadata as port_bmeta
import minio_tpu_torch.object.engine as port_engine
import minio_tpu_torch.object.multipart as port_multipart
import minio_tpu_torch.s3.handlers as port_handlers
from minio_tpu_torch.storage.xl_meta import XLMetaV2
from tests.test_s3 import CREDS, REGION, S3TestClient
from tests.test_torch_s3 import (MASTER, SSE_S3, _creation_dates,
                                 _mp_complete_xml, _norm, _upload_id, pin)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, DRIVES, BS = 4, 4, 1 << 16
TWIN_BUCKETS = ("twin", "lossy")


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def boot(cluster_mod, root, creds=CREDS, **kw):
    """Four nodes of cluster_mod booted concurrently, as four processes
    would boot them."""
    ports = free_ports(NODES)
    specs = [cluster_mod.NodeSpec("127.0.0.1", ports[i],
                                  [str(root / f"n{i}d{j}")
                                   for j in range(DRIVES)])
             for i in range(NODES)]
    out, errs = [None] * NODES, [None] * NODES

    def one(i):
        try:
            out[i] = cluster_mod.ClusterNode(
                specs, i, creds, parity=4, set_drive_count=16,
                block_size=BS, format_timeout=60.0, **kw)
        except Exception as e:  # noqa: BLE001 — raised below
            errs[i] = e

    ts = [threading.Thread(target=one, args=(i,)) for i in range(NODES)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    for e in errs:
        if e is not None:
            raise e
    return out


def shutdown_all(nodes):
    for n in nodes:
        try:
            n.shutdown()
        except Exception:  # noqa: BLE001 — best effort on the way down
            pass


def bucket_files(root) -> dict:
    """relative path -> bytes of every file under the twin buckets on
    every drive (the bucket data and its metadata blob)."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            parts = rel.split(os.sep)
            if parts[1] in TWIN_BUCKETS or (
                    parts[1:3] == [".minio.sys", "buckets"]
                    and parts[3] in TWIN_BUCKETS):
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def wait_online(*clusters) -> None:
    """Every node's clients of every peer back online (a restarted
    listener is found by the transport's probe)."""
    wait_for(lambda: all(rc.is_online() for nodes in clusters
                         for n in nodes for rc in n._remote_clients),
             30, "peers back online")


def settle(ref, port) -> None:
    """After a node's return: every peer sees it again and every node's
    MRF queue has drained (the PUTs' missed shards and the degraded
    reads' heals). Both packages' queues would wait out their retry
    backoff; the test kicks them once the node is seen again."""
    wait_online(ref, port)
    for n in ref + port:
        n.sets.mrf.kick()
    assert all(n.sets.mrf.drain(30) for n in ref + port)


def wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """(ref nodes, port nodes, roots): the twin clusters, booted with
    peer probes capped at 1 s (a returning listener is found within a
    second), their node-0 scanners and crawler stopped (their
    writes would interleave with the pinned request sequence), and every
    identity source pinned in both packages."""
    mp = pytest.MonkeyPatch()
    for tr in (ref_transport, port_transport):
        mp.setattr(tr, "HEALTH_PROBE_MAX", 1.0)
    # parts of 300 kB (S3's 5 MiB floor, cut for the CPU's plain steps)
    for mod in (ref_multipart, port_multipart):
        mp.setattr(mod, "MIN_PART_SIZE", 256 << 10)
    mp.setenv("MINIO_SSE_MASTER_KEY", MASTER)
    mp.setenv("MINIO_TPU_SSE_CIPHER", "chacha20")
    roots = {w: tmp_path_factory.mktemp(w) for w in ("ref", "port")}
    ref = boot(ref_cluster, roots["ref"])
    try:
        port = boot(port_cluster, roots["port"], device="cpu")
    except BaseException:
        shutdown_all(ref)
        raise
    for n in (ref[0], port[0]):
        for loop in ("heal_scanner", "crawler", "transition_worker"):
            getattr(n, loop).close()
            setattr(n, loop, None)
    # node 0's MRF queue heals what its PUTs missed; the other nodes'
    # queues are closed, so that no degraded GET queues a heal of its own:
    # such a heal, racing a node's return, may or may not rewrite a
    # multipart object's xl.meta on it (a completed multipart object
    # carries the drive's slot order as its erasure index, a heal the
    # distribution's), in either package, by timing alone
    for n in ref[1:] + port[1:]:
        n.sets.mrf.close()
    # a peer call that failed during the concurrent boot leaves its
    # client offline until the next probe
    wait_online(ref, port)
    pin(mp, ref_engine, ref_multipart, ref_bmeta, ref_handlers,
        ref_crypto)
    pin(mp, port_engine, port_multipart, port_bmeta, port_handlers,
        port_crypto)
    yield ref, port, roots
    shutdown_all(ref + port)
    mp.undo()


class Twin:
    """One request to both clusters, through the same node index of each;
    the normalized answers must be equal."""

    def __init__(self, twins):
        self.ref, self.port, self.roots = twins
        self.states: list[dict] = [{}, {}]

    def clients(self, i: int):
        return [S3TestClient("127.0.0.1", c[i].s3.port)
                for c in (self.ref, self.port)]

    def both(self, i: int, method: str, path: str, **kw):
        outs = [c.request(method, path, **kw) for c in self.clients(i)]
        a, b = outs
        ca, cb = _creation_dates(a[2]), _creation_dates(b[2])
        assert len(ca) == len(cb) and \
            all(abs(x - y) < 30 for x, y in zip(ca, cb))
        na, nb = _norm(a), _norm(b)
        assert na[0] == nb[0], f"{method} {path}: {na[0]} != {nb[0]} " \
            f"{a[2][:300]!r} {b[2][:300]!r}"
        assert na[1] == nb[1], f"{method} {path}: headers differ"
        assert na[2] == nb[2], f"{method} {path}: bodies differ"
        return b

    def same_files(self, what: str) -> dict:
        want = bucket_files(self.roots["ref"])
        got = bucket_files(self.roots["port"])
        assert sorted(want) == sorted(got), what
        assert [k for k in want if want[k] != got[k]] == [], what
        return got


RNG = np.random.default_rng(17)
DATA = {"small": RNG.bytes(1024), "big": RNG.bytes(600_001),
        "empty": b"", "part": RNG.bytes(300_000), "tail": RNG.bytes(77_777),
        "sse": RNG.bytes(200_000), "during0": RNG.bytes(300_000),
        "during1": RNG.bytes(64 << 10)}


def _stop(node) -> None:
    node.s3.stop()


def _restart(node, ref: bool) -> None:
    if ref:
        node._start_server(REGION, None)
    else:
        node._start_server(REGION)


def test_twin_boot_and_peer_plane(twins):
    ref, port, _ = twins
    for nodes in (ref, port):
        assert all((n.set_count, n.set_drive_count, n.parity) ==
                   (1, 16, 4) for n in nodes)
        assert len({n.sets.deployment_id for n in nodes}) == 1
        info = nodes[0].object_layer.storage_info()
        assert info["online_disks"] == 16, info
    assert all(n.metacache is None for n in port)
    assert [n.heal_scanner is None for n in port] == [True] * NODES
    p0 = port[0]
    info = p0.notification.server_info_all()
    assert sorted(i["addr"] for i in info) == \
        sorted(n.spec.addr for n in port[1:]), info
    storage = p0.notification.storage_info_all()
    assert all(s["online_disks"] == 16 for s in storage), storage
    rotated = p0.notification.tracker_rotate_all()
    assert len(rotated) == 3 and \
        all(isinstance(r, dict) for r in rotated), rotated
    probes = p0.notification.net_obd(size=1 << 16)
    assert all(r.get("bytes") == 1 << 16 for r in probes), probes
    # a verb of a plane the port has not got answers the reference's 404
    rc = port_transport.RestClient("127.0.0.1", port[1].s3.port,
                                   "/minio/peer/v1", CREDS.access_key,
                                   CREDS.secret_key)
    with pytest.raises(port_transport.RPCError) as ei:
        rc.call("metrics")
    assert ei.value.kind == "unknown-verb"
    # the identity, metrics and OBD verbs are served
    rc.call("reload-iam")
    assert b"minio_disks_online" in rc.call("metrics-text")
    obd = rc.call_json("obd")
    assert obd["node"] == port[1].spec.addr
    assert sorted(d["path"] for d in obd["drives"]) == \
        sorted(port[1].spec.drives)
    assert all(d["ok"] for d in obd["drives"]), obd["drives"]
    assert [o["node"] for o in p0.notification.obd_all()] == \
        [n.spec.addr for n in port[1:]]
    rc.close()


def test_twin_put_get_across_nodes(twins):
    t = Twin(twins)
    t.both(0, "PUT", "/twin")
    for name in ("small", "big", "empty"):
        t.both(0, "PUT", f"/twin/{name}", body=DATA[name])
    for name in ("small", "big", "empty"):
        got = t.both(2, "GET", f"/twin/{name}")
        assert got[2] == DATA[name]
        t.both(3, "HEAD", f"/twin/{name}")
    got = t.both(1, "GET", "/twin/big", headers={"range": "bytes=70000-"
                                                 "200000"})
    assert got[0] == 206 and got[2] == DATA["big"][70000:200001]
    t.same_files("after the PUTs")


def _wait_ring(node, pred, n: int) -> None:
    deadline = time.monotonic() + 10
    while sum(map(pred, list(node.s3.api.trace.recent))) < n and \
            time.monotonic() < deadline:
        time.sleep(0.02)


def test_twin_trace_and_events_verbs(twins):
    """The tracing plane's peer verbs answer alike on twin clusters:
    node 1's ``trace`` ring after one signed sequence through it (times,
    durations, TTFBs, trace ids, callers and node addresses masked, the
    address held to node 1's own), and its ``events`` window after the
    same record is emitted in each package (time, sequence and node
    masked)."""
    import minio_tpu.utils.eventlog as ref_eventlog
    import minio_tpu_torch.utils.eventlog as port_eventlog
    ref, port, _ = twins
    t = Twin(twins)
    mine = lambda e: e["path"].startswith("/twin/")     # noqa: E731
    # a record lands a hair after its response: once a request's record
    # is in, the earlier tests' records are in too, and each request
    # below waits for the last one's record, so that a loaded worker
    # cannot leave a record behind the clear or reorder the ring
    t.both(1, "GET", "/twin-sync")
    for nodes in (ref, port):
        _wait_ring(nodes[1], lambda e: e["path"] == "/twin-sync", 1)
        nodes[1].s3.api.trace.recent.clear()
    for i, (method, path) in enumerate((("GET", "/twin/small"),
                                        ("HEAD", "/twin/big"),
                                        ("GET", "/twin/nosuch")), 1):
        t.both(1, method, path)
        for nodes in (ref, port):
            _wait_ring(nodes[1], mine, i)
    for ev in (ref_eventlog, port_eventlog):
        ev.emit("rebalance.checkpoint", pool=0, objects=7)
    answers = []
    for tr, nodes in ((ref_transport, ref), (port_transport, port)):
        rc = tr.RestClient("127.0.0.1", nodes[1].s3.port,
                           "/minio/peer/v1", CREDS.access_key,
                           CREDS.secret_key)
        try:
            trace = [e for e in rc.call_json("trace")
                     if e["path"].startswith("/twin/")]
            events = [e for e in rc.call_json("events")
                      if e["class"] == "rebalance.checkpoint"]
        finally:
            rc.close()
        assert {e["node"] for e in trace} == {nodes[1].spec.addr}
        masked = ("time", "duration_ms", "ttfb_ms", "trace_id", "caller",
                  "node")
        answers.append((
            [{k: ("*" if k in masked else v) for k, v in e.items()}
             for e in trace],
            {k: ("*" if k in ("ts", "seq", "node") else v)
             for k, v in events[-1].items()}))
    assert len(answers[1][0]) == 3, answers[1][0]
    assert answers[0] == answers[1]


def test_twin_multipart_and_sse(twins):
    t = Twin(twins)
    outs = [c.request("POST", "/twin/mp", query={"uploads": ""})
            for c in t.clients(1)]
    assert _norm(outs[0]) == _norm(outs[1])
    uid = _upload_id(outs[1][2])
    assert uid == _upload_id(outs[0][2])
    etags = []
    for n, part in enumerate((DATA["part"], DATA["tail"])):
        got = t.both(n + 1, "PUT", "/twin/mp", body=part, query={
            "partNumber": str(n + 1), "uploadId": uid})
        etags.append(got[1]["etag"].strip('"'))
    t.both(3, "GET", "/twin/mp", query={"uploadId": uid})
    t.both(0, "POST", "/twin/mp", query={"uploadId": uid},
           body=_mp_complete_xml(etags))
    got = t.both(2, "GET", "/twin/mp")
    assert got[2] == DATA["part"] + DATA["tail"]
    t.both(0, "PUT", "/twin/sse", body=DATA["sse"], headers=SSE_S3)
    got = t.both(3, "GET", "/twin/sse")
    assert got[2] == DATA["sse"]
    got = t.both(1, "GET", "/twin/sse",
                 headers={"range": "bytes=65000-150000"})
    assert got[2] == DATA["sse"][65000:150001]
    t.same_files("after multipart and SSE")


def test_twin_listings(twins):
    t = Twin(twins)
    t.both(1, "GET", "/")
    t.both(2, "GET", "/twin", query={"list-type": "2"})
    t.both(3, "GET", "/twin", query={"list-type": "2", "max-keys": "2"})
    t.both(0, "GET", "/twin", query={"versions": ""})
    t.both(1, "GET", "/twin", query={"prefix": "s", "delimiter": "/"})


def _as(node, creds, method, path, **kw):
    return S3TestClient("127.0.0.1", node.s3.port, creds).request(
        method, path, **kw)


def test_twin_iam_across_nodes(twins):
    """A user added through node 0's admin router signs a PUT through
    node 2 (the peers applied the iam-delta); removed through node 1, it
    is refused on node 3. Equal answers from both clusters."""
    t = Twin(twins)
    user = type(CREDS)("nodeuser", "nodeusersecret")
    t.both(0, "PUT", "/minio/admin/v3/add-user",
           query={"accessKey": "nodeuser"},
           body=b'{"secretKey": "nodeusersecret"}')
    t.both(0, "PUT", "/minio/admin/v3/set-user-or-group-policy",
           query={"policyName": "readwrite", "userOrGroup": "nodeuser"})
    t.both(0, "PUT", "/iamb")
    outs = [_as(c[2], user, "PUT", "/iamb/o", body=DATA["small"])
            for c in (t.ref, t.port)]
    assert [o[0] for o in outs] == [200, 200]
    assert _norm(outs[0]) == _norm(outs[1])
    for c in (t.ref, t.port):
        assert all(n.iam.get_credentials("nodeuser") is not None
                   for n in c)
    t.both(1, "DELETE", "/minio/admin/v3/remove-user",
           query={"accessKey": "nodeuser"})
    outs = [_as(c[3], user, "GET", "/iamb/o") for c in (t.ref, t.port)]
    assert [o[0] for o in outs] == [403, 403]
    assert _norm(outs[0]) == _norm(outs[1])
    assert b"InvalidAccessKeyId" in outs[1][2]


def _peer_state(node) -> list:
    """Node 1's peer clients as a scrape leaves them: address, online,
    offline trips, network errors and fan-out sheds (the failure message
    of a scrape that dropped a node)."""
    import minio_tpu.distributed.peer_rpc as ref_peer
    import minio_tpu_torch.distributed.peer_rpc as port_peer
    shed = (port_peer if type(node).__module__.startswith("minio_tpu_torch")
            else ref_peer)._PARTITION_SHED
    return [(p.addr, p.rc.online, p.rc.offline_trips, p.rc.net_errors,
             shed.value(peer=p.addr)) for p in node.notification.peers]


def test_twin_cluster_scrape_merges_every_node(twins, monkeypatch):
    """?cluster=1 through node 1: one exposition carrying all four
    nodes, as the reference's cluster gives it.

    A peer that misses its pull's deadline is dropped from the merge by
    design. The reference bounds each pull by four times the peer's
    observed p99, floored at 0.5 s (MINIO_TPU_PEER_SHED_DEADLINE_X, a
    tightening the port does not have), and a peer's render (the
    process's registry and its 16 drives' disk info, 12 of them over
    storage RPC) passes that on a loaded worker: the reference then
    drops the peer where the port keeps it. So the deadline is pinned
    alike in both: the reference's tightening off, and
    MINIO_TPU_CLUSTER_SCRAPE_S at 8 s, below the 10 s the fan-out waits
    for its threads."""
    from minio_tpu_torch.utils import promfed
    monkeypatch.setenv("MINIO_TPU_CLUSTER_SCRAPE_S", "8")
    monkeypatch.setenv("MINIO_TPU_PEER_SHED_DEADLINE_X", "0")
    t = Twin(twins)
    merged = []
    for nodes in (t.ref, t.port):
        before = _peer_state(nodes[1])
        t0 = time.monotonic()
        st, _h, body = S3TestClient("127.0.0.1", nodes[1].s3.port).request(
            "GET", "/minio/admin/v3/metrics", query={"cluster": "1"})
        took = time.monotonic() - t0
        assert st == 200
        fam = promfed.parse_exposition(body.decode())["minio_disks_online"]
        merged.append(sorted(
            (dict(labels)["node"], v)
            for (_n, labels), v in fam.samples.items()))
        assert [a for a, _v in merged[-1]] == \
            sorted(n.spec.addr for n in nodes), (
            f"{type(nodes[1]).__module__}: scrape took {took:.3f} s; "
            f"peers (addr, online, offline trips, net errors, sheds) "
            f"before {before} after {_peer_state(nodes[1])}")
    assert [v for _a, v in merged[0]] == [v for _a, v in merged[1]] \
        == [16] * NODES


def test_twin_node_loss_mrf_and_second_loss(twins):
    """Node 3's listener stops: every object reads degraded through the
    others, and PUTs through node 0 commit at write quorum (12 of 16).
    Node 3 returns; node 0's MRF queue heals its drives without a
    restart of the others (equal files in both clusters). Then node 0's
    listener stops and the objects written during the loss read through
    node 1 and node 2 from node 3's healed shards."""
    t = Twin(twins)
    ref, port, roots = twins
    t.both(0, "PUT", "/lossy")
    mrf0 = [n[0].sets.mrf for n in (ref, port)]
    assert [q.queued for q in mrf0] == [0, 0]
    for nodes, is_ref in ((ref, True), (port, False)):
        _stop(nodes[3])
    try:
        assert t.both(2, "GET", "/twin/sse")[2] == DATA["sse"]
        assert t.both(2, "GET", "/twin/mp")[2] == \
            DATA["part"] + DATA["tail"]
        for name in ("small", "big", "empty"):
            assert t.both(1, "GET", f"/twin/{name}")[2] == DATA[name]
        for name in ("during0", "during1"):
            t.both(0, "PUT", f"/lossy/{name}", body=DATA[name])
        for name in ("during0", "during1"):
            assert t.both(1, "GET", f"/lossy/{name}")[2] == DATA[name]
        missing = [k for k in bucket_files(roots["port"])
                   if k.startswith("n3") and "/lossy/" in k]
        assert missing == []
    finally:
        for nodes, is_ref in ((ref, True), (port, False)):
            _restart(nodes[3], is_ref)

    def healed(root) -> bool:
        files = bucket_files(root)
        return all(any(k.startswith(f"n3d{j}{os.sep}lossy{os.sep}{name}")
                       and k.endswith("part.1") for k in files)
                   for j in range(DRIVES) for name in ("during0",
                                                        "during1"))

    settle(ref, port)
    assert healed(roots["ref"]) and healed(roots["port"])
    # each PUT during the loss queued one heal on node 0, healed once
    # node 3 was back
    assert [(q.queued, q.healed) for q in mrf0] == [(2, 2), (2, 2)]
    t.same_files("after MRF")
    for nodes in (ref, port):
        _stop(nodes[0])
    try:
        for i in (1, 2):
            for name in ("during0", "during1"):
                assert t.both(i, "GET", f"/lossy/{name}")[2] == DATA[name]
    finally:
        for nodes, is_ref in ((ref, True), (port, False)):
            _restart(nodes[0], is_ref)
    settle(ref, port)
    t.same_files("at the end")


# the port's identity sources as imported, before any fixture pins them
_REAL_IDS = [(mod, name, getattr(mod, name))
             for mod, name in ((port_engine, "_uuid"), (port_engine, "now"),
                               (port_multipart, "_uuid"),
                               (port_multipart, "now"), (port_bmeta, "time"),
                               (port_handlers, "uuid"),
                               (port_crypto, "secrets"))]


@pytest.fixture(scope="module")
def solo(tmp_path_factory):
    """A port cluster of its own; its tests run unpinned."""
    root = tmp_path_factory.mktemp("solo")
    nodes = boot(port_cluster, root, device="cpu")
    yield nodes, root
    shutdown_all(nodes)


@pytest.fixture
def unpinned(monkeypatch):
    """The port's real identity sources for one test, over the twins'
    pins, which hold until the module ends: racing PUTs must draw
    distinct ids, and the pinned counter is not thread-safe (two PUTs
    that draw one uuid share a tmp dir, and their commits mix)."""
    for mod, name, real in _REAL_IDS:
        monkeypatch.setattr(mod, name, real)


def test_concurrent_puts_of_one_key_through_two_nodes(solo, unpinned):
    """Rounds of two PUTs of one key racing through nodes 0 and 2: the
    namespace lock is dsync across the nodes, so each GET returns one
    body whole and the 16 drives' xl.meta agree."""
    port, root = solo
    c0, c2 = (S3TestClient("127.0.0.1", port[i].s3.port) for i in (0, 2))
    assert c0.request("PUT", "/race")[0] == 200
    rng = np.random.default_rng(5)
    for rnd in range(4):
        bodies = [rng.bytes(200_000 + rnd), rng.bytes(200_000 + rnd)]
        errs: list = []

        def put(c, body):
            try:
                st = c.request("PUT", "/race/key", body=body)[0]
                assert st == 200, st
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append(e)

        ts = [threading.Thread(target=put, args=(c, b))
              for c, b in ((c0, bodies[0]), (c2, bodies[1]))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=60)
        assert not errs
        got = S3TestClient("127.0.0.1", port[1].s3.port).request(
            "GET", "/race/key")
        assert got[0] == 200 and got[2] in bodies
        versions = set()
        for i in range(NODES):
            for j in range(DRIVES):
                with open(os.path.join(root, f"n{i}d{j}", "race", "key",
                                       "xl.meta"), "rb") as f:
                    fis = XLMetaV2.loads(f.read()).list_file_infos(
                        "race", "key")
                # the drive's erasure index is its own; the rest agrees
                versions.add(tuple((fi.version_id, fi.data_dir, fi.size,
                                    fi.mod_time, fi.metadata["etag"])
                                   for fi in fis))
        assert len(versions) == 1 and len(next(iter(versions))) == 1
        assert next(iter(versions))[0][4] == \
            hashlib.md5(got[2]).hexdigest()


def test_reboot_in_place_heals_through_mrf(solo, unpinned):
    """A port node shut down and booted again on its drives: while it is
    down PUTs commit at quorum; its boot's bootstrap verify, under a new
    boot generation, re-admits it on every peer at once (no probe wait),
    and the writer's MRF queue, at its next retry, brings its drives to
    full redundancy."""
    nodes, tmp_path = solo
    c0 = S3TestClient("127.0.0.1", nodes[0].s3.port)
    assert c0.request("PUT", "/rbk")[0] == 200
    nodes[3].shutdown()
    data = np.random.default_rng(9).bytes(250_000)
    assert c0.request("PUT", "/rbk/o", body=data)[0] == 200
    specs = nodes[3].nodes
    t0 = time.monotonic()
    nodes[3] = port_cluster.ClusterNode(specs, 3, CREDS, parity=4,
                                        set_drive_count=16,
                                        block_size=BS, device="cpu")
    assert all(rc.is_online() for rc in nodes[0]._remote_clients)
    wait_for(lambda: all(os.path.exists(
        tmp_path / f"n3d{j}" / "rbk" / "o" / "xl.meta")
        for j in range(DRIVES)), 20, "MRF heal of node 3")
    assert time.monotonic() - t0 < 20
    # 12 drives left with node 1 gone: the read needs node 3's shards
    nodes[1].s3.stop()
    try:
        got = S3TestClient("127.0.0.1", nodes[3].s3.port).request(
            "GET", "/rbk/o")
        assert got[0] == 200 and got[2] == data
    finally:
        nodes[1]._start_server(REGION)
