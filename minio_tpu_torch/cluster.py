"""Cluster assembly — boot a node into a running (multi-)node system.

Counterpart of minio_tpu/cluster.py (the reference's serverMain,
cmd/server-main.go:371-533): expand the drive arguments, divide them into
erasure sets, start the S3 listener with the internode RPC routers
(storage, lock, peer, bootstrap) mounted on it, verify the cluster config
against the peers, then format or open the drives and late-bind the
object layer into the handlers. A node's own drives are local XLStorage
objects (also exported over storage RPC for its peers); every other
node's drives are RemoteStorage clients. The drive order is the endpoint
order, identical on every node, so each drive holds the same erasure-set
slot cluster-wide; node 0 formats a fresh cluster and the others wait for
its format. A distributed node's namespace lock is dsync over every
node's locker. Each node has its own batch former on its own device: a
PUT that reaches a node encodes and hashes there, and its shards go to
the other nodes' drives over storage RPC.

The boot follows ``ClusterNode._finish_boot`` (minio_tpu/cluster.py:
143-211): one cross-request batch former, the admission gate and the
staging rings sized from one RAM/CPU budget, the sets over the drives
with that former, one pool of them; then the background plane
(minio_tpu/cluster.py:556-617): the disk monitor (a wiped or replaced
drive is formatted for its slot and its set sweep-healed), the
data-update tracker every mutation marks and, on the first node only, the
hinted heal scanner over it (pulling the peers' tracker snapshots), the
data-usage crawler whose cache quota reads, and the transition worker.
As in the reference: the persisted bucket metacache, on by default
(``MINIO_TPU_METACACHE``), serves the listings of a single node and feeds
its scanners (minio_tpu/cluster.py:521-531); a distributed node keeps the
merge-walk, since a write through a peer never reaches its journal. With
``MINIO_TPU_CACHE=on`` the hot-object read cache sits in front of the
layer for the S3 surface, while the background planes keep the raw layer
(:541-555); the crawler enforces lifecycle expiry, noncurrent expiry and
stale multipart aborts (:598-617). The tier plane (:483-490, :575-612):
the tier registry loaded from the drives at boot, one transition worker
(also the async RestoreObject worker), and the crawler's transition,
noncurrent-transition and restore-reclaim actions, with the expiry
actions freeing transitioned versions' remote copies. The pool plane
(:216-224, :501-519, :623-655): the boot resumes a drain that a restart
interrupted (``resume_rebalance_if_pending``), runs the fsck auditor in
repair mode under ``MINIO_TPU_FSCK_BOOT=on`` (on the first node only)
after the tier registry loads and before the metacache and scanners start
(a failed audit is logged and the boot proceeds, as in the reference; it
sees the boot's pools only, not those ``add_pool`` appends after it), and
``add_pool`` appends a pool of local drives online (the CLI's
``--pool``). ``FSNode`` and ``start_fs`` (:763-796) serve one directory
through the plain-file backend (object/fs.py), with the root credential
only.

Node identity (its address) rides every RPC handler and client
explicitly, so several nodes can run in one process; they share the
process's staging rings, one per geometry, as in the reference.

``device`` picks where the sets' fused steps and the Select scans run:
None means the card, and a host without one raises rather than serving
from the CPU; ``device="cpu"`` runs the plain PyTorch versions on the
host.

The identity and operator planes (:226-233, :271-289, :307-315,
:357-360, :445-447): IAM over the erasure-coded identity store (its
records are objects of the node's layer under ``.minio.sys/config/iam/``,
loaded at boot), every mutation pushed to the peers as a per-entity
delta (the ``iam-delta`` verb, a wholesale ``reload-iam`` as its
fallback) and a full reload every ``MINIO_TPU_IAM_REFRESH_S``; the admin,
health and Prometheus routers (s3/admin.py) on the node's listener, the
peers' ``metrics-text`` verb rendering through the same handler; and the
config KV (config/kv.py), applied to the handlers at boot and on every
admin set-config.

The tracing plane (minio_tpu/cluster.py:300-351): console lines at boot,
at the boot fsck, at a pool's addition and at shutdown; the event journal
and the flight recorder on drive 0; the SLO engine; the recorder's
providers (healthtrack, membership, slo, topology); and the peer hooks of
the trace, event, incident, profiling and console verbs. Trace records
carry each node's address; the journal is process-global, and its records
carry the address of the first node that booted in the process, as in the
reference.

The boot loads the QoS plane's budget registry (s3/qos.py) from every
pool, and the transition worker paces its pushes by the registry's
per-tier budgets.

Bucket event notification (minio_tpu/cluster.py:389-400, :455-481): the
legacy event notifier (features/events.py) with its durable queue under
``<drive 1>/.minio.sys/events`` and the config-KV notify targets; the
notification plane (notify/) with its target registry loaded from every
pool, its per-target queue under ``.minio.sys/notify/queue``, owner
routing over the peers' ``notify-event`` verb and registry reloads over
``notify-reload``; the crawler's lifecycle expiry sends
s3:ObjectRemoved:Lifecycle. The plane's site id comes from the
replication target registry.

Active-active replication (minio_tpu/cluster.py:401-444, :715-717): the
target registry (replicate/targets.py) loaded from every pool and, on a
first boot, saved with the minted site id; the replication plane
(replicate/plane.py) on the layer's namespace feed with the bucket
metadata's replication rules; each bucket's legacy remote targets
mounted into the registry; the plane closed at shutdown before the
notification plane. Its pushes read through the layer's GET and its
replica writes go through the layer's PUT, so both run on the card past
the codec's gate. Departure: the plane's ``bandwidth`` monitor stays
None (the port has no bandwidth monitor yet).

Left out: the etcd IAM store and federation, the web router, the
bandwidth admin route (it answers NotImplemented), and the peer verbs of
those planes.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Optional

from . import device as device_mod
from .distributed import membership
from .distributed.dsync import DistNSLockMap
from .distributed.local_locker import LocalLocker
from .distributed.lock_rpc import LockRPCClient, LockRPCServer
from .distributed.peer_rpc import (BootstrapRPCServer, NotificationSys,
                                   PeerRPCClient, PeerRPCServer,
                                   verify_server_system_config)
from .distributed.storage_rpc import RemoteStorage, StorageRPCServer
from .config import ConfigSys
from .iam import IAMSys
from .features.lifecycle import (crawler_action, mpu_abort_action,
                                 noncurrent_sweep_action)
from .object import cache as cache_mod
from .object import metacache as metacache_mod
from .object.background import DataUsageCrawler, DiskMonitor, HealScanner
from .object.cache import CacheObjects
from .object.fsck import run_fsck
from .object.metacache import MetacacheManager
from .object.nslock import NSLockMap
from .object.server_sets import ErasureServerSets
from .object.sets import ErasureSets
from .parallel import pipeline as _pipeline
from .parallel.scheduler import BatchScheduler, requests_budget
from .s3.admin import mount_admin
from .s3.credentials import Credentials, global_credentials
from .s3.server import S3Server
from .storage import errors as serr
from .object.update_tracker import DataUpdateTracker
from .storage.xl_storage import XLStorage
from .tier.client import TierClientError
from .tier.config import TierManager
from .tier.transition import (TransitionWorker,
                              noncurrent_transition_action,
                              restore_reclaim_action, transition_action)
from .utils import (console as console_mod, ellipses, eventlog,
                    healthtrack, incidents, knobs, slo)

# the tracing plane's process-global services (the journal's flusher, the
# SLO engine, the flight recorder) are shared by every node of the
# process; the last node to shut down stops them and detaches the journal
# and recorder from their drive, so that the next boot replays the
# journal's segments as a new process would
_PLANE_MU = threading.Lock()
_PLANE_NODES = 0


@dataclasses.dataclass
class NodeSpec:
    """One node: where it listens and which drive paths it owns."""
    host: str
    port: int
    drives: list[str]

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"


def parse_node_arg(arg: str) -> NodeSpec:
    """"host:port=/d{1...4}" or "host:port=/a,/b" -> NodeSpec."""
    addr, _, paths = arg.partition("=")
    if not paths:
        raise ValueError(f"node arg needs host:port=drives, got {arg!r}")
    host, _, port = addr.rpartition(":")
    drives = []
    for p in paths.split(","):
        drives.extend(ellipses.expand_arg(p))
    return NodeSpec(host or "127.0.0.1", int(port), drives)


class ClusterNode:
    """One running node: S3 endpoint + internode RPC + object layer over
    its local drives and, in a distributed cluster, the peers' drives."""

    def __init__(self, nodes: list[NodeSpec], this: int,
                 creds: Credentials, parity: Optional[int] = None,
                 set_drive_count: int = 0, block_size: int = 1 << 22,
                 region: str = "us-east-1",
                 bootstrap_timeout: float = 30.0,
                 format_timeout: float = 30.0,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None, device=None):
        device = device_mod.resolve(device)
        self.nodes = nodes
        self.this = this
        self.creds = creds
        self.spec = nodes[this]
        self.distributed = len(nodes) > 1
        # this process speaks as spec.addr; every RPC carries it and the
        # boot generation so peers fence stale per-peer state after a
        # restart (in-process clusters boot several nodes per process:
        # their handlers and clients carry this node's id and a boot
        # generation of its own, which win over the process-level
        # fallback, so a node rebooted in the process is a new
        # incarnation to its peers)
        membership.set_local_node(self.spec.addr)
        self.generation = membership.mint_generation()
        all_drives = [(ni, path) for ni, n in enumerate(nodes)
                      for path in n.drives]
        total = len(all_drives)
        if set_drive_count:
            if total % set_drive_count:
                raise ValueError("drives not divisible into sets")
            set_count = total // set_drive_count
        else:
            set_count, set_drive_count = ellipses.divide_into_sets(
                total, [len(n.drives) for n in nodes])
        if parity is None:
            parity = set_drive_count // 2   # reference default EC:N/2
        self.set_count, self.set_drive_count = set_count, set_drive_count
        self.parity = parity
        self.scheduler: Optional[BatchScheduler] = None
        self.sets: Optional[ErasureSets] = None
        self.object_layer: Optional[ErasureServerSets] = None
        self.disk_monitor: Optional[DiskMonitor] = None
        self.update_tracker: Optional[DataUpdateTracker] = None
        self.heal_scanner: Optional[HealScanner] = None
        self.crawler: Optional[DataUsageCrawler] = None
        self.metacache: Optional[MetacacheManager] = None
        self.read_cache: Optional[CacheObjects] = None
        self.tiers: Optional[TierManager] = None
        self.transition_worker: Optional[TransitionWorker] = None
        self.notification: Optional[NotificationSys] = None
        self.events = None           # the legacy EventNotifier
        self.repl_targets = None     # replicate.TargetRegistry (site id)
        self.replication = None      # replicate.ReplicationPlane
        self.notify_targets = None   # notify.NotifyTargetRegistry
        self.notify_plane = None     # notify.NotificationPlane
        self.iam: Optional[IAMSys] = None
        self.config: Optional[ConfigSys] = None
        self.admin = None            # the AdminHandlers mount_admin made
        self._iam_refresh_stop = threading.Event()
        self.boot_fsck = None        # the boot audit's FsckReport, if run
        self.pools: list = []        # pools add_pool appended after boot
        # the process's console-log ring, its lines tagged with this node
        self.console = console_mod.get_console()
        self._plane_on = False       # this node holds the tracing plane
        self._block_size = block_size
        self._device = device
        self._tls = (certfile, keyfile)
        self._remote_clients: list[RemoteStorage] = []
        self._lock_clients: list[LockRPCClient] = []
        self._peer_clients: list[PeerRPCClient] = []

        # -- local drives + RPC servers on this node's listener ------------
        # a faulty drive becomes a None slot, never a boot abort
        self.local_drives: dict[str, XLStorage] = {}
        for path in self.spec.drives:
            try:
                self.local_drives[path] = XLStorage(path)
            except serr.StorageError:
                pass
        self.locker = LocalLocker()
        ak, sk = creds.access_key, creds.secret_key
        self._storage_rpc = StorageRPCServer(self.local_drives, ak, sk)
        self._lock_rpc = LockRPCServer(self.locker, ak, sk)
        self._peer_rpc = PeerRPCServer(ak, sk, node_id=self.spec.addr)
        endpoints = [f"{n.addr}{p}" for n in nodes for p in n.drives]
        self._bootstrap_rpc = BootstrapRPCServer(ak, sk, endpoints)
        for srv in (self._storage_rpc, self._lock_rpc, self._peer_rpc,
                    self._bootstrap_rpc):
            self._identify(srv.handler)
        # the listener starts before the drives are formatted (the
        # reference serves before newObjectLayer returns): peers' format
        # reads and the bootstrap verify reach it meanwhile
        self.s3: Optional[S3Server] = None
        self._start_server(region)
        try:
            self._finish_boot(all_drives, endpoints, block_size, device,
                              bootstrap_timeout, format_timeout)
        except BaseException:
            # a failed boot must not leak the listening server or the
            # RPC clients (shutdown is idempotent on a partial boot)
            self.shutdown()
            raise

    def _finish_boot(self, all_drives, endpoints, block_size: int, device,
                     bootstrap_timeout: float,
                     format_timeout: float) -> None:
        nodes, this = self.nodes, self.this
        ak, sk = self.creds.access_key, self.creds.secret_key
        # -- bootstrap verify against peers --------------------------------
        peers = [(n.host, n.port) for i, n in enumerate(nodes)
                 if i != this]
        if peers:
            verify_server_system_config(
                peers, endpoints, ak, sk,
                retries=max(int(bootstrap_timeout), 1),
                node_id=self.spec.addr, generation=self.generation)
        # -- the drive list in global endpoint order -----------------------
        drives: list = []
        for ni, path in all_drives:
            if ni == this:
                drives.append(self.local_drives.get(path))
            else:
                rc = RemoteStorage(nodes[ni].host, nodes[ni].port, path,
                                   ak, sk)
                self._identify(rc.rc)
                self._remote_clients.append(rc)
                drives.append(rc)
        # -- namespace lock: dsync across every node when distributed ------
        if self.distributed:
            lockers: list = []
            for i, n in enumerate(nodes):
                if i == this:
                    lockers.append(self.locker)
                else:
                    lc = LockRPCClient(n.host, n.port, ak, sk)
                    self._identify(lc.rc)
                    self._lock_clients.append(lc)
                    lockers.append(lc)
            ns_lock = DistNSLockMap(lockers, owner=self.spec.addr)
        else:
            ns_lock = NSLockMap()
        # -- cross-request device batch former + RAM-budgeted admission ----
        self.scheduler = BatchScheduler()
        budget = requests_budget(block_size, self.set_drive_count)
        self.s3.api.requests_budget = budget
        self.s3.api.set_max_clients(budget)
        # staging rings sized from the SAME admission budget (each
        # admitted stream keeps ~2 batches in flight); buffers are
        # allocated, and pinned, lazily on first use
        _pipeline.configure_pool_buffers(budget)
        # -- format bootstrap (waitForFormatErasure) -----------------------
        deadline = time.monotonic() + format_timeout
        while True:
            try:
                self.sets = ErasureSets.from_storage(
                    drives, self.set_count, self.set_drive_count,
                    self.parity, block_size=block_size, ns_lock=ns_lock,
                    create_format=(this == 0), scheduler=self.scheduler,
                    device=device)
                break
            except serr.StorageError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.5)
        # distributed clusters are single-pool: skip the boot-time
        # cluster-wide topology read, which during a concurrent boot races
        # peers still formatting (the default map, all-active, is a
        # one-pool cluster's only state)
        self.object_layer = ErasureServerSets(
            [self.sets], load_topology=not self.distributed)
        self.s3.api.set_object_layer(self.object_layer)
        # a drain interrupted by a restart resumes from its persisted
        # checkpoint (the pool is still marked draining in the topology
        # doc) instead of starting over
        try:
            self.object_layer.resume_rebalance_if_pending()
        except Exception:  # noqa: BLE001 — boot must proceed; a later
            pass           # start_decommission restarts the drain
        # the scan plane on the shared former: concurrent Selects coalesce
        # their pages into one launch on the cluster's device (the engine
        # took the layer's device in set_object_layer)
        self.s3.api.scan.scheduler = self.scheduler
        # -- IAM over the object layer (the erasure-coded identity store) --
        if self.s3.api.iam is None:
            self.s3.api.iam = IAMSys(self.object_layer, root_cred=self.creds)
        self.iam = self.s3.api.iam
        self.iam.bucket_policy_lookup = \
            lambda b: self.s3.api.bucket_meta.get(b).policy_json
        # -- peer control plane hooks (the planes the port has) ------------
        self._peer_clients = [PeerRPCClient(n.host, n.port, ak, sk)
                              for i, n in enumerate(nodes) if i != this]
        for pc in self._peer_clients:
            self._identify(pc.rc)
        self.notification = NotificationSys(self._peer_clients)
        self._peer_rpc.get_locks = self.locker.dump
        self._peer_rpc.get_server_info = lambda: {
            "addr": self.spec.addr,
            "sets": self.set_count,
            "drives_per_set": self.set_drive_count,
        }
        bmeta = self.s3.api.bucket_meta
        self._peer_rpc.reload_bucket_metadata = bmeta.reload
        bmeta.on_change = self.notification.reload_bucket_metadata
        self._peer_rpc.get_storage_info = self.object_layer.storage_info
        self._peer_rpc.obd_drive_paths = list(self.spec.drives)
        self._peer_rpc.get_bucket_usage = \
            lambda: (self.crawler.usage if self.crawler is not None
                     else {})
        self._peer_rpc.reload_iam = self.iam.load
        self._peer_rpc.apply_iam_delta = self.iam.apply_delta
        self.iam.on_change = self.notification.reload_iam
        self.iam.on_delta = self.notification.iam_delta
        # bounded staleness: a delta lost to a transient partition (the
        # sender's per-peer reload fallback failing too) must not diverge
        # this node forever; the whole cache reloads on an interval, as
        # the reference's IAM refresh loop does
        threading.Thread(target=self._iam_refresh_loop,
                         args=(knobs.get_float("MINIO_TPU_IAM_REFRESH_S"),),
                         name="iam-refresh", daemon=True).start()
        # -- admin / health / metrics routers ------------------------------
        self.admin = mount_admin(self.s3, self)
        self._peer_rpc.get_metrics_text = self.admin.metrics.local_text
        self._start_tracing_plane()
        # service restart/stop: peers run the same local action the admin
        # endpoint runs, deferred so that the RPC reply reaches the sender
        self._peer_rpc.signal_service = \
            lambda sig: threading.Timer(
                0.2, self.admin.service_action, (sig,)).start()
        # -- config KV (newAllSubsystems ConfigSys + lookupConfigs) --------
        self.config = ConfigSys(self.object_layer, secret=sk)
        self.s3.api.config = self.config
        # -- live bucket events (the legacy notifier) ----------------------
        # the durable event backlog lives under the node's first local
        # drive (queuestore.go: pending events survive a restart)
        from .features import EventNotifier
        evq = os.path.join(self.spec.drives[0], ".minio.sys", "events") \
            if self.spec.drives else None
        self.events = EventNotifier(self.s3.api.bucket_meta, queue_dir=evq)
        self.s3.api.events = self.events
        # -- active-active replication plane (replicate/) ------------------
        # the epoch-versioned target registry recovers from every pool
        # (highest epoch wins: targets survive decommission) and carries
        # this site's id, which the notification plane stamps on its
        # records too; the plane rides the layer's namespace feed, so
        # every mutation verb reaches the replication queue
        from .replicate import ReplicationPlane, TargetRegistry
        self.repl_targets = TargetRegistry(self.object_layer)
        try:
            if not self.repl_targets.load():
                # first boot: persist the minted site id so replicas
                # pushed before and after a restart carry ONE origin
                self.repl_targets.save()
        except Exception:  # noqa: BLE001 — boot proceeds; admin re-adds
            pass
        # the port has no bandwidth monitor yet, so the plane's
        # ``bandwidth`` stays None (no per-bucket egress accounting)
        self.replication = ReplicationPlane(
            self.object_layer, self.repl_targets,
            bucket_meta=self.s3.api.bucket_meta)
        self.object_layer.attach_replication(self.replication)
        try:
            buckets = [v.name for v in self.object_layer.list_buckets()]
        except Exception as e:  # noqa: BLE001 — boot must proceed, but
            # an unlistable namespace leaves targets unmounted: say so
            self.console.log_line(
                "ERROR", f"replication target mount skipped: {e}")
            buckets = []
        # legacy bucket-metadata remote targets mount into the registry
        for b in buckets:
            try:
                for entry in self.s3.api.bucket_meta.get(
                        b).replication_targets:
                    entry = dict(entry, source_bucket=b)
                    self.replication.mount_target_entry(entry)
            except Exception:  # noqa: BLE001 — per-bucket best effort
                continue
        self.s3.api.replication = self.replication
        self.config.apply(self.s3.api, events=self.events,
                          trace=self.s3.api.trace)
        # -- bucket event notification plane (notify/) ---------------------
        # the every-pool registry rule of the tiers; the plane rides the
        # layer's namespace feed, so every mutation verb reaches its
        # queue, and its per-target backlog lives beside the legacy
        # queue on the first local drive
        from .notify import NotificationPlane, NotifyTargetRegistry
        self.notify_targets = NotifyTargetRegistry(self.object_layer)
        try:
            self.notify_targets.load()
        except Exception:  # noqa: BLE001 — boot proceeds; admin re-adds
            pass
        nq = os.path.join(self.spec.drives[0], ".minio.sys", "notify",
                          "queue") if self.spec.drives else None
        self.notify_plane = NotificationPlane(
            self.object_layer, self.notify_targets,
            bucket_meta=self.s3.api.bucket_meta, queue_dir=nq,
            node=self.spec.addr, nodes=[n.addr for n in nodes],
            site_id=self.repl_targets.site_id)
        # owner-node delivery: a non-owner hands the event to the
        # bucket's owner over the peer plane (no double fire), and the
        # peers' registries reload on an admin target mutation
        npeers = {p.addr: p for p in self._peer_clients}
        self.notify_plane.forward_fn = \
            lambda addr, b, k: (addr in npeers
                                and npeers[addr].notify_event(b, k))
        self._peer_rpc.notify_event = self.notify_plane.ingest
        self._peer_rpc.notify_reload = self.notify_targets.load
        self.notify_plane.reload_peers = self.notification.notify_reload
        self.object_layer.attach_notifications(self.notify_plane)
        self.s3.api.notify = self.notify_plane
        # -- tier plane (remote tiers + ILM transitions) --------------------
        self.tiers = TierManager(self.object_layer)
        try:
            self.tiers.load()
        except TierClientError:
            pass    # loaded; its gateway-typed tiers cannot be served
        self.s3.api.tiers = self.tiers
        # -- QoS budget registry (s3/qos.py) -------------------------------
        # the tiers' every-pool persistence rule: recover the newest budget
        # doc; a missing or torn doc means default budgets
        self.s3.api.qos.registry.obj = self.object_layer
        try:
            self.s3.api.qos.registry.load()
        except Exception:  # noqa: BLE001 — boot proceeds on defaults
            pass
        # -- boot-time crash-consistency audit (object/fsck.py) ------------
        # MINIO_TPU_FSCK_BOOT=on: the first node audits the boot's pools
        # (add_pool's come later, as in the reference) and repairs what
        # the last crash left behind BEFORE the index and the scanners
        # start trusting the tree
        if this == 0 and knobs.get_bool("MINIO_TPU_FSCK_BOOT"):
            self._boot_fsck()
        # -- bucket metacache (persisted listing index + scanner feed) -----
        # single nodes only: deltas are engine-local, so writes through a
        # PEER's S3 endpoint would never feed this node's journal;
        # distributed nodes keep the merge-walk
        if metacache_mod.enabled() and not self.distributed:
            self.metacache = MetacacheManager(self.object_layer).start()
            self.object_layer.attach_metacache(self.metacache)
        # -- hot-object read cache in front of the erasure path ------------
        if cache_mod.enabled() and self.spec.drives:
            self.read_cache = CacheObjects.from_env(
                self.object_layer, os.path.join(self.spec.drives[0],
                                                ".minio.sys", "cache"))
            # invalidation rides the namespace feed; the S3 surface serves
            # through the wrapper (a hit skips the erasure decode), and
            # the background planes keep the raw layer, so that they never
            # fill the cache
            self.object_layer.attach_read_cache(self.read_cache)
            self.s3.api.set_object_layer(self.read_cache)
        # -- background plane (initAutoHeal + initDataCrawler) -------------
        self.disk_monitor = DiskMonitor(self.sets).start()
        # data-update tracker: every mutation marks the bloom; the heal
        # scanner prunes unchanged work (cmd/data-update-tracker.go)
        self.update_tracker = DataUpdateTracker(os.path.join(
            self.spec.drives[0], ".minio.sys", "tracker",
            "update-tracker.bin") if self.spec.drives else "")
        self.s3.api.update_tracker = self.update_tracker
        self._peer_rpc.get_update_tracker = \
            self.update_tracker.rotate_snapshot
        if this != 0:
            return
        # the first node runs the heal scanner (over every node's
        # tracker), the transition worker and the crawler, whose usage
        # cache feeds quota, once per cluster
        self.heal_scanner = HealScanner(
            self.object_layer, self.update_tracker,
            peer_snapshots=self.notification.tracker_rotate_all).start()
        # one transition worker, on the raw layer and throttled off the
        # foreground; the async RestoreObject pulls ride it too
        self.transition_worker = TransitionWorker(self.object_layer,
                                                  self.tiers)
        # per-tier push budgets come from the QoS registry's "tier" scope
        # (the doc shape the tenant budgets use)
        self.transition_worker.budget_lookup = \
            lambda name: self.s3.api.qos.registry.get("tier", name)
        self.transition_worker.start()
        self.s3.api.restore_worker = self.transition_worker
        self.crawler = DataUsageCrawler(
            self.object_layer,
            actions=[crawler_action(bmeta, self.object_layer,
                                    self.events, tiers=self.tiers),
                     transition_action(bmeta, self.transition_worker),
                     restore_reclaim_action(self.object_layer,
                                            self.tiers)],
            bucket_actions=[
                mpu_abort_action(bmeta, self.object_layer),
                noncurrent_sweep_action(bmeta, self.object_layer,
                                        tiers=self.tiers),
                noncurrent_transition_action(bmeta,
                                             self.transition_worker)],
        ).start()
        self.s3.api.usage = self.crawler

    def _iam_refresh_loop(self, refresh_s: float) -> None:
        while not self._iam_refresh_stop.wait(refresh_s):
            try:
                self.iam.load()
            except Exception:  # noqa: BLE001 — retry next tick
                pass

    def _identify(self, end) -> None:
        """Stamp this node's id and boot generation on one of its RPC
        handlers or clients."""
        end.node_id, end.generation = self.spec.addr, self.generation

    def _boot_fsck(self) -> None:
        """Audit the boot's pools and repair what it finds (a pool that
        add_pool appends later is not seen); the report stays
        on the node. A failed audit is logged and the boot proceeds, as
        in the reference (a later run_fsck repeats it on demand)."""
        try:
            rep = run_fsck(self.object_layer, repair=True, tiers=self.tiers)
        except Exception as e:  # noqa: BLE001 — boot must proceed
            print(f"boot fsck failed: {e!r}", file=sys.stderr, flush=True)
            self.console.log_line("ERROR", f"boot fsck failed: {e}")
            return
        self.boot_fsck = rep
        if not rep.clean:
            line = (f"boot fsck: found {rep.counts()}, repaired "
                    f"{rep.repaired_counts()}, unrepaired "
                    f"{len(rep.unrepaired)}")
            print(line, file=sys.stderr, flush=True)
            self.console.log_line("INFO", line)

    def _start_tracing_plane(self) -> None:
        """Console lines, the event journal and the flight recorder on
        drive 0 (``.minio.sys/eventlog``, ``.minio.sys/incidents``), the
        SLO engine, the recorder's state providers and the tracing
        plane's peer hooks (minio_tpu/cluster.py:300-351). The journal,
        engine and recorder are process-global: the first node to boot
        attaches them, and the last to shut down stops them."""
        global _PLANE_NODES
        self.console.node = self.spec.addr
        self.console.log_line("INFO", f"node {self.spec.addr} online")
        with _PLANE_MU:
            _PLANE_NODES += 1
            self._plane_on = True
            if self.spec.drives:
                meta = os.path.join(self.spec.drives[0], ".minio.sys")
                eventlog.JOURNAL.attach(os.path.join(meta, "eventlog"),
                                        node=self.spec.addr)
                incidents.RECORDER.attach(os.path.join(meta, "incidents"))
            if knobs.get_bool("MINIO_TPU_SLO"):
                slo.ENGINE.ensure_started()
        rec = incidents.RECORDER
        rec.add_provider("healthtrack", lambda: {
            "drives": healthtrack.TRACKER.snapshot("drive"),
            "peers": healthtrack.TRACKER.snapshot("peer")})
        rec.add_provider("membership", membership.TRACKER.snapshot)
        rec.add_provider("slo", slo.ENGINE.status)
        rec.add_provider("topology", self._topology_state)
        pr = self._peer_rpc
        pr.get_trace = lambda: list(self.s3.api.trace.recent) \
            if self.s3 is not None else []
        pr.event_hub = eventlog.JOURNAL.hub
        pr.get_events = lambda: eventlog.JOURNAL.recent(500)
        pr.list_incidents = rec.list
        pr.get_incident = rec.get

    def _topology_state(self) -> dict:
        topo = getattr(self.object_layer, "topology", None)
        return topo.to_dict() if topo is not None else {}

    def _stop_tracing_plane(self) -> None:
        """Persist the journal's tail; the last node of the process
        also stops the SLO engine and the recorder and detaches the
        journal (its flusher stops after a last flush)."""
        global _PLANE_NODES
        if not self._plane_on:
            return
        self._plane_on = False
        self.console.log_line("INFO",
                              f"node {self.spec.addr} shutting down")
        with _PLANE_MU:
            _PLANE_NODES -= 1
            last = _PLANE_NODES == 0
        if not last:
            try:
                eventlog.JOURNAL.flush()
            except Exception:  # noqa: BLE001 — best-effort on the way down
                pass
            return
        slo.ENGINE.stop()
        incidents.RECORDER.detach()
        eventlog.JOURNAL.detach()

    # ------------------------------------------------------------------
    # topology: online pool expansion
    # ------------------------------------------------------------------

    def add_pool(self, drive_roots: list[str], set_drive_count: int = 0,
                 parity: Optional[int] = None) -> int:
        """Append one pool of LOCAL drives to the running node (online
        expansion; the single-node form of upstream's server-pool list).
        Bumps and persists the placement epoch; new writes weigh the new
        capacity at once. The new pool's sets share the node's batch
        former and device. Returns the new pool index."""
        paths = ellipses.expand_args(list(drive_roots))
        if set_drive_count:
            if len(paths) % set_drive_count:
                raise ValueError("drives not divisible into sets")
            set_count = len(paths) // set_drive_count
        else:
            set_count, set_drive_count = ellipses.divide_into_sets(
                len(paths), [len(paths)])
        if parity is None:
            parity = set_drive_count // 2
        sets = ErasureSets.from_drives(
            paths, set_count, set_drive_count, parity,
            block_size=self._block_size, scheduler=self.scheduler,
            device=self._device)
        idx = self.object_layer.add_pool(sets)
        # the running DiskMonitor covers the new pool's drives too: a
        # drive dying in a post-boot pool re-admits and heals like a
        # boot-time one
        if self.disk_monitor is not None:
            self.disk_monitor.add_pool(sets)
        self.pools.append(sets)
        self.console.log_line(
            "INFO", f"pool {idx} added ({len(paths)} drives, "
            f"epoch {self.object_layer.topology.epoch})")
        return idx

    def _start_server(self, region: str) -> None:
        """The S3 listener with every internode router mounted (the
        reference's configureServerHandler); also restarts a stopped
        node's listener on its address."""
        certfile, keyfile = self._tls
        self.s3 = S3Server(None, address=self.spec.host,
                           port=self.spec.port, region=region,
                           creds=self.creds, iam=self.iam,
                           certfile=certfile, keyfile=keyfile)
        self.s3.register_router("/minio/storage/", self._storage_rpc.route)
        self.s3.register_router("/minio/lock/", self._lock_rpc.route)
        self.s3.register_router("/minio/peer/", self._peer_rpc.route)
        self.s3.register_router("/minio/bootstrap/",
                                self._bootstrap_rpc.route)
        # trace records carry this node's name, and the peers' follow
        # streams subscribe to this listener's hub
        self.s3.api.trace.node = self.spec.addr
        self._peer_rpc.trace_hub = self.s3.api.trace.hub
        self.s3.start()

    @property
    def url(self) -> str:
        return self.s3.url

    def shutdown(self) -> None:
        """Idempotent; safe on a partially-booted node. The background
        loops and the transition worker close, the metacache closes
        (persisting what is dirty), the tracker flushes and the event
        notifier and notification plane close first, then
        the server stops, then a running drain, then the pools, then the
        former, then the RPC clients. The IAM refresh loop stops first,
        and the tracing plane's journal persists its tail (the last node
        of the process stops the plane's threads)."""
        self._iam_refresh_stop.set()
        self._stop_tracing_plane()
        for loop in ("disk_monitor", "crawler", "transition_worker",
                     "heal_scanner"):
            if getattr(self, loop) is not None:
                getattr(self, loop).close()
                setattr(self, loop, None)
        if self.metacache is not None:
            self.metacache.close()
            self.metacache = None
        if self.update_tracker is not None:
            try:
                self.update_tracker.flush()
            except Exception:  # noqa: BLE001 — hints only
                pass
            self.update_tracker = None
        if self.events is not None:
            self.events.close()
            self.events = None
        if self.replication is not None:
            self.replication.close()
            self.replication = None
        if self.notify_plane is not None:
            self.notify_plane.close()
            self.notify_plane = None
        if self.s3 is not None:
            self.s3.stop()
            self.s3 = None
        if self.object_layer is not None and \
                self.object_layer._rebalancer is not None:
            # a running drain stops, checkpointed, before its pools close
            self.object_layer._rebalancer.stop()
        if self.sets is not None:
            self.sets.close()
            self.sets = None
        for pool in self.pools:
            pool.close()
        self.pools = []
        if self.scheduler is not None:
            self.scheduler.close()
            self.scheduler = None
        self._lock_rpc.close()
        for c in (self._remote_clients + self._lock_clients
                  + self._peer_clients):
            c.close()
        self._remote_clients, self._lock_clients = [], []
        self._peer_clients = []


def start_node(nodes: list[NodeSpec], this: int,
               creds: Optional[Credentials] = None, **kw) -> ClusterNode:
    """Boot node `this` of a cluster described by `nodes` (reference
    `minio server http://host{1...4}/export{1...4}`)."""
    return ClusterNode(nodes, this, creds or global_credentials(), **kw)


def start_single(drives: list[str], address: str = "127.0.0.1",
                 port: int = 0, creds: Optional[Credentials] = None,
                 **kw) -> ClusterNode:
    """Single-node server over local drives (reference `minio server
    /data/d{1...16}`)."""
    creds = creds or global_credentials()
    paths = ellipses.expand_args(drives)
    return ClusterNode([NodeSpec(address, port, paths)], 0, creds, **kw)


class FSNode:
    """Single-directory FS-backend server (the reference's
    newObjectLayer one-endpoint branch, cmd/server-main.go:524-532): no
    erasure, a plain file tree, the S3 surface. The backend does no
    device work; ``device`` (None: the card) is where the handlers'
    ChaCha20 SSE GETs would decipher, resolved at boot like every entry
    point's. IAM over the directory's ``.minio.sys`` and the admin,
    health and metrics routers serve it too (minio_tpu/cluster.py:
    773-783)."""

    def __init__(self, root: str, address: str = "127.0.0.1",
                 port: int = 0, creds: Optional[Credentials] = None,
                 region: str = "us-east-1", device=None):
        from .object.fs import FSObjects
        self.creds = creds or global_credentials()
        self.object_layer = FSObjects(root,
                                      device=device_mod.resolve(device))
        self.iam = IAMSys(self.object_layer, root_cred=self.creds)
        self.s3: Optional[S3Server] = S3Server(
            self.object_layer, address=address, port=port, region=region,
            creds=self.creds, iam=self.iam)
        self.iam.bucket_policy_lookup = \
            lambda b: self.s3.api.bucket_meta.get(b).policy_json
        self.admin = mount_admin(self.s3)
        self.s3.start()

    @property
    def url(self) -> str:
        return self.s3.url

    def shutdown(self) -> None:
        """Idempotent."""
        if self.s3 is not None:
            self.s3.stop()
            self.s3 = None


def start_fs(root: str, address: str = "127.0.0.1", port: int = 0,
             creds: Optional[Credentials] = None, **kw) -> FSNode:
    """FS-backend server over one directory (reference `minio server
    /data`)."""
    return FSNode(root, address, port, creds, **kw)
