"""Single-node boot — local drives into a running S3 server.

Counterpart of the single-node part of minio_tpu/cluster.py (the
reference's serverMain, cmd/server-main.go:371-533): expand the drive
arguments, divide them into erasure sets, start the S3 listener, then
format or open the drives and late-bind the object layer into the
handlers. The boot follows ``ClusterNode._finish_boot``
(minio_tpu/cluster.py:143-210): one cross-request batch former, the
admission gate and the staging rings sized from one RAM/CPU budget, the
sets over the drives with that former, one pool of them; then the
background plane of a single node (minio_tpu/cluster.py:556-617): the
disk monitor (a wiped or replaced drive is formatted for its slot and its
set sweep-healed), the data-update tracker every mutation marks, the
hinted heal scanner over it, and the data-usage crawler whose cache
quota reads. Also as in the reference's single node: the persisted bucket
metacache, on by default (``MINIO_TPU_METACACHE``), serves the listings
and feeds both scanners (minio_tpu/cluster.py:521-531); with
``MINIO_TPU_CACHE=on`` the hot-object read cache sits in front of the
layer for the S3 surface, while the background planes keep the raw layer
(:541-555); the crawler enforces lifecycle expiry, noncurrent expiry and
stale multipart aborts (:598-617). The tier plane (:483-490, :575-612):
the tier registry loaded from the drives at boot, one transition worker
(also the async RestoreObject worker), and the crawler's transition,
noncurrent-transition and restore-reclaim actions, with the expiry
actions freeing transitioned versions' remote copies.

``device`` picks where the sets' fused steps and the Select scans run:
None means the card, and a host without one raises rather than serving
from the CPU; ``device="cpu"`` runs the plain PyTorch versions on the
host.

Left out: distributed nodes (internode storage, lock, peer and bootstrap
RPC, dsync), IAM, config KV, events, replication, notification, the QoS
registry (the transition worker's per-tier budgets), the boot fsck, the
admin, health and web routers (the admin tier routes with them), the
incident plane, online pool expansion and the single-path FS backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from . import device as device_mod
from .features.lifecycle import (crawler_action, mpu_abort_action,
                                 noncurrent_sweep_action)
from .object import cache as cache_mod
from .object import metacache as metacache_mod
from .object.background import DataUsageCrawler, DiskMonitor, HealScanner
from .object.cache import CacheObjects
from .object.metacache import MetacacheManager
from .object.nslock import NSLockMap
from .object.server_sets import ErasureServerSets
from .object.sets import ErasureSets
from .parallel import pipeline as _pipeline
from .parallel.scheduler import BatchScheduler, requests_budget
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
from .utils import ellipses


@dataclasses.dataclass
class NodeSpec:
    """One node: where it listens and which drive paths it owns."""
    host: str
    port: int
    drives: list[str]

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"


class ClusterNode:
    """One running single node: S3 endpoint + object layer over local
    drives."""

    def __init__(self, spec: NodeSpec, creds: Credentials,
                 parity: Optional[int] = None, set_drive_count: int = 0,
                 block_size: int = 1 << 22, region: str = "us-east-1",
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None, device=None):
        device = device_mod.resolve(device)
        self.spec = spec
        self.creds = creds
        total = len(spec.drives)
        if set_drive_count:
            if total % set_drive_count:
                raise ValueError("drives not divisible into sets")
            set_count = total // set_drive_count
        else:
            set_count, set_drive_count = ellipses.divide_into_sets(
                total, [total])
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
        # the listener starts before the drives are formatted (the
        # reference serves before newObjectLayer returns)
        self.s3: Optional[S3Server] = S3Server(
            None, address=spec.host, port=spec.port, region=region,
            creds=creds, certfile=certfile, keyfile=keyfile).start()
        try:
            self._finish_boot(block_size, device)
        except BaseException:
            # a failed boot must not leak the listening server
            self.shutdown()
            raise

    def _finish_boot(self, block_size: int, device) -> None:
        # a faulty drive becomes a None slot, never a boot abort
        drives: list = []
        for path in self.spec.drives:
            try:
                drives.append(XLStorage(path))
            except serr.StorageError:
                drives.append(None)
        # -- cross-request device batch former + RAM-budgeted admission ----
        self.scheduler = BatchScheduler()
        budget = requests_budget(block_size, self.set_drive_count)
        self.s3.api.set_max_clients(budget)
        # staging rings sized from the SAME admission budget (each
        # admitted stream keeps ~2 batches in flight); buffers are
        # allocated, and pinned, lazily on first use
        _pipeline.configure_pool_buffers(budget)
        self.sets = ErasureSets.from_storage(
            drives, self.set_count, self.set_drive_count, self.parity,
            block_size=block_size, ns_lock=NSLockMap(),
            scheduler=self.scheduler, device=device)
        self.object_layer = ErasureServerSets([self.sets])
        self.s3.api.set_object_layer(self.object_layer)
        # the scan plane on the shared former: concurrent Selects coalesce
        # their pages into one launch on the cluster's device (the engine
        # took the layer's device in set_object_layer)
        self.s3.api.scan.scheduler = self.scheduler
        # -- bucket metacache (persisted listing index + scanner feed) -----
        if metacache_mod.enabled():
            self.metacache = MetacacheManager(self.object_layer).start()
            self.object_layer.attach_metacache(self.metacache)
        # -- hot-object read cache in front of the erasure path ------------
        if cache_mod.enabled():
            self.read_cache = CacheObjects.from_env(
                self.object_layer, os.path.join(self.spec.drives[0],
                                                ".minio.sys", "cache"))
            # invalidation rides the namespace feed; the S3 surface serves
            # through the wrapper (a hit skips the erasure decode), and
            # the background planes keep the raw layer, so that they never
            # fill the cache
            self.object_layer.attach_read_cache(self.read_cache)
            self.s3.api.set_object_layer(self.read_cache)
        # -- tier plane (remote tiers + ILM transitions) --------------------
        self.tiers = TierManager(self.object_layer)
        try:
            self.tiers.load()
        except TierClientError:
            pass    # loaded; its gateway-typed tiers cannot be served
        self.s3.api.tiers = self.tiers
        # -- background plane (initAutoHeal + initDataCrawler) -------------
        self.disk_monitor = DiskMonitor(self.sets).start()
        # data-update tracker: every mutation marks the bloom; the heal
        # scanner prunes unchanged work (cmd/data-update-tracker.go)
        self.update_tracker = DataUpdateTracker(os.path.join(
            self.spec.drives[0], ".minio.sys", "tracker",
            "update-tracker.bin"))
        self.s3.api.update_tracker = self.update_tracker
        # a single node is the cluster's first node: it runs the scanner
        # and the crawler, whose usage cache feeds quota
        self.heal_scanner = HealScanner(self.object_layer,
                                        self.update_tracker).start()
        # one transition worker, on the raw layer and throttled off the
        # foreground; the async RestoreObject pulls ride it too
        self.transition_worker = TransitionWorker(self.object_layer,
                                                  self.tiers).start()
        self.s3.api.restore_worker = self.transition_worker
        bmeta = self.s3.api.bucket_meta
        self.crawler = DataUsageCrawler(
            self.object_layer,
            actions=[crawler_action(bmeta, self.object_layer,
                                    tiers=self.tiers),
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

    @property
    def url(self) -> str:
        return self.s3.url

    def shutdown(self) -> None:
        """Idempotent; safe on a partially-booted node. The background
        loops and the transition worker close, the metacache closes
        (persisting what is dirty) and the tracker flushes first, then
        the server stops, then the sets, then the former."""
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
        if self.s3 is not None:
            self.s3.stop()
            self.s3 = None
        if self.sets is not None:
            self.sets.close()
            self.sets = None
        if self.scheduler is not None:
            self.scheduler.close()
            self.scheduler = None


def start_single(drives: list[str], address: str = "127.0.0.1",
                 port: int = 0, creds: Optional[Credentials] = None,
                 **kw) -> ClusterNode:
    """Single-node server over local drives (reference `minio server
    /data/d{1...16}`)."""
    creds = creds or global_credentials()
    paths = ellipses.expand_args(drives)
    return ClusterNode(NodeSpec(address, port, paths), creds, **kw)
