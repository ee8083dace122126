"""Notification-target registry: where bucket events go.

The reference wires targets from server config (cmd/config/notify/);
this registry promotes them to a first-class persisted document —
``.minio.sys/notify/targets.json`` written to EVERY pool and recovered
deterministic-winner, exactly the durability rule of the topology /
tier / replicate / qos registries: any surviving subset of pools
recovers the newest target map, and a same-epoch fork is an fsck
finding, never a coin flip.

Three target types cover the delivery matrix without external brokers:

* ``webhook`` — POST the event JSON to an HTTP endpoint (the reference
  webhook target; params: ``endpoint``, ``timeout``, optional
  ``auth_token`` sent as a Bearer header and redacted in listings);
* ``queue``   — an in-process bounded record sink (tests, the admin
  event tail, ListenBucketNotification-style consumers);
* ``log``     — append one JSON line per event to a local file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import urllib.request
import uuid as _uuid
from typing import Optional

from ..object import api_errors
from ..storage.xl_storage import MINIO_META_BUCKET
from ..utils import atomicfile, crashpoint, eventlog, regfence

NOTIFY_PREFIX = "notify/"
TARGETS_OBJECT = NOTIFY_PREFIX + "targets.json"

TARGET_TYPES = ("webhook", "queue", "log")

_SECRET_PARAMS = ("auth_token", "secret_key")


class NotifyTargetError(api_errors.ObjectApiError):
    """Invalid notification-target operation (duplicate ARN, unknown
    ARN, bad spec)."""


def new_arn(name: str, type_: str) -> str:
    """Mint a reference-shape notification ARN
    (``arn:minio:sqs::<id>:<type>`` — pkg/event/arn.go)."""
    return f"arn:minio:sqs::{name or _uuid.uuid4().hex[:12]}:{type_}"


@dataclasses.dataclass
class NotifyTarget:
    """One registered event destination."""
    arn: str
    type: str = "webhook"          # "webhook" | "queue" | "log"
    params: dict = dataclasses.field(default_factory=dict)

    def to_dict(self, redact: bool = False) -> dict:
        params = dict(self.params)
        if redact:
            for k in _SECRET_PARAMS:
                if params.get(k):
                    params[k] = "REDACTED"
        return {"arn": self.arn, "type": self.type, "params": params}

    @classmethod
    def from_dict(cls, d: dict) -> "NotifyTarget":
        arn = str(d.get("arn", "")).strip()
        type_ = str(d.get("type", "webhook")).strip()
        if not arn:
            raise NotifyTargetError("target needs an arn")
        if type_ not in TARGET_TYPES:
            raise NotifyTargetError(
                f"unknown target type {type_!r} "
                f"(expected one of {TARGET_TYPES})")
        t = cls(arn=arn, type=type_, params=dict(d.get("params") or {}))
        t.validate()
        return t

    def validate(self) -> None:
        if self.type == "webhook" and not self.params.get("endpoint"):
            raise NotifyTargetError(
                "webhook targets need params.endpoint")
        if self.type == "log" and not self.params.get("path"):
            raise NotifyTargetError("log targets need params.path")


# ---------------------------------------------------------------------------
# senders (the live delivery side of a registered target)
# ---------------------------------------------------------------------------

class WebhookSender:
    """POST the event JSON to an endpoint (pkg/event/target/webhook)."""

    def __init__(self, arn: str, endpoint: str, timeout: float = 2.0,
                 auth_token: str = ""):
        self.arn = arn
        self.endpoint = endpoint
        self.timeout = timeout
        self.auth_token = auth_token

    def send(self, record: dict) -> None:
        body = json.dumps(record).encode()
        headers = {"Content-Type": "application/json"}
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        req = urllib.request.Request(self.endpoint, data=body,
                                     method="POST", headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()


class QueueSender:
    """In-process bounded record sink (tests / event tails)."""

    def __init__(self, arn: str, limit: int = 10000):
        self.arn = arn
        self.limit = limit
        self.records: list[dict] = []
        self._cond = threading.Condition()

    def send(self, record: dict) -> None:
        with self._cond:
            if len(self.records) >= self.limit:
                raise NotifyTargetError(
                    f"queue target {self.arn!r} is full "
                    f"({self.limit} records)")
            self.records.append(record)
            self._cond.notify_all()

    def wait_for(self, n: int, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while len(self.records) < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    return False
            return True


class LogSender:
    """Append one JSON line per event to a local file."""

    def __init__(self, arn: str, path: str):
        self.arn = arn
        self.path = path
        self._mu = threading.Lock()

    def send(self, record: dict) -> None:
        line = json.dumps(record) + "\n"
        with self._mu:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line)


def make_sender(target: NotifyTarget):
    p = target.params
    if target.type == "webhook":
        return WebhookSender(target.arn, str(p.get("endpoint", "")),
                             timeout=float(p.get("timeout", 2.0) or 2.0),
                             auth_token=str(p.get("auth_token", "")))
    if target.type == "queue":
        return QueueSender(target.arn,
                           limit=int(p.get("limit", 10000) or 10000))
    if target.type == "log":
        return LogSender(target.arn, str(p.get("path", "")))
    raise NotifyTargetError(f"unknown target type {target.type!r}")


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class NotifyTargetRegistry:
    """The live target map + sender cache. Every mutation bumps
    ``epoch`` and persists BEFORE it takes effect (the TierManager
    discipline: a crash mid-add replays, never forgets a target a
    bucket rule already references)."""

    def __init__(self, object_layer=None):
        self.obj = object_layer
        self._mu = threading.Lock()
        self.epoch = 0
        self.updated = time.time()
        self.targets: dict[str, NotifyTarget] = {}
        self._senders: dict[str, object] = {}
        # lineage fencing: every epoch commit chains a hash of
        # (parent lineage, epoch, writer) — see utils/regfence.py
        self.writer = ""
        self.parent_lineage = ""
        self.lineage = ""

    def _advance_lineage(self) -> None:
        """Chain the fencing hash for the epoch just committed (caller
        holds ``_mu``)."""
        self.parent_lineage = self.lineage
        self.writer = regfence.default_writer()
        self.lineage = regfence.lineage(self.parent_lineage,
                                        self.epoch, self.writer)

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------

    def add(self, target: NotifyTarget, update: bool = False) -> int:
        """Register (or with `update` replace) a target; the spec
        validates before the registry mutates. Returns the new epoch."""
        target.validate()
        with self._mu:
            if not update and target.arn in self.targets:
                raise NotifyTargetError(
                    f"target {target.arn!r} already exists")
            prev = self.targets.get(target.arn)
            self.targets[target.arn] = target
            self._senders.pop(target.arn, None)
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:              # roll back the in-memory map
                if prev is None:
                    self.targets.pop(target.arn, None)
                else:
                    self.targets[target.arn] = prev
            raise
        self._emit_update(epoch)
        return epoch

    def remove(self, arn: str) -> int:
        with self._mu:
            if arn not in self.targets:
                raise NotifyTargetError(f"unknown target {arn!r}")
            prev = self.targets.pop(arn)
            self._senders.pop(arn, None)
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:
                self.targets[arn] = prev
            raise
        self._emit_update(epoch)
        return epoch

    def get(self, arn: str) -> NotifyTarget:
        with self._mu:
            t = self.targets.get(arn)
        if t is None:
            raise NotifyTargetError(f"unknown target {arn!r}")
        return t

    def arns(self) -> set[str]:
        with self._mu:
            return set(self.targets)

    def list(self, redact: bool = True) -> list[dict]:
        with self._mu:
            return [t.to_dict(redact=redact)
                    for t in sorted(self.targets.values(),
                                    key=lambda t: t.arn)]

    def sender(self, arn: str):
        """The live delivery object of a registered target (built
        lazily; survives re-registration only through set_sender)."""
        with self._mu:
            s = self._senders.get(arn)
            t = self.targets.get(arn)
        if s is not None:
            return s
        if t is None:
            raise NotifyTargetError(f"unknown target {arn!r}")
        s = make_sender(t)
        with self._mu:
            return self._senders.setdefault(arn, s)

    def set_sender(self, arn: str, sender) -> None:
        """Swap the live sender of a registered target (chaos tests
        wrap the real sender in a NaughtyTarget)."""
        self.get(arn)
        with self._mu:
            self._senders[arn] = sender

    def _emit_update(self, epoch: int) -> None:
        with self._mu:
            n = len(self.targets)
        eventlog.emit("notify.update", epoch=epoch, targets=n)

    # ------------------------------------------------------------------
    # persistence (every pool, deterministic winner)
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        with self._mu:
            return {"epoch": self.epoch, "updated": self.updated,
                    "targets": [t.to_dict()
                                for t in self.targets.values()],
                    "writer": self.writer,
                    "parent_lineage": self.parent_lineage,
                    "lineage": self.lineage}

    def _pools(self):
        if self.obj is None:
            return []
        return getattr(self.obj, "server_sets", None) or [self.obj]

    def save(self) -> int:
        """Write the registry to every pool; the configured write
        quorum must land or the mutation is rejected (caller rolls
        back)."""
        pools = self._pools()
        if not pools:
            return 0
        payload = json.dumps(self.to_dict()).encode()
        landed = 0
        last: Optional[Exception] = None
        for z in pools:
            try:
                # one hit per pool (arm :<nth>)
                crashpoint.hit("notify.registry.save.pool")
                z.put_object(MINIO_META_BUCKET, TARGETS_OBJECT, payload)
                landed += 1
            except Exception as e:  # noqa: BLE001 — per-pool durability
                last = e
        need = regfence.write_quorum(len(pools))
        if landed < need:
            # refusing a minority-side epoch bump (caller rolls back)
            raise NotifyTargetError(
                f"notify targets epoch {self.epoch} persisted to "
                f"{landed} of {len(pools)} pool(s), need {need}: "
                f"{last!r}")
        return landed

    def load(self) -> bool:
        """Recover the newest persisted registry (deterministic winner
        across pools); returns True when a doc was found. Live senders
        reset and reconstruct lazily."""
        docs: list[dict] = []
        for z in self._pools():
            try:
                _, stream = z.get_object(MINIO_META_BUCKET,
                                         TARGETS_OBJECT)
                doc = atomicfile.load_json_doc(b"".join(stream))
            except api_errors.ObjectApiError:
                continue
            if doc is None:     # torn/truncated copy: other pools win
                continue
            docs.append(doc)
        # deterministic winner; same-epoch/different-lineage copies are
        # a fork fsck surfaces — load never coin-flips between them
        best = regfence.pick_best(docs)
        if best is None:
            return False
        targets = {}
        for d in best.get("targets", []):
            try:
                t = NotifyTarget.from_dict(d)
            except NotifyTargetError:
                continue
            targets[t.arn] = t
        with self._mu:
            self.epoch = int(best.get("epoch", 0))
            self.updated = float(best.get("updated", time.time()))
            self.targets = targets
            self.writer = str(best.get("writer", ""))
            self.parent_lineage = str(best.get("parent_lineage", ""))
            self.lineage = str(best.get("lineage", ""))
            self._senders.clear()
        return True
