"""The multi-tenant QoS plane: fairness enforced at the one gate.

Counterpart of minio_tpu/s3/qos.py, ported whole. Every authenticated
request maps to a **tenant**: the root credential, a plain IAM user, or,
for service accounts and STS credentials, the parent user they roll up to
(reference cmd/iam.go parentUser). The mapping costs one
Authorization-header parse (the *claimed* access key, no signature work),
so it runs inside ``pre_admit`` on the edge's loop; the verified
credential confirms it after auth.

The AdmissionController enforces three per-tenant budgets from one
registry document:

  * **weighted admission shares**: a tenant's in-flight slots are bounded
    by its share of the gate, computed over the *active* tenant set so
    unused capacity is borrowable: a lone tenant still gets the whole
    gate;
  * **request-rate budget**: a token bucket per tenant; an empty bucket
    refuses 503 SlowDown + Retry-After before any body byte;
  * **byte budgets** (rx/tx): admission *peeks* the rx bucket (an
    exhausted budget refuses before the body without double-charging),
    then the handler paces the admitted body and response streams
    through the same buckets. On the port the paced body is the stream
    the PUT loop reads into its pinned staging ring
    (``PacedReader.readinto``), so a paced PUT encodes on the card as any
    other.

Budget docs live in ``QoSRegistry``: epoch-versioned, persisted to every
pool under ``.minio.sys/qos/config.json`` with regfence lineage. The same
doc shape carries per-**tier** budgets the transition worker paces pushes
through (``scope="tier"``).

The plane is **off by default** (``MINIO_TPU_QOS=off``): every probe
returns before touching a lock, and the server answers byte for byte as
one without this module. Per-tenant counters are bounded-cardinality:
the tenant label is drawn from the registered-account set plus three
sentinels ("root", "anonymous", "unknown").
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ..object import api_errors
from ..storage.xl_storage import MINIO_META_BUCKET
from ..utils import atomicfile, crashpoint, eventlog, knobs, regfence, \
    telemetry
from ..utils.bandwidth import PacedReader, TokenBucket

QOS_PREFIX = "qos/"
QOS_CONFIG_OBJECT = QOS_PREFIX + "config.json"

# tenant sentinels: requests that resolve outside the IAM tables
TENANT_ROOT = "root"
TENANT_ANONYMOUS = "anonymous"
TENANT_UNKNOWN = "unknown"

SCOPES = ("tenant", "tier")

# per-tenant accounting (bounded by the registered-account set + the
# three sentinels — the label-cardinality rule's bound argument)
_TENANT_REQS = telemetry.REGISTRY.counter(
    "minio_tpu_qos_tenant_requests_total",
    "Requests observed by the QoS plane, per tenant")
_TENANT_RX = telemetry.REGISTRY.counter(
    "minio_tpu_qos_tenant_rx_bytes_total",
    "Request-body bytes metered through per-tenant budgets")
_TENANT_TX = telemetry.REGISTRY.counter(
    "minio_tpu_qos_tenant_tx_bytes_total",
    "Response-body bytes metered through per-tenant budgets")
_TENANT_SHED = telemetry.REGISTRY.counter(
    "minio_tpu_qos_tenant_shed_total",
    "Requests refused by a tenant budget, per tenant and budget kind")
_TENANT_LAG = telemetry.REGISTRY.counter(
    "minio_tpu_qos_tenant_lag_seconds_total",
    "Seconds tenant streams stalled waiting for byte budget")


class QoSConfigError(api_errors.ObjectApiError):
    """Invalid QoS operation (bad budget spec, unknown scope/name)."""


class Budget:
    """One scope entry ("tenant" or "tier") of the registry doc.
    Zero means *default/unlimited*: ``share=0`` falls back to
    ``MINIO_TPU_QOS_DEFAULT_SHARE``, a zero rate never refuses."""

    __slots__ = ("name", "share", "rps", "rx_bps", "tx_bps")

    def __init__(self, name: str, share: float = 0.0, rps: float = 0.0,
                 rx_bps: float = 0.0, tx_bps: float = 0.0):
        self.name = name
        self.share = float(share)
        self.rps = float(rps)
        self.rx_bps = float(rx_bps)
        self.tx_bps = float(tx_bps)

    def to_dict(self) -> dict:
        return {"name": self.name, "share": self.share, "rps": self.rps,
                "rx_bps": self.rx_bps, "tx_bps": self.tx_bps}

    @classmethod
    def from_dict(cls, d: dict) -> "Budget":
        name = str(d.get("name", "")).strip()
        if not name:
            raise QoSConfigError("budget needs a name")
        try:
            vals = {k: float(d.get(k, 0) or 0)
                    for k in ("share", "rps", "rx_bps", "tx_bps")}
        except (TypeError, ValueError):
            raise QoSConfigError(f"budget {name!r}: rates must be numbers")
        for k, v in vals.items():
            if v < 0:
                raise QoSConfigError(f"budget {name!r}: {k} must be >= 0")
        return cls(name=name, **vals)


class QoSRegistry:
    """The persisted budget registry: two scopes ("tenant", "tier"),
    epoch-versioned and written to EVERY pool with regfence lineage —
    the exact durability rule of the topology/tier/replicate
    registries, so fsck's ``registry_epoch_fork`` coverage applies
    unchanged. Mutations persist BEFORE they take effect and roll back
    when the write quorum is missed."""

    def __init__(self, object_layer=None):
        self.obj = object_layer
        self._mu = threading.Lock()
        self.epoch = 0
        self.updated = time.time()
        self.tenants: dict[str, Budget] = {}
        self.tiers: dict[str, Budget] = {}
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

    def _table(self, scope: str) -> dict[str, Budget]:
        if scope == "tenant":
            return self.tenants
        if scope == "tier":
            return self.tiers
        raise QoSConfigError(f"unknown QoS scope {scope!r} "
                             f"(expected one of {SCOPES})")

    # ------------------------------------------------------------------
    # registry CRUD
    # ------------------------------------------------------------------

    def set_budget(self, scope: str, budget: Budget) -> int:
        """Register or replace one budget; returns the new epoch."""
        with self._mu:
            table = self._table(scope)
            prev = table.get(budget.name)
            table[budget.name] = budget
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:          # roll the in-memory registry back
                if prev is None:
                    table.pop(budget.name, None)
                else:
                    table[budget.name] = prev
            raise
        self._emit_update(epoch)
        return epoch

    def remove_budget(self, scope: str, name: str) -> int:
        with self._mu:
            table = self._table(scope)
            if name not in table:
                raise QoSConfigError(
                    f"no {scope} budget named {name!r}")
            prev = table.pop(name)
            self.epoch += 1
            self.updated = time.time()
            self._advance_lineage()
            epoch = self.epoch
        try:
            self.save()
        except Exception:
            with self._mu:
                table[name] = prev
            raise
        self._emit_update(epoch)
        return epoch

    def get(self, scope: str, name: str) -> Optional[Budget]:
        with self._mu:
            return self._table(scope).get(name)

    def list(self, scope: str) -> list[dict]:
        with self._mu:
            return [b.to_dict() for b in
                    sorted(self._table(scope).values(),
                           key=lambda b: b.name)]

    def _emit_update(self, epoch: int) -> None:
        with self._mu:
            tenants, tiers = len(self.tenants), len(self.tiers)
        eventlog.emit("qos.update", epoch=epoch, tenants=tenants,
                      tiers=tiers)

    # ------------------------------------------------------------------
    # persistence (the topology plane's every-pool, fenced-epoch rule)
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        with self._mu:
            return {"epoch": self.epoch, "updated": self.updated,
                    "tenants": [b.to_dict()
                                for b in self.tenants.values()],
                    "tiers": [b.to_dict() for b in self.tiers.values()],
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
                crashpoint.hit("qos.save.pool")
                z.put_object(MINIO_META_BUCKET, QOS_CONFIG_OBJECT,
                             payload)
                landed += 1
            except Exception as e:  # noqa: BLE001 — per-pool durability
                last = e
        need = regfence.write_quorum(len(pools))
        if landed < need:
            # refusing a minority-side epoch bump (caller rolls back)
            raise QoSConfigError(
                f"qos config epoch {self.epoch} persisted to {landed} "
                f"of {len(pools)} pool(s), need {need}: {last!r}")
        return landed

    def load(self) -> bool:
        """Recover the newest persisted registry (deterministic winner
        across pools); returns True when a doc was found."""
        docs: list[dict] = []
        for z in self._pools():
            try:
                _, stream = z.get_object(MINIO_META_BUCKET,
                                         QOS_CONFIG_OBJECT)
                doc = atomicfile.load_json_doc(b"".join(stream))
            except api_errors.ObjectApiError:
                continue
            if doc is None:     # torn/truncated copy: other pools win
                continue
            docs.append(doc)
        best = regfence.pick_best(docs)
        if best is None:
            return False
        tables: dict[str, dict[str, Budget]] = {"tenants": {},
                                                "tiers": {}}
        for key in tables:
            for d in best.get(key, []):
                try:
                    b = Budget.from_dict(d)
                except QoSConfigError:
                    continue
                tables[key][b.name] = b
        with self._mu:
            self.epoch = int(best.get("epoch", 0))
            self.updated = float(best.get("updated", time.time()))
            self.tenants = tables["tenants"]
            self.tiers = tables["tiers"]
            self.writer = str(best.get("writer", ""))
            self.parent_lineage = str(best.get("parent_lineage", ""))
            self.lineage = str(best.get("lineage", ""))
        return True


class Refusal:
    """One tenant-budget refusal: what the AdmissionController needs to
    shed it (message + Retry-After) plus the accounting facts."""

    __slots__ = ("tenant", "kind", "message", "retry_after")

    def __init__(self, tenant: str, kind: str, message: str,
                 retry_after: int = 1):
        self.tenant = tenant
        self.kind = kind
        self.message = message
        self.retry_after = max(int(retry_after), 1)


def claimed_access_key(headers: dict, query: dict) -> str:
    """The access key a request *claims* (no signature verification):
    enough to pick the budget to charge — a forged claim only ever
    borrows a STRICTER budget and still fails auth afterwards. Header
    names are lower-cased by both frontends (signature.Request
    contract)."""
    auth = headers.get("authorization", "")
    if auth.startswith("AWS4-"):
        i = auth.find("Credential=")
        if i >= 0:
            cred = auth[i + len("Credential="):]
            return cred.split(",", 1)[0].strip().split("/", 1)[0]
        return ""
    if auth.startswith("AWS "):
        return auth[4:].split(":", 1)[0].strip()
    v = query.get("X-Amz-Credential")
    if v:
        return str(v[0]).split("/", 1)[0]
    v = query.get("AWSAccessKeyId")
    if v:
        return str(v[0])
    return ""


class QoSPlane:
    """The live enforcement state the AdmissionController consults.

    Holds the registry, per-tenant token buckets (rebuilt when the
    registry epoch moves), and the in-flight slot ledger behind the
    weighted-share rule. Everything here is pre-body-cheap: the hot
    probes are one dict lookup plus one bucket refill under a lock.
    """

    def __init__(self, registry: Optional[QoSRegistry] = None,
                 iam_lookup=None, root_access_key: str = ""):
        self.registry = registry if registry is not None else QoSRegistry()
        # late-bound: S3ApiHandlers gets its IAMSys after construction
        self._iam_lookup = iam_lookup or (lambda: None)
        self.root_access_key = root_access_key
        self._mu = threading.Lock()
        self._buckets: dict[tuple[str, str], TokenBucket] = {}
        self._gen = -1                     # registry epoch the buckets saw
        self._inflight: dict[str, int] = {}
        self._last_seen: dict[str, float] = {}
        self._shed_emitted: dict[str, float] = {}

    # -- switches --------------------------------------------------------

    @staticmethod
    def enabled() -> bool:
        """Read per request (a knob getter, so tests can flip the env
        mid-process); the default-off path costs one env lookup."""
        return knobs.get_bool("MINIO_TPU_QOS")

    # -- tenant resolution -----------------------------------------------

    def resolve_tenant(self, access_key: str) -> str:
        """Access key -> tenant: root cred -> "root", registered keys
        roll up to their parent account, everything else lands on the
        bounded sentinels."""
        if not access_key:
            return TENANT_ANONYMOUS
        if access_key == self.root_access_key:
            return TENANT_ROOT
        iam = self._iam_lookup()
        if iam is not None:
            account = iam.account_of(access_key)
            if account is not None:
                if account == self.root_access_key:
                    return TENANT_ROOT
                return account
        return TENANT_UNKNOWN

    def tenant_of(self, headers: dict, query: dict) -> str:
        return self.resolve_tenant(claimed_access_key(headers, query))

    def tenant_for_cred(self, cred) -> str:
        """Post-auth confirmation from the VERIFIED credential (same
        value the claimed-key parse produced, derived independently)."""
        if cred is None:
            return TENANT_ANONYMOUS
        if cred.access_key == self.root_access_key:
            return TENANT_ROOT
        account = getattr(cred, "parent_user", "") or cred.access_key
        if account == self.root_access_key:
            return TENANT_ROOT
        return account

    # -- budgets & buckets -----------------------------------------------

    def _budget(self, tenant: str) -> Optional[Budget]:
        return self.registry.get("tenant", tenant)

    def share_of(self, tenant: str) -> float:
        b = self._budget(tenant)
        share = b.share if b is not None and b.share > 0 else \
            knobs.get_float("MINIO_TPU_QOS_DEFAULT_SHARE")
        return max(share, 0.01)

    def _rate_for(self, kind: str, tenant: str) -> float:
        b = self._budget(tenant)
        if kind == "rps":
            rate = b.rps if b is not None else 0.0
            return rate or knobs.get_float("MINIO_TPU_QOS_DEFAULT_RPS")
        if kind == "rx":
            rate = b.rx_bps if b is not None else 0.0
            return rate or knobs.get_float("MINIO_TPU_QOS_DEFAULT_RX_BPS")
        rate = b.tx_bps if b is not None else 0.0
        return rate or knobs.get_float("MINIO_TPU_QOS_DEFAULT_TX_BPS")

    def bucket(self, kind: str, tenant: str) -> TokenBucket:
        """The (kind, tenant) token bucket; the cache is dropped
        whenever the registry epoch moves so budget updates take effect
        on the next request."""
        epoch = self.registry.epoch
        with self._mu:
            if epoch != self._gen:
                self._buckets.clear()
                self._gen = epoch
            b = self._buckets.get((kind, tenant))
            if b is None:
                b = TokenBucket(self._rate_for(kind, tenant))
                self._buckets[(kind, tenant)] = b
            return b

    # -- the admission hooks ---------------------------------------------

    def pre_check(self, method: str, path: str, query: dict,
                  headers: dict) -> Optional[Refusal]:
        """The pre-body budget probe, run once per request from
        ``AdmissionController.pre_admit`` (loop-side on the edge):
        request-rate bucket, then — for requests announcing a body —
        a *peek* of the rx byte bucket. Returns a Refusal or None; no
        body byte has been read either way."""
        if not self.enabled():
            return None
        tenant = self.tenant_of(headers, query)
        _TENANT_REQS.inc(tenant=tenant)
        wait = self.bucket("rps", tenant).try_take(1)
        if wait > 0:
            return self._refuse(tenant, "rate", wait)
        if method in ("PUT", "POST"):
            try:
                length = int(headers.get("content-length", "") or 0)
            except (TypeError, ValueError):
                length = 0
            if length > 0:
                wait = self.bucket("rx", tenant).peek(length)
                if wait > 0:
                    return self._refuse(tenant, "bytes", wait)
        return None

    def admit_slot(self, method: str, path: str, query: dict,
                   headers: dict, capacity: int):
        """The weighted-share gate, run from ``admit`` on every
        request: returns the tenant name (the ticket parks it for
        release/pacing; "" when the plane is off) or a Refusal when
        the tenant is at its bound.

        The bound: each *active* tenant (in flight now, or seen within
        the activity window) is guaranteed ``capacity × share/Σ active
        shares`` slots, floored at 1; whatever the guarantees leave
        unclaimed is borrowable by anyone — a lone tenant's bound is
        the whole gate."""
        if not self.enabled():
            return ""
        tenant = self.tenant_of(headers, query)
        now = time.monotonic()
        horizon = now - knobs.get_float("MINIO_TPU_QOS_ACTIVE_S")
        with self._mu:
            for t in [t for t, seen in self._last_seen.items()
                      if seen < horizon and not self._inflight.get(t)]:
                self._last_seen.pop(t, None)
                self._inflight.pop(t, None)
            self._last_seen[tenant] = now
            active = set(self._last_seen)
            active.add(tenant)
        shares = {t: self.share_of(t) for t in active}
        total_share = sum(shares.values())
        with self._mu:
            guaranteed = {
                t: max(1, int(capacity * shares[t] / total_share))
                for t in active}
            loose = max(0, capacity - sum(guaranteed.values()))
            bound = guaranteed[tenant] + loose
            mine = self._inflight.get(tenant, 0)
            if mine >= bound:
                pass                      # refuse below, outside _mu
            else:
                self._inflight[tenant] = mine + 1
                return tenant
        return self._refuse(tenant, "share",
                            1.0, f"tenant {tenant} is at its admission "
                            "share, retry the request")

    def release(self, tenant: str) -> None:
        if not tenant:
            return
        with self._mu:
            n = self._inflight.get(tenant, 0)
            if n > 1:
                self._inflight[tenant] = n - 1
            else:
                self._inflight.pop(tenant, None)
            self._last_seen[tenant] = time.monotonic()

    def _refuse(self, tenant: str, kind: str, wait: float,
                message: str = "") -> Refusal:
        _TENANT_SHED.inc(tenant=tenant, kind=kind)
        self._note_shed(tenant, kind)
        retry = max(1, int(-(-wait // 1)))
        return Refusal(
            tenant, kind,
            message or f"tenant {tenant} is over its {kind} budget, "
            "retry the request", retry)

    def _note_shed(self, tenant: str, kind: str) -> None:
        """First shed per tenant per window lands in the event journal
        (debounced — budget refusals under sustained overload would
        otherwise flood the ring at the request rate)."""
        now = time.monotonic()
        window = knobs.get_float("MINIO_TPU_QOS_SHED_WINDOW_S")
        with self._mu:
            last = self._shed_emitted.get(tenant, 0.0)
            if now - last < window:
                return
            self._shed_emitted[tenant] = now
        eventlog.emit("tenant.shed", tenant=tenant, reason=kind)

    # -- data-path pacing --------------------------------------------------

    def paced_body(self, tenant: str, body):
        """Wrap an admitted request-body reader: bytes pace through the
        tenant's rx bucket and land in the rx/lag counters."""
        return PacedReader(
            body, self.bucket("rx", tenant),
            on_bytes=lambda n: _TENANT_RX.inc(n, tenant=tenant),
            on_wait=lambda s: _TENANT_LAG.inc(s, tenant=tenant))

    def paced_stream(self, tenant: str, stream):
        """Wrap a response chunk iterator through the tx bucket."""
        return self.bucket("tx", tenant).paced(
            stream,
            on_bytes=lambda n: _TENANT_TX.inc(n, tenant=tenant),
            on_wait=lambda s: _TENANT_LAG.inc(s, tenant=tenant))

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Per-tenant live + cumulative view for the admin surface."""
        with self._mu:
            tenants = set(self._inflight) | set(self._last_seen)
            inflight = dict(self._inflight)
        tenants.update(b["name"] for b in self.registry.list("tenant"))
        out = {}
        for t in sorted(tenants):
            sheds = sum(v for key, v in _TENANT_SHED.series().items()
                        if dict(key).get("tenant") == t)
            out[t] = {
                "inflight": inflight.get(t, 0),
                "share": self.share_of(t),
                "requests": _TENANT_REQS.value(tenant=t),
                "rx_bytes": _TENANT_RX.value(tenant=t),
                "tx_bytes": _TENANT_TX.value(tenant=t),
                "shed": sheds,
                "lag_s": round(_TENANT_LAG.value(tenant=t), 3),
            }
        return out
