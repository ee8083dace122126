"""Bucket lifecycle (ILM) rules + enforcement.

Counterpart of minio_tpu/features/lifecycle.py. The reference parses
lifecycle XML in pkg/bucket/lifecycle and enforces it from the data
crawler (applyActions, cmd/data-crawler.go:629-713): each crawled object
is checked against the bucket's rules and expired (deleted or
delete-markered) when eligible.

Supported rule surface: Status, Filter/Prefix (+And/Tag ignored-match),
Expiration{Days|Date}, NoncurrentVersionExpiration{NoncurrentDays},
AbortIncompleteMultipartUpload{DaysAfterInitiation},
Transition{Days|Date,StorageClass},
NoncurrentVersionTransition{NoncurrentDays,StorageClass}.

Transition rules name a remote TIER via StorageClass (the reference's
ILM tiering, pkg/bucket/lifecycle/transition.go): the crawler's tier
actions (tier/transition.py) act on them, and expiry always wins over
transition when both are due. With a tier manager (``tiers=``), the
expiry actions here also free a transitioned version's remote copy.
``crawler_action`` sends its s3:ObjectRemoved:Lifecycle event to the
``notifier`` the caller passes; the boot passes its legacy event
notifier (features/events.EventNotifier), as in the reference.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import time
import xml.etree.ElementTree as ET
from typing import Optional

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _find(el, tag):
    r = el.find(tag)
    if r is None:
        r = el.find(_NS + tag)
    return r


def _findall(el, tag):
    return list(el.findall(tag)) + list(el.findall(_NS + tag))


def _text(el, tag, default=""):
    r = _find(el, tag)
    return (r.text or "").strip() if r is not None else default


@dataclasses.dataclass
class Rule:
    rule_id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    expiry_days: int = 0
    expiry_date: float = 0.0          # unix seconds; 0 = unset
    noncurrent_days: int = 0
    abort_mpu_days: int = 0
    # ILM tiering: move data to the tier named by StorageClass
    transition_days: int = 0
    transition_date: float = 0.0      # unix seconds; 0 = unset
    transition_tier: str = ""
    noncurrent_transition_days: int = 0
    noncurrent_transition_tier: str = ""

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"


# parsed-config memo for the crawler hot loop: several actions
# (expiry, transition, noncurrent sweeps) each re-parse the SAME
# bucket XML once per crawled object otherwise. Keyed by the raw
# document; bounded by wholesale reset (configs are tiny and few).
_PARSE_CACHE: dict[str, "Lifecycle"] = {}


class Lifecycle:
    def __init__(self, rules: list[Rule]):
        self.rules = rules

    @classmethod
    def cached(cls, raw: str | bytes) -> "Lifecycle":
        """from_xml through the memo — the crawler-action entry point
        (parse errors are never cached and re-raise every call)."""
        key = raw.decode("utf-8", "replace") \
            if isinstance(raw, (bytes, bytearray)) else raw
        lc = _PARSE_CACHE.get(key)
        if lc is None:
            lc = cls.from_xml(raw)
            if len(_PARSE_CACHE) >= 64:
                _PARSE_CACHE.clear()
            _PARSE_CACHE[key] = lc
        return lc

    @classmethod
    def from_xml(cls, raw: str | bytes) -> "Lifecycle":
        root = ET.fromstring(raw)
        rules = []
        for rel in _findall(root, "Rule"):
            r = Rule(rule_id=_text(rel, "ID"),
                     status=_text(rel, "Status", "Enabled"))
            fel = _find(rel, "Filter")
            if fel is not None:
                r.prefix = _text(fel, "Prefix")
                andel = _find(fel, "And")
                if andel is not None and not r.prefix:
                    r.prefix = _text(andel, "Prefix")
            else:
                r.prefix = _text(rel, "Prefix")
            eel = _find(rel, "Expiration")
            if eel is not None:
                days = _text(eel, "Days")
                if days:
                    r.expiry_days = int(days)
                date = _text(eel, "Date")
                if date:
                    r.expiry_date = _dt.datetime.fromisoformat(
                        date.replace("Z", "+00:00")).timestamp()
            nel = _find(rel, "NoncurrentVersionExpiration")
            if nel is not None:
                nd = _text(nel, "NoncurrentDays")
                if nd:
                    r.noncurrent_days = int(nd)
            tel = _find(rel, "Transition")
            if tel is not None:
                days = _text(tel, "Days")
                if days:
                    r.transition_days = int(days)
                date = _text(tel, "Date")
                if date:
                    r.transition_date = _dt.datetime.fromisoformat(
                        date.replace("Z", "+00:00")).timestamp()
                r.transition_tier = _text(tel, "StorageClass")
            ntel = _find(rel, "NoncurrentVersionTransition")
            if ntel is not None:
                nd = _text(ntel, "NoncurrentDays")
                if nd:
                    r.noncurrent_transition_days = int(nd)
                r.noncurrent_transition_tier = _text(ntel, "StorageClass")
            ael = _find(rel, "AbortIncompleteMultipartUpload")
            if ael is not None:
                ad = _text(ael, "DaysAfterInitiation")
                if ad:
                    r.abort_mpu_days = int(ad)
            rules.append(r)
        return cls(rules)

    # -- evaluation --------------------------------------------------------

    def is_expired(self, object_name: str, mod_time: float,
                   now: Optional[float] = None) -> bool:
        """Current-version expiry check (ComputeAction -> DeleteAction)."""
        now = now if now is not None else time.time()
        for r in self.rules:
            if not r.enabled or not object_name.startswith(r.prefix):
                continue
            if r.expiry_date and now >= r.expiry_date:
                return True
            if r.expiry_days and now >= mod_time + r.expiry_days * 86400:
                return True
        return False

    def mpu_abort_before(self, object_name: str,
                         now: Optional[float] = None) -> Optional[float]:
        """Cutoff initiation time for aborting incomplete multipart
        uploads under this prefix, or None."""
        now = now if now is not None else time.time()
        cutoffs = [now - r.abort_mpu_days * 86400 for r in self.rules
                   if r.enabled and r.abort_mpu_days
                   and object_name.startswith(r.prefix)]
        return max(cutoffs) if cutoffs else None

    def noncurrent_expiry_days(self, object_name: str) -> int:
        """Strictest NoncurrentDays applying to this key, or 0."""
        days = [r.noncurrent_days for r in self.rules
                if r.enabled and r.noncurrent_days
                and object_name.startswith(r.prefix)]
        return min(days) if days else 0

    def transition_due(self, object_name: str, mod_time: float,
                       now: Optional[float] = None) -> str:
        """Tier name the current version should transition to NOW, or
        "". Expiry wins over transition (reference ComputeAction:
        uploading data the same pass deletes is pure waste), and a rule
        needs a StorageClass (tier name) to be actionable."""
        now = now if now is not None else time.time()
        if self.is_expired(object_name, mod_time, now):
            return ""
        for r in self.rules:
            if not r.enabled or not r.transition_tier \
                    or not object_name.startswith(r.prefix):
                continue
            if r.transition_date and now >= r.transition_date:
                return r.transition_tier
            if r.transition_days and \
                    now >= mod_time + r.transition_days * 86400:
                return r.transition_tier
        return ""

    def noncurrent_transition(self, object_name: str) -> tuple[int, str]:
        """(strictest NoncurrentDays, tier) of the
        NoncurrentVersionTransition rules applying to this key, or
        (0, "")."""
        best: tuple[int, str] = (0, "")
        for r in self.rules:
            if not r.enabled or not r.noncurrent_transition_days \
                    or not r.noncurrent_transition_tier \
                    or not object_name.startswith(r.prefix):
                continue
            if not best[0] or r.noncurrent_transition_days < best[0]:
                best = (r.noncurrent_transition_days,
                        r.noncurrent_transition_tier)
        return best


def crawler_action(bucket_meta_sys, object_layer, notifier=None,
                   now_fn=time.time, tiers=None):
    """DataUsageCrawler per-object action enforcing lifecycle expiry
    (cmd/data-crawler.go:629-713): current-version Expiration (delete or
    delete-marker when versioned). NoncurrentVersionExpiration is the
    per-bucket noncurrent_sweep_action's. With a tier manager, an
    unversioned expiry of a transitioned version also frees its remote
    copy (best-effort: a tier outage must not block expiry).

    A departure from the reference: the crawler's ObjectInfo comes from
    the namespace feed, which may lag the drives, so the object is
    re-stated and its expiry decided again on the fresh mod time before
    the delete. An overwrite acknowledged after the feed read is kept;
    one that lands between the re-stat and the delete is not (the
    delete takes no precondition)."""

    def act(bucket: str, oi) -> None:
        from ..object import api_errors
        bm = bucket_meta_sys.get(bucket)
        if not bm.lifecycle_xml:
            return
        try:
            lc = Lifecycle.cached(bm.lifecycle_xml)
        except ET.ParseError:
            return
        now = now_fn()
        if lc.is_expired(oi.name, oi.mod_time, now):
            versioned = bm.versioning_enabled()
            try:
                fresh = object_layer.get_object_info(bucket, oi.name)
                if fresh.delete_marker or \
                        not lc.is_expired(oi.name, fresh.mod_time, now):
                    return
                object_layer.delete_object(
                    bucket, oi.name, versioned=versioned)
            except api_errors.ObjectApiError:
                return
            if tiers is not None and not versioned:
                # the data version is gone (not a marker write): its
                # remote tier copy goes too
                from ..tier.transition import free_remote
                free_remote(tiers, fresh.user_defined or {})
            if notifier is not None:
                try:
                    notifier.send("s3:ObjectRemoved:Lifecycle", bucket,
                                  oi.name)
                except Exception:  # noqa: BLE001 — best-effort
                    pass

    return act


def noncurrent_sweep_action(bucket_meta_sys, object_layer,
                            now_fn=time.time, tiers=None):
    """Per-bucket crawler action enforcing NoncurrentVersionExpiration
    over a paginated bucket-wide version walk.

    Runs per BUCKET (not per listed object) so keys whose latest version
    is a delete marker — invisible to object listings — still get their
    noncurrent versions expired. A version's clock starts when it BECAME
    noncurrent (its successor's mod time, S3 semantics), and the null
    version (empty version id, written before versioning) expires like
    any other noncurrent version.

    With a tier manager, expiring a transitioned noncurrent version also
    frees its remote copy: in a versioned bucket this sweep is the main
    deletion path of tiered data (current-version expiry only lays
    markers).
    """

    def act(bucket: str) -> None:
        from ..object import api_errors
        bm = bucket_meta_sys.get(bucket)
        if not bm.lifecycle_xml:
            return
        try:
            lc = Lifecycle.cached(bm.lifecycle_xml)
        except ET.ParseError:
            return
        if not any(r.enabled and r.noncurrent_days for r in lc.rules):
            return
        now = now_fn()

        def expire_group(name: str, vs: list) -> None:
            days = lc.noncurrent_expiry_days(name)
            if not days:
                return
            vs = sorted(vs, key=lambda v: -v.mod_time)
            for i in range(1, len(vs)):         # index 0 = current
                became_noncurrent = vs[i - 1].mod_time
                if became_noncurrent < now - days * 86400:
                    try:
                        object_layer.delete_object(
                            bucket, name, version_id=vs[i].version_id)
                    except api_errors.ObjectApiError:
                        continue
                    if tiers is not None:
                        from ..tier.transition import free_remote
                        free_remote(tiers, vs[i].user_defined or {})

        for name, vs in iter_version_groups(object_layer, bucket,
                                            consumer="lifecycle"):
            expire_group(name, vs)

    return act


def iter_version_groups(object_layer, bucket: str,
                        consumer: str = "scanner"):
    """Yield (name, versions) groups of one bucket's whole version
    history — the shared walk of every version-driven scanner
    (noncurrent expiry/transition sweeps).

    Prefers the metacache namespace feed (no walk: the index already
    holds each name's quorum-merged version list); falls back to
    paging `list_object_versions` with the key/version-id markers,
    carrying a page-cut group across pages so a name's versions are
    always seen TOGETHER (a group split across pages would mis-clock
    which version is current)."""
    from ..object import api_errors
    mc = getattr(object_layer, "metacache", None)
    feed = mc.namespace_feed(bucket, versions=True, consumer=consumer) \
        if mc is not None else None
    if feed is not None:
        yield from feed
        return
    from ..object.metacache import walks_counter
    walks_counter().inc(consumer=consumer, source="merge")
    marker = vid_marker = ""
    carry_name: Optional[str] = None
    carry: list = []
    while True:
        try:
            versions, _pfx, nkm, nvm, trunc = \
                object_layer.list_object_versions(
                    bucket, "", marker, 1000, vid_marker)
        except api_errors.ObjectApiError:
            return
        for v in versions:
            if carry_name is not None and v.name != carry_name:
                yield carry_name, carry
                carry = []
            carry_name = v.name
            carry.append(v)
        if not trunc:
            break
        marker, vid_marker = nkm, nvm
    if carry_name is not None and carry:
        yield carry_name, carry


def mpu_abort_action(bucket_meta_sys, object_layer, now_fn=time.time):
    """Per-bucket crawler action aborting incomplete multipart uploads
    past their AbortIncompleteMultipartUpload cutoff
    (cmd/data-crawler applyActions' multipart sweep)."""

    def act(bucket: str) -> None:
        from ..object import api_errors
        bm = bucket_meta_sys.get(bucket)
        if not bm.lifecycle_xml:
            return
        try:
            lc = Lifecycle.cached(bm.lifecycle_xml)
        except ET.ParseError:
            return
        if not any(r.enabled and r.abort_mpu_days for r in lc.rules):
            return
        try:
            uploads = object_layer.list_multipart_uploads(bucket)
        except api_errors.ObjectApiError:
            return
        now = now_fn()
        for up in uploads:
            cutoff = lc.mpu_abort_before(up["object"], now)
            if cutoff is None or up.get("initiated", 0.0) >= cutoff:
                continue
            try:
                object_layer.abort_multipart_upload(
                    bucket, up["object"], up["upload_id"])
            except api_errors.ObjectApiError:
                pass

    return act
