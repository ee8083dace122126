"""Object lock (WORM): retention and legal hold parsing and enforcement.

Counterpart of minio_tpu/features/objectlock.py, ported whole. Per-object
lock state lives in metadata headers and is enforced on deletion (the
reference's pkg/bucket/object/lock and cmd/bucket-object-lock.go
enforceRetentionForDeletion): a version under COMPLIANCE retention or
legal hold cannot be deleted; GOVERNANCE retention can be bypassed with
x-amz-bypass-governance-retention by a caller holding
s3:BypassGovernanceRetention.
"""

from __future__ import annotations

import datetime as _dt
import time
import xml.etree.ElementTree as ET
from typing import Optional

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"

# stored as (real S3) object metadata headers
MD_MODE = "x-amz-object-lock-mode"
MD_RETAIN = "x-amz-object-lock-retain-until-date"
MD_HOLD = "x-amz-object-lock-legal-hold"


def _find(el, tag):
    r = el.find(tag)
    if r is None:
        r = el.find(_NS + tag)
    return r


def _text(el, tag, default=""):
    r = _find(el, tag)
    return (r.text or "").strip() if r is not None else default


def parse_iso(ts: str) -> float:
    return _dt.datetime.fromisoformat(
        ts.replace("Z", "+00:00")).timestamp()


def iso(ts: float) -> str:
    return _dt.datetime.fromtimestamp(ts, _dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


class DefaultRetention:
    """Bucket-level default applied to new objects
    (<ObjectLockConfiguration><Rule><DefaultRetention>...)."""

    def __init__(self, mode: str = "", days: int = 0, years: int = 0):
        self.mode = mode
        self.days = days
        self.years = years

    @classmethod
    def from_config_xml(cls, raw: str) -> "DefaultRetention":
        try:
            root = ET.fromstring(raw)
        except ET.ParseError:
            return cls()
        rule = _find(root, "Rule")
        if rule is None:
            return cls()
        dr = _find(rule, "DefaultRetention")
        if dr is None:
            return cls()
        return cls(mode=_text(dr, "Mode"),
                   days=int(_text(dr, "Days") or 0),
                   years=int(_text(dr, "Years") or 0))

    def apply_to(self, metadata: dict, now: Optional[float] = None
                 ) -> None:
        if not self.mode:
            return
        now = now if now is not None else time.time()
        until = now + self.days * 86400 + self.years * 365 * 86400
        metadata.setdefault(MD_MODE, self.mode)
        metadata.setdefault(MD_RETAIN, iso(until))


def retention_headers_from_request(header, metadata: dict) -> None:
    """Copy x-amz-object-lock-* request headers into object metadata
    (PUT path)."""
    mode = header(MD_MODE)
    until = header(MD_RETAIN)
    hold = header(MD_HOLD)
    if mode:
        if mode not in ("GOVERNANCE", "COMPLIANCE"):
            from ..s3.s3errors import S3Error
            raise S3Error("InvalidArgument", "bad object lock mode")
        if not until:
            from ..s3.s3errors import S3Error
            raise S3Error("InvalidArgument",
                          "retain-until-date required with mode")
        metadata[MD_MODE] = mode
        metadata[MD_RETAIN] = until
    if hold:
        if hold not in ("ON", "OFF"):
            from ..s3.s3errors import S3Error
            raise S3Error("InvalidArgument", "bad legal hold")
        metadata[MD_HOLD] = hold


def check_deletable(user_defined: dict, bypass_governance: bool,
                    now: Optional[float] = None) -> Optional[str]:
    """None when deletable; else the reason (maps to ObjectLocked)."""
    now = now if now is not None else time.time()
    if user_defined.get(MD_HOLD, "").upper() == "ON":
        return "object is under legal hold"
    mode = user_defined.get(MD_MODE, "").upper()
    until_raw = user_defined.get(MD_RETAIN, "")
    if not mode or not until_raw:
        return None
    try:
        until = parse_iso(until_raw)
    except ValueError:
        # Corrupt/unparsable retain-until date on a locked object: fail
        # closed — treat retention as still active rather than deletable.
        until = None
    if until is not None and now >= until:
        return None
    if mode == "COMPLIANCE":
        return "object is under COMPLIANCE retention"
    if mode == "GOVERNANCE" and not bypass_governance:
        return "object is under GOVERNANCE retention"
    return None


def check_retention_update(user_defined: dict, new_mode: str,
                           new_until: str, bypass_governance: bool,
                           now: Optional[float] = None) -> Optional[str]:
    """None when the retention change is allowed; else the reason.

    Mirrors PutObjectRetentionHandler (cmd/object-handlers.go):
    - active COMPLIANCE retention can only be extended, never have its
      mode changed or date reduced;
    - weakening active GOVERNANCE retention (mode change away from a
      stricter setting or date reduction) requires the governance-bypass
      header plus s3:BypassGovernanceRetention (bypass_governance=True).
    Tightening is always allowed.
    """
    now = now if now is not None else time.time()
    cur_mode = user_defined.get(MD_MODE, "").upper()
    cur_raw = user_defined.get(MD_RETAIN, "")
    if not cur_mode or not cur_raw:
        return None
    try:
        cur_until = parse_iso(cur_raw)
    except ValueError:
        cur_until = None                  # corrupt date: fail closed below
    if cur_until is not None and now >= cur_until:
        return None                       # retention expired: free change
    try:
        new_ts = parse_iso(new_until)
    except ValueError:
        return "bad retain-until date"
    if cur_mode == "COMPLIANCE":
        if new_mode != "COMPLIANCE":
            return "cannot change mode while COMPLIANCE retention is active"
        if cur_until is None or new_ts < cur_until:
            return "cannot shorten COMPLIANCE retention"
        return None
    # active GOVERNANCE: shortening the date (or an unreadable stored
    # date, where extension cannot be proven) needs the bypass grant
    if cur_until is None or new_ts < cur_until:
        if not bypass_governance:
            return ("cannot weaken GOVERNANCE retention without "
                    "x-amz-bypass-governance-retention")
    return None


# -- ?retention / ?legal-hold subresource XML -------------------------------

def retention_xml(user_defined: dict) -> str:
    mode = user_defined.get(MD_MODE, "")
    until = user_defined.get(MD_RETAIN, "")
    if not mode:
        return ""
    return (f"<Retention><Mode>{mode}</Mode>"
            f"<RetainUntilDate>{until}</RetainUntilDate></Retention>")


def parse_retention_xml(raw: bytes) -> tuple[str, str]:
    root = ET.fromstring(raw)
    return _text(root, "Mode"), _text(root, "RetainUntilDate")


def legal_hold_xml(user_defined: dict) -> str:
    status = user_defined.get(MD_HOLD, "OFF")
    return f"<LegalHold><Status>{status}</Status></LegalHold>"


def parse_legal_hold_xml(raw: bytes) -> str:
    return _text(ET.fromstring(raw), "Status")
