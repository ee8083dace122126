"""IAM / bucket policy documents and evaluation.

A copy of minio_tpu/iam/policy.py (host only, standard library only).

The reference's pkg/iam/policy + pkg/bucket/policy: JSON policy documents
(Version, Statement[] of Effect/Action/Resource/Principal/Condition)
evaluated per request. Explicit Deny always wins; otherwise any matching
Allow grants; default is deny.

Wildcards: Action and Resource support '*' and '?' globs exactly like the
reference's pkg/wildcard. Conditions implement the operators the S3
dialect actually exercises (StringEquals / StringNotEquals / StringLike /
StringNotLike / IpAddress / NotIpAddress with real CIDR containment); an
unknown operator or key makes the condition false (deny-safe, matching
AWS semantics for unresolvable conditions).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import ipaddress
import json
from typing import Optional


def _wild_match(pattern: str, s: str) -> bool:
    """'*'/'?' glob (reference pkg/wildcard.MatchSimple)."""
    if pattern == "*":
        return True
    # fnmatch also honors [] classes; neutralize them to literal chars
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(s, pattern)


def _ip_in_cidr(have: str, want: str) -> bool:
    """CIDR containment (reference pkg/policy/condition ipaddress.go).
    Malformed addresses or networks never match (deny-safe)."""
    try:
        return ipaddress.ip_address(have.strip()) in \
            ipaddress.ip_network(want.strip(), strict=False)
    except ValueError:
        return False


def _to_num(s: str):
    try:
        return float(s)
    except ValueError:
        return None


def _to_date(s: str):
    """ISO 8601 (with Z or offset) or epoch seconds -> unix ts."""
    s = s.strip()
    n = _to_num(s)
    if n is not None:
        return n
    import datetime as _dt
    try:
        return _dt.datetime.fromisoformat(
            s.replace("Z", "+00:00")).timestamp()
    except ValueError:
        return None


_CMP = {"Equals": lambda a, b: a == b,
        "LessThan": lambda a, b: a < b,
        "LessThanEquals": lambda a, b: a <= b,
        "GreaterThan": lambda a, b: a > b,
        "GreaterThanEquals": lambda a, b: a >= b}


def _op_hit(base: str, vals: list[str], have: str):
    """One positive condition operator over one context value: True /
    False on a known operator, None when the operator is unknown
    (deny-safe at the caller)."""
    if base == "StringEquals":
        return have in vals
    if base == "StringEqualsIgnoreCase":
        return have.lower() in [v.lower() for v in vals]
    if base == "StringLike":
        return any(_wild_match(v, have) for v in vals)
    if base == "IpAddress":
        return any(_ip_in_cidr(have, v) for v in vals)
    if base == "Bool":
        return have.lower() in [v.lower() for v in vals]
    for family, conv in (("Numeric", _to_num), ("Date", _to_date)):
        if base.startswith(family):
            cmp = _CMP.get(base[len(family):])
            if cmp is None:
                return None
            h = conv(have)
            if h is None:
                return False                   # unparsable: never match
            return any(cmp(h, w) for w in
                       (conv(v) for v in vals) if w is not None)
    return None


@dataclasses.dataclass
class PolicyArgs:
    """One authorization query (reference policy.Args)."""
    account: str = ""             # access key of the caller
    action: str = ""              # e.g. "s3:GetObject"
    bucket: str = ""
    object: str = ""
    is_owner: bool = False
    conditions: dict = dataclasses.field(default_factory=dict)

    @property
    def resource(self) -> str:
        if self.object:
            return f"{self.bucket}/{self.object}"
        return self.bucket


class Statement:
    def __init__(self, effect: str, actions: list[str],
                 resources: list[str],
                 principals: Optional[list[str]] = None,
                 conditions: Optional[dict] = None, sid: str = ""):
        if effect not in ("Allow", "Deny"):
            raise ValueError(f"invalid Effect {effect!r}")
        self.sid = sid
        self.effect = effect
        self.actions = actions
        self.resources = resources
        self.principals = principals          # None = identity policy
        self.conditions = conditions or {}

    # -- matching ----------------------------------------------------------

    def _action_matches(self, action: str) -> bool:
        return any(_wild_match(a, action) for a in self.actions)

    def _resource_matches(self, resource: str) -> bool:
        for r in self.resources:
            pat = r
            for prefix in ("arn:aws:s3:::",):
                if pat.startswith(prefix):
                    pat = pat[len(prefix):]
            if _wild_match(pat, resource):
                return True
        return False

    def _principal_matches(self, account: str) -> bool:
        if self.principals is None:
            return True                        # identity policy: implicit
        return any(_wild_match(p, account) for p in self.principals)

    def _conditions_match(self, ctx: dict) -> bool:
        # AWS/reference operator matrix (pkg/policy/condition): String*,
        # Numeric*, Date*, Bool, IpAddress, Null, with Not- and
        # IfExists- modifiers. A NEGATED operator evaluates true when
        # the condition key is absent from the request context; a
        # positive operator evaluates false (unless IfExists). Unknown
        # operators are false — safe because a non-applying Deny is "no
        # opinion", same as the reference's unresolvable conditions.
        for op, kv in self.conditions.items():
            if op == "Null":
                for key, want in kv.items():
                    vals = want if isinstance(want, list) else [want]
                    want_null = str(vals[0]).lower() in ("true", "1")
                    if (ctx.get(key) is None) != want_null:
                        return False
                continue
            base = op
            if_exists = base.endswith("IfExists")
            if if_exists:
                base = base[:-len("IfExists")]
            neg = "Not" in base
            base = base.replace("Not", "", 1)
            for key, want in kv.items():
                vals = [str(v) for v in
                        (want if isinstance(want, list) else [want])]
                have = ctx.get(key)
                if have is None:
                    if neg or if_exists:
                        continue
                    return False
                hit = _op_hit(base, vals, str(have))
                if hit is None:
                    return False               # unknown operator
                if hit == neg:
                    return False
        return True

    def applies(self, args: PolicyArgs) -> bool:
        return (self._action_matches(args.action)
                and self._resource_matches(args.resource)
                and self._principal_matches(args.account)
                and self._conditions_match(args.conditions))

    # -- (de)serialization -------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "Statement":
        def aslist(v):
            if v is None:
                return []
            return v if isinstance(v, list) else [v]

        principals = None
        if "Principal" in d:
            p = d["Principal"]
            if isinstance(p, dict):
                principals = aslist(p.get("AWS", []))
            else:
                principals = aslist(p)
            principals = [x.replace("arn:aws:iam::", "").replace(
                ":root", "") for x in principals]
        return cls(effect=d.get("Effect", ""),
                   actions=aslist(d.get("Action")),
                   resources=aslist(d.get("Resource")),
                   principals=principals,
                   conditions=d.get("Condition"),
                   sid=d.get("Sid", ""))

    def to_dict(self) -> dict:
        out: dict = {"Effect": self.effect, "Action": self.actions,
                     "Resource": self.resources}
        if self.sid:
            out["Sid"] = self.sid
        if self.principals is not None:
            out["Principal"] = {"AWS": self.principals}
        if self.conditions:
            out["Condition"] = self.conditions
        return out


class Policy:
    def __init__(self, statements: list[Statement],
                 version: str = "2012-10-17"):
        self.version = version
        self.statements = statements

    def is_allowed(self, args: PolicyArgs) -> bool:
        allowed = False
        for st in self.statements:
            if not st.applies(args):
                continue
            if st.effect == "Deny":
                return False                   # explicit deny wins
            allowed = True
        return allowed

    def is_empty(self) -> bool:
        return not self.statements

    @classmethod
    def from_json(cls, raw: str | bytes) -> "Policy":
        d = json.loads(raw)
        sts = [Statement.from_dict(s) for s in d.get("Statement", [])]
        return cls(sts, version=d.get("Version", "2012-10-17"))

    def to_json(self) -> str:
        return json.dumps({
            "Version": self.version,
            "Statement": [s.to_dict() for s in self.statements]})


# -- canned policies (reference pkg/iam/policy/{admin,readonly,...}.go) ----

def _canned(effect: str, actions: list[str]) -> Policy:
    return Policy([Statement(effect, actions, ["*"])])


CANNED_POLICIES: dict[str, Policy] = {
    "readonly": _canned("Allow", ["s3:GetBucketLocation", "s3:GetObject",
                                  "s3:GetObjectVersion",
                                  "s3:ListAllMyBuckets", "s3:ListBucket"]),
    "writeonly": _canned("Allow", ["s3:PutObject",
                                   "s3:ListBucketMultipartUploads",
                                   "s3:AbortMultipartUpload",
                                   "s3:ListMultipartUploadParts"]),
    "readwrite": _canned("Allow", ["s3:*"]),
    "consoleAdmin": _canned("Allow", ["s3:*", "admin:*", "sts:*"]),
    "diagnostics": _canned("Allow", ["admin:ServerInfo", "admin:Profiling",
                                     "admin:TopLocksInfo",
                                     "admin:OBDInfo"]),
}
