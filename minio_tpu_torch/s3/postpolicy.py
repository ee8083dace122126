"""POST policy form upload (browser uploads).

Counterpart of minio_tpu/s3/postpolicy.py, ported whole (the reference's
cmd/postpolicyform.go and PostPolicyBucketHandler): a multipart/form-data
POST to the bucket URL carrying a base64 policy document, a V4 signature
over that policy, form fields, and the file. Conditions supported: exact
["eq", "$field", v], ["starts-with", "$field", prefix], and
["content-length-range", lo, hi].
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import hmac
import json
import re
from typing import Optional

from .s3errors import S3Error


def parse_multipart_form(body: bytes, content_type: str
                         ) -> tuple[dict[str, str], bytes, str]:
    """-> (fields, file_bytes, file_name). Minimal RFC 7578 parser."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise S3Error("MalformedPOSTRequest", "missing boundary")
    boundary = b"--" + m.group(1).encode()
    fields: dict[str, str] = {}
    file_bytes = b""
    file_name = ""
    parts = body.split(boundary)
    for part in parts:
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        disp = ""
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition:"):
                disp = line.decode(errors="replace")
        nm = re.search(r'name="([^"]*)"', disp)
        if not nm:
            continue
        name = nm.group(1)
        if name == "file":
            fn = re.search(r'filename="([^"]*)"', disp)
            file_name = fn.group(1) if fn else ""
            file_bytes = payload
        else:
            fields[name] = payload.decode(errors="replace")
    return fields, file_bytes, file_name


def check_post_policy(policy_b64: str, fields: dict[str, str],
                      file_size: int) -> None:
    """Validate form fields against the decoded policy conditions
    (cmd/postpolicyform.go checkPostPolicy)."""
    try:
        doc = json.loads(base64.b64decode(policy_b64))
    except (ValueError, TypeError):
        raise S3Error("MalformedPOSTRequest", "bad policy") from None
    exp = doc.get("expiration")
    if not exp:
        # A policy without an expiration would be replayable forever.
        raise S3Error("MalformedPOSTRequest", "missing expiration")
    try:
        when = _dt.datetime.fromisoformat(exp.replace("Z", "+00:00"))
    except (ValueError, TypeError):
        raise S3Error("MalformedPOSTRequest", "bad expiration") \
            from None
    if when.tzinfo is None:          # no offset given: treat as UTC
        when = when.replace(tzinfo=_dt.timezone.utc)
    if when < _dt.datetime.now(_dt.timezone.utc):
        raise S3Error("AccessDenied", "policy expired")
    lower = {k.lower(): v for k, v in fields.items()}
    for cond in doc.get("conditions", []):
        if isinstance(cond, dict):
            for k, v in cond.items():
                have = lower.get(k.lower(), "")
                if have != v:
                    raise S3Error("AccessDenied",
                                  f"policy condition failed: {k}")
        elif isinstance(cond, list) and len(cond) == 3:
            op, a, b = cond
            op = str(op).lower()
            if op == "content-length-range":
                if not (int(a) <= file_size <= int(b)):
                    raise S3Error("EntityTooLarge"
                                  if file_size > int(b)
                                  else "EntityTooSmall")
                continue
            field = str(a).lstrip("$").lower()
            have = lower.get(field, "")
            if op == "eq" and have != b:
                raise S3Error("AccessDenied",
                              f"policy condition failed: eq {field}")
            if op == "starts-with" and not have.startswith(b):
                raise S3Error(
                    "AccessDenied",
                    f"policy condition failed: starts-with {field}")


def verify_post_signature(fields: dict[str, str], cred_lookup,
                          region: str):
    """V4 POST signature: signature = HMAC-chain(secret, date/region/s3)
    over the base64 policy (same signing key as SigV4 requests)."""
    from . import signature as sig
    lower = {k.lower(): v for k, v in fields.items()}
    policy = lower.get("policy", "")
    amz_cred = lower.get("x-amz-credential", "")
    amz_date = lower.get("x-amz-date", "")
    got_sig = lower.get("x-amz-signature", "")
    if not (policy and amz_cred and amz_date and got_sig):
        raise S3Error("AccessDenied", "missing POST auth fields")
    try:
        access_key, datestamp, reg, svc, term = amz_cred.split("/")
    except ValueError:
        raise S3Error("AccessDenied", "bad credential field") from None
    cred = cred_lookup(access_key)
    key = sig.signing_key(cred.secret_key, datestamp, reg, svc)
    want = hmac.new(key, policy.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, got_sig):
        raise S3Error("SignatureDoesNotMatch")
    return cred
