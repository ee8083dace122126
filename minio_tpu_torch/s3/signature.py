"""AWS signature verification: SigV4 (header, presigned, streaming
chunked) and SigV2 (header, presigned).

Mirrors the behavior of the reference's cmd/signature-v4.go,
cmd/signature-v4-parser.go, cmd/streaming-signature-v4.go and
cmd/signature-v2.go, rebuilt around a request snapshot (method, path,
query, headers, body) rather than net/http internals.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import hmac
import re
import urllib.parse
from typing import Callable, Iterable, Optional

from .credentials import Credentials

SIGN_V4_ALGORITHM = "AWS4-HMAC-SHA256"
STREAMING_CONTENT_SHA256 = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
ISO8601_FORMAT = "%Y%m%dT%H%M%SZ"
YYYYMMDD = "%Y%m%d"
SERVICE_S3 = "s3"
MAX_SKEW_SECONDS = 15 * 60
MAX_PRESIGN_EXPIRES = 7 * 24 * 3600


class SigError(Exception):
    """Signature failure; .code is an S3 error code name."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code


@dataclasses.dataclass
class Request:
    """Snapshot of an incoming HTTP request for auth purposes."""
    method: str
    path: str                      # URL-encoded path as received
    query: dict[str, list[str]]    # parsed query (values url-decoded)
    headers: dict[str, str]        # lower-cased header names
    raw_query: str = ""            # original query string

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def _hmac_sha256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str,
                service: str = SERVICE_S3) -> bytes:
    """AWS4 derived signing key (cmd/signature-v4.go getSigningKey)."""
    k = _hmac_sha256(("AWS4" + secret).encode(), date)
    k = _hmac_sha256(k, region)
    k = _hmac_sha256(k, service)
    return _hmac_sha256(k, "aws4_request")


def _canonical_query(query: dict[str, list[str]],
                     skip: Iterable[str] = ()) -> str:
    pairs = []
    skipset = set(skip)
    for k in sorted(query):
        if k in skipset:
            continue
        for v in sorted(query[k]):
            pairs.append(f"{_uri_encode(k)}={_uri_encode(v)}")
    return "&".join(pairs)


def _canonical_headers(headers: dict[str, str],
                       signed: list[str]) -> tuple[str, str]:
    lines = []
    for h in signed:
        v = headers.get(h, "")
        lines.append(f"{h}:{' '.join(v.split())}\n")
    return "".join(lines), ";".join(signed)


def canonical_request(method: str, path: str, query_str: str,
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str) -> str:
    ch, sh = _canonical_headers(headers, signed_headers)
    return "\n".join([method, path, query_str, ch, sh, payload_hash])


def string_to_sign(canon_req: str, amz_date: str, scope: str) -> str:
    return "\n".join([SIGN_V4_ALGORITHM, amz_date, scope,
                      hashlib.sha256(canon_req.encode()).hexdigest()])


def _scope(date: str, region: str, service: str = SERVICE_S3) -> str:
    return f"{date}/{region}/{service}/aws4_request"


def _parse_amz_date(s: str) -> datetime.datetime:
    for fmt in (ISO8601_FORMAT, "%a, %d %b %Y %H:%M:%S %Z"):
        try:
            return datetime.datetime.strptime(s, fmt).replace(
                tzinfo=datetime.timezone.utc)
        except ValueError:
            continue
    raise SigError("MalformedDate", f"bad date: {s}")


# ---------------------------------------------------------------------------
# SigV4 header auth
# ---------------------------------------------------------------------------

_CRED_RE = re.compile(
    r"^(?P<ak>[^/]+)/(?P<date>\d{8})/(?P<region>[^/]*)/"
    r"(?P<service>[^/]+)/aws4_request$")


@dataclasses.dataclass
class SigV4Parts:
    access_key: str
    date: str
    region: str
    service: str
    signed_headers: list[str]
    signature: str


def parse_sign_v4(auth_header: str) -> SigV4Parts:
    """Parse `Authorization: AWS4-HMAC-SHA256 Credential=..,
    SignedHeaders=.., Signature=..` (cmd/signature-v4-parser.go)."""
    if not auth_header.startswith(SIGN_V4_ALGORITHM):
        raise SigError("SignatureVersionNotSupported")
    rest = auth_header[len(SIGN_V4_ALGORITHM):].strip()
    fields = {}
    for part in rest.split(","):
        part = part.strip()
        if "=" not in part:
            raise SigError("AuthorizationHeaderMalformed")
        k, v = part.split("=", 1)
        fields[k.strip()] = v.strip()
    try:
        cred, sh, sig = (fields["Credential"], fields["SignedHeaders"],
                         fields["Signature"])
    except KeyError:
        raise SigError("AuthorizationHeaderMalformed")
    mm = _CRED_RE.match(cred)
    if not mm:
        raise SigError("CredMalformed")
    return SigV4Parts(access_key=mm["ak"], date=mm["date"],
                      region=mm["region"], service=mm["service"],
                      signed_headers=sorted(h.lower()
                                            for h in sh.split(";")),
                      signature=sig)


def _check_required_signed_headers(signed: list[str]) -> None:
    if "host" not in signed:
        raise SigError("UnsignedHeaders", "host header must be signed")


def verify_v4(req: Request, cred_lookup: Callable[[str], Credentials],
              region: str = "", payload_hash: Optional[str] = None
              ) -> Credentials:
    """Verify a header-signed V4 request; returns the matched creds.
    (cmd/signature-v4.go doesSignatureMatch)."""
    parts = parse_sign_v4(req.header("authorization"))
    _check_required_signed_headers(parts.signed_headers)
    creds = cred_lookup(parts.access_key)
    if region and parts.region and parts.region != region:
        raise SigError("AuthorizationHeaderMalformed",
                       f"region mismatch: {parts.region}")

    date_str = req.header("x-amz-date") or req.header("date")
    if not date_str:
        raise SigError("MissingDateHeader")
    t = _parse_amz_date(date_str)
    now = datetime.datetime.now(datetime.timezone.utc)
    if abs((now - t).total_seconds()) > MAX_SKEW_SECONDS:
        raise SigError("RequestTimeTooSkewed")

    if payload_hash is None:
        payload_hash = req.header("x-amz-content-sha256", UNSIGNED_PAYLOAD)

    canon = canonical_request(
        req.method, _canonical_uri(req.path), _canonical_query(req.query),
        req.headers, parts.signed_headers, payload_hash)
    sts = string_to_sign(canon, t.strftime(ISO8601_FORMAT),
                         _scope(parts.date, parts.region, parts.service))
    key = signing_key(creds.secret_key, parts.date, parts.region,
                      parts.service)
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, parts.signature):
        raise SigError("SignatureDoesNotMatch")
    return creds


def _canonical_uri(path: str) -> str:
    # Path arrives percent-encoded from the wire; canonical form keeps
    # it encoded (s3 does NOT double-encode, unlike other services).
    return path or "/"


# ---------------------------------------------------------------------------
# SigV4 presigned
# ---------------------------------------------------------------------------

def verify_v4_presigned(req: Request,
                        cred_lookup: Callable[[str], Credentials],
                        region: str = "") -> Credentials:
    """Verify `?X-Amz-Algorithm=AWS4-HMAC-SHA256&...` presigned URL
    (cmd/signature-v4.go doesPresignedSignatureMatch)."""
    q = {k: v[0] for k, v in req.query.items()}
    if q.get("X-Amz-Algorithm") != SIGN_V4_ALGORITHM:
        raise SigError("SignatureVersionNotSupported")
    try:
        cred, amz_date = q["X-Amz-Credential"], q["X-Amz-Date"]
        expires, sh = q["X-Amz-Expires"], q["X-Amz-SignedHeaders"]
        signature = q["X-Amz-Signature"]
    except KeyError:
        raise SigError("InvalidQueryParams")
    mm = _CRED_RE.match(cred)
    if not mm:
        raise SigError("CredMalformed")
    creds = cred_lookup(mm["ak"])
    if region and mm["region"] and mm["region"] != region:
        raise SigError("AuthorizationHeaderMalformed")

    t = _parse_amz_date(amz_date)
    now = datetime.datetime.now(datetime.timezone.utc)
    try:
        exp = int(expires)
    except ValueError:
        raise SigError("MalformedExpires")
    if exp < 0:
        raise SigError("NegativeExpires")
    if exp > MAX_PRESIGN_EXPIRES:
        raise SigError("MaximumExpires")
    if (now - t).total_seconds() > exp:
        raise SigError("ExpiredPresignRequest")
    if (t - now).total_seconds() > MAX_SKEW_SECONDS:
        raise SigError("RequestNotReadyYet")

    signed_headers = sorted(h.lower() for h in sh.split(";"))
    _check_required_signed_headers(signed_headers)
    payload_hash = q.get("X-Amz-Content-Sha256", UNSIGNED_PAYLOAD)
    canon = canonical_request(
        req.method, _canonical_uri(req.path),
        _canonical_query(req.query, skip=("X-Amz-Signature",)),
        req.headers, signed_headers, payload_hash)
    sts = string_to_sign(canon, amz_date,
                         _scope(mm["date"], mm["region"], mm["service"]))
    key = signing_key(creds.secret_key, mm["date"], mm["region"],
                      mm["service"])
    want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, signature):
        raise SigError("SignatureDoesNotMatch")
    return creds


def presign_v4(method: str, path: str, query: dict[str, str],
               headers: dict[str, str], creds: Credentials, region: str,
               expires: int, t: Optional[datetime.datetime] = None) -> str:
    """Produce the presigned query string (client side; used by tests,
    the admin client, and share-URL generation)."""
    t = t or datetime.datetime.now(datetime.timezone.utc)
    amz_date = t.strftime(ISO8601_FORMAT)
    date = t.strftime(YYYYMMDD)
    scope = _scope(date, region)
    q = dict(query)
    q.update({
        "X-Amz-Algorithm": SIGN_V4_ALGORITHM,
        "X-Amz-Credential": f"{creds.access_key}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    })
    if creds.session_token:
        q["X-Amz-Security-Token"] = creds.session_token
    mq = {k: [v] for k, v in q.items()}
    canon = canonical_request(
        method, _canonical_uri(path), _canonical_query(mq),
        {"host": headers.get("host", "")}, ["host"], UNSIGNED_PAYLOAD)
    sts = string_to_sign(canon, amz_date, scope)
    key = signing_key(creds.secret_key, date, region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    q["X-Amz-Signature"] = sig
    return urllib.parse.urlencode(q)


def sign_v4(method: str, path: str, query: dict[str, list[str]],
            headers: dict[str, str], payload_hash: str,
            creds: Credentials, region: str,
            t: Optional[datetime.datetime] = None) -> dict[str, str]:
    """Client-side header signing: returns headers to add (Authorization,
    x-amz-date, x-amz-content-sha256). Used by tests + internode client."""
    t = t or datetime.datetime.now(datetime.timezone.utc)
    amz_date = t.strftime(ISO8601_FORMAT)
    date = t.strftime(YYYYMMDD)
    hdrs = {k.lower(): v for k, v in headers.items()}
    hdrs["x-amz-date"] = amz_date
    hdrs["x-amz-content-sha256"] = payload_hash
    if creds.session_token:
        hdrs["x-amz-security-token"] = creds.session_token
    signed = sorted(h for h in hdrs
                    if h in ("host", "content-type", "content-md5")
                    or h.startswith("x-amz-"))
    canon = canonical_request(method, _canonical_uri(path),
                              _canonical_query(query), hdrs, signed,
                              payload_hash)
    scope = _scope(date, region)
    sts = string_to_sign(canon, amz_date, scope)
    key = signing_key(creds.secret_key, date, region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    hdrs["authorization"] = (
        f"{SIGN_V4_ALGORITHM} Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return hdrs


# ---------------------------------------------------------------------------
# SigV4 streaming chunked payload
# ---------------------------------------------------------------------------

class ChunkedReader:
    """Decode `aws-chunked` streaming-signed V4 payload, verifying each
    chunk signature (cmd/streaming-signature-v4.go newSignV4ChunkedReader).

    Frame:  <hex size>;chunk-signature=<sig>\r\n<payload>\r\n ...
    Final:  0;chunk-signature=<sig>\r\n\r\n
    Chunk string-to-sign chains the previous signature
    ("AWS4-HMAC-SHA256-PAYLOAD").
    """

    def __init__(self, raw, seed_signature: str, seed_date: str,
                 scope_date: str, region: str, secret_key: str):
        self.raw = raw
        self.prev_sig = seed_signature
        self.seed_date = seed_date
        self.scope = _scope(scope_date, region)
        self.key = signing_key(secret_key, scope_date, region)
        self.buf = b""
        self.eof = False

    def _read_line(self) -> bytes:
        line = b""
        while not line.endswith(b"\r\n"):
            c = self.raw.read(1)
            if not c:
                raise SigError("IncompleteBody", "truncated chunk header")
            line += c
            if len(line) > 4096:
                raise SigError("MalformedPOSTRequest", "chunk header too long")
        return line[:-2]

    def _chunk_string_to_sign(self, payload: bytes) -> str:
        return "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", self.seed_date, self.scope,
            self.prev_sig, EMPTY_SHA256,
            hashlib.sha256(payload).hexdigest()])

    def _next_chunk(self) -> bytes:
        header = self._read_line().decode("latin-1")
        if ";" not in header:
            raise SigError("MalformedPOSTRequest", "missing chunk-signature")
        size_hex, sigpart = header.split(";", 1)
        if not sigpart.startswith("chunk-signature="):
            raise SigError("MalformedPOSTRequest", "bad chunk signature tag")
        sig = sigpart[len("chunk-signature="):]
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise SigError("MalformedPOSTRequest", "bad chunk size")
        payload = b""
        while len(payload) < size:
            got = self.raw.read(size - len(payload))
            if not got:
                raise SigError("IncompleteBody", "truncated chunk payload")
            payload += got
        want = hmac.new(self.key, self._chunk_string_to_sign(payload)
                        .encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise SigError("SignatureDoesNotMatch", "chunk signature")
        self.prev_sig = sig
        crlf = self.raw.read(2)
        if crlf != b"\r\n":
            raise SigError("MalformedPOSTRequest", "missing chunk CRLF")
        if size == 0:
            self.eof = True
        return payload

    def read(self, n: int = -1) -> bytes:
        while not self.eof and (n < 0 or len(self.buf) < n):
            self.buf += self._next_chunk()
        if n < 0:
            out, self.buf = self.buf, b""
        else:
            out, self.buf = self.buf[:n], self.buf[n:]
        return out


def new_chunked_reader(req: Request, raw,
                       creds: Credentials) -> ChunkedReader:
    """Build the verifying reader from a streaming-signed request
    (requires the header signature already verified with payload hash
    STREAMING_CONTENT_SHA256)."""
    parts = parse_sign_v4(req.header("authorization"))
    date_str = req.header("x-amz-date") or req.header("date")
    t = _parse_amz_date(date_str)
    return ChunkedReader(raw, parts.signature, t.strftime(ISO8601_FORMAT),
                         parts.date, parts.region, creds.secret_key)


# ---------------------------------------------------------------------------
# SigV2 (legacy)
# ---------------------------------------------------------------------------

_SUBRESOURCES = (
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type", "response-expires",
    "torrent", "uploadId", "uploads", "versionId", "versioning", "versions",
    "website", "tagging", "select", "select-type")


def _canonical_v2(method: str, path: str, query: dict[str, list[str]],
                  headers: dict[str, str]) -> str:
    amz = sorted((k, ",".join(" ".join(vv.split()) for vv in [v]))
                 for k, v in headers.items() if k.startswith("x-amz-"))
    canon_amz = "".join(f"{k}:{v}\n" for k, v in amz)
    res = path
    sub = []
    for k in sorted(query):
        if k in _SUBRESOURCES:
            v = query[k][0]
            sub.append(f"{k}={v}" if v else k)
    if sub:
        res += "?" + "&".join(sub)
    return "\n".join([
        method,
        headers.get("content-md5", ""),
        headers.get("content-type", ""),
        headers.get("date", ""),
    ]) + "\n" + canon_amz + res


def verify_v2(req: Request, cred_lookup: Callable[[str], Credentials]
              ) -> Credentials:
    """Verify `Authorization: AWS AKID:signature` (cmd/signature-v2.go)."""
    import base64
    auth = req.header("authorization")
    if not auth.startswith("AWS "):
        raise SigError("SignatureVersionNotSupported")
    try:
        ak, sig = auth[4:].split(":", 1)
    except ValueError:
        raise SigError("InvalidArgument", "malformed v2 auth header")
    creds = cred_lookup(ak)
    sts = _canonical_v2(req.method, req.path, req.query, req.headers)
    want = base64.b64encode(
        hmac.new(creds.secret_key.encode(), sts.encode(),
                 hashlib.sha1).digest()).decode()
    if not hmac.compare_digest(want, sig):
        raise SigError("SignatureDoesNotMatch")
    return creds


# ---------------------------------------------------------------------------
# request auth-type classification (cmd/auth-handler.go:54-118)
# ---------------------------------------------------------------------------

AUTH_UNKNOWN = "unknown"
AUTH_ANONYMOUS = "anonymous"
AUTH_PRESIGNED = "presigned"
AUTH_PRESIGNED_V2 = "presignedv2"
AUTH_SIGNED = "signed"
AUTH_SIGNED_V2 = "signedv2"
AUTH_STREAMING_SIGNED = "streaming-signed"
AUTH_POST_POLICY = "post-policy"
AUTH_JWT = "jwt"
AUTH_STS = "sts"


def get_request_auth_type(req: Request) -> str:
    auth = req.header("authorization")
    if auth.startswith(SIGN_V4_ALGORITHM):
        if req.header("x-amz-content-sha256") == STREAMING_CONTENT_SHA256:
            return AUTH_STREAMING_SIGNED
        return AUTH_SIGNED
    if auth.startswith("AWS "):
        return AUTH_SIGNED_V2
    if auth.startswith("Bearer "):
        return AUTH_JWT
    if "X-Amz-Credential" in req.query:
        return AUTH_PRESIGNED
    if "AWSAccessKeyId" in req.query:
        return AUTH_PRESIGNED_V2
    if req.header("content-type", "").startswith("multipart/form-data") \
            and req.method == "POST":
        return AUTH_POST_POLICY
    if "Action" in req.query:
        return AUTH_STS
    if not auth:
        return AUTH_ANONYMOUS
    return AUTH_UNKNOWN
