"""S3 API handlers — the request->ObjectLayer glue.

Counterpart of minio_tpu/s3/handlers.py (the reference's
cmd/object-handlers.go, cmd/bucket-handlers.go and
cmd/bucket-listobjects-handlers.go) on top of a request snapshot and the
port's object layer: auth classification and signature verification,
conditional headers, ranged reads, streaming-signed payload decoding,
multipart, copy, delete-multiple, tagging, versioning, the handler
side of SSE-S3 / SSE-C, and inline compression (MINIO_COMPRESS,
MINIO_COMPRESS_ALGORITHM: S2 framing by default, or zstd).

Every object byte goes through the port's object layer, so a PUT runs the
fused encode step on the card (models/pipeline.put_step through the batch
former), a degraded GET the fused decode, a single SSE PUT the fused
cipher+encode (features/crypto.DeviceSSE), and every encrypted GET
checks each package's Poly1305 tag on the host before the card deciphers
it (crypto.chacha_decrypt_ranged, through the batch former: handler
threads never touch the card). Multipart SSE parts are ciphered on
the host with per-part nonces, as in the reference. SelectObjectContent
evaluates its WHERE clause and COUNTs on the card (scan/engine.ScanEngine,
through the batch former's scan verb when the boot attached one) and
frames the evaluator's response bytes; a Select over an SSE object
deciphers on the card first, and one over a compressed object decodes
through the same plaintext stack on the host. Every mutation marks the
data-update tracker (update_tracker, attached by the boot) where the
reference's event funnel marks it, and quota reads the usage crawler's
cache (usage) when one is attached.

Every verb is authorised by the reference's action, bucket and key
(minio_tpu/s3/handlers.py:298-395): the root credential and credentials
derived from it are the owner; with an IAMSys attached (``iam``; the
cluster boot attaches one over the erasure-coded identity store) users,
groups, service accounts and STS credentials are held to their policies
and the bucket's policy (explicit Deny wins), temporary credentials must
present their session token, an anonymous request is allowed only by a
bucket policy, and a copy needs ``s3:GetObject`` on its source. POST /
is STS (:396-520): AssumeRole signed by a user, and the web-identity,
client-grants and LDAP federation where ``identity_openid`` /
``identity_ldap`` are configured (``config``, a ConfigSys). Without IAM
the root credential alone serves, anonymous requests are refused and STS
answers NotImplemented, as in the reference. Object lock (the bucket's
``?object-lock`` config, a bucket created with
``x-amz-bucket-object-lock-enabled``, a PUT's lock headers and the
bucket's default retention, ``?retention`` and ``?legal-hold``, and WORM
enforcement on deletes) and browser POST uploads (s3/postpolicy.py) are
the reference's; a locked or POSTed object encodes on the card as any PUT.
Departure: DeleteObjects holds each key to the lock as the single DELETE
does (the reference's removes a locked version). Bucket notification
is the reference's: ``?notification`` configs (a PUT validated by the
notification plane, ``notify``), ListenBucketNotification's ND-JSON
stream over the legacy notifier's hub (``events``), and ``_notify`` at
each of the reference's event sites (the tracker marked for every event
but ``s3:ObjectAccessed:*``). Replication is the
reference's: ``?replication`` configs, the owner-gated internal headers
(the replication-apply branch of PUT, whose version-faithful write
encodes on the card past the codec's gate, and the replica-prune branch
of DELETE, bound by object lock), and the legacy pool's ``on_put`` /
``on_delete`` hooks in ``_notify`` (``replication``; the active-active
plane rides the namespace feed instead). RestoreObject answers
NotImplemented when no tier manager is attached (``tiers``, as in the
reference).

The QoS plane (s3/qos.py, off by default) resolves each request's tenant
at the admission gate, confirms it from the verified credential
(``ctx.tenant``, which the trace record carries) and paces the admitted
body and the response stream through the tenant's byte budgets.
Each request's trace record goes to ``trace`` (s3/trace.TraceSys) from
the edge middleware. Left out with the unported planes: bandwidth
accounting, bucket federation and storage-class parity.

The tier plane (tier/): a transitioned object's HEAD and GET carry the
tier as ``x-amz-storage-class`` and its ``x-amz-restore`` state, a GET
of a stub answers InvalidObjectState, RestoreObject pulls the object
back (202 on a fresh restore, 200 when it only extends the expiry; at
MINIO_TPU_RESTORE_ASYNC_BYTES or more, 202 at once and the tier worker
pulls), and a DELETE or a DeleteObjects that removes a data version
frees its remote copy. Departure: the GET of a stub answers
InvalidObjectState before any transform; the reference's GET of an
encrypted or compressed stub starts a 200 whose stream then fails (its
transformed reads open the layer lazily).

Departure: a copy that keeps the source's stored bytes (REPLACE directive
without a new transform) also keeps the source's cipher record, and a
copy re-encrypted under AES-GCM drops a ChaCha20 source's record; the
reference does neither, which leaves such copies unreadable.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import hashlib
import io
import json
import os
import re
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape as _sax_escape
from collections import OrderedDict
from email.utils import formatdate, parsedate_to_datetime
from typing import Iterator, Optional

from ..features import crypto as sse
from ..features import objectlock as olock
from ..object import api_errors as oerr
from ..object.bucket_metadata import BucketMetadataSys
from ..object.engine import GetOptions, PutOptions
from ..object.hash_reader import HashReader
from ..object.multipart import CompletePart
from ..s3select import SelectRequest
from ..scan import ScanEngine
from ..storage import datatypes as dt
from ..storage.datatypes import ObjectInfo
from ..tier import transition as tier_transition
from ..utils import knobs, stagetimer
from ..utils.streams import IterStream as _IterStream
from . import postpolicy as pp
from . import signature as sig
from . import xmlgen
from .credentials import Credentials, global_credentials
from .s3errors import S3Error, api_error_from

MAX_OBJECT_SIZE = 5 * (1 << 40)          # 5 TiB
MAX_PART_SIZE = 5 * (1 << 30)            # 5 GiB
MIN_PART_SIZE = 5 * (1 << 20)            # 5 MiB
MAX_PARTS = 10000
_BUCKET_RE = re.compile(r"^[a-z0-9][a-z0-9.\-]{1,61}[a-z0-9]$")

# internal metadata a re-transforming copy drops before it seals anew, and,
# with the cipher record, a verbatim copy keeps
_SEAL_KEYS = (sse.MK_SSE, sse.MK_SEALED, sse.MK_IV, sse.MK_KEYMD5,
              sse.MK_COMPRESS, sse.MK_COMPRESS_LEGACY, sse.MK_ACTUAL,
              sse.MK_SSE_MP)


@dataclasses.dataclass
class HTTPResponse:
    status: int = 200
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    body: bytes = b""
    stream: Optional[Iterator[bytes]] = None   # used instead of body if set
    long_poll: bool = False   # idle follow stream: never "slow" in spans
    # admission-refusal label riding the response so the middleware's
    # trace record can say why a 503 shed happened (set only by
    # ShedDecision.response, the one shed construction site)
    shed_reason: str = ""

    def with_xml(self, payload: bytes) -> "HTTPResponse":
        self.headers["Content-Type"] = "application/xml"
        self.body = payload
        return self


class RequestContext:
    """Everything a handler needs about one request."""

    def __init__(self, req: sig.Request, body_stream, content_length: int):
        self.req = req
        self.body_stream = body_stream
        self.content_length = content_length
        self.cred: Optional[Credentials] = None
        self.remote_addr = ""              # filled by the server loop
        self.secure = False                # True on a TLS listener
        self.auth_type = sig.get_request_auth_type(req)
        # hex digest the client signed over (x-amz-content-sha256);
        # enforced when the body is consumed (isReqAuthenticated analog)
        self.expect_body_sha = ""
        # QoS tenant the admission ticket resolved ("" = plane off);
        # confirmed from the verified credential post-auth
        self.tenant = ""

    def query1(self, name: str, default: str = "") -> str:
        v = self.req.query.get(name)
        return v[0] if v else default

    def has_query(self, name: str) -> bool:
        return name in self.req.query

    def header(self, name: str, default: str = "") -> str:
        return self.req.header(name, default)

    def read_body(self) -> bytes:
        if self.content_length <= 0:
            data = b""
        else:
            data = self.body_stream.read(self.content_length)
        if self.expect_body_sha:
            if hashlib.sha256(data).hexdigest() != self.expect_body_sha:
                raise S3Error("XAmzContentSHA256Mismatch")
            self.expect_body_sha = ""
        return data


def _http_date(t: float) -> str:
    return formatdate(t, usegmt=True)


def _is_hex_sha(s: str) -> bool:
    return len(s) == 64 and all(c in "0123456789abcdef" for c in s)


def _skip_take(chunks: Iterator[bytes], skip: int, take: int
               ) -> Iterator[bytes]:
    """Trim a chunk stream to [skip, skip+take)."""
    for chunk in chunks:
        if skip:
            if len(chunk) <= skip:
                skip -= len(chunk)
                continue
            chunk = chunk[skip:]
            skip = 0
        if take <= 0:
            return
        if len(chunk) > take:
            yield chunk[:take]
            return
        take -= len(chunk)
        yield chunk


def _extract_metadata(ctx: RequestContext) -> dict[str, str]:
    """User + standard metadata from headers
    (cmd/utils.go extractMetadata)."""
    md: dict[str, str] = {}
    for k, v in ctx.req.headers.items():
        if k.startswith("x-amz-meta-"):
            md["X-Amz-Meta-" + k[len("x-amz-meta-"):].title()] = v
        elif k in ("content-type", "content-encoding", "cache-control",
                   "content-disposition", "content-language", "expires"):
            md[k] = v
    if "content-type" not in md:
        md["content-type"] = "application/octet-stream"
    if ctx.header("x-amz-storage-class"):
        md["x-amz-storage-class"] = ctx.header("x-amz-storage-class")
    if ctx.header("x-amz-website-redirect-location"):
        md["x-amz-website-redirect-location"] = ctx.header(
            "x-amz-website-redirect-location")
    return md


def _parse_range(header: str, size: int) -> Optional[tuple[int, int]]:
    """`bytes=a-b` -> (offset, length); None = whole object. Raises
    InvalidRange when unsatisfiable (cmd/httprange.go)."""
    if not header:
        return None
    if not header.startswith("bytes="):
        return None  # ignored per S3 semantics
    spec = header[len("bytes="):]
    if "," in spec:
        raise S3Error("NotImplemented", "multiple ranges not supported")
    try:
        first, last = spec.split("-", 1)
        if first == "":
            n = int(last)
            if n == 0:
                raise S3Error("InvalidRange")
            offset = max(size - n, 0)
            return offset, size - offset
        start = int(first)
        if last == "":
            if start >= size:
                raise S3Error("InvalidRange")
            return start, size - start
        end = int(last)
        if start > end:
            raise S3Error("InvalidRange")
        if start >= size:
            raise S3Error("InvalidRange")
        return start, min(end, size - 1) - start + 1
    except ValueError:
        return None


class _ReleasingStream:
    """Response-body wrapper that returns its admission ticket when the
    stream is exhausted or closed (whichever comes first; the ticket's
    release is idempotent)."""

    def __init__(self, inner, ticket):
        self._inner = inner
        self._ticket = ticket

    def __iter__(self):
        try:
            for chunk in self._inner:
                yield chunk
        finally:
            self.close()

    def close(self) -> None:
        try:
            close = getattr(self._inner, "close", None)
            if close is not None:
                close()
        finally:
            self._ticket.release()


class S3ApiHandlers:
    def __init__(self, object_layer, region: str = "us-east-1",
                 creds: Optional[Credentials] = None,
                 iam=None, max_clients: Optional[int] = None):
        self.obj = object_layer
        self.region = region
        self.root_cred = creds or global_credentials()
        self.iam = iam            # optional IAMSys (policy checks + users)
        self.config = None        # optional ConfigSys (admin KV)
        # the admission gate's size the boot computed (requests_budget);
        # config requests_max 0 restores it
        self.requests_budget: Optional[int] = None
        self.bucket_meta = BucketMetadataSys(object_layer)
        # the one admission gate (s3/edge/admission.py), shared with the
        # event-loop edge so both frontends refuse identically; the
        # cluster boot re-sizes it with requests_budget via
        # set_max_clients()
        from .edge.admission import AdmissionController
        self.admission = AdmissionController(max_clients)
        # the multi-tenant QoS plane (s3/qos.py): per-tenant shares and
        # budgets enforced at the admission gate. The iam lookup is
        # late-bound (the cluster boot sets self.iam after this
        # constructor runs). Off by default (MINIO_TPU_QOS).
        from .qos import QoSPlane, QoSRegistry
        self.qos = QoSPlane(QoSRegistry(object_layer),
                            iam_lookup=lambda: self.iam,
                            root_access_key=self.root_cred.access_key)
        self.admission.qos = self.qos
        # upload-session metadata cache: immutable after create, so part
        # uploads don't re-read the session journal per part
        self._mpu_meta: "OrderedDict[str, dict]" = OrderedDict()
        # resolved SSE-S3 object keys per upload (bounds KMS round
        # trips to one per upload, not one per part)
        self._mpu_keys: "OrderedDict[str, tuple]" = OrderedDict()
        self.kms = sse.kms_from_env()        # SSE-S3 KMS seam
        self.compression_enabled = os.environ.get(
            "MINIO_COMPRESS", "").lower() in ("on", "true", "1")
        # "s2" (snappy framing, reference-interoperable — the default)
        # or "zstd" (better ratio, no cross-binary interop)
        self.compression_algorithm = os.environ.get(
            "MINIO_COMPRESS_ALGORITHM", "s2").lower()
        self.events = None         # optional EventNotifier (legacy hook)
        self.notify = None         # optional NotificationPlane
                                   # (notify/, feed-driven)
        self.usage = None          # optional DataUsageCrawler (quota cache)
        self.replication = None    # optional ReplicationPlane (or the
        # legacy ReplicationPool: _notify duck-types the difference)
        self.tiers = None          # optional TierManager (ILM tiering)
        # optional TransitionWorker: the async RestoreObject pulls
        self.restore_worker = None
        self.update_tracker = None  # optional DataUpdateTracker
        from .trace import TraceSys
        self.trace = TraceSys()    # request tracing + audit hub
        self.cors_allow_origin = "*"
        # the scan plane: Selects evaluate on the object layer's device;
        # the cluster boot attaches the shared batch former, so that
        # concurrent Selects coalesce
        self.scan = ScanEngine(device=getattr(object_layer, "device", None))

    def set_max_clients(self, n: int) -> None:
        """Re-size the admission gate once topology is known (the
        reference computes maxClients from RAM + drive count,
        cmd/handler-api.go:46-57)."""
        self.admission.resize(n)

    def set_object_layer(self, object_layer) -> None:
        """Late-bind the ObjectLayer (the boot starts the listener before
        the drives are formatted)."""
        self.obj = object_layer
        self.bucket_meta.obj = object_layer
        # the scheduler-occupancy admission signal probes the live
        # layer's batch formers
        self.admission.layer = object_layer
        self.scan.device = getattr(object_layer, "device", None)
        # the QoS budget registry persists to the live layer's pools
        self.qos.registry.obj = object_layer

    # ------------------------------------------------------------------
    # auth
    # ------------------------------------------------------------------

    def _is_owner(self, cred: Credentials) -> bool:
        """Root and its derived temp/service creds (reference
        cred.ParentUser == globalActiveCred.AccessKey => IsOwner)."""
        return cred.access_key == self.root_cred.access_key or \
            cred.parent_user == self.root_cred.access_key

    def _cred_lookup(self, access_key: str) -> Credentials:
        if access_key == self.root_cred.access_key:
            return self.root_cred
        if self.iam is not None:
            cred = self.iam.get_credentials(access_key)
            if cred is not None and cred.is_valid():
                return cred
        raise sig.SigError("InvalidAccessKeyId")

    def authenticate(self, ctx: RequestContext,
                     action: str = "", bucket: str = "",
                     object_name: str = "") -> None:
        """Verify the request signature and (if IAM is wired) that the
        caller may perform `action` (cmd/auth-handler.go
        checkRequestAuthType)."""
        with stagetimer.stage("auth"):
            self._authenticate(ctx, action, bucket, object_name)

    def _authenticate(self, ctx: RequestContext,
                      action: str = "", bucket: str = "",
                      object_name: str = "") -> None:
        at = ctx.auth_type
        if at == sig.AUTH_SIGNED:
            body_sha = ctx.header("x-amz-content-sha256",
                                  sig.UNSIGNED_PAYLOAD)
            ctx.cred = sig.verify_v4(ctx.req, self._cred_lookup,
                                     self.region, body_sha)
            # a signed hex digest must match the actual body; object PUT
            # verifies via HashReader, every other consumer via read_body
            if _is_hex_sha(body_sha):
                ctx.expect_body_sha = body_sha
        elif at == sig.AUTH_STREAMING_SIGNED:
            ctx.cred = sig.verify_v4(ctx.req, self._cred_lookup,
                                     self.region,
                                     sig.STREAMING_CONTENT_SHA256)
        elif at == sig.AUTH_PRESIGNED:
            ctx.cred = sig.verify_v4_presigned(ctx.req, self._cred_lookup,
                                               self.region)
        elif at == sig.AUTH_SIGNED_V2:
            ctx.cred = sig.verify_v2(ctx.req, self._cred_lookup)
        elif at == sig.AUTH_ANONYMOUS:
            if not self._anonymous_allowed(ctx, action, bucket,
                                           object_name):
                raise S3Error("AccessDenied")
            ctx.cred = Credentials()
            if self.qos.enabled():
                ctx.tenant = self.qos.tenant_for_cred(None)
            return
        else:
            raise S3Error("SignatureVersionNotSupported")
        # temp (STS) credentials must present their session token —
        # header for signed requests, X-Amz-Security-Token query param
        # for presigned URLs (signature.py:291)
        if ctx.cred.is_temp():
            token = ctx.header("x-amz-security-token") or \
                ctx.query1("X-Amz-Security-Token")
            if token != ctx.cred.session_token:
                raise S3Error("InvalidTokenId")
        if self.iam is not None and ctx.cred.access_key and \
                not self._is_owner(ctx.cred):
            if not self.iam.is_allowed(ctx.cred, action, bucket,
                                       object_name,
                                       self._policy_conditions(ctx)):
                raise S3Error("AccessDenied")
        # confirm the tenant from the verified credential (the admission
        # gate charged the budget of the *claimed* key; a forged claim
        # never reaches here)
        if self.qos.enabled():
            ctx.tenant = self.qos.tenant_for_cred(ctx.cred)

    @staticmethod
    def _policy_conditions(ctx: "RequestContext") -> dict:
        """Request facts for policy Condition evaluation (reference
        getConditionValues, cmd/auth-handler.go)."""
        cond = {}
        if ctx.remote_addr:
            cond["aws:SourceIp"] = ctx.remote_addr
        referer = ctx.header("referer")
        if referer:
            cond["aws:Referer"] = referer
        # real connection state, never a client-supplied header
        cond["aws:SecureTransport"] = "true" if ctx.secure else "false"
        return cond

    def _anonymous_allowed(self, ctx: "RequestContext", action: str,
                           bucket: str, object_name: str) -> bool:
        if not bucket or self.iam is None:
            return False
        return self.iam.is_anonymous_allowed(
            self.bucket_meta.get(bucket).policy_json, action, bucket,
            object_name, self._policy_conditions(ctx))

    # ------------------------------------------------------------------
    # STS (POST / with Action=AssumeRole; cmd/sts-handlers.go:43-86)
    # ------------------------------------------------------------------

    def handle_sts(self, ctx: RequestContext) -> HTTPResponse:
        """STS action dispatch (reference cmd/sts-handlers.go:43-86):
        AssumeRole is SigV4-authenticated; the federation actions
        (WebIdentity/ClientGrants JWT, LDAP bind) are authenticated by
        the presented token/credentials themselves."""
        if self.iam is None:
            raise S3Error("NotImplemented", "STS requires IAM")
        body_sha = ctx.header("x-amz-content-sha256",
                              sig.UNSIGNED_PAYLOAD)
        if _is_hex_sha(body_sha):
            ctx.expect_body_sha = body_sha     # enforced by read_body
        body = ctx.read_body()
        form = {k: v[0] for k, v in
                urllib.parse.parse_qs(body.decode(errors="replace")).items()}
        action = form.get("Action", "")
        try:
            duration = int(form.get("DurationSeconds", "3600"))
        except ValueError:
            raise S3Error("InvalidArgument", "bad DurationSeconds") from None

        if action == "AssumeRole":
            # SigV4 over the form body (service "sts" or "s3" both
            # accepted); any valid non-temporary user may assume a role
            # — the minted credential inherits the PARENT's policies,
            # so no policy check gates the call itself
            cred = sig.verify_v4(ctx.req, self._cred_lookup, self.region,
                                 body_sha)
            if cred.is_temp():
                raise S3Error("AccessDenied",
                              "temporary credentials cannot assume roles")
            minted = self.iam.assume_role(cred, duration)
            return self._sts_response(action, minted)

        if action in ("AssumeRoleWithWebIdentity",
                      "AssumeRoleWithClientGrants"):
            from ..iam.providers import STSValidationError
            token = form.get("WebIdentityToken") or form.get("Token", "")
            if not token:
                raise S3Error("InvalidArgument", "missing identity token")
            provider = self._openid_provider()
            if provider is None:
                raise S3Error("NotImplemented",
                              "OpenID is not configured")
            try:
                claims = provider.validate(token)
            except STSValidationError as e:
                raise S3Error("AccessDenied", str(e)) from None
            policies = provider.policy_names(claims)
            if not policies:
                # no policy claim -> no permissions mapping; reject like
                # the reference (policy claim is mandatory)
                raise S3Error(
                    "AccessDenied",
                    f"token lacks a '{provider.claim_name}' claim")
            subject = str(claims.get("sub") or claims.get("email") or "")
            if not subject:
                raise S3Error("AccessDenied", "token lacks sub claim")
            # minted credentials never outlive the token that
            # authenticated them
            import time as _time
            minted = self.iam.assume_role_with_claims(
                f"oidc:{subject}", policies, duration,
                max_seconds=float(claims["exp"]) - _time.time())
            return self._sts_response(action, minted, subject=subject)

        if action == "AssumeRoleWithLDAPIdentity":
            from ..iam.providers import STSValidationError
            provider = self._ldap_provider()
            if provider is None:
                raise S3Error("NotImplemented", "LDAP is not configured")
            try:
                dn = provider.bind(form.get("LDAPUsername", ""),
                                   form.get("LDAPPassword", ""))
            except STSValidationError as e:
                raise S3Error("AccessDenied", str(e)) from None
            # policies: the policy-DB mapping for the DN (set by the
            # admin), never from the client
            minted = self.iam.assume_role_with_claims(
                f"ldap:{dn}", None, duration)
            return self._sts_response(action, minted, subject=dn)

        raise S3Error("InvalidArgument",
                      f"unsupported STS action {action!r}")

    def _openid_provider(self):
        """identity_openid provider from config (rebuilt per call: the
        config may be live-edited via admin set-config)."""
        if getattr(self, "openid_provider", None) is not None:
            return self.openid_provider
        if self.config is None:
            return None
        from ..iam.providers import OpenIDProvider
        p = OpenIDProvider(self.config.get_subsys("identity_openid"))
        return p if p.enabled() else None

    def _ldap_provider(self):
        if getattr(self, "ldap_provider", None) is not None:
            return self.ldap_provider
        if self.config is None:
            return None
        from ..iam.providers import LDAPProvider
        p = LDAPProvider(self.config.get_subsys("identity_ldap"))
        return p if p.enabled() else None

    def _sts_response(self, action: str, minted,
                      subject: str = "") -> HTTPResponse:
        import datetime as _dt
        exp = _dt.datetime.fromtimestamp(
            minted.expiration, _dt.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")
        subject_xml = ""
        if subject and action == "AssumeRoleWithWebIdentity":
            subject_xml = ("<SubjectFromWebIdentityToken>"
                           f"{_sax_escape(subject)}"
                           "</SubjectFromWebIdentityToken>")
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f'<{action}Response xmlns='
            '"https://sts.amazonaws.com/doc/2011-06-15/">'
            f"<{action}Result><Credentials>"
            f"<AccessKeyId>{minted.access_key}</AccessKeyId>"
            f"<SecretAccessKey>{minted.secret_key}</SecretAccessKey>"
            f"<SessionToken>{minted.session_token}</SessionToken>"
            f"<Expiration>{exp}</Expiration>"
            f"</Credentials>{subject_xml}</{action}Result>"
            "<ResponseMetadata><RequestId>"
            f"{uuid.uuid4()}</RequestId></ResponseMetadata>"
            f"</{action}Response>")
        return HTTPResponse(body=xml.encode(),
                            headers={"Content-Type": "application/xml"})

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def handle(self, ctx: RequestContext) -> HTTPResponse:
        # Admission covers the FULL request lifetime — the reference's
        # maxClients gate wraps ServeHTTP including the response body
        # (cmd/handler-api.go:100), so a streaming GET holds its slot
        # until the body is fully written. The event-loop edge admits
        # BEFORE dispatching here (before any body byte was read) and
        # parks its ticket on the context; the threaded frontend admits
        # now — its body reader is lazy, so the decision is still
        # pre-body.
        from .edge.admission import AdmissionTicket
        ticket = getattr(ctx, "admission_ticket", None)
        if ticket is None:
            got = self.admission.admit(ctx.req.method, ctx.req.path,
                                       ctx.req.query, ctx.req.headers)
            if not isinstance(got, AdmissionTicket):
                # shed: 503 SlowDown + Retry-After + Connection: close
                return got.response(ctx.req.path)
            ticket = got
        # QoS data-path metering: the ticket carries the tenant the
        # admission gate resolved; its rx/tx buckets pace the admitted
        # body (which the PUT loop reads into its pinned staging ring
        # through PacedReader.readinto) and the response stream
        tenant = getattr(ticket, "tenant", "")
        if tenant:
            ctx.tenant = tenant
            if ctx.content_length > 0 and ctx.body_stream is not None:
                ctx.body_stream = self.qos.paced_body(tenant,
                                                      ctx.body_stream)
        release = True
        try:
            try:
                resp = self._route(ctx)
            except Exception as e:  # noqa: BLE001 — map to S3 error XML
                return self._error_response(ctx, api_error_from(e))
            # a long_poll stream (ListenBucketNotification) mostly
            # idles: it gives its admission slot back at once
            if resp.stream is not None and not resp.long_poll:
                if tenant:
                    resp.stream = self.qos.paced_stream(tenant,
                                                        resp.stream)
                resp.stream = _ReleasingStream(resp.stream, ticket)
                release = False
            return resp
        finally:
            if release:
                ticket.release()

    def _error_response(self, ctx: RequestContext,
                        err: S3Error) -> HTTPResponse:
        body = xmlgen.error_response(err.code, err.message, ctx.req.path,
                                     str(uuid.uuid4()))
        r = HTTPResponse(status=err.status)
        return r.with_xml(body)

    def _route(self, ctx: RequestContext) -> HTTPResponse:
        path = urllib.parse.unquote(ctx.req.path)
        parts = path.lstrip("/").split("/", 1)
        bucket = parts[0]
        key = parts[1] if len(parts) > 1 else ""
        m = ctx.req.method

        if not bucket:
            if m == "GET":
                return self.list_buckets(ctx)
            if m == "POST":
                return self.handle_sts(ctx)
            raise S3Error("MethodNotAllowed")

        if key:
            return self._route_object(ctx, m, bucket, key)
        return self._route_bucket(ctx, m, bucket)

    def _route_bucket(self, ctx, m, bucket) -> HTTPResponse:
        if m == "GET":
            if ctx.has_query("location"):
                return self.get_bucket_location(ctx, bucket)
            if ctx.has_query("versioning"):
                return self.get_bucket_versioning(ctx, bucket)
            if ctx.has_query("versions"):
                return self.list_object_versions(ctx, bucket)
            if ctx.has_query("uploads"):
                return self.list_multipart_uploads(ctx, bucket)
            if ctx.has_query("policy"):
                return self.get_bucket_policy(ctx, bucket)
            if ctx.has_query("tagging"):
                return self.get_bucket_tagging(ctx, bucket)
            if ctx.has_query("lifecycle"):
                return self.get_bucket_lifecycle(ctx, bucket)
            if ctx.has_query("encryption"):
                return self.get_bucket_encryption(ctx, bucket)
            if ctx.has_query("object-lock"):
                return self.get_object_lock_config(ctx, bucket)
            if ctx.has_query("replication"):
                return self.get_bucket_replication(ctx, bucket)
            if ctx.has_query("notification"):
                return self.get_bucket_notification(ctx, bucket)
            if ctx.has_query("events"):
                return self.listen_bucket_notification(ctx, bucket)
            if ctx.query1("list-type") == "2":
                return self.list_objects_v2(ctx, bucket)
            return self.list_objects_v1(ctx, bucket)
        if m == "PUT":
            if ctx.has_query("versioning"):
                return self.put_bucket_versioning(ctx, bucket)
            if ctx.has_query("policy"):
                return self.put_bucket_policy(ctx, bucket)
            if ctx.has_query("tagging"):
                return self.put_bucket_tagging(ctx, bucket)
            if ctx.has_query("lifecycle"):
                return self.put_bucket_lifecycle(ctx, bucket)
            if ctx.has_query("encryption"):
                return self.put_bucket_encryption(ctx, bucket)
            if ctx.has_query("object-lock"):
                return self.put_object_lock_config(ctx, bucket)
            if ctx.has_query("replication"):
                return self.put_bucket_replication(ctx, bucket)
            if ctx.has_query("notification"):
                return self.put_bucket_notification(ctx, bucket)
            return self.make_bucket(ctx, bucket)
        if m == "HEAD":
            return self.head_bucket(ctx, bucket)
        if m == "DELETE":
            if ctx.has_query("policy"):
                return self.delete_bucket_policy(ctx, bucket)
            if ctx.has_query("tagging"):
                return self.delete_bucket_tagging(ctx, bucket)
            if ctx.has_query("lifecycle"):
                return self.delete_bucket_lifecycle(ctx, bucket)
            if ctx.has_query("encryption"):
                return self.delete_bucket_encryption(ctx, bucket)
            if ctx.has_query("replication"):
                return self.delete_bucket_replication(ctx, bucket)
            return self.delete_bucket(ctx, bucket)
        if m == "POST":
            if ctx.has_query("delete"):
                return self.delete_multiple_objects(ctx, bucket)
            if "multipart/form-data" in ctx.header("content-type"):
                return self.post_policy_upload(ctx, bucket)
        raise S3Error("MethodNotAllowed")

    def post_policy_upload(self, ctx, bucket) -> HTTPResponse:
        """Browser form upload (PostPolicyBucketHandler,
        cmd/bucket-handlers.go)."""
        body = ctx.read_body()
        fields, file_bytes, file_name = pp.parse_multipart_form(
            body, ctx.header("content-type"))
        cred = pp.verify_post_signature(fields, self._cred_lookup,
                                        self.region)
        lower = {k.lower(): v for k, v in fields.items()}
        if cred.is_temp() and \
                lower.get("x-amz-security-token") != cred.session_token:
            raise S3Error("InvalidTokenId")
        key = lower.get("key", "")
        if not key:
            raise S3Error("MalformedPOSTRequest", "missing key field")
        key = key.replace("${filename}", file_name)
        # Bind the policy check to the REQUEST's bucket, not a client-
        # supplied form field (PostPolicyBucketHandler does the same) —
        # otherwise a policy signed for bucket A replays against bucket B.
        fields = {k: v for k, v in fields.items()
                  if k.lower() != "bucket"}
        fields["bucket"] = bucket
        pp.check_post_policy(lower.get("policy", ""), fields,
                             len(file_bytes))
        if self.iam is not None and not self._is_owner(cred):
            if not self.iam.is_allowed(cred, "s3:PutObject", bucket, key,
                                       self._policy_conditions(ctx)):
                raise S3Error("AccessDenied")
        self.obj.get_bucket_info(bucket)
        self._enforce_quota(bucket, len(file_bytes))
        metadata = {"content-type": lower.get(
            "content-type", "application/octet-stream")}
        for k, v in fields.items():
            if k.lower().startswith("x-amz-meta-"):
                metadata["X-Amz-Meta-" +
                         k[len("x-amz-meta-"):].title()] = v
        versioned = self.bucket_meta.versioning_enabled(bucket)
        info = self.obj.put_object(
            bucket, key, file_bytes,
            opts=PutOptions(metadata=metadata, versioned=versioned))
        self._notify("s3:ObjectCreated:Post", bucket, key)
        status = int(lower.get("success_action_status", "204"))
        if status not in (200, 201, 204):
            status = 204
        headers = {"ETag": f'"{info.etag}"',
                   "Location": f"/{bucket}/{key}"}
        if status == 201:
            xml = (f'<?xml version="1.0" encoding="UTF-8"?>'
                   f"<PostResponse><Location>/{bucket}/{key}</Location>"
                   f"<Bucket>{bucket}</Bucket><Key>{key}</Key>"
                   f'<ETag>"{info.etag}"</ETag></PostResponse>')
            return HTTPResponse(status=201, headers=headers,
                                body=xml.encode())
        return HTTPResponse(status=status, headers=headers)

    def _route_object(self, ctx, m, bucket, key) -> HTTPResponse:
        if m == "GET":
            if ctx.has_query("uploadId"):
                return self.list_object_parts(ctx, bucket, key)
            if ctx.has_query("tagging"):
                return self.get_object_tagging(ctx, bucket, key)
            if ctx.has_query("retention"):
                return self.get_object_retention(ctx, bucket, key)
            if ctx.has_query("legal-hold"):
                return self.get_object_legal_hold(ctx, bucket, key)
            return self.get_object(ctx, bucket, key)
        if m == "HEAD":
            return self.head_object(ctx, bucket, key)
        if m == "PUT":
            if ctx.has_query("uploadId") and ctx.has_query("partNumber"):
                if ctx.header("x-amz-copy-source"):
                    return self.copy_object_part(ctx, bucket, key)
                return self.put_object_part(ctx, bucket, key)
            if ctx.has_query("tagging"):
                return self.put_object_tagging(ctx, bucket, key)
            if ctx.has_query("retention"):
                return self.put_object_retention(ctx, bucket, key)
            if ctx.has_query("legal-hold"):
                return self.put_object_legal_hold(ctx, bucket, key)
            if ctx.header("x-amz-copy-source"):
                return self.copy_object(ctx, bucket, key)
            return self.put_object(ctx, bucket, key)
        if m == "POST":
            if ctx.has_query("uploads"):
                return self.new_multipart_upload(ctx, bucket, key)
            if ctx.has_query("uploadId"):
                return self.complete_multipart_upload(ctx, bucket, key)
            if ctx.has_query("restore"):
                return self.restore_object(ctx, bucket, key)
            if ctx.has_query("select") or \
                    ctx.query1("select-type") == "2":
                return self.select_object_content(ctx, bucket, key)
        if m == "DELETE":
            if ctx.has_query("uploadId"):
                return self.abort_multipart_upload(ctx, bucket, key)
            if ctx.has_query("tagging"):
                return self.delete_object_tagging(ctx, bucket, key)
            return self.delete_object(ctx, bucket, key)
        raise S3Error("MethodNotAllowed")

    # ------------------------------------------------------------------
    # service + bucket handlers
    # ------------------------------------------------------------------

    def list_buckets(self, ctx) -> HTTPResponse:
        self.authenticate(ctx, "s3:ListAllMyBuckets")
        return HTTPResponse().with_xml(xmlgen.list_buckets_response(
            "minio", self.obj.list_buckets()))

    def make_bucket(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:CreateBucket", bucket)
        if not _BUCKET_RE.match(bucket) or ".." in bucket:
            raise S3Error("InvalidBucketName")
        body = ctx.read_body()
        if body:
            # LocationConstraint must match our region if present
            try:
                root = ET.fromstring(body)
                loc = root.find(f"{{{xmlgen.S3_XMLNS}}}LocationConstraint")
                loc_txt = (loc.text or "") if loc is not None else ""
                if loc_txt and loc_txt != self.region:
                    raise S3Error("InvalidRegion",
                                  f"region must be {self.region}")
            except ET.ParseError:
                raise S3Error("MalformedXML")
        self.obj.make_bucket(bucket)
        if ctx.header("x-amz-bucket-object-lock-enabled") == "true":
            self.bucket_meta.update(
                bucket, versioning="Enabled",
                object_lock_xml="<ObjectLockConfiguration>"
                "<ObjectLockEnabled>Enabled</ObjectLockEnabled>"
                "</ObjectLockConfiguration>")
        self._notify("s3:BucketCreated:*", bucket, "")
        return HTTPResponse(headers={"Location": f"/{bucket}"})

    def head_bucket(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:ListBucket", bucket)
        self.obj.get_bucket_info(bucket)
        return HTTPResponse()

    def delete_bucket(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:DeleteBucket", bucket)
        force = ctx.header("x-minio-force-delete") == "true"
        self.obj.delete_bucket(bucket, force=force)
        self.bucket_meta.delete(bucket)
        self._notify("s3:BucketRemoved:*", bucket, "")
        return HTTPResponse(status=204)

    def get_bucket_location(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetBucketLocation", bucket)
        self.obj.get_bucket_info(bucket)
        region = "" if self.region == "us-east-1" else self.region
        return HTTPResponse().with_xml(xmlgen.location_response(region))

    def get_bucket_versioning(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetBucketVersioning", bucket)
        self.obj.get_bucket_info(bucket)
        return HTTPResponse().with_xml(xmlgen.versioning_response(
            self.bucket_meta.get(bucket).versioning))

    def put_bucket_versioning(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutBucketVersioning", bucket)
        self.obj.get_bucket_info(bucket)
        body = ctx.read_body()
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        status_el = root.find(f"{{{xmlgen.S3_XMLNS}}}Status")
        if status_el is None:
            status_el = root.find("Status")
        status = (status_el.text or "") if status_el is not None else ""
        if status not in ("Enabled", "Suspended"):
            raise S3Error("MalformedXML", "bad versioning status")
        self.bucket_meta.update(bucket, versioning=status)
        return HTTPResponse()

    # --- policy / tagging / configs ------------------------------------

    def get_bucket_policy(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetBucketPolicy", bucket)
        self.obj.get_bucket_info(bucket)
        pj = self.bucket_meta.get(bucket).policy_json
        if not pj:
            raise S3Error("NoSuchBucketPolicy")
        return HTTPResponse(headers={"Content-Type": "application/json"},
                            body=pj.encode())

    def put_bucket_policy(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutBucketPolicy", bucket)
        self.obj.get_bucket_info(bucket)
        body = ctx.read_body()
        try:
            json.loads(body)
        except ValueError:
            raise S3Error("MalformedPolicy", "policy is not JSON")
        self.bucket_meta.update(bucket, policy_json=body.decode())
        return HTTPResponse(status=204)

    def delete_bucket_policy(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:DeleteBucketPolicy", bucket)
        self.obj.get_bucket_info(bucket)
        self.bucket_meta.update(bucket, policy_json="")
        return HTTPResponse(status=204)

    def get_bucket_tagging(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetBucketTagging", bucket)
        self.obj.get_bucket_info(bucket)
        tags = self.bucket_meta.get(bucket).tagging
        if not tags:
            raise S3Error("NoSuchTagSet")
        return HTTPResponse().with_xml(xmlgen.tagging_response(tags))

    def put_bucket_tagging(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutBucketTagging", bucket)
        self.obj.get_bucket_info(bucket)
        tags = _parse_tagging_xml(ctx.read_body())
        self.bucket_meta.update(bucket, tagging=tags)
        return HTTPResponse()

    def delete_bucket_tagging(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutBucketTagging", bucket)
        self.obj.get_bucket_info(bucket)
        self.bucket_meta.update(bucket, tagging={})
        return HTTPResponse(status=204)

    def get_object_lock_config(self, ctx, bucket):
        return self._xml_config(ctx, bucket, "object_lock_xml",
                                "s3:GetBucketObjectLockConfiguration",
                                "NoSuchObjectLockConfiguration")

    def put_object_lock_config(self, ctx, bucket):
        return self._put_xml_config(ctx, bucket, "object_lock_xml",
                                    "s3:PutBucketObjectLockConfiguration")

    def get_bucket_replication(self, ctx, bucket):
        return self._xml_config(ctx, bucket, "replication_xml",
                                "s3:GetReplicationConfiguration",
                                "ReplicationConfigurationNotFoundError")

    def put_bucket_replication(self, ctx, bucket):
        return self._put_xml_config(ctx, bucket, "replication_xml",
                                    "s3:PutReplicationConfiguration")

    def delete_bucket_replication(self, ctx, bucket):
        return self._del_xml_config(ctx, bucket, "replication_xml",
                                    "s3:PutReplicationConfiguration")

    def _xml_config(self, ctx, bucket, field: str, action: str,
                    missing_code: str) -> HTTPResponse:
        self.authenticate(ctx, action, bucket)
        self.obj.get_bucket_info(bucket)
        xml_doc = getattr(self.bucket_meta.get(bucket), field)
        if not xml_doc:
            raise S3Error(missing_code)
        return HTTPResponse(headers={"Content-Type": "application/xml"},
                            body=xml_doc.encode())

    def _put_xml_config(self, ctx, bucket, field: str,
                        action: str) -> HTTPResponse:
        self.authenticate(ctx, action, bucket)
        self.obj.get_bucket_info(bucket)
        body = ctx.read_body()
        try:
            ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        self.bucket_meta.update(bucket, **{field: body.decode()})
        return HTTPResponse()

    def _del_xml_config(self, ctx, bucket, field: str,
                        action: str) -> HTTPResponse:
        self.authenticate(ctx, action, bucket)
        self.obj.get_bucket_info(bucket)
        self.bucket_meta.update(bucket, **{field: ""})
        return HTTPResponse(status=204)

    def get_bucket_lifecycle(self, ctx, bucket):
        return self._xml_config(ctx, bucket, "lifecycle_xml",
                                "s3:GetLifecycleConfiguration",
                                "NoSuchLifecycleConfiguration")

    def put_bucket_lifecycle(self, ctx, bucket):
        return self._put_xml_config(ctx, bucket, "lifecycle_xml",
                                    "s3:PutLifecycleConfiguration")

    def delete_bucket_lifecycle(self, ctx, bucket):
        return self._del_xml_config(ctx, bucket, "lifecycle_xml",
                                    "s3:PutLifecycleConfiguration")

    def get_bucket_encryption(self, ctx, bucket):
        return self._xml_config(
            ctx, bucket, "sse_config_xml", "s3:GetEncryptionConfiguration",
            "ServerSideEncryptionConfigurationNotFoundError")

    def put_bucket_encryption(self, ctx, bucket):
        return self._put_xml_config(ctx, bucket, "sse_config_xml",
                                    "s3:PutEncryptionConfiguration")

    def delete_bucket_encryption(self, ctx, bucket):
        return self._del_xml_config(ctx, bucket, "sse_config_xml",
                                    "s3:PutEncryptionConfiguration")

    # --- bucket notification --------------------------------------------

    def listen_bucket_notification(self, ctx, bucket) -> HTTPResponse:
        """Live event stream for one bucket (ListenBucketNotification,
        cmd/listen-notification-handlers.go): ND-JSON event records,
        filtered by prefix/suffix/event-name query params, ends after an
        idle window."""
        import fnmatch as _fn
        import json as _json
        self.authenticate(ctx, "s3:ListenBucketNotification", bucket)
        self.obj.get_bucket_info(bucket)
        if self.events is None:
            raise S3Error("NotImplemented", "event system not running")
        prefix = ctx.query1("prefix")
        suffix = ctx.query1("suffix")
        patterns = ctx.req.query.get("events") or ["*"]
        try:
            idle = float(ctx.query1("idle", "10") or 10)
        except ValueError:
            raise S3Error("InvalidArgument", "bad idle value") from None
        idle = min(max(idle, 1.0), 3600.0)
        hub = self.events.hub

        def stream():
            with hub.subscribe() as sub:
                while True:
                    item = sub.get(timeout=idle)
                    if item is None:
                        return
                    b, record = item
                    if b != bucket:
                        continue
                    rec = record["Records"][0]
                    key = rec["s3"]["object"]["key"]
                    if prefix and not key.startswith(prefix):
                        continue
                    if suffix and not key.endswith(suffix):
                        continue
                    if not any(_fn.fnmatchcase(rec["eventName"], p)
                               or p == "*"
                               for p in patterns):
                        continue
                    yield (_json.dumps(record) + "\n").encode()

        return HTTPResponse(
            headers={"Content-Type": "application/x-ndjson"},
            stream=stream(), long_poll=True)

    def get_bucket_notification(self, ctx, bucket):
        self.authenticate(ctx, "s3:GetBucketNotification", bucket)
        self.obj.get_bucket_info(bucket)
        doc = self.bucket_meta.get(bucket).notification_xml
        if not doc:
            doc = ('<?xml version="1.0" encoding="UTF-8"?>'
                   f'<NotificationConfiguration xmlns="{xmlgen.S3_XMLNS}"/>')
        return HTTPResponse(headers={"Content-Type": "application/xml"},
                            body=doc.encode())

    def put_bucket_notification(self, ctx, bucket):
        self.authenticate(ctx, "s3:PutBucketNotification", bucket)
        self.obj.get_bucket_info(bucket)
        body = ctx.read_body()
        try:
            ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        if self.notify is not None:
            # configs naming unknown target ARNs or event names are
            # refused at PUT time (ErrARNNotification /
            # ErrEventNotification): a rule that can never fire is a
            # config error, not a silent no-op. The legacy notifier's
            # config-driven targets stay valid.
            from ..notify.rules import BucketNotifyConfig, NotifyRuleError
            try:
                cfg = BucketNotifyConfig.from_xml(body)
            except NotifyRuleError as e:
                raise S3Error("MalformedXML", str(e)) from None
            known = self.notify.registry.arns()
            legacy = getattr(self.events, "targets", None) or {}
            for rule in cfg.rules:
                if rule.arn not in known and rule.arn not in legacy:
                    raise S3Error(
                        "InvalidArgument",
                        f"unknown notification target ARN {rule.arn}")
            bad = cfg.unknown_events()
            if bad:
                raise S3Error(
                    "InvalidArgument",
                    f"unsupported notification event(s): "
                    f"{', '.join(sorted(set(bad)))}")
        self.bucket_meta.update(bucket, notification_xml=body.decode())
        return HTTPResponse()

    # --- listings -------------------------------------------------------

    def list_objects_v1(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:ListBucket", bucket)
        prefix = ctx.query1("prefix")
        marker = ctx.query1("marker")
        delimiter = ctx.query1("delimiter")
        enc = ctx.query1("encoding-type")
        max_keys = _parse_max_keys(ctx.query1("max-keys", "1000"))
        if max_keys == 0:
            self.obj.get_bucket_info(bucket)
            objs, prefixes, trunc = [], [], False
        else:
            objs, prefixes, trunc = self.obj.list_objects(
                bucket, prefix, marker, delimiter, max_keys)
        next_marker = ""
        if trunc:
            if objs and (not prefixes or objs[-1].name > prefixes[-1]):
                next_marker = objs[-1].name
            elif prefixes:
                next_marker = prefixes[-1]
        return HTTPResponse().with_xml(xmlgen.list_objects_v1_response(
            bucket, prefix, marker, delimiter, max_keys, enc, objs,
            prefixes, trunc, next_marker))

    def list_objects_v2(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:ListBucket", bucket)
        prefix = ctx.query1("prefix")
        delimiter = ctx.query1("delimiter")
        enc = ctx.query1("encoding-type")
        start_after = ctx.query1("start-after")
        token = ctx.query1("continuation-token")
        fetch_owner = ctx.query1("fetch-owner") == "true"
        max_keys = _parse_max_keys(ctx.query1("max-keys", "1000"))
        marker = _decode_token(token) if token else start_after
        if max_keys == 0:
            self.obj.get_bucket_info(bucket)
            objs, prefixes, trunc = [], [], False
        else:
            objs, prefixes, trunc = self.obj.list_objects(
                bucket, prefix, marker, delimiter, max_keys)
        next_token = ""
        if trunc:
            last = objs[-1].name if objs else (prefixes[-1] if prefixes
                                               else "")
            next_token = _encode_token(last)
        return HTTPResponse().with_xml(xmlgen.list_objects_v2_response(
            bucket, prefix, delimiter, max_keys, enc, start_after, token,
            next_token, objs, prefixes, trunc, fetch_owner))

    def list_object_versions(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:ListBucketVersions", bucket)
        prefix = ctx.query1("prefix")
        key_marker = ctx.query1("key-marker")
        vid_marker = ctx.query1("version-id-marker")
        delimiter = ctx.query1("delimiter")
        enc = ctx.query1("encoding-type")
        max_keys = _parse_max_keys(ctx.query1("max-keys", "1000"))
        if max_keys == 0:
            self.obj.get_bucket_info(bucket)
            versions, prefixes, nkm, nvm, trunc = [], [], "", "", False
        else:
            # a version-id-marker without a key-marker is meaningless
            # (S3 rejects it; we ignore it) — and the object layer
            # handles the "null" wire form of the empty version id
            versions, prefixes, nkm, nvm, trunc = \
                self.obj.list_object_versions(
                    bucket, prefix, key_marker, max_keys,
                    vid_marker if key_marker else "", delimiter)
        return HTTPResponse().with_xml(xmlgen.list_versions_response(
            bucket, prefix, key_marker, vid_marker, delimiter, max_keys,
            enc, versions, prefixes, trunc, nkm, nvm))

    def delete_multiple_objects(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:DeleteObject", bucket)
        self.obj.get_bucket_info(bucket)  # missing bucket -> 404, not 200
        body = ctx.read_body()
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        quiet = False
        keys: list[tuple[str, str]] = []
        for child in root:
            tag = child.tag.split("}")[-1]
            if tag == "Quiet":
                quiet = (child.text or "").strip() == "true"
            elif tag == "Object":
                key_el = vid = None
                for sub in child:
                    st = sub.tag.split("}")[-1]
                    if st == "Key":
                        key_el = sub.text or ""
                    elif st == "VersionId":
                        vid = sub.text or ""
                if key_el:
                    keys.append((key_el, vid or ""))
        if len(keys) > 1000:
            raise S3Error("MalformedXML", "too many objects (max 1000)")
        versioned = self.bucket_meta.versioning_enabled(bucket)
        # a batch delete frees remote tier copies as the single DELETE
        # does (the same gate: only when a DATA version goes)
        tiers_live = self.tiers is not None \
            and getattr(self.tiers, "tiers", None)
        deleted, errors = [], []
        for key, vid in keys:
            if vid == "null":
                vid = ""  # same normalization as single DELETE
            tiered_md = None
            if tiers_live and (vid or not versioned):
                try:
                    tiered_md = self.obj.get_object_info(
                        bucket, key,
                        GetOptions(version_id=vid)).user_defined or {}
                except oerr.ObjectApiError:
                    pass
            try:
                # a locked version fails its own entry (departure: the
                # reference's DeleteObjects removes it)
                self._enforce_object_lock(ctx, bucket, key, vid, versioned)
                res = self.obj.delete_object(bucket, key, version_id=vid,
                                             versioned=versioned)
                entry = {"key": key, "version_id": vid}
                if isinstance(res, ObjectInfo) and res.delete_marker:
                    entry["delete_marker"] = True
                    entry["delete_marker_version"] = res.version_id
                deleted.append(entry)
                if tiered_md is not None:
                    tier_transition.free_remote(self.tiers, tiered_md)
                self._notify("s3:ObjectRemoved:Delete", bucket, key)
            except oerr.ObjectNotFound:
                deleted.append({"key": key, "version_id": vid})
            except Exception as e:  # noqa: BLE001 — per-key error entry
                ae = api_error_from(e)
                errors.append({"key": key, "code": ae.code,
                               "message": ae.message})
        if quiet:
            deleted = []
        return HTTPResponse().with_xml(
            xmlgen.delete_objects_response(deleted, errors))

    def list_multipart_uploads(self, ctx, bucket) -> HTTPResponse:
        self.authenticate(ctx, "s3:ListBucketMultipartUploads", bucket)
        self.obj.get_bucket_info(bucket)
        prefix = ctx.query1("prefix")
        max_uploads = _parse_max_keys(ctx.query1("max-uploads", "1000"))
        uploads = self.obj.list_multipart_uploads(bucket)
        if prefix:
            uploads = [u for u in uploads
                       if u["object"].startswith(prefix)]
        trunc = len(uploads) > max_uploads
        uploads = uploads[:max_uploads]
        nkm = uploads[-1]["object"] if trunc and uploads else ""
        num = uploads[-1]["upload_id"] if trunc and uploads else ""
        return HTTPResponse().with_xml(
            xmlgen.list_multipart_uploads_response(
                bucket, "", "", prefix, "", max_uploads, trunc, uploads,
                nkm, num))

    # ------------------------------------------------------------------
    # object handlers
    # ------------------------------------------------------------------

    def _put_reader(self, ctx) -> tuple[HashReader, int]:
        """Build the verified PUT stream: content-md5 / x-amz-content-
        sha256 expectations + streaming-signature decoding
        (cmd/object-handlers.go:1343-1435). The body reader's
        ``readinto`` is the seam through which the PUT loop reads the
        socket straight into its pinned staging ring."""
        size = ctx.content_length
        md5_hex = ""
        cm = ctx.header("content-md5")
        if cm:
            try:
                md5_hex = binascii.hexlify(
                    base64.b64decode(cm, validate=True)).decode()
            except (binascii.Error, ValueError):
                raise S3Error("InvalidDigest")
        sha_hex = ""
        body_sha = ctx.header("x-amz-content-sha256")
        stream = ctx.body_stream
        if ctx.auth_type == sig.AUTH_STREAMING_SIGNED:
            decoded = ctx.header("x-amz-decoded-content-length")
            if not decoded:
                raise S3Error("MissingContentLength")
            try:
                size = int(decoded)
            except ValueError:
                raise S3Error("InvalidArgument",
                              "bad x-amz-decoded-content-length")
            stream = sig.new_chunked_reader(ctx.req, ctx.body_stream,
                                            ctx.cred)
        elif body_sha and body_sha not in (sig.UNSIGNED_PAYLOAD, ""):
            sha_hex = body_sha
        if size < 0:
            raise S3Error("MissingContentLength")
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        return HashReader(stream, size, md5_hex=md5_hex,
                          sha256_hex=sha_hex), size

    def put_object(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObject", bucket, key)
        self.obj.get_bucket_info(bucket)
        if ctx.header("x-minio-tpu-repl-spec"):
            # internal replication apply (the reference's
            # x-minio-source-* peer headers): a version-faithful write
            # carrying explicit identity — owner credential only
            return self._repl_apply(ctx, bucket, key)
        # _put_reader resolves the true payload size (including
        # x-amz-decoded-content-length for aws-chunked streams, where
        # Content-Length covers the chunk framing) — quota must gate on
        # that, or chunked PUTs bypass it entirely.
        reader, size = self._put_reader(ctx)
        self._enforce_quota(bucket, size)
        metadata = _extract_metadata(ctx)
        if ctx.header("x-amz-tagging"):
            metadata["X-Amz-Tagging"] = ctx.header("x-amz-tagging")
        reader, size, sse_headers, sse_spec = self._apply_put_transforms(
            ctx, key, reader, size, metadata)
        # object lock: explicit headers win; else the bucket default
        olock.retention_headers_from_request(ctx.header, metadata)
        lock_cfg = self.bucket_meta.get(bucket).object_lock_xml
        if lock_cfg and olock.MD_MODE not in metadata:
            olock.DefaultRetention.from_config_xml(lock_cfg).apply_to(
                metadata)
        versioned = self.bucket_meta.versioning_enabled(bucket)
        info = self.obj.put_object(
            bucket, key, reader, size,
            PutOptions(metadata=metadata, versioned=versioned,
                       sse_spec=sse_spec))
        headers = {"ETag": f'"{info.etag}"', **sse_headers}
        if info.version_id and info.version_id != "null":
            headers["x-amz-version-id"] = info.version_id
        self._notify("s3:ObjectCreated:Put", bucket, key)
        return HTTPResponse(headers=headers)

    def _repl_apply(self, ctx, bucket, key) -> HTTPResponse:
        """Apply one replicated version with full fidelity (identity,
        part boundaries, markers, transitioned stubs as metadata) —
        the HTTPReplClient's server side. Owner credential only: the
        spec header carries internal metadata and explicit version
        identity no ordinary client may set. A data version's body is
        read whole and replayed through the layer's PUT, so a version
        past the codec's device gate encodes on the card."""
        if self.iam is not None and ctx.cred is not None and \
                not self._is_owner(ctx.cred):
            raise S3Error("AccessDenied",
                          "replication apply needs the owner credential")
        from ..object.faithful import VersionSpec
        from ..replicate.client import LayerReplClient, ReplClientError
        try:
            spec = VersionSpec.from_dict(json.loads(
                base64.urlsafe_b64decode(
                    ctx.header("x-minio-tpu-repl-spec").encode())
                .decode()))
        except (ValueError, KeyError, TypeError):
            raise S3Error("InvalidArgument",
                          "bad replication spec header") from None
        body = ctx.read_body()
        if not spec.delete_marker and not spec.transitioned_stub \
                and len(body) != spec.size:
            raise S3Error("IncompleteBody")
        site = ""
        if self.replication is not None:
            site = getattr(getattr(self.replication, "registry", None),
                           "site_id", "")
        client = LayerReplClient(self.obj, bucket, site)
        try:
            result = client.apply_version(
                key, spec, reader_factory=lambda: io.BytesIO(body))
        except ReplClientError as e:
            raise S3Error("InternalError", str(e)) from None
        if result == "applied":
            self._notify("s3:ObjectCreated:Replication", bucket, key)
        return HTTPResponse(
            body=json.dumps({"result": result}).encode(),
            headers={"Content-Type": "application/json"})

    def _apply_put_transforms(self, ctx, key, reader, size, metadata
                              ) -> tuple:
        """Compression + SSE wrapping of the PUT stream (reference
        newS2CompressReader + EncryptRequest wiring,
        cmd/object-handlers.go:1452-1470). Returns (reader, size,
        response headers, sse_spec) — sse_spec rides PutOptions into the
        engine when the fused device cipher path takes the stream
        instead of a host transform here."""
        ssec_key = sse.parse_ssec_headers(ctx.header)
        sse_s3 = self._sse_s3_requested(ctx, ssec_key)
        compress = (self.compression_enabled
                    and sse.is_compressible(
                        key, metadata.get("content-type", "")))
        if ssec_key is None and not sse_s3 and not compress:
            return reader, size, {}, None
        reader2, size2, spec = sse.setup_put_transforms(
            key_name=key, raw_reader=reader, raw_size=size,
            metadata=metadata, ssec_key=ssec_key, sse_s3=sse_s3,
            kms=self.kms, compress=compress,
            compress_algo=self._compress_algo(),
            device_sse=getattr(self.obj, "supports_sse_device", False))
        headers = {}
        if sse_s3:
            headers["x-amz-server-side-encryption"] = "AES256"
        elif ssec_key is not None:
            headers["x-amz-server-side-encryption-customer-algorithm"] = \
                "AES256"
            headers["x-amz-server-side-encryption-customer-key-md5"] = \
                metadata.get(sse.MK_KEYMD5, "")
        return reader2, size2, headers, spec

    def _obj_response_headers(self, info: ObjectInfo) -> dict[str, str]:
        h = {
            "ETag": f'"{info.etag}"',
            "Last-Modified": _http_date(info.mod_time),
            "Content-Type": info.content_type or
            "application/octet-stream",
            "Accept-Ranges": "bytes",
        }
        if info.content_encoding:
            h["Content-Encoding"] = info.content_encoding
        if info.version_id and info.version_id != "null":
            h["x-amz-version-id"] = info.version_id
        for k, v in info.user_defined.items():
            lk = k.lower()
            if lk.startswith("x-amz-meta-"):
                h[k] = v
            elif lk in ("cache-control", "content-disposition",
                        "content-language", "expires"):
                h[k] = v
        md = info.user_defined or {}
        if dt.is_transitioned(md):
            # a transitioned object reports its TIER as its storage class
            # and its restore state (S3's GLACIER semantics)
            h["x-amz-storage-class"] = md.get(dt.TRANSITION_TIER_KEY, "")
            if md.get(dt.RESTORE_KEY):
                h["x-amz-restore"] = md[dt.RESTORE_KEY]
        if info.delete_marker:
            h["x-amz-delete-marker"] = "true"
        return h

    def _check_preconditions(self, ctx, info: ObjectInfo) -> Optional[int]:
        """Conditional header evaluation; returns an HTTP status to
        short-circuit with, or None (cmd/object-handlers-common.go)."""
        inm = ctx.header("if-none-match")
        im = ctx.header("if-match")
        etag = info.etag
        if im and im.strip('"') != etag:
            return 412
        if inm and inm.strip('"') == etag:
            return 304
        ims = ctx.header("if-modified-since")
        if ims and not inm:
            try:
                t = parsedate_to_datetime(ims).timestamp()
                if info.mod_time <= t:
                    return 304
            except (TypeError, ValueError):
                pass
        ius = ctx.header("if-unmodified-since")
        if ius and not im:
            try:
                t = parsedate_to_datetime(ius).timestamp()
                if info.mod_time > t:
                    return 412
            except (TypeError, ValueError):
                pass
        return None

    def get_object(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetObject", bucket, key)
        vid = ctx.query1("versionId")
        opts = GetOptions(version_id="" if vid == "null" else vid)
        info = self.obj.get_object_info(bucket, key, opts)
        short = self._check_preconditions(ctx, info)
        if short is not None:
            return HTTPResponse(status=short,
                                headers=self._obj_response_headers(info))
        md = info.user_defined or {}
        if dt.is_transitioned(md) and not dt.is_restored(md):
            # before any transform: a transformed GET reads the layer
            # only once the response has started
            raise oerr.InvalidObjectState(
                f"{bucket}/{key} is archived in a remote tier; restore "
                "it first")
        if md.get(sse.MK_SSE) or sse.stored_compression(md):
            return self._get_transformed(ctx, bucket, key, info, opts, md)
        rng = _parse_range(ctx.header("range"), info.size)
        offset, length = (0, info.size) if rng is None else rng
        info, stream = self.obj.get_object(bucket, key, offset, length,
                                           opts)
        headers = self._obj_response_headers(info)
        headers["Content-Length"] = str(length)
        status = 200
        if rng is not None:
            status = 206
            headers["Content-Range"] = (
                f"bytes {offset}-{offset + length - 1}/{info.size}")
        # response header overrides (presigned GET)
        for qk, hk in (("response-content-type", "Content-Type"),
                       ("response-content-disposition",
                        "Content-Disposition"),
                       ("response-cache-control", "Cache-Control"),
                       ("response-content-encoding", "Content-Encoding"),
                       ("response-content-language", "Content-Language")):
            if ctx.query1(qk):
                headers[hk] = ctx.query1(qk)
        self._notify("s3:ObjectAccessed:Get", bucket, key)
        return HTTPResponse(status=status, headers=headers, stream=stream)

    def _compress_algo(self) -> str:
        return sse.COMPRESS_ZSTD if self.compression_algorithm == \
            "zstd" else sse.COMPRESS_S2

    def _get_transformed(self, ctx, bucket, key, info, opts, md
                         ) -> HTTPResponse:
        """GET of an encrypted and/or compressed object: decrypt the
        covering package range / decompress, then trim to the requested
        plaintext range (reference DecryptBlocksRequestR + s2 reader
        stack, cmd/object-api-utils.go:626-697)."""
        enc = sse.resolve_get_key(md, ctx.header, self.kms)
        compressed = bool(sse.stored_compression(md))
        actual = self._plain_size(info, md)
        rng = _parse_range(ctx.header("range"), actual)
        offset, length = (0, actual) if rng is None else rng

        if actual <= 0 or length <= 0:
            stream = iter(())
        elif enc is not None and md.get(sse.MK_SSE_MP) and info.parts:
            # multipart SSE: parts are independent package streams under
            # per-part nonces; walk the parts covering the range
            stream = self._mp_decrypt_stream(opts, bucket, key, info,
                                             enc, offset, length)
        elif compressed:
            # compressed payloads have no random access: decode from the
            # start and skip (the reference's s2 path does the same)
            stream = self._stored_plaintext(bucket, key, info, opts, enc)
            stream = sse.decompress_stream(
                stream, sse.stored_compression(md) or sse.COMPRESS_ZSTD)
            stream = _skip_take(stream, offset, length)
        elif sse.stored_sse_cipher(md) == sse.CIPHER_CHACHA:
            # detached-tag stream: ciphertext offsets match plaintext
            # 1:1 and the tag trailer sits at the end — the ranged
            # helper pulls both through the fetch seam and verifies
            # every covering package BEFORE its keystream XOR
            stream = sse.chacha_decrypt_ranged(
                self._obj_fetch(bucket, key, opts), info.size,
                enc[0], enc[1], offset, length, device=self.obj.device,
                scheduler=self.obj.scheduler)
            stream = _skip_take(stream, offset % sse.PKG_SIZE, length)
        else:
            # package-aligned ciphertext range
            pkg_full = sse.PKG_SIZE + sse.TAG_SIZE
            start_pkg = offset // sse.PKG_SIZE
            end_pkg = (offset + length - 1) // sse.PKG_SIZE
            coff = start_pkg * pkg_full
            clen = min(info.size - coff,
                       (end_pkg - start_pkg + 1) * pkg_full)
            _, stream = self.obj.get_object(bucket, key, coff, clen, opts)
            stream = sse.decrypt_stream(stream, enc[0], enc[1],
                                        start_seq=start_pkg)
            stream = _skip_take(stream, offset - start_pkg * sse.PKG_SIZE,
                                length)

        headers = self._obj_response_headers(info)
        headers.update(self._sse_response_headers(md))
        headers["Content-Length"] = str(length)
        status = 200
        if rng is not None:
            status = 206
            headers["Content-Range"] = (
                f"bytes {offset}-{offset + length - 1}/{actual}")
        self._notify("s3:ObjectAccessed:Get", bucket, key)
        return HTTPResponse(status=status, headers=headers, stream=stream)

    def _multipart_meta(self, bucket: str, key: str,
                        upload_id: str) -> dict:
        """Session metadata with a bounded cache (immutable after
        create; avoids one journal read per part upload)."""
        cache_key = f"{bucket}/{key}/{upload_id}"
        md = self._mpu_meta.get(cache_key)
        if md is None:
            md = self.obj.get_multipart_info(bucket, key, upload_id)
            self._mpu_meta[cache_key] = md
            while len(self._mpu_meta) > 1024:
                self._mpu_meta.popitem(last=False)
        return md

    def _mpu_sse_key(self, bucket: str, key: str, upload_id: str,
                     md: dict, ctx) -> tuple:
        """Resolved (oek, nonce_base) for a multipart SSE session.
        SSE-S3 resolutions are cached per upload (one KMS round trip per
        upload, not one per part). SSE-C is NEVER cached: each part
        request must present (and re-verify) the client's key headers."""
        if md.get(sse.MK_SSE) != "S3":
            return sse.resolve_get_key(md, ctx.header, self.kms)
        cache_key = f"{bucket}/{key}/{upload_id}"
        enc = self._mpu_keys.get(cache_key)
        if enc is None:
            enc = sse.resolve_get_key(md, ctx.header, self.kms)
            self._mpu_keys[cache_key] = enc
            while len(self._mpu_keys) > 1024:
                self._mpu_keys.popitem(last=False)
        return enc

    def _sse_s3_requested(self, ctx, ssec_key) -> bool:
        """Validate x-amz-server-side-encryption: only AES256 (SSE-S3)
        is supported — aws:kms etc. must error, never silently store
        plaintext after an encryption request."""
        algo = ctx.header("x-amz-server-side-encryption")
        if not algo or ssec_key is not None:
            return False
        if algo != "AES256":
            raise S3Error("NotImplemented",
                          f"server-side encryption {algo!r} is not "
                          "supported (use AES256)")
        return True

    def _obj_fetch(self, bucket, key, opts, base: int = 0):
        """fetch(off, len) -> stored-byte chunk iterator, the read seam
        chacha_decrypt_ranged pulls ciphertext and tag-trailer ranges
        through (offset by `base` for a part inside a multipart
        object)."""
        def fetch(off, ln):
            _, st = self.obj.get_object(bucket, key, base + off, ln,
                                        opts)
            return st
        return fetch

    def _chacha_full_stream(self, bucket, key, info, opts, enc
                            ) -> Iterator[bytes]:
        """Whole-object verify-then-decrypt of a detached-tag chacha
        stream (the cipher's plaintext length comes from the stored
        size — under compression it is the compressed length, which
        metadata does not record)."""
        ct_len, _ = sse.chacha_ct_len(info.size)
        return sse.chacha_decrypt_ranged(
            self._obj_fetch(bucket, key, opts), info.size,
            enc[0], enc[1], 0, ct_len, device=self.obj.device,
            scheduler=self.obj.scheduler)

    def _stored_plaintext(self, bucket, key, info, opts, enc
                          ) -> Iterator[bytes]:
        """The whole stored stream, deciphered when `enc` is an object key
        (a compressed object's compressed bytes)."""
        if enc is not None and \
                sse.stored_sse_cipher(info.user_defined or {}) == \
                sse.CIPHER_CHACHA:
            return self._chacha_full_stream(bucket, key, info, opts, enc)
        _, stream = self.obj.get_object(bucket, key, 0, info.size, opts)
        if enc is not None:
            stream = sse.decrypt_stream(stream, enc[0], enc[1])
        return stream

    def _plaintext_stream(self, bucket, key, info, header, opts
                          ) -> tuple[Iterator[bytes], int]:
        """Full plaintext stream + size of a stored object, decrypting and
        decompressing as its metadata requires (the copy source's and
        Select's decode stack; the ranged S3 GET keeps its own
        package-range arithmetic in _get_transformed). `header` is a
        callable(name, default="") supplying SSE-C key headers; without
        them an SSE-C object raises AccessDenied from resolve_get_key."""
        md = info.user_defined or {}
        if not (md.get(sse.MK_SSE) or sse.stored_compression(md)):
            _, stream = self.obj.get_object(bucket, key, 0, info.size,
                                            opts)
            return stream, info.size
        enc = sse.resolve_get_key(md, header, self.kms)
        plain_size = self._plain_size(info, md)
        if enc is not None and md.get(sse.MK_SSE_MP) and info.parts:
            return (self._mp_decrypt_stream(opts, bucket, key, info,
                                            enc, 0, plain_size),
                    plain_size)
        stream = self._stored_plaintext(bucket, key, info, opts, enc)
        if sse.stored_compression(md):
            stream = sse.decompress_stream(
                stream, sse.stored_compression(md) or sse.COMPRESS_ZSTD)
        return stream, plain_size

    def _copy_source_plaintext(self, ctx, src_bucket, src_key, src_info,
                               opts) -> tuple[Iterator[bytes], int]:
        """Plaintext stream + size of a copy source, decrypting with the
        x-amz-copy-source-* SSE-C headers (or the master key) and
        decompressing as needed."""

        def src_header(name, default=""):
            prefix = "x-amz-server-side-encryption-customer"
            if name.startswith(prefix):
                return ctx.header(
                    "x-amz-copy-source-server-side-encryption-customer"
                    + name[len(prefix):], default)
            return ctx.header(name, default)

        return self._plaintext_stream(src_bucket, src_key, src_info,
                                      src_header, opts)

    @staticmethod
    def _plain_size(info, md: dict) -> int:
        if md.get(sse.MK_SSE_MP) and info.parts:
            return sum(p.actual_size for p in info.parts)
        return int(md.get(sse.MK_ACTUAL, info.size))

    def _mp_decrypt_stream(self, opts, bucket, key, info, enc,
                           offset: int, length: int) -> Iterator[bytes]:
        """Decrypt a multipart-SSE object across part boundaries
        (DecryptBlocksRequestR's part walk, cmd/encryption-v1.go:356).
        Each part is an independent package stream under a per-part
        nonce — either cipher's layout, per the object's metadata."""
        pkg_full = sse.PKG_SIZE + sse.TAG_SIZE
        chacha = sse.stored_sse_cipher(info.user_defined or {}) == \
            sse.CIPHER_CHACHA

        def gen():
            remaining = length
            want = offset
            plain_start = 0
            cipher_start = 0
            for p in info.parts:
                psize, csize = p.actual_size, p.size
                plain_end = plain_start + psize
                if remaining <= 0:
                    return
                if plain_end <= want:
                    plain_start = plain_end
                    cipher_start += csize
                    continue
                in_off = want - plain_start
                in_len = min(remaining, psize - in_off)
                start_pkg = in_off // sse.PKG_SIZE
                if chacha:
                    pt = sse.chacha_decrypt_ranged(
                        self._obj_fetch(bucket, key, opts,
                                        base=cipher_start),
                        csize, enc[0], sse.part_nonce(enc[1], p.number),
                        in_off, in_len, device=self.obj.device,
                        scheduler=self.obj.scheduler)
                else:
                    end_pkg = (in_off + in_len - 1) // sse.PKG_SIZE
                    coff = cipher_start + start_pkg * pkg_full
                    clen = min(csize - start_pkg * pkg_full,
                               (end_pkg - start_pkg + 1) * pkg_full)
                    _, stream = self.obj.get_object(bucket, key, coff,
                                                    clen, opts)
                    pt = sse.decrypt_stream(
                        stream, enc[0], sse.part_nonce(enc[1], p.number),
                        start_seq=start_pkg)
                yield from _skip_take(pt,
                                      in_off - start_pkg * sse.PKG_SIZE,
                                      in_len)
                remaining -= in_len
                want += in_len
                plain_start = plain_end
                cipher_start += csize

        return gen()

    def _sse_response_headers(self, md: dict) -> dict:
        mode = md.get(sse.MK_SSE, "")
        if mode == "S3":
            return {"x-amz-server-side-encryption": "AES256"}
        if mode == "C":
            return {
                "x-amz-server-side-encryption-customer-algorithm":
                    "AES256",
                "x-amz-server-side-encryption-customer-key-md5":
                    md.get(sse.MK_KEYMD5, ""),
            }
        return {}

    def head_object(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetObject", bucket, key)
        vid = ctx.query1("versionId")
        opts = GetOptions(version_id="" if vid == "null" else vid)
        info = self.obj.get_object_info(bucket, key, opts)
        short = self._check_preconditions(ctx, info)
        headers = self._obj_response_headers(info)
        md = info.user_defined or {}
        if md.get(sse.MK_SSE) or sse.stored_compression(md):
            if md.get(sse.MK_SSE) == "C":
                sse.resolve_get_key(md, ctx.header, self.kms)
            headers.update(self._sse_response_headers(md))
            headers["Content-Length"] = str(self._plain_size(info, md))
        else:
            headers["Content-Length"] = str(info.size)
        if short is not None:
            return HTTPResponse(status=short, headers=headers)
        self._notify("s3:ObjectAccessed:Head", bucket, key)
        return HTTPResponse(headers=headers)

    def delete_object(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:DeleteObject", bucket, key)
        self.obj.get_bucket_info(bucket)
        if ctx.header("x-minio-tpu-repl-purge"):
            # internal replica prune: remove ONE version outright (no
            # delete marker), owner credential only — the wire form of
            # the replication plane's prune step
            if self.iam is not None and ctx.cred is not None and \
                    not self._is_owner(ctx.cred):
                raise S3Error("AccessDenied",
                              "replica prune needs the owner credential")
            pvid = ctx.query1("versionId")
            # object-lock retention binds the prune too: a COMPLIANCE-
            # locked version must survive replication convergence
            # exactly like it survives a direct versioned DELETE. The
            # prune ALWAYS removes a version (never writes a marker),
            # so the marker exemption must not apply — an empty vid
            # names the null version explicitly
            self._enforce_object_lock(ctx, bucket, key, pvid or "null",
                                      False)
            try:
                self.obj.delete_object(
                    bucket, key,
                    version_id="" if pvid == "null" else pvid,
                    versioned=False)
            except (oerr.ObjectNotFound, oerr.VersionNotFound):
                pass                    # already converged
            self._notify("s3:ObjectRemoved:Delete", bucket, key)
            return HTTPResponse(status=204)
        vid = ctx.query1("versionId")
        versioned = self.bucket_meta.versioning_enabled(bucket)
        self._enforce_object_lock(ctx, bucket, key, vid, versioned)
        # "null" targets the pre-versioning null version, which this
        # stack stores under the empty version id: normalized once, so
        # that the tier gate below and delete_object agree on whether
        # this request removes a DATA version or only lays a marker
        eff_vid = "" if vid == "null" else vid
        # a delete that removes a data version (an explicit version, or
        # an unversioned delete) frees a transitioned object's remote
        # copy. Gated on a non-empty registry (with no tiers nothing is
        # transitioned, and the extra metadata read would tax every
        # DELETE) and on eff_vid: ?versionId=null on a versioned bucket
        # lays a marker, the stub stays, and so must its remote copy
        tiered_md = None
        if self.tiers is not None and getattr(self.tiers, "tiers", None) \
                and (eff_vid or not versioned):
            try:
                tiered_md = self.obj.get_object_info(
                    bucket, key,
                    GetOptions(version_id=eff_vid)).user_defined or {}
            except oerr.ObjectApiError:
                pass
        headers = {}
        try:
            res = self.obj.delete_object(
                bucket, key, version_id=eff_vid, versioned=versioned)
            if isinstance(res, ObjectInfo):
                if res.delete_marker:
                    headers["x-amz-delete-marker"] = "true"
                if res.version_id and res.version_id != "null":
                    headers["x-amz-version-id"] = res.version_id
            if tiered_md is not None:
                tier_transition.free_remote(self.tiers, tiered_md)
        except oerr.ObjectNotFound:
            pass  # S3 DELETE of a missing key is 204
        self._notify("s3:ObjectRemoved:Delete", bucket, key)
        return HTTPResponse(status=204, headers=headers)

    def restore_object(self, ctx, bucket, key) -> HTTPResponse:
        """POST /bucket/key?restore: pull a transitioned object back as an
        expiring local copy (S3 RestoreObject; 202 on a fresh restore,
        200 when only the expiry window was extended)."""
        self.authenticate(ctx, "s3:RestoreObject", bucket, key)
        self.obj.get_bucket_info(bucket)
        if self.tiers is None:
            raise S3Error("NotImplemented", "no tier configuration")
        body = ctx.read_body()
        days = 1
        if body.strip():
            try:
                root = ET.fromstring(body)
            except ET.ParseError:
                raise S3Error("MalformedXML") from None
            ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
            del_ = root.find("Days")
            if del_ is None:
                del_ = root.find(ns + "Days")
            if del_ is not None and (del_.text or "").strip():
                try:
                    days = int(del_.text.strip())
                except ValueError:
                    raise S3Error("MalformedXML", "bad Days") from None
        if days < 1:
            raise S3Error("InvalidArgument", "restore Days must be >= 1")
        vid = ctx.query1("versionId")
        eff_vid = "" if vid == "null" else vid
        info = self.obj.get_object_info(bucket, key,
                                        GetOptions(version_id=eff_vid))
        md = info.user_defined or {}
        if dt.RESTORE_ONGOING in md.get(dt.RESTORE_KEY, ""):
            raise S3Error("RestoreAlreadyInProgress")
        async_bytes = knobs.get_int("MINIO_TPU_RESTORE_ASYNC_BYTES")
        if (self.restore_worker is not None and async_bytes
                and info.size >= async_bytes and dt.is_transitioned(md)
                and not dt.is_restored(md)):
            # a large object: answer 202 now and pull on the worker;
            # the ongoing marker shows in GET/HEAD and gates duplicates
            tier_transition.mark_restore_ongoing(self.obj, bucket, key,
                                                 eff_vid)
            if self.restore_worker.enqueue_restore(
                    bucket, key, eff_vid or info.version_id, days):
                self._notify("s3:ObjectRestore:Post", bucket, key)
                return HTTPResponse(status=202)
            # the worker's queue is full or stopping: nothing would ever
            # clear the marker, so undo it and restore synchronously
            tier_transition.clear_restore_ongoing(self.obj, bucket, key,
                                                  eff_vid)
        out = tier_transition.restore_object(self.obj, self.tiers, bucket,
                                             key, version_id=eff_vid,
                                             days=days)
        self._notify("s3:ObjectRestore:Completed", bucket, key)
        return HTTPResponse(
            status=202 if out["status"] == "restored" else 200)

    def copy_object(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObject", bucket, key)
        src_bucket, src_key, src_vid = _parse_copy_source(
            ctx.header("x-amz-copy-source"))
        if self.iam is not None and ctx.cred and \
                not self._is_owner(ctx.cred):
            if not self.iam.is_allowed(ctx.cred, "s3:GetObject",
                                       src_bucket, src_key,
                                       self._policy_conditions(ctx)):
                raise S3Error("AccessDenied")
        opts = GetOptions(version_id=src_vid)
        src_info = self.obj.get_object_info(src_bucket, src_key, opts)
        # copy preconditions
        csm = ctx.header("x-amz-copy-source-if-match")
        if csm and csm.strip('"') != src_info.etag:
            raise S3Error("PreconditionFailed")
        csnm = ctx.header("x-amz-copy-source-if-none-match")
        if csnm and csnm.strip('"') == src_info.etag:
            raise S3Error("PreconditionFailed")
        directive = ctx.header("x-amz-metadata-directive", "COPY")
        src_md = src_info.user_defined or {}
        src_transformed = bool(src_md.get(sse.MK_SSE)
                               or sse.stored_compression(src_md))
        # target transform request (re-encrypt / encrypt-on-copy), or an
        # explicit source key (decrypt-on-copy)?
        tgt_ssec = sse.parse_ssec_headers(ctx.header)
        tgt_sse_s3 = self._sse_s3_requested(ctx, tgt_ssec)
        re_transform = (tgt_ssec is not None or tgt_sse_s3
                        or bool(ctx.header(
                            "x-amz-copy-source-server-side-encryption-"
                            "customer-algorithm")))

        if directive == "REPLACE":
            metadata = _extract_metadata(ctx)
            if src_transformed and not re_transform:
                # stored bytes copied verbatim: the transform state
                # (seals, cipher, compression flag, actual size) must
                # survive a metadata REPLACE or the copy is unreadable
                for ik in _SEAL_KEYS + (sse.MK_CIPHER,):
                    if ik in src_md:
                        metadata[ik] = src_md[ik]
        else:
            if src_bucket == bucket and src_key == key \
                    and not re_transform:
                raise S3Error("InvalidRequest",
                              "self-copy requires metadata directive "
                              "REPLACE")
            metadata = dict(src_md)
            metadata["content-type"] = src_info.content_type
            if re_transform:
                for ik in _SEAL_KEYS:
                    metadata.pop(ik, None)

        if re_transform:
            # re-encryption path: decrypt/decompress the source to
            # plaintext, then apply the TARGET transforms like a fresh PUT
            plain_stream, plain_size = self._copy_source_plaintext(
                ctx, src_bucket, src_key, src_info, opts)
            if src_bucket == bucket and src_key == key:
                plain_stream = iter([b"".join(plain_stream)])
            reader = HashReader(_IterStream(plain_stream), plain_size)
            metadata["etag"] = src_info.etag
            reader2, size2, spec = sse.setup_put_transforms(
                key_name=key, raw_reader=reader, raw_size=plain_size,
                metadata=metadata, ssec_key=tgt_ssec, sse_s3=tgt_sse_s3,
                kms=self.kms, compress=False,
                device_sse=getattr(self.obj, "supports_sse_device",
                                   False))
            if sse.sse_cipher_for_new_writes() != sse.CIPHER_CHACHA:
                # the seals just written are AES-GCM's: a source's ChaCha20
                # record would misname the target's cipher
                metadata.pop(sse.MK_CIPHER, None)
            versioned = self.bucket_meta.versioning_enabled(bucket)
            info = self.obj.put_object(
                bucket, key, reader2, size2,
                PutOptions(metadata=metadata, versioned=versioned,
                           sse_spec=spec))
            headers = {}
            if info.version_id and info.version_id != "null":
                headers["x-amz-version-id"] = info.version_id
            self._notify("s3:ObjectCreated:Copy", bucket, key)
            return HTTPResponse(headers=headers).with_xml(
                xmlgen.copy_object_response(info.etag, info.mod_time))

        _, stream = self.obj.get_object(src_bucket, src_key, 0,
                                        src_info.size, opts)
        if src_bucket == bucket and src_key == key:
            # self-copy: drain before writing — the GET stream holds the
            # read lock the PUT's write lock would wait on
            stream = iter([b"".join(stream)])
        reader = HashReader(_IterStream(stream), src_info.size)
        # the bytes are identical, so the ETag is too — and for
        # transformed objects the stored-byte MD5 is NOT the ETag
        metadata["etag"] = src_info.etag
        versioned = self.bucket_meta.versioning_enabled(bucket)
        info = self.obj.put_object(
            bucket, key, reader, src_info.size,
            PutOptions(metadata=metadata, versioned=versioned))
        headers = {}
        if info.version_id and info.version_id != "null":
            headers["x-amz-version-id"] = info.version_id
        self._notify("s3:ObjectCreated:Copy", bucket, key)
        return HTTPResponse(headers=headers).with_xml(
            xmlgen.copy_object_response(info.etag, info.mod_time))

    # --- multipart ------------------------------------------------------

    def new_multipart_upload(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObject", bucket, key)
        self.obj.get_bucket_info(bucket)
        metadata = _extract_metadata(ctx)
        # SSE multipart: seal one object key now; every part encrypts
        # under it with a per-part nonce space
        ssec_key = sse.parse_ssec_headers(ctx.header)
        sse_s3 = self._sse_s3_requested(ctx, ssec_key)
        sse.create_sse_seals(metadata, ssec_key, sse_s3,
                             self.kms, multipart=True,
                             kms_context={"object": key})
        upload_id = self.obj.new_multipart_upload(
            bucket, key, PutOptions(metadata=metadata))
        return HTTPResponse().with_xml(
            xmlgen.initiate_multipart_response(bucket, key, upload_id))

    def put_object_part(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObject", bucket, key)
        upload_id = ctx.query1("uploadId")
        try:
            part_number = int(ctx.query1("partNumber"))
        except ValueError:
            raise S3Error("InvalidArgument", "partNumber must be an int")
        if not 1 <= part_number <= MAX_PARTS:
            raise S3Error("InvalidArgument",
                          f"partNumber must be 1..{MAX_PARTS}")
        reader, size = self._put_reader(ctx)
        if size > MAX_PART_SIZE:
            raise S3Error("EntityTooLarge")
        # multipart must not bypass bucket quota; size is the resolved
        # plaintext length, aws-chunked included
        self._enforce_quota(bucket, size)
        # SSE upload: encrypt the part under the session's object key,
        # on the host, in the part's own nonce space
        md = self._multipart_meta(bucket, key, upload_id)
        if md.get(sse.MK_SSE):
            enc = self._mpu_sse_key(bucket, key, upload_id, md, ctx)
            pnonce = sse.part_nonce(enc[1], part_number)
            if sse.stored_sse_cipher(md) == sse.CIPHER_CHACHA:
                transform = sse.ChaChaEncryptor(enc[0], pnonce)
            else:
                transform = sse.Encryptor(enc[0], pnonce)
            reader = sse.PutObjReader(reader, [transform])
            size = -1
        part = self.obj.put_object_part(bucket, key, upload_id,
                                        part_number, reader, size)
        return HTTPResponse(headers={"ETag": f'"{part.etag}"'})

    def copy_object_part(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObject", bucket, key)
        upload_id = ctx.query1("uploadId")
        try:
            part_number = int(ctx.query1("partNumber"))
        except ValueError:
            raise S3Error("InvalidArgument", "partNumber must be an int")
        if self._multipart_meta(bucket, key,
                                upload_id).get(sse.MK_SSE):
            raise S3Error("NotImplemented",
                          "copy-part into SSE uploads is not supported")
        src_bucket, src_key, src_vid = _parse_copy_source(
            ctx.header("x-amz-copy-source"))
        opts = GetOptions(version_id=src_vid)
        src_info = self.obj.get_object_info(src_bucket, src_key, opts)
        rng = _parse_range(ctx.header("x-amz-copy-source-range"),
                           src_info.size)
        offset, length = (0, src_info.size) if rng is None else rng
        _, stream = self.obj.get_object(src_bucket, src_key, offset,
                                        length, opts)
        reader = HashReader(_IterStream(stream), length)
        part = self.obj.put_object_part(bucket, key, upload_id,
                                        part_number, reader, length)
        x = xmlgen.X()
        x.open("CopyPartResult", xmlns=xmlgen.S3_XMLNS)
        x.elem("LastModified", xmlgen._ts(part.mod_time
                                          if hasattr(part, "mod_time")
                                          else 0.0))
        x.elem("ETag", f'"{part.etag}"')
        x.close("CopyPartResult")
        return HTTPResponse().with_xml(x.bytes())

    def complete_multipart_upload(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObject", bucket, key)
        upload_id = ctx.query1("uploadId")
        body = ctx.read_body()
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise S3Error("MalformedXML")
        parts: list[CompletePart] = []
        for child in root:
            if not child.tag.endswith("Part"):
                continue
            num = etag = None
            for sub in child:
                st = sub.tag.split("}")[-1]
                if st == "PartNumber":
                    try:
                        num = int(sub.text or "0")
                    except ValueError:
                        raise S3Error("MalformedXML",
                                      "PartNumber must be an int")
                elif st == "ETag":
                    etag = (sub.text or "").strip('"')
            if num is None or etag is None:
                raise S3Error("MalformedXML")
            parts.append(CompletePart(num, etag))
        if not parts:
            raise S3Error("MalformedXML", "no parts")
        if parts != sorted(parts, key=lambda p: p.part_number):
            raise S3Error("InvalidPartOrder")
        info = self.obj.complete_multipart_upload(bucket, key, upload_id,
                                                  parts)
        self._notify("s3:ObjectCreated:CompleteMultipartUpload", bucket,
                     key)
        host = ctx.header("host", "")
        return HTTPResponse().with_xml(xmlgen.complete_multipart_response(
            f"http://{host}/{bucket}/{key}", bucket, key, info.etag))

    def abort_multipart_upload(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:AbortMultipartUpload", bucket, key)
        self.obj.abort_multipart_upload(bucket, key,
                                        ctx.query1("uploadId"))
        return HTTPResponse(status=204)

    def list_object_parts(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:ListMultipartUploadParts", bucket, key)
        upload_id = ctx.query1("uploadId")
        try:
            marker = int(ctx.query1("part-number-marker", "0"))
        except ValueError:
            raise S3Error("InvalidArgument",
                          "part-number-marker must be an int")
        max_parts = _parse_max_keys(ctx.query1("max-parts", "1000"))
        parts = self.obj.list_object_parts(bucket, key, upload_id, marker,
                                           max_parts + 1)
        trunc = len(parts) > max_parts
        parts = parts[:max_parts]
        next_marker = parts[-1].part_number if parts and trunc else 0
        return HTTPResponse().with_xml(xmlgen.list_parts_response(
            bucket, key, upload_id, marker, next_marker, max_parts, trunc,
            parts))

    # --- object tagging -------------------------------------------------

    def get_object_tagging(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetObjectTagging", bucket, key)
        info = self.obj.get_object_info(bucket, key)
        raw = info.user_defined.get("X-Amz-Tagging", "")
        tags = dict(urllib.parse.parse_qsl(raw))
        return HTTPResponse().with_xml(xmlgen.tagging_response(tags))

    def put_object_tagging(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObjectTagging", bucket, key)
        tags = _parse_tagging_xml(ctx.read_body())
        self._rewrite_metadata(
            bucket, key,
            {"X-Amz-Tagging": urllib.parse.urlencode(tags)})
        return HTTPResponse()

    def delete_object_tagging(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:DeleteObjectTagging", bucket, key)
        self._rewrite_metadata(bucket, key, {"X-Amz-Tagging": None})
        return HTTPResponse(status=204)

    def _rewrite_metadata(self, bucket, key, updates: dict,
                          version_id: str = "") -> None:
        """Metadata-only update in place — no data rewrite, no new
        version (tags on a versioned bucket must not grow the stack)."""
        info = self.obj.get_object_info(bucket, key,
                                        GetOptions(version_id=version_id))
        md = dict(info.user_defined)
        md["content-type"] = info.content_type
        if info.content_encoding:
            md["content-encoding"] = info.content_encoding
        for k, v in updates.items():
            if v is None:
                md.pop(k, None)
            else:
                md[k] = v
        self.obj.update_object_metadata(bucket, key, md,
                                        version_id or info.version_id)

    # ------------------------------------------------------------------
    # select
    # ------------------------------------------------------------------

    def select_object_content(self, ctx, bucket, key) -> HTTPResponse:
        """SelectObjectContent: SQL over a CSV/JSON object streamed back
        as AWS event-stream messages (reference pkg/s3select and
        cmd/object-handlers.go SelectObjectContentHandler). The object is
        read whole through the plaintext stack (an SSE object deciphers on
        the card, a compressed one decodes on the host), then the scan
        engine decides its rows on the card before the response starts: a
        device failure answers 500, never the evaluator's bytes."""
        self.authenticate(ctx, "s3:GetObject", bucket, key)
        req = SelectRequest.from_xml(ctx.read_body())
        with stagetimer.stage("select.get"):
            info = self.obj.get_object_info(bucket, key)
            stream, _size = self._plaintext_stream(bucket, key, info,
                                                   ctx.header, GetOptions())
            data = b"".join(stream)
        return HTTPResponse(
            headers={"Content-Type": "application/octet-stream"},
            stream=self.scan.event_stream(req, data))

    # ------------------------------------------------------------------
    # quota
    # ------------------------------------------------------------------

    def _enforce_quota(self, bucket: str, incoming: int) -> None:
        q = self.bucket_meta.get_quota(bucket)
        if not q or not q.get("quota"):
            return
        limit = int(q["quota"])
        if self._bucket_usage(bucket) + incoming > limit:
            raise S3Error("QuotaExceeded")

    def _bucket_usage(self, bucket: str) -> int:
        """Bytes used by one bucket: the data-usage crawler's cache when
        one is attached (cmd/bucket-quota.go reads dataUsageCache), else
        a listing walk."""
        if self.usage is not None:
            cached = self.usage.bucket_usage(bucket)
            if cached is not None:
                return cached
        used = 0
        marker = ""
        while True:
            objs, _, trunc = self.obj.list_objects(bucket, "", marker,
                                                   "", 1000)
            used += sum(o.size for o in objs)
            if not trunc or not objs:
                return used
            marker = objs[-1].name

    # ------------------------------------------------------------------
    # the data-update tracker
    # ------------------------------------------------------------------

    def _enforce_object_lock(self, ctx, bucket: str, key: str,
                             version_id: str, versioned: bool) -> None:
        """WORM enforcement on deletion (enforceRetentionForDeletion,
        cmd/bucket-object-lock.go): only the removal of an actual
        VERSION is gated — a versioned delete without versionId just
        writes a marker."""
        if not self.bucket_meta.get(bucket).object_lock_xml:
            return
        if versioned and not version_id:
            return                        # delete marker: always allowed
        try:
            info = self.obj.get_object_info(
                bucket, key, GetOptions(version_id=version_id))
        except oerr.ObjectApiError:
            return
        bypass = self._governance_bypass(ctx, bucket, key)
        reason = olock.check_deletable(info.user_defined or {}, bypass)
        if reason is not None:
            raise S3Error("ObjectLocked", reason)

    def _governance_bypass(self, ctx, bucket: str, key: str) -> bool:
        """True when the request carries the governance-bypass header AND
        the caller holds s3:BypassGovernanceRetention (root implicit)."""
        if ctx.header("x-amz-bypass-governance-retention") != "true":
            return False
        if self.iam is not None and ctx.cred and \
                not self._is_owner(ctx.cred):
            return self.iam.is_allowed(
                ctx.cred, "s3:BypassGovernanceRetention", bucket, key,
                self._policy_conditions(ctx))
        return True

    # --- ?retention / ?legal-hold subresources --------------------------

    def get_object_retention(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetObjectRetention", bucket, key)
        info = self.obj.get_object_info(
            bucket, key, GetOptions(version_id=ctx.query1("versionId")))
        xml = olock.retention_xml(info.user_defined or {})
        if not xml:
            raise S3Error("NoSuchObjectLockConfiguration")
        return HTTPResponse().with_xml(
            b'<?xml version="1.0" encoding="UTF-8"?>' + xml.encode())

    def put_object_retention(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObjectRetention", bucket, key)
        if not self.bucket_meta.get(bucket).object_lock_xml:
            raise S3Error("InvalidRequest",
                          "bucket is missing ObjectLockConfiguration")
        mode, until = olock.parse_retention_xml(ctx.read_body())
        if mode not in ("GOVERNANCE", "COMPLIANCE") or not until:
            raise S3Error("InvalidArgument", "bad retention document")
        vid = ctx.query1("versionId")
        info = self.obj.get_object_info(bucket, key,
                                        GetOptions(version_id=vid))
        md = dict(info.user_defined or {})
        try:
            olock.parse_iso(until)
        except ValueError:
            raise S3Error("InvalidArgument", "bad date") from None
        reason = olock.check_retention_update(
            md, mode, until, self._governance_bypass(ctx, bucket, key))
        if reason is not None:          # date is pre-validated above, so
            raise S3Error("ObjectLocked", reason)   # always a lock denial
        md[olock.MD_MODE] = mode
        md[olock.MD_RETAIN] = until
        md["content-type"] = info.content_type
        self.obj.update_object_metadata(bucket, key, md,
                                        vid or info.version_id)
        return HTTPResponse()

    def get_object_legal_hold(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:GetObjectLegalHold", bucket, key)
        info = self.obj.get_object_info(
            bucket, key, GetOptions(version_id=ctx.query1("versionId")))
        return HTTPResponse().with_xml(
            b'<?xml version="1.0" encoding="UTF-8"?>' +
            olock.legal_hold_xml(info.user_defined or {}).encode())

    def put_object_legal_hold(self, ctx, bucket, key) -> HTTPResponse:
        self.authenticate(ctx, "s3:PutObjectLegalHold", bucket, key)
        if not self.bucket_meta.get(bucket).object_lock_xml:
            raise S3Error("InvalidRequest",
                          "bucket is missing ObjectLockConfiguration")
        status = olock.parse_legal_hold_xml(ctx.read_body())
        if status not in ("ON", "OFF"):
            raise S3Error("InvalidArgument", "bad legal hold document")
        vid = ctx.query1("versionId")
        info = self.obj.get_object_info(bucket, key,
                                        GetOptions(version_id=vid))
        md = dict(info.user_defined or {})
        md[olock.MD_HOLD] = status
        md["content-type"] = info.content_type
        self.obj.update_object_metadata(bucket, key, md,
                                        vid or info.version_id)
        return HTTPResponse()

    def _notify(self, event_name: str, bucket: str, key: str) -> None:
        if self.events is not None:
            try:
                self.events.send(event_name, bucket, key)
            except Exception:  # noqa: BLE001 — events are best-effort
                pass
        # the data-update tracker rides every mutation signal (reference
        # cmd/data-update-tracker.go marks its bloom on object writes)
        tracker = self.update_tracker
        if tracker is not None and \
                not event_name.startswith("s3:ObjectAccessed"):
            try:
                tracker.mark(bucket, key)
            except Exception:  # noqa: BLE001 — hints are best-effort
                pass
        # LEGACY replication pool only: the active-active plane
        # (replicate/) rides the engine namespace-change feed instead,
        # so every mutation verb reaches it without per-handler call
        # sites (the old hooks here missed bulk delete and multipart
        # commit)
        if self.replication is not None and key and \
                hasattr(self.replication, "on_put"):
            try:
                if event_name.startswith("s3:ObjectCreated:"):
                    self.replication.on_put(bucket, key)
                elif event_name.startswith("s3:ObjectRemoved:"):
                    self.replication.on_delete(bucket, key)
            except Exception:  # noqa: BLE001 — replication is async
                pass


def _parse_max_keys(v: str) -> int:
    try:
        n = int(v)
    except ValueError:
        raise S3Error("InvalidArgument", "max-keys must be an int")
    if n < 0:
        raise S3Error("InvalidArgument", "max-keys must be >= 0")
    return min(n, 1000)  # 0 is a legal request for an empty listing


def _encode_token(marker: str) -> str:
    return base64.urlsafe_b64encode(marker.encode()).decode()


def _decode_token(token: str) -> str:
    try:
        return base64.urlsafe_b64decode(token.encode()).decode()
    except (binascii.Error, ValueError):
        raise S3Error("InvalidArgument", "bad continuation token")


def _parse_copy_source(src: str) -> tuple[str, str, str]:
    src = urllib.parse.unquote(src)
    vid = ""
    if "?versionId=" in src:
        src, vid = src.split("?versionId=", 1)
    src = src.lstrip("/")
    if "/" not in src:
        raise S3Error("InvalidArgument", "bad x-amz-copy-source")
    bucket, key = src.split("/", 1)
    return bucket, key, "" if vid == "null" else vid


def _parse_tagging_xml(body: bytes) -> dict[str, str]:
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise S3Error("MalformedXML")
    tags: dict[str, str] = {}
    for ts in root.iter():
        if ts.tag.split("}")[-1] == "Tag":
            k = v = None
            for sub in ts:
                st = sub.tag.split("}")[-1]
                if st == "Key":
                    k = sub.text or ""
                elif st == "Value":
                    v = sub.text or ""
            if not k or len(k) > 128 or (v and len(v) > 256):
                raise S3Error("InvalidTagKey" if not k or len(k) > 128
                              else "InvalidTagValue")
            tags[k] = v or ""
    if len(tags) > 50:
        raise S3Error("InvalidArgument", "too many tags")
    return tags
