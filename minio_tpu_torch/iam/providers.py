"""STS federation identity providers: OpenID Connect (JWT/JWKS) + LDAP.

A copy of minio_tpu/iam/providers.py; ``cryptography`` (RS256/384/512)
is imported only when an RSA-signed token is verified.

The reference authenticates federated STS callers three ways
(cmd/sts-handlers.go:43-86): AssumeRoleWithWebIdentity and
AssumeRoleWithClientGrants validate an OIDC JWT against the provider's
JWKS (cmd/config/identity/openid/jwt.go), AssumeRoleWithLDAPIdentity
simple-binds to an LDAP server (cmd/config/identity/ldap/config.go).
Both map the federated identity to IAM policies: OIDC via a policy
claim in the token, LDAP via the policy DB entry for the bound DN.

This module is transport-real but offline-testable:
  * OpenIDProvider reads a JWKS from inline config or a local file (the
    discovery fetch of config_url is a one-line swap when egress
    exists); RS256/384/512 verify via `cryptography`, HS256 via hmac.
  * LDAPProvider speaks actual LDAPv3 simple bind (BER-encoded over a
    socket, RFC 4511 §4.2) — tests run a loopback server; production
    points server_addr at a real directory.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import socket
import time
from typing import Callable, Optional


class STSValidationError(Exception):
    """Token/credential validation failure (maps to AccessDenied)."""


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _b64url_uint(s: str) -> int:
    return int.from_bytes(_b64url_decode(s), "big")


# ---------------------------------------------------------------------------
# OpenID Connect
# ---------------------------------------------------------------------------

class OpenIDProvider:
    """JWT validation against a configured JWKS + policy-claim mapping.

    Config keys (identity_openid subsystem): `jwks` (inline JWKS JSON)
    or `jwks_file` (path), `client_id` (enforced against aud/azp when
    set), `claim_name` (default "policy"), `claim_prefix`.
    """

    ALGS = {"RS256": "sha256", "RS384": "sha384", "RS512": "sha512",
            "HS256": "sha256", "HS384": "sha384", "HS512": "sha512"}

    def __init__(self, cfg: dict):
        self.client_id = cfg.get("client_id", "")
        self.claim_name = cfg.get("claim_name") or "policy"
        self.claim_prefix = cfg.get("claim_prefix", "")
        jwks_raw = cfg.get("jwks", "")
        if not jwks_raw and cfg.get("jwks_file"):
            with open(cfg["jwks_file"]) as f:
                jwks_raw = f.read()
        self._keys: dict[str, dict] = {}
        self._anon_keys: list[dict] = []
        if jwks_raw:
            for k in json.loads(jwks_raw).get("keys", []):
                if k.get("kid"):
                    self._keys[k["kid"]] = k
                else:
                    self._anon_keys.append(k)

    def enabled(self) -> bool:
        return bool(self._keys or self._anon_keys)

    # -- validation --------------------------------------------------------

    def validate(self, token: str, *, now: Optional[float] = None) -> dict:
        """Verify signature + temporal claims + audience; return the
        claim set. Raises STSValidationError on every failure mode."""
        now = time.time() if now is None else now
        try:
            h_b64, p_b64, s_b64 = token.split(".")
            header = json.loads(_b64url_decode(h_b64))
            claims = json.loads(_b64url_decode(p_b64))
            sig = _b64url_decode(s_b64)
        except Exception:
            raise STSValidationError("malformed JWT") from None

        alg = header.get("alg", "")
        if alg not in self.ALGS:
            raise STSValidationError(f"unsupported alg {alg!r}")
        key = self._find_key(header.get("kid"), alg)
        signing_input = f"{h_b64}.{p_b64}".encode()
        if not self._verify_sig(key, alg, signing_input, sig):
            raise STSValidationError("signature verification failed")

        exp = claims.get("exp")
        if not isinstance(exp, (int, float)):
            raise STSValidationError("missing exp claim")
        if now >= exp:
            raise STSValidationError("token expired")
        nbf = claims.get("nbf")
        if isinstance(nbf, (int, float)) and now < nbf:
            raise STSValidationError("token not yet valid")
        if self.client_id:
            aud = claims.get("aud", claims.get("azp"))
            auds = aud if isinstance(aud, list) else [aud]
            if self.client_id not in auds:
                raise STSValidationError("audience mismatch")
        return claims

    def _find_key(self, kid: Optional[str], alg: str) -> dict:
        if kid is not None:
            k = self._keys.get(kid)
            if k is None:
                raise STSValidationError(f"unknown kid {kid!r}")
            return k
        if self._anon_keys:
            return self._anon_keys[0]
        if len(self._keys) == 1:
            return next(iter(self._keys.values()))
        raise STSValidationError("no kid and multiple keys")

    def _verify_sig(self, key: dict, alg: str, signing_input: bytes,
                    sig: bytes) -> bool:
        digest = self.ALGS[alg]
        if alg.startswith("HS"):
            if key.get("kty") != "oct" or "k" not in key:
                raise STSValidationError("key type mismatch for HMAC alg")
            want = hmac.new(_b64url_decode(key["k"]), signing_input,
                            getattr(hashlib, digest)).digest()
            return hmac.compare_digest(want, sig)
        if key.get("kty") != "RSA":
            raise STSValidationError("key type mismatch for RSA alg")
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import (padding,
                                                               rsa)
        hash_cls = {"sha256": hashes.SHA256, "sha384": hashes.SHA384,
                    "sha512": hashes.SHA512}[digest]
        pub = rsa.RSAPublicNumbers(
            _b64url_uint(key["e"]), _b64url_uint(key["n"])).public_key()
        try:
            pub.verify(sig, signing_input, padding.PKCS1v15(),
                       hash_cls())
            return True
        except Exception:
            return False

    # -- policy mapping ----------------------------------------------------

    def policy_names(self, claims: dict) -> list[str]:
        """Policies named by the token's policy claim (reference
        GetDefaultPolicyName over the configured claim,
        cmd/sts-handlers.go WebIdentity flow)."""
        v = claims.get(self.claim_prefix + self.claim_name)
        if v is None and self.claim_prefix:
            v = claims.get(self.claim_name)
        if v is None:
            return []
        if isinstance(v, str):
            return [p.strip() for p in v.split(",") if p.strip()]
        if isinstance(v, list):
            return [str(p) for p in v if str(p)]
        return []


# ---------------------------------------------------------------------------
# LDAP (RFC 4511 simple bind, minimal BER)
# ---------------------------------------------------------------------------

def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(content)) + content


def _ber_int(v: int) -> bytes:
    body = v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big",
                      signed=True)
    return _tlv(0x02, body)


def _parse_tlv(buf: bytes, at: int) -> tuple[int, bytes, int]:
    """-> (tag, content, next_offset)"""
    tag = buf[at]
    ln = buf[at + 1]
    at += 2
    if ln & 0x80:
        nb = ln & 0x7F
        ln = int.from_bytes(buf[at:at + nb], "big")
        at += nb
    return tag, buf[at:at + ln], at + ln


def _recv_ber_message(s: socket.socket, limit: int = 1 << 20) -> bytes:
    """Read exactly one BER TLV from a socket — length-driven, so a
    response fragmented across TCP segments still parses (a single
    recv() would truncate over a WAN)."""
    def recv_exact(n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise OSError("LDAP connection closed mid-message")
            buf += chunk
        return buf

    head = recv_exact(2)
    ln = head[1]
    if ln & 0x80:
        nb = ln & 0x7F
        if not 0 < nb <= 4:
            raise OSError("bad BER length")
        ext = recv_exact(nb)
        ln = int.from_bytes(ext, "big")
        head += ext
    if ln > limit:
        raise OSError("oversized LDAP message")
    return head + recv_exact(ln)


_DN_ESCAPE = {c: f"\\{c}" for c in ',+"\\<>;='}


def _dn_escape(value: str) -> str:
    """RFC 4514 escaping of a DN attribute value — the client-supplied
    username must not be able to inject DN structure (',ou=admins')
    and thereby choose which DN's policy mapping it inherits."""
    out = "".join(_DN_ESCAPE.get(c, c) for c in value)
    if out.startswith((" ", "#")):
        out = "\\" + out
    if out.endswith(" "):
        out = out[:-1] + "\\ "
    return out.replace("\x00", "\\00")


class LDAPProvider:
    """LDAPv3 simple bind against `server_addr`; DN from
    `user_dn_format` (e.g. "uid=%s,ou=people,dc=example,dc=org" — the
    reference's username format list, cmd/config/identity/ldap).
    """

    def __init__(self, cfg: dict,
                 connect: Optional[Callable[[], socket.socket]] = None):
        self.server_addr = cfg.get("server_addr", "")
        self.user_dn_format = cfg.get("user_dn_format", "")
        self._connect = connect or self._default_connect

    def enabled(self) -> bool:
        return bool(self.server_addr)

    def _default_connect(self) -> socket.socket:
        from ..utils import host_port
        return socket.create_connection(
            host_port(self.server_addr, 389), timeout=10)

    def bind(self, username: str, password: str) -> str:
        """Simple bind; returns the bound DN or raises
        STSValidationError (bad credentials, unreachable server)."""
        if not username or not password:
            raise STSValidationError("empty LDAP username or password")
        dn = (self.user_dn_format % _dn_escape(username)) \
            if self.user_dn_format else _dn_escape(username)
        bind_req = _tlv(0x60,                       # [APPLICATION 0]
                        _ber_int(3)                 # version
                        + _tlv(0x04, dn.encode())   # name
                        + _tlv(0x80, password.encode()))  # simple auth
        msg = _tlv(0x30, _ber_int(1) + bind_req)
        try:
            with self._connect() as s:
                s.sendall(msg)
                resp = _recv_ber_message(s)
        except OSError as e:
            raise STSValidationError(f"LDAP unreachable: {e}") from None
        try:
            _tag, env, _ = _parse_tlv(resp, 0)      # LDAPMessage
            at = 0
            _tag, _msgid, at = _parse_tlv(env, at)  # messageID
            tag, bres, _ = _parse_tlv(env, at)      # BindResponse
            if tag != 0x61:
                raise ValueError("not a BindResponse")
            _tag, code, _ = _parse_tlv(bres, 0)     # resultCode (ENUM)
            result = int.from_bytes(code, "big")
        except Exception:
            raise STSValidationError("malformed LDAP response") from None
        if result != 0:
            raise STSValidationError(
                f"LDAP bind failed (resultCode {result})")
        return dn
