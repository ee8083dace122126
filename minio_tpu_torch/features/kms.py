"""KMS seam for SSE-S3 (reference cmd/crypto/kes.go + kms.go shapes).

A copy of minio_tpu/features/kms.py: host-only, standard library only.

Two backends behind one duck-typed interface:

  generate_key(context) -> (plaintext DEK, sealed DEK blob)
  decrypt_key(sealed, context) -> plaintext DEK

* ``StaticKMS`` — the master key from config/env; generate returns the
  master itself with an empty sealed blob, preserving the pre-KMS
  metadata format byte-for-byte (cmd/crypto/kms.go masterKeyKMS).
* ``KESClient`` — a KES-shaped remote KMS over HTTP
  (cmd/crypto/kes.go): POST /v1/key/generate/<name> returns
  {plaintext, ciphertext}; POST /v1/key/decrypt/<name> unseals. The
  HTTP connection factory is injectable so tests run against an
  in-process fake, and a down KMS surfaces as a clean S3 error — SSE
  PUTs/GETs fail closed, nothing falls back to plaintext.

The object-key sealing chain mirrors the reference: per-object key
(OEK) sealed by the DEK; only the DEK ciphertext and the sealed OEK
persist in xl.meta — the KMS never sees object data, and losing the
KMS key renders objects unreadable (the point of remote KMS).
"""

from __future__ import annotations

import base64
import http.client
import json
import urllib.parse
from typing import Callable, Optional


class KMSError(Exception):
    pass


class StaticKMS:
    """Local master key (config kms_secret_key / MINIO_SSE_MASTER_KEY)."""

    key_id = "minio-static-key"

    def __init__(self, master_key: bytes):
        if len(master_key) != 32:
            raise ValueError("master key must be 256 bits")
        self._master = master_key

    def generate_key(self, context: dict) -> tuple[bytes, bytes]:
        # empty sealed blob = "the DEK is the master key itself";
        # byte-compatible with objects written before the KMS seam
        return self._master, b""

    def decrypt_key(self, sealed: bytes, context: dict,
                    key_id: str = "") -> bytes:
        if sealed:
            raise KMSError("static KMS cannot decrypt a remote DEK")
        return self._master


class KESClient:
    """KES-shaped HTTP KMS client (cmd/crypto/kes.go).

    Auth is a bearer API key (KES identity); the transport factory is
    injectable for offline tests and future mTLS wiring."""

    def __init__(self, endpoint: str, key_name: str, api_key: str = "",
                 timeout: float = 5.0,
                 connect: Optional[Callable[[], object]] = None):
        u = urllib.parse.urlsplit(endpoint)
        if u.scheme not in ("http", "https") or not u.hostname:
            raise ValueError(f"bad KES endpoint {endpoint!r}")
        self.endpoint = endpoint
        self.key_name = key_name
        self.key_id = f"kes:{key_name}"
        self.api_key = api_key
        self.timeout = timeout
        self._host = u.hostname
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._secure = u.scheme == "https"
        self._connect = connect or self._default_connect

    def _default_connect(self):
        cls = http.client.HTTPSConnection if self._secure \
            else http.client.HTTPConnection
        return cls(self._host, self._port, timeout=self.timeout)

    def _post(self, path: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        try:
            conn = self._connect()
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
        except OSError as e:
            raise KMSError(f"KMS unreachable: {e}") from e
        if resp.status != 200:
            raise KMSError(
                f"KMS {path} failed ({resp.status}): {data[:200]!r}")
        try:
            out = json.loads(data.decode())
        except ValueError:
            raise KMSError("KMS returned malformed JSON") from None
        if not isinstance(out, dict):
            raise KMSError("KMS returned a non-object response")
        return out

    @staticmethod
    def _ctx_b64(context: dict) -> str:
        # canonical: sorted keys, no whitespace — decrypt must present
        # the exact bytes generate was called with
        return base64.b64encode(json.dumps(
            context or {}, sort_keys=True,
            separators=(",", ":")).encode()).decode()

    def generate_key(self, context: dict) -> tuple[bytes, bytes]:
        out = self._post(f"/v1/key/generate/{self.key_name}",
                         {"context": self._ctx_b64(context)})
        try:
            plain = base64.b64decode(out["plaintext"])
            sealed = base64.b64decode(out["ciphertext"])
        except (KeyError, ValueError):
            raise KMSError("KMS generate-key response missing "
                           "plaintext/ciphertext") from None
        if len(plain) != 32:
            raise KMSError("KMS returned a non-256-bit data key")
        return plain, sealed

    def decrypt_key(self, sealed: bytes, context: dict,
                    key_id: str = "") -> bytes:
        """key_id: the key the OBJECT was sealed under (metadata
        "kes:<name>") — decrypt must route there even after the
        configured default key_name rotates, or every pre-rotation
        object dies with the rotation."""
        name = key_id[len("kes:"):] if key_id.startswith("kes:") \
            else (key_id or self.key_name)
        out = self._post(
            f"/v1/key/decrypt/{name}",
            {"ciphertext": base64.b64encode(sealed).decode(),
             "context": self._ctx_b64(context)})
        try:
            plain = base64.b64decode(out["plaintext"])
        except (KeyError, ValueError):
            raise KMSError("KMS decrypt-key response missing "
                           "plaintext") from None
        if len(plain) != 32:
            raise KMSError("KMS returned a non-256-bit data key")
        return plain
