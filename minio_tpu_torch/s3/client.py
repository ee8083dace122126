"""A SigV4-signing S3 client over http.client, for driving the server.

It signs as an SDK does (s3/signature.py): a header-signed request with
the payload's SHA-256, or an aws-chunked streaming-signed PUT whose
chunks chain their signatures. One connection per request, as a fleet
of SDK clients without keep-alive. The server has no use for it: the
smoke script and the tests drive the port's server through it.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse

from . import signature as sig


class S3Client:
    """Requests to the server at 127.0.0.1:`port` under `creds`."""

    def __init__(self, port: int, creds, region: str = "us-east-1",
                 timeout: float = 600):
        self.port, self.creds, self.region = port, creds, region
        self.timeout = timeout

    def sign(self, method, path, query=None, body=b"", headers=None
             ) -> dict:
        """The request's headers with its SigV4 Authorization."""
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        hdrs["host"] = f"127.0.0.1:{self.port}"
        return sig.sign_v4(method, urllib.parse.quote(path),
                           {k: [v] for k, v in (query or {}).items()},
                           hdrs, hashlib.sha256(body).hexdigest(),
                           self.creds, self.region)

    def send(self, method, path, query=None, body=b"", headers=None,
             signed=None) -> tuple[int, dict, bytes]:
        """(status, lower-cased headers, body). `signed`: headers signed
        ahead of time (sign())."""
        hdrs = signed or self.sign(method, path, query, body, headers)
        qs = urllib.parse.urlencode(query or {})
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, urllib.parse.quote(path)
                         + (f"?{qs}" if qs else ""), body=body,
                         headers=hdrs)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, {k.lower(): v for k, v in
                                 resp.getheaders()}, data
        finally:
            conn.close()

    def streaming_put(self, path, data, chunk: int = 64 << 10):
        """One aws-chunked streaming-signed PUT: a seed signature over the
        headers, then a signature per chunk chained to the previous one
        (the reference's cmd/streaming-signature-v4.go)."""
        t = datetime.datetime.now(datetime.timezone.utc)
        amz_date = t.strftime(sig.ISO8601_FORMAT)
        date = t.strftime(sig.YYYYMMDD)
        scope = f"{date}/{self.region}/s3/aws4_request"
        chunks = [data[i:i + chunk] for i in range(0, len(data), chunk)]
        chunks.append(b"")
        enc_len = sum(len(f"{len(c):x};chunk-signature={'0' * 64}\r\n")
                      + len(c) + 2 for c in chunks)
        hdrs = {"host": f"127.0.0.1:{self.port}", "x-amz-date": amz_date,
                "x-amz-content-sha256": sig.STREAMING_CONTENT_SHA256,
                "x-amz-decoded-content-length": str(len(data)),
                "content-length": str(enc_len)}
        signed = sorted(["host", "x-amz-content-sha256", "x-amz-date",
                         "x-amz-decoded-content-length"])
        key = sig.signing_key(self.creds.secret_key, date, self.region)
        prev = hmac.new(key, sig.string_to_sign(sig.canonical_request(
            "PUT", path, "", hdrs, signed, sig.STREAMING_CONTENT_SHA256),
            amz_date, scope).encode(), hashlib.sha256).hexdigest()
        hdrs["authorization"] = (
            f"{sig.SIGN_V4_ALGORITHM} Credential={self.creds.access_key}/"
            f"{scope}, SignedHeaders={';'.join(signed)}, Signature={prev}")
        body = bytearray()
        for c in chunks:
            sts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope,
                             prev, sig.EMPTY_SHA256,
                             hashlib.sha256(c).hexdigest()])
            prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
            body += f"{len(c):x};chunk-signature={prev}\r\n".encode()
            body += c + b"\r\n"
        return self.send("PUT", path, body=bytes(body), signed=hdrs)
