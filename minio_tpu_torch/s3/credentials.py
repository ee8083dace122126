"""Credentials model (reference pkg/auth/credentials.go).

Access/secret pairs with optional session token + expiry, used by both
the root account and IAM-issued users/service-accounts/STS creds.
"""

from __future__ import annotations

import base64
import dataclasses
import os
import secrets
import time
from typing import Optional

ACCESS_KEY_MIN_LEN = 3
ACCESS_KEY_MAX_LEN = 20
SECRET_KEY_MIN_LEN = 8
SECRET_KEY_MAX_LEN = 40

DEFAULT_ACCESS_KEY = "minioadmin"
DEFAULT_SECRET_KEY = "minioadmin"

_ALNUM = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


@dataclasses.dataclass
class Credentials:
    access_key: str = ""
    secret_key: str = ""
    session_token: str = ""
    expiration: float = 0.0       # unix seconds; 0 = never
    status: str = "on"            # "on" | "off"
    parent_user: str = ""         # set for service accounts / STS creds

    def is_expired(self) -> bool:
        return self.expiration > 0 and time.time() > self.expiration

    def is_temp(self) -> bool:
        return bool(self.session_token)

    def is_service_account(self) -> bool:
        return bool(self.parent_user) and not self.session_token

    def is_valid(self) -> bool:
        return (self.status != "off" and bool(self.access_key)
                and bool(self.secret_key) and not self.is_expired())

    def equal(self, other: "Credentials") -> bool:
        return (self.access_key == other.access_key
                and self.secret_key == other.secret_key
                and self.session_token == other.session_token)


def generate_credentials() -> Credentials:
    """Random access/secret pair (reference GetNewCredentials)."""
    access = "".join(secrets.choice(_ALNUM) for _ in range(20))
    secret = base64.b64encode(os.urandom(30)).decode()[:40].replace("/", "+")
    return Credentials(access_key=access, secret_key=secret)


def global_credentials() -> Credentials:
    """Root credentials from env (MINIO_ACCESS_KEY / MINIO_SECRET_KEY,
    falling back to minioadmin:minioadmin like the reference)."""
    return Credentials(
        access_key=os.environ.get(
            "MINIO_ACCESS_KEY",
            os.environ.get("MINIO_ROOT_USER", DEFAULT_ACCESS_KEY)),
        secret_key=os.environ.get(
            "MINIO_SECRET_KEY",
            os.environ.get("MINIO_ROOT_PASSWORD", DEFAULT_SECRET_KEY)))


def is_access_key_valid(ak: str) -> bool:
    return ACCESS_KEY_MIN_LEN <= len(ak)


def is_secret_key_valid(sk: str) -> bool:
    return SECRET_KEY_MIN_LEN <= len(sk)
