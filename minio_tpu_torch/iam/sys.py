"""IAMSys — users, groups, policies, service accounts, STS credentials.

Counterpart of minio_tpu/iam/sys.py, host only: the records it persists
are erasure-coded objects of the port's layer, so each save encodes on
the card. ``last_load_s`` keeps the seconds of the last completed
``load`` (the boot's included). Left out: ``migrate_to_store`` (the move
of the records to the etcd store, which is not ported).

The reference's cmd/iam.go + cmd/iam-object-store.go: all IAM state
persists as JSON objects under `.minio.sys/config/iam/` through the
ObjectLayer itself (so it is erasure-coded and survives drive loss), with
an in-memory cache and peer-reload broadcast on change.

Layout (mirrors iam-object-store keys):
    config/iam/users/<ak>.json          identity (secret, status)
    config/iam/groups/<name>.json       {members, status}
    config/iam/policies/<name>.json     policy document
    config/iam/policydb/users/<ak>.json      {"policy": [names]}
    config/iam/policydb/groups/<name>.json   {"policy": [names]}
    config/iam/svcaccts/<ak>.json       service account (parent, secret)
    config/iam/sts/<ak>.json            temp credentials
"""

from __future__ import annotations

import base64
import json
import secrets
import threading
import time
from typing import Callable, Optional

from ..s3.credentials import Credentials, generate_credentials
from .policy import CANNED_POLICIES, Policy, PolicyArgs

IAM_PREFIX = "config/iam"
MINIO_META_BUCKET = ".minio.sys"


class IAMError(Exception):
    pass


class IAMSys:
    """In-memory IAM state over persisted JSON blobs.

    `object_layer=None` gives a purely in-memory IAM (tests, single-shot
    tools); with a layer every mutation persists before the cache updates.
    """

    def __init__(self, object_layer=None, root_cred: Optional[Credentials]
                 = None, store=None):
        from .store import ObjectIAMStore
        self.obj = object_layer
        # persistence backend (cmd/iam-object-store.go): the object
        # layer unless a store is given
        self.store = store if store is not None else (
            ObjectIAMStore(object_layer)
            if object_layer is not None else None)
        self.root = root_cred
        self._mu = threading.RLock()
        self.users: dict[str, Credentials] = {}
        self.groups: dict[str, dict] = {}           # name -> {members,status}
        self.policies: dict[str, Policy] = dict(CANNED_POLICIES)
        self.user_policy: dict[str, list[str]] = {}
        self.group_policy: dict[str, list[str]] = {}
        self.sts_creds: dict[str, Credentials] = {}
        self.svc_accounts: dict[str, Credentials] = {}
        # cluster hook: called with no args after every mutation so peers
        # reload (reference NotificationSys.LoadUser/LoadPolicy etc.)
        self.on_change: Optional[Callable[[], None]] = None
        # granular peer propagation: called with the mutation's whole
        # [(kind, name), ...] batch; when unset, on_change (wholesale)
        self.on_delta: Optional[Callable[[list], None]] = None
        # bucket policy lookup seam (bucket -> policy JSON or "")
        self.bucket_policy_lookup: Optional[Callable[[str], str]] = None
        # seconds the last completed load() took (the boot's included)
        self.last_load_s: Optional[float] = None
        if self.store is not None:
            self.load()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def _path(self, *parts: str) -> str:
        # one encoder for reads AND writes: store.entity_path owns the
        # percent-encoding (federated subjects like 'oidc:a/b' must
        # never collide with 'oidc:a_b', and the write path and the
        # delta read path must build byte-identical keys)
        from .store import entity_path
        return entity_path("/".join(parts[:-1]), parts[-1])

    def _save(self, path: str, payload: dict) -> None:
        if self.store is not None:
            self.store.save(path, payload)

    def _delete(self, path: str) -> None:
        if self.store is not None:
            self.store.delete(path)

    def _read_all(self, prefix: str) -> dict[str, dict]:
        """name -> parsed payload for every record under
        config/iam/<prefix>/ in the configured store."""
        if self.store is None:
            return {}
        return self.store.read_all(prefix)

    def load(self) -> None:
        """(Re)build the cache from the store (reference IAMSys.Load).
        Every prefix is read BEFORE the cache mutates, and a transient
        store failure keeps the existing cache — a backend blip must
        never read as "all identities deleted"."""
        from .store import IAMStoreError
        t0 = time.perf_counter()
        try:
            raw_users = self._read_all("users")
            raw_groups = self._read_all("groups")
            raw_policies = self._read_all("policies")
            raw_upol = self._read_all("policydb/users")
            raw_gpol = self._read_all("policydb/groups")
            raw_svc = self._read_all("svcaccts")
            raw_sts = self._read_all("sts")
        except IAMStoreError:
            return                # keep the current cache
        with self._mu:
            self.users = {
                ak: Credentials(access_key=ak,
                                secret_key=d.get("secret_key", ""),
                                status=d.get("status", "on"))
                for ak, d in raw_users.items()}
            self.groups = raw_groups
            self.policies = dict(CANNED_POLICIES)
            for name, d in raw_policies.items():
                try:
                    self.policies[name] = Policy.from_json(json.dumps(d))
                except (ValueError, KeyError):
                    continue
            self.user_policy = {
                ak: list(d.get("policy", []))
                for ak, d in raw_upol.items()}
            self.group_policy = {
                g: list(d.get("policy", []))
                for g, d in raw_gpol.items()}
            self.svc_accounts = {
                ak: Credentials(access_key=ak,
                                secret_key=d.get("secret_key", ""),
                                parent_user=d.get("parent", ""),
                                status=d.get("status", "on"))
                for ak, d in raw_svc.items()}
            now = time.time()
            self.sts_creds = {}
            for ak, d in raw_sts.items():
                c = Credentials(access_key=ak,
                                secret_key=d.get("secret_key", ""),
                                session_token=d.get("session_token", ""),
                                expiration=d.get("expiration", 0.0),
                                parent_user=d.get("parent", ""))
                if not c.is_expired() or c.expiration > now:
                    self.sts_creds[ak] = c
        self.last_load_s = time.perf_counter() - t0

    def _notify(self, kind: str = "", name: str = "") -> None:
        self._notify_batch([(kind, name)] if kind else [])

    def _notify_batch(self, pairs: list) -> None:
        """Propagate a mutation to peers. With (kind, name) deltas and
        an on_delta hook, peers reload ONLY those entities — in ONE
        broadcast round for the whole batch (reference granular
        LoadUser/LoadGroup/LoadPolicy peer verbs,
        cmd/peer-rest-common.go:38-46); wholesale reload is the
        fallback, not the steady state (it is O(all users) per change).
        """
        if pairs and self.on_delta is not None:
            try:
                self.on_delta(pairs)
                return
            except Exception:  # noqa: BLE001 — fall back to full reload
                pass
        if self.on_change is not None:
            try:
                self.on_change()
            except Exception:  # noqa: BLE001 — peers reload lazily anyway
                pass

    def _read_one(self, prefix: str, name: str) -> Optional[dict]:
        """Current stored record of one IAM entity, or None when it no
        longer exists (delta application reads the store, so a delete
        and a create are the same verb). A TRANSIENT store error must
        not read as "deleted" — it raises IAMStoreError, and
        apply_delta degrades to a full reload instead of evicting a
        live credential."""
        if self.store is None:
            return None
        return self.store.read_one(prefix, name)

    def apply_delta(self, kind: str, name: str) -> None:
        """Refresh one entity from the store (the receiving side of the
        peer delta verbs). Unknown kinds degrade to a full load."""
        from .store import IAMStoreError
        d = None
        if kind in ("user", "group", "policy", "user-policy",
                    "group-policy", "svcacct", "sts"):
            prefix = {"user": "users", "group": "groups",
                      "policy": "policies",
                      "user-policy": "policydb/users",
                      "group-policy": "policydb/groups",
                      "svcacct": "svcaccts", "sts": "sts"}[kind]
            try:
                d = self._read_one(prefix, name)
            except IAMStoreError:
                # backend blip on the read: keep the cached entry and
                # resync wholesale rather than evicting a live identity
                try:
                    self.load()
                except IAMStoreError:
                    pass
                return
        with self._mu:
            if kind == "user":
                if d is None:
                    self.users.pop(name, None)
                else:
                    self.users[name] = Credentials(
                        access_key=name,
                        secret_key=d.get("secret_key", ""),
                        status=d.get("status", "on"))
                return
            if kind == "group":
                if d is None:
                    self.groups.pop(name, None)
                else:
                    self.groups[name] = d
                return
            if kind == "policy":
                if d is None:
                    self.policies.pop(name, None)
                    if name in CANNED_POLICIES:
                        self.policies[name] = CANNED_POLICIES[name]
                else:
                    try:
                        self.policies[name] = Policy.from_json(
                            json.dumps(d))
                    except (ValueError, KeyError):
                        pass
                return
            if kind == "user-policy":
                if d is None:
                    self.user_policy.pop(name, None)
                else:
                    self.user_policy[name] = list(d.get("policy", []))
                return
            if kind == "group-policy":
                if d is None:
                    self.group_policy.pop(name, None)
                else:
                    self.group_policy[name] = list(d.get("policy", []))
                return
            if kind == "svcacct":
                if d is None:
                    self.svc_accounts.pop(name, None)
                else:
                    self.svc_accounts[name] = Credentials(
                        access_key=name,
                        secret_key=d.get("secret_key", ""),
                        parent_user=d.get("parent", ""),
                        status=d.get("status", "on"))
                return
            if kind == "sts":
                if d is None:
                    self.sts_creds.pop(name, None)
                else:
                    self.sts_creds[name] = Credentials(
                        access_key=name,
                        secret_key=d.get("secret_key", ""),
                        session_token=d.get("session_token", ""),
                        expiration=d.get("expiration", 0.0),
                        parent_user=d.get("parent", ""))
                return
        self.load()

    # ------------------------------------------------------------------
    # users / groups / policies CRUD (cmd/admin-handlers-users.go surface)
    # ------------------------------------------------------------------

    def add_user(self, access_key: str, secret_key: str,
                 status: str = "on") -> None:
        if self.root is not None and access_key == self.root.access_key:
            raise IAMError("cannot override root account")
        with self._mu:
            self._save(self._path("users", access_key),
                       {"secret_key": secret_key, "status": status})
            self.users[access_key] = Credentials(
                access_key=access_key, secret_key=secret_key, status=status)
        self._notify("user", access_key)

    def set_user_status(self, access_key: str, status: str) -> None:
        with self._mu:
            u = self.users.get(access_key)
            if u is None:
                raise IAMError(f"no such user {access_key}")
            u.status = status
            self._save(self._path("users", access_key),
                       {"secret_key": u.secret_key, "status": status})
        self._notify("user", access_key)

    def remove_user(self, access_key: str) -> None:
        dropped_svc: list[str] = []
        dropped_sts: list[str] = []
        with self._mu:
            self.users.pop(access_key, None)
            self.user_policy.pop(access_key, None)
            self._delete(self._path("users", access_key))
            self._delete(self._path("policydb/users", access_key))
            # drop the user's service accounts + STS creds
            for ak, c in list(self.svc_accounts.items()):
                if c.parent_user == access_key:
                    self.svc_accounts.pop(ak, None)
                    self._delete(self._path("svcaccts", ak))
                    dropped_svc.append(ak)
            for ak, c in list(self.sts_creds.items()):
                if c.parent_user == access_key:
                    self.sts_creds.pop(ak, None)
                    self._delete(self._path("sts", ak))
                    dropped_sts.append(ak)
        self._notify_batch(
            [("user", access_key), ("user-policy", access_key)]
            + [("svcacct", ak) for ak in dropped_svc]
            + [("sts", ak) for ak in dropped_sts])

    def list_users(self) -> list[str]:
        with self._mu:
            return sorted(self.users)

    def add_members_to_group(self, group: str, members: list[str]) -> None:
        with self._mu:
            g = self.groups.setdefault(group,
                                       {"members": [], "status": "on"})
            for m in members:
                if m not in self.users:
                    raise IAMError(f"no such user {m}")
                if m not in g["members"]:
                    g["members"].append(m)
            self._save(self._path("groups", group), g)
        self._notify("group", group)

    def remove_members_from_group(self, group: str,
                                  members: list[str]) -> None:
        with self._mu:
            g = self.groups.get(group)
            if g is None:
                raise IAMError(f"no such group {group}")
            g["members"] = [m for m in g["members"] if m not in members]
            if g["members"]:
                self._save(self._path("groups", group), g)
            else:
                self.groups.pop(group, None)
                self.group_policy.pop(group, None)
                self._delete(self._path("groups", group))
                self._delete(self._path("policydb/groups", group))
        self._notify_batch([("group", group), ("group-policy", group)])

    def set_policy(self, name: str, policy: Policy) -> None:
        """Create/replace a named policy document."""
        with self._mu:
            self.policies[name] = policy
            self._save(self._path("policies", name),
                       json.loads(policy.to_json()))
        self._notify("policy", name)

    def delete_policy(self, name: str) -> None:
        with self._mu:
            if name in CANNED_POLICIES:
                raise IAMError(f"cannot delete canned policy {name}")
            self.policies.pop(name, None)
            self._delete(self._path("policies", name))
        self._notify("policy", name)

    def attach_policy(self, names: str | list[str], user: str = "",
                      group: str = "") -> None:
        """Map policy name(s) to a user or group (reference
        IAMSys.PolicyDBSet)."""
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",") if n.strip()]
        with self._mu:
            for n in names:
                if n not in self.policies:
                    raise IAMError(f"no such policy {n}")
            if user:
                self.user_policy[user] = names
                self._save(self._path("policydb/users", user),
                           {"policy": names})
            elif group:
                self.group_policy[group] = names
                self._save(self._path("policydb/groups", group),
                           {"policy": names})
            else:
                raise IAMError("user or group required")
        if user:
            self._notify("user-policy", user)
        else:
            self._notify("group-policy", group)

    # ------------------------------------------------------------------
    # service accounts + STS
    # ------------------------------------------------------------------

    def new_service_account(self, parent_user: str,
                            access_key: str = "",
                            secret_key: str = "") -> Credentials:
        with self._mu:
            if not access_key:
                fresh = generate_credentials()
                access_key = fresh.access_key
                secret_key = fresh.secret_key
            cred = Credentials(access_key=access_key,
                               secret_key=secret_key,
                               parent_user=parent_user)
            self.svc_accounts[access_key] = cred
            self._save(self._path("svcaccts", access_key),
                       {"secret_key": secret_key, "parent": parent_user,
                        "status": "on"})
        self._notify("svcacct", access_key)
        return cred

    def _mint_sts(self, parent: str, duration_seconds: int
                  ) -> Credentials:
        """Shared STS mint-and-persist (one copy of the sts/ record
        format for assume_role and the federation paths)."""
        fresh = generate_credentials()
        token = base64.urlsafe_b64encode(secrets.token_bytes(24)).decode()
        cred = Credentials(
            access_key=fresh.access_key, secret_key=fresh.secret_key,
            session_token=token,
            expiration=time.time() + duration_seconds,
            parent_user=parent)
        with self._mu:
            self.sts_creds[cred.access_key] = cred
            self._save(self._path("sts", cred.access_key),
                       {"secret_key": cred.secret_key,
                        "session_token": cred.session_token,
                        "expiration": cred.expiration,
                        "parent": cred.parent_user})
        return cred

    def assume_role(self, parent_cred: Credentials,
                    duration_seconds: int = 3600) -> Credentials:
        """Mint temp credentials for an authenticated user (reference
        AssumeRole, cmd/sts-handlers.go:43-86)."""
        duration_seconds = max(900, min(duration_seconds, 7 * 24 * 3600))
        cred = self._mint_sts(
            parent_cred.parent_user or parent_cred.access_key,
            duration_seconds)
        self._notify("sts", cred.access_key)
        return cred

    def assume_role_with_claims(self, subject: str,
                                policy_names: Optional[list[str]],
                                duration_seconds: int = 3600,
                                max_seconds: Optional[float] = None
                                ) -> Credentials:
        """Mint temp credentials for a FEDERATED identity (OIDC subject
        or LDAP DN) — reference AssumeRoleWithWebIdentity/ClientGrants/
        LDAPIdentity minting (cmd/sts-handlers.go:43-86). The cred's
        parent is the federated subject; with policy_names given (OIDC
        policy claim) the subject's policy mapping is set from the
        token, with None (LDAP) the policy DB mapping for the DN — set
        by the admin beforehand — stays authoritative. max_seconds (the
        identity token's remaining lifetime) caps the minted cred AFTER
        the floor — credentials must never outlive the token that
        authenticated them (reference bounds STS expiry by JWT exp)."""
        duration_seconds = max(900, min(duration_seconds, 7 * 24 * 3600))
        if max_seconds is not None:
            duration_seconds = min(duration_seconds, int(max_seconds))
            if duration_seconds <= 0:
                raise IAMError("identity token already expired")
        cred = self._mint_sts(subject, duration_seconds)
        pairs = [("sts", cred.access_key)]
        if policy_names is not None:
            with self._mu:
                self.user_policy[subject] = list(policy_names)
                self._save(self._path("policydb/users", subject),
                           {"policy": list(policy_names)})
            pairs.append(("user-policy", subject))
        self._notify_batch(pairs)
        return cred

    # ------------------------------------------------------------------
    # the authorization surface the S3 handlers consume
    # ------------------------------------------------------------------

    def get_credentials(self, access_key: str) -> Optional[Credentials]:
        with self._mu:
            for table in (self.users, self.svc_accounts, self.sts_creds):
                c = table.get(access_key)
                if c is not None:
                    return c
        return None

    def account_of(self, access_key: str) -> Optional[str]:
        """The billing/QoS tenant an access key belongs to: service
        accounts and STS temp creds roll up to their parent user, plain
        users stand for themselves. None when the key is not registered
        here (the root credential lives outside the IAM tables)."""
        cred = self.get_credentials(access_key)
        if cred is None:
            return None
        return cred.parent_user or cred.access_key

    def _effective_policy_names(self, access_key: str) -> list[str]:
        names = list(self.user_policy.get(access_key, []))
        for g, info in self.groups.items():
            if info.get("status", "on") == "on" and \
                    access_key in info.get("members", []):
                names.extend(self.group_policy.get(g, []))
        return names

    def is_allowed(self, cred: Credentials, action: str, bucket: str,
                   object_name: str = "",
                   conditions: Optional[dict] = None) -> bool:
        """Identity-policy + bucket-policy union (reference
        IAMSys.IsAllowed + PolicyDBGet; temp/service creds evaluate their
        parent's policies)."""
        account = cred.parent_user or cred.access_key
        if cred.is_expired():
            return False
        args = PolicyArgs(account=account, action=action, bucket=bucket,
                          object=object_name,
                          conditions=dict(conditions or {}))
        with self._mu:
            names = self._effective_policy_names(account)
            docs = [self.policies[n] for n in names if n in self.policies]
        # bucket policy participates in the same deny/allow algebra
        if bucket and self.bucket_policy_lookup is not None:
            raw = self.bucket_policy_lookup(bucket)
            if raw:
                try:
                    docs.append(Policy.from_json(raw))
                except (ValueError, KeyError):
                    pass
        for doc in docs:
            # explicit deny in ANY applicable policy wins
            for st in doc.statements:
                if st.effect == "Deny" and st.applies(args):
                    return False
        return any(doc.is_allowed(args) for doc in docs)

    def is_anonymous_allowed(self, policy_json: str, action: str,
                             bucket: str, object_name: str = "",
                             conditions: Optional[dict] = None) -> bool:
        if not policy_json:
            return False
        try:
            doc = Policy.from_json(policy_json)
        except (ValueError, KeyError):
            return False
        return doc.is_allowed(PolicyArgs(
            account="*", action=action, bucket=bucket, object=object_name,
            conditions=dict(conditions or {})))
