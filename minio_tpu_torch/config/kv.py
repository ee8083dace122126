"""Typed KV config: subsystems, env overrides, encrypted persistence,
history + rollback.

Counterpart of minio_tpu/config/kv.py, host only. The blob is sealed with
AES-256-GCM from ``cryptography`` (``SEAL`` names it), byte for byte the
reference's: the same key derivation, a 12-byte nonce prefix, no
associated data, so a config either package stored loads in the other.
The stored blob is an erasure-coded object of the port's layer. ``apply``
pushes what the port has into the handlers (region, CORS origin,
compression, the request cap, the static KMS and KES) and the audit
webhook into the trace plane (s3/trace.TraceSys) and the notify
subsystems' targets into the legacy event notifier
(features/events.EventNotifier). Departure: MINIO_COMPRESS and
MINIO_COMPRESS_ALGORITHM overlay the compression keys (``_LEGACY_ENV``);
the reference's apply at boot turns off the compression those two env
names turned on. Departures too: with nothing stored yet the env overlay
still applies (the reference's load returns before it), and requests_max
0 restores the gate the boot sized from its RAM and CPU budget
(``api.requests_budget``) where the reference sets 256.

The reference's cmd/config system (cmd/config/config.go:101-127 subsystem
enumeration; cmd/config-encrypted.go stores the blob encrypted with the
root credentials; cmd/admin-handlers-config-kv.go history/rollback;
lookupConfigs applies values at startup). Same architecture here:

  * a registry of subsystems with typed default keys,
  * `MINIO_<SUBSYS>_<KEY>` environment variables override stored values,
  * the blob persists AES-GCM-encrypted under the root secret at
    .minio.sys/config/config.json through the ObjectLayer,
  * every set() snapshots the previous blob into config/history/,
  * apply() pushes live values into the running server (compression,
    region, API limits, KMS).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import threading
import time

CONFIG_OBJECT = "config/config.json"
HISTORY_PREFIX = "config/history"
MINIO_META_BUCKET = ".minio.sys"

# subsystem -> {key: default} (reference cmd/config/config.go:101-127)
SUBSYSTEMS: dict[str, dict[str, str]] = {
    "api": {"requests_max": "0", "cors_allow_origin": "*"},
    "region": {"name": "us-east-1"},
    "compression": {"enable": "off",
                    "algorithm": "s2",
                    "extensions": ".txt,.log,.csv,.json,.tar,.xml,.bin",
                    "mime_types": "text/*,application/json"},
    "storage_class": {"standard": "", "rrs": ""},
    "heal": {"interval": "10s", "max_io": "4"},
    "scanner": {"interval": "60s"},
    "etcd": {"endpoints": "", "domain": ""},
    "identity_openid": {"config_url": "", "client_id": "",
                        "jwks": "", "jwks_file": "",
                        "claim_name": "policy", "claim_prefix": ""},
    "identity_ldap": {"server_addr": "", "user_dn_format": ""},
    "kms_secret_key": {"key": ""},
    "kms_kes": {"enable": "off", "endpoint": "", "key_name": "",
                "api_key": ""},
    "logger_webhook": {"enable": "off", "endpoint": ""},
    "audit_webhook": {"enable": "off", "endpoint": ""},
    "notify_webhook": {"enable": "off", "endpoint": "",
                       "queue_limit": "10000"},
    "notify_redis": {"enable": "off", "address": "", "key": "minioevents",
                     "format": "namespace", "password": ""},
    "notify_kafka": {"enable": "off", "brokers": "", "topic": ""},
    "notify_mqtt": {"enable": "off", "broker": "", "topic": ""},
    "notify_nats": {"enable": "off", "address": "",
                    "subject": "minioevents"},
    "notify_nsq": {"enable": "off", "address": "",
                   "topic": "minioevents"},
    "notify_amqp": {"enable": "off", "address": "", "exchange": "",
                    "routing_key": "minioevents", "user": "guest",
                    "password": "guest", "vhost": "/"},
    "notify_elasticsearch": {"enable": "off", "url": "",
                             "index": "minioevents",
                             "format": "namespace"},
    "notify_postgres": {"enable": "off", "address": "",
                        "database": "", "table": "minioevents",
                        "user": "postgres", "password": "",
                        "format": "namespace"},
    "notify_mysql": {"enable": "off", "address": "",
                     "database": "", "table": "minioevents",
                     "user": "root", "password": "",
                     "format": "namespace"},
}


class ConfigError(Exception):
    pass


# the AES-256-GCM that seals the stored blob
SEAL = "cryptography AESGCM"


def _derive_key(secret: str) -> bytes:
    return hashlib.sha256(b"minio-tpu-config:" + secret.encode()).digest()


def _encrypt(secret: str, plain: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    nonce = secrets.token_bytes(12)
    return nonce + AESGCM(_derive_key(secret)).encrypt(nonce, plain, b"")


def _decrypt(secret: str, blob: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    return AESGCM(_derive_key(secret)).decrypt(blob[:12], blob[12:], b"")


# keys whose values must parse as non-negative integers
_INT_KEYS = {("api", "requests_max"), ("heal", "max_io"),
             ("notify_webhook", "queue_limit")}
# keys restricted to on/off
_BOOL_KEYS = {("compression", "enable"), ("logger_webhook", "enable"),
              ("audit_webhook", "enable"), ("notify_webhook", "enable")}

HISTORY_KEEP = 50

# env names the handlers read -> the config key each stands for
_LEGACY_ENV = {"MINIO_COMPRESS": ("compression", "enable"),
               "MINIO_COMPRESS_ALGORITHM": ("compression", "algorithm")}


def _validate(subsys: str, key: str, value: str) -> None:
    if (subsys, key) in _INT_KEYS:
        try:
            if int(value) < 0:
                raise ValueError
        except ValueError:
            raise ConfigError(
                f"{subsys}/{key} must be a non-negative integer, "
                f"got {value!r}") from None
    if (subsys, key) in _BOOL_KEYS and value.lower() not in (
            "on", "off", "true", "false", "1", "0", ""):
        raise ConfigError(f"{subsys}/{key} must be on or off")


class ConfigSys:
    def __init__(self, object_layer=None, secret: str = ""):
        self.obj = object_layer
        self.secret = secret
        self._mu = threading.RLock()
        self._kv: dict[str, dict[str, str]] = {
            s: dict(defaults) for s, defaults in SUBSYSTEMS.items()}
        # env overlay, consulted by get() with highest precedence but
        # NEVER persisted (set_kv writes only the stored layer)
        self._env: dict[tuple[str, str], str] = {}
        if self.obj is not None:
            self.load()
        else:
            self._apply_env()

    # -- persistence -------------------------------------------------------

    def load(self) -> None:
        from ..object import api_errors
        try:
            _, stream = self.obj.get_object(MINIO_META_BUCKET,
                                            CONFIG_OBJECT)
            blob = b"".join(stream)
        except api_errors.ObjectApiError:
            # nothing stored yet: the env overlay still applies
            self._apply_env()
            return
        try:
            plain = _decrypt(self.secret, blob) if self.secret else blob
            stored = json.loads(plain.decode())
        except Exception as e:  # noqa: BLE001
            # an unreadable stored config is a hard error: silently
            # falling back to defaults would drop security-relevant
            # settings (the reference also refuses to start)
            raise ConfigError(f"config undecryptable: {e}") from e
        with self._mu:
            for subsys, kv in stored.items():
                if subsys in self._kv and isinstance(kv, dict):
                    self._kv[subsys].update(
                        {k: str(v) for k, v in kv.items()})
        self._apply_env()

    def _persist(self) -> None:
        if self.obj is None:
            return
        from ..object import api_errors
        # the whole read-snapshot-write cycle runs under the lock so two
        # concurrent set_kv calls cannot store a stale blob
        with self._mu:
            plain = json.dumps(self._kv, sort_keys=True).encode()
            try:
                _, stream = self.obj.get_object(MINIO_META_BUCKET,
                                                CONFIG_OBJECT)
                prev = b"".join(stream)
                # microsecond-resolution name keeps history lexically
                # ordered even for rapid successive writes
                now = time.time()
                ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
                ts += f"{int(now * 1e6) % 1_000_000:06d}Z"
                self.obj.put_object(
                    MINIO_META_BUCKET,
                    f"{HISTORY_PREFIX}/{ts}-{secrets.token_hex(4)}.json",
                    prev)
            except api_errors.ObjectApiError:
                pass
            blob = _encrypt(self.secret, plain) if self.secret else plain
            self.obj.put_object(MINIO_META_BUCKET, CONFIG_OBJECT, blob)
            self._prune_history()

    def _prune_history(self) -> None:
        """Cap history at HISTORY_KEEP newest snapshots."""
        from ..object import api_errors
        try:
            entries = self.history()
        except api_errors.ObjectApiError:
            return
        for entry in entries[:-HISTORY_KEEP]:
            try:
                self.obj.delete_object(MINIO_META_BUCKET,
                                       f"{HISTORY_PREFIX}/{entry}")
            except api_errors.ObjectApiError:
                pass

    def _apply_env(self) -> None:
        """MINIO_<SUBSYS>_<KEY> env overrides: an overlay with highest
        read precedence, never merged into the persisted layer. The
        handlers' own compression switches, MINIO_COMPRESS and
        MINIO_COMPRESS_ALGORITHM, count as the compression keys where
        the MINIO_COMPRESSION_* names are unset (upstream reads the first
        as its legacy name), so that a boot's apply keeps them."""
        with self._mu:
            self._env = {}
            for subsys, kv in self._kv.items():
                for key in kv:
                    env = f"MINIO_{subsys.upper()}_{key.upper()}"
                    if env in os.environ:
                        self._env[(subsys, key)] = os.environ[env]
            for legacy, key in _LEGACY_ENV.items():
                if legacy in os.environ:
                    self._env.setdefault(key, os.environ[legacy])

    # -- KV surface --------------------------------------------------------

    def get(self, subsys: str, key: str) -> str:
        with self._mu:
            if (subsys, key) in self._env:
                return self._env[(subsys, key)]
            try:
                return self._kv[subsys][key]
            except KeyError:
                raise ConfigError(
                    f"unknown config key {subsys}/{key}") from None

    def get_subsys(self, subsys: str) -> dict[str, str]:
        with self._mu:
            if subsys not in self._kv:
                raise ConfigError(f"unknown subsystem {subsys}")
            out = dict(self._kv[subsys])
            for (s2, k), v in self._env.items():
                if s2 == subsys:
                    out[k] = v
            return out

    def dump(self) -> dict:
        with self._mu:
            out = {s: dict(kv) for s, kv in self._kv.items()}
            for (s2, k), v in self._env.items():
                out[s2][k] = v
            return out

    def set_kv(self, subsys: str, **kv: str) -> None:
        with self._mu:
            if subsys not in self._kv:
                raise ConfigError(f"unknown subsystem {subsys}")
            for k, v in kv.items():
                if k not in SUBSYSTEMS[subsys]:
                    raise ConfigError(f"unknown key {subsys}/{k}")
                _validate(subsys, k, str(v))
            self._kv[subsys].update({k: str(v) for k, v in kv.items()})
        self._persist()

    # -- history / rollback ------------------------------------------------

    def history(self) -> list[str]:
        from ..object import api_errors
        if self.obj is None:
            return []
        try:
            objs, _, _ = self.obj.list_objects(
                MINIO_META_BUCKET, prefix=HISTORY_PREFIX + "/",
                max_keys=1000)
        except api_errors.ObjectApiError:
            return []
        return [o.name[len(HISTORY_PREFIX) + 1:] for o in objs]

    def restore(self, entry: str) -> None:
        from ..object import api_errors
        try:
            _, stream = self.obj.get_object(
                MINIO_META_BUCKET, f"{HISTORY_PREFIX}/{entry}")
            blob = b"".join(stream)
        except api_errors.ObjectApiError:
            raise ConfigError(f"no history entry {entry}") from None
        plain = _decrypt(self.secret, blob) if self.secret else blob
        stored = json.loads(plain.decode())
        with self._mu:
            for subsys, kv in stored.items():
                if subsys in self._kv and isinstance(kv, dict):
                    self._kv[subsys] = dict(SUBSYSTEMS[subsys])
                    self._kv[subsys].update(
                        {k: str(v) for k, v in kv.items()})
        self._persist()

    # -- live application (lookupConfigs, cmd/config-current.go:323) -------

    CONFIG_WEBHOOK_ARN = "arn:minio:sqs::_:webhook"
    CONFIG_REDIS_ARN = "arn:minio:sqs::_:redis"
    CONFIG_KAFKA_ARN = "arn:minio:sqs::_:kafka"
    CONFIG_MQTT_ARN = "arn:minio:sqs::_:mqtt"
    CONFIG_NATS_ARN = "arn:minio:sqs::_:nats"
    CONFIG_NSQ_ARN = "arn:minio:sqs::_:nsq"
    CONFIG_AMQP_ARN = "arn:minio:sqs::_:amqp"
    CONFIG_POSTGRES_ARN = "arn:minio:sqs::_:postgresql"
    CONFIG_MYSQL_ARN = "arn:minio:sqs::_:mysql"
    CONFIG_ELASTIC_ARN = "arn:minio:sqs::_:elasticsearch"

    def apply(self, api, events=None, trace=None) -> None:
        """Push config into a running S3ApiHandlers: region, the CORS
        origin, compression, the API's request cap and the KMS.
        Off-transitions are applied too: resetting requests_max restores
        the default cap, an audit webhook turned off stops shipping, and
        a notify target turned off is unregistered. ``trace``
        (s3/trace.TraceSys) takes the audit webhook; ``events``
        (features/events.EventNotifier) takes the notify subsystems'
        targets."""
        api.region = self.get("region", "name")
        api.cors_allow_origin = self.get("api", "cors_allow_origin")
        api.compression_enabled = \
            self.get("compression", "enable").lower() in ("on", "true", "1")
        # "s2" = snappy framing, readable by the reference binary;
        # "zstd" = better ratio, this framework only
        api.compression_algorithm = \
            self.get("compression", "algorithm").lower() or "s2"
        try:
            reqs = int(self.get("api", "requests_max") or 0)
        except ValueError:
            reqs = 0
        api.set_max_clients(reqs if reqs > 0
                            else api.requests_budget or 256)
        # KMS precedence: a configured KES endpoint (the production
        # SSE-S3 shape, cmd/crypto/kes.go) wins over a static key
        if self.get("kms_kes", "enable").lower() in ("on", "true", "1"):
            from ..features.kms import KESClient
            try:
                api.kms = KESClient(
                    self.get("kms_kes", "endpoint"),
                    self.get("kms_kes", "key_name"),
                    api_key=self.get("kms_kes", "api_key"))
            except ValueError:
                pass                     # bad endpoint: keep prior KMS
        else:
            kms = self.get("kms_secret_key", "key")
            if kms:
                from ..features.kms import StaticKMS
                try:
                    key = bytes.fromhex(kms)
                    if len(key) == 32:
                        api.kms = StaticKMS(key)
                except ValueError:
                    pass
        if trace is not None:
            if self.get("audit_webhook", "enable").lower() in ("on",
                                                               "true", "1"):
                trace.audit_webhook = self.get("audit_webhook", "endpoint")
            else:
                trace.audit_webhook = ""
        if events is not None:
            def _on(subsys: str) -> bool:
                return self.get(subsys, "enable").lower() in ("on",
                                                              "true", "1")

            def _register(target_factory) -> None:
                # a malformed notify config (e.g. bad NATS subject)
                # must not crash boot/apply: log and leave the target
                # unregistered
                try:
                    events.register_target(target_factory())
                except Exception as e:  # noqa: BLE001
                    from ..utils.console import get_console
                    get_console().log_line(
                        "ERROR", f"notify target rejected: {e}")
            from ..features.events import (KafkaTarget, MQTTTarget,
                                           RedisTarget, WebhookTarget)
            if _on("notify_webhook"):
                _register(lambda: WebhookTarget(
                    self.CONFIG_WEBHOOK_ARN,
                    self.get("notify_webhook", "endpoint")))
            else:
                events.unregister_target(self.CONFIG_WEBHOOK_ARN)
            if _on("notify_redis"):
                _register(lambda: RedisTarget(
                    self.CONFIG_REDIS_ARN,
                    self.get("notify_redis", "address"),
                    self.get("notify_redis", "key"),
                    format=self.get("notify_redis", "format"),
                    password=self.get("notify_redis", "password")))
            else:
                events.unregister_target(self.CONFIG_REDIS_ARN)
            if _on("notify_kafka"):
                _register(lambda: KafkaTarget(
                    self.CONFIG_KAFKA_ARN,
                    [b.strip() for b in
                     self.get("notify_kafka", "brokers").split(",")
                     if b.strip()],
                    self.get("notify_kafka", "topic")))
            else:
                events.unregister_target(self.CONFIG_KAFKA_ARN)
            if _on("notify_mqtt"):
                _register(lambda: MQTTTarget(
                    self.CONFIG_MQTT_ARN,
                    self.get("notify_mqtt", "broker"),
                    self.get("notify_mqtt", "topic")))
            else:
                events.unregister_target(self.CONFIG_MQTT_ARN)
            from ..features.events import (ElasticsearchTarget,
                                           NATSTarget)
            if _on("notify_nats"):
                _register(lambda: NATSTarget(
                    self.CONFIG_NATS_ARN,
                    self.get("notify_nats", "address"),
                    self.get("notify_nats", "subject")))
            else:
                events.unregister_target(self.CONFIG_NATS_ARN)
            from ..features.events import AMQPTarget, NSQTarget
            if _on("notify_amqp"):
                _register(lambda: AMQPTarget(
                    self.CONFIG_AMQP_ARN,
                    self.get("notify_amqp", "address"),
                    exchange=self.get("notify_amqp", "exchange"),
                    routing_key=self.get("notify_amqp", "routing_key"),
                    user=self.get("notify_amqp", "user"),
                    password=self.get("notify_amqp", "password"),
                    vhost=self.get("notify_amqp", "vhost")))
            else:
                events.unregister_target(self.CONFIG_AMQP_ARN)
            if _on("notify_nsq"):
                _register(lambda: NSQTarget(
                    self.CONFIG_NSQ_ARN,
                    self.get("notify_nsq", "address"),
                    self.get("notify_nsq", "topic")))
            else:
                events.unregister_target(self.CONFIG_NSQ_ARN)
            from ..features.events import MySQLTarget, PostgresTarget
            if _on("notify_mysql"):
                _register(lambda: MySQLTarget(
                    self.CONFIG_MYSQL_ARN,
                    self.get("notify_mysql", "address"),
                    self.get("notify_mysql", "database"),
                    self.get("notify_mysql", "table"),
                    user=self.get("notify_mysql", "user"),
                    password=self.get("notify_mysql", "password"),
                    format=self.get("notify_mysql", "format")))
            else:
                events.unregister_target(self.CONFIG_MYSQL_ARN)
            if _on("notify_postgres"):
                _register(lambda: PostgresTarget(
                    self.CONFIG_POSTGRES_ARN,
                    self.get("notify_postgres", "address"),
                    self.get("notify_postgres", "database"),
                    self.get("notify_postgres", "table"),
                    user=self.get("notify_postgres", "user"),
                    password=self.get("notify_postgres", "password"),
                    format=self.get("notify_postgres", "format")))
            else:
                events.unregister_target(self.CONFIG_POSTGRES_ARN)
            if _on("notify_elasticsearch"):
                _register(lambda: ElasticsearchTarget(
                    self.CONFIG_ELASTIC_ARN,
                    self.get("notify_elasticsearch", "url"),
                    self.get("notify_elasticsearch", "index"),
                    format=self.get("notify_elasticsearch", "format")))
            else:
                events.unregister_target(self.CONFIG_ELASTIC_ARN)
