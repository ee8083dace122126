"""The port's config KV (minio_tpu_torch/config/kv.py) held against
minio_tpu's.

  * tests/test_config_listen.py's config cases rebound to the port
    (tests/test_torch_iam.rebound): defaults, set and reload, the wrong
    secret refused, unknown keys, env overrides, history and rollback,
    the AES-256-GCM seal, and the admin get-config / set-config /
    config-history routes over HTTP; the live apply restated for what the
    port applies (the audit webhook goes to the trace plane, a
    notify_webhook turned on and off registers and unregisters its
    target with the event notifier), the reference's live apply and
    ListenBucketNotification over an FS server;
  * a config stored by either package over the same drives loads in the
    other, history and rollback included, and with the seal's nonce,
    the history names and the clock pinned both packages leave the same
    drive files;
  * the seal itself: the port's blob under a pinned nonce equals the
    reference's byte for byte, and each opens the other's.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

import minio_tpu.config.kv as ref_kv
import minio_tpu_torch.config.kv as port_kv
import tests.test_config_listen as ref_cases
from minio_tpu.config import ConfigSys as RefConfigSys
from minio_tpu_torch import device as device_mod
from minio_tpu_torch.config import ConfigSys
from minio_tpu_torch.config.kv import ConfigError
from minio_tpu_torch.features.events import EventNotifier
from minio_tpu_torch.object.fs import FSObjects
from minio_tpu_torch.s3.handlers import S3ApiHandlers
from tests.test_torch_iam import CREDS, _ref_sets, _sets, rebound
from tests.test_torch_s3 import drive_files


@pytest.fixture
def cpu_default(monkeypatch):
    monkeypatch.setattr(device_mod, "resolve",
                        lambda d=None: torch.device("cpu" if d is None
                                                    else d))


@pytest.mark.parametrize("name", [
    "test_config_defaults_and_set", "test_config_unknown_keys_rejected",
    "test_config_history_rollback", "test_admin_config_endpoints",
    "test_config_apply_live", "test_listen_bucket_notification"])
def test_reference_config_cases(tmp_path, cpu_default, name):
    rebound(getattr(ref_cases, name))(tmp_path)


def test_reference_env_override_case(tmp_path, monkeypatch):
    rebound(ref_cases.test_config_env_override)(tmp_path, monkeypatch)


def test_reference_encryption_case():
    rebound(ref_cases.test_config_encryption_roundtrip)()


def test_apply_live(tmp_path):
    """tests/test_config_listen.py::test_config_apply_live restated for
    more of what the port applies: region, compression, the request cap
    and the static KMS go live, the audit webhook goes to the trace
    plane, and a notify_webhook's target to the event notifier."""
    fs = FSObjects(str(tmp_path / "a"), device="cpu")
    api = S3ApiHandlers(fs, creds=CREDS)
    cfg = ConfigSys(fs, secret=CREDS.secret_key)
    cfg.set_kv("region", name="ap-moon-1")
    cfg.set_kv("compression", enable="on", algorithm="zstd")
    cfg.set_kv("api", requests_max="17")
    cfg.set_kv("kms_secret_key", key="ab" * 32)
    cfg.set_kv("audit_webhook", enable="on",
               endpoint="http://127.0.0.1:1/audit")
    cfg.apply(api)
    assert api.region == "ap-moon-1"
    assert api.compression_enabled
    assert api.compression_algorithm == "zstd"
    assert api.admission.capacity == 17
    assert type(api.kms).__name__ == "StaticKMS"
    assert cfg.get("audit_webhook", "endpoint") == \
        "http://127.0.0.1:1/audit"
    with pytest.raises(ConfigError):
        cfg.set_kv("audit_webhook", enable="maybe")
    # the audit webhook goes live on the trace plane; the event plane
    # is still refused
    trace = types.SimpleNamespace(audit_webhook="")
    cfg.apply(api, trace=trace)
    assert trace.audit_webhook == "http://127.0.0.1:1/audit"
    cfg.set_kv("audit_webhook", enable="off")
    cfg.apply(api, trace=trace)
    assert trace.audit_webhook == ""
    # a notify_webhook turned on registers its target with the event
    # notifier; turned off, it is unregistered
    events = EventNotifier(api.bucket_meta)
    try:
        cfg.set_kv("notify_webhook", enable="on",
                   endpoint="http://127.0.0.1:1/hook")
        cfg.apply(api, events=events)
        hook = events.targets[cfg.CONFIG_WEBHOOK_ARN]
        assert type(hook).__name__ == "WebhookTarget"
        assert hook.endpoint == "http://127.0.0.1:1/hook"
        cfg.set_kv("notify_webhook", enable="off")
        cfg.apply(api, events=events)
        assert cfg.CONFIG_WEBHOOK_ARN not in events.targets
    finally:
        events.close()
    # requests_max back to 0: the gate the boot sized comes back
    api.requests_budget = 40
    cfg.set_kv("api", requests_max="0")
    cfg.apply(api)
    assert api.admission.capacity == 40


def test_legacy_compression_env_survives_apply(tmp_path, monkeypatch):
    """MINIO_COMPRESS / MINIO_COMPRESS_ALGORITHM (the handlers' own
    switches) count as the compression keys, so that a boot's apply keeps
    them; the MINIO_COMPRESSION_* names win where both are set."""
    monkeypatch.setenv("MINIO_COMPRESS", "on")
    monkeypatch.setenv("MINIO_COMPRESS_ALGORITHM", "zstd")
    fs = FSObjects(str(tmp_path / "e"), device="cpu")
    api = S3ApiHandlers(fs, creds=CREDS)
    cfg = ConfigSys(fs, secret=CREDS.secret_key)
    cfg.apply(api)
    assert api.compression_enabled and api.compression_algorithm == "zstd"
    monkeypatch.setenv("MINIO_COMPRESSION_ENABLE", "off")
    cfg.load()
    cfg.apply(api)
    assert not api.compression_enabled


class _PinnedSeal:
    """secrets and time of a config/kv.py module from counters."""

    def __init__(self):
        self.rng = np.random.default_rng(3)
        self.t = 1.7e9

    def token_bytes(self, n):
        return self.rng.bytes(n)

    def token_hex(self, n):
        return self.rng.bytes(n).hex()

    def time(self):
        self.t += 1.0
        return self.t

    @staticmethod
    def strftime(fmt, t):
        import time as _time
        return _time.strftime(fmt, t)

    @staticmethod
    def gmtime(t):
        import time as _time
        return _time.gmtime(t)


def _pin(monkeypatch):
    from tests.test_torch_iam import pin_both
    pin_both(monkeypatch)
    for mod in (ref_kv, port_kv):
        p = _PinnedSeal()
        monkeypatch.setattr(mod, "secrets", p)
        monkeypatch.setattr(mod, "time", p)


def test_seal_is_the_references(monkeypatch):
    _pin(monkeypatch)
    plain = json.dumps({"region": {"name": "x"}}).encode()
    a = ref_kv._encrypt("root-secret", plain)
    b = port_kv._encrypt("root-secret", plain)
    assert a == b and len(a) == 12 + len(plain) + 16
    assert port_kv._decrypt("root-secret", a) == plain
    assert ref_kv._decrypt("root-secret", b) == plain
    assert port_kv.SEAL == "cryptography AESGCM"


def _write(cfg):
    cfg.set_kv("region", name="r1")
    cfg.set_kv("compression", enable="on")
    cfg.set_kv("identity_openid", client_id="app", claim_name="pol")
    cfg.set_kv("notify_webhook", enable="on",
               endpoint="http://127.0.0.1:1/hook", queue_limit="5")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stored_config_loads_in_the_other_package(tmp_path, monkeypatch,
                                                  writer):
    _pin(monkeypatch)
    for tag, sets_fn, cfg_cls in (("ref", _ref_sets, RefConfigSys),
                                  ("port", _sets, ConfigSys)):
        (tmp_path / tag).mkdir()
        layer = sets_fn(tmp_path / tag)
        _write(cfg_cls(layer, secret=CREDS.secret_key))
        layer.close()
    # twin trees: the same sealed blob and history objects
    want = drive_files(tmp_path / "ref")
    got = drive_files(tmp_path / "port")
    assert sorted(want) == sorted(got)
    assert [k for k in want if want[k] != got[k]] == []
    # the other package reads the writer's tree
    src = "ref" if writer == "reference" else "port"
    sets_fn, cfg_cls = ((_sets, ConfigSys) if writer == "reference"
                        else (_ref_sets, RefConfigSys))
    layer = sets_fn(tmp_path / src)
    try:
        cfg = cfg_cls(layer, secret=CREDS.secret_key)
        assert cfg.get("region", "name") == "r1"
        assert cfg.get("compression", "enable") == "on"
        assert cfg.get_subsys("identity_openid")["claim_name"] == "pol"
        assert cfg.get("notify_webhook", "queue_limit") == "5"
        hist = cfg.history()
        assert len(hist) == 3
        cfg.restore(hist[0])
        assert cfg.get("region", "name") == "r1"
        assert cfg.get("compression", "enable") == "off"
        with pytest.raises(Exception):
            cfg_cls(layer, secret="another-secret")
    finally:
        layer.close()
