"""Config KV subsystem (cmd/config); counterpart of minio_tpu/config/."""

from .kv import ConfigSys, SUBSYSTEMS  # noqa: F401
