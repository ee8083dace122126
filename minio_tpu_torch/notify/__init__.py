"""Bucket event notification plane (the N-th consumer of the ONE
namespace feed).

The reference ships bucket notifications as a first-class S3 surface
(pkg/event/, cmd/event-notification.go): webhook/queue targets named by
ARN, per-bucket `NotificationConfiguration` rules with prefix/suffix/
event-type filters, and S3 event JSON records delivered at-least-once
through per-target durable queues. This package rebuilds that surface
on top of the engine namespace feed instead of per-handler send calls:

* ``targets.py``  — the epoch-versioned target registry (webhook /
  in-process queue / file-log target types), persisted to every pool
  under ``.minio.sys/notify/`` with regfence lineage — the same
  durability rule as the topology/tier/replicate/qos registries, so
  fsck's registry-fork coverage applies unchanged;
* ``rules.py``    — per-bucket `NotificationConfiguration` XML
  (prefix/suffix/event filters, ARN validation);
* ``plane.py``    — the NotificationPlane: one listener on the
  namespace feed (wired by ``ErasureServerSets.attach_notifications``,
  pinned by the lint gate's hook-coverage chain), state-derived event
  classification, reference-shape event records, bounded dedup queue,
  MRF-style capped-backoff retry, per-target offline windows and
  owner-node delivery on multi-node clusters;
* ``chaos.py``    — the NaughtyTarget deterministic fault wrapper the
  durability tests drive.
"""

from .chaos import NaughtyTarget
from .plane import NotificationPlane, render_record
from .rules import BucketNotifyConfig, NotifyRule, NotifyRuleError
from .targets import (NotifyTarget, NotifyTargetError,
                      NotifyTargetRegistry, new_arn)

__all__ = [
    "BucketNotifyConfig", "NaughtyTarget", "NotificationPlane",
    "NotifyRule", "NotifyRuleError", "NotifyTarget", "NotifyTargetError",
    "NotifyTargetRegistry", "new_arn", "render_record",
]
