"""Host-side features of the data path: SSE and compression (crypto.py),
the KMS seam (kms.py), S2 framing (snappy.py), bucket lifecycle rules
with the crawler's actions (lifecycle.py), the legacy event notifier
with its wire targets (events.py) and the legacy bucket replication
config and pool (replication.py)."""

from .events import EventNotifier, NotificationConfig  # noqa: F401
from .replication import ReplicationConfig, ReplicationPool  # noqa: F401
