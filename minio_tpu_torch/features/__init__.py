"""Host-side features of the data path: SSE and compression (crypto.py),
the KMS seam (kms.py), S2 framing (snappy.py), bucket lifecycle rules
with the crawler's actions (lifecycle.py) and the legacy event notifier
with its wire targets (events.py)."""

from .events import EventNotifier, NotificationConfig  # noqa: F401
