"""Active-active multi-site replication plane (counterpart of
minio_tpu/replicate/).

Promotes the one-way async copier of ``features/replication.py`` into
a real subsystem: an epoch-versioned persisted target registry
(``targets.py``), transport-agnostic target clients with a
deterministic fault wrapper (``client.py``), the bidirectional sync
plane with loop suppression, conflict resolution, pruning, MRF-style
retry and bandwidth budgets (``plane.py``), and the checkpointed
resync walker that seeds a new site (``resync.py``).
"""

from .client import (HTTPReplClient, LayerReplClient,  # noqa: F401
                     NaughtyReplClient, ReplClientError,
                     ReplTargetClient, ReplTargetOffline,
                     replica_writes_counter)
from .plane import ReplicationPlane  # noqa: F401
from .resync import Resyncer  # noqa: F401
from .targets import (REPL_ORIGIN_KEY, ReplTargetError,  # noqa: F401
                      SiteTarget, TargetRegistry, is_replica, new_arn,
                      origin_of)
