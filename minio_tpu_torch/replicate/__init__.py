"""Active-active multi-site replication: the persisted target registry
(``targets.py``) and the replica-origin helpers the notification plane
reads. The replication clients, plane and resync walker are not ported
yet; ``TargetRegistry`` refuses to build a client (``targets.py``)."""

from .targets import (REPL_ORIGIN_KEY, ReplTargetError,  # noqa: F401
                      SiteTarget, TargetRegistry, is_replica, new_arn,
                      origin_of)
