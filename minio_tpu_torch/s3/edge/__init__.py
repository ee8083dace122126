"""HTTP edge plane: event-loop frontend + the one admission gate.

Counterpart of minio_tpu/s3/edge/. :mod:`admission` makes every shed
decision before any request-body byte is read; :mod:`dispatch` is the
per-request middleware both frontends share; :mod:`server` is
``EdgeServer``: asyncio loops parse request lines and headers and hold
idle keep-alive connections, admitted requests run the blocking handler
layer on a bounded worker pool, reading their bodies zero-copy
(``readinto``) into the PUT pipeline's pinned staging rings.
"""

from .admission import AdmissionController, AdmissionTicket, ShedDecision
from .server import EdgeServer

__all__ = ["AdmissionController", "AdmissionTicket", "ShedDecision",
           "EdgeServer"]
