"""Tier plane: remote tiers behind the erasure pools.

Counterpart of minio_tpu/tier/ (the reference's ILM tiering,
cmd/tier.go and the transition paths of cmd/erasure-object.go):
operators register named remote tiers, lifecycle ``Transition`` rules
move cold objects' data there, the local ``xl.meta`` becomes a zero-data
stub, GETs answer ``InvalidObjectState`` until a ``RestoreObject``
pulls an expiring local copy back, and the crawler reclaims that copy
when it expires.

  * :mod:`.config`     — the persisted, epoch-versioned tier registry
  * :mod:`.client`     — the tier clients and the fault wrapper
  * :mod:`.transition` — the transition worker, the crawler actions,
                         restore and reclaim

Without the admin router (not ported), a tier is added through
``TierManager.add`` in the library, or comes from the drives: a registry
saved by the reference loads at boot.
"""

from .client import (FSTierClient, GatewayTierClient, NaughtyTierClient,
                     TierClientError, TierObjectNotFound,
                     new_tier_client)  # noqa: F401
from .config import TierConfig, TierManager, TIER_CONFIG_OBJECT  # noqa: F401
