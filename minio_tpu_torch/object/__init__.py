"""Object engine: erasure-coded object CRUD, multipart and healing on one
erasure set (counterpart of minio_tpu/object/__init__.py); object/sets.py
and object/server_sets.py route over many."""

from __future__ import annotations

from typing import Optional

from . import api_errors  # noqa: F401
from .codec import Codec  # noqa: F401
from .engine import (ErasureObjects, GetOptions, PutOptions,  # noqa: F401
                     from_reference_layout)
from .hash_reader import HashReader  # noqa: F401
from .healing import HealMixin, HealResultItem  # noqa: F401
from .multipart import CompletePart, MultipartMixin, PartInfo  # noqa: F401
from .nslock import NSLock, NSLockMap  # noqa: F401


class ErasureSetObjects(MultipartMixin, HealMixin):
    """The per-set object engine: CRUD + multipart + heal. `mrf` is the
    MRF heal queue wired to the degraded-read and degraded-write hooks,
    when open_erasure_set built one."""

    mrf = None


def open_erasure_set(disk_paths: list[str], k: int, m: int,
                     scheduler=None, mrf: bool = False,
                     mrf_kw: Optional[dict] = None,
                     **engine_kw) -> ErasureSetObjects:
    """Open (formatting fresh drives) one erasure set of local drives as
    an ErasureSetObjects (engine.from_reference_layout), with an optional
    batch former and, with `mrf`, an MRFHealer (kwargs `mrf_kw`) that
    heals through this set's heal_object: on_degraded_write and
    on_degraded_read queue the object. Close the healer with
    `obj.mrf.close()`."""
    obj = from_reference_layout(disk_paths, k, m, cls=ErasureSetObjects,
                                scheduler=scheduler, **engine_kw)
    if mrf:
        from .background import MRFHealer
        obj.mrf = MRFHealer(
            lambda b, o, v: obj.heal_object(b, o, v), **(mrf_kw or {}))
        obj.on_degraded_write = obj.mrf.enqueue
        obj.on_degraded_read = lambda b, o: obj.mrf.enqueue(b, o, "")
    return obj


__all__ = ["Codec", "CompletePart", "ErasureObjects", "ErasureSetObjects",
           "GetOptions", "HashReader", "HealResultItem", "NSLock",
           "NSLockMap", "PartInfo", "PutOptions", "open_erasure_set"]
