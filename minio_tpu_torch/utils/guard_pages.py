"""Device memory flanked by unmapped address space, to check on the card
that a kernel touches only the bytes of its tensors.

    with guarded(nbytes, "cuda") as buf:     # uint8 tensor
        x = buf[-n:]          # its last byte is the last mapped byte

`guarded` reserves three equal ranges of device address space with
libcuda's virtual memory management calls and maps memory into the
middle one only: `nbytes` rounded up to the allocation granularity (2 MiB
on an H100). A tensor at either end of `buf` borders unmapped memory, so a load
or store past that end stops the kernel with an illegal-address error,
where the caching allocator's neighbouring memory would let it pass
silently. libcuda is loaded only when `guarded` is called.
"""

from __future__ import annotations

import contextlib
import ctypes

_PINNED, _DEVICE, _READ_WRITE = 1, 1, 3
_ptr, _size, _u64 = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_ulonglong


class _Prop(ctypes.Structure):          # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32_meta", ctypes.c_void_p),
                ("compression", ctypes.c_ubyte), ("rdma", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _Access(ctypes.Structure):        # CUmemAccessDesc
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("flags", ctypes.c_int)]


class _Mapped:
    """Exposes a mapped range to torch.as_tensor."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")
    sigs = {
        "cuMemGetAllocationGranularity": [ctypes.POINTER(_size),
                                          ctypes.POINTER(_Prop), ctypes.c_int],
        "cuMemAddressReserve": [ctypes.POINTER(_ptr), _size, _size, _ptr,
                                _u64],
        "cuMemCreate": [ctypes.POINTER(_u64), _size, ctypes.POINTER(_Prop),
                        _u64],
        "cuMemMap": [_ptr, _size, _size, _u64, _u64],
        "cuMemSetAccess": [_ptr, _size, ctypes.POINTER(_Access), _size],
        "cuMemUnmap": [_ptr, _size],
        "cuMemRelease": [_u64],
        "cuMemAddressFree": [_ptr, _size],
    }
    for name, args in sigs.items():
        getattr(cu, name).argtypes = args
        getattr(cu, name).restype = ctypes.c_int
    return cu


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUresult {err}")


@contextlib.contextmanager
def guarded(nbytes: int, device):
    """Yields a uint8 CUDA tensor of `nbytes` rounded up to the allocation
    granularity, with unmapped address space on both sides."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"guarded: {dev} is not a CUDA device")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    with torch.cuda.device(index):
        torch.cuda.synchronize()        # the primary context is current
        cu = _libcuda()
        prop = _Prop(type=_PINNED, loc_type=_DEVICE, loc_id=index)
        gran = _size()
        _check(cu.cuMemGetAllocationGranularity(ctypes.byref(gran),
                                                ctypes.byref(prop), 0),
               "cuMemGetAllocationGranularity")
        size = max(1, -(-nbytes // gran.value)) * gran.value
        va, handle = _ptr(), _u64()
        _check(cu.cuMemAddressReserve(ctypes.byref(va), 3 * size, 0, 0, 0),
               "cuMemAddressReserve")
        mid, mapped, created = va.value + size, False, False
        try:
            _check(cu.cuMemCreate(ctypes.byref(handle), size,
                                  ctypes.byref(prop), 0), "cuMemCreate")
            created = True
            _check(cu.cuMemMap(mid, size, 0, handle, 0), "cuMemMap")
            mapped = True
            access = _Access(loc_type=_DEVICE, loc_id=index,
                             flags=_READ_WRITE)
            _check(cu.cuMemSetAccess(mid, size, ctypes.byref(access), 1),
                   "cuMemSetAccess")
            yield torch.as_tensor(_Mapped(mid, size), device=dev)
        finally:
            torch.cuda.synchronize()
            if mapped:
                cu.cuMemUnmap(mid, size)
            if created:
                cu.cuMemRelease(handle)
            cu.cuMemAddressFree(va.value, 3 * size)
