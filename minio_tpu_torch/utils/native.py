"""ctypes bindings to the C++ host library built from the repo's native/ sources.

The port's host engine for small writes and healthy-GET verification:
  * HighwayHash-256 (batched and streaming) — the CPU bitrot engine;
  * gf_matmul — the GFNI/AVX-512 (or portable) GF(2^8) coding matmul of
    batches below the device size gate;
  * the snappy/S2 block codec and CRC32C of inline compression
    (features/snappy.py).

The library is compiled at first use with g++ into ``build/native/`` (named
by a hash of its sources, so an edit rebuilds it). If the compiler is
missing or the build fails, ``available()`` is False and the numpy /
pure-Python paths take over (slower, same bytes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SOURCES = ("highwayhash.cpp", "gf_rs.cpp", "snappy.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "native")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Compile the library if no build of these exact sources exists;
    returns its path, or None when it cannot be built."""
    srcs = [os.path.join(_NATIVE_DIR, s) for s in _SOURCES]
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    try:
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
    except OSError:
        return None
    out = os.path.join(_BUILD_DIR, f"libnative-{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, *srcs], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.hh256_batch.restype = None
        lib.hh256_batch.argtypes = [u8p, u8p, ctypes.c_size_t,
                                    ctypes.c_size_t, ctypes.c_size_t, u8p]
        lib.hh_init.restype = None
        lib.hh_init.argtypes = [u8p, u8p]
        lib.hh_update_packets.restype = None
        lib.hh_update_packets.argtypes = [u8p, u8p, ctypes.c_size_t]
        lib.hh_final256.restype = None
        lib.hh_final256.argtypes = [u8p, u8p, ctypes.c_size_t, u8p]
        lib.gf_matmul.restype = None
        lib.gf_matmul.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t,
                                  u8p, ctypes.c_size_t,
                                  u8p, ctypes.c_size_t, ctypes.c_size_t,
                                  ctypes.c_int]
        lib.snappy_crc32c.restype = ctypes.c_uint32
        lib.snappy_crc32c.argtypes = [u8p, ctypes.c_size_t]
        lib.snappy_max_compressed_length.restype = ctypes.c_size_t
        lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
        lib.snappy_compress_block.restype = ctypes.c_int
        lib.snappy_compress_block.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.POINTER(ctypes.c_size_t)]
        lib.snappy_uncompressed_length.restype = ctypes.c_int64
        lib.snappy_uncompressed_length.argtypes = [u8p, ctypes.c_size_t]
        lib.snappy_uncompress_block.restype = ctypes.c_int64
        lib.snappy_uncompress_block.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def hh256_batch(key: bytes, shards: np.ndarray) -> np.ndarray:
    """Hash each row of a contiguous (n, L) uint8 array -> (n, 32)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    shards = np.ascontiguousarray(shards, np.uint8)
    n, length = shards.shape
    k = np.frombuffer(key, dtype=np.uint8)
    out = np.zeros((n, 32), dtype=np.uint8)
    lib.hh256_batch(_u8p(k), _u8p(shards), n, length, shards.strides[0],
                    _u8p(out))
    return out


def gf_matmul(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out(r,L) = matrix(r,k) (x) data(k,L) over GF(2^8), native speed."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    matrix = np.ascontiguousarray(matrix, np.uint8)
    data = np.ascontiguousarray(data, np.uint8)
    r, k = matrix.shape
    k2, length = data.shape
    if k != k2:
        raise ValueError(f"matrix has {k} columns, data has {k2} rows")
    out = np.zeros((r, length), dtype=np.uint8)
    lib.gf_matmul(_u8p(matrix), r, k, _u8p(data), data.strides[0],
                  _u8p(out), out.strides[0], length, 0)
    return out


# ---------------------------------------------------------------------------
# snappy/S2 block codec + CRC32C
# ---------------------------------------------------------------------------

# the snappy codec is built into the one library
snappy_available = available


def _snappy_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def crc32c(data: bytes | memoryview) -> int:
    d = np.frombuffer(data, dtype=np.uint8)
    return int(_snappy_lib().snappy_crc32c(_u8p(d), d.size))


def snappy_compress_block(data: bytes | memoryview) -> bytes:
    """One snappy block (<= 65536 bytes: the framing chunk limit; the C
    hash table stores 16-bit positions)."""
    lib = _snappy_lib()
    d = np.frombuffer(data, dtype=np.uint8)
    if d.size > 65536:
        raise ValueError(f"{d.size} bytes exceed one 65536-byte block")
    out = np.empty(int(lib.snappy_max_compressed_length(d.size)),
                   dtype=np.uint8)
    n = ctypes.c_size_t(0)
    lib.snappy_compress_block(_u8p(d), d.size, _u8p(out), ctypes.byref(n))
    return out[:n.value].tobytes()


def snappy_uncompress_block(data: bytes | memoryview,
                            max_out: int = 1 << 24) -> bytes:
    """Decode one snappy/S2 block; raises ValueError on corrupt input
    and NotImplementedError on S2 encodings outside the subset."""
    lib = _snappy_lib()
    d = np.frombuffer(data, dtype=np.uint8)
    want = int(lib.snappy_uncompressed_length(_u8p(d), d.size))
    if want < 0 or want > max_out:
        raise ValueError("corrupt snappy block header")
    out = np.empty(want, dtype=np.uint8)
    got = int(lib.snappy_uncompress_block(_u8p(d), d.size, _u8p(out),
                                          want))
    if got == -2:
        raise NotImplementedError(
            "S2 extended repeat encoding outside the decoded subset")
    if got != want:
        raise ValueError("corrupt snappy block")
    return out.tobytes()
