"""Build and load the port's hand-written CUDA kernels.

Each source in ``minio_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ctypes. Builds go to ``build/kernels/`` under the repo root, named by
a hash of the source and flags, so an edit rebuilds and an unchanged source
is reused. Nothing is built at import: the first launch builds, or
``build()`` builds every kernel at once with one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = {"gf_matmul": "gf_matmul.cu", "hh256": "hh256.cu",
           "sha256": "sha256.cu", "chacha20": "chacha20.cu",
           "scan_eval": "scan_eval.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _scan_eval_flags() -> list[str]:
    # the scan interpreter's float64 arithmetic must round once per
    # operation, as the CPU evaluator's does, so nvcc may not contract a
    # multiply and an add into one FMA; its stack depths are the
    # flattener's limits, which are written down there only
    from . import scan_program
    return ["-fmad=false", f"-DSCAN_MAX_VALS={scan_program.MAX_VALS}",
            f"-DSCAN_MAX_BOOLS={scan_program.MAX_BOOLS}"]


# flags of one source only, after NVCC_FLAGS, made when it is built
SOURCE_FLAGS = {"scan_eval": _scan_eval_flags}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per kernel
BUILD_LOG: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA toolkit's nvcc; raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def flags(name: str) -> list[str]:
    """nvcc's flags for kernel `name`."""
    extra = SOURCE_FLAGS.get(name)
    return NVCC_FLAGS + (extra() if extra else [])


def _target(name: str) -> str:
    with open(os.path.join(_CSRC, SOURCES[name]), "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(" ".join(flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names=None) -> float:
    """Compile the named kernels (default: all) that have no current
    build, one nvcc process per source, all running at once. Returns the
    wall seconds spent; raises with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_target(n))]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = nvcc()
    procs = {}
    for n in todo:
        tmp = f"{_target(n)}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [cc, *flags(n), "-o", tmp, os.path.join(_CSRC, SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of kernel library `name`, building and
    loading the library at first use. Every entry returns an int
    cudaError_t."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _demangled(name: str) -> str:
    """The last source name of an Itanium-mangled function name, with a
    bool template argument after it spelled out; `name` itself when it is
    not mangled."""
    m = re.match(r"_ZN?", name)
    if not m:
        return name
    at, last = m.end(), name
    while at < len(name) and name[at].isdigit():
        n = re.match(r"\d+", name[at:]).group(0)
        at += len(n)
        last = name[at:at + int(n)]
        at += int(n)
    arg = re.match(r"ILb([01])E", name[at:])
    if arg:
        last += "<true>" if arg.group(1) == "1" else "<false>"
    return last


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "stack_frame", "spill_stores", "spill_loads"}}
    from an nvcc -Xptxas -v log, each kernel by its name (a bool template
    argument spelled out: ``scan_eval_kernel<true>``)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _demangled(m.group(1))
            fn = out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None:
            fn.update(stack_frame=int(m.group(1)),
                      spill_stores=int(m.group(2)),
                      spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
    return out


def library(name: str) -> str:
    """Path of kernel library `name`, built if needed."""
    build([name])
    return _target(name)


_count_mu = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`, the count of a kernel's launches.
    Dispatch threads launch at once, and a bare `+=` on the attribute can
    lose counts between its read and its write."""
    with _count_mu:
        wrapper.launches += 1


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
