"""What the kernel A/B scripts share: building several sources of one
kernel side by side, timing launches with CUDA events (around the calls,
or around the replay of a CUDA graph of them), and the card's name and
power limit."""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from ..ops import kernels


def build_libs(kind: str, builds: dict[str, str]) -> dict[str, str]:
    """name -> source, each built by its own nvcc into
    build/ab/lib{kind}_{name}.so, all at once; returns name -> library
    path. Exits with nvcc's output when a build fails."""
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in builds.items():
        lib = os.path.join(out_dir, f"lib{kind}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"{kind}_ab: build {name} failed:\n{log}")
        libs[name] = lib
    return libs


def timed(fn, iters: int = 20) -> float:
    """ms per call of fn(i) over `iters` calls, CUDA events around them,
    after two warm-up calls."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_timed(fn, iters: int = 20) -> float:
    """ms per call of fn(i), i < iters, from CUDA events around the replay
    of one CUDA graph of the `iters` calls (captured after two warm-up
    calls): the device-side time, free of the host's cost per call."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
