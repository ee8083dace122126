"""What the kernel A/B scripts share: building several sources of one
kernel side by side, timing launches with CUDA events (around the calls,
or around the replay of a CUDA graph of them) and with torch.profiler's
kernel durations, and the card's name and power limit."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import torch

from ..ops import kernels


def build_libs(kind: str, builds: dict[str, str],
               logs: dict | None = None) -> dict[str, str]:
    """name -> source, each built by its own nvcc with the flags the
    package builds kernel `kind` with (ops/kernels.flags) into
    build/ab/lib{kind}_{name}.so, all at once; returns name -> library
    path, and puts each build's nvcc output (ptxas's -v report) in `logs`
    when given. Exits with nvcc's output when a build fails."""
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in builds.items():
        lib = os.path.join(out_dir, f"lib{kind}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.flags(kind), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"{kind}_ab: build {name} failed:\n{log}")
        libs[name] = lib
        if logs is not None:
            logs[name] = log
    return libs


def variant(kind: str, tree_src: str, name: str, spec: str) -> str:
    """A copy of the tree's source of kernel `kind` with `constexpr int
    CONST = ...;` set to each CONST=VALUE of spec; returns its path under
    build/ab/."""
    with open(tree_src) as f:
        src = f.read()
    for item in spec.split(","):
        const, value = item.split("=", 1)
        src, n = re.subn(rf"(constexpr int {const} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            sys.exit(f"{kind}_ab: no constant {const} in {tree_src}")
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "ab")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{kind}_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


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


def profiled(fn, kernel: str, iters: int = 20) -> tuple[float | None, int]:
    """(ms per launch, launches recorded) of the kernel whose name holds
    `kernel`: the mean of torch.profiler's device durations over `iters`
    calls of fn(i) (after two warm-up calls), None when the profiler
    recorded no launch of it (it can lose records on the card machine)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if kernel in e.key and t and e.count:
            us, n = us + t, n + e.count
    return (us / n / 1e3 if n else None), n


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
