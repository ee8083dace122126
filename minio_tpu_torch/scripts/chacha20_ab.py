"""Time builds of the chacha20 kernel against each other on one card, in turns.

    python3 -m minio_tpu_torch.scripts.chacha20_ab \
        [--other NAME=PATH.cu ...] [--set NAME:CONST=VALUE[,CONST=VALUE] ...]
        [--rounds N]

Builds the tree's csrc/chacha20.cu ("tree"), each --other source (any file
with the same C entry point, chacha20_launch: an earlier revision taken
from git, such as `git show e8d2d0c:minio_tpu_torch/csrc/chacha20.cu`) and
each --set variant (a copy of the tree's source with the named
`constexpr int` constants edited, e.g. `t256:kThreads=256,kBlocksPerSm=4`
or `sm5:kBlocksPerSm=5`), one nvcc per build, all at once. At the encode
launch (8 and 32 rows of 1,048,584 B, a 1 MiB span in packages of 65,536
B, out of place as sse_put_step calls it) and GET's decipher batch (64
rows of 65,536 B, one package each, in place) every build's output must
equal the plain version (ops/chacha20_plain.py, on the card) byte for
byte. Then each build is timed in turns, the builds in order and then in
reverse, `--rounds` times: "ms" with CUDA events around 20 back-to-back
launches cycling four input sets (after warm-up; where the host's launch
rate is below the kernel's, this reads the host), and "graph_ms" with
CUDA events around the replay of a CUDA graph of the same 20 launches,
the device-side time. Prints one JSON line with every time, each build's
SASS summary (utils.sass.unrolled: the rounds' instructions by pipe, adds
on the ALU and FMA pipes, calls left such as a 64-bit divide), its
resource usage from cuobjdump, and the card's name and power limit. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import chacha20_cuda, chacha20_plain, kernels
from ..utils import sass
from . import ab

SHAPES = {"encode8": (8, 1048584, 1 << 20, 65536, False),
          "encode32": (32, 1048584, 1 << 20, 65536, False),
          "get64": (64, 65536, 65536, 65536, True)}
_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_void_p]
ITERS = 20


def resource_usage(lib: str) -> str:
    """cuobjdump's resource line (registers, stack, shared, local) for the
    chacha20 kernel of library `lib`."""
    tool = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if "chacha20_kernel" in line and i + 1 < len(lines):
            return lines[i + 1].strip()
    return out.strip()


def launch(fn, x, out, keys, nonces, span, pkg):
    err = fn(x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
             x.shape[0], span, keys.data_ptr(), nonces.data_ptr(),
             nonces.shape[1], pkg, torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "chacha20 launch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH.cu")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME:CONST=VALUE[,CONST=VALUE]")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chacha20_ab: needs a CUDA card")
    tree = os.path.join(kernels._CSRC, kernels.SOURCES["chacha20"])
    builds = {"tree": tree}
    builds.update(spec.split("=", 1) for spec in args.other)
    for spec in args.set:
        name, consts = spec.split(":", 1)
        builds[name] = ab.variant("chacha20", tree, name, consts)
    fns, summary, usage = {}, {}, {}
    for name, lib in ab.build_libs("chacha20", builds).items():
        fn = ctypes.CDLL(lib).chacha20_launch
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        fns[name] = fn
        summary[name] = sass.keystream_block(lib)
        usage[name] = resource_usage(lib)

    rng = np.random.default_rng(20240601)
    gen = torch.Generator(device="cuda").manual_seed(20240601)
    result = {"card": ab.card(), "order": [], "shapes": {}, "sass": summary,
              "resource_usage": usage}
    order = list(fns) + list(fns)[::-1]
    for shape, (n, stride, span, pkg, in_place) in SHAPES.items():
        p = -(-span // pkg)
        keys = chacha20_cuda.words(rng.integers(0, 1 << 32, (n, 8),
                                                dtype=np.uint32), "cuda")
        nonces = chacha20_cuda.words(rng.integers(0, 1 << 32, (n, p, 3),
                                                  dtype=np.uint32), "cuda")
        sets = [torch.randint(0, 256, (n, stride), dtype=torch.uint8,
                              device="cuda", generator=gen)
                for _ in range(4)]
        outs = sets if in_place else [torch.empty_like(x) for x in sets]
        want = chacha20_plain.keystream_xor(sets[0], keys, nonces, pkg, span)
        for name, fn in fns.items():
            x = sets[0].clone()
            out = x if in_place else torch.zeros_like(x)
            launch(fn, x, out, keys, nonces, span, pkg)
            torch.cuda.synchronize()
            if not torch.equal(out[:, :span], want[:, :span]):
                sys.exit(f"chacha20_ab: {name} disagrees with the plain "
                         f"version at {shape}")
        times = {name: [] for name in fns}
        graph = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name in order:
                def call(i, fn=fns[name]):
                    launch(fn, sets[i % 4], outs[i % 4], keys, nonces, span,
                           pkg)
                times[name].append(ab.timed(call, ITERS))
                graph[name].append(ab.graph_timed(call, ITERS))
        result["shapes"][shape] = {
            "rows": n, "row_bytes": stride, "span": span, "packages": n * p,
            "in_place": in_place, "ms": times, "graph_ms": graph,
            "mean_graph_ms": {k: sum(v) / len(v) for k, v in graph.items()}}
        del sets, outs
    result["order"] = order
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
