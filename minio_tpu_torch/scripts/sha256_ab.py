"""Time builds of the sha256 kernel against each other on one card, in turns.

    python3 -m minio_tpu_torch.scripts.sha256_ab \
        [--other NAME=PATH.cu ...] [--rounds N]

Builds the tree's csrc/sha256.cu ("tree") and each --other source (any file
with the same C entry point, sha256_launch: an earlier revision taken from
git, such as `git show 649558e:minio_tpu_torch/csrc/sha256.cu`, or a copy of
the tree's source with its constants edited), one nvcc per build, all at
once. At config 5's encode launch shapes (640 and 160 rows of 65,536 B)
the tree's digests must equal hashlib's, and every build's the tree's,
byte for byte; then each build is timed with CUDA events (20 launches over
four input sets, after warm-up) in turns: the builds in order, then in
reverse, `--rounds` times. Prints one JSON line with every time, each
build's block-loop summary from its SASS (utils.sass.block_loop: issue
slots, instructions by pipe, adds on the ALU and FMA pipes, chain cycles
per compression) and the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import sys

import torch

from ..ops import kernels
from ..utils import sass
from . import ab

SHAPES = {"640": (640, 65536), "160": (160, 65536)}
_ARGS = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2


def launch(fn, rows: torch.Tensor, length: int) -> torch.Tensor:
    out = torch.empty((rows.shape[0], 32), dtype=torch.uint8,
                      device=rows.device)
    err = fn(rows.data_ptr(), rows.shape[0], rows.shape[1], length,
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "sha256 launch")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH.cu")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("sha256_ab: needs a CUDA card")
    builds = dict(spec.split("=", 1) for spec in args.other)
    builds["tree"] = os.path.join(kernels._CSRC, kernels.SOURCES["sha256"])
    fns, loops = {}, {}
    for name, lib in ab.build_libs("sha256", builds).items():
        fn = ctypes.CDLL(lib).sha256_launch
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        fns[name] = fn
        loops[name] = sass.block_loop(lib)

    gen = torch.Generator(device="cuda").manual_seed(20240601)
    result = {"card": ab.card(), "order": [], "shapes": {},
              "block_loop": loops}
    order = list(fns) + list(fns)[::-1]
    for shape, (n, length) in SHAPES.items():
        sets = [torch.randint(0, 256, (n, length), dtype=torch.uint8,
                              device="cuda", generator=gen)
                for _ in range(4)]
        want = launch(fns["tree"], sets[0], length)
        host = [hashlib.sha256(r.tobytes()).digest()
                for r in sets[0].cpu().numpy()]
        if [r.tobytes() for r in want.cpu().numpy()] != host:
            sys.exit(f"sha256_ab: the tree's kernel disagrees with hashlib "
                     f"at {n} x {length}")
        for name, fn in fns.items():
            if not torch.equal(launch(fn, sets[0], length), want):
                sys.exit(f"sha256_ab: {name} disagrees with the tree's "
                         f"kernel at {n} x {length}")
        times: dict[str, list[float]] = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(ab.timed(
                    lambda i, fn=fns[name]: launch(fn, sets[i % 4], length)))
        result["shapes"][shape] = {
            "rows": n, "length": length, "ms": times,
            "mean_ms": {k: sum(v) / len(v) for k, v in times.items()}}
        del sets
    result["order"] = order
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
