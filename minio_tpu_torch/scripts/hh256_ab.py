"""Time builds of the hh256 kernel against each other on one card, in turns.

    python3 -m minio_tpu_torch.scripts.hh256_ab \
        [--other NAME=PATH.cu ...] [--rounds N]

Builds the tree's csrc/hh256.cu ("tree") and each --other source (any file
with the same C entry point, hh256_launch: an earlier revision taken from
git, or a copy of the tree's source with its ring constants edited), one
nvcc per build, all at once. At each of the main path's hh256 shapes
(512 x 87,382, 128 x 349,526 and 96 x 349,526 bytes) every build must give
the tree's digests byte for byte; then each build is timed with CUDA
events (20 launches over four input sets, after warm-up) in turns: the
builds in order, then in reverse, `--rounds` times. Prints one JSON line
with every time, each build's packet-loop summary from its SASS
(utils.sass.packet_loop; an error for a build with no shared-memory packet
loop, such as the earlier one-thread-per-row kernel), and the card's name
and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

from ..bitrot import MAGIC_HIGHWAYHASH_KEY as KEY
from ..ops import kernels
from ..utils import sass
from . import ab

SHAPES = {"baseline": (512, 87382), "put": (128, 349526),
          "degraded_get": (96, 349526)}
_ARGS = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + \
    [ctypes.c_ulonglong] * 4 + [ctypes.c_void_p] * 2


def build_all(builds: dict[str, str]) -> tuple:
    """name -> source built into build/ab/; returns (name -> the loaded
    hh256_launch, name -> its hot-loop summary)."""
    fns, loops = {}, {}
    for name, lib in ab.build_libs("hh256", builds).items():
        fn = ctypes.CDLL(lib).hh256_launch
        fn.argtypes, fn.restype = _ARGS, ctypes.c_int
        fns[name] = fn
        try:
            loops[name] = sass.packet_loop(lib)
        except ValueError as e:         # an older design has no such loop
            loops[name] = {"error": str(e)}
    return fns, loops


def launch(fn, rows: torch.Tensor, length: int) -> torch.Tensor:
    out = torch.empty((rows.shape[0], 32), dtype=torch.uint8,
                      device=rows.device)
    kw = [int.from_bytes(KEY[i * 8:(i + 1) * 8], "little") for i in range(4)]
    err = fn(rows.data_ptr(), rows.shape[0], rows.shape[1], length, *kw,
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "hh256 launch")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH.cu")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("hh256_ab: needs a CUDA card")
    tree_src = os.path.join(kernels._CSRC, kernels.SOURCES["hh256"])
    builds = {}
    for spec in args.other:
        name, path = spec.split("=", 1)
        builds[name] = path
    builds["tree"] = tree_src
    fns, loops = build_all(builds)

    card = ab.card()
    gen = torch.Generator(device="cuda").manual_seed(20240601)
    result = {"card": card, "order": [], "shapes": {}, "hot_loop": loops}
    order = list(fns) + list(fns)[::-1]
    for shape, (n, length) in SHAPES.items():
        sets = [torch.randint(0, 256, (n, length), dtype=torch.uint8,
                              device="cuda", generator=gen)
                for _ in range(4)]
        want = launch(fns["tree"], sets[0], length)
        for name, fn in fns.items():
            if not torch.equal(launch(fn, sets[0], length), want):
                sys.exit(f"hh256_ab: {name} disagrees with the tree's "
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
