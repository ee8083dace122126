"""Time scan_eval kernel builds against each other on one card, in turns.

    python3 -m minio_tpu_torch.scripts.scan_ab \
        [--other NAME=PATH.cu ...] [--set NAME:CONST=VALUE[,CONST=VALUE] ...]
        [--unchecked NAME=PATH.cu ...] [--rounds N]

Builds the tree's csrc/scan_eval.cu ("tree"), each --other source (any file
with the same C entry point, scan_eval_launch: an earlier revision taken
from git, such as `git show d50ac6a:minio_tpu_torch/csrc/scan_eval.cu`) and
each --set variant (a copy of the tree's source with the named `constexpr
int` constants edited, e.g. `rows2:kRows=2`), one nvcc per build with the
package's flags for it (ops/kernels.flags), all at once. An --unchecked
source is timed but its results are not held against the tree's: a
diagnostic copy that leaves work out on purpose, such as one whose
interpreter loop never runs (the staging and the launch alone). Five
launches, from TPC-H lineitem (scripts/scan_cases.lineitem_csv, 520,000
rows) paged as the pager pages it and packed as the former packs it:

  q6         Q6's predicate (scan_cases.Q6_COUNT): 254 pages of 2,048 rows,
             C = 3 slots of width 16; three copies cycled (~47 MB each, the
             L2 cache 50 MB), as chip_smoke.py's timing cycles them;
  like       the contains-LIKE over l_comment (scan_cases.LIKE_QUERY), at
             the shape the pager gives it (C = 1, W = 64); three copies
             cycled;
  sf1        Q6's pages tiled by scan_cases.tile_pages to 2,931 pages, the
             6,001,215 rows of TPC-H SF1's lineitem (the last page 575
             rows), ~0.55 GB, one copy, far past the L2 cache;
  sf1_like   the LIKE's pages tiled the same way (~0.47 GB);
  sf1_count  SELECT COUNT(*) with no WHERE, tiled the same way: a program
             that reads rowvalid alone (C = 1, W = 8).

At each launch the tree's mask and counts must equal the plain version's
(ops/scan_plain.py, on the card) and every other build's the tree's,
exactly.
Then each build is timed in turns, the builds in order and then in
reverse, `--rounds` times: "ms" with CUDA events around 20 back-to-back
launches (after warm-up), "graph_ms" with CUDA events around the replay
of a CUDA graph of the same 20 launches, the device-side time, and
"profiler_ms" torch.profiler's kernel durations (None where it recorded
no launch). Prints one
JSON line with every time; per launch the bytes the program must move
(scan_cases.must_move_bytes) and the 32-byte sectors that hold them
(scan_cases.sector_floor_bytes), each over 3.35 TB/s; each build's ptxas
report (registers, stack frame and spill bytes of each kernel); and the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

from ..ops import kernels, scan_cuda, scan_plain, scan_program
from ..s3select import sql
from ..scan import pager
from ..scan.plan import compile_plan
from . import ab
from . import scan_cases as sc

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
ROWS = 520_000                     # chip_smoke.py's phase 11 object
SF1_ROWS = 6_001_215               # TPC-H SF1 lineitem
COUNT_QUERY = "SELECT COUNT(*) FROM S3Object"
ITERS = 20


def pages_of(rows: list, query: str):
    """(program, pages) of a CSV query over parsed rows, as the pager pages
    them."""
    plan = compile_plan(sql.parse(query), "CSV")
    return scan_program.program_for(plan), pager.build_pages(rows, plan)


def card_copies(arrays: dict, dev, copies: int) -> list:
    """`copies` copies on the card of pages packed as the former packs
    them, each as scan_cuda.unpack's typed views (cycled so that a launch
    does not find its pages in the L2 cache)."""
    _B, R, C, W = arrays["sb"].shape
    packed = torch.from_numpy(scan_cuda.pack_pages(arrays))
    return [scan_cuda.unpack(packed.to(dev), R, C, W) for _ in range(copies)]


def bounds(program, arrays: dict, mask: np.ndarray) -> dict:
    """The bytes the program must move over these pages
    (scan_cases.must_move_bytes: its read set once, the mask and counts
    written once) and the 32-byte sectors that hold them
    (scan_cases.sector_floor_bytes), each as a time at HBM_BYTES_PER_S."""
    must = sc.must_move_bytes(program, arrays, mask)
    floor = sc.sector_floor_bytes(program, arrays, mask)
    return {"bytes": must, "byte_bound_ms": must / HBM_BYTES_PER_S * 1e3,
            "sector_bytes": floor,
            "sector_floor_ms": floor / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH.cu")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME:CONST=VALUE[,CONST=VALUE]")
    ap.add_argument("--unchecked", action="append", default=[],
                    metavar="NAME=PATH.cu")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("scan_ab: needs a CUDA card")
    tree = os.path.join(kernels._CSRC, kernels.SOURCES["scan_eval"])
    builds = {"tree": tree}
    builds.update(spec.split("=", 1) for spec in args.other)
    for spec in args.set:
        name, consts = spec.split(":", 1)
        builds[name] = ab.variant("scan_eval", tree, name, consts)
    unchecked = dict(spec.split("=", 1) for spec in args.unchecked)
    builds.update(unchecked)
    logs: dict = {}
    fns = {}
    for name, lib in ab.build_libs("scan_eval", builds, logs).items():
        fn = ctypes.CDLL(lib).scan_eval_launch
        fn.argtypes, fn.restype = scan_cuda.ARGTYPES, ctypes.c_int
        fns[name] = fn
    ptxas = {name: kernels.ptxas_report(log) for name, log in logs.items()}

    rows = sc.rows_of(sc.lineitem_csv(ROWS, 20240601), "CSV")
    q6_program, q6_pages = pages_of(rows, sc.Q6_COUNT)
    like_program, like_pages = pages_of(rows, sc.LIKE_QUERY)
    count_program, count_pages = pages_of(rows, COUNT_QUERY)
    del rows
    R = q6_pages.shape_key()[0]
    sf1_b = -(-SF1_ROWS // R)

    def sf1(pages):
        return sc.tile_pages(pages.arrays, sf1_b, SF1_ROWS - (sf1_b - 1) * R)

    # (program, arrays, copies), built when the launch comes (the SF1
    # pages are ~0.1-0.55 GB each on the host)
    cases = {
        "q6": lambda: (q6_program, q6_pages.arrays, 3),
        "like": lambda: (like_program, like_pages.arrays, 3),
        "sf1": lambda: (q6_program, sf1(q6_pages), 1),
        "sf1_like": lambda: (like_program, sf1(like_pages), 1),
        "sf1_count": lambda: (count_program, sf1(count_pages), 1)}
    dev = torch.device("cuda", 0)
    result = {"card": ab.card(), "ptxas": ptxas, "order": [],
              "unchecked": sorted(unchecked), "launches": {}}
    order = list(fns) + list(fns)[::-1]
    for case, make in cases.items():
        program, arrays, copies = make()
        B, R, C, W = arrays["sb"].shape
        views = card_copies(arrays, dev, copies)
        blob = torch.from_numpy(program.blob.copy()).to(dev)
        k = len(program.cspec)
        outs = [(torch.empty((B, R), dtype=torch.uint8, device=dev),
                 torch.empty((B, k), dtype=torch.int32, device=dev))
                for _ in range(copies)]

        def launch(fn, i):
            v, (mask, counts) = views[i % copies], outs[i % copies]
            kernels.check(fn(*scan_cuda.launch_args(
                program, blob, v["num"], v["ok"], v["null"], v["sb"],
                v["slen"], v["rowvalid"], mask, counts,
                torch.cuda.current_stream(dev))),
                f"scan_eval launch ({case})")
            return mask, counts

        want = scan_plain.scan_eval(program.prog, program.cspec, **views[0])
        for name in ["tree", *[n for n in fns
                               if n != "tree" and n not in unchecked]]:
            got = launch(fns[name], 0)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1])):
                held = "the plain version" if name == "tree" else "the tree"
                sys.exit(f"scan_ab: {name} disagrees with {held} at {case}")
            if name == "tree":
                want = tuple(t.clone() for t in got)
        bound = bounds(program, arrays, want[0].cpu().numpy())
        times = {name: [] for name in fns}
        graph = {name: [] for name in fns}
        prof = {name: [] for name in fns}
        for _ in range(args.rounds):
            for name in order:
                def call(i, fn=fns[name]):
                    launch(fn, i)
                times[name].append(ab.timed(call, ITERS))
                graph[name].append(ab.graph_timed(call, ITERS))
                prof[name].append(ab.profiled(call, "scan_eval_kernel",
                                              ITERS)[0])
        result["launches"][case] = {
            "B": B, "R": R, "C": C, "W": W,
            "rows": int(np.asarray(arrays["rowvalid"]).sum()),
            "count": int(want[1].sum()) if k else None,
            **bound, "ms": times, "graph_ms": graph, "profiler_ms": prof,
            "mean_ms": {n: sum(v) / len(v) for n, v in times.items()},
            "mean_graph_ms": {n: sum(v) / len(v) for n, v in graph.items()}}
        del views, outs, arrays
        torch.cuda.empty_cache()
    result["order"] = order
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
