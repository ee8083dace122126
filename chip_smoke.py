"""Smoke run of the PyTorch/CUDA port (minio_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. build    — compile every hand-written kernel (csrc/*.cu, one nvcc per
                source, all at once) and report nvcc's register/spill lines.
  2. kernels  — each kernel against its plain PyTorch version on the card,
                byte for byte (tolerance 0): gf_matmul with a parity, a
                3-missing decode and a recover matrix at 16 ragged widths
                S from 0 to 349,526 and at the main path's B=8,
                S=349,526 (the parity launch three times: a store race
                shows only sometimes), random 0/1 matrices at r in {1, 2,
                3, 4, 5, 8, 12, 16} x k in {1, 3, 12, 16}, and input and
                output views starting at every byte offset 1..15 (the
                bytes around the output must stay as they were), and input
                and output at each end of a mapping between unmapped
                address ranges (utils/guard_pages.py: a read or store
                outside the tensors faults), as for hh256's main-path rows;
                hh256
                (also against the scalar HighwayHash on one row of each
                case) on rows of every length 0..64, rows starting at
                every offset mod 16 (strides 1031 and 349,526, views that
                start mid-word, a sliced view made contiguous), lengths
                around each ring chunk size, 1 to 9000 rows, 349,526 bytes
                inside longer rows, length == row stride on the tensor's
                last row, and the main path's 8 x (12 + r) rows of 349,526
                bytes for r = 0..4.
  3. main path — one 16-drive erasure set at EC 12+4, 4 MiB blocks,
                highwayhash256S streaming bitrot: PUT eight 64 MiB objects,
                one of 64 MiB + 12,345 bytes and one of 1 KiB; GET them all
                back (bytes and MD5 ETags compared); reopen the set with 3
                drives missing (one holds a data shard) and GET them all
                again through the fused verify+decode step. Both kernels'
                launch counters must rise in the PUT and degraded-GET runs.
                Prints the host seconds the codec spent in its device
                steps (copy onto the card; launches and copy back).
  4. timings  — with CUDA events after warm-up: at BASELINE.json's shape
                (B=32, 12+4, 1 MiB blocks, S=87,382) put_step, each kernel
                and each plain version; each kernel alone also at the main
                path's launch shapes: gf_matmul for PUT parity (B=8, 4x12,
                S=349,526) and degraded-GET decode (B=8, S=349,526, r=1
                and r=3), hh256 over 128 rows (PUT) and 96 rows (degraded
                GET) of 349,526 bytes. Beside each: the byte bound (bytes
                moved / 3.35 TB/s), the operation bound (32-bit operations
                / the INT32 rate) and, for hh256, the chain floor: packet
                rounds x the cycles of one trip of the kernel's packet loop
                (its longest dependency chain, read from cuobjdump -sass)
                at the SM clock nvidia-smi reports under load.

Then it prints the kernel table as one JSON line, the card's name and power
limit, and the device line last. It needs one CUDA card and the repo's
minio_tpu_torch package beside it; it imports nothing of JAX or minio_tpu.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# H100 SXM integer rate: 132 SMs x 64 INT32 lanes at the 1,980 MHz boost
# clock (Hopper architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit operations of one HighwayHash packet round of one row: per state
# lane three u64 adds (2 each), two 32x32->64 products (2 each) and two
# u64 xors (2 each) = 14, x 4 lanes; four zipper merges of five byte
# permutes and two u64 adds (2 each) = 9 each
HH256_OPS_PER_ROUND = 4 * 14 + 4 * 9
SEED = 20240601


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "minio_tpu_torch", "csrc")):
        fail("minio_tpu_torch/ is not beside chip_smoke.py")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    from minio_tpu_torch.ops import (highwayhash_cuda, highwayhash_py,
                                     kernels, rs_cuda, rs_matrix)
    from minio_tpu_torch.bitrot import MAGIC_HIGHWAYHASH_KEY as KEY
    from minio_tpu_torch.models import pipeline
    from minio_tpu_torch.utils import guard_pages, sass

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    def max_err(a, b) -> int:
        if a.shape != b.shape:
            fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel() == 0:
            return 0
        return int((a.to(torch.int16) - b.to(torch.int16)).abs().max())

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build_s = kernels.build()
    emit({"phase": "build", "seconds": round(build_s, 3),
          "wall_s": round(time.perf_counter() - t0, 3),
          "ptxas": {n: [ln for ln in kernels.BUILD_LOG.get(n, "").splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in kernels.SOURCES}})

    # -- 2. each kernel against its plain version --------------------------
    t0 = time.perf_counter()
    k, m = 12, 4
    n = k + m
    lost = [1, 5, 14]                               # two data, one parity
    mask = sum(1 << i for i in range(n) if i not in lost)
    mats = {"parity": rs_matrix.parity_matrix(k, m),
            "decode3": rs_matrix.missing_data_matrix(k, m, mask)[0],
            "recover3": rs_matrix.recover_matrix(k, m, mask)[0]}
    gf_err, gf_cases = 0, 0

    def check_gf(what, m2, x, out_at=None):
        """Kernel == plain version (tolerance 0). With out_at = (flat, o),
        the C entry point writes into flat[o:] and the bytes around its
        output must stay as they were."""
        nonlocal gf_err, gf_cases
        if out_at is None:
            got = rs_cuda.gf_matmul(m2, x)
        else:
            flat, o = out_at
            b, r, s = x.shape[0], m2.shape[0] // 8, x.shape[-1]
            end = o + b * r * s
            before = flat.clone()
            got = flat[o:end].view(b, r, s)
            kernels.check(rs_cuda._launcher()(
                m2.data_ptr(), x.data_ptr(), got.data_ptr(), b, r,
                m2.shape[1] // 8, s, torch.cuda.current_stream().cuda_stream),
                "gf_matmul_launch")
        torch.cuda.synchronize()
        if out_at is not None and not (
                torch.equal(flat[:o], before[:o])
                and torch.equal(flat[end:], before[end:])):
            fail(f"gf_matmul {what}: wrote outside its output")
        err = max_err(got, rs_cuda.gf_matmul_plain(m2, x))
        if err:
            fail(f"gf_matmul {what}: max abs err {err}")
        gf_err = max(gf_err, err)
        gf_cases += 1

    # GF matrices at ragged widths; the main path's own launch shape
    # (batches of 8 blocks of 4 MiB, S = 349,526) three times for the
    # parity matrix, since a store race at a tile edge shows only sometimes
    for name, mat in mats.items():
        m2 = rs_cuda.matrix_bits(mat, dev)
        for s in (0, 1, 2, 3, 5, 15, 16, 17, 31, 33, 4095, 4097, 16384,
                  87382, 100003, 349526):
            check_gf(f"{name} B=2 S={s}", m2, rand_u8(2, k, s))
        x = rand_u8(8, k, 349526)
        for _ in range(3 if name == "parity" else 1):
            check_gf(f"{name} B=8 S=349526", m2, x)
    # random 0/1 matrices, which are not GF expansions, at every (r, k)
    for r in (1, 2, 3, 4, 5, 8, 12, 16):
        for kk in (1, 3, 12, 16):
            m2 = torch.randint(0, 2, (8 * r, 8 * kk), dtype=torch.uint8,
                               device=dev, generator=gen)
            for s in (33, 4097):
                check_gf(f"random {r}x{kk} S={s}", m2, rand_u8(2, kk, s))
    # input and output starting at every byte offset mod 16
    m2 = rs_cuda.matrix_bits(mats["parity"], dev)
    for base in range(1, 16):
        x = rand_u8(base + 3 * k * 4097)[base:].view(3, k, 4097)
        check_gf(f"input at offset {base}", m2, x)
        o = (3 * base) % 16
        check_gf(f"input at {base}, output at {o}", m2, x,
                 (rand_u8(o + 3 * m * 4097 + 16), o))
    # input and output at each end of a mapping between unmapped ranges: a
    # read of a word without an input byte, or a store past the output,
    # stops the kernel with an illegal-address error
    for b, s in ((2, 17), (2, 4097), (8, 349526)):
        n_in, n_out = b * k * s, b * m * s
        with guard_pages.guarded(n_in, dev) as src, \
                guard_pages.guarded(n_out, dev) as dst:
            for at, x in (("start", src[:n_in]), ("end", src[-n_in:])):
                x = x.view(b, k, s)
                x.copy_(rand_u8(b, k, s))
                for o in (0, dst.numel() - n_out):
                    check_gf(f"B={b} S={s} input at the {at} of a mapping, "
                             f"output at {o}", m2, x, (dst, o))
    hh_err, hh_cases = 0, 0

    def check_hh(what, rows, length, plain=None):
        """Kernel == plain version on every row (tolerance 0) and == the
        scalar HighwayHash on the last row, which may end the tensor."""
        nonlocal hh_err, hh_cases
        got = highwayhash_cuda.hh256(rows, length, KEY)
        torch.cuda.synchronize()
        if plain is None:
            plain = highwayhash_cuda.hh256_plain(rows, length, KEY)
        err = max_err(got, plain)
        h = highwayhash_py.HighwayHash(KEY)
        h.update(rows[-1, :length].cpu().numpy().tobytes())
        if err or got[-1].cpu().numpy().tobytes() != h.digest256():
            fail(f"hh256 {what}: kernel disagrees (max abs err {err})")
        hh_err = max(hh_err, err)
        hh_cases += 1

    for length in range(65):
        check_hh(f"length {length}", rand_u8(16, length + 7), length)
    # row starts at every offset mod 16 (1031 = 7 mod 16); at length ==
    # row_stride the last row ends the tensor
    rows = rand_u8(16, 1031)
    for length in (1031, 1030, 1014):
        check_hh(f"16 rows of 1031, length {length}", rows, length)
    flat = rand_u8(16 + 9 * 1031)
    for base in range(1, 16):
        check_hh(f"view from byte {base}",
                 flat[base:base + 9 * 1031].view(9, 1031), 1031)
    check_hh("sliced view made contiguous",
             rand_u8(9, 1040)[:, 5:].contiguous(), 1035)
    # around each ring chunk size tried (512 B is the one built)
    for chunk in (256, 512, 1024, 2048):
        for length in (chunk - 31, chunk - 1, chunk, chunk + 1, chunk + 31):
            check_hh(f"length {length}", rand_u8(5, length + 3), length)
    # row counts off the rows-per-warp grid; 1100 packs 3 rows per warp,
    # 9000 packs 16 and needs more than 48 KB of shared memory per block
    for n_rows in (1, 2, 15, 17, 33, 96, 128, 512, 1100, 9000):
        check_hh(f"{n_rows} rows of 1031", rand_u8(n_rows, 1031), 1031)
    check_hh("349526 in rows of 349590", rand_u8(4, 349526 + 64), 349526)
    # the main path's launch shapes: 8 blocks x (12 + 4) rows in a PUT,
    # 8 x 12 survivor rows in a degraded GET, 8 x (12 + r) in a heal with
    # r shards lost. S = 349,526 = 6 mod 16 puts rows at every even
    # offset, and the 128-row tensor's last row ends the allocation.
    rows = rand_u8(8 * (k + m), 349526)
    plain = highwayhash_cuda.hh256_plain(rows, 349526, KEY)
    for r in range(m + 1):
        check_hh(f"{8 * (k + r)} rows of 349526", rows[:8 * (k + r)], 349526,
                 plain[:8 * (k + r)])
    # the same rows at each end of a mapping between unmapped ranges
    with guard_pages.guarded(rows.numel(), dev) as buf:
        for at, g in (("start", buf[:rows.numel()]),
                      ("end", buf[-rows.numel():])):
            g = g.view_as(rows)
            g.copy_(rows)
            check_hh(f"{len(rows)} rows of 349526 at the {at} of a mapping",
                     g, 349526, plain)
    emit({"phase": "kernels", "gf_matmul_max_abs_err": gf_err,
          "gf_matmul_cases": gf_cases,
          "hh256_max_abs_err": hh_err, "hh256_cases": hh_cases,
          "tolerance": 0,
          "seconds": round(time.perf_counter() - t0, 3), "card": card})

    # -- 3. the main path --------------------------------------------------
    from minio_tpu_torch.object import engine as eng_mod
    from minio_tpu_torch.storage.datatypes import hash_order
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        main_path = run_main_path(eng_mod, hash_order, tmp, card,
                                  rs_cuda, highwayhash_cuda, np)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 4. timings -------------------------------------------------------
    b, s = 32, -(-(1 << 20) // k)
    timing = run_timings(torch, dev, rand_u8, max_err, pipeline, rs_cuda,
                         highwayhash_cuda, rs_matrix, kernels, sass, KEY, b,
                         k, m, s)
    timing.update({"phase": "timings", "B": b, "k": k, "m": m, "S": s,
                   "card": card})
    emit(timing)

    def bound_by(t, name):
        return "bytes" if t[f"{name}_byte_bound_ms"] >= \
            t[f"{name}_op_bound_ms"] else "operations"

    emit({"kernels": [
        {"name": "gf_matmul", "route": "cuda",
         "source": "minio_tpu_torch/csrc/gf_matmul.cu",
         "replaces": "minio_tpu/ops/rs_pallas.py:52",
         "launches": main_path["gf_matmul_launches"],
         "max_abs_err": max(gf_err, timing["gf_matmul_max_abs_err"]),
         "ms": timing["gf_matmul_ms"], "plain_ms": timing["gf_plain_ms"],
         "bound_ms": timing["gf_matmul_bound_ms"],
         "bound_by": bound_by(timing, "gf_matmul"), "library_ms": None},
        {"name": "hh256", "route": "cuda",
         "source": "minio_tpu_torch/csrc/hh256.cu",
         "replaces": "minio_tpu/ops/highwayhash_jax.py:336",
         "launches": main_path["hh256_launches"],
         "max_abs_err": max(hh_err, timing["hh256_max_abs_err"]),
         "ms": timing["hh256_ms"], "plain_ms": timing["hh_plain_ms"],
         "bound_ms": timing["hh256_bound_ms"],
         "bound_by": bound_by(timing, "hh256"), "library_ms": None}]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_main_path(eng_mod, hash_order, tmp, card, rs_cuda, hh, np) -> dict:
    k, m = 12, 4
    mib = 1 << 20
    rng = np.random.default_rng(SEED)
    sizes = {f"obj-{i}": 64 * mib for i in range(8)}
    sizes["obj-ragged"] = 64 * mib + 12345
    sizes["obj-small"] = 1024                       # below the size gate
    objects = {name: rng.bytes(n) for name, n in sizes.items()}
    total = sum(sizes.values())
    paths = [os.path.join(tmp, f"drive{i}") for i in range(k + m)]
    eng = eng_mod.from_reference_layout(paths, k, m)   # device: the card
    eng.make_bucket("smoke")

    def counts():
        return rs_cuda.gf_matmul.launches, hh.hh256.launches

    def get_all(e) -> float:
        t0 = time.perf_counter()
        for name, data in objects.items():
            info, it = e.get_object("smoke", name)
            got = b"".join(it)
            if got != data:
                fail(f"GET {name}: bytes differ")
            if info.etag != hashlib.md5(data).hexdigest():
                fail(f"GET {name}: ETag {info.etag} is not the MD5")
        return time.perf_counter() - t0

    from minio_tpu_torch.object import codec
    codec.reset_step_seconds()
    rs_cuda.gf_matmul.launches = 0
    hh.hh256.launches = 0
    t0 = time.perf_counter()
    for name, data in objects.items():
        info = eng.put_object("smoke", name, data)
        if info.etag != hashlib.md5(data).hexdigest() or \
                info.size != len(data):
            fail(f"PUT {name}: bad ObjectInfo")
    put_s = time.perf_counter() - t0
    put_counts = counts()
    if min(put_counts) <= 0:
        fail(f"PUT did not launch both kernels: {put_counts}")

    get_s = get_all(eng)
    healthy_counts = counts()

    # 3 drives gone; the first one holds data shard 0 of obj-0
    dist = hash_order("smoke/obj-0", k + m)
    gone = [dist.index(1)]
    gone += [i for i in range(k + m) if i not in gone][:2]
    disks = [None if i in gone else d for i, d in enumerate(eng.disks)]
    degraded = eng_mod.ErasureObjects(disks, k, m)
    deg_s = get_all(degraded)
    final = counts()
    deg_counts = (final[0] - healthy_counts[0], final[1] - healthy_counts[1])
    if min(deg_counts) <= 0:
        fail(f"degraded GET did not launch both kernels: {deg_counts}")
    gib = total / (1 << 30)
    out = {"phase": "main_path", "objects": len(objects),
           "bytes": total, "drives": k + m, "ec": f"{k}+{m}",
           "block_size": eng.block_size, "missing_drives": gone,
           "put_s": round(put_s, 3), "put_gib_s": round(gib / put_s, 4),
           "get_s": round(get_s, 3), "get_gib_s": round(gib / get_s, 4),
           "degraded_get_s": round(deg_s, 3),
           "degraded_get_gib_s": round(gib / deg_s, 4),
           "codec_step_s": {name: round(v, 4)
                            for name, v in codec.STEP_SECONDS.items()},
           "put_launches": {"gf_matmul": put_counts[0],
                            "hh256": put_counts[1]},
           "healthy_get_launches": {
               "gf_matmul": healthy_counts[0] - put_counts[0],
               "hh256": healthy_counts[1] - put_counts[1]},
           "degraded_get_launches": {"gf_matmul": deg_counts[0],
                                     "hh256": deg_counts[1]},
           "gf_matmul_launches": final[0], "hh256_launches": final[1],
           "card": card}
    emit(out)
    return out


def hh256_rounds(length: int) -> int:
    """Packet rounds of one row: full packets, the remainder packet, and
    the ten finalisation rounds."""
    return length // 32 + (1 if length % 32 else 0) + 10


def sm_clocks(torch, launch) -> dict:
    """The SM clock nvidia-smi reports while hh256 runs, and its maximum:
    200 launches are queued first so the card is busy when it is read."""
    for i in range(200):
        launch(i)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0]
    torch.cuda.synchronize()
    busy, top = (float(v) for v in out.split(","))
    return {"sm_clock_mhz": busy, "sm_clock_max_mhz": top}


def run_timings(torch, dev, rand_u8, max_err, pipeline, rs_cuda, hh,
                rs_matrix, kernels, sass, key, b, k, m, s) -> dict:
    """put_step, each kernel and each plain version at BASELINE.json's
    shape (B blocks at k+m, S bytes per shard), and hh256 alone at the
    main path's own launch shapes, each beside its bounds."""
    # four input sets (4 x 45 MB) cycled so repeated launches do not run
    # out of the 50 MB L2 cache
    datas = [rand_u8(b, k, s) for _ in range(4)]
    m2 = rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), dev)
    rows = [torch.cat([d, rs_cuda.gf_matmul_plain(m2, d)], 1).reshape(
        b * (k + m), s) for d in datas]
    shard = 349526                          # 4 MiB blocks at 12+4
    put_rows = [rand_u8(8 * (k + m), shard) for _ in range(4)]

    def timed(fn, iters: int) -> float:
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

    loop = sass.packet_loop(kernels.library("hh256"))    # raises if unread
    clocks = sm_clocks(torch, lambda i: hh.hh256(put_rows[i % 4], shard, key))
    out = {
        "put_step_ms": timed(lambda i: pipeline.put_step(datas[i % 4], k, m),
                             20),
        "gf_plain_ms": timed(
            lambda i: rs_cuda.gf_matmul_plain(m2, datas[i % 4]), 5),
        "hh_plain_ms": timed(lambda i: hh.hh256_plain(rows[i % 4], s, key),
                             1),
        "hh256_hot_loop": loop, **clocks,
        "int32_ops_per_s": INT32_OPS_PER_S,
        "hh256_ops_per_round": HH256_OPS_PER_ROUND,
    }
    # gf_matmul at BASELINE.json's shape and at the main path's own launch
    # shapes: PUT parity and degraded-GET decode with 1 and 3 data shards
    # lost, over batches of 8 blocks of 4 MiB
    survivors = [x[:8 * k].view(8, k, shard) for x in put_rows]
    full = (1 << (k + m)) - 1
    gf_shapes = {
        "baseline": (m2, datas),
        "put": (m2, survivors),
        "decode_r1": (rs_cuda.matrix_bits(rs_matrix.missing_data_matrix(
            k, m, full & ~(1 << 1))[0], dev), survivors),
        "decode_r3": (rs_cuda.matrix_bits(rs_matrix.missing_data_matrix(
            k, m, full & ~(1 << 0 | 1 << 5 | 1 << 9))[0], dev), survivors)}
    for name, (bits, sets) in gf_shapes.items():
        nb, _, width = sets[0].shape
        nbytes = nb * (k + bits.shape[0] // 8) * width
        # bit-sliced GF(2) product: one 32-bit XOR per set matrix bit per
        # 32 byte columns, the lower bound on operations for any design
        ops = nb * width * int(bits.sum()) / 32
        t = {"B": nb, "r": bits.shape[0] // 8, "k": k, "S": width,
             "ms": timed(lambda i: rs_cuda.gf_matmul(bits, sets[i % 4]), 50),
             "bytes": nbytes, "ops": ops,
             "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "op_bound_ms": ops / INT32_OPS_PER_S * 1e3}
        t["bound_ms"] = max(t["byte_bound_ms"], t["op_bound_ms"])
        t["bound_by"] = ("bytes" if t["byte_bound_ms"] >= t["op_bound_ms"]
                         else "operations")
        out[f"gf_matmul_{name}"] = t
    base = out["gf_matmul_baseline"]
    out.update({"gf_matmul_ms": base["ms"],
                "gf_matmul_byte_bound_ms": base["byte_bound_ms"],
                "gf_matmul_op_bound_ms": base["op_bound_ms"],
                "gf_matmul_bound_ms": base["bound_ms"]})
    shapes = {"baseline": (b * (k + m), s, rows),
              "put": (8 * (k + m), shard, put_rows),
              "degraded_get": (8 * k, shard, [x[:8 * k] for x in put_rows])}
    for name, (n, length, sets) in shapes.items():
        nbytes = n * (length + 32)
        ops = n * hh256_rounds(length) * HH256_OPS_PER_ROUND
        out[f"hh256_{name}"] = {
            "rows": n, "length": length,
            "ms": timed(lambda i: hh.hh256(sets[i % 4], length, key), 20),
            "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "op_bound_ms": ops / INT32_OPS_PER_S * 1e3,
            "rounds": hh256_rounds(length),
            "chain_floor_ms": hh256_rounds(length) * loop["chain_cycles"]
            / (clocks["sm_clock_mhz"] * 1e3),
            "bytes": nbytes, "ops": ops}
    base = out["hh256_baseline"]
    out.update({"hh256_ms": base["ms"],
                "hh256_byte_bound_ms": base["byte_bound_ms"],
                "hh256_op_bound_ms": base["op_bound_ms"],
                "hh256_bound_ms": max(base["byte_bound_ms"],
                                      base["op_bound_ms"])})
    out["gf_matmul_max_abs_err"] = max(
        max_err(rs_cuda.gf_matmul(bits, sets[0]),
                rs_cuda.gf_matmul_plain(bits, sets[0]))
        for bits, sets in gf_shapes.values())
    out["hh256_max_abs_err"] = max_err(hh.hh256(rows[0], s, key),
                                       hh.hh256_plain(rows[0], s, key))
    torch.cuda.synchronize()
    if out["gf_matmul_max_abs_err"] or out["hh256_max_abs_err"]:
        fail("kernel disagrees with its plain version at the timing shape")
    return out


if __name__ == "__main__":
    sys.exit(main())
