"""The port's scan plane (minio_tpu_torch/scan/, ops/scan_*) on the host,
held against minio_tpu's.

The port of tests/test_scan.py's cases, with the engine on the CPU
(device="cpu", so the predicate runs as the kernel's plain version): the
seeded CSV and JSON-Lines property suites, whose framed streams must equal
both packages' CPU evaluators byte for byte while the device path serves;
semantics corners; LIKE over newlines and the empty pattern; declines
counted by reason; bad-SQL parity; the device switch; plan signatures;
the former's scan verb (coalescing, mixed page counts, mixed queries, a
closed former); and Select over HTTP. The coalescing cases are
deterministic: the former's batch is sized to the requests' pages, so it
dispatches exactly when every request has submitted.

Beside them:
  * the row masks of ops/scan_plain.py against the reference's JAX
    program (minio_tpu/scan/kernels._kernel_for, traced under
    jax.enable_x64) and the evaluator's WHERE decision, query by query,
    over cells whose numbers are IEEE corners;
  * the kernel's interpreter (csrc/scan_eval.cu) restated in Python over
    the flattened program blob and held against the plain version: a
    rehearsal of the kernel's algorithm, not coverage of the CUDA source
    (which runs only on the card: tests/test_torch_cuda.py, chip_smoke.py);
  * the flattener's layout and limits, the `program-depth` decline;
  * a failing kernel launch fails the Select instead of answering from
    the evaluator, inline, through the former and over HTTP.
"""

from __future__ import annotations

import gzip
import math
import pathlib
import random
import re
import threading

import jax
import numpy as np
import pytest
import torch

from minio_tpu.s3select import sql as ref_sql
from minio_tpu.s3select.select import event_stream as ref_event_stream
from minio_tpu.scan import kernels as ref_kernels
from minio_tpu.scan import pager as ref_pager
from minio_tpu.scan import plan as ref_plan
from minio_tpu_torch.ops import kernels as ops_kernels
from minio_tpu_torch.ops import scan_cuda, scan_plain, scan_program
from minio_tpu_torch.parallel.scheduler import BatchScheduler
from minio_tpu_torch.s3.s3errors import S3Error
from minio_tpu_torch.s3select import sql
from minio_tpu_torch.s3select.select import event_stream
from minio_tpu_torch.scan import ScanEngine, kernels, pager
from minio_tpu_torch.scan.plan import Decline, compile_plan
from minio_tpu_torch.scripts import scan_cases as sc
from minio_tpu_torch.utils import telemetry

CPU = "cpu"


@pytest.fixture(autouse=True)
def _device_on(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SCAN_DEVICE", "on")


def _engine(sched=None) -> ScanEngine:
    return ScanEngine(sched, device=CPU)


def _pair(req, data: bytes) -> tuple[ScanEngine, bytes, bytes]:
    """(engine, the engine's bytes, the port's CPU evaluator's bytes); the
    reference's evaluator must give the same bytes as the port's."""
    eng = _engine()
    dev = b"".join(eng.event_stream(req, data))
    cpu = b"".join(event_stream(req, data))
    assert cpu == b"".join(ref_event_stream(req, data))
    return eng, dev, cpu


# -- the kernel's interpreter, restated -----------------------------------

def _num_cmp(op: int, a: float, b: float) -> bool:
    return (a == b, a != b, a < b, a <= b, a > b, a >= b)[op]


def _str_order(a: np.ndarray, b: np.ndarray) -> int:
    """scan_eval.cu's str_order: 8-byte words, zeros past each string's
    words, the lowest differing byte of the first differing word."""
    for i in range(max(len(a), len(b))):
        x = int(a[i]) if i < len(a) else 0
        y = int(b[i]) if i < len(b) else 0
        if x != y:
            low = (x ^ y) & -(x ^ y)
            sh = (low.bit_length() - 1) & ~7
            return -1 if (x >> sh) & 0xff < (y >> sh) & 0xff else 1
    return 0


def _arith(op: int, x: float, y: float) -> tuple[float, bool]:
    with np.errstate(all="ignore"):
        x, y = np.float64(x), np.float64(y)
        if op == 0:
            return float(x + y), True
        if op == 1:
            return float(x - y), True
        if op == 2:
            return float(x * y), True
        d = y if y != 0 else np.float64(1)
        if op == 3:
            return float(x / d), bool(y != 0)
        r = np.fmod(x, d)
        if r != 0 and (r < 0) != (d < 0):
            r = r + d
        return float(r), bool(y != 0)


def kernel_restated(program, arrays: dict) -> tuple[np.ndarray, np.ndarray]:
    """csrc/scan_eval.cu's kernel in Python over the program blob: the
    parts at the offsets the launcher is given, the postfix code, the
    value and bit stacks (their depths checked against the kernel's
    limits), word compares and LIKE loops, rowvalid, and the per-page
    COUNT sums."""
    blob = program.blob.tobytes()
    at_code, ncode, at_cspec, ncnt, at_lnum, at_lmeta, at_lbytes = \
        program.parts
    nlit = (at_lbytes - at_lmeta) // 12
    code = np.frombuffer(blob, "<i4", ncode, at_code).tolist()
    cspec = np.frombuffer(blob, "<i4", ncnt, at_cspec).tolist()
    lnum = np.frombuffer(blob, "<f8", nlit, at_lnum).tolist()
    lmeta = np.frombuffer(blob, "<i4", 3 * nlit, at_lmeta).reshape(-1, 3)
    lbytes = blob[at_lbytes:]
    assert len(blob) % 16 == 0

    def lit_words(li):
        off, n = int(lmeta[li][1]), int(lmeta[li][2])
        return np.frombuffer(lbytes, "<u8", (n + 7) // 8, off)

    num, ok, null = arrays["num"], arrays["ok"], arrays["null"]
    sb, slen, rv = arrays["sb"], arrays["slen"], arrays["rowvalid"]
    B, R, C, W = sb.shape
    mask = np.zeros((B, R), np.uint8)
    counts = np.zeros((B, ncnt), np.int32)
    for b in range(B):
        for r in range(R):
            if not rv[b, r]:
                continue
            vals, bits = [], []

            def words(side):
                kind, ref = side[3], side[4]
                if kind == 1:
                    return np.frombuffer(sb[b, r, ref].tobytes(), "<u8")
                return lit_words(ref)

            pc = 0
            while pc < ncode:
                op = code[pc]
                pc += 1
                if op in (1, 2):
                    bits.append(op == 1)
                elif op in (3, 4):
                    y, x = bits.pop(), bits.pop()
                    bits.append((x and y) if op == 3 else (x or y))
                elif op == 5:
                    bits.append(not bits.pop())
                elif op == 6:
                    s = code[pc]
                    pc += 1
                    vals.append((float(num[b, r, s]), bool(ok[b, r, s]),
                                 bool(null[b, r, s]), 1, s))
                elif op == 7:
                    li = code[pc]
                    pc += 1
                    vals.append((lnum[li], bool(lmeta[li][0]), False, 2, li))
                elif op == 8:
                    aop = code[pc]
                    pc += 1
                    y, x = vals.pop(), vals.pop()
                    v, nz = _arith(aop, x[0], y[0])
                    valid = x[1] and y[1] and nz
                    vals.append((v, valid, not valid, 0, 0))
                elif op == 9:
                    cop = code[pc]
                    pc += 1
                    y, x = vals.pop(), vals.pop()
                    both = x[1] and y[1]
                    if x[3] == 0 or y[3] == 0:
                        res = both and _num_cmp(cop, x[0], y[0])
                    elif both:
                        res = _num_cmp(cop, x[0], y[0])
                    elif x[2] or y[2]:
                        res = False
                    else:
                        c = _str_order(words(x), words(y))
                        res = (c == 0, c != 0, c < 0, c <= 0, c > 0,
                               c >= 0)[cop]
                    bits.append(res)
                elif op == 10:
                    bits.append(not vals.pop()[2])
                elif op == 11:
                    bits.append(bool(null[b, r, code[pc]]))
                    pc += 1
                elif op == 12:
                    slot, kind, li = code[pc:pc + 3]
                    pc += 3
                    L = int(lmeta[li][2])
                    needle = lbytes[int(lmeta[li][1]):][:L]
                    cell = sb[b, r, slot].tobytes()
                    s = int(slen[b, r, slot])
                    if kind == 4:
                        hit = True
                    elif L > W:
                        hit = False
                    elif kind == 0:
                        hit = s == L and cell[:L] == needle
                    elif kind == 1:
                        hit = s >= L and cell[:L] == needle
                    elif kind == 2:
                        hit = s >= L and cell[s - L:s] == needle
                    else:
                        hit = any(cell[o:o + L] == needle
                                  for o in range(0, s - L + 1))
                    bits.append(hit and not null[b, r, slot])
                else:
                    raise AssertionError(f"opcode {op}")
                assert len(vals) <= scan_program.MAX_VALS
                assert len(bits) <= scan_program.MAX_BOOLS
            assert len(bits) == 1 and not vals
            mask[b, r] = bits[0]
            for k, c in enumerate(cspec):
                counts[b, k] += bool(bits[0]) and (c < 0 or
                                                   not null[b, r, c])
    return mask, counts


def _plain(program, arrays):
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    m, c = scan_plain.scan_eval(program.prog, program.cspec, **t)
    return m.numpy(), c.numpy()


# ---------------------------------------------------------------------------
# the property: framed output identical, the device path serving
# ---------------------------------------------------------------------------

def _property(fmt: str, seed: int, edge: bool):
    rng = random.Random(seed)
    corpus = sc.csv_corpus if fmt == "CSV" else sc.json_corpus
    data = corpus(rng, rng.randint(40, 160), edge=edge)
    served = 0
    for _ in range(10):
        expr = sc.query(rng)
        other = "JSON" if fmt == "CSV" else "CSV"
        out = other if rng.random() < 0.3 else fmt
        eng, dev, cpu = _pair(sc.request(expr, fmt=fmt, out=out), data)
        assert dev == cpu, expr
        served += eng.device_serves
    # the generator leans supported: the device must carry real traffic
    assert served >= 5


@pytest.mark.parametrize("seed", range(4))
def test_property_csv_byte_identity(seed):
    _property("CSV", 1000 + seed, False)


@pytest.mark.parametrize("seed", range(4))
def test_property_json_lines_byte_identity(seed):
    _property("JSON", 2000 + seed, False)


@pytest.mark.parametrize("fmt", ["CSV", "JSON"])
def test_property_edge_cells_byte_identity(fmt):
    _property(fmt, 3000, True)


def test_semantics_corners_byte_identity():
    """Numeric-vs-string coercion, division/modulo by zero, negative
    floor-mod, empty cells, LIMIT mid-chunk, COUNT over nulls."""
    data = (b"a,b,c,d\n"
            b"10,9,x,\n"
            b"-3,0.5,,x y\n"
            b"0,0,Par,10\n"
            b"2.5,-0.5,b\xc3\xa9,Z\n")
    for expr in (
        "SELECT * FROM S3Object WHERE a < '9'",       # mixed coercion
        "SELECT * FROM S3Object WHERE a < b",
        "SELECT * FROM S3Object WHERE (a / b) > 1",   # div by zero row
        "SELECT * FROM S3Object WHERE (a % 2) = 1",   # negative mod
        "SELECT a FROM S3Object WHERE c = ''",
        "SELECT a FROM S3Object WHERE d >= 'Z'",
        "SELECT * FROM S3Object LIMIT 2",
        "SELECT COUNT(*), COUNT(c) FROM S3Object WHERE a <= 10",
        "SELECT a AS x, b FROM S3Object WHERE NOT (a IN (10, '0'))",
        "SELECT * FROM S3Object WHERE b BETWEEN -1 AND 1",
        "SELECT * FROM S3Object WHERE c LIKE '%a%' OR d LIKE 'x%'",
    ):
        eng, dev, cpu = _pair(sc.request(expr), data)
        assert dev == cpu, expr
        assert eng.device_serves == 1, expr


def test_like_newline_and_empty_pattern_byte_identity():
    """LIKE '' matches only the empty cell, and newline-bearing cells
    under LIKE decline to the CPU path, never diverge."""
    jl = (b'{"c": "abc\\n"}\n{"c": "abc"}\n{"c": ""}\n'
          b'{"c": "a\\nb"}\n{"c": "xbc"}\n')
    for expr, fmt, data, served in (
        ("SELECT c FROM S3Object WHERE c LIKE ''", "CSV",
         b"c\nabc\n\nxy\n", True),
        ("SELECT c FROM S3Object WHERE c LIKE 'abc'", "JSON", jl, False),
        ("SELECT c FROM S3Object WHERE c LIKE '%bc'", "JSON", jl, False),
        ("SELECT c FROM S3Object WHERE c LIKE '%b%'", "JSON", jl, False),
        ("SELECT c FROM S3Object WHERE c LIKE '%'", "JSON", jl, False),
    ):
        eng, dev, cpu = _pair(sc.request(expr, fmt=fmt), data)
        assert dev == cpu, expr
        if served:
            assert eng.device_serves == 1, expr
        else:
            assert eng.fallback_reasons.get("like-newline"), expr


# ---------------------------------------------------------------------------
# declines: counted by reason, output identical
# ---------------------------------------------------------------------------

def _fallback_counter(reason: str) -> float:
    return telemetry.REGISTRY.counter(
        "minio_tpu_scan_fallbacks_total").value(reason=reason)


def _deep(n: int) -> str:
    """A predicate nested n levels to the right: its postfix program keeps
    n + 1 booleans on the stack."""
    p = "a = 0"
    for i in range(1, n + 1):
        p = f"a = {i} OR ({p})"
    return p


def test_unsupported_constructs_fall_back_counted():
    csv_data = b"a,b\n1,x\n2,y\n"
    nested = b'{"a": {"deep": 1}, "b": 2}\n{"a": 3, "b": 4}\n'
    cases = [
        (sc.request("SELECT * FROM S3Object WHERE a = 1", fmt="JSON"),
         nested, "nested"),
        (sc.request("SELECT * FROM S3Object WHERE b LIKE 'a_b'"),
         csv_data, "like-pattern"),
        (sc.request("SELECT SUM(a) FROM S3Object"), csv_data, "aggregate"),
        (sc.request("SELECT * FROM S3Object WHERE a = 1", fmt="JSON",
                    json_type="DOCUMENT"), b'{"a": 1}', "json-document"),
        (sc.request("SELECT * FROM S3Object WHERE b = 'x'"),
         b"a,b\n1," + b"w" * 200 + b"\n2,x\n", "wide-string"),
        (sc.request("SELECT * FROM S3Object WHERE s3object = 'x'"),
         csv_data, "row-ref"),
        (sc.request(f"SELECT * FROM S3Object WHERE {_deep(40)}"),
         csv_data, "program-depth"),
        (sc.request("SELECT * FROM S3Object WHERE a = 1",
                    compression="GZIP"), b"not gzip", "error"),
    ]
    for req, data, reason in cases:
        before = _fallback_counter(reason)
        eng = _engine()
        if reason == "error":
            # the CPU path turns the input error into the client's error
            with pytest.raises(Exception):
                b"".join(eng.event_stream(req, data))
        else:
            eng, dev, cpu = _pair(req, data)
            assert dev == cpu, reason
        assert eng.device_serves == 0 and eng.fallbacks == 1, reason
        assert eng.fallback_reasons == {reason: 1}
        assert _fallback_counter(reason) == before + 1


def test_bad_sql_error_parity():
    """A request the parser rejects declines (`sql-error`) and the CPU
    path raises the client's S3 error."""
    eng = _engine()
    with pytest.raises(S3Error):
        b"".join(eng.event_stream(
            sc.request("SELECT FROM WHERE"), b"a,b\n1,2\n"))
    assert eng.fallback_reasons == {"sql-error": 1}


def test_device_off_falls_back(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SCAN_DEVICE", "off")
    eng, dev, cpu = _pair(
        sc.request("SELECT * FROM S3Object WHERE a = 1"), b"a\n1\n2\n")
    assert dev == cpu
    assert eng.device_serves == 0
    assert eng.fallback_reasons == {"no-device": 1}


def test_plan_signature_separates_literals():
    """Differing literals give different signatures, identical queries
    one; the copied compiler gives the reference's signatures."""
    exprs = ("SELECT * FROM S3Object WHERE a = 1",
             "SELECT * FROM S3Object WHERE a = 2",
             "SELECT * FROM S3Object WHERE a = 1")
    p1, p2, p3 = (compile_plan(sql.parse(e), "CSV") for e in exprs)
    assert p1.signature != p2.signature
    assert p1.signature == p3.signature
    for e, p in zip(exprs, (p1, p2, p3)):
        ref = ref_plan.compile_plan(ref_sql.parse(e), "CSV")
        assert (p.signature, p.prog) == (ref.signature, ref.prog)
    with pytest.raises(Decline):
        compile_plan(sql.parse("SELECT AVG(a) FROM S3Object"), "CSV")


# ---------------------------------------------------------------------------
# the former's scan verb
# ---------------------------------------------------------------------------

def _concurrent(sched, reqs_datas: list) -> tuple[ScanEngine, list]:
    eng = _engine(sched)
    outs: list = [None] * len(reqs_datas)
    barrier = threading.Barrier(len(reqs_datas))

    def one(i: int) -> None:
        barrier.wait()
        req, data = reqs_datas[i]
        outs[i] = b"".join(eng.event_stream(req, data))

    ts = [threading.Thread(target=one, args=(i,))
          for i in range(len(reqs_datas))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    return eng, outs


def test_concurrent_selects_coalesce_one_launch():
    # eight one-page requests and a batch of eight blocks: the bucket
    # fills, and dispatches, when the last request has submitted
    rng = random.Random(77)
    data = sc.csv_corpus(rng, 120)
    req = sc.request("SELECT a, b FROM S3Object WHERE a >= 1 AND b <> ''")
    cpu = b"".join(event_stream(req, data))
    n = 8
    sched = BatchScheduler(max_batch=n, max_wait=60.0)
    try:
        eng, outs = _concurrent(sched, [(req, data)] * n)
        assert all(o == cpu for o in outs)
        assert eng.device_serves == n
        vs = sched.verb_stats["scan"]
        assert vs["batches"] == 1 and vs["coalesced"] == n - 1
        assert vs["blocks"] == n             # one page each
    finally:
        sched.close()


def test_mixed_page_counts_coalesce_correct_slices():
    """Requests with different page counts and one plan and shape share a
    launch; each gets exactly its own rows of the mask back."""
    rng = random.Random(79)
    small = sc.csv_corpus(rng, 50)                       # 1 page
    big = sc.csv_corpus(rng, pager.PAGE_ROWS * 2 + 37)   # 3 pages
    req = sc.request("SELECT a, b FROM S3Object WHERE a >= 1 AND b <> ''")
    oracles = {d: b"".join(event_stream(req, d)) for d in (small, big)}
    datas = [small, big, big, small]
    sched = BatchScheduler(max_batch=8, max_wait=60.0)
    try:
        eng, outs = _concurrent(sched, [(req, d) for d in datas])
        for i, o in enumerate(outs):
            assert o == oracles[datas[i]], f"stream {i} wrong slice"
        assert eng.device_serves == len(datas)
        vs = sched.verb_stats["scan"]
        assert vs["batches"] == 1 and vs["coalesced"] == 3
        assert vs["blocks"] == 8                 # 1+3+3+1 pages
    finally:
        sched.close()


def test_mixed_queries_bucket_separately():
    """Two plans submitted concurrently stay in separate buckets (the
    signature is in the key): no cross-contaminated masks."""
    rng = random.Random(78)
    data = sc.csv_corpus(rng, 90)
    reqs = [sc.request("SELECT a FROM S3Object WHERE a > 1"),
            sc.request("SELECT COUNT(*) FROM S3Object WHERE a <= 1")]
    oracles = [b"".join(event_stream(r, data)) for r in reqs]
    sched = BatchScheduler(max_batch=64, max_wait=0.2)
    try:
        eng, outs = _concurrent(sched, [(reqs[i % 2], data)
                                        for i in range(6)])
        for i, o in enumerate(outs):
            assert o == oracles[i % 2]
        vs = sched.verb_stats["scan"]
        assert 2 <= vs["batches"] <= 6 and vs["blocks"] == 6
    finally:
        sched.close()


def test_scheduler_close_falls_back():
    """A scan on a closed former answers from the CPU (`declined`)."""
    sched = BatchScheduler(max_batch=64, max_wait=0.1)
    sched.close()
    eng = _engine(sched)
    req = sc.request("SELECT * FROM S3Object WHERE a = 1")
    assert b"".join(eng.event_stream(req, b"a\n1\n2\n")) \
        == b"".join(event_stream(req, b"a\n1\n2\n"))
    assert eng.fallback_reasons == {"declined": 1}


# ---------------------------------------------------------------------------
# the live endpoint rides the device path
# ---------------------------------------------------------------------------

def _select_server(tmp_path):
    from minio_tpu_torch import cluster
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch.s3.credentials import Credentials
    creds = Credentials("scantest1234", "scansecret1234")
    node = cluster.start_single([str(tmp_path / "d{1...4}")], creds=creds,
                                parity=2, block_size=1 << 16, device=CPU)
    client = S3Client(node.s3.port, creds)
    assert client.send("PUT", "/data")[0] == 200
    return node, client


_SELECT = {"select": "", "select-type": "2"}


def test_select_over_http_device_path(tmp_path):
    data = (b"name,age,city\n"
            b"alice,30,paris\n"
            b"bob,25,london\n"
            b"carol,35,paris\n")
    expr = "SELECT name FROM S3Object WHERE city = 'paris'"
    oracle = b"".join(event_stream(sc.request(expr), data))
    node, c = _select_server(tmp_path)
    try:
        assert c.send("PUT", "/data/people.csv", body=data)[0] == 200
        st, h, body = c.send("POST", "/data/people.csv", query=_SELECT,
                             body=sc.select_xml(expr))
        assert st == 200 and h["content-type"] == "application/octet-stream"
        assert body == oracle                # framed stream, verbatim
        assert node.s3.api.scan.device_serves == 1
        assert node.s3.api.scan.fallbacks == 0
        # through the boot's former, on the cluster's device
        assert node.s3.api.scan.scheduler is node.scheduler
        assert node.scheduler.verb_stats["scan"]["batches"] == 1
        st, _, body = c.send("POST", "/data/absent.csv", query=_SELECT,
                             body=sc.select_xml(expr))
        assert st == 404 and b"<Code>NoSuchKey</Code>" in body
    finally:
        node.shutdown()


# ---------------------------------------------------------------------------
# no fallback when the device fails
# ---------------------------------------------------------------------------

def _failing_launch(*_a, **_k):
    raise RuntimeError("scan_eval launch: CUDA error 719")


def test_failing_launcher_fails_the_select(monkeypatch):
    """A kernel launch that fails raises out of the engine, inline and
    through the former; the evaluator never answers."""
    monkeypatch.setattr(scan_cuda, "scan_eval", _failing_launch)
    answered = []
    monkeypatch.setattr("minio_tpu_torch.s3select.select.event_stream",
                        lambda *a: answered.append(a) or iter(()))
    req = sc.request("SELECT a FROM S3Object WHERE a > 1")
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        _engine().event_stream(req, b"a\n1\n2\n")
    sched = BatchScheduler(max_batch=64, max_wait=0.01)
    try:
        with pytest.raises(RuntimeError, match="CUDA error 719"):
            _engine(sched).event_stream(req, b"a\n1\n2\n")
    finally:
        sched.close()
    assert answered == []


def test_failing_launcher_answers_500_over_http(tmp_path, monkeypatch):
    node, c = _select_server(tmp_path)
    try:
        assert c.send("PUT", "/data/t.csv", body=b"a\n1\n2\n")[0] == 200
        monkeypatch.setattr(scan_cuda, "scan_eval", _failing_launch)
        st, _, body = c.send("POST", "/data/t.csv", query=_SELECT,
                             body=sc.select_xml(
                                 "SELECT a FROM S3Object WHERE a > 1"))
        assert st == 500 and b"<Code>InternalError</Code>" in body
        assert node.s3.api.scan.device_serves == 0
        assert node.s3.api.scan.fallbacks == 0
    finally:
        node.shutdown()


# ---------------------------------------------------------------------------
# the plain version against the reference's JAX program and the evaluator
# ---------------------------------------------------------------------------

def _jax_mask(plan, arrays) -> np.ndarray:
    """The reference's own program for `plan` (scan/kernels._kernel_for),
    traced and run with 64-bit floats on."""
    with jax.enable_x64(True):
        fn = ref_kernels._kernel_for(plan, None)
        return np.asarray(fn(*[arrays[k] for k in ref_kernels._ARRAY_ORDER]))


@pytest.mark.parametrize("fmt", ["CSV", "JSON"])
def test_masks_equal_the_jax_program_and_the_evaluator(fmt):
    import json as _json
    data = sc.oracle_csv()
    if fmt == "JSON":
        data = ("\n".join(_json.dumps(r) for r in sc.rows_of(data, "CSV"))
                + "\n").encode()
    rows = sc.rows_of(data, fmt)
    checked = flushed = 0
    for where in sc.ORACLE_WHERE:
        expr = f"SELECT * FROM S3Object WHERE {where}"
        q = sql.parse(expr)
        plan = compile_plan(q, fmt)
        ref = ref_plan.compile_plan(ref_sql.parse(expr), fmt)
        assert plan.prog == ref.prog and plan.signature == ref.signature
        pages = pager.build_pages(rows, plan)
        ref_pages = ref_pager.build_pages(rows, ref)
        for k, v in pages.arrays.items():
            assert np.array_equal(v, ref_pages.arrays[k], equal_nan=True) \
                if v.dtype == np.float64 else np.array_equal(
                    v, ref_pages.arrays[k]), (where, k)
        program = scan_program.program_for(plan)
        mask, _ = _plain(program, pages.arrays)
        mask = mask.reshape(-1)[:len(rows)].astype(bool)
        where_rows = np.array([bool(sql.evaluate(q.where, r, q.alias))
                               for r in rows])
        assert np.array_equal(mask, where_rows), where
        # XLA on the CPU flushes subnormal float64 values to zero, so the
        # JAX program departs from its own evaluator on rows holding one
        # (1e-320); the port follows the evaluator there, and equals the
        # JAX program on every other row
        jax_rows = _jax_mask(ref, ref_pages.arrays).reshape(-1)[:len(rows)]
        C = pages.arrays["num"].shape[-1]
        num = pages.arrays["num"].reshape(-1, C)[:len(rows)]
        ok = pages.arrays["ok"].reshape(-1, C)[:len(rows)]
        sub = ((num != 0) & (np.abs(num) < np.finfo(np.float64).tiny)
               & ok).any(1)
        assert np.array_equal(mask[~sub], jax_rows[~sub]), where
        flushed += int((mask != jax_rows).sum())
        # and the framed stream
        eng, dev, cpu = _pair(sc.request(expr, fmt=fmt), data)
        assert dev == cpu and eng.device_serves == 1, where
        checked += 1
    assert checked >= 40
    assert flushed > 0          # the corner is in the corpus


# ---------------------------------------------------------------------------
# the kernel's algorithm, restated, against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["CSV", "JSON"])
@pytest.mark.parametrize("width", [0, 12, 30, 60, 100])
def test_kernel_restated_equals_plain(fmt, width):
    for expr, program, pages, _q, _r in sc.page_cases(
            fmt, width, 100 + width, 12, rows=120):
        want = _plain(program, pages.arrays)
        got = kernel_restated(program, pages.arrays)
        assert np.array_equal(got[0], want[0]), expr
        assert np.array_equal(got[1], want[1]), expr


def test_kernel_restated_oracle_queries():
    rows = sc.rows_of(sc.oracle_csv(), "CSV")
    for where in sc.ORACLE_WHERE:
        plan = compile_plan(sql.parse(
            f"SELECT COUNT(*), COUNT(s) FROM S3Object WHERE {where}"),
            "CSV")
        program = scan_program.program_for(plan)
        pages = pager.build_pages(rows, plan)
        got = kernel_restated(program, pages.arrays)
        want = _plain(program, pages.arrays)
        assert np.array_equal(got[0], want[0]), where
        assert np.array_equal(got[1], want[1]), where


def test_kernel_restated_rounds_once_per_operation():
    data, expr = sc.fma_case()
    rows = sc.rows_of(data, "CSV")
    plan = compile_plan(sql.parse(expr), "CSV")
    program = scan_program.program_for(plan)
    pages = pager.build_pages(rows, plan)
    assert kernel_restated(program, pages.arrays)[1][0, 0] == 1
    assert _plain(program, pages.arrays)[1][0, 0] == 1


# ---------------------------------------------------------------------------
# the flattener, the packing, the batch
# ---------------------------------------------------------------------------

def test_flattener_limits_are_the_kernels():
    # the kernel's stack depths are the flattener's, passed to nvcc; the
    # source has no numbers of its own for them
    flags = ops_kernels.flags("scan_eval")
    assert f"-DSCAN_MAX_VALS={scan_program.MAX_VALS}" in flags
    assert f"-DSCAN_MAX_BOOLS={scan_program.MAX_BOOLS}" in flags
    assert "-fmad=false" in flags
    src = (pathlib.Path(scan_cuda.__file__).parent.parent / "csrc"
           / "scan_eval.cu").read_text()
    assert "constexpr int kMaxVals = SCAN_MAX_VALS;" in src
    assert "constexpr int kMaxBools = SCAN_MAX_BOOLS;" in src
    # the launcher takes the program's parts and depths in Program's order
    assert re.search(r"int scan_eval_launch\(const void\* prog, int "
                     r"prog_bytes, int code, int ncode,\s+int cspec, int "
                     r"ncnt, int lnum, int lmeta, int lbytes,\s+int "
                     r"max_vals, int max_bools,", src)


def test_flattener_layout():
    plan = compile_plan(sql.parse(
        "SELECT COUNT(*), a, COUNT(b) FROM S3Object WHERE "
        "a IN (1, 'x') AND b BETWEEN 'p' AND 2 AND c LIKE '%abcdefghi%' "
        "AND (a * 2) > 3 AND NOT (b IS NULL)"), "CSV")
    prog = scan_program.flatten(plan)
    blob = prog.blob.tobytes()
    at_code, ncode, at_cspec, ncnt, at_lnum, at_lmeta, at_lbytes = \
        prog.parts
    assert prog.cspec == (-1, plan.columns.index("b"))
    assert at_code == 0 and at_cspec == 4 * ncode and ncnt == 2
    assert len(blob) % 16 == 0 and at_lnum % 8 == 0
    nlit = (at_lmeta - at_lnum) // 8
    assert at_lbytes % 8 == 0 and 0 <= at_lbytes - at_lmeta - 12 * nlit < 8
    assert np.frombuffer(blob, "<i4", ncnt, at_cspec).tolist() == \
        list(prog.cspec)
    lmeta = np.frombuffer(blob, "<i4", 3 * nlit, at_lmeta)
    offs, lens = lmeta[1::3], lmeta[2::3]
    assert all(o % 8 == 0 for o in offs)
    lb = blob[at_lbytes:]
    texts = {lb[o:o + n] for o, n in zip(offs, lens)}
    assert {b"1", b"x", b"p", b"2", b"abcdefghi", b"3"} <= texts
    assert prog.max_vals == 2                 # two sides at most
    # IN over two items keeps two bools; BETWEEN's AND chain two
    assert 2 <= prog.max_bools <= 3


def test_program_depth_limit():
    ok = compile_plan(sql.parse(
        f"SELECT * FROM S3Object WHERE {_deep(scan_program.MAX_BOOLS - 1)}"),
        "CSV")
    assert scan_program.flatten(ok).max_bools == scan_program.MAX_BOOLS
    deep = compile_plan(sql.parse(
        f"SELECT * FROM S3Object WHERE {_deep(scan_program.MAX_BOOLS)}"),
        "CSV")
    with pytest.raises(Decline) as e:
        scan_program.flatten(deep)
    assert e.value.reason == "program-depth"
    arith = "a"
    for i in range(scan_program.MAX_VALS):
        arith = f"({i} + {arith})"
    with pytest.raises(Decline) as e:
        scan_program.flatten(compile_plan(sql.parse(
            f"SELECT * FROM S3Object WHERE {arith} > 0"), "CSV"))
    assert e.value.reason == "program-depth"
    # size is no limit: a long IN list of long literals flattens
    huge = ", ".join(f"'{'w' * 60}{i}'" for i in range(700))
    big = scan_program.flatten(compile_plan(sql.parse(
        f"SELECT * FROM S3Object WHERE a IN ({huge})"), "CSV"))
    assert big.blob.nbytes > 48 * 1024
    assert big.max_vals == 2 and big.max_bools == 2


def test_large_programs_are_served_on_the_device_path():
    # a program past a block's shared memory is not declined: the Select
    # rides the device path and frames the evaluator's stream
    rng = random.Random(21)
    data = sc.csv_corpus(rng, 120)
    items = ", ".join(f"'{'w' * 60}{i}'" for i in range(700))
    for expr in (f"SELECT COUNT(*) FROM S3Object WHERE a IN ({items}, 25)",
                 f"SELECT a, b FROM S3Object WHERE b NOT IN ({items}, 'x')"):
        eng, dev, cpu = _pair(sc.request(expr), data)
        assert dev == cpu
        assert eng.device_serves == 1 and eng.fallbacks == 0


def test_scan_eval_writes_given_outputs():
    for _e, program, pages, _q, _r in sc.page_cases("CSV", 12, 6, 3,
                                                     rows=300):
        t = {k: torch.from_numpy(v) for k, v in pages.arrays.items()}
        B, R = pages.arrays["rowvalid"].shape
        mask = torch.full((B, R), 7, dtype=torch.uint8)
        counts = torch.full((B, len(program.cspec)), -1, dtype=torch.int32)
        got = scan_cuda.scan_eval(program, mask=mask, counts=counts, **t)
        assert got[0] is mask and got[1] is counts
        want = _plain(program, pages.arrays)
        assert np.array_equal(mask.numpy(), want[0])
        assert np.array_equal(counts.numpy(), want[1])


def test_must_move_bytes_counts_what_the_program_reads():
    # Q6's shape: a date compare (string bytes, ok and null), a BETWEEN
    # over numbers (number, ok, null) and a < over numbers (number, ok);
    # no slen, no other sb
    data = sc.lineitem_csv(3000, 2)
    rows = sc.rows_of(data, "CSV")
    plan = compile_plan(sql.parse(sc.Q6_COUNT), "CSV")
    program = scan_program.program_for(plan)
    pages = pager.build_pages(rows, plan)
    B, R, C, W = pages.arrays["sb"].shape
    assert (C, W) == (3, 16)
    mask = _plain(program, pages.arrays)[0]
    n = pages.n_rows
    want = n * (2 + W) + n * (8 + 1 + 1) + n * (8 + 1) + 2 * B * R + 4 * B \
        + program.blob.nbytes
    assert sc.must_move_bytes(program, pages.arrays, mask) == want
    # a LIKE reads null and slen, and only the bytes its form needs
    arrays = {"num": np.zeros((1, 4, 1)), "ok": np.zeros((1, 4, 1), bool),
              "null": np.array([[[0], [0], [1], [0]]], bool),
              "slen": np.array([[[3], [5], [0], [8]]], np.int32),
              "sb": np.zeros((1, 4, 1, 8), np.uint8),
              "rowvalid": np.array([[1, 1, 1, 0]], bool)}
    for form, pat, sbytes in (("prefix", "abc%", 3 + 3),
                              ("exact", "abcde", 5),
                              ("contains", "%bc%", 3 + 5),
                              ("any", "%", 0)):
        plan = compile_plan(sql.parse(
            f"SELECT * FROM S3Object WHERE a LIKE '{pat}'"), "CSV")
        program = scan_program.flatten(plan)
        assert plan.prog[2] == form
        live = 0 if form == "any" else 2
        got = sc.must_move_bytes(program, arrays, np.zeros((1, 4), bool))
        assert got == 3 + 4 * live + sbytes + 8 + program.blob.nbytes, form


def test_program_cache_is_a_bounded_lru(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_SCAN_KERNEL_CACHE", "2")
    plans = [compile_plan(sql.parse(
        f"SELECT * FROM S3Object WHERE a = {i + 1000}"), "CSV")
        for i in range(3)]
    first = scan_program.program_for(plans[0])
    assert scan_program.program_for(plans[0]) is first
    scan_program.program_for(plans[1])
    scan_program.program_for(plans[2])
    assert len(scan_program._PROGRAMS) == 2
    assert scan_program.program_for(plans[0]) is not first


def test_pack_unpack_round_trip():
    for _e, program, pages, _q, _r in sc.page_cases("JSON", 30, 3, 3,
                                                     rows=2100):
        packed = scan_cuda.pack_pages(pages.arrays)
        B = pages.n_pages
        R, C, W = pages.shape_key()
        assert packed.shape == (B, scan_cuda.page_layout(R, C, W)[1])
        views = scan_cuda.unpack(torch.from_numpy(packed), R, C, W)
        for k, v in pages.arrays.items():
            assert np.array_equal(views[k].numpy(), v,
                                  equal_nan=v.dtype == np.float64), k
        mask, counts = kernels.run_batch(pages.plan, pages.arrays, CPU)
        want = _plain(program, pages.arrays)
        assert np.array_equal(mask, want[0].astype(bool))
        assert np.array_equal(counts, want[1])


def test_count_sums_per_page_and_ragged_batches():
    for _e, program, pages, _q, _r in sc.page_cases("CSV", 12, 4, 6,
                                                     rows=2100):
        for B in (1, 3, 5):
            arrays = sc.tile_pages(pages.arrays, B, 777)
            mask, counts = _plain(program, arrays)
            assert not mask[-1, 777:].any()
            nulls = arrays["null"]
            for k, c in enumerate(program.cspec):
                want = mask.astype(bool) if c < 0 else \
                    mask.astype(bool) & ~nulls[:, :, c]
                assert np.array_equal(counts[:, k], want.sum(1))


def test_device_none_means_the_card():
    eng = ScanEngine()
    req = sc.request("SELECT a FROM S3Object WHERE a > 1")
    if torch.cuda.is_available():
        pytest.skip("a card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.event_stream(req, b"a\n1\n2\n")


def test_select_gzip_and_floor_mod_corners():
    data = b"a,b\n" + b"\n".join(
        f"{x},{y}".encode() for x in ("-7", "7", "-0", "inf", "nan", "5.5")
        for y in ("2", "-2", "inf", "-inf", "0", "-0.0", "nan")) + b"\n"
    for expr in ("SELECT * FROM S3Object WHERE (a % b) > 0",
                 "SELECT * FROM S3Object WHERE (a % b) < 0",
                 "SELECT COUNT(*) FROM S3Object WHERE (a % b) = (a % b)",
                 "SELECT * FROM S3Object WHERE (a / b) >= 0"):
        for comp, body in (("NONE", data), ("GZIP", gzip.compress(data))):
            eng, dev, cpu = _pair(sc.request(expr, compression=comp), body)
            assert dev == cpu and eng.device_serves == 1, (expr, comp)
    assert math.isnan(float("nan") % 2)


def _fmod_operands():
    rng = random.Random(1)
    vals = [0.0, -0.0, 1e308, -1e308, 1.7976931348623157e308, 1e-320,
            -1e-320, 5e-324, 7.0, -7.0, 5.5, 0.3, 0.1, 1e22, 3.0, -0.5,
            2.5, math.inf, -math.inf, math.nan, 1 - 2 ** -53, 2 ** -1022]
    vals += [rng.uniform(-1e6, 1e6) for _ in range(20)]
    vals += [10 ** rng.uniform(-300, 300) * rng.choice((1, -1))
             for _ in range(20)]
    a = np.array([x for x in vals for _ in vals])
    b = np.array([y for _ in vals for y in vals])
    return a, b


def test_plain_fmod_is_exact():
    """C's fmod bit for bit, sign of zero included, where PyTorch's own
    vectorized fmod divides first (1e308 % -0.5 gives nan there)."""
    a, b = _fmod_operands()
    got = scan_plain._fmod(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    with np.errstate(all="ignore"):
        want = np.fmod(a, b)
    same = (got == want) & (np.signbit(got) == np.signbit(want))
    assert (same | (np.isnan(got) & np.isnan(want))).all()
