"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card (tolerance 0: exact bytes, and for the scan kernel
equal masks and COUNT sums). Marked `cuda`: each test skips, with the
reason, on a host without a card; CUDA kernels have no CPU mode."""

import hashlib
import random

import numpy as np
import pytest
import torch

from minio_tpu_torch.bitrot import MAGIC_HIGHWAYHASH_KEY as KEY
from minio_tpu_torch.models import pipeline
from minio_tpu_torch.ops import (chacha20_cuda, chacha20_plain,
                                 chacha20_ref, highwayhash_cuda,
                                 highwayhash_py, rs_cuda, rs_matrix,
                                 scan_cuda, scan_plain, scan_program,
                                 sha256_cuda, sha256_ref)
from minio_tpu_torch.scripts import scan_cases
from minio_tpu_torch.utils import guard_pages

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(shape, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8)).to(dev)


GF_WIDTHS = [0, 1, 2, 3, 5, 15, 16, 17, 31, 33, 4095, 4097, 16384, 87382,
             100003, 349526]


def _random_bits(r, k, seed, dev):
    """A random (8r, 8k) 0/1 matrix: not the expansion of a GF matrix."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (8 * r, 8 * k), dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("s", GF_WIDTHS)
def test_gf_matmul_kernel_equals_plain(dev, s):
    for k, m in ((4, 2), (12, 4), (16, 16)):
        m2 = rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), dev)
        x = _rand((3 if s < 100000 else 1, k, s), s, dev)
        before = rs_cuda.gf_matmul.launches
        got = rs_cuda.gf_matmul(m2, x)
        assert torch.equal(got, rs_cuda.gf_matmul_plain(m2, x))
        assert rs_cuda.gf_matmul.launches == before + (1 if s else 0)


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 8, 12, 16])
@pytest.mark.parametrize("k", [1, 3, 12, 16])
def test_gf_matmul_random_matrices(dev, r, k):
    m2 = _random_bits(r, k, 16 * r + k, dev)
    for s in (33, 4097):
        x = _rand((2, k, s), r * s + k, dev)
        assert torch.equal(rs_cuda.gf_matmul(m2, x),
                           rs_cuda.gf_matmul_plain(m2, x))


def _launch_into(m2, x, out):
    """The C entry point on `x` into `out`, both at any byte address."""
    r, k = m2.shape[0] // 8, m2.shape[1] // 8
    err = rs_cuda._launcher()(
        m2.data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0], r, k,
        x.shape[-1], torch.cuda.current_stream(x.device).cuda_stream)
    assert err == 0


@pytest.mark.parametrize("base", range(1, 16))
def test_gf_matmul_offset_views(dev, base):
    # input and output start at every byte offset mod 16; the bytes around
    # the output must stay as they were
    k, r, s = 12, 4, 4097
    m2 = _random_bits(r, k, base, dev)
    flat = _rand((base + 3 * k * s,), base, dev)
    x = flat[base:].view(3, k, s)
    assert x.data_ptr() % 16 == base
    assert torch.equal(rs_cuda.gf_matmul(m2, x),
                       rs_cuda.gf_matmul_plain(m2, x))
    o = (3 * base) % 16
    out_flat = _rand((o + 3 * r * s + 16,), base + 1, dev)
    before = out_flat.clone()
    out = out_flat[o:o + 3 * r * s].view(3, r, s)
    _launch_into(m2, x, out)
    assert torch.equal(out, rs_cuda.gf_matmul_plain(m2, x))
    assert torch.equal(out_flat[:o], before[:o])
    assert torch.equal(out_flat[o + 3 * r * s:], before[o + 3 * r * s:])


@pytest.mark.parametrize("b,s", [(3, 17), (2, 4097), (1, 87382)])
def test_gf_matmul_touches_only_its_tensors(dev, b, s):
    # input and output at each end of a mapping between unmapped ranges: a
    # read of a word without an input byte, or a store past the output,
    # stops the kernel with an illegal-address error
    k = 12
    for m2 in (rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, 4), dev),
               _random_bits(3, k, s, dev)):
        r = m2.shape[0] // 8
        n_in, n_out = b * k * s, b * r * s
        with guard_pages.guarded(n_in, dev) as src, \
                guard_pages.guarded(n_out, dev) as dst:
            for x in (src[:n_in], src[-n_in:]):
                x = x.view(b, k, s)
                x.copy_(_rand((b, k, s), s, dev))
                want = rs_cuda.gf_matmul_plain(m2, x)
                for out in (dst[:n_out], dst[-n_out:]):
                    out = out.view(b, r, s)
                    _launch_into(m2, x, out)
                    torch.cuda.synchronize()
                    assert torch.equal(out, want)


def test_gf_matmul_main_shape_repeated(dev):
    # the main path's PUT launch, three times: a store race at a tile edge
    # shows only sometimes
    k, m, s = 12, 4, 349526
    m2 = rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), dev)
    x = _rand((8, k, s), 11, dev)
    want = rs_cuda.gf_matmul_plain(m2, x)
    for _ in range(3):
        assert torch.equal(rs_cuda.gf_matmul(m2, x), want)


@pytest.mark.parametrize("length", [0, 1, 3, 16, 21, 31, 32, 33, 1000])
def test_hh256_kernel_equals_plain(dev, length):
    rows = _rand((8, length + 5), length, dev)
    before = highwayhash_cuda.hh256.launches
    got = highwayhash_cuda.hh256(rows, length, KEY)
    assert torch.equal(got, highwayhash_cuda.hh256_plain(rows, length, KEY))
    assert highwayhash_cuda.hh256.launches == before + 1


def _check_hh256(rows, length, row=-1):
    """Kernel == plain version on every row, and == the scalar
    HighwayHash on one row (the last by default: it may end the tensor)."""
    got = highwayhash_cuda.hh256(rows, length, KEY)
    assert torch.equal(got, highwayhash_cuda.hh256_plain(rows, length, KEY))
    h = highwayhash_py.HighwayHash(KEY)
    h.update(rows[row, :length].cpu().numpy().tobytes())
    assert got[row].cpu().numpy().tobytes() == h.digest256()


@pytest.mark.parametrize("stride", [1031, 349526])
def test_hh256_every_row_offset(dev, stride):
    # 1031 = 7 mod 16 puts 16 rows at every start offset mod 16; 349,526
    # (the main path's S) at every even one; length == row_stride, so the
    # last row ends the tensor (one length there: the plain version walks
    # 10,923 rounds at ~1 ms each)
    rows = _rand((16, stride), stride, dev)
    for length in (stride,) if stride > 2000 else (stride, stride - 1,
                                                   stride - 17):
        _check_hh256(rows, length)


@pytest.mark.parametrize("base", [1, 3, 6, 8, 13, 15])
def test_hh256_offset_views(dev, base):
    flat = _rand((base + 9 * 1031,), base, dev)
    view = flat[base:].view(9, 1031)        # contiguous, starts mid-word
    assert view.data_ptr() % 16 == base % 16
    _check_hh256(view, 1031)
    _check_hh256(view, 1000, row=4)
    sliced = _rand((9, 1040), base, dev)[:, base:].contiguous()
    _check_hh256(sliced, sliced.shape[1])


@pytest.mark.parametrize("chunk", [512, 1024, 2048])
def test_hh256_lengths_around_chunks(dev, chunk):
    for length in (chunk - 31, chunk - 1, chunk, chunk + 1, chunk + 31):
        _check_hh256(_rand((5, length + 3), length, dev), length)


@pytest.mark.parametrize("n_rows", [1, 2, 15, 17, 33, 96, 128, 512, 1100,
                                    9000])
def test_hh256_row_counts(dev, n_rows):
    # past 4 warps per SM, warps take several rows each (1100) and at 16
    # rows per warp the ring needs more than 48 KB of shared memory (9000)
    rows = _rand((n_rows, 1031), n_rows, dev)
    _check_hh256(rows, 1031)
    _check_hh256(rows, 999, row=0)


@pytest.mark.parametrize("n_rows,length", [(3, 17), (16, 1031), (2, 4102)])
def test_hh256_reads_only_its_rows(dev, n_rows, length):
    # rows at each end of a mapping between unmapped ranges: a read of a
    # word without a row byte stops the kernel with an illegal-address error
    n = n_rows * length
    with guard_pages.guarded(n, dev) as buf:
        for rows in (buf[:n], buf[-n:]):
            rows = rows.view(n_rows, length)
            rows.copy_(_rand((n_rows, length), length, dev))
            got = highwayhash_cuda.hh256(rows, length, KEY)
            torch.cuda.synchronize()
            assert torch.equal(
                got, highwayhash_cuda.hh256_plain(rows, length, KEY))


def test_hh256_shard_inside_longer_rows(dev):
    rows = _rand((4, 349526 + 64), 64, dev)
    _check_hh256(rows, 349526)


def test_put_step_on_card_equals_cpu(dev):
    x = _rand((2, 12, 1031), 5, dev)
    on_card = pipeline.put_step(x, 12, 4, 1000)
    on_cpu = pipeline.put_step(x.cpu(), 12, 4, 1000)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


def test_get_step_hashes_survivors_only(dev):
    k, m = 12, 4
    mask = sum(1 << i for i in range(k + m) if i not in (1, 5, 14))
    dm, used, missing = rs_matrix.missing_data_matrix(k, m, mask)
    bits = rs_cuda.matrix_bits(dm, dev)
    x = _rand((8, k, 1031), 7, dev)
    before = highwayhash_cuda.hh256.launches
    out, dig = pipeline.get_step(x, bits, len(missing), k, 1000)
    assert highwayhash_cuda.hh256.launches == before + 1
    assert dig.shape == (8, k, 32)
    cpu = pipeline.get_step(x.cpu(), bits.cpu(), len(missing), k, 1000)
    assert torch.equal(out.cpu(), cpu[0]) and torch.equal(dig.cpu(), cpu[1])


def _check_sha256(rows, length):
    got = sha256_cuda.sha256_rows(rows, length)
    torch.cuda.synchronize()
    assert torch.equal(got, sha256_ref.sha256_rows(rows, length))
    host = rows[:, :length].cpu().numpy()
    for i, r in enumerate(host):
        assert got[i].cpu().numpy().tobytes() == \
            hashlib.sha256(r.tobytes()).digest()


# csrc/sha256.cu stages 128 bytes of a row per ring stage, and its three
# producers with two slots each turn once every 6 stages (768 bytes): a
# stage's bytes -1, +0, +1, and both padding forms (length % 64 = 55, 56,
# 63, 0) ending a stage or crossing into the next, at both
SHA256_STAGE_LENGTHS = sorted({base + d for base in (128, 768)
                               for d in (-64 + 55, -64 + 56, -1, 0, 1, 55,
                                         56, 63, 64)})


@pytest.mark.parametrize("length", sorted(
    {0, 1, 3, 55, 56, 57, 63, 64, 65, 119, 120, 127, 128, 1000, 4099}
    | set(SHA256_STAGE_LENGTHS)))
def test_sha256_kernel_equals_plain(dev, length):
    before = sha256_cuda.sha256_rows.launches
    _check_sha256(_rand((35, length + 5), length, dev), length)
    assert sha256_cuda.sha256_rows.launches == before + 1


@pytest.mark.parametrize("stride", [1024, 1028, 1030, 1031])
def test_sha256_row_alignments(dev, stride):
    # rows on 16-, 4-, 2- and 1-byte boundaries, every load path
    _check_sha256(_rand((33, stride), stride, dev), stride)
    _check_sha256(_rand((33, stride), stride + 1, dev), stride - 9)


# a block is 32 rows (one per lane of its round warp)
@pytest.mark.parametrize("n_rows", [1, 31, 32, 33, 63, 64, 65, 639, 640,
                                    641])
def test_sha256_row_counts(dev, n_rows):
    # rows of 1031 bytes start at every offset mod 16
    _check_sha256(_rand((n_rows, 1031), n_rows, dev), 1031)


@pytest.mark.parametrize("n_rows,length", [(3, 17), (40, 1031),
                                           (20, 8192), (32, 1031),
                                           (64, 8193)])
def test_sha256_reads_only_its_rows(dev, n_rows, length):
    # rows at each end of a mapping between unmapped ranges: a read
    # outside the rows stops the kernel with an illegal-address error
    n = n_rows * length
    with guard_pages.guarded(n, dev) as buf:
        for rows in (buf[:n], buf[-n:]):
            rows = rows.view(n_rows, length)
            rows.copy_(_rand((n_rows, length), length, dev))
            _check_sha256(rows, length)


def test_put_step_sha256_on_card_equals_cpu(dev):
    x = _rand((2, 16, 4096), 6, dev)
    before = sha256_cuda.sha256_rows.launches
    on_card = pipeline.put_step(x, 16, 4, 4000, algo="sha256")
    assert sha256_cuda.sha256_rows.launches == before + 1
    on_cpu = pipeline.put_step(x.cpu(), 16, 4, 4000, algo="sha256")
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


def test_two_threads_launch_on_their_own_streams(dev):
    # each thread launches both kernels on its own stream at (r, k)
    # shapes no other test uses first: the first launch of a new shape
    # sets the function's shared-memory opt-in and the resident-block
    # cache, and two threads may be there at once
    import threading
    shapes = {0: [(7, 13), (9, 2)], 1: [(6, 11), (10, 5)]}
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def run(t):
        try:
            stream = torch.cuda.Stream(dev)
            barrier.wait()
            with torch.cuda.stream(stream):
                for r, k in shapes[t]:
                    m2 = _random_bits(r, k, 100 * r + k, dev)
                    x = _rand((3, k, 4099), r + k, dev)
                    rows = _rand((40, 1031), r * k, dev)
                    results[(t, r, k)] = (
                        m2, x, rows, rs_cuda.gf_matmul(m2, x),
                        highwayhash_cuda.hh256(rows, 1031, KEY))
            stream.synchronize()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    gf0 = rs_cuda.gf_matmul.launches
    hh0 = highwayhash_cuda.hh256.launches
    threads = [threading.Thread(target=run, args=(t,)) for t in shapes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    assert rs_cuda.gf_matmul.launches == gf0 + 4
    assert highwayhash_cuda.hh256.launches == hh0 + 4
    for m2, x, rows, gf, hh in results.values():
        assert torch.equal(gf, rs_cuda.gf_matmul_plain(m2, x))
        assert torch.equal(hh, highwayhash_cuda.hh256_plain(rows, 1031, KEY))


def test_pinned_buffer_recycled_only_after_its_copy(dev):
    # a copy queued behind a long kernel is still reading the pinned ring
    # buffer when it is returned: put() must wait for the copy's event
    from minio_tpu_torch.parallel import bpool
    pool = bpool.BytePool(64 << 20, 1, pinned=True)
    buf = pool.get()
    assert torch.from_numpy(buf).is_pinned()
    buf[:] = 7
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)         # ~0.1 s of device time
        out = torch.empty(buf.shape, dtype=torch.uint8, device=dev)
        out.copy_(torch.from_numpy(buf), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    bpool.after_copy(buf, done)
    assert not done.query()
    pool.put(buf)
    assert done.query()
    assert pool.get(timeout=1) is buf
    assert int(out.min()) == int(out.max()) == 7


def test_codec_dispatches_overlap_threads_and_agree(dev, monkeypatch):
    # concurrent fused dispatches through the codec's in-flight slots, on
    # pinned and pageable inputs, equal the CPU codec's outputs
    import threading
    from minio_tpu_torch.bitrot import BitrotAlgorithm
    from minio_tpu_torch.object import codec as codec_mod
    from minio_tpu_torch.parallel import bpool
    hh = BitrotAlgorithm.HIGHWAYHASH256S
    k, m, s = 12, 4, 4099
    monkeypatch.setattr(codec_mod, "DEVICE_MIN_BYTES", 0)
    card = codec_mod.Codec(k, m, k * s, device=dev)
    host = codec_mod.Codec(k, m, k * s, device="cpu")
    pool = bpool.BytePool(8 * k * s, 4, pinned=True)
    inputs = []
    for i in range(6):
        x = np.random.default_rng(i).integers(0, 256, (8, k, s),
                                              dtype=np.uint8)
        if i % 2:
            buf = pool.get().reshape(8, k, s)
            buf[:] = x
            x = buf
        inputs.append(x)
    outs, errors = [None] * len(inputs), []

    def run(i):
        try:
            outs[i] = card.encode_and_hash_batch(
                inputs[i] if i < 4 else [inputs[i][:3], inputs[i][3:]], hh)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors, errors
    for x, got in zip(inputs, outs):
        want = host.encode_and_hash_batch(np.ascontiguousarray(x), hh)
        assert (got[0] == want[0]).all() and (got[1] == want[1]).all()


def _cipher_words(b, p, seed, dev):
    rng = np.random.default_rng(seed)
    return (chacha20_cuda.words(rng.integers(0, 1 << 32, (b, 8),
                                             dtype=np.uint32), dev),
            chacha20_cuda.words(rng.integers(0, 1 << 32, (b, p, 3),
                                             dtype=np.uint32), dev))


def _check_chacha(data, keys, nonces, pkg_bytes, span=None):
    """Kernel == plain version (tolerance 0), into a new tensor and in
    place; bytes at or past the span stay as they were."""
    want = chacha20_plain.keystream_xor(data, keys, nonces, pkg_bytes, span)
    before = chacha20_cuda.keystream_xor.launches
    got = chacha20_cuda.keystream_xor(data, keys, nonces, pkg_bytes, span)
    torch.cuda.synchronize()
    assert chacha20_cuda.keystream_xor.launches == before + 1
    assert torch.equal(got, want)
    inplace = data.clone()
    chacha20_cuda.keystream_xor(inplace, keys, nonces, pkg_bytes, span,
                                out=inplace)
    torch.cuda.synchronize()
    assert torch.equal(inplace, want)


def test_chacha20_rfc8439_vector(dev):
    # §2.4.2: the sunscreen plaintext, 114 bytes in one 128-byte package
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer "
          b"you only one tip for the future, sunscreen would be it.")
    nonce = bytes.fromhex("000000000000004a00000000")
    got = chacha20_cuda.keystream_xor(
        torch.frombuffer(bytearray(pt), dtype=torch.uint8)[None].to(dev),
        chacha20_cuda.words(np.frombuffer(bytes(range(32)), "<u4")[None],
                            dev),
        chacha20_cuda.words(np.frombuffer(nonce, "<u4")[None, None], dev),
        128)
    assert got.cpu().numpy().tobytes() == chacha20_ref.xor_stream(
        pt, bytes(range(32)), nonce)


@pytest.mark.parametrize("pkg_bytes", [64, 4096, 65536])
@pytest.mark.parametrize("p", [1, 2, 16])
def test_chacha20_kernel_equals_plain(dev, pkg_bytes, p):
    data = _rand((3, p * pkg_bytes + 40), pkg_bytes + p, dev)
    keys, nonces = _cipher_words(3, p, p, dev)
    _check_chacha(data, keys, nonces, pkg_bytes)
    # spans shorter than the row, a multiple of 64 and not
    for span in (p * pkg_bytes - 64, p * pkg_bytes - 1, 1):
        if span > 0:
            _check_chacha(data, keys, nonces, pkg_bytes, span)


@pytest.mark.parametrize("stride", [1048584, 1048580, 1048577, 4194312])
def test_chacha20_put_rows_at_every_alignment(dev, stride):
    # the PUT's flat (B, k*S) rows: k*S = 1,048,584 (1 MiB blocks at 12+4)
    # and 4,194,312 (4 MiB) start on 8-byte boundaries; 4- and 1-byte
    # strides too; the plaintext span is the block
    span = 4 << 20 if stride > 4 << 20 else 1 << 20
    data = _rand((8 if stride < 4 << 20 else 2, stride), stride, dev)
    keys, nonces = _cipher_words(data.shape[0], span // 65536, stride, dev)
    _check_chacha(data, keys, nonces, 65536, span)


@pytest.mark.parametrize("base", [1, 4, 8])
def test_chacha20_offset_views(dev, base):
    flat = _rand((base + 3 * 8192,), base, dev)
    view = flat[base:].view(3, 8192)
    keys, nonces = _cipher_words(3, 2, base, dev)
    _check_chacha(view, keys, nonces, 4096)
    _check_chacha(view, keys, nonces, 4096, 5000)


def test_chacha20_get_batch(dev):
    # GET's decipher batch: 64 packages of 65,536 B, and a short last
    # package zero-padded to a 64-byte multiple
    keys, nonces = _cipher_words(64, 1, 64, dev)
    rows = _rand((64, 65536), 1, dev)
    for width in (65536, 1024):
        r = rows[:, :width].contiguous()
        r[-1, width - 50:] = 0
        got = chacha20_cuda.xor_packages(r, keys, nonces[:, 0])
        assert torch.equal(got, chacha20_plain.keystream_xor(
            r, keys, nonces, width))


@pytest.mark.parametrize("n_rows,length,span", [(3, 129, 100), (2, 65536,
                                                                 65536),
                                                (8, 1048584, 1 << 20)])
def test_chacha20_touches_only_its_tensors(dev, n_rows, length, span):
    # input and output at each end of a mapping between unmapped ranges: a
    # load or store outside the rows stops the kernel
    n = n_rows * length
    keys, nonces = _cipher_words(n_rows, -(-span // 64), length, dev)
    src = _rand((n_rows, length), length, dev)
    want = chacha20_plain.keystream_xor(src, keys, nonces, 64, span)
    with guard_pages.guarded(n, dev) as a, \
            guard_pages.guarded(n, dev) as b:
        for x in (a[:n], a[-n:]):
            x = x.view(n_rows, length)
            x.copy_(src)
            for out in (b[:n], b[-n:]):
                out = out.view(n_rows, length)
                out.copy_(src)
                chacha20_cuda.keystream_xor(x, keys, nonces, 64, span,
                                            out=out)
                torch.cuda.synchronize()
                assert torch.equal(out, want)
            chacha20_cuda.keystream_xor(x, keys, nonces, 64, span, out=x)
            torch.cuda.synchronize()
            assert torch.equal(x, want)


# four 8 KiB tiles of the kernel and a fifth cut mid-tile and mid-block
# (% 64 = 37), in packages of 4,096 B
TILED_SPAN = 4 * 8192 + 4096 + 37


@pytest.mark.parametrize("in_off", range(16))
def test_chacha20_every_alignment_pair(dev, in_off):
    # input rows from byte in_off of a buffer, output rows from each byte
    # 0..15 of another; strides 5 and 11 bytes over the span, so each row
    # of a call sits at another (in, out) offset pair mod 16. Bytes of the
    # output buffer outside the spans stay as they were
    n_rows, span = 3, TILED_SPAN
    si, so = span + 5, span + 11
    p = -(-span // 4096)
    keys, nonces = _cipher_words(n_rows, p, in_off, dev)
    flat_in = _rand((16 + n_rows * si,), in_off, dev)
    x = flat_in[in_off:in_off + n_rows * si].view(n_rows, si)
    assert x.data_ptr() % 16 == (flat_in.data_ptr() + in_off) % 16
    want = chacha20_plain.keystream_xor(x, keys, nonces, 4096, span)
    for out_off in range(16):
        flat_out = _rand((16 + n_rows * so,), 100 + out_off, dev)
        before = flat_out.clone()
        out = flat_out[out_off:out_off + n_rows * so].view(n_rows, so)
        chacha20_cuda.keystream_xor(x, keys, nonces, 4096, span,
                                    out=out[:, :si])
        torch.cuda.synchronize()
        assert torch.equal(out[:, :span], want[:, :span]), out_off
        expect = before.clone()
        expect[out_off:out_off + n_rows * so].view(n_rows, so)[:, :span] = \
            want[:, :span]
        assert torch.equal(flat_out, expect), out_off


@pytest.mark.parametrize("off", [1, 3, 7, 13])
def test_chacha20_in_place_at_odd_offsets(dev, off):
    # in place from an odd byte, rows 7 bytes over the span: each row of
    # the call starts at another odd offset
    n_rows, span = 4, TILED_SPAN
    stride = span + 7
    keys, nonces = _cipher_words(n_rows, -(-span // 4096), off, dev)
    flat = _rand((16 + n_rows * stride,), off, dev)
    before = flat.clone()
    x = flat[off:off + n_rows * stride].view(n_rows, stride)
    want = chacha20_plain.keystream_xor(x, keys, nonces, 4096, span)
    chacha20_cuda.keystream_xor(x, keys, nonces, 4096, span, out=x)
    torch.cuda.synchronize()
    assert torch.equal(x, want)
    assert torch.equal(flat[:off], before[:off])
    assert torch.equal(flat[off + n_rows * stride:],
                       before[off + n_rows * stride:])


@pytest.mark.parametrize("n_rows,length", [(5, TILED_SPAN), (3, 100),
                                           (64, 65536 - 3)])
def test_chacha20_span_ends_at_a_guarded_page(dev, n_rows, length):
    # the span is the whole row, so the first row's first byte is the
    # mapping's first byte, or the last row's last byte is its last, with
    # unmapped address space beyond: input and output at each end of two
    # mappings (odd lengths: the other end sits mid-granule), out of place
    # and in place
    n = n_rows * length
    keys, nonces = _cipher_words(n_rows, -(-length // 4096), length, dev)
    src = _rand((n_rows, length), length, dev)
    want = chacha20_plain.keystream_xor(src, keys, nonces, 4096)
    with guard_pages.guarded(n, dev) as a, \
            guard_pages.guarded(n, dev) as b:
        for x in (a[:n], a[-n:]):
            x = x.view(n_rows, length)
            x.copy_(src)
            for out in (b[:n], b[-n:]):
                out = out.view(n_rows, length)
                chacha20_cuda.keystream_xor(x, keys, nonces, 4096, out=out)
                torch.cuda.synchronize()
                assert torch.equal(out, want)
            chacha20_cuda.keystream_xor(x, keys, nonces, 4096, out=x)
            torch.cuda.synchronize()
            assert torch.equal(x, want)


def test_chacha20_rows_past_65535_in_one_launch(dev):
    # more rows than a grid's y dimension holds: rows sit on grid.x, so
    # one call is one launch
    keys, nonces = _cipher_words(70000, 1, 70000, dev)
    _check_chacha(_rand((70000, 100), 70000, dev), keys, nonces, 128)


def test_chacha20_longest_span_and_past_it(dev):
    # 65,535 tiles of 8 KiB are the longest span one launch takes. In
    # packages of one tile each (the counter restarts at 1 in each), the
    # first and last tiles equal the plain version of their package alone;
    # a span one block longer is refused before any launch
    tile, tiles = 8192, 65535
    data = _rand((1, tiles * tile + 64), 5, dev)
    keys, nonces = _cipher_words(1, tiles + 1, 6, dev)
    got = chacha20_cuda.keystream_xor(data, keys, nonces, tile,
                                      tiles * tile)
    torch.cuda.synchronize()
    for t in (0, tiles - 1):
        part = data[:, t * tile:(t + 1) * tile].contiguous()
        assert torch.equal(got[:, t * tile:(t + 1) * tile],
                           chacha20_plain.keystream_xor(
                               part, keys, nonces[:, t:t + 1], tile))
    assert torch.equal(got[:, tiles * tile:], data[:, tiles * tile:])
    before = chacha20_cuda.keystream_xor.launches
    with pytest.raises(RuntimeError, match="chacha20 launch"):
        chacha20_cuda.keystream_xor(data, keys, nonces, tile)
    assert chacha20_cuda.keystream_xor.launches == before


def test_sse_steps_on_card_equal_cpu(dev):
    k, m, s = 12, 4, 87382                  # 1 MiB blocks at 12+4
    b, p = 2, 16
    x = torch.zeros((b, k * s), dtype=torch.uint8, device=dev)
    x[:, :1 << 20] = _rand((b, 1 << 20), 9, dev)
    x = x.view(b, k, s)
    keys, nonces = _cipher_words(b, p, 9, dev)
    before = chacha20_cuda.keystream_xor.launches
    rows, dig = pipeline.sse_put_step(x, keys, nonces, k, m, 65536)
    assert chacha20_cuda.keystream_xor.launches == before + 1
    cpu_rows, cpu_dig = pipeline.sse_put_step(x.cpu(), keys.cpu(),
                                              nonces.cpu(), k, m, 65536)
    assert torch.equal(rows.cpu(), cpu_rows) and torch.equal(dig.cpu(),
                                                             cpu_dig)
    mask = sum(1 << i for i in range(k + m) if i not in (1, 5, 14))
    dm, used, missing = rs_matrix.missing_data_matrix(k, m, mask)
    surv = rows[:, list(used)].contiguous()
    data_src = tuple((0, used.index(j)) if j in used
                     else (1, missing.index(j)) for j in range(k))
    bits = rs_cuda.matrix_bits(dm, dev)
    got = pipeline.sse_get_step(surv, bits, keys, nonces, dm.shape[0], k,
                                data_src, 65536, s)
    want = pipeline.sse_get_step(surv.cpu(), bits.cpu(), keys.cpu(),
                                 nonces.cpu(), dm.shape[0], k, data_src,
                                 65536, s)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[0], x)



def _server_on_card(tmp_path, monkeypatch):
    """The port's server over a small set on the card (16 drives at 12+4,
    1 MiB blocks), a bucket made; (node, signed client)."""
    from minio_tpu_torch.s3.client import S3Client
    from minio_tpu_torch import cluster
    from minio_tpu_torch.s3.credentials import Credentials
    monkeypatch.setenv("MINIO_SSE_MASTER_KEY", "5a" * 32)
    monkeypatch.setenv("MINIO_TPU_SSE_CIPHER", "chacha20")
    creds = Credentials("cudaadminkey", "cudaadminsecretkey")
    node = cluster.start_single([str(tmp_path / "d{1...16}")], creds=creds,
                                parity=4, block_size=1 << 20)
    client = S3Client(node.s3.port, creds)
    assert client.send("PUT", "/cuda")[0] == 200
    return node, client


def test_server_put_and_degraded_get_launch_kernels(dev, tmp_path,
                                                    monkeypatch):
    """A PUT past the codec's 8 MiB gate runs put_step on the card; a GET
    with 3 drives' bucket gone runs get_step there; the bytes match."""
    import shutil
    node, c = _server_on_card(tmp_path, monkeypatch)
    try:
        data = np.random.default_rng(21).bytes((16 << 20) + 777)
        gf, hh = rs_cuda.gf_matmul.launches, highwayhash_cuda.hh256.launches
        st, h, _ = c.send("PUT", "/cuda/o", body=data)
        assert st == 200 and h["etag"] == f'"{hashlib.md5(data).hexdigest()}"'
        assert rs_cuda.gf_matmul.launches > gf
        assert highwayhash_cuda.hh256.launches > hh
        assert c.send("GET", "/cuda/o")[2] == data
        for i in (1, 2, 3):
            shutil.rmtree(tmp_path / f"d{i}" / "cuda")
        gf = rs_cuda.gf_matmul.launches
        assert c.send("GET", "/cuda/o")[2] == data
        assert rs_cuda.gf_matmul.launches > gf
    finally:
        node.shutdown()


def test_server_hedged_degraded_get_launches_kernels(dev, tmp_path,
                                                    monkeypatch):
    """A drive holding a data shard stalls every read 0.5 s: the GET's
    latency hedge races a parity read past it, the group missing that
    data shard is reconstructed by get_step on the card (gf_matmul and
    hh256 launches), the bytes match, and nothing is queued for heal."""
    from minio_tpu_torch.storage.naughty import NaughtyDisk
    from minio_tpu_torch.utils import telemetry
    monkeypatch.setenv("MINIO_TPU_HEDGE_CEIL_S", "0.1")
    node, c = _server_on_card(tmp_path, monkeypatch)
    try:
        data = np.random.default_rng(23).bytes(16 << 20)
        assert c.send("PUT", "/cuda/h", body=data)[0] == 200
        layer = node.object_layer
        pool = getattr(layer, "server_sets", [layer])[0]
        eng = pool.sets[0]
        slow = next(d for d in eng.disks
                    if d.read_version("cuda", "h").erasure.index <= 12)
        inner = slow.inner
        nd = NaughtyDisk(inner, enabled=True)
        nd.stall_verbs = {"read_file_stream": 0.5, "read_file": 0.5}
        hedged = telemetry.REGISTRY.counter("minio_tpu_hedged_reads_total")
        before = hedged.value(trigger="latency")
        gf, hh = rs_cuda.gf_matmul.launches, highwayhash_cuda.hh256.launches
        slow.inner = nd
        try:
            assert c.send("GET", "/cuda/h")[2] == data
        finally:
            slow.inner = inner
        assert nd.stats.stalls >= 1
        assert hedged.value(trigger="latency") > before
        assert rs_cuda.gf_matmul.launches > gf
        assert highwayhash_cuda.hh256.launches > hh
        assert pool.mrf_stats()["queued"] == 0
    finally:
        node.shutdown()


def test_server_sse_put_and_get_launch_chacha20(dev, tmp_path, monkeypatch):
    """An SSE-S3 PUT takes the fused cipher+encode step on the card and
    its GET deciphers there, whole and in a range."""
    node, c = _server_on_card(tmp_path, monkeypatch)
    try:
        data = np.random.default_rng(22).bytes((16 << 20) + 5)
        sse = {"x-amz-server-side-encryption": "AES256"}
        cc = chacha20_cuda.keystream_xor.launches
        st, h, _ = c.send("PUT", "/cuda/e", body=data, headers=sse)
        assert st == 200 and h["x-amz-server-side-encryption"] == "AES256"
        assert chacha20_cuda.keystream_xor.launches > cc
        cc = chacha20_cuda.keystream_xor.launches
        assert c.send("GET", "/cuda/e")[2] == data
        st, _, got = c.send("GET", "/cuda/e",
                               headers={"range": "bytes=70000-4200000"})
        assert st == 206 and got == data[70000:4200001]
        assert chacha20_cuda.keystream_xor.launches > cc
    finally:
        node.shutdown()


# -- scan_eval: the Select predicate interpreter ----------------------------

def _pages_on(arrays, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def _scan_equal(program, arrs):
    before = scan_cuda.scan_eval.launches
    mask, counts = scan_cuda.scan_eval(program, **arrs)
    assert scan_cuda.scan_eval.launches == before + 1
    pm, pc = scan_plain.scan_eval(program.prog, program.cspec, **arrs)
    assert torch.equal(mask, pm)
    assert torch.equal(counts, pc)


@pytest.mark.parametrize("fmt", ["CSV", "JSON"])
@pytest.mark.parametrize("width", [0, 12, 30, 60, 100])
def test_scan_eval_equals_plain_every_width(dev, fmt, width):
    # the generator's queries with literals longer than the page width,
    # over corpora with nan / inf / -0 / 1e400 cells
    for _e, program, pages, _q, _r in scan_cases.page_cases(
            fmt, width, 100 + width, 30):
        _scan_equal(program, _pages_on(pages.arrays, dev))


@pytest.mark.parametrize("B", [1, 3, 64, 254])
def test_scan_eval_batches_with_a_ragged_last_page(dev, B):
    for _e, program, pages, _q, _r in scan_cases.page_cases(
            "CSV", 30, 7, 6, rows=2500):
        arrays = scan_cases.tile_pages(pages.arrays, B, 1234)
        _scan_equal(program, _pages_on(arrays, dev))


def test_scan_eval_packed_pages(dev):
    # the former's batch: packed pages of two requests, typed views
    cases = scan_cases.page_cases("JSON", 60, 9, 8, rows=2100)
    for _e, program, pages, _q, _r in cases:
        packed = np.concatenate([scan_cuda.pack_pages(pages.arrays)] * 2)
        R, C, W = pages.shape_key()
        views = scan_cuda.unpack(torch.from_numpy(packed).to(dev), R, C, W)
        _scan_equal(program, views)


def test_scan_eval_rounds_like_the_evaluator(dev):
    # (a * 3) + 1 contracted into one FMA would round once and miss
    from minio_tpu_torch.scan import ScanEngine
    from minio_tpu_torch.s3select.select import event_stream, run_select
    data, expr = scan_cases.fma_case()
    req = scan_cases.request(expr)
    assert list(run_select(req, data)) == [b"1\n"]
    eng = ScanEngine(device=dev)
    assert b"".join(eng.event_stream(req, data)) == \
        b"".join(event_stream(req, data))
    assert eng.device_serves == 1


def test_scan_plain_fmod_is_exact_on_the_card(dev):
    # the plain version's fmod builds its powers of two from exponent bits:
    # torch.pow on the card is not exact at 2**700
    rng = np.random.default_rng(3)
    a = np.concatenate([[1e308, -1e308, 1e-320, 7.0, 1.7976931348623157e308],
                        10.0 ** rng.uniform(-300, 300, 400)])
    b = np.concatenate([[2.5, 3.0, 2.5, 2.5, 1e-300],
                        10.0 ** rng.uniform(-300, 300, 400)])
    got = scan_plain._fmod(torch.from_numpy(a).to(dev),
                           torch.from_numpy(b).to(dev)).cpu().numpy()
    assert np.array_equal(got, np.fmod(a, b))


@pytest.mark.parametrize("width", [0, 60, 100])
def test_scan_eval_touches_only_its_tensors(dev, width):
    # packed pages, mask and counts at each end of a mapping between
    # unmapped ranges: a read past the last page or a store past the mask
    # or the counts stops the kernel with an illegal-address error
    for _e, program, pages, _q, _r in scan_cases.page_cases(
            "CSV", width, 31 + width, 6, rows=2100):
        packed = scan_cuda.pack_pages(pages.arrays)
        B, P = packed.shape
        R, C, W = pages.shape_key()
        k = len(program.cspec)
        want = scan_plain.scan_eval(program.prog, program.cspec,
                                    **_pages_on(pages.arrays, dev))
        with guard_pages.guarded(packed.nbytes, dev) as src, \
                guard_pages.guarded(B * R + 4 * B * k + 4, dev) as dst:
            for x in (src[:packed.nbytes], src[-packed.nbytes:]):
                x.copy_(torch.from_numpy(packed.reshape(-1)))
                v = scan_cuda.unpack(x.view(B, P), R, C, W)
                for end in (0, 1):
                    n = B * R + 4 * B * k
                    out = dst[:n] if end == 0 else dst[-n:]
                    counts = out[:4 * B * k].view(torch.int32).view(B, k)
                    mask = out[4 * B * k:].view(B, R)
                    before = scan_cuda.scan_eval.launches
                    scan_cuda.scan_eval(program, mask=mask, counts=counts,
                                        **v)
                    torch.cuda.synchronize()
                    assert scan_cuda.scan_eval.launches == before + 1
                    assert torch.equal(mask, want[0])
                    assert torch.equal(counts, want[1])


def test_scan_eval_programs_past_shared_memory(dev):
    # IN lists of long literals whose blob is past a block's 48 KB of
    # shared memory: the kernel reads the program where it lies
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan import pager
    from minio_tpu_torch.scan.plan import compile_plan
    rng = random.Random(8)
    data = scan_cases.csv_corpus(rng, 300, edge=True, width=60)
    rows = scan_cases.rows_of(data, "CSV")
    for n in (100, 1500):
        items = ", ".join(f"'{'w' * 60}{i}'" for i in range(n))
        q = sql.parse(f"SELECT COUNT(*), COUNT(b) FROM S3Object WHERE "
                      f"a IN ({items}, 25, 'x') OR b NOT IN ({items})")
        plan = compile_plan(q, "CSV")
        program = scan_program.program_for(plan)
        assert (program.blob.nbytes > 48 * 1024) == (n == 1500)
        pages = pager.build_pages(rows, plan)
        _scan_equal(program, _pages_on(pages.arrays, dev))


def test_scan_eval_more_pages_than_grid_y(dev):
    # 70,000 pages of 32 rows: more than the grid's 65,535 in y, so a
    # block strides over pages, each page's counts its own
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan.plan import compile_plan
    plan = compile_plan(sql.parse(
        "SELECT COUNT(*), COUNT(a) FROM S3Object WHERE a > 3 OR a = 'x'"),
        "CSV")
    program = scan_program.program_for(plan)
    B, R, W = 70_000, 32, 8
    g = torch.Generator().manual_seed(4)
    num = torch.randint(0, 8, (B, R, 1), generator=g).double()
    arrs = {"num": num, "ok": torch.rand(B, R, 1, generator=g) < 0.9,
            "null": torch.rand(B, R, 1, generator=g) < 0.1,
            "sb": torch.randint(0, 256, (B, R, 1, W), generator=g,
                                dtype=torch.uint8),
            "slen": torch.full((B, R, 1), 8, dtype=torch.int32),
            "rowvalid": torch.rand(B, R, generator=g) < 0.95}
    _scan_equal(program, {k: v.to(dev) for k, v in arrs.items()})


def test_server_select_launches_scan_eval(dev, tmp_path, monkeypatch):
    """A Select over HTTP on the card: its rows are decided by scan_eval
    (one launch through the former), and the framed stream is the
    evaluator's."""
    from minio_tpu_torch.s3select.select import event_stream
    node, c = _server_on_card(tmp_path, monkeypatch)
    try:
        data = scan_cases.lineitem_csv(5000, 3)
        assert c.send("PUT", "/cuda/l.csv", body=data)[0] == 200
        before = scan_cuda.scan_eval.launches
        for expr in (scan_cases.Q6_COUNT, scan_cases.Q6_ROWS):
            st, _, body = c.send(
                "POST", "/cuda/l.csv", query={"select": "",
                                              "select-type": "2"},
                body=scan_cases.select_xml(expr))
            assert st == 200
            assert body == b"".join(event_stream(
                scan_cases.request(expr), data))
        assert scan_cuda.scan_eval.launches == before + 2
        assert node.s3.api.scan.device_serves == 2
    finally:
        node.shutdown()


def _lineitem_pages(expr: str, n_rows: int = 3000, seed: int = 5):
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan import pager
    from minio_tpu_torch.scan.plan import compile_plan
    rows = scan_cases.rows_of(scan_cases.lineitem_csv(n_rows, seed), "CSV")
    plan = compile_plan(sql.parse(expr), "CSV")
    return scan_program.program_for(plan), pager.build_pages(rows, plan)


@pytest.mark.parametrize("R", [1, 3, 1000, 1023, 1025, 2047])
def test_scan_eval_rows_not_a_multiple_of_the_tile(dev, R):
    # pages of R rows (the tile is up to kRows x kThreads = 1024 rows), a
    # ragged last page, packed and as separate arrays
    for expr in (scan_cases.Q6_COUNT, scan_cases.LIKE_QUERY,
                 "SELECT COUNT(*), COUNT(l_tax) FROM S3Object WHERE "
                 "((l_quantity + 1) / (l_tax - 0.02)) < (l_linenumber % 3)"
                 " OR l_returnflag = l_linestatus"):
        program, pages = _lineitem_pages(expr)
        arrays = {k: np.ascontiguousarray(v[:, :R])
                  for k, v in pages.arrays.items()}
        arrays = scan_cases.tile_pages(arrays, 5, max(1, R // 2))
        _scan_equal(program, _pages_on(arrays, dev))
        packed = scan_cuda.pack_pages(arrays)
        _B, _R, C, W = arrays["sb"].shape
        _scan_equal(program, scan_cuda.unpack(
            torch.from_numpy(packed).to(dev), R, C, W))


@pytest.mark.parametrize("width,want", [(0, 8), (100, 128)])
def test_scan_eval_narrowest_and_widest_pages(dev, width, want):
    # W = 8 (8-byte cell pieces where only some slots are staged) and the
    # widest width the pager makes (scan/pager._WIDTHS)
    from minio_tpu_torch.scan import pager
    assert pager._WIDTHS[-1] == 128
    n = 0
    for _e, program, pages, _q, _r in scan_cases.page_cases(
            "CSV", width, 61 + width, 30, rows=1500):
        _scan_equal(program, _pages_on(pages.arrays, dev))
        n += pages.width == want
    # (a query that reads no column pages one narrow placeholder slot)
    assert n >= 15


def test_scan_eval_blob_past_the_budget_beside_the_tiles(dev):
    # a blob under the two-block budget that with two stages of kThreads
    # rows of every array passes it: the blob is read from global memory
    # (tests/test_torch_scan_tiles.py restates that choice)
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan import pager
    from minio_tpu_torch.scan.plan import compile_plan
    rows = scan_cases.rows_of(scan_cases.lineitem_csv(3000, 9), "CSV")
    items = ", ".join(f"'{'s' * 60}{i}'" for i in range(600))
    q = sql.parse(f"SELECT COUNT(*), COUNT(l_discount) FROM S3Object "
                  f"WHERE l_shipdate IN ({items}, '1994-02-03') OR "
                  f"l_discount BETWEEN 0.05 AND 0.07 OR l_quantity < 3")
    plan = compile_plan(q, "CSV")
    program = scan_program.program_for(plan)
    assert 60_000 < program.blob.nbytes < 100_000
    pages = pager.build_pages(rows, plan)
    assert pages.shape_key()[1:] == (3, 16)
    _scan_equal(program, _pages_on(pages.arrays, dev))


@pytest.mark.parametrize("W", [16, 64])
def test_scan_eval_contains_like_at_every_offset(dev, W):
    # the needle at every offset of the cell, the last one included, cut
    # by the cell's length, absent, or only its first byte present
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan.plan import compile_plan
    rng = np.random.default_rng(W)
    needle = b"fur"
    L = len(needle)
    cells = []
    for off in range(W - L + 1):
        for s in (off + L, W, off + L - 1):
            raw = bytearray(rng.integers(97, 102, W, dtype=np.uint8))
            raw[off:off + L] = needle
            raw[s:] = bytes(W - s)
            cells.append((bytes(raw), s))
    cells.append((b"f" * W, W))
    cells.append((b"fu" * (W // 2), W))
    R = len(cells)
    plan = compile_plan(sql.parse(
        "SELECT COUNT(*) FROM S3Object WHERE a LIKE '%fur%'"), "CSV")
    program = scan_program.program_for(plan)
    sb = np.frombuffer(b"".join(c for c, _ in cells),
                       np.uint8).reshape(1, R, 1, W).copy()
    arrays = {"num": np.zeros((1, R, 1)), "ok": np.zeros((1, R, 1), bool),
              "null": np.zeros((1, R, 1), bool), "sb": sb,
              "slen": np.array([s for _, s in cells],
                               np.int32).reshape(1, R, 1),
              "rowvalid": np.ones((1, R), bool)}
    _scan_equal(program, _pages_on(arrays, dev))


@pytest.mark.parametrize("expr", [
    "SELECT COUNT(*) FROM S3Object WHERE a > 3 AND (n * 2) < 50",
    "SELECT COUNT(*) FROM S3Object WHERE a < 'x' OR b >= 'P'",
    "SELECT COUNT(*) FROM S3Object WHERE a LIKE 'x%' OR b LIKE '%z'",
    "SELECT COUNT(a), COUNT(*) FROM S3Object"])
def test_scan_eval_each_read_set(dev, expr):
    # numbers only, strings only, LIKE only, COUNT(col) only: each stages
    # its own arrays, over cells that parse, do not, and are null
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan import pager
    from minio_tpu_torch.scan.plan import compile_plan
    rng = random.Random(17)
    data = "a,b,n\n" + "".join(
        f"{rng.choice(['1', '7', '-3', 'x', 'Par', '', 'zz', '2.5'])},"
        f"{rng.choice(['30', 'P', '', 'xz', '9', 'abz'])},"
        f"{rng.choice(['1', '30', '-2', '7.5'])}\n"
        for _ in range(2500))
    rows = scan_cases.rows_of(data.encode(), "CSV")
    plan = compile_plan(sql.parse(expr), "CSV")
    program = scan_program.program_for(plan)
    pages = pager.build_pages(rows, plan)
    _scan_equal(program, _pages_on(pages.arrays, dev))


@pytest.mark.parametrize("C", [40, 43, 64])
def test_scan_eval_wide_numeric_where(dev, C):
    # a numeric-only WHERE over 40 or more slots: tiles of fewer rows than
    # a block has threads, the blob in global memory; the threads past a
    # tile's rows read only its staged cells
    from minio_tpu_torch.s3select import sql
    from minio_tpu_torch.scan import pager
    from minio_tpu_torch.scan.plan import compile_plan
    data, expr = scan_cases.wide_numeric_case(C, 3000, C)
    plan = compile_plan(sql.parse(expr), "CSV")
    program = scan_program.program_for(plan)
    pages = pager.build_pages(scan_cases.rows_of(data, "CSV"), plan)
    assert pages.shape_key()[1] == C
    _scan_equal(program, _pages_on(pages.arrays, dev))
    R, C, W = pages.shape_key()
    _scan_equal(program, scan_cuda.unpack(torch.from_numpy(
        scan_cuda.pack_pages(pages.arrays)).to(dev), R, C, W))


def test_scan_eval_count_star_over_many_tiles_a_block(dev):
    # COUNT(*) with no WHERE stages rowvalid alone: 1,501 pages (about
    # eleven tiles a block), a ragged last page, the counts met per page
    program, pages = _lineitem_pages("SELECT COUNT(*) FROM S3Object")
    arrays = scan_cases.tile_pages(pages.arrays, 1501, 777)
    _scan_equal(program, _pages_on(arrays, dev))
