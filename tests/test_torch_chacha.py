"""The port's ChaCha20: its host copy (minio_tpu_torch/ops/chacha20_ref.py)
against the RFC 8439 vectors (copied from tests/test_chacha.py) and
minio_tpu's host cipher, and the plain PyTorch keystream
(ops/chacha20_plain.py, the CPU path of ops/chacha20_cuda) against
minio_tpu's device program (ops/chacha20_jax keystream_u8, keystream_xor,
xor_packages, on the JAX CPU backend) at P in {1, 3} packages of 64 and
4,096 bytes, and with a span shorter than the row. Inputs come from numpy
seeds; tolerance 0 (bytes) throughout."""

import numpy as np
import pytest
import torch

from minio_tpu.ops import chacha20_jax as ref_jax
from minio_tpu.ops import chacha20_ref as ref_c20
from minio_tpu_torch.ops import chacha20_cuda, chacha20_plain
from minio_tpu_torch.ops import chacha20_ref as c20

RFC_KEY = bytes(range(32))
SUNSCREEN = (b"Ladies and Gentlemen of the class of '99: If I could "
             b"offer you only one tip for the future, sunscreen would "
             b"be it.")


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def _xor(data, keys, nonces, pkg_bytes, span=None):
    """The wrapper on CPU tensors (the plain version) -> numpy."""
    return chacha20_cuda.keystream_xor(
        torch.from_numpy(data.copy()), chacha20_cuda.words(keys, "cpu"),
        chacha20_cuda.words(nonces, "cpu"), pkg_bytes, span).numpy()


# -- RFC 8439 vectors on the host copy ----------------------------------------

def test_rfc8439_block_function():
    # §2.3.2: ChaCha20 block, counter 1
    out = c20._block_scalar(RFC_KEY, bytes.fromhex("000000090000004a00000000"),
                            1)
    assert out[:16] == bytes.fromhex("10f1e7e4d13b5915500fdd1fa32071c4")
    assert out[-16:] == bytes.fromhex("b5129cd1de164eb9cbd083e8a2503c4e")


def test_rfc8439_encryption():
    # §2.4.2: the sunscreen plaintext, counter 1
    nonce = bytes.fromhex("000000000000004a00000000")
    ct = c20.xor_stream(SUNSCREEN, RFC_KEY, nonce, counter=1)
    assert ct[:16] == bytes.fromhex("6e2e359a2568f98041ba0728dd0d6981")
    assert ct[-10:] == bytes.fromhex("b40b8eedf2785e42874d")
    assert c20.xor_stream(ct, RFC_KEY, nonce, counter=1) == SUNSCREEN


def test_rfc8439_poly1305_mac_and_key_gen():
    # §2.5.2 and §2.6.2
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a8"
                        "0103808afb0db2fd4abff6af4149f51b")
    assert c20.poly1305_mac(b"Cryptographic Forum Research Group", key) == \
        bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")
    otk = c20.poly1305_key_gen(bytes(range(0x80, 0xA0)),
                               bytes.fromhex("000000000001020304050607"))
    assert otk == bytes.fromhex("8ad5a08b905f81cc815040274ab29471"
                                "a833b637e3fd0da508dbb8e2fdd1a646")


def test_rfc8439_aead_seal_and_open():
    # §2.8.2 in detached form; a wrong tag or a flipped ciphertext byte is
    # refused before anything is deciphered
    key = bytes(range(0x80, 0xA0))
    nonce = bytes.fromhex("070000004041424344454647")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    ct, tag = c20.seal_detached(key, nonce, aad, SUNSCREEN)
    assert ct[:16] == bytes.fromhex("d31a8d34648e60db7b86afbc53ef7ec2")
    assert tag == bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")
    assert c20.open_detached(key, nonce, aad, ct, tag) == SUNSCREEN
    with pytest.raises(ValueError):
        c20.open_detached(key, nonce, aad, ct, bytes(16))
    with pytest.raises(ValueError):
        c20.open_detached(key, nonce, aad, ct[:-1] + bytes([ct[-1] ^ 1]),
                          tag)


@pytest.mark.parametrize("seed", range(4))
def test_host_copy_equals_reference(seed):
    rng = np.random.default_rng(seed)
    key, nonce, aad = rng.bytes(32), rng.bytes(12), rng.bytes(seed * 7)
    ctr, nblk = int(rng.integers(0, 5)), int(rng.integers(1, 9))
    assert c20.keystream(key, nonce, ctr, nblk).tobytes() == \
        ref_c20.keystream(key, nonce, ctr, nblk).tobytes() == \
        b"".join(ref_c20._block_scalar(key, nonce, ctr + i)
                 for i in range(nblk))
    pt = rng.bytes(int(rng.integers(0, 3000)))
    assert c20.seal_detached(key, nonce, aad, pt) == \
        ref_c20.seal_detached(key, nonce, aad, pt)


# -- the plain keystream against minio_tpu's device program -------------------

def test_plain_rfc8439_encryption_vector():
    # §2.4.2 through the wrapper: one row of 114 bytes, one 128-byte package
    keys = np.frombuffer(RFC_KEY, "<u4")[None]
    nonces = np.frombuffer(bytes.fromhex("000000000000004a00000000"),
                           "<u4")[None, None]
    data = np.frombuffer(SUNSCREEN, np.uint8)[None]
    got = _xor(data, keys, nonces, 128)
    assert got.tobytes() == c20.xor_stream(
        SUNSCREEN, RFC_KEY, bytes.fromhex("000000000000004a00000000"))


@pytest.mark.parametrize("pkg_bytes", [64, 4096])
@pytest.mark.parametrize("p", [1, 3])
def test_plain_keystream_equals_jax(pkg_bytes, p):
    rng = np.random.default_rng(pkg_bytes + p)
    b = 3
    keys, nonces = _words(rng, (b, 8)), _words(rng, (b, p, 3))
    length = p * pkg_bytes
    want_ks = np.asarray(ref_jax.keystream_u8(keys, nonces, length,
                                              pkg_bytes))
    got_ks = chacha20_plain.keystream(
        chacha20_cuda.words(keys, "cpu"), chacha20_cuda.words(nonces, "cpu"),
        length, pkg_bytes).numpy()
    assert np.array_equal(got_ks, want_ks)
    data = rng.integers(0, 256, (b, length), dtype=np.uint8)
    want = np.asarray(ref_jax.keystream_xor(data, keys, nonces, pkg_bytes))
    assert np.array_equal(_xor(data, keys, nonces, pkg_bytes), want)
    # XOR: the same call deciphers
    assert np.array_equal(_xor(want, keys, nonces, pkg_bytes), data)


@pytest.mark.parametrize("pkg_bytes,p,span", [(64, 3, 150), (4096, 3, 9000),
                                              (4096, 1, 4096)])
def test_plain_span_shorter_than_row(pkg_bytes, p, span):
    # rows longer than the span (the flat k*S view past the plaintext
    # block): bytes at or past the span come back as they went in, and the
    # bytes before it match the JAX program over the full packages
    rng = np.random.default_rng(span)
    b = 2
    keys, nonces = _words(rng, (b, 8)), _words(rng, (b, p, 3))
    data = rng.integers(0, 256, (b, p * pkg_bytes + 40), dtype=np.uint8)
    got = _xor(data, keys, nonces, pkg_bytes, span)
    full = np.asarray(ref_jax.keystream_xor(
        np.ascontiguousarray(data[:, :p * pkg_bytes]), keys, nonces,
        pkg_bytes))
    assert np.array_equal(got[:, :span], full[:, :span])
    assert np.array_equal(got[:, span:], data[:, span:])


def test_plain_in_place_writes_only_the_span():
    rng = np.random.default_rng(5)
    keys, nonces = _words(rng, (2, 8)), _words(rng, (2, 2, 3))
    t = torch.from_numpy(rng.integers(0, 256, (2, 300), dtype=np.uint8))
    before = t.clone()
    out = chacha20_cuda.keystream_xor(t, chacha20_cuda.words(keys, "cpu"),
                                      chacha20_cuda.words(nonces, "cpu"),
                                      128, 200, out=t)
    assert out is t
    assert torch.equal(t[:, 200:], before[:, 200:])
    assert not torch.equal(t[:, :200], before[:, :200])
    assert np.array_equal(t.numpy(), _xor(before.numpy(), keys, nonces, 128,
                                          200))


def test_plain_xor_packages_equals_jax():
    # GET's decipher batch: one package a row, the last one short and
    # zero-padded to a 64-byte multiple
    rng = np.random.default_rng(6)
    n, width = 5, 4096
    rows = rng.integers(0, 256, (n, width), dtype=np.uint8)
    rows[-1, 1000:] = 0
    keys = np.broadcast_to(_words(rng, (8,)), (n, 8)).copy()
    nonces = _words(rng, (n, 3))
    want = ref_jax.xor_packages(rows, keys, nonces)
    got = chacha20_cuda.xor_packages(torch.from_numpy(rows),
                                     chacha20_cuda.words(keys, "cpu"),
                                     chacha20_cuda.words(nonces, "cpu"))
    assert np.array_equal(got.numpy(), want)


def test_int64_and_int32_words_agree():
    rng = np.random.default_rng(7)
    keys, nonces = _words(rng, (2, 8)), _words(rng, (2, 2, 3))
    data = torch.from_numpy(rng.integers(0, 256, (2, 128), dtype=np.uint8))
    a = chacha20_cuda.keystream_xor(data, chacha20_cuda.words(keys, "cpu"),
                                    chacha20_cuda.words(nonces, "cpu"), 64)
    b = chacha20_cuda.keystream_xor(
        data, torch.from_numpy(keys.astype(np.int64)),
        torch.from_numpy(nonces.astype(np.int64)), 64)
    assert torch.equal(a, b)


def test_cpu_route_launches_nothing_and_bad_arguments_raise():
    data = torch.zeros((2, 128), dtype=torch.uint8)
    keys = torch.zeros((2, 8), dtype=torch.int32)
    nonces = torch.zeros((2, 2, 3), dtype=torch.int32)
    before = chacha20_cuda.keystream_xor.launches
    chacha20_cuda.keystream_xor(data, keys, nonces, 64)
    assert chacha20_cuda.keystream_xor.launches == before
    bad = [
        (data.to(torch.int32), keys, nonces, 64, None),   # not uint8
        (data[0], keys, nonces, 64, None),                # not 2-D
        (data, keys, nonces, 63, None),                   # not 64-aligned
        (data, keys[:1], nonces, 64, None),               # key rows
        (data, keys, nonces[:, :, :2], 64, None),         # nonce words
        (data, keys.to(torch.float32), nonces, 64, None),  # word type
        (data, keys, nonces, 64, 129),                    # span > row
        (data, keys, nonces[:, :1], 64, 65),              # span > P*pkg
    ]
    for args in bad:
        with pytest.raises(ValueError):
            chacha20_cuda.keystream_xor(*args)
    with pytest.raises(ValueError):
        chacha20_cuda.keystream_xor(data.to("meta"), keys.to("meta"),
                                    nonces.to("meta"), 64)


def test_words_keep_bit_patterns():
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = chacha20_cuda.words(w, "cpu")
    assert t.dtype == torch.int32
    assert t.numpy().view(np.uint32).tolist() == w.tolist()
