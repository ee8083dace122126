"""The fused device steps of the erasure data path.

Counterpart of minio_tpu/models/pipeline.py:114-153 (put_step),
:156-240 (sse_put_step, sse_get_step) and :243-326 (get_step,
heal_step): the same signatures, shapes and return order, as launch
sequences on the current CUDA stream — the GF(2^8) kernel
(ops/rs_cuda.gf_matmul) followed by one hash launch over the rows whose
digests are returned: HighwayHash-256 (ops/highwayhash_cuda.hh256) or,
for the sha256 bitrot algorithm, SHA-256 (ops/sha256_cuda.sha256_rows).
The SSE steps add one ChaCha20 launch (ops/chacha20_cuda.keystream_xor)
before the encode or after the decode. On CPU tensors the kernels run
their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import (chacha20_cuda, highwayhash_cuda, rs_cuda, rs_matrix,
                   sha256_cuda)
from ..storage.datatypes import ErasureInfo


@dataclasses.dataclass(frozen=True)
class ECConfig:
    """Erasure-set geometry: k data + m parity shards over block_size-byte
    blocks. Placement math delegates to storage.datatypes.ErasureInfo
    (cmd/erasure-coding.go:120-143)."""
    data_shards: int
    parity_shards: int
    block_size: int = 1 << 20

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    def _erasure_info(self) -> ErasureInfo:
        return ErasureInfo(data_blocks=self.data_shards,
                           parity_blocks=self.parity_shards,
                           block_size=self.block_size)

    @property
    def shard_size(self) -> int:
        """Per-shard bytes of one full block (ceil division, zero-padded)."""
        return self._erasure_info().shard_size()

    def shard_file_size(self, total_length: int) -> int:
        return self._erasure_info().shard_file_size(total_length)


def _hash_rows(rows: torch.Tensor, shard_len: int, key: bytes,
               algo: str) -> torch.Tensor:
    """(N, S) rows -> (N, 32) bitrot digests over the first shard_len
    bytes, on the rows' device (shared by put/get/heal steps)."""
    from ..bitrot import MAGIC_HIGHWAYHASH_KEY
    if algo == "sha256":
        return sha256_cuda.sha256_rows(rows, shard_len)
    if algo != "highwayhash":
        raise ValueError(f"unknown device bitrot algorithm {algo!r}")
    return highwayhash_cuda.hh256(rows, shard_len,
                                  bytes(key or MAGIC_HIGHWAYHASH_KEY))


def _as_bits(matrix_bits, device) -> torch.Tensor:
    if isinstance(matrix_bits, torch.Tensor):
        return matrix_bits.to(device=device, dtype=torch.uint8)
    return torch.from_numpy(np.array(matrix_bits, dtype=np.uint8)).to(device)


def put_step(data: torch.Tensor, k: int, m: int, shard_len: int = 0,
             key: bytes = b"", algo: str = "highwayhash"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One PUT device step: RS-encode a batch of blocks AND compute each
    shard's streaming-bitrot digest (cmd/erasure-encode.go:75-146 +
    cmd/bitrot-streaming.go:46-58).

    data: (B, k, S) uint8 data shards on the device. S may include right
    zero-padding; shard_len (<= S, default S) is the byte length the
    digests cover. Returns (parity (B, m, S) uint8, digests (B, k+m, 32)
    uint8 in shard order data-then-parity). The caller already holds the
    data rows, so only parity and digests need to reach the host.
    """
    b, k_, s = data.shape
    if k_ != k:
        raise ValueError(f"data has {k_} shards, expected k={k}")
    parity = rs_cuda.gf_matmul(
        rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), data.device),
        data)
    # one hash launch over data+parity rows: the hash is a per-row
    # sequential chain, so two launches would double its latency
    rows = torch.cat([data, parity], dim=-2).reshape(b * (k + m), s)
    digests = _hash_rows(rows, shard_len or s, key, algo)
    return parity, digests.reshape(b, k + m, 32)


def sse_put_step(data: torch.Tensor, keys: torch.Tensor,
                 nonces: torch.Tensor, k: int, m: int, pkg_bytes: int,
                 shard_len: int = 0, key: bytes = b"",
                 algo: str = "highwayhash"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One ENCRYPTED PUT device step: ChaCha20-cipher each block, RS-encode
    the ciphertext, and digest every shard. The host's only cipher work
    left is the Poly1305 tag trailer over the ciphertext this step returns.

    data:   (B, k, S) uint8 staged shards whose flat (B, k·S) view holds the
            plaintext block in its first P·pkg_bytes bytes, zeros after.
            Only that span is ciphered, so pad columns stay zero and the
            stored stream equals the host ChaChaEncryptor's.
    keys:   (B, 8) and nonces (B, P, 3) u32 words (int32 bit patterns or
            int64 values) on data's device, per row
            (features/crypto.DeviceSSE.batch_params): rows of different
            objects share a step under their own keys.
    Returns (rows (B, k+m, S) uint8 — ciphertext data shards with parity
    appended, digests (B, k+m, 32)). Unlike put_step the data rows cross
    back: the caller staged plaintext and writes (and tags) ciphertext.
    """
    b, k_, s = data.shape
    if k_ != k:
        raise ValueError(f"data has {k_} shards, expected k={k}")
    span = nonces.shape[1] * pkg_bytes
    ct = chacha20_cuda.keystream_xor(data.reshape(b, k * s), keys, nonces,
                                     pkg_bytes, span).view(b, k, s)
    parity = rs_cuda.gf_matmul(
        rs_cuda.matrix_bits(rs_matrix.parity_matrix(k, m), data.device), ct)
    rows = torch.cat([ct, parity], dim=-2)
    digests = _hash_rows(rows.reshape(b * (k + m), s), shard_len or s, key,
                         algo)
    return rows, digests.reshape(b, k + m, 32)


def sse_get_step(survivors: torch.Tensor, matrix_bits, keys: torch.Tensor,
                 nonces: torch.Tensor, r: int, k: int, data_src: tuple = (),
                 pkg_bytes: int = 0, shard_len: int = 0, key: bytes = b"",
                 algo: str = "highwayhash"
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ENCRYPTED degraded-GET device step: verify, decode, decipher.
    Reconstructs the missing rows from the survivors, reassembles the kd
    ciphertext data shards, and XORs the per-package keystream off them
    (the Poly1305 package tags are checked on the host before any of this
    output is served).

    data_src: one (src, idx) per data shard — src 0 takes survivors[:, idx]
    (in decode `used` order), src 1 takes the reconstructed row idx (in
    `missing` order). keys (B, 8) / nonces (B, P, 3): the block's package
    words; the plaintext span is P·pkg_bytes of the flat (B, kd·S) view.
    Returns (plain (B, kd, S) deciphered data shards, missing (B, r, S)
    reconstructed CIPHERTEXT shards, survivor digests (B, k, 32)).
    """
    missing = _reconstruct(survivors, matrix_bits, r, k)
    b, _, s = survivors.shape
    digests = _hash_rows(survivors.reshape(b * k, s).contiguous(),
                         shard_len or s, key, algo).reshape(b, k, 32)
    stacked = torch.stack([survivors[:, i] if src == 0 else missing[:, i]
                           for src, i in data_src], dim=1)
    flat = stacked.view(b, len(data_src) * s)
    # the stack is this step's own tensor: decipher it in place
    chacha20_cuda.keystream_xor(flat, keys, nonces, pkg_bytes,
                                nonces.shape[1] * pkg_bytes, out=flat)
    return stacked, missing, digests


def _reconstruct(survivors, matrix_bits, r, k):
    """Shared core of get_step/heal_step: apply the (8r, 8k) matrix to the
    (B, k, S) survivors -> (B, r, S)."""
    b, k_, s = survivors.shape
    if k_ != k:
        raise ValueError(f"survivors have {k_} shards, expected k={k}")
    m2 = _as_bits(matrix_bits, survivors.device)
    if tuple(m2.shape) != (8 * r, 8 * k):
        raise ValueError(f"matrix_bits {tuple(m2.shape)} != {(8 * r, 8 * k)}")
    return rs_cuda.gf_matmul(m2, survivors)


def get_step(survivors: torch.Tensor, matrix_bits, r: int, k: int,
             shard_len: int = 0, key: bytes = b"",
             algo: str = "highwayhash"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One degraded-GET device step: verify AND reconstruct (the
    reference's inseparable verify-then-decode,
    cmd/bitrot-streaming.go:111-150 + cmd/erasure-decode.go:211).

    survivors:   (B, k, S) uint8, stacked in missing_data_matrix `used`
                 order.
    matrix_bits: (8r, 8k) 0/1 — bit-expanded missing-data matrix.
    shard_len:   payload bytes per shard frame (digest coverage).
    Returns (missing (B, r, S) uint8 in `missing` index order,
    digests (B, k, 32) uint8 of the survivors, for the host to compare
    against the frame digests read from disk).
    """
    missing = _reconstruct(survivors, matrix_bits, r, k)
    b, _, s = survivors.shape
    # only the survivors' digests are checked: hash the k rows, not k + r
    digests = _hash_rows(survivors.reshape(b * k, s).contiguous(),
                         shard_len or s, key, algo)
    return missing, digests.reshape(b, k, 32)


def heal_step(survivors: torch.Tensor, matrix_bits, r: int, k: int,
              shard_len: int = 0, key: bytes = b"",
              algo: str = "highwayhash"
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One heal device step: verify the survivors, recover the lost shards
    AND digest them for their new bitrot frames
    (cmd/erasure-lowlevel-heal.go:28-48).

    survivors:   (B, k, S) uint8 in recover_matrix `used` order.
    matrix_bits: (8r, 8k) bit-expanded recover matrix.
    Returns (recovered (B, r, S), survivor_digests (B, k, 32),
    recovered_digests (B, r, 32)).
    """
    recovered = _reconstruct(survivors, matrix_bits, r, k)
    # ONE hash launch over [survivors | recovered]
    b, _, s = survivors.shape
    rows = torch.cat([survivors, recovered], dim=-2).reshape(b * (k + r), s)
    digests = _hash_rows(rows, shard_len or s, key, algo).reshape(
        b, k + r, 32)
    return recovered, digests[:, :k], digests[:, k:]
