"""Host-side erasure codec: split/join + encode/reconstruct routing.

The engine-facing seam shaped like the reference's codec wrapper
(cmd/erasure-coding.go:28-112; counterpart of minio_tpu/object/codec.py).
Two routes, picked per call by batch size (minio_tpu/object/codec.py:
140-145):

  * the device (ops/rs_cuda.py, models/pipeline.py) for batches of at
    least DEVICE_MIN_BYTES, where launch and transfer costs amortize;
  * the native C++ host library (utils/native.py), or numpy where it did
    not build, for smaller batches.

Both produce byte-identical shards. A batch routed to the device that
fails there raises: there is no silent host retry.

In-flight slots. Each device dispatch on the card holds one of
MINIO_TPU_SCHED_INFLIGHT slots of its device: a CUDA stream, pinned input
and output staging, and CUDA events. The batch is copied to the card from
pinned memory with a non-blocking copy on the slot's stream (straight
from the caller's array when that is already pinned, as the PUT's staging
ring is; else assembled into the slot's pinned input), the kernels run on
that stream, and the results come back into the slot's pinned output. The
dispatch then waits on the slot's own event, never on the whole device, so
two dispatches' copies and kernels overlap. Every tensor of a dispatch is
allocated and used on its slot's stream (none crosses streams, so none
needs ``record_stream``); the cached coding matrices are written once by
a blocking copy before any stream reads them.

Encrypted batches (encrypt_encode_and_hash_batch,
verify_decode_decrypt_batch) ride the same slots: their per-row ChaCha20
key and nonce words go to the card on the slot's stream with the batch.
So do the two device steps that hold no erasure geometry: the GET's
decipher of verified packages (decipher_packages) and S3 Select's
predicate scan over packed pages (scan/kernels.run_packed).

Left out: the mesh routes (parallel/mesh.py).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import bitrot as bitrot_mod
from .. import device as device_mod
from ..ops import chacha20_cuda, gf256, rs_cuda, rs_matrix
from ..parallel import bpool
from ..utils import knobs, native
from . import api_errors

# Batches at least this large go to the device.
DEVICE_MIN_BYTES = knobs.get_int("MINIO_TPU_DEVICE_MIN_BYTES")
# dispatches in flight per device: one slot each
INFLIGHT = max(1, knobs.get_int("MINIO_TPU_SCHED_INFLIGHT"))

# Seconds inside the codec's device dispatches, per verb, summed over
# calls. They are spans, not device time: on the card each is the interval
# between two CUDA events recorded on the slot's stream around the host's
# launches, so it also holds the time the card waits for the host between
# them (the dispatch thread waiting for the interpreter lock). Device time
# is the profiler's. "transfer_span_s" is the host's assembly of the batch
# plus the span of its copy onto the device, "compute_span_s" the span
# from the copy's end to the last launch's end, "fetch_span_s" the span of
# the copy back plus the host's copy out of pinned memory. On CPU tensors
# they are host wall time.
STEP_STAGES = ("transfer_span_s", "compute_span_s", "fetch_span_s")
_steps_mu = threading.Lock()
STEP_SECONDS: dict[str, dict] = {}


def reset_step_seconds() -> None:
    with _steps_mu:
        for verb in ("encode", "decode", "recover", "decipher", "scan"):
            STEP_SECONDS[verb] = {"calls": 0,
                                  **dict.fromkeys(STEP_STAGES, 0.0)}


reset_step_seconds()


def step_seconds() -> dict:
    """A consistent copy of STEP_SECONDS."""
    with _steps_mu:
        return {verb: dict(v) for verb, v in STEP_SECONDS.items()}


def _record_step(verb: str, stages: dict) -> None:
    with _steps_mu:
        acc = STEP_SECONDS[verb]
        acc["calls"] += 1
        for name, sec in stages.items():
            acc[name] += sec


class _Slot:
    """One in-flight dispatch's resources on one card: its stream,
    pinned staging (grown on demand, reused by the slot's next dispatch
    only after the slot's event has completed) and four timing events
    (start, input copied, steps done, outputs copied)."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.events = [torch.cuda.Event(enable_timing=True)
                       for _ in range(4)]
        self._pinned: dict[str, torch.Tensor] = {}

    def pinned(self, which: str, nbytes: int) -> torch.Tensor:
        buf = self._pinned.get(which)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._pinned[which] = buf
        return buf[:nbytes]


_slots: dict[torch.device, "queue.Queue[_Slot]"] = {}
_slots_mu = threading.Lock()


@contextlib.contextmanager
def _slot(device: torch.device):
    """Hold one of the device's INFLIGHT slots, with its stream current
    on this thread (PyTorch's current stream is per thread)."""
    with _slots_mu:
        q = _slots.get(device)
        if q is None:
            q = _slots[device] = queue.Queue()
            for _ in range(INFLIGHT):
                q.put(_Slot(device))
    slot = q.get()
    try:
        with torch.cuda.stream(slot.stream):
            yield slot
    except BaseException:
        # a failed dispatch may have left copies out of the slot's staging
        # queued: let them finish before another dispatch refills it
        try:
            slot.stream.synchronize()
        except RuntimeError:
            pass          # the device is in error: the original raises
        raise
    finally:
        q.put(slot)


def _parts(data) -> list[np.ndarray]:
    """A batch given as one (B, ...) array or as a list of such arrays
    stacked along the batch axis (the batch former's coalesced groups)."""
    return list(data) if isinstance(data, (list, tuple)) else [data]


# -- one device dispatch ----------------------------------------------------

def run_step(device: torch.device, verb: str, parts: list, step,
             stage_cb=None) -> tuple:
    """Put the batch stacked from `parts` on `device`, run
    `step(tensor) -> tuple of uint8 tensors` on it, and return the outputs
    as numpy arrays. On the card this holds one of the device's slots for
    the copies and launches. Reports the STEP_STAGES spans to
    STEP_SECONDS[verb] and to stage_cb."""
    if device.type == "cuda":
        out, stages = _run_on_card(device, parts, step)
    else:
        out, stages = _run_on_host_tensors(device, parts, step)
    _record_step(verb, stages)
    if stage_cb is not None:
        for name in STEP_STAGES:
            stage_cb(name, stages[name])
    return out


def _run_on_host_tensors(device: torch.device, parts: list, step):
    t0 = time.perf_counter()
    x = parts[0] if len(parts) == 1 else np.concatenate(parts)
    x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    t1 = time.perf_counter()
    outs = step(x)
    t2 = time.perf_counter()
    res = tuple(o.cpu().numpy() for o in outs)
    t3 = time.perf_counter()
    return res, {"transfer_span_s": t1 - t0,
                 "compute_span_s": t2 - t1, "fetch_span_s": t3 - t2}


def _run_on_card(device: torch.device, parts: list, step):
    shape = (sum(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:])
    nbytes = int(np.prod(shape))
    with _slot(device) as slot:
        t0 = time.perf_counter()
        start, copied, stepped, fetched = slot.events
        src = parts[0] if len(parts) == 1 else None
        if src is not None and src.flags.c_contiguous \
                and torch.from_numpy(src).is_pinned():
            host = torch.from_numpy(src)     # a pinned ring buffer
        else:
            src = None
            host = slot.pinned("in", nbytes).view(shape)
            view, at = host.numpy(), 0
            for p in parts:
                view[at:at + p.shape[0]] = p
                at += p.shape[0]
        assembled = time.perf_counter() - t0
        start.record()
        x = torch.empty(shape, dtype=torch.uint8, device=device)
        x.copy_(host, non_blocking=True)
        copied.record()
        if src is not None:
            # the ring buffer is recycled only after this copy
            done = torch.cuda.Event()
            done.record()
            bpool.after_copy(src, done)
        outs = step(x)
        stepped.record()
        pin = slot.pinned("out", sum(o.numel() for o in outs))
        views, at = [], 0
        for o in outs:
            v = pin[at:at + o.numel()].view(o.shape)
            v.copy_(o, non_blocking=True)
            views.append(v)
            at += o.numel()
        fetched.record()
        fetched.synchronize()
        t1 = time.perf_counter()
        # the slot's pinned output is reused by its next dispatch
        res = tuple(v.numpy().copy() for v in views)
        copied_out = time.perf_counter() - t1
        stages = {"transfer_span_s": assembled
                  + start.elapsed_time(copied) / 1e3,
                  "compute_span_s": copied.elapsed_time(stepped) / 1e3,
                  "fetch_span_s": stepped.elapsed_time(fetched) / 1e3
                  + copied_out}
    return res, stages


def decipher_packages(device, rows, keys: np.ndarray, nonces: np.ndarray,
                      *, stage_cb=None) -> np.ndarray:
    """The GET's decipher of verified ChaCha20 packages: rows (N, Lp)
    uint8, one package each zero-padded to a 64-byte multiple (or a list
    of such groups, stacked), keys (N, 8) and nonces (N, 3) u32 words ->
    (N, Lp) plaintext rows, in one launch of the ChaCha20 kernel on
    `device` (its plain version on the CPU). A failure raises."""
    def step(x):
        return (chacha20_cuda.xor_packages(
            x, chacha20_cuda.words(keys, x.device),
            chacha20_cuda.words(nonces, x.device)),)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # the codecs' slots are keyed by the indexed device
        dev = torch.device("cuda", torch.cuda.current_device())
    return run_step(dev, "decipher", _parts(rows), step, stage_cb)[0]


class Codec:
    """RS(k, m) over GF(2^8), klauspost-compatible matrices."""

    def __init__(self, data_shards: int, parity_shards: int,
                 block_size: int, device=None):
        if not (1 <= data_shards <= 256 and 0 <= parity_shards
                and data_shards + parity_shards <= 256):
            raise ValueError("unsupported erasure geometry")
        self.k = data_shards
        self.m = parity_shards
        self.block_size = block_size
        self.shard_size = -(-block_size // data_shards)
        dev = device_mod.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._parity_matrix = np.asarray(
            rs_matrix.parity_matrix(self.k, self.m), dtype=np.uint8)

    # -- split / join ------------------------------------------------------

    def split(self, block: bytes | memoryview) -> np.ndarray:
        """block -> (k, S) zero-padded shards, S = ceil(len/k)
        (klauspost Split semantics, cmd/erasure-coding.go:70-84)."""
        n = len(block)
        if n == 0:
            return np.zeros((self.k, 0), dtype=np.uint8)
        shard = -(-n // self.k)
        buf = np.zeros(self.k * shard, dtype=np.uint8)
        buf[:n] = np.frombuffer(block, dtype=np.uint8)
        return buf.reshape(self.k, shard)

    @staticmethod
    def join(data_shards: np.ndarray, size: int) -> bytes:
        """Concatenate data shards and trim padding."""
        return data_shards.reshape(-1).tobytes()[:size]

    # -- routing -----------------------------------------------------------

    def _route(self, nbytes: int) -> str:
        if nbytes >= DEVICE_MIN_BYTES:
            return "device"
        if native.available():
            return "native"
        return "numpy"

    def fused_route(self, algo) -> bool:
        """Whether this codec's device can run the fused steps for `algo`
        at all: a device hash kernel (HighwayHash-256 or SHA-256) and
        parity shards. A batch that passes still takes the host route
        below the size gate."""
        return self.m > 0 and self._device_hash_kernel(algo) is not None

    @staticmethod
    def _device_hash_kernel(algo) -> Optional[str]:
        """Device kernel name for a bitrot algorithm, or None when the
        algorithm has no device implementation."""
        if algo in (bitrot_mod.BitrotAlgorithm.HIGHWAYHASH256,
                    bitrot_mod.BitrotAlgorithm.HIGHWAYHASH256S):
            return "highwayhash"
        if algo is bitrot_mod.BitrotAlgorithm.SHA256:
            return "sha256"
        return None

    def _host_matmul(self, matrix: np.ndarray, stacked: np.ndarray,
                     path: str) -> np.ndarray:
        """(B, k, S) -> (B, r, S) on the host: the native library, or numpy
        where it did not build."""
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        if path == "native" and native.available():
            return np.stack([native.gf_matmul(matrix, s) for s in stacked])
        return np.stack([gf256.gf_matmul(matrix, s) for s in stacked])

    # -- one device dispatch -----------------------------------------------

    def _run_step(self, verb: str, parts: list, step, stage_cb=None
                  ) -> tuple:
        return run_step(self.device, verb, parts, step, stage_cb)

    def _matmul_on_device(self, verb: str, matrix: np.ndarray, parts: list
                          ) -> np.ndarray:
        bits = rs_cuda.matrix_bits(matrix, self.device)
        return self._run_step(
            verb, parts, lambda x: (rs_cuda.gf_matmul(bits, x),))[0]

    # -- encode ------------------------------------------------------------

    def encode_parity_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, S) data shards -> (B, m, S) parity ONLY — the data rows
        are written straight out of the read buffer."""
        b, _k, s = data.shape
        if self.m == 0:
            return np.zeros((b, 0, s), dtype=np.uint8)
        path = self._route(data.nbytes)
        if path == "device":
            return self._matmul_on_device("encode", self._parity_matrix,
                                          [data])
        return self._host_matmul(self._parity_matrix, data, path)

    def encode_and_hash_batch(self, data, algo, *, stage_cb=None):
        """The fused device path of the PUT loop: one device step computes
        parity AND every shard's per-block digest (models/pipeline.put_step;
        HighwayHash-256, or SHA-256 under the sha256 algorithm, whose
        whole-file writers rehash on the host as the reference's do).

        data: (B, k, S), or a list of such groups stacked along B. Returns
        (parity (B, m, S), digests (B, k+m, 32)) as numpy arrays, or None
        when the batch does not route to the device or the bitrot
        algorithm has no device kernel. Only parity and digests come back
        from the device; the data rows are the caller's own bytes.
        stage_cb(stage, seconds) receives the STEP_STAGES spans."""
        parts = _parts(data)
        if not self.fused_route(algo):
            return None
        if self._route(sum(p.nbytes for p in parts)) != "device":
            return None
        from ..models.pipeline import put_step
        k, m = self.k, self.m
        kernel = self._device_hash_kernel(algo)
        return self._run_step(
            "encode", parts, lambda x: put_step(x, k, m, algo=kernel),
            stage_cb)

    def encrypt_encode_and_hash_batch(self, data, keys, nonces,
                                      pkg_bytes: int, algo, *,
                                      stage_cb=None):
        """The fused device path of the ENCRYPTED PUT loop: ChaCha20 cipher,
        parity and every shard's digest in one device step
        (models/pipeline.sse_put_step).

        data: (B, k, S) staged PLAINTEXT shards, or a list of such groups;
        keys (B, 8) / nonces (B, P, 3) u32 word arrays for the stacked
        rows (features/crypto.DeviceSSE.batch_params; P·pkg_bytes
        plaintext bytes per row). Returns (full (B, k+m, S) — CIPHERTEXT
        data rows with parity appended, digests (B, k+m, 32)), or None
        when the batch does not route to the device (the caller ciphers on
        the host) or the algorithm has no device kernel."""
        parts = _parts(data)
        if not self.fused_route(algo):
            return None
        if self._route(sum(p.nbytes for p in parts)) != "device":
            return None
        from ..models.pipeline import sse_put_step
        k, m = self.k, self.m
        kernel = self._device_hash_kernel(algo)

        def step(x):
            return sse_put_step(x, chacha20_cuda.words(keys, x.device),
                                chacha20_cuda.words(nonces, x.device), k, m,
                                pkg_bytes, algo=kernel)
        return self._run_step("encode", parts, step, stage_cb)

    def verify_decode_decrypt_batch(self, survivors, present_mask: int,
                                    shard_len: int, keys, nonces,
                                    pkg_bytes: int, algo, *, stage_cb=None):
        """The fused device path of the ENCRYPTED degraded GET: verify the
        survivors, reconstruct the missing data rows, and decipher the
        reassembled data shards in one device step
        (models/pipeline.sse_get_step).

        survivors: (B, k, S) in missing_data_matrix `used` order (or a list
        of such groups); keys (B, 8) / nonces (B, P, 3) word arrays.
        Returns (plain (B, k, S) deciphered data shards in shard-index
        order, missing_idx, survivor_digests (B, k, 32)), or None when the
        batch does not route to the device, the algorithm has no device
        kernel, or nothing is missing. The package tags are checked on the
        host before any of this is served."""
        parts = _parts(survivors)
        kernel = self._device_hash_kernel(algo)
        if kernel is None:
            return None
        if self._route(sum(p.nbytes for p in parts)) != "device":
            return None
        dm, used, missing = rs_matrix.missing_data_matrix(
            self.k, self.m, present_mask)
        if not missing:
            return None
        # data shard j comes from the survivors (decode `used` order) or
        # the reconstructed rows (`missing` order)
        data_src = tuple((0, used.index(j)) if j in used
                         else (1, missing.index(j)) for j in range(self.k))
        from ..models.pipeline import sse_get_step
        bits = rs_cuda.matrix_bits(dm, self.device)
        r, k = dm.shape[0], self.k

        def step(x):
            plain, _ct_missing, digests = sse_get_step(
                x, bits, chacha20_cuda.words(keys, x.device),
                chacha20_cuda.words(nonces, x.device), r, k, data_src,
                pkg_bytes, shard_len, algo=kernel)
            return plain, digests
        plain, digests = self._run_step("decode", parts, step, stage_cb)
        return plain, missing, digests

    # -- fused verify + decode / recover (device) --------------------------

    def verify_and_decode_batch(self, survivors, present_mask: int,
                                shard_len: int, algo, *, stage_cb=None):
        """The fused device path of the degraded GET: ONE device step
        bitrot-hashes every survivor shard AND reconstructs only the
        missing data rows (models/pipeline.get_step).

        survivors: (B, k, S) stacked in missing_data_matrix `used` order
        (or a list of such groups). Returns (missing (B, r, S),
        missing_idx, survivor_digests (B, k, 32)) as numpy arrays, or None
        when the batch does not route to the device, the algorithm has no
        device kernel, or nothing is missing."""
        parts = _parts(survivors)
        kernel = self._device_hash_kernel(algo)
        if kernel is None:
            return None
        if self._route(sum(p.nbytes for p in parts)) != "device":
            return None
        dm, _used, missing = rs_matrix.missing_data_matrix(
            self.k, self.m, present_mask)
        if not missing:
            return None
        from ..models.pipeline import get_step
        bits = rs_cuda.matrix_bits(dm, self.device)
        r, k = dm.shape[0], self.k
        out, digests = self._run_step(
            "decode", parts,
            lambda x: get_step(x, bits, r, k, shard_len, algo=kernel),
            stage_cb)
        return out, missing, digests

    def verify_and_recover_batch(self, survivors, present_mask: int,
                                 rows: "set[int]", shard_len: int, algo, *,
                                 stage_cb=None):
        """The fused device path of heal: verify the survivors, rebuild
        exactly the requested lost rows, and digest the rebuilt shards for
        their new bitrot frames (models/pipeline.heal_step; reference
        minio_tpu/object/codec.py:371-415).

        survivors: (B, k, S) in recover_matrix `used` order (or a list of
        such groups). Returns (out (B, R, S), idxs, survivor_digests
        (B, k, 32), out_digests (B, R, 32)), or None when the batch does
        not route to the device or nothing is to be rebuilt. A failure on
        the card raises."""
        parts = _parts(survivors)
        kernel = self._device_hash_kernel(algo)
        if kernel is None:
            return None
        if self._route(sum(p.nbytes for p in parts)) != "device":
            return None
        rec, idxs = rs_matrix.recover_rows(self.k, self.m, present_mask,
                                           rows)
        if not idxs:
            return None
        from ..models.pipeline import heal_step
        bits = rs_cuda.matrix_bits(rec, self.device)
        r, k = rec.shape[0], self.k
        out, sdig, odig = self._run_step(
            "recover", parts,
            lambda x: heal_step(x, bits, r, k, shard_len, algo=kernel),
            stage_cb)
        return out, idxs, sdig, odig

    # -- batched decode / recover ------------------------------------------

    def decode_stacked(self, survivors: np.ndarray,
                       present_mask: int) -> np.ndarray:
        """(B, k, S) survivors — stacked in decode_matrix `used` order —
        -> (B, k, S) data shards, one matrix application for the batch."""
        d, _used = rs_matrix.decode_matrix(self.k, self.m, present_mask)
        path = self._route(survivors.nbytes)
        if path == "device":
            return self._matmul_on_device("decode", d, [survivors])
        return self._host_matmul(d, survivors, path)

    def recover_stacked(self, survivors: np.ndarray, present_mask: int,
                        rows: "set[int]"
                        ) -> tuple[np.ndarray, list[int]]:
        """(B, k, S) survivors (recover_matrix `used` order) -> exactly the
        requested missing shard rows, one batched matrix application.
        Returns (out (B, R, S), shard indices for each output row)."""
        rec, idxs = rs_matrix.recover_rows(self.k, self.m, present_mask,
                                           rows)
        path = self._route(survivors.nbytes)
        if path == "device":
            return self._matmul_on_device("recover", rec,
                                          [survivors]), idxs
        return self._host_matmul(rec, survivors, path), idxs

    def reconstruct(self, shards: list, data_only: bool = False,
                    rows: Optional[set] = None) -> list:
        """Fill in missing (None) shards from >= k survivors.

        shards: length k+m list in shard-index order; returns the full
        list with the missing entries rebuilt (only data shards when
        data_only; only the shard indices in `rows` when given, the heal
        path's exact-rows form) — reference DecodeDataAndParityBlocks /
        DecodeDataBlocks (cmd/erasure-coding.go:89-112)."""
        n = self.k + self.m
        if len(shards) != n:
            raise ValueError("bad shard count")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.k:
            raise api_errors.InsufficientReadQuorum(
                f"{len(present)} shards < k={self.k}")
        wanted = {i for i in range(n) if shards[i] is None
                  and (not data_only or i < self.k)
                  and (rows is None or i in rows)}
        if not wanted:
            return list(shards)
        mask = sum(1 << i for i in present)
        _rec, used, _missing = rs_matrix.recover_matrix(self.k, self.m, mask)
        stacked = np.stack([shards[i] for i in used])[None]
        out, idxs = self.recover_stacked(stacked, mask, wanted)
        result = list(shards)
        for row, idx in enumerate(idxs):
            result[idx] = out[0, row]
        return result
