"""Run a scan plan's predicate over page batches on a device.

Counterpart of minio_tpu/scan/kernels.py:317-346 (`_pad_batch`,
`run_batch`). The reference traces one XLA program per (signature,
shape) and pads the page axis to a power of two to bound that cache; the
port runs every plan through one generic kernel (ops/scan_cuda.scan_eval
over the program of ops/scan_program.py), so nothing is padded.

A batch goes through object/codec.run_step, as every other device step of
the port does: packed pages (ops/scan_cuda.pack_pages) are copied onto
the device in one copy (on the card inside one of the codec's in-flight
slots, on its stream), the kernel runs there, and the mask and counts come
back. On a CPU device the step is the kernel's plain version. There is no
device probe and no fallback: a failed build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..object import codec
from ..ops import scan_cuda, scan_program


def _indexed(device) -> torch.device:
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        # the codec's slots are keyed by the indexed device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run_packed(device, program, shape: tuple, parts: list,
               stage_cb=None) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate `program` over packed page groups `parts` (each (B_i, P)
    uint8, pages of shape (R, C, W) = `shape`), stacked along B, in one
    launch on `device`. Returns (mask bool [B, R], counts int32 [B, K])."""
    R, C, W = shape

    def step(x):
        mask, counts = scan_cuda.scan_eval(program,
                                           **scan_cuda.unpack(x, R, C, W))
        return mask, counts.view(torch.uint8)

    mask, counts = codec.run_step(_indexed(device), "scan", parts, step,
                                  stage_cb)
    return mask.view(np.bool_), counts.view(np.int32)


def run_batch(plan, arrays: dict, device=None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate the plan's predicate over one request's pages (the pager's
    arrays) on `device` (None: the card). Returns the row mask [B, R] and
    the per-page COUNT sums [B, K]. Raises Decline("program-depth") for a
    program the kernel's stacks cannot hold."""
    program = scan_program.program_for(plan)
    B, R, C, W = arrays["sb"].shape
    return run_packed(device, program, (R, C, W),
                      [scan_cuda.pack_pages(arrays)])
