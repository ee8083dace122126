"""S3 Select's predicate scan on the card.

Counterpart of minio_tpu/scan/kernels.py:244-314 (`_eval_prog`,
`_kernel_for`). ``scan_eval`` is the wrapper of the hand-written
predicate-program interpreter (csrc/scan_eval.cu): on CUDA tensors it
launches the kernel over the program ops/scan_program.py flattened, on CPU
tensors it runs the plain PyTorch version (ops/scan_plain.py, the plan's
tree walk); any other device raises.

Pages travel to the card as one byte row each (``pack_pages``): every
array of a page at a 16-byte aligned offset, so that the pages of several
requests stack along the batch axis and go over in one copy, and
``unpack`` gives typed views of such a batch without copying it. The
kernel reads the views in place at their page strides.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import kernels, scan_plain

# (name, numpy dtype, element bytes) of a page's arrays, in packing order;
# each array of a page is [R, C] except rowvalid [R] and sb [R, C, W]
_FIELDS = (("num", np.float64, 8), ("slen", np.int32, 4),
           ("ok", np.bool_, 1), ("null", np.bool_, 1),
           ("rowvalid", np.bool_, 1), ("sb", np.uint8, 1))
_TORCH = {np.float64: torch.float64, np.int32: torch.int32,
          np.bool_: torch.bool, np.uint8: torch.uint8}


def page_layout(R: int, C: int, W: int) -> tuple[dict, int]:
    """({name: (byte offset, element count)}, page bytes) of one packed
    page; offsets and the page size are multiples of 16."""
    layout, at = {}, 0
    for name, _dt, size in _FIELDS:
        n = R if name == "rowvalid" else R * C * (W if name == "sb" else 1)
        layout[name] = (at, n)
        at += n * size
        at += -at % 16
    return layout, at


def pack_pages(arrays: dict) -> np.ndarray:
    """The pager's arrays (num, ok, null, sb, slen, rowvalid, each with B
    pages on axis 0) -> (B, P) uint8, one packed page per row."""
    B, R, C, W = arrays["sb"].shape
    layout, P = page_layout(R, C, W)
    out = np.zeros((B, P), np.uint8)
    for name, dt, size in _FIELDS:
        at, n = layout[name]
        src = np.ascontiguousarray(arrays[name], dt).reshape(B, n)
        out[:, at:at + n * size] = src.view(np.uint8)
    return out


def unpack(x: torch.Tensor, R: int, C: int, W: int) -> dict:
    """Typed views (no copy) of a (B, P) uint8 batch of packed pages, in
    the pager's shapes: num [B,R,C] f64, slen i32, ok / null bool, sb
    [B,R,C,W] u8, rowvalid [B,R] bool."""
    layout, P = page_layout(R, C, W)
    if x.dim() != 2 or x.shape[1] != P or x.dtype != torch.uint8:
        raise ValueError(f"packed pages must be (B, {P}) uint8")
    B = x.shape[0]
    out = {}
    for name, dt, size in _FIELDS:
        at, n = layout[name]
        v = x[:, at:at + n * size].view(_TORCH[dt])
        shape = (B, R) if name == "rowvalid" else \
            (B, R, C, W) if name == "sb" else (B, R, C)
        out[name] = v.view(shape)
    return out


# the argument types of the C entry point scan_eval_launch
ARGTYPES = [ctypes.c_void_p, ctypes.c_int, *[ctypes.c_int] * 9,
            *[ctypes.c_void_p, ctypes.c_longlong] * 6, *[ctypes.c_int] * 4,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _launcher():
    return kernels.function("scan_eval", "scan_eval_launch", ARGTYPES)


def _blob_on(program, device: torch.device) -> torch.Tensor:
    blob = program.on_device.get(device)
    if blob is None:
        # a blocking copy: done before any stream reads it
        blob = torch.from_numpy(program.blob.copy()).to(device)
        program.on_device[device] = blob
    return blob


def _check_page(t: torch.Tensor, name: str, dtypes: tuple, shape: tuple):
    if t.dtype not in dtypes or tuple(t.shape) != shape:
        raise ValueError(f"scan_eval: {name} must be {shape} of "
                         f"{dtypes[0]}, not {tuple(t.shape)} {t.dtype}")
    # within a page the elements are contiguous; pages may sit at any
    # stride (a packed batch)
    inner = 1
    for d in range(t.dim() - 1, 0, -1):
        if t.shape[d] > 1 and t.stride(d) != inner:
            raise ValueError(f"scan_eval: {name} is not contiguous within "
                             "a page")
        inner *= t.shape[d]


def _check_out(t: torch.Tensor, name: str, dtype, shape: tuple, device):
    if t.dtype != dtype or tuple(t.shape) != shape or \
            not t.is_contiguous() or t.device != device:
        raise ValueError(f"scan_eval: {name} must be a contiguous {shape} "
                         f"{dtype} tensor on {device}")


def launch_args(program, blob: torch.Tensor, num, ok, null, sb, slen,
                rowvalid, mask, counts, stream) -> tuple:
    """scan_eval_launch's arguments for checked pages, outputs and the
    program's blob on their device: the blob and its parts, the stack
    depths, each page array's address and page stride in bytes, the
    shape, the outputs and the stream."""
    B, R, C, W = sb.shape
    return (blob.data_ptr(), blob.numel(), *program.parts, program.max_vals,
            program.max_bools, num.data_ptr(), num.stride(0) * 8,
            slen.data_ptr(), slen.stride(0) * 4, ok.data_ptr(), ok.stride(0),
            null.data_ptr(), null.stride(0), sb.data_ptr(), sb.stride(0),
            rowvalid.data_ptr(), rowvalid.stride(0), B, R, C, W,
            mask.data_ptr(), counts.data_ptr(), stream.cuda_stream)


def scan_eval(program, num: torch.Tensor, ok: torch.Tensor,
              null: torch.Tensor, sb: torch.Tensor, slen: torch.Tensor,
              rowvalid: torch.Tensor, mask: torch.Tensor | None = None,
              counts: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (mask uint8 [B, R], counts int32 [B, len(program.cspec)]): the
    rows of B pages that pass `program` (an ops/scan_program.Program) and
    are real rows, and per page the COUNT of each of its specs. Pages in
    the pager's shapes, on one device; `mask` and `counts`, when given,
    are contiguous tensors of those shapes on that device to write.
    CPU tensors take scan_plain.scan_eval; CUDA tensors launch the kernel
    (counted in scan_eval.launches)."""
    B, R, C, W = sb.shape
    if num.device.type == "cpu":
        pm, pc = scan_plain.scan_eval(program.prog, program.cspec, num, ok,
                                      null, sb, slen, rowvalid)
        if mask is None and counts is None:
            return pm, pc
        out_m = pm if mask is None else mask.copy_(pm)
        return out_m, pc if counts is None else counts.copy_(pc)
    if num.device.type != "cuda":
        raise ValueError(f"scan_eval: unsupported device {num.device}")
    flags = (torch.bool, torch.uint8)
    _check_page(num, "num", (torch.float64,), (B, R, C))
    _check_page(slen, "slen", (torch.int32,), (B, R, C))
    _check_page(ok, "ok", flags, (B, R, C))
    _check_page(null, "null", flags, (B, R, C))
    _check_page(sb, "sb", (torch.uint8,), (B, R, C, W))
    _check_page(rowvalid, "rowvalid", flags, (B, R))
    for t in (ok, null, sb, slen, rowvalid):
        if t.device != num.device:
            raise ValueError("scan_eval: pages on more than one device")
    K = len(program.cspec)
    if mask is None:
        mask = torch.empty((B, R), dtype=torch.uint8, device=num.device)
    _check_out(mask, "mask", torch.uint8, (B, R), num.device)
    if counts is None:
        counts = torch.empty((B, K), dtype=torch.int32, device=num.device)
    _check_out(counts, "counts", torch.int32, (B, K), num.device)
    if B == 0:
        return mask, counts
    blob = _blob_on(program, num.device)
    stream = torch.cuda.current_stream(num.device)
    # an evicted program's blob may be freed while this launch reads it
    blob.record_stream(stream)
    err = _launcher()(*launch_args(program, blob, num, ok, null, sb, slen,
                                   rowvalid, mask, counts, stream))
    kernels.check(err, "scan_eval launch")
    kernels.count_launch(scan_eval)
    return mask, counts


scan_eval.launches = 0
