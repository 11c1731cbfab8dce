"""CUDA RG-LRU scan: the wrapper of ``csrc/rglru_scan.cu``.

Replaces ``repro/kernels/rglru_scan.py:rglru_scan`` (the Pallas TPU
kernel).  One kernel runs the recurrence forward (:func:`rglru_scan`) and
its gradient backwards in time (:func:`rglru_scan_backward`).  The
wrappers check what the kernel takes, allocate the outputs with
``torch.empty`` and launch on the current CUDA stream; the kernel is built
at first use (:mod:`repro_torch.kernels.build`).  Callers go through
:mod:`repro_torch.kernels.ops`, which sends CPU tensors to the plain
versions instead.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "rglru_scan",
    "rglru_scan.cu",
    "repro_rglru_scan",
    [_P, _P, _P,  # inputs: a, b (forward) / a, g, h (reverse)
     _P, _P,  # outputs: h (forward) / da, db (reverse)
     _I, _I, _I,  # B, S, D
     _I, _I, _P],  # dtype, reverse, stream
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def work(B: int, S: int, D: int, itemsize: int, reverse: bool = False):
    """(FLOPs, bytes) of one call.  Forward: a and b read once, h written
    once; a multiply and an add per element.  Reverse: a, g and h read
    once, da and db written once; the carry's multiply and add and da's
    multiply per element."""
    if reverse:
        return 3.0 * B * S * D, 5.0 * B * S * D * itemsize
    return 2.0 * B * S * D, 3.0 * B * S * D * itemsize


def _check(what: str, tensors) -> None:
    first = tensors[0][1]
    for name, t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{first.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.dim() != 3 or t.shape != first.shape:
            raise ValueError(f"{what}: every input must be (B,S,D) of one "
                             f"shape, got {name} {tuple(t.shape)} against "
                             f"{tuple(first.shape)}")
        if first.dtype not in DTYPE_CODE or t.dtype != first.dtype:
            raise ValueError(f"{what}: dtypes {first.dtype}/{t.dtype} "
                             f"unsupported (all float32 or all bfloat16)")
    if first.shape[0] > 65535:
        raise ValueError(f"{what}: B={first.shape[0]} exceeds the grid's "
                         f"65535 rows")


def _launch(x0, x1, x2, y0, y1, reverse: bool) -> None:
    B, S, D = x0.shape
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(x0.data_ptr(), x1.data_ptr(),
                      None if x2 is None else x2.data_ptr(), y0.data_ptr(),
                      None if y1 is None else y1.data_ptr(), B, S, D,
                      DTYPE_CODE[x0.dtype], int(reverse), stream,
                      key=(B, S, D, str(x0.dtype).removeprefix("torch."),
                           reverse))


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` from a zero state over a, b (B,S,D)
    of one dtype (float32 or bfloat16); the carry is fp32, the result
    (B,S,D) in a's dtype."""
    _check("rglru_scan", [("a", a), ("b", b)])
    h = torch.empty_like(a)
    if h.numel():
        _launch(a, b, None, h, None, reverse=False)
    return h


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor,
                        g: torch.Tensor):
    """(da, db) of ``h = rglru_scan(a, b)`` for the cotangent ``g`` of h,
    all (B,S,D) of a's dtype: one launch of the kernel walking t from S-1
    down to 0, ``dh_t = a_{t+1}·dh_{t+1} + g_t`` (fp32 carry), ``db =
    dh``, ``da_t = dh_t·h_{t-1}``; counted under its key with ``reverse``
    True."""
    _check("rglru_scan_backward", [("a", a), ("h", h), ("g", g)])
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel():
        _launch(a, g, h, da, db, reverse=True)
    return da, db
