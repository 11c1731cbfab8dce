"""CUDA RG-LRU scan: the wrapper of ``csrc/rglru_scan.cu``.

Replaces ``repro/kernels/rglru_scan.py:rglru_scan`` (the Pallas TPU
kernel).  The wrapper checks what the kernel takes, allocates the output
with ``torch.empty`` and launches on the current CUDA stream; the kernel
is built at first use (:mod:`repro_torch.kernels.build`).  Callers go
through :func:`repro_torch.kernels.ops.rglru_scan`, which sends CPU
tensors to the plain version instead.
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
    [_P, _P, _P,  # a, b, h
     _I, _I, _I,  # B, S, D
     _I, _P],  # dtype, stream
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def work(B: int, S: int, D: int, itemsize: int):
    """(FLOPs, bytes) of one call: a and b read once, h written once; a
    multiply and an add per element."""
    return 2.0 * B * S * D, 3.0 * B * S * D * itemsize


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` from a zero state over a, b (B,S,D)
    of one dtype (float32 or bfloat16); the carry is fp32, the result
    (B,S,D) in a's dtype.  ``reverse`` marks a call on inputs the caller
    flipped in time (the backward's): the same launch, counted under its
    own key."""
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"rglru_scan: {name} must be on {a.device} "
                             f"(CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a and b must both be (B,S,D), got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    if a.dtype not in DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: dtypes {a.dtype}/{b.dtype} "
                         f"unsupported (both float32 or both bfloat16)")
    B, S, D = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan: B={B} exceeds the grid's 65535 rows")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D,
                      DTYPE_CODE[a.dtype], stream,
                      key=(B, S, D, str(a.dtype).removeprefix("torch."),
                           reverse))
    return h
