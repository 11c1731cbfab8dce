"""CUDA grouped matmul of the MoE experts: the wrapper of ``csrc/grouped_matmul.cu``.

Replaces ``repro/kernels/moe_gmm.py:grouped_matmul`` (the Pallas TPU
kernel).  The wrapper checks what the kernel takes, picks the kernel's
variant by shape (:func:`variant`), allocates the output with
``torch.empty`` (the kernel writes every element, zeros included) and
launches on the current CUDA stream; the kernel is built at first use
(:mod:`repro_torch.kernels.build`).  Callers go through
:func:`repro_torch.kernels.ops.grouped_matmul`, which sends CPU tensors to
the plain version instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "grouped_matmul",
    "grouped_matmul.cu",
    "repro_grouped_matmul",
    [_P, _P, _P, _P,  # x, w, group sizes (or null), y
     _I, _I, _I, _I,  # E, C, d, f
     _I, _I, _P],  # dtype, mode, stream
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_MIN_ROWS = 64  # one wgmma warpgroup's rows
SKINNY_MAX_ROWS = 16  # decode: C = 4 at 8 slots
MAX_SMEM = 227 * 1024


def work(E: int, C: int, d: int, f: int, itemsize: int, *,
         live_rows: Optional[int] = None, nonempty: Optional[int] = None,
         sized: bool = True):
    """(FLOPs, bytes) of one call on x (E,C,d) and w (E,d,f): the live
    rows of x and the weights of each non-empty group read once, the
    whole (E,C,f) output written, the (E,) int32 group sizes read when
    ``sized``; a product of ``d`` for each live row and output column.
    ``live_rows`` and ``nonempty`` are what the routing gave this call;
    ``None`` (a shape-only call, which has no data) counts every row and
    every group live."""
    live = E * C if live_rows is None else live_rows
    groups = E if nonempty is None else nonempty
    return (2.0 * live * d * f,
            float((live * d + groups * d * f + E * C * f) * itemsize
                  + (4 * E if sized else 0)))


def _skinny_smem(C: int, d: int, itemsize: int) -> int:
    """Shared memory of the skinny kernel: x[e] as fp32 with C rounded up
    to 4, 8 or 16 rows (or the partial sums of 128 columns, if larger),
    and 256 threads' rings of 8 weight rows of 8 columns."""
    rows = 4 if C <= 4 else 8 if C <= 8 else 16
    return 4 * rows * max(d, 1024) + 8 * 256 * 8 * itemsize


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel variant that runs for x (E,C,d) and w (E,d,f), by shape:

    * ``"skinny"``: bf16 or fp32 with C <= 16, d and f multiples of 8 and
      16-byte aligned x and w — every decode step of the model: each
      thread streams 8 columns of an expert's weights once, fp32 FMAs;
    * ``"wgmma"``: bf16 with C >= 64 and the same alignment (TMA's rules)
      — every prefill call of the model;
    * ``"wmma"``: any other bf16 call (16 < C < 64, unaligned shapes);
    * ``"fp32"``: any other float32 call, CUDA-core FMAs on 64 x 64 tiles.

    A choice by shape, not a fallback: a variant that fails raises."""
    mode = _mode(x, w)
    if mode == 3:
        return "skinny"
    if x.dtype != torch.bfloat16:
        return "fp32"
    return "wgmma" if mode == 2 else "wmma"


def _mode(x: torch.Tensor, w: torch.Tensor) -> int:
    """The entry point's mode: 3 = skinny, 2 = wgmma, 1 = wmma with 16-byte
    loads, 0 = wmma with 2-byte loads (or the fp32 tile kernel)."""
    C, d = x.shape[1], x.shape[2]
    aligned = (d % 8 == 0 and w.shape[2] % 8 == 0
               and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    if aligned and C <= SKINNY_MAX_ROWS and _skinny_smem(C, d, x.element_size()) <= MAX_SMEM:
        return 3
    if x.dtype != torch.bfloat16:
        return 0
    return 2 if aligned and C >= WGMMA_MIN_ROWS else int(aligned)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E,C,d) @ w (E,d,f) → (E,C,f) in x's dtype; rows ``>=
    group_sizes[e]`` (int32 (E,), on the device) are exactly zero, and
    ``None`` means every group is full."""
    tensors = dict(x=x, w=w)
    if group_sizes is not None:
        tensors["group_sizes"] = group_sizes
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"grouped_matmul: {name} must be on {x.device} "
                             f"(CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_matmul: {name} must be contiguous")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_matmul: x (E,C,d) and w (E,d,f) expected, "
                         f"got {tuple(x.shape)} / {tuple(w.shape)}")
    if x.dtype not in DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul: dtypes {x.dtype}/{w.dtype} "
                         f"unsupported (both float32 or both bfloat16)")
    E, C, d = x.shape
    f = w.shape[2]
    if group_sizes is not None and (group_sizes.dtype != torch.int32
                                    or group_sizes.shape != (E,)):
        raise ValueError(f"grouped_matmul: group_sizes must be int32 ({E},), "
                         f"got {group_sizes.dtype} {tuple(group_sizes.shape)}")
    y = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    mode = _mode(x, w)
    sizes_ptr = group_sizes.data_ptr() if group_sizes is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(x.data_ptr(), w.data_ptr(), sizes_ptr, y.data_ptr(),
                      E, C, d, f, DTYPE_CODE[x.dtype], mode, stream)
    return y
