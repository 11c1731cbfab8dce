"""CUDA paged-decode attention: the wrapper of ``csrc/paged_attention.cu``.

Replaces ``repro/kernels/paged_attention.py:paged_attention`` (the Pallas TPU
kernel).  The wrapper checks what the kernel takes, allocates the output
with ``torch.empty`` and launches on the current CUDA stream; the kernel
is built at first use (:mod:`repro_torch.kernels.build`).  Callers go
through :func:`repro_torch.kernels.ops.paged_attention`, which sends CPU
tensors to the plain version instead.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

KERNEL = CudaKernel(
    "paged_attention",
    "paged_attention.cu",
    "repro_paged_attention",
    [_P, _P, _P, _P, _P, _P,  # q, k_pool, v_pool, table, lengths, out
     _I, _I, _I, _I, _I, _I, _I,  # B, H, K, hd, ps, n_pp, P
     ctypes.c_float, _I, _I, _P],  # scale, q dtype, kv dtype, stream
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,hd); pools (P,K,ps,hd); page_table (B,n_pp) int32; lengths
    (B,) int32 decode positions.  Returns (B,H,hd) in q's dtype."""
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, page_table=page_table,
                   lengths=lengths)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be on {q.device} "
                             f"(CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"paged_attention: q (B,H,hd) and pools (P,K,ps,hd) "
                         f"expected, got {tuple(q.shape)} / "
                         f"{tuple(k_pool.shape)}")
    B, H, hd = q.shape
    P, K, ps, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or H % K:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k_pool.shape)} v {tuple(v_pool.shape)} "
                         f"do not agree (H % K == 0, same hd)")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_attention: page_table must be (B={B}, n_pp), "
                         f"got {tuple(page_table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"paged_attention: lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and lengths must be "
                         "int32")
    if q.dtype not in DTYPE_CODE or k_pool.dtype not in DTYPE_CODE:
        raise ValueError(f"paged_attention: dtypes {q.dtype}/{k_pool.dtype} "
                         f"unsupported (float32, bfloat16)")
    if v_pool.dtype != k_pool.dtype:
        raise ValueError("paged_attention: k_pool and v_pool dtypes differ")
    n_pp = page_table.shape[1]
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, K, hd, ps, n_pp, P, scale,
            DTYPE_CODE[q.dtype], DTYPE_CODE[k_pool.dtype], stream,
        )
    return out
