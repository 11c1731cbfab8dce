"""CUDA flash-attention forward: the wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py:flash_attention`` (the Pallas
TPU kernel), a forward kernel, as the Pallas one is.  Asked for it
(``return_lse=True``, the training path), it also returns each query row's
log-sum-exp, from which the backward kernel
(:mod:`repro_torch.kernels.flash_attention_bwd`) computes the gradient.
q, k and v may be strided views (the model passes its
``(B, S, heads, hd)`` projections transposed, without a copy) as long as
the head dim is contiguous; the output is a new contiguous
``(B, H, Sq, hd)`` tensor.  bf16 runs on the tensor cores and reads q, k
and v through TMA, which needs 16-byte aligned bases and strides: the
wrapper raises on anything else rather than copying.  fp32 has no such
rule.  Callers go through
:func:`repro_torch.kernels.ops.flash_attention`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

KERNEL = CudaKernel(
    "flash_attention",
    "flash_attention.cu",
    "repro_flash_attention",
    [_P, _P, _P, _P, _P,  # q, k, v, out, lse (or null)
     _I, _I, _I, _I, _I, _I,  # B, H, K, Sq, Sk, hd
     _L, _L, _L, _L, _L, _L, _L, _L, _L,  # q/k/v strides (b, h, s)
     _I, ctypes.c_float, _I, _P],  # causal, scale, dtype, stream
)

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def work(B: int, H: int, K: int, Sq: int, Sk: int, hd: int, causal: bool,
         itemsize: int):
    """(FLOPs, bytes) of one call: q read and the output written once
    (B,H,Sq,hd), k and v read once (B,K,Sk,hd); two products of ``hd``
    (scores and values) for each scored (query, key) pair, where the
    causal mask, aligned top-left, lets query i score keys 0..i."""
    n = min(Sq, Sk)
    pairs = n * (n + 1) / 2 + (Sq - n) * Sk if causal else Sq * Sk
    return (4.0 * B * H * hd * pairs,
            float((2 * B * H * Sq + 2 * B * K * Sk) * hd * itemsize))


def tma_strides(t: torch.Tensor):
    """(b, h, s) strides of a (B, heads, S, hd) tensor, in elements.  A dim
    of size 1 is never stepped along, so its stride (whatever the view
    says) is replaced by the extent of the whole tensor: aligned, and past
    the other two."""
    span = max([t.shape[3]] + [t.stride(i) * t.shape[i] for i in range(3)
                               if t.shape[i] > 1])
    return tuple(t.stride(i) if t.shape[i] > 1 else span for i in range(3))


def check_qkv(who: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, **more: torch.Tensor):
    """Raise unless q (B,H,Sq,hd) and k, v (B,K,Sk,hd) are CUDA tensors of
    one supported dtype and head dim, K dividing H, each with a contiguous
    head dim (and, in bf16, TMA's 16-byte aligned base and strides); so
    must be each tensor of ``more`` (same dtype and device).  Returns
    (B, H, K, Sq, Sk, hd) and the (b, h, s) strides of q, k and v."""
    for name, t in dict(q=q, k=k, v=v, **more).items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{who}: {name} must be on {q.device} "
                             f"(CUDA), got {t.device}")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"{who}: {name} must be 4-D with a "
                             f"contiguous head dim, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.dtype != q.dtype:
            raise ValueError(f"{who}: dtypes differ ({name} {t.dtype}, q "
                             f"{q.dtype})")
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"{who}: dtype {q.dtype} unsupported "
                         f"(float32, bfloat16)")
    B, H, Sq, hd = q.shape
    _, K, Sk, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape
            or H % K):
        raise ValueError(f"{who}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not agree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{who}: head dim {hd} unsupported {HEAD_DIMS}")
    if Sk == 0 and B and H and Sq:
        raise ValueError(f"{who}: empty key sequence")
    strides = [tma_strides(t) for t in (q, k, v)]
    if q.dtype == torch.bfloat16:
        named = [(n, t, tma_strides(t)) for n, t in more.items()]
        for name, t, st in list(zip("qkv", (q, k, v), strides)) + named:
            if t.data_ptr() % 16 or any(x % 8 for x in st):
                raise ValueError(
                    f"{who}: bf16 {name} needs a 16-byte aligned "
                    f"base and strides that are multiples of 8 elements "
                    f"(TMA), got strides {t.stride()}")
    return (B, H, K, Sq, Sk, hd), strides


def launch_key(shape, causal: bool, dtype: torch.dtype) -> tuple:
    """The launch key of a call: (B, H, K, Sq, Sk, hd, causal, dtype)."""
    return (*shape, bool(causal), str(dtype).removeprefix("torch."))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """q (B,H,Sq,hd); k/v (B,K,Sk,hd), K dividing H.  Returns (B,H,Sq,hd)
    in q's dtype, and with ``return_lse`` also the fp32 (B,H,Sq)
    log-sum-exp of each row's scaled scores."""
    shape, strides = check_qkv("flash_attention", q, k, v)
    B, H, K, Sq, Sk, hd = shape
    out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B and H and Sq:
        scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            KERNEL.launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if return_lse else None,
                B, H, K, Sq, Sk, hd,
                *strides[0], *strides[1], *strides[2],
                int(causal), scale, DTYPE_CODE[q.dtype], stream,
                key=launch_key(shape, causal, q.dtype),
            )
    return (out, lse) if return_lse else out
