"""CUDA flash-attention backward: the wrapper of
``csrc/flash_attention_bwd.cu``.

Replaces no TPU kernel (the Pallas package has no backward; JAX's
``_flash_bwd``, ``repro/kernels/ops.py``, recomputes its oracle in XLA):
it computes (dq, dk, dv) of flash attention from q, k, v, the forward's
output and log-sum-exp, and the output cotangent, without the plain
recompute's (B, H, Sq, Sk) score matrices.  q, k and v are the tensors the
forward took (strided views allowed, as there); the cotangent is made
contiguous when it is not (autograd may hand a strided one), the output
is the forward's own contiguous tensor.  The gradients are new contiguous
tensors in q's dtype, which the cotangent must have too.  bf16 reads
through TMA, which needs 16-byte aligned bases and strides: the wrapper
raises on anything else rather than copying.  Callers go through
:func:`repro_torch.kernels.ops.flash_attention_backward`.
"""

from __future__ import annotations

import ctypes
import math
import torch

from .build import CudaKernel
from .flash_attention import DTYPE_CODE, check_qkv, launch_key

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

KERNEL = CudaKernel(
    "flash_attention_backward",
    "flash_attention_bwd.cu",
    "repro_flash_attention_bwd",
    [_P, _P, _P, _P, _P, _P, _P,  # q, k, v, o, dout, lse, D scratch
     _P, _P, _P,  # dq, dk, dv
     _I, _I, _I, _I, _I, _I,  # B, H, K, Sq, Sk, hd
     _L, _L, _L, _L, _L, _L, _L, _L, _L,  # q/k/v strides (b, h, s)
     _I, ctypes.c_float, _I, _P],  # causal, scale, dtype, stream
)


def work(B: int, H: int, K: int, Sq: int, Sk: int, hd: int, causal: bool,
         itemsize: int):
    """(FLOPs, bytes) of one call: five products of ``hd`` for each scored
    (query, key) pair (the scores, dV, dP, dQ and dK; the causal mask,
    aligned top-left, lets query i score keys 0..i), q, o and dO read and
    dq written (B,H,Sq,hd), k and v read and dk and dv written
    (B,K,Sk,hd), and the fp32 log-sum-exp (B,H,Sq) read, each once."""
    n = min(Sq, Sk)
    pairs = n * (n + 1) / 2 + (Sq - n) * Sk if causal else Sq * Sk
    return (10.0 * B * H * hd * pairs,
            float((4 * B * H * Sq + 4 * B * K * Sk) * hd * itemsize
                  + 4 * B * H * Sq))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True):
    """q (B,H,Sq,hd), k/v (B,K,Sk,hd), the forward's output o (B,H,Sq,hd,
    contiguous) and fp32 log-sum-exp lse (B,H,Sq), the cotangent do of o.
    The scale is the forward's, 1/sqrt(hd).  Returns (dq, dk, dv) in q's
    dtype."""
    if not do.is_contiguous() or do.data_ptr() % 16:
        do = do.clone(memory_format=torch.contiguous_format)
    shape, strides = check_qkv("flash_attention_backward", q, k, v, o=o,
                               do=do)
    B, H, K, Sq, Sk, hd = shape
    if not o.is_contiguous() or o.shape != q.shape:
        raise ValueError("flash_attention_backward: o must be the forward's "
                         "contiguous (B, H, Sq, hd) output")
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_backward: lse must be contiguous "
                         f"fp32 {(B, H, Sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, K, Sk, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if not (B and H and Sq):
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, K, Sq, Sk, hd,
            *strides[0], *strides[1], *strides[2],
            int(causal), scale, DTYPE_CODE[q.dtype], stream,
            key=launch_key(shape, causal, q.dtype),
        )
    return dq, dk, dv
