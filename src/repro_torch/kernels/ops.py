"""Public kernel entry points: dispatch on the tensor's device.

A CPU tensor goes to the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor goes to the hand-written
CUDA kernel, whose build or launch failure raises.  There is no fallback
between the two (the JAX wrapper's interpret-mode fallback,
``repro/kernels/ops.py:77-80``, has no counterpart here).

Flash attention is differentiable, as the JAX wrapper's ``custom_vjp``
(``_flash_diff``, ``repro/kernels/ops.py:29-57``) makes it: the forward is
the kernel, the backward recomputes the plain version under autograd and
differentiates it (JAX, too, has no backward kernel: its ``_flash_bwd``
recomputes ``flash_attention_ref`` in XLA).  A forward run again by an
activation checkpoint launches the kernel again, and counts again.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import flash_attention as _flash
from . import grouped_matmul as _gmm
from . import paged_attention as _paged
from . import ref
from . import rglru_scan as _scan
from .build import CudaKernel

KERNELS: Dict[str, CudaKernel] = {
    "flash_attention": _flash.KERNEL,
    "paged_attention": _paged.KERNEL,
    "grouped_matmul": _gmm.KERNEL,
    "rglru_scan": _scan.KERNEL,
}


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must all be on the CPU or all on CUDA, "
                     f"got {sorted(devs)}")


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward with the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if _on_cpu(q, k, v):
            return ref.flash_attention_ref(q, k, v, causal=causal)
        return _flash.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_backward(*ctx.saved_tensors, g,
                                          causal=ctx.causal), None)


def flash_attention_backward(q, k, v, g, *, causal: bool = True):
    """(dq, dk, dv) of flash attention for the output cotangent ``g``: the
    plain version recomputed under autograd and differentiated.  One
    call's scores and probabilities live only until it returns."""
    with torch.enable_grad(), torch.profiler.record_function(
            "repro.flash_backward"):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref.flash_attention_ref(*ins, causal=causal)
        return torch.autograd.grad(out, ins, g)


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal (or full) GQA attention, head-major: q (B,H,Sq,hd), k/v
    (B,K,Sk,hd) → (B,H,Sq,hd) in q's dtype; differentiable in q, k, v."""
    return _FlashAttention.apply(q, k, v, causal)


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """One decode token per row against a paged KV pool: q (B,H,hd), pools
    (P,K,ps,hd), page_table (B,n_pp) int32, lengths (B,) int32 positions →
    (B,H,hd) in q's dtype."""
    if _on_cpu(q, k_pool, v_pool, page_table, lengths):
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    return _paged.paged_attention(q, k_pool, v_pool, page_table, lengths)


def grouped_matmul(x, w, group_sizes=None):
    """Per-group products x (E,C,d) @ w (E,d,f) → (E,C,f) in x's dtype,
    fp32 accumulation; rows ``>= group_sizes[e]`` (int32 (E,)) are exactly
    zero, ``None`` meaning every group is full."""
    tensors = (x, w) if group_sizes is None else (x, w, group_sizes)
    if _on_cpu(*tensors):
        return ref.grouped_matmul_ref(x, w, group_sizes)
    return _gmm.grouped_matmul(x, w, group_sizes)


def rglru_scan(a, b):
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` from a zero
    state: a, b (B,S,D) of one dtype → (B,S,D) in a's dtype, fp32 carry."""
    if _on_cpu(a, b):
        return ref.rglru_scan_ref(a, b)
    return _scan.rglru_scan(a, b)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
