"""Public kernel entry points: dispatch on the tensor's device.

A CPU tensor goes to the kernel's plain PyTorch version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor goes to the hand-written
CUDA kernel, whose build or launch failure raises.  There is no fallback
between the two (the JAX wrapper's interpret-mode fallback,
``repro/kernels/ops.py:77-80``, has no counterpart here).

Three entry points are differentiable, each a ``torch.autograd.Function``
whose forward is the kernel (or, on the CPU, the plain version), so a
kernel's output never leaves autograd without a gradient:

* flash attention, as the JAX wrapper's ``custom_vjp`` (``_flash_diff``,
  ``repro/kernels/ops.py:29-57``) makes it differentiable: the forward
  saves q, k, v, its output and each row's log-sum-exp, and the backward
  is a kernel of its own on the card (``flash_attention_backward``, which
  the Pallas package lacks: JAX's ``_flash_bwd`` recomputes
  ``flash_attention_ref`` in XLA), its plain version written out in
  :func:`ref.flash_attention_backward_ref` on the CPU;
* the grouped matmul: dx is the same grouped product of the output
  cotangent with each group's transposed weights (the kernel again, on the
  card), dw one ``torch.bmm`` of x against the cotangent with the rows past
  each group zeroed (JAX differentiates its expert einsums in XLA,
  ``repro/models/moe.py:106-108``);
* the RG-LRU scan: its backward is the same linear recurrence run
  backwards in time, one launch of the scan kernel in reverse that reads
  a, the cotangent and the forward's output in place and writes ``da``
  and ``db`` (:func:`ref.rglru_scan_backward_ref` on the CPU).

A forward run again by an activation checkpoint launches its kernel
again, and counts again.  With no input that requires a gradient a
Function records no graph, so serving pays nothing for this.  Paged
decode has no gradient in either package: it raises when asked for one.

Inputs all on ``"meta"`` (the dry run's shape-only trace,
:mod:`repro_torch.launch.op_analysis`) take a third branch in flash
attention (forward and backward), the grouped matmul (forward and dx) and
the scan (forward and reverse): an empty ``"meta"`` output of the kernel's
shape and dtype, and one call in :data:`SHAPE_ONLY` under the kernel's
name with the FLOPs and bytes of its ``work`` formula (the one
``chip_smoke.py``'s bounds read).
A meta tensor holds no data, so nothing computed from it can reach a real
result: this is the kernel's shape, not a fallback.  Paged decode has no
such branch (no step the dry run traces decodes from pages).  Mixed
devices raise.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import flash_attention as _flash
from . import flash_attention_bwd as _flash_bwd
from . import grouped_matmul as _gmm
from . import paged_attention as _paged
from . import ref
from . import rglru_scan as _scan
from .build import CudaKernel

KERNELS: Dict[str, CudaKernel] = {
    "flash_attention": _flash.KERNEL,
    "flash_attention_backward": _flash_bwd.KERNEL,
    "paged_attention": _paged.KERNEL,
    "grouped_matmul": _gmm.KERNEL,
    "rglru_scan": _scan.KERNEL,
}


#: shape-only calls by kernel name since the last
#: :func:`reset_shape_only`: ``{"calls", "flops", "bytes"}`` of the
#: launches they stand for.  Never :attr:`CudaKernel.launches`, which
#: counts the card's real launches only.
SHAPE_ONLY: Dict[str, Dict[str, float]] = {}


def reset_shape_only() -> None:
    SHAPE_ONLY.clear()
    SHAPE_ONLY.update({name: {"calls": 0, "flops": 0.0, "bytes": 0.0}
                       for name in KERNELS})


reset_shape_only()


def _device_type(*tensors) -> str:
    """``"cpu"``, ``"cuda"`` or ``"meta"``: the one device type of a
    kernel's inputs.  Mixed devices raise."""
    devs = {t.device.type for t in tensors}
    if len(devs) == 1 and devs <= {"cpu", "cuda", "meta"}:
        return devs.pop()
    raise ValueError(f"kernel inputs must all be on the CPU, all on CUDA or "
                     f"all on meta, got {sorted(devs)}")


def _shape_only(name: str, out: torch.Tensor, work) -> torch.Tensor:
    """Record one shape-only call of kernel ``name`` doing ``work``
    (FLOPs, bytes) and return its empty meta output ``out``."""
    rec = SHAPE_ONLY[name]
    rec["calls"] += 1
    rec["flops"] += work[0]
    rec["bytes"] += work[1]
    return out


def _flash_forward(q, k, v, causal: bool, lse: bool):
    """The forward's output, and with ``lse`` also each row's fp32
    log-sum-exp (the backward's input)."""
    where = _device_type(q, k, v)
    if where == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=lse)
    if where == "meta":
        B, H, Sq, hd = q.shape
        out = _shape_only(
            "flash_attention",
            torch.empty((B, H, Sq, hd), dtype=q.dtype, device="meta"),
            _flash.work(B, H, k.shape[1], Sq, k.shape[2], hd, causal,
                        q.element_size()))
        return (out, torch.empty((B, H, Sq), dtype=torch.float32,
                                 device="meta")) if lse else out
    return _flash.flash_attention(q, k, v, causal=causal, return_lse=lse)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward with the flash backward kernel as its
    gradient.  With no input that needs a gradient (serving, prefill) the
    forward writes no log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, need_grad: bool):
        ctx.causal = causal
        if not need_grad:
            return _flash_forward(q, k, v, causal, False)
        out, lse = _flash_forward(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*flash_attention_backward(*ctx.saved_tensors, g,
                                          causal=ctx.causal), None, None)


def flash_attention_backward(q, k, v, o, lse, g, *, causal: bool = True):
    """(dq, dk, dv) of flash attention for the cotangent ``g`` of its output
    ``o``, from the forward's log-sum-exp ``lse``: the backward kernel on
    the card, :func:`ref.flash_attention_backward_ref` on the CPU, a
    shape-only call on ``"meta"``."""
    with torch.profiler.record_function("repro.flash_backward"):
        where = _device_type(q, k, v, o, lse, g)
        if where == "cpu":
            return ref.flash_attention_backward_ref(q, k, v, o, lse, g,
                                                    causal=causal)
        if where == "meta":
            B, H, Sq, hd = q.shape
            K, Sk = k.shape[1], k.shape[2]
            dq = _shape_only(
                "flash_attention_backward",
                torch.empty(q.shape, dtype=q.dtype, device="meta"),
                _flash_bwd.work(B, H, K, Sq, Sk, hd, causal,
                                q.element_size()))
            return (dq, torch.empty(k.shape, dtype=q.dtype, device="meta"),
                    torch.empty(k.shape, dtype=q.dtype, device="meta"))
        return _flash_bwd.flash_attention_backward(q, k, v, o, lse, g,
                                                   causal=causal)


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal (or full) GQA attention, head-major: q (B,H,Sq,hd), k/v
    (B,K,Sk,hd) → (B,H,Sq,hd) in q's dtype; differentiable in q, k, v."""
    need = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, need)


def paged_attention(q, k_pool, v_pool, page_table, lengths):
    """One decode token per row against a paged KV pool: q (B,H,hd), pools
    (P,K,ps,hd), page_table (B,n_pp) int32, lengths (B,) int32 positions →
    (B,H,hd) in q's dtype.  Not differentiable: it raises when grad mode
    is on and an input requires a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pool, v_pool)):
        raise RuntimeError("paged_attention has no gradient (decode only, in "
                           "either package); call it under torch.no_grad()")
    where = _device_type(q, k_pool, v_pool, page_table, lengths)
    if where == "meta":
        raise ValueError("paged_attention has no shape-only branch: no step "
                         "the dry run traces decodes from pages")
    if where == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, lengths)
    return _paged.paged_attention(q, k_pool, v_pool, page_table, lengths)


def _grouped_matmul(x, w, group_sizes):
    tensors = (x, w) if group_sizes is None else (x, w, group_sizes)
    where = _device_type(*tensors)
    if where == "cpu":
        return ref.grouped_matmul_ref(x, w, group_sizes)
    if where == "meta":
        (E, C, d), f = x.shape, w.shape[2]
        return _shape_only(
            "grouped_matmul",
            torch.empty((E, C, f), dtype=x.dtype, device="meta"),
            _gmm.work(E, C, d, f, x.element_size(),
                      sized=group_sizes is not None))
    return _gmm.grouped_matmul(x, w, group_sizes)


class _GroupedMatmul(torch.autograd.Function):
    """The grouped-matmul kernel with its gradient
    (:func:`grouped_matmul_backward`)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _grouped_matmul(x, w, group_sizes)

    @staticmethod
    def backward(ctx, g):
        x, w, sizes = ctx.saved_tensors
        return (*grouped_matmul_backward(x, w, sizes, g,
                                         need=ctx.needs_input_grad[:2]), None)


def grouped_matmul_backward(x, w, group_sizes, g, *, need=(True, True)):
    """(dx, dw) of the grouped matmul for the output cotangent ``g`` (each
    ``None`` where ``need`` says so).  The rows at and past a group's size
    are the constant 0 in the output, so their cotangent is zeroed first;
    then dx is the same grouped product with each group's weights
    transposed (the kernel, on the card: one launch, and a transposed copy
    of w) and dw one ``torch.bmm`` of x's transpose against it."""
    with torch.profiler.record_function("repro.gmm_backward"):
        g = g.to(x.dtype)
        if group_sizes is not None:
            live = (torch.arange(g.shape[1], device=g.device)[None, :]
                    < group_sizes[:, None])
            g = torch.where(live[..., None], g,
                            torch.zeros((), dtype=g.dtype, device=g.device))
        g = g.contiguous()
        dx = dw = None
        if need[0]:
            dx = _grouped_matmul(g, w.transpose(1, 2).contiguous(),
                                 group_sizes)
        if need[1]:
            dw = torch.bmm(x.transpose(1, 2), g).to(w.dtype)
        return dx, dw


def grouped_matmul(x, w, group_sizes=None):
    """Per-group products x (E,C,d) @ w (E,d,f) → (E,C,f) in x's dtype,
    fp32 accumulation; rows ``>= group_sizes[e]`` (int32 (E,)) are exactly
    zero, ``None`` meaning every group is full.  Differentiable in x and
    w."""
    return _GroupedMatmul.apply(x, w, group_sizes)


def _rglru_scan(a, b):
    where = _device_type(a, b)
    if where == "cpu":
        return ref.rglru_scan_ref(a, b)
    if where == "meta":
        return _shape_only(
            "rglru_scan",
            torch.empty(a.shape, dtype=a.dtype, device="meta"),
            _scan.work(*a.shape, a.element_size()))
    return _scan.rglru_scan(a, b)


class _RGLRUScan(torch.autograd.Function):
    """The scan kernel with its gradient (:func:`rglru_scan_backward`)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        return rglru_scan_backward(*ctx.saved_tensors, g)


def rglru_scan_backward(a, h, g):
    """(da, db) of the scan ``h = rglru_scan(a, b)`` for the cotangent
    ``g`` of h: ``dh_t = g_t + a_{t+1}·dh_{t+1}`` walked backwards in time,
    ``db = dh`` and ``da_t = dh_t·h_{t-1}`` with ``h_0 = 0``.  On the card
    one launch of the scan kernel run in reverse, reading a, g and h in
    place; on the CPU :func:`ref.rglru_scan_backward_ref`; on ``"meta"`` a
    shape-only call of the reverse launch's work."""
    with torch.profiler.record_function("repro.scan_backward"):
        where = _device_type(a, h, g)
        if where == "cpu":
            return ref.rglru_scan_backward_ref(a, h, g)
        if where == "meta":
            da = _shape_only(
                "rglru_scan",
                torch.empty(a.shape, dtype=a.dtype, device="meta"),
                _scan.work(*a.shape, a.element_size(), reverse=True))
            return da, torch.empty(a.shape, dtype=a.dtype, device="meta")
        return _scan.rglru_scan_backward(a, h,
                                         g.to(a.dtype).contiguous())


def rglru_scan(a, b):
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t`` from a zero
    state: a, b (B,S,D) of one dtype → (B,S,D) in a's dtype, fp32 carry.
    Differentiable in a and b."""
    return _RGLRUScan.apply(a, b)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def launch_keys() -> Dict[str, Dict[tuple, int]]:
    """Each kernel's launches by the key its wrapper names: flash's and
    its backward's (B, H, K, Sq, Sk, hd, causal, dtype), the scan's
    (B, S, D, dtype, reverse); empty for the other kernels."""
    return {name: dict(k.by_key) for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.by_key.clear()
