"""Mixture-of-Experts FFN (Qwen-MoE family), port of ``repro/models/moe.py``.

Routing is softmax top-k over the fp32 router logits, renormalised; the
dispatch is the JAX package's capacity-bounded scatter: each assignment's
position within its expert is an exclusive prefix count over the flattened
``(T·k)`` assignments in row order, the first ``capacity`` of an expert
are kept, and the rest go to an overflow bucket (row ``E`` of an
``(E+1, C, d)`` buffer) that is never computed.  The three expert products
are the JAX einsums, or — with ``use_kernels`` — the grouped-matmul kernel
(:func:`repro_torch.kernels.ops.grouped_matmul`), whose group sizes are
the kept counts per expert, computed on the device.  Rows past a group's
count are zero in the buffer, so both compute the same function.

The layer trains as JAX's does: the scatter into the buffer, the gather
of the expert outputs and the gates are differentiable, the grouped
matmul is an autograd function (its dx through the kernel), and the
Switch aux loss reaches the fp32 router through the softmax probs.  A
padded (dead) expert is never routed and gets a zero gradient.

Under a mesh whose ``"model"`` axis n > 1 divides the physical experts,
the layer is JAX's ``shard_map`` branch (expert parallelism): the tokens
(sharded over the batch axes only) and the router are replicated over
``"model"``; model rank r routes its rank's tokens over all experts,
dispatches to its experts ``[r·E/n, (r+1)·E/n)`` (the expert stacks are
DTensors, ``Shard(0)`` on ``"model"``: :func:`shard_expert_stacks`, or
this rank's experts already gathered over ``"data"`` from a state placed
by the rules, ``parallel.sharding.place_module``) at
the capacity of its own token count, applies them — through the
grouped-matmul kernel on the local ``(E/n, C, d)`` buffer with
``use_kernels`` — and the partial outputs are summed over ``"model"``.
The partials are summed in fp32 and rounded once, as one process's
``sum`` over the top-k rounds once.  The aux loss is averaged over
``"model"`` and then over the batch axes.  The gradients follow
``shard_map``'s transpose rules (:mod:`repro_torch.parallel.collectives`).
With a sharded batch the capacity and the aux loss are per batch shard,
so EP with a batch split is a function of the mesh, as in JAX.  The
layer never waits on the device: the capacity is a Python int from
shapes, and the dispatch is index arithmetic on device tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ArchConfig
from ..kernels import ops
from ..parallel.collectives import (mean_over_replicas, mean_over_shards,
                                    replicated_in, sum_out)
from ..parallel.mesh import (DATA, MODEL, POD, axis_group, axis_size,
                             model_shard)
from .layers import mlp_apply

EXPERT_STACKS = ("we_gate", "we_up", "we_down")


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Per-expert capacity of one call over ``n_tokens`` tokens — exactly
    ``moe.py:131``, with the logical expert count."""
    m = cfg.moe
    return max(int(n_tokens * m.top_k / m.n_experts * m.capacity_factor),
               m.top_k)


def route(router_w, x2d, n_experts: int, top_k: int):
    """Returns (gates (T,k), idx (T,k) int64, aux_loss scalar).  The router
    product runs in full fp32 (no TF32 on the card): a last-bit change of
    a logit can flip a top-k choice."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = x2d.float() @ router_w.float()  # (T, E)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    assign = F.one_hot(idx, n_experts).float().sum(dim=1)  # (T, E)
    ce = assign.mean(dim=0)
    aux = n_experts * (me * ce).sum()
    return gates, idx, aux


def dispatch_compute_combine(x2d, gates, idx, we_gate, we_up, we_down,
                             cap: int, *, use_kernels: bool,
                             e_base: Optional[int] = None):
    """Capacity-bounded scatter dispatch over the ``E`` experts held here,
    the SwiGLU expert products, and the gated combine.  x2d (T,d) →
    (T,d).  ``e_base`` None: every physical expert is here; else the
    stacks hold experts ``[e_base, e_base + E)``, the assignments to
    others are dropped (JAX's ``_dispatch_compute_combine``), and the
    partial top-k sum stays fp32 (the caller sums it over the ranks and
    rounds once)."""
    T, d = x2d.shape
    E = we_gate.shape[0]
    k = idx.shape[1]
    flat_idx = idx.reshape(-1)  # the (T·k) assignments in row order
    if e_base is not None:
        flat_idx = flat_idx - e_base
        owned = (flat_idx >= 0) & (flat_idx < E)
    # each expert's running count of its assignments: a scan along the
    # inner axis of an (E, T·k) one-hot.  The JAX layout, (T·k, E) scanned
    # along its outer axis, took torch's outer-axis scan kernel 3 ms per
    # layer at a 4096-token prefill on the H100 (launch/profile.py)
    hits = flat_idx[None, :] == torch.arange(E, device=idx.device)[:, None]
    running = hits.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
    at = flat_idx if e_base is None else flat_idx.clamp(0, E - 1)
    pos = running.gather(0, at[None, :])[0].long() - 1  # exclusive
    keep = pos < cap
    if e_base is not None:
        keep = keep & owned
    e_idx = torch.where(keep, flat_idx, E)  # overflow bucket E
    p_idx = torch.where(keep, pos, 0)
    buf = x2d.new_zeros((E + 1, cap, d))
    tok = x2d[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf[e_idx, p_idx] = tok  # kept slots are distinct; drops share row E
    h = buf[:E]  # (E, C, d), contiguous
    if use_kernels:
        # kept assignments of each expert: rows [0, size) of its buffer
        sizes = running[:, -1].clamp_max(cap)
        g = F.silu(ops.grouped_matmul(h, we_gate, sizes))
        u = ops.grouped_matmul(h, we_up, sizes)
        y = ops.grouped_matmul(g * u, we_down, sizes)
    else:
        g = F.silu(torch.einsum("ecd,edf->ecf", h, we_gate))
        u = torch.einsum("ecd,edf->ecf", h, we_up)
        y = torch.einsum("ecf,efd->ecd", g * u, we_down)  # (E, C, d)
    # combine: a dropped assignment gathers a clamped (in-range) row, as
    # JAX's gather clamps, and its zero weight removes it
    out_tok = y[e_idx.clamp_max(E - 1), p_idx]  # (T*k, d)
    out_tok = out_tok * (gates.reshape(-1, 1) * keep[:, None]).to(y.dtype)
    return out_tok.reshape(T, k, d).sum(
        dim=1, dtype=None if e_base is None else torch.float32)


def ep_size(cfg: ArchConfig, mesh) -> int:
    """The ``"model"`` axis size the experts shard over under ``mesh``:
    JAX's condition (size > 1 and dividing the physical experts), else 1
    (the one-process layer)."""
    if mesh is None:
        return 1
    n = axis_size(mesh, MODEL)
    return n if n > 1 and cfg.moe.n_physical % n == 0 else 1


def _ep_apply(params, x, cfg: ArchConfig, mesh, n: int, use_kernels: bool):
    """JAX's ``shard_map`` body and its collectives (see the module doc)."""
    m = cfg.moe
    d = x.shape[-1]
    model_group, _ = axis_group(mesh, (MODEL,))
    batch_group, nb = axis_group(mesh, (POD, DATA))
    e_loc = m.n_physical // n
    e_base = mesh.get_local_rank(MODEL) * e_loc
    x2d = replicated_in(x.reshape(-1, d), model_group)
    router = replicated_in(params["router"], model_group)
    gates, idx, aux = route(router, x2d, m.n_experts, m.top_k)
    wg, wu, wd = (_local(params[k]) for k in EXPERT_STACKS)
    part = dispatch_compute_combine(
        x2d, gates, idx, wg, wu, wd, capacity(x2d.shape[0], cfg),
        use_kernels=use_kernels, e_base=e_base)
    out = sum_out(part, model_group).to(x.dtype).reshape(x.shape)
    aux = mean_over_replicas(aux, model_group, n)
    return out, mean_over_shards(aux, batch_group, nb)


def _local(w):
    from torch.distributed.tensor import DTensor

    return w.to_local() if isinstance(w, DTensor) else w


def moe_apply(params, x, cfg: ArchConfig, *, use_kernels: bool = False,
              mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on (B, S, d) (this rank's rows under ``mesh``).  Returns
    (out, aux_loss)."""
    m = cfg.moe
    n = ep_size(cfg, mesh)
    if n > 1:
        out, aux = _ep_apply(params, x, cfg, mesh, n, use_kernels)
    else:
        d = x.shape[-1]
        x2d = x.reshape(-1, d)
        gates, idx, aux = route(params["router"], x2d, m.n_experts, m.top_k)
        out = dispatch_compute_combine(
            x2d, gates, idx, params["we_gate"], params["we_up"],
            params["we_down"], capacity(x2d.shape[0], cfg),
            use_kernels=use_kernels,
        ).reshape(x.shape)
    if m.n_shared_experts > 0:
        sh = params["shared"]
        tp = (model_shard(mesh) if sh["w_gate"].shape[-1]
              != m.d_ff_expert * m.n_shared_experts else None)
        out = out + mlp_apply(sh, x, tp)
    return out, aux


@torch.no_grad()
def shard_expert_stacks(module: nn.Module, cfg: ArchConfig, mesh) -> int:
    """Replace every MoE layer's expert stacks in ``module`` by DTensors,
    ``Shard(0)`` on ``"model"`` and replicated over the other mesh axes:
    this rank keeps only its own experts (a copy of its slice; the whole
    stacks are freed).  A no-op without EP under ``mesh``.  Returns the
    number of stacks replaced.  Each goes through
    ``parallel.sharding.place_param``, as every leaf of a state placed by
    the rules does."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import place_param

    if ep_size(cfg, mesh) == 1:
        return 0
    done = 0
    for name, p in list(module.named_parameters()):
        if name.rsplit(".", 1)[-1] in EXPERT_STACKS and not isinstance(
                p, DTensor):
            place_param(module, name, p, (MODEL,) + (None,) * (p.dim() - 1),
                        mesh, p.device)
            done += 1
    return done
