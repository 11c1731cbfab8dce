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

Under a mesh the layer takes JAX's two branches (``moe.py:137-176``):

* **Expert parallelism** — the ``"model"`` axis n > 1 divides the
  physical experts (whatever ``shard_experts`` says): JAX's ``shard_map``
  branch.  The tokens (sharded over the batch axes only) and the router
  are replicated over ``"model"``; model rank r routes its rank's tokens
  over all experts, dispatches to its experts ``[r·E/n, (r+1)·E/n)`` at
  the capacity of its own token count, applies them — through the
  grouped-matmul kernel on the local ``(E/n, C, d)`` buffer with
  ``use_kernels`` — and the partial outputs are summed over ``"model"``,
  in fp32 and rounded once, as one process's ``sum`` over the top-k
  rounds once.  The expert stacks are DTensors ``Shard(0)`` on
  ``"model"`` (:func:`shard_expert_stacks`, or the rules' placement);
  stacks the rules split on their hidden dim (``shard_experts=False``)
  or leave whole are re-laid into this rank's whole experts first, as
  GSPMD reshards them to the ``shard_map``'s specs (a gather over
  ``"model"`` whose gradient reduce-scatters back).  The aux loss is
  averaged over ``"model"`` and then over the batch axes.  With a split
  batch the capacity and the aux loss are per batch shard, as in JAX.
* **The global batch** — no EP (the axis does not divide the experts):
  JAX runs the layer on the global arrays.  Each rank routes its own
  tokens; the capacity is that of the global token count, and an
  assignment's position within its expert is global: each rank
  all-gathers the per-expert counts of its assignments over the batch
  axes (E ints) and offsets its positions by the counts of the ranks
  before it (JAX's global rows are batch-rank-major), so its buffer
  holds only its own kept rows and no rank needs another's tokens.  The
  aux loss is the global batch's: the per-expert sums of the probs and
  assignments are all-reduced (:func:`~repro_torch.parallel.collectives.
  sum_over_shards`, whose gradient comes through the data-parallel mean
  whole).  Stacks split on their hidden dim over ``"model"`` (the rules'
  fallback with ``shard_experts=False``: qwen2-moe's paper baseline) are
  tensor-parallel: every model rank routes alike, computes its block of
  every expert's hidden dim (the grouped matmul at f / n columns), and
  the fp32 partial outputs are summed over ``"model"``; the router enters
  through ``replicated_in`` and the aux loss through
  ``mean_over_replicas``.

Under Megatron-SP (``tp.seq``) the input arrives gathered over the
sequence, and the partial outputs are reduce-scattered onto this rank's
positions instead (``collectives.tp_out``); a part every model rank
computes whole (stacks or a shared SwiGLU the rules leave replicated)
takes its leaves through ``replicated_in`` and keeps its own positions.
The gradients follow ``shard_map``'s transpose rules
(:mod:`repro_torch.parallel.collectives`).  The layer never waits on the
device: the capacity is a Python int from shapes, and the dispatch is
index arithmetic on device tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ArchConfig
from ..kernels import ops
from ..parallel.collectives import (all_gather_cat, all_reduce_,
                                    gather_shards, mean_over_replicas,
                                    mean_over_shards, replicated_in,
                                    sum_over_shards, tp_in, tp_out)
from ..parallel.mesh import DATA, MODEL, POD, axis_group, axis_size
from ..parallel.mesh import model_shard as _model_shard
from .layers import mlp_apply

EXPERT_STACKS = ("we_gate", "we_up", "we_down")


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Per-expert capacity of one call over ``n_tokens`` tokens — exactly
    ``moe.py:131``, with the logical expert count."""
    m = cfg.moe
    return max(int(n_tokens * m.top_k / m.n_experts * m.capacity_factor),
               m.top_k)


def route(router_w, x2d, n_experts: int, top_k: int, batch=None):
    """Returns (gates (T,k), idx (T,k) int64, aux_loss scalar).  The router
    product runs in full fp32 (no TF32 on the card): a last-bit change of
    a logit can flip a top-k choice.  ``batch``: (group, size) of the
    batch axes when the aux loss is the global batch's (each rank's
    per-expert sums all-reduced; see the module doc)."""
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
    assign = F.one_hot(idx, n_experts).float().sum(dim=1)  # (T, E)
    if batch is None or batch[0] is None:
        me, ce = probs.mean(dim=0), assign.mean(dim=0)
    else:
        group, nb = batch
        T = x2d.shape[0] * nb
        me = sum_over_shards(probs.sum(dim=0), group, nb) / T
        ce = all_reduce_(assign.sum(dim=0), group) / T
    aux = n_experts * (me * ce).sum()
    return gates, idx, aux


def dispatch_compute_combine(x2d, gates, idx, we_gate, we_up, we_down,
                             cap: int, *, use_kernels: bool,
                             e_base: Optional[int] = None, batch=None,
                             partial: bool = False):
    """Capacity-bounded scatter dispatch over the ``E`` experts held here,
    the SwiGLU expert products, and the gated combine.  x2d (T,d) →
    (T,d).  ``e_base`` None: every physical expert is here; else the
    stacks hold experts ``[e_base, e_base + E)`` and the assignments to
    others are dropped (JAX's ``_dispatch_compute_combine``).  ``batch``
    (a process group): the tokens are this rank's of a global batch split
    over the group: each expert's count of assignments is all-gathered,
    an assignment's global position is offset by the counts of the ranks
    before this one, it is kept while that is below ``cap``, and the
    buffer holds this rank's kept rows only, ``min(cap, T)`` of them (an
    expert takes a token at most once).  The top-k sum of a partial
    output (``e_base`` given, or ``partial``: a block of the hidden dim)
    stays fp32: the caller sums it over the ranks and rounds once."""
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
    rows, count = cap, running[:, -1]
    if batch is None:
        keep = pos < cap
        sizes = count.clamp_max(cap)
    else:  # the ranks before this one hold the first global positions
        every = all_gather_cat(count[None], batch)
        offset = every[:torch.distributed.get_rank(batch)].sum(
            dim=0, dtype=torch.int32)
        keep = pos + offset[at] < cap
        rows = min(cap, T)
        sizes = torch.minimum(count, (cap - offset).clamp_min(0))
    if e_base is not None:
        keep = keep & owned
    e_idx = torch.where(keep, flat_idx, E)  # overflow bucket E
    p_idx = torch.where(keep, pos, 0)
    buf = x2d.new_zeros((E + 1, rows, d))
    tok = x2d[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf[e_idx, p_idx] = tok  # kept slots are distinct; drops share row E
    h = buf[:E]  # (E, C, d), contiguous
    if use_kernels:
        # kept assignments of each expert: rows [0, size) of its buffer
        sizes = sizes.to(torch.int32)
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
    partial = partial or e_base is not None
    return out_tok.reshape(T, k, d).sum(
        dim=1, dtype=torch.float32 if partial else None)


def ep_size(cfg: ArchConfig, mesh) -> int:
    """The ``"model"`` axis size the experts shard over under ``mesh``:
    JAX's condition (size > 1 and dividing the physical experts), else 1
    (the global-batch layer)."""
    if mesh is None:
        return 1
    n = axis_size(mesh, MODEL)
    return n if n > 1 and cfg.moe.n_physical % n == 0 else 1


def _hidden_split(params, cfg: ArchConfig) -> bool:
    """Whether the expert stacks hold a block of their hidden dim (the
    rules' TP fallback under ``shard_experts=False``)."""
    return _local(params["we_gate"]).shape[2] != cfg.moe.d_ff_expert


def _rank_experts(w, name: str, cfg: ArchConfig, tp, e_base: int,
                  e_loc: int):
    """This rank's whole experts ``[e_base, e_base + e_loc)`` of an expert
    stack: as held when the stack is split over ``"model"`` on its
    experts; else re-laid (GSPMD's reshard to the ``shard_map``'s specs):
    a stack split on its hidden dim gathered over ``"model"`` (the
    gradient reduce-scatters back onto this rank's block), a whole stack
    entering through ``replicated_in``, then sliced."""
    w = _local(w)
    if w.shape[0] == e_loc:
        return w
    hid = 1 if name == "we_down" else 2
    if w.shape[hid] != cfg.moe.d_ff_expert:
        w = gather_shards(w, tp.group, hid)
    else:
        w = replicated_in(w, tp.group)
    return w[e_base:e_base + e_loc]


def _ep_apply(params, x, cfg: ArchConfig, mesh, tp, use_kernels: bool):
    """JAX's ``shard_map`` body and its collectives (see the module doc)."""
    m = cfg.moe
    d = x.shape[-1]
    batch_group, nb = axis_group(mesh, (POD, DATA))
    e_loc = m.n_physical // tp.n
    e_base = tp.rank * e_loc
    x2d = tp_in(x, tp).reshape(-1, d)
    router = replicated_in(params["router"], tp.group)
    gates, idx, aux = route(router, x2d, m.n_experts, m.top_k)
    wg, wu, wd = (_rank_experts(params[k], k, cfg, tp, e_base, e_loc)
                  for k in EXPERT_STACKS)
    part = dispatch_compute_combine(
        x2d, gates, idx, wg, wu, wd, capacity(x2d.shape[0], cfg),
        use_kernels=use_kernels, e_base=e_base)
    out = tp_out(part.reshape(x.shape), tp).to(x.dtype)
    aux = mean_over_replicas(aux, tp.group, tp.n)
    return out, mean_over_shards(aux, batch_group, nb)


def _global_apply(params, x, cfg: ArchConfig, mesh, tp, use_kernels: bool):
    """JAX's layer on the global arrays, this rank's tokens of them (see
    the module doc)."""
    m = cfg.moe
    d = x.shape[-1]
    batch_group, nb = axis_group(mesh, (POD, DATA))
    split = tp is not None and _hidden_split(params, cfg)
    whole = tp is not None and tp.seq and not split
    names = ("router",) + EXPERT_STACKS
    leaves = {k: _local(params[k]) for k in names}
    if split or whole:  # every model rank routes alike
        leaves = {k: (replicated_in(w, tp.group) if whole or k == "router"
                      else w) for k, w in leaves.items()}
    x2d = (tp_in(x, tp) if split else x).reshape(-1, d)
    T = x2d.shape[0]
    gates, idx, aux = route(leaves["router"], x2d, m.n_experts, m.top_k,
                            (batch_group, nb))
    out = dispatch_compute_combine(
        x2d, gates, idx, leaves["we_gate"], leaves["we_up"],
        leaves["we_down"], capacity(T * nb, cfg), use_kernels=use_kernels,
        batch=batch_group, partial=split).reshape(x.shape)
    if split:
        out = tp_out(out, tp).to(x.dtype)
    elif whole:
        out = tp.own_positions(out)
    if split or whole:
        aux = mean_over_replicas(aux, tp.group, tp.n)
    return out, aux


def _local(w):
    from torch.distributed.tensor import DTensor

    return w.to_local() if isinstance(w, DTensor) else w


def moe_apply(params, x, cfg: ArchConfig, *, use_kernels: bool = False,
              mesh=None, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on (B, S, d) (this rank's rows under ``mesh``; under
    Megatron-SP the sequence gathered whole).  ``tp``: this rank's
    :class:`~repro_torch.parallel.mesh.ModelShard` (its ``seq`` marks SP;
    by default ``mesh``'s).  Returns (out, aux_loss); under SP ``out``
    holds this rank's positions."""
    m = cfg.moe
    tp = _model_shard(mesh) if tp is None else tp
    if ep_size(cfg, mesh) > 1:
        out, aux = _ep_apply(params, x, cfg, mesh, tp, use_kernels)
    else:
        out, aux = _global_apply(params, x, cfg, mesh, tp, use_kernels)
    if m.n_shared_experts > 0:
        sh = params["shared"]
        if sh["w_gate"].shape[-1] != m.d_ff_expert * m.n_shared_experts:
            out = out + mlp_apply(sh, x, tp)
        elif tp is not None and tp.seq:  # replicated: whole on every rank
            sh = {k: replicated_in(sh[k], tp.group)
                  for k in ("w_gate", "w_up", "w_down")}
            out = out + tp.own_positions(mlp_apply(sh, x))
        else:
            out = out + mlp_apply(sh, x)
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
