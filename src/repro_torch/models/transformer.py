"""Decoder-only transformer for the serving slices (port of
``repro/models/transformer.py``).

A layer is a sequence mixer followed by an FFN (none in xLSTM).  The
mixer's kind comes from the block pattern — ``attn`` (full causal attention over the paged
KV pools, or a per-slot slab), ``local_attn`` (sliding-window attention
with a circular per-slot buffer), ``rglru`` (Griffin's recurrent block) or
``mlstm``/``slstm`` (xLSTM's cells; both in
:mod:`repro_torch.models.recurrent`) — so dense decoders such as qwen3,
MoE decoders such as qwen2-moe (whose FFN is
:func:`repro_torch.models.moe.moe_apply`), the hybrid recurrentgemma, the
ssm xlstm (no FFN: ``d_ff`` 0, so a layer is norm + mixer, as JAX's
``_has_ffn`` has it) and the VLM backbone of pixtral (its stub patch
embeddings prepended to the token stream, as JAX's ``_embed`` does) run on
one stack.  With kernels
off attention takes the JAX decoder's impl, ``"chunked"``.  The JAX package runs ``n_layers % len(pattern)``
remainder layers first and then scans over layer groups stacked on a
leading axis; here each layer is its own :class:`Block` in a
``ModuleList`` in that order (layer ``i`` has kind ``pattern[i]`` for
``i < n_rem``, else ``pattern[(i - n_rem) % len(pattern)]``), the scan is
a Python loop, and :mod:`repro_torch.bridge` unstacks the group axis.
Parameter names follow the JAX leaves (``norm1.scale``, ``mix.wq``,
``mix.rglru.lam``, ``ffn.w_gate``, ``ffn.we_up``, ``ffn.shared.w_down``,
...), held in ``nn.ParameterDict``s (or, where leaves nest,
:class:`Leaves`) that the functional layers index exactly like the JAX
param dicts.

Precision policy: the JAX model keeps params in ``param_dtype`` and casts
the decoder's to ``compute_dtype`` on every call (``cast_floats``).  A
serving model (the default) creates each parameter in the dtype it
computes with and casts once, at load (:meth:`Transformer.load_state`) —
the same arithmetic without a cast per call.  A model built with
``train=True`` holds every parameter in ``param_dtype`` with
``requires_grad`` (the fp32 masters the optimizer updates) and casts each
layer's leaves inside the forward (:func:`cast_leaves`, under the layer's
activation checkpoint), so the gradients land on the fp32 leaves, as
JAX's do.  :meth:`Transformer.loss` is the training objective: the
decoder under ``ShardingConfig.remat`` (``"block"``: each pattern
repetition recomputed in backward; ``"sqrt"``: JAX's two-level scheme) and
:func:`chunked_xent`, plus the MoE router's load-balance loss summed over
the layers (``router_aux_weight`` times it, as JAX's); it trains every
family of the stack — dense, MoE, hybrid and VLM.  With kernels on, the
grouped matmul and the RG-LRU scan run forward, in remat recompute and in
backward through their autograd functions (:mod:`repro_torch.kernels.ops`).
In a serving model ``final_norm`` stays in
``param_dtype``, as in JAX; the embedding table and the head are held in
``compute_dtype`` (JAX casts the looked-up rows and the head at use — the
same values).  The MoE router and the RG-LRU's ``lam`` stay fp32 whatever
the policy, as JAX keeps them (``layers.py`` ``_KEEP_F32``).  The RG-LRU
gate matrices ``w_r``/``w_i`` are cast to ``compute_dtype`` by JAX and
widened to fp32 at every use (``_rglru_gates``); the port holds them in
fp32 with the compute dtype's values (:data:`WIDENED`), rounded once at
load — the same products, for 2 × 4 bytes instead of 2 × 2 per element
(+1.7 GB at recurrentgemma-9b's full width) and no cast per call.  A
training model holds them in ``param_dtype``, as JAX's params hold them,
and widens them per call.

A model placed by the sharding rules (``parallel.sharding.place_module``:
every parameter a DTensor holding this rank's block) runs under its
``mesh``: each layer's leaves are gathered over their data axes just
before the layer uses them (:func:`local_leaves`, inside the layer's
activation checkpoint, so the gather runs again in recompute and its
gradient reduce-scatters), and the ``"model"`` split stays: attention
(windowed too), the SwiGLU, the Griffin block and the xLSTM cells are
tensor-parallel (:mod:`repro_torch.models.attention`,
``layers.mlp_apply``, :mod:`repro_torch.models.recurrent`), the
embedding, the head and :func:`chunked_xent`
vocab-parallel, and the logits of a prefill or a decode step are
all-gathered over ``"model"``.  Whether a layer is tensor-parallel is
read from its local shapes, so an unplaced model under a mesh (the
expert parallelism of ``train(mesh=)``) computes as before.  With
``ShardingConfig.seq_parallel`` a training forward runs Megatron-SP where
JAX's does (:func:`seq_parallel_on`): the residual stream between the
pattern groups, and so each checkpointed group's input, holds this rank's
block of positions (see :meth:`Decoder.forward` and :func:`_sublayer`).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ArchConfig, ShardingConfig
from ..parallel.collectives import (all_gather_cat, gather_alike,
                                    gather_shards, max_over, replicated_in,
                                    sum_out, take_shard)
from ..parallel.mesh import MODEL, axis_size, model_shard
from ..parallel.sharding import gather_data
from .attention import (attn_apply, attn_decode, attn_prefill_chunk,
                        page_slots, tp_sharded)
from .layers import dtype_of, embed_lookup, mlp_apply, rmsnorm
from .moe import moe_apply
from .paging import paginate_cache
from .recurrent import (RGLRU_C, _griffin_tp, _xlstm_heads,
                        griffin_block_apply, griffin_block_decode,
                        griffin_state_init, mlstm_apply, mlstm_decode,
                        mlstm_state_init, slstm_apply, slstm_decode,
                        slstm_state_init)

KINDS = ("attn", "local_attn", "rglru", "mlstm", "slstm")  # mixing kinds
#: leaves held in fp32 with the compute dtype's values (see the module doc)
WIDENED = ("w_r", "w_i")
#: leaves kept fp32 whatever the compute policy (JAX ``layers._KEEP_F32``)
KEEP_F32 = ("lam", "logit_scale", "router")
REMATS = ("block", "sqrt", "none")
LOGITS_CHUNK = 1024  # sequence positions per chunk of the vocab loss


def _sqrt_factor(g: int) -> int:
    """Largest factor of ``g`` ≤ √g (1 if prime — sqrt-remat degenerates)."""
    best = 1
    f = 1
    while f * f <= g:
        if g % f == 0:
            best = f
        f += 1
    return best


def resolve_pattern(cfg: ArchConfig):
    return tuple(cfg.block_pattern) or ("attn",)


def layer_kinds(cfg: ArchConfig):
    """Each layer's mixing kind, in execution order: the JAX decoder's
    ``n_layers % len(pattern)`` remainder layers first, then the groups."""
    pattern = resolve_pattern(cfg)
    L = len(pattern)
    n_rem = cfg.n_layers % L
    return tuple(pattern[i] if i < n_rem else pattern[(i - n_rem) % L]
                 for i in range(cfg.n_layers))


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _rnn_width(cfg: ArchConfig) -> int:
    return cfg.d_model  # Griffin: lru_width == d_model for the 9B config


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Leaves(nn.Module):
    """Named parameter leaves, indexed like a JAX param dict (``p["w_up"]``)
    — an ``nn.ParameterDict`` that can nest: a nested dict such as
    ``ffn.shared`` is a child ``Leaves``."""

    def __init__(self, leaves: Dict[str, nn.Module | nn.Parameter]):
        super().__init__()
        for name, leaf in leaves.items():
            setattr(self, name, leaf)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return hasattr(self, name)


def has_ffn(cfg: ArchConfig) -> bool:
    """Whether a layer has an FFN (JAX ``_has_ffn``): not xLSTM's."""
    return cfg.d_ff > 0 or cfg.is_moe


def _mlp_leaves(d: int, d_ff: int, dtype, device) -> Leaves:
    return Leaves({
        "w_gate": _param((d, d_ff), dtype, device),
        "w_up": _param((d, d_ff), dtype, device),
        "w_down": _param((d_ff, d), dtype, device),
    })


def _ffn_leaves(cfg: ArchConfig, dtype, device) -> Leaves:
    """``_ffn_init``'s leaves: a SwiGLU, or ``moe_init``'s router (fp32),
    expert stacks over the physical experts and shared SwiGLU."""
    d = cfg.d_model
    if not cfg.is_moe:
        return _mlp_leaves(d, cfg.d_ff, dtype, device)
    m = cfg.moe
    E, f = m.n_physical, m.d_ff_expert
    leaves = {
        "router": _param((d, m.n_experts), torch.float32, device),
        "we_gate": _param((E, d, f), dtype, device),
        "we_up": _param((E, d, f), dtype, device),
        "we_down": _param((E, f, d), dtype, device),
    }
    if m.n_shared_experts > 0:
        leaves["shared"] = _mlp_leaves(d, f * m.n_shared_experts, dtype,
                                       device)
    return Leaves(leaves)


def _mix_leaves(cfg: ArchConfig, kind: str, dtype, device,
                widened=torch.float32):
    """``_mix_init``'s leaves: attention projections, the Griffin block's
    (``griffin_block_init``: conv width 4, ``lam`` in fp32 and the gate
    matrices in ``widened``: fp32 in a serving model, see
    :data:`WIDENED`), or an xLSTM cell's (``mlstm_init``: q/k/v, the input
    and forget gates' (d, 2H), out and output gate; ``slstm_init``: the
    (z, i, f, o) input projection, the block-diagonal recurrent weights
    (4, H, hd, hd) and out)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dh = cfg.n_heads * hd
    if kind in ("attn", "local_attn"):
        H, K = cfg.n_heads, cfg.n_kv_heads
        return nn.ParameterDict({
            "wq": _param((d, H * hd), dtype, device),
            "wk": _param((d, K * hd), dtype, device),
            "wv": _param((d, K * hd), dtype, device),
            "wo": _param((H * hd, d), dtype, device),
        })
    if kind == "rglru":
        r = _rnn_width(cfg)
        f32 = torch.float32
        return Leaves({
            "w_x": _param((d, r), dtype, device),
            "w_gate": _param((d, r), dtype, device),
            "conv": Leaves({"w": _param((4, r), dtype, device)}),
            "rglru": Leaves({"lam": _param((r,), f32, device),
                             "w_r": _param((r, r), widened, device),
                             "w_i": _param((r, r), widened, device)}),
            "w_out": _param((r, d), dtype, device),
        })
    if kind == "mlstm":
        return nn.ParameterDict({
            "wq": _param((d, dh), dtype, device),
            "wk": _param((d, dh), dtype, device),
            "wv": _param((d, dh), dtype, device),
            "w_if": _param((d, 2 * cfg.n_heads), dtype, device),
            "wo": _param((dh, d), dtype, device),
            "ogate": _param((d, dh), dtype, device),
        })
    if kind == "slstm":
        return nn.ParameterDict({
            "w_in": _param((d, 4 * dh), dtype, device),
            "r": _param((4, cfg.n_heads, hd, hd), dtype, device),
            "wo": _param((dh, d), dtype, device),
        })
    raise ValueError(f"mixing kind {kind!r} is not ported; one of {KINDS}")


def cast_leaves(mod: nn.Module, dtype):
    """``cast_floats`` of one module's leaves: a nested dict (by leaf name)
    of the leaves cast to ``dtype`` (None: as they are held), a placed
    leaf first gathered over its data axes (``parallel.sharding.
    gather_data``), :data:`KEEP_F32` leaves as they are and
    :data:`WIDENED` ones rounded to ``dtype`` and widened back to fp32
    (JAX casts them and ``_rglru_gates`` widens them at use).  The casts
    and gathers are differentiable: gradients flow back to the fp32
    leaves."""
    out = {name: cast_leaves(child, dtype)
           for name, child in mod.named_children()}
    for name, p in mod.named_parameters(recurse=False):
        p = gather_data(p)
        if dtype is None or name in KEEP_F32:
            out[name] = p
        elif name in WIDENED:
            out[name] = p.to(dtype).float()
        else:
            out[name] = p.to(dtype)
    return out


def _placed_leaf(p) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor)


def _placed(mod: nn.Module) -> bool:
    return any(_placed_leaf(p) for p in mod.parameters())


def local_leaves(mod: nn.Module, dtype):
    """A layer as its functions take it: the module itself when it holds
    its leaves as they compute (no cast, not placed), else
    :func:`cast_leaves`' dicts."""
    if dtype is None and not _placed(mod):
        return mod
    return SimpleNamespace(**cast_leaves(mod, dtype))


class Block(nn.Module):
    """One pre-norm (mixer [+ FFN]) layer: ``_layer_init``'s leaves."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype, device,
                 widened=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.norm1 = nn.ParameterDict({"scale": _param((d,), dtype, device)})
        self.mix = _mix_leaves(cfg, kind, dtype, device, widened)
        if has_ffn(cfg):
            self.norm2 = nn.ParameterDict({"scale": _param((d,), dtype,
                                                           device)})
            self.ffn = _ffn_leaves(cfg, dtype, device)


def ffn_apply(p, h, cfg: ArchConfig, *, impl: str, mesh=None, tp=None):
    """``_ffn_apply`` on (B, S, d): (the MoE FFN, its router's aux loss) or
    (the SwiGLU, 0.0 — a Python zero, so a dense layer launches nothing
    for it).  The serving paths drop the aux loss, as JAX's do.  ``mesh``
    reaches the MoE layer (its expert parallelism) and a SwiGLU whose
    hidden dim is split over ``"model"`` (tensor parallelism); ``tp`` is
    this rank's model shard when it differs from ``mesh``'s (Megatron-SP)."""
    if cfg.is_moe:
        return moe_apply(p, h, cfg, use_kernels=impl == "kernels", mesh=mesh,
                         tp=tp)
    tp = model_shard(mesh) if tp is None else tp
    return mlp_apply(p, h, tp if _ffn_split(p, cfg) else None), 0.0


def _ffn_split(p, cfg: ArchConfig) -> bool:
    """Whether this layer's FFN is tensor-parallel (an MoE layer always
    keeps its own split: :func:`~repro_torch.models.moe.moe_apply`)."""
    return cfg.is_moe or p["w_gate"].shape[-1] != cfg.d_ff


def _mix_split(p, cfg: ArchConfig, kind: str, tp) -> bool:
    """Whether this layer's mixer is tensor-parallel under ``tp``, as each
    mixer reads it from its local shapes."""
    hd = cfg.resolved_head_dim
    if kind in ("attn", "local_attn"):
        return tp_sharded(p, cfg.n_heads, hd, tp)
    if kind == "rglru":
        return _griffin_tp(p, cfg.d_model, tp) is not None
    proj = "wq" if kind == "mlstm" else "w_in"
    return _xlstm_heads(p, cfg.n_heads, hd, tp, proj) is not None


def seq_parallel_on(mesh, seq_len: int, seq_parallel: bool,
                    return_cache: bool = False) -> bool:
    """Whether a forward runs Megatron-SP: JAX's ``Decoder.forward``
    predicate (``transformer.py:325-331``) — asked for, a forward without
    a cache (``Transformer.forward``), a mesh whose ``"model"`` axis n >
    1, and more than one position ``seq_len`` (a VLM's stub positions
    included) that n divides.  Otherwise SP is off, silently, as in
    JAX."""
    if not seq_parallel or return_cache or mesh is None:
        return False
    n = axis_size(mesh, MODEL)
    return n > 1 and seq_len > 1 and seq_len % n == 0


def _alike(p, group):
    """A layer's leaves (a module, a namespace or nested dicts) as nested
    dicts, each leaf through ``replicated_in`` over ``group``."""
    if isinstance(p, torch.Tensor):
        return replicated_in(p, group)
    if isinstance(p, nn.Module) and not isinstance(p, nn.ParameterDict):
        items = (list(p.named_children())
                 + list(p.named_parameters(recurse=False)))
    else:
        items = p.items()
    return {k: _alike(v, group) for k, v in items}


def _sublayer(fn, norm, h, tp, split: bool):
    """``fn`` (a mixer or an FFN on the normed input and a model shard)
    on ``rmsnorm(norm, h)``.  Under Megatron-SP (``tp.seq``) ``h`` holds
    this rank's positions: they are normed (the scale through
    ``replicated_in``: it sees this rank's positions only) and gathered
    whole with ``gather_shards``; a tensor-parallel ``fn`` (``split``)
    leaves reduce-scattered onto them; one every rank computes whole gets
    its leaves through ``replicated_in`` (see :func:`_alike`) and keeps
    this rank's positions of its output.  Returns ``fn``'s output."""
    if tp is None or not tp.seq:
        return fn(rmsnorm(norm, h), tp, None)
    x = rmsnorm({"scale": replicated_in(norm["scale"], tp.group)}, h)
    x = gather_shards(x, tp.group, 1)
    if split:
        return fn(x, tp, None)
    y, *rest = fn(x, None, tp.group)
    return (tp.own_positions(y), *rest)


def _mix_apply(p, h, cfg: ArchConfig, kind: str, *, impl: str, tp=None,
               state: bool = True):
    """Prefill sequence mixing on (B,S,d). Returns (y, raw decode state):
    {"k", "v"} of shape (B,S,K,hd) for attention, {"h", "conv"} for rglru,
    and the xLSTM cells' decode states as they are — under ``tp`` the KV
    heads, features or heads this rank holds.  ``state=False`` (a forward
    without a cache) skips mLSTM's closed-form state, the one state that
    costs products of its own (its place is then None)."""
    hd = cfg.resolved_head_dim
    if kind in ("attn", "local_attn"):
        y, kv = attn_apply(
            p, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            causal=True, qk_norm=cfg.qk_norm,
            window=cfg.local_window if kind == "local_attn" else 0,
            impl=impl, return_kv=True, tp=tp,
        )
        return y, {"k": kv[0], "v": kv[1]}
    if kind == "rglru":
        return griffin_block_apply(p, h, use_kernels=impl == "kernels",
                                   tp=tp)
    if kind == "mlstm":
        out = mlstm_apply(p, h, n_heads=cfg.n_heads, head_dim=hd,
                          return_state=state, tp=tp)
        return out if state else (out, None)
    if kind == "slstm":
        return slstm_apply(p, h, n_heads=cfg.n_heads, head_dim=hd, tp=tp)
    raise ValueError(kind)


def _mix_decode(p, x_t, state, pos, cfg: ArchConfig, kind: str, pages,
                slots, impl: str, tp=None):
    """One-token mixing. x_t: (B, d). Returns (y (B,d), state).  Full
    attention goes through the paged pools when ``pages`` is given, else
    through its slab; window and recurrent state is slot-major (O(W) /
    O(d) per slot — nothing to page)."""
    hd = cfg.resolved_head_dim
    if kind in ("attn", "local_attn"):
        paged = kind == "attn" and pages is not None
        y, ck, cv = attn_decode(
            p, x_t[:, None, :], state["k"], state["v"], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm,
            window=cfg.local_window if kind == "local_attn" else 0,
            page_table=pages if paged else None,
            slots=slots if paged else None, impl=impl, tp=tp,
        )
        return y[:, 0], {"k": ck, "v": cv}
    if kind == "rglru":
        return griffin_block_decode(p, x_t, state, tp)
    if kind == "mlstm":
        return mlstm_decode(p, x_t, state, n_heads=cfg.n_heads, head_dim=hd,
                            tp=tp)
    if kind == "slstm":
        return slstm_decode(p, x_t, state, n_heads=cfg.n_heads, head_dim=hd,
                            tp=tp)
    raise ValueError(kind)


def _layer_apply(p: Block, h, cfg: ArchConfig, kind: str, *, impl: str,
                 mesh=None, state: bool = True, sp: bool = False):
    """One layer over a sequence. Returns (h, aux loss, raw decode state;
    see :func:`_mix_apply` for ``state``).  ``sp``: Megatron-SP, ``h``
    this rank's positions (JAX ``_layer_apply(seq_dim=)``; see
    :func:`_sublayer`)."""
    tp = model_shard(mesh, seq=sp)

    def mix(x, t, alike):
        leaves = p.mix if alike is None else _alike(p.mix, alike)
        return _mix_apply(leaves, x, cfg, kind, impl=impl, tp=t, state=state)

    def ffn(x, t, alike):
        leaves = p.ffn if alike is None else _alike(p.ffn, alike)
        return ffn_apply(leaves, x, cfg, impl=impl, mesh=mesh,
                         tp=t if alike is None else None)

    y, state = _sublayer(mix, p.norm1, h, tp, sp and _mix_split(
        p.mix, cfg, kind, tp))
    h = h + y
    if not has_ffn(cfg):
        return h, 0.0, state
    y, aux = _sublayer(ffn, p.norm2, h, tp, sp and _ffn_split(p.ffn, cfg))
    return h + y, aux, state


def _layer_decode(p: Block, x_t, state, pos, cfg: ArchConfig, kind: str,
                  pages, slots, impl, mesh=None, seq_cache: bool = False):
    y, state = _mix_decode(p.mix, rmsnorm(p.norm1, x_t), state, pos, cfg,
                           kind, pages, slots, impl,
                           model_shard(mesh, seq_cache=seq_cache))
    h = x_t + y
    if has_ffn(cfg):
        h = h + ffn_apply(p.ffn, rmsnorm(p.norm2, h[:, None, :]), cfg,
                          impl=impl, mesh=mesh)[0][:, 0]
    return h, state


def _layer_chunk(p: Block, x, pool, page_table, pos0: int, cfg: ArchConfig,
                 impl: str, mesh=None):
    """One (attn + FFN) layer over a prefill chunk x (B, C, d) against the
    paged cache (JAX ``_layer_chunk``): attention stays plain; an MoE FFN
    takes the grouped-matmul kernel with kernels on, at the chunk's
    capacity."""
    y, pk, pv = attn_prefill_chunk(
        p.mix, rmsnorm(p.norm1, x), pool["k"], pool["v"], page_table, pos0,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm,
    )
    h = x + y
    h = h + ffn_apply(p.ffn, rmsnorm(p.norm2, h), cfg, impl=impl,
                      mesh=mesh)[0]
    return h, {"k": pk, "v": pv}


def _state_init(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                cache_dtype, device):
    """One layer's slab decode state (JAX ``_state_init``); the xLSTM
    states are fp32 whatever ``cache_dtype``."""
    if kind == "rglru":
        return griffin_state_init(batch, _rnn_width(cfg), dtype=cache_dtype,
                                  device=device)
    if kind == "mlstm":
        return mlstm_state_init(batch, cfg.n_heads, cfg.resolved_head_dim,
                                device=device)
    if kind == "slstm":
        return slstm_state_init(batch, cfg.n_heads, cfg.resolved_head_dim,
                                device=device)
    length = cache_len
    if kind == "local_attn":
        length = min(cfg.local_window or cache_len, cache_len)
    shape = (batch, cfg.n_kv_heads, length, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_dtype, device=device)}


class Decoder(nn.Module):
    """The layer stack (no embeddings — see :class:`Transformer`)."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str, dtype, device,
                 cast_dtype=None):
        super().__init__()
        self.cfg = cfg
        # "chunked" (JAX's kernels-off impl) | "kernels" (the kernels also
        # take the MoE expert products and the RG-LRU scan) | "naive"
        self.attn_impl = attn_impl
        # the dtype a training model casts its fp32 leaves to per layer
        # (None: the leaves are held in the dtype they compute with)
        self.cast_dtype = cast_dtype
        self.kinds = layer_kinds(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, kind, dtype, device,
                  torch.float32 if cast_dtype is None else dtype)
            for kind in self.kinds)

    def _layer(self, i: int, h, mesh=None, state: bool = False,
               sp: bool = False):
        layer = local_leaves(self.layers[i], self.cast_dtype)
        return _layer_apply(layer, h, self.cfg, self.kinds[i],
                            impl=self.attn_impl, mesh=mesh, state=state,
                            sp=sp)

    def _layers(self, h, lo: int, hi: int, mesh=None, sp: bool = False):
        """Layers ``lo..hi-1``. Returns (h, their summed aux loss)."""
        aux = 0.0
        for i in range(lo, hi):
            h, a, _ = self._layer(i, h, mesh, sp=sp)
            aux = aux + a
        return h, aux

    def _groups(self, h, starts, mesh=None, sp: bool = False):
        """The groups starting at ``starts``, each checkpointed (block
        remat). Returns (h, their summed aux loss)."""
        L = len(resolve_pattern(self.cfg))
        aux = 0.0
        for g0 in starts:
            h, a = checkpoint(self._layers, h, g0, g0 + L, mesh, sp,
                              use_reentrant=False)
            aux = aux + a
        return h, aux

    def forward(self, h, *, return_cache: bool = False, remat: str = "none",
                mesh=None, seq_parallel: bool = False):
        """h: (B,S,d) → (h, aux loss, raw per-layer decode states | None),
        the aux loss the MoE layers' router losses summed (a Python 0.0
        in a stack without MoE), as JAX's ``Decoder.forward`` returns.

        The ``n_layers % len(pattern)`` remainder layers run first,
        unchecked, then the G groups of one pattern repetition each.
        ``remat="block"`` recomputes each group in backward (one
        ``torch.utils.checkpoint`` per group, as JAX checkpoints each scan
        step), so only the groups' inputs are kept.  ``remat="sqrt"`` is
        JAX's two-level scheme: with g1 = :func:`_sqrt_factor` (G) > 1 it
        checkpoints g1 outer segments of G/g1 groups each, and each group
        inside them, so only g1 segment inputs live through the forward
        (each layer then runs three times, but the last group of a
        segment twice: the non-reentrant checkpoint stops a recompute once
        what backward needs is back); with g1 ≤ 1 (G prime) it is block
        remat.  Remat applies to a forward without a cache.  ``mesh``
        reaches the MoE layers (their expert parallelism) and the
        tensor-parallel ones; the recompute runs their collectives again,
        on every rank alike.

        ``seq_parallel`` (where :func:`seq_parallel_on` holds): Megatron-SP
        over ``"model"``, JAX's ``seq_dim``.  The remainder layers run on
        the whole sequence; then this rank keeps its block of positions
        (``take_shard``), the groups run with the residual stream and
        every checkpointed input split along the sequence (each sublayer
        gathers its normed input and reduce-scatters its output:
        :func:`_sublayer`), and the blocks are gathered whole at the end
        (``gather_alike``: every rank's head and loss then compute
        alike)."""
        if remat not in REMATS:
            raise ValueError(f"unknown remat {remat!r}; one of {REMATS}")
        n = len(self.layers)
        if return_cache:
            states, aux = [], 0.0
            for i in range(n):
                h, a, st = self._layer(i, h, mesh, True)
                aux = aux + a
                states.append(st)
            return h, aux, states
        L = len(resolve_pattern(self.cfg))
        n_rem = n % L
        h, aux = self._layers(h, 0, n_rem, mesh)
        starts = list(range(n_rem, n, L))
        sp = bool(starts) and seq_parallel_on(mesh, h.shape[1], seq_parallel)
        group = model_shard(mesh).group if sp else None
        if sp:
            h = take_shard(h, group, 1)
        g1 = _sqrt_factor(len(starts)) if remat == "sqrt" else 0
        if remat == "none":
            h, a = self._layers(h, n_rem, n, mesh, sp)
            aux = aux + a
        elif g1 > 1:
            g2 = len(starts) // g1
            for k in range(g1):
                h, a = checkpoint(self._groups, h, starts[k * g2:(k + 1) * g2],
                                  mesh, sp, use_reentrant=False)
                aux = aux + a
        else:
            h, a = self._groups(h, starts, mesh, sp)
            aux = aux + a
        if sp:
            h = gather_alike(h, group, 1)
        return h, aux, None

    def pack_cache(self, cache, prompt_len: int, cache_len: int,
                   cache_dtype=torch.bfloat16):
        """Raw forward states → the decode layout: full-attention K/V
        (B,S,K,hd) → (B,K,cache_len,hd), zero-padded; local K/V → the
        circular buffer (B,K,W,hd), W = min(window, cache_len) — the last
        W tokens rolled so that position p sits at p % W once S >= W,
        zero-padded below; rglru keeps ``h`` fp32 and casts ``conv``; the
        xLSTM states are already in the decode layout (fp32)."""
        cfg = self.cfg

        def pack_one(kind, st):
            if kind in ("mlstm", "slstm"):
                return st
            if kind == "rglru":
                return {"h": st["h"], "conv": st["conv"].to(cache_dtype)}
            W = cache_len
            if kind == "local_attn":
                W = min(cfg.local_window or cache_len, cache_len)

            def pk(x):
                x = x.transpose(1, 2).to(cache_dtype)
                S = x.shape[2]
                if kind == "local_attn" and S >= W:
                    return torch.roll(x[:, :, S - W:S], prompt_len % W,
                                      dims=2)
                return F.pad(x, (0, 0, 0, W - S))

            return {"k": pk(st["k"]), "v": pk(st["v"])}

        return [pack_one(kind, st) for kind, st in zip(self.kinds, cache)]

    def init_cache(self, batch: int, cache_len: int, cache_dtype, device):
        return [_state_init(self.cfg, kind, batch, cache_len, cache_dtype,
                            device) for kind in self.kinds]

    @property
    def chunkable(self) -> bool:
        """Chunked prefill needs every mixing layer to be paged full
        attention (recurrent and window state cannot be rebuilt chunk by
        chunk from a KV pool)."""
        return all(kind == "attn" for kind in self.kinds)

    def init_paged_cache(self, batch: int, cache_len: int, *, n_pages: int,
                         page_size: int, cache_dtype, device):
        """Paged decode cache: full-attention K and V pools (n_pages, K,
        page_size, hd), coded ``"kv0"``; window and recurrent state stays
        slot-major as :meth:`init_cache` lays it out, coded ``"state0"``.
        Returns ``(cache, layout)``."""
        slab = self.init_cache(batch, cache_len, cache_dtype, "meta")
        layout = [{key: "kv0" if kind == "attn" else "state0" for key in st}
                  for kind, st in zip(self.kinds, slab)]
        return paginate_cache(slab, layout, n_pages=n_pages,
                              page_size=page_size, device=device)

    def decode_step(self, x_t, cache, pos, *, pages=None, mesh=None,
                    seq_cache: bool = False):
        """x_t: (B,d); pos: scalar or (B,) positions; ``pages`` the (B, n_pp)
        page table of the full-attention layers (None: their slabs).  Pools,
        slabs and window buffers are updated in place; returns (x_t,
        cache).  ``seq_cache``: a placed slab cache split over ``"model"``
        along its sequence."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x_t.device)
        pos = pos if pos.dim() else pos.expand(x_t.shape[0])
        slots = None
        if pages is not None:
            # one write slot per row, shared by the full-attention layers
            page_size = next((st["k"].shape[2] for kind, st in
                              zip(self.kinds, cache) if kind == "attn"), None)
            if page_size is not None:
                slots = page_slots(pages, pos, page_size)
        new = []
        for layer, kind, state in zip(self.layers, self.kinds, cache):
            x_t, st = _layer_decode(local_leaves(layer, self.cast_dtype), x_t,
                                    state, pos, self.cfg, kind, pages, slots,
                                    self.attn_impl, mesh, seq_cache)
            new.append(st)
        return x_t, new

    def decode_chunk(self, x, cache, pos0: int, *, pages, mesh=None):
        """One prefill chunk x (B, C, d) at base position ``pos0`` through
        the paged cache (all-attention stacks only, see :attr:`chunkable`);
        the pools are updated in place.  Returns (h (B, C, d), cache)."""
        if not self.chunkable:
            raise ValueError(f"chunked prefill needs an all-attention "
                             f"pattern, got {self.kinds}")
        if _placed(self):
            raise NotImplementedError("chunked prefill of a placed model is "
                                      "not ported")
        new = []
        for layer, state in zip(self.layers, cache):
            x, st = _layer_chunk(layer, x, state, pages, pos0, self.cfg,
                                 self.attn_impl, mesh)
            new.append(st)
        return x, new


def _xent_chunk(hc, w, lc, mc, tp=None):
    with torch.profiler.record_function("repro.chunked_xent"):
        if tp is not None:
            hc = replicated_in(hc, tp.group)
        logits = (hc @ w).float()  # (B, c, V) or this rank's vocab slice
        if tp is None:  # fused: one (B, c, V) buffer fewer in backward
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lc[..., None])[..., 0]
        else:  # vocab-parallel: max, sum and gold logit over "model"
            m = max_over(logits.amax(dim=-1), tp.group)
            se = sum_out(torch.exp(logits - m[..., None]).sum(dim=-1),
                         tp.group)
            logz = m + torch.log(se)
            vl = logits.shape[-1]
            loc = lc - tp.rank * vl
            own = (loc >= 0) & (loc < vl)
            gold = logits.gather(-1, loc.clamp(0, vl - 1)[..., None])[..., 0]
            gold = sum_out(torch.where(own, gold, torch.zeros_like(gold)),
                           tp.group)
        return ((logz - gold) * mc).sum(), mc.sum()


def chunked_xent(h, w_head, labels, mask=None, chunk: int = 1024, tp=None):
    """h (B,S,d), w_head (d,V), labels (B,S) → mean token NLL (fp32), over
    sequence chunks of ``chunk`` positions (the last padded to a whole
    chunk and masked).  The head product runs in h's dtype, the loss math
    in fp32, and each chunk's (B, chunk, V) logits are recomputed in
    backward (an activation checkpoint per chunk), never stored.  With
    ``tp`` (a :class:`~repro_torch.parallel.mesh.ModelShard`) ``w_head``
    is this rank's (d, V/n) vocab slice: the logsumexp's max and sum and
    the gold logit are reduced over ``"model"``, h enters through
    ``replicated_in``, and every rank gets the whole loss."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    labels = labels.long()
    mask = (torch.ones((B, S), dtype=torch.float32, device=h.device)
            if mask is None else mask.float())
    if S % chunk:  # pad to a whole number of chunks, mask the pad
        pad = chunk - S % chunk
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    w = w_head.to(h.dtype)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        t, n = checkpoint(_xent_chunk, h[:, c0:c0 + chunk], w,
                          labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                          tp, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def vocab_tp(leaf, vocab: int, mesh, dim: int = 0):
    """The ``"model"`` shard when ``leaf`` (a placed leaf or a tensor: the
    (vocab, d) embedding, or with ``dim=-1`` a (d, vocab) head) holds a
    slice of the vocab, else None."""
    tp = model_shard(mesh)
    rows = (leaf.to_local() if _placed_leaf(leaf) else leaf).shape[dim]
    return tp if tp is not None and rows != vocab else None


def vocab_embed(table, tokens, tp=None):
    """Rows of ``table`` for ``tokens``; with ``tp`` the table is this
    rank's vocab slice: each rank looks up the ids of its slice (zero rows
    for the others) and the rows are summed over ``"model"``."""
    if tp is None:
        return embed_lookup(table, tokens)
    vl = table.shape[0]
    loc = tokens.long() - tp.rank * vl
    own = ((loc >= 0) & (loc < vl))[..., None]
    rows = embed_lookup(table, loc.clamp(0, vl - 1))
    return sum_out(torch.where(own, rows, torch.zeros_like(rows)), tp.group)


def vocab_logits(x, head, tp=None):
    """fp32 logits (B, V) of x (B, d) through the (d, V) ``head``; with
    ``tp`` the head is this rank's vocab slice and the slices are
    all-gathered over ``"model"``."""
    logits = (x @ head.to(x.dtype)).float()
    return logits if tp is None else all_gather_cat(logits, tp.group, -1)


#: entries of a parameter drawn from one generator
#: (:meth:`SeededParams.draw_blocks`)
DRAW_BLOCK = 1 << 24


class SeededParams(nn.Module):
    """Loading and seeded initialization of a model's parameters, shared by
    :class:`Transformer` and the encoder-decoder
    (:class:`repro_torch.models.encdec.EncDecTransformer`).  A subclass
    sets ``cfg``, ``train_layout`` and ``_cdt`` (the compute dtype)."""

    @torch.no_grad()
    def load_state(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy ``param_dtype`` values (by parameter name) into the model,
        casting each to the dtype its parameter holds (the compute policy
        applied once; in a serving model a :data:`WIDENED` leaf is rounded
        to the compute dtype first).  Every parameter must be given."""
        params = dict(self.named_parameters())
        missing = sorted(set(params) - set(tensors))
        extra = sorted(set(tensors) - set(params))
        if missing or extra:
            raise KeyError(f"load_state: missing {missing}, unexpected {extra}")
        for name, p in params.items():
            t = torch.as_tensor(tensors[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"load_state: {name} has shape "
                                 f"{tuple(t.shape)}, expected {tuple(p.shape)}")
            if _leaf(name) in WIDENED and not self.train_layout:
                t = t.to(self._cdt)
            p.copy_(t.to(p.dtype))  # cast first: no staging copy on device

    def init(self, seed: int) -> None:
        """Random weights from ``seed`` with the JAX init's distributions:
        N(0, 1/d_in) matrices — ``d_in`` is the fan-in axis ``shape[-2]``,
        also for an ``(E, d_in, d_out)`` expert stack — N(0, 0.02²)
        embeddings, unit norm scales, zero dead experts (``moe_init`` pads
        them), and the RG-LRU's ``lam = softplus⁻¹(-log(u) / c)`` for ``u
        ~ U[0.9, 0.999]`` (``rglru_init``), drawn as :meth:`draw_into`
        draws them."""
        self.draw_into(seed, dict(self.named_parameters()))

    def draw_blocks(self, name: str, p) -> List[slice]:
        """The blocks of leading rows parameter ``name`` (shaped as ``p``)
        is drawn in: at most :data:`DRAW_BLOCK` entries each, one row at
        least, over its drawn rows (an expert stack's live experts); one
        block for a norm scale, ``lam`` or a vector."""
        shape = tuple(p.shape)
        rows = self.cfg.moe.n_experts if len(shape) == 3 else shape[0]
        if _leaf(name) in ("scale", "lam") or len(shape) < 2:
            return [slice(0, rows)]
        per = max(1, DRAW_BLOCK // math.prod(shape[1:]))
        blocks = [slice(r, min(r + per, rows)) for r in range(0, rows, per)]
        if len(blocks) > 256:  # the seeds of :meth:`draw` would repeat
            raise ValueError(f"{name}: {len(blocks)} draw blocks > 256")
        return blocks

    def draw_into(self, seed: int, targets: Dict[str, torch.Tensor]) -> None:
        """Fill ``targets`` (by parameter name, each shaped as its
        parameter) with the parameters drawn from ``seed``: every block of
        :meth:`draw_blocks` of every parameter a task of one thread pool
        (torch releases the GIL; a full-width MoE model holds ~15 B values
        and an embedding up to 1 B), copied into its rows of the target,
        so only its own dtype crosses to the target's device.  Dead expert
        rows are zero."""
        params = list(self.named_parameters())
        tasks = [(i, n, p, k) for i, (n, p) in enumerate(params)
                 for k in range(len(self.draw_blocks(n, p)))]

        @torch.no_grad()
        def fill(i: int, name: str, p, k: int) -> None:
            out, blocks = targets[name], self.draw_blocks(name, p)
            out[blocks[k]].copy_(self.draw(seed, i, name, p, k))
            if k == 0 and blocks[-1].stop < out.shape[0]:
                out[blocks[-1].stop:].zero_()

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            for fut in [ex.submit(fill, *t) for t in tasks]:
                fut.result()  # re-raises a failed draw

    def draw(self, seed: int, i: int, name: str, p,
             block: Optional[int] = None) -> torch.Tensor:
        """Block ``block`` of :meth:`draw_blocks` of parameter ``i``
        (``name``, shaped and typed as ``p``), or with ``block=None`` the
        whole parameter (its blocks in turn, dead experts zero), on the
        CPU: :meth:`draw_into` fills the model with these, and
        ``parallel.sharding.place_module`` takes each rank's block of the
        whole one.  Block ``k`` comes from a generator of its own seeded
        ``(seed << 20) + i + (k << 24)``, so one seed gives one model on
        every device, whatever the threads' order, and a parameter of one
        block is drawn as one ``randn`` of its shape.  The CPU generator
        keeps a seed's low 32 bits only: ``i < 2^20`` and ``k < 256`` keep
        every block of a model distinct."""
        blocks = self.draw_blocks(name, p)
        if block is None:
            w = torch.cat([self.draw(seed, i, name, p, k)
                           for k in range(len(blocks))])
            if w.shape[0] < p.shape[0]:
                w = torch.cat([w, w.new_zeros((p.shape[0] - w.shape[0],)
                                              + tuple(p.shape[1:]))])
            return w
        rows = blocks[block]
        shape = (rows.stop - rows.start,) + tuple(p.shape[1:])
        leaf = _leaf(name)
        if leaf == "scale":
            return torch.ones(shape, dtype=p.dtype)
        g = torch.Generator(device="cpu").manual_seed(
            (seed << 20) + i + (block << 24))
        if leaf == "lam":
            u = torch.rand(shape, generator=g) * 0.099 + 0.9
            return torch.log(torch.expm1(-torch.log(u) / RGLRU_C)).to(p.dtype)
        std = 0.02 if leaf == "tok_embed" else 1.0 / math.sqrt(p.shape[-2])
        w = torch.randn(shape, generator=g).mul_(std)
        if leaf in WIDENED and not self.train_layout:
            w = w.to(self._cdt)
        return w.to(p.dtype)


class Transformer(SeededParams):
    """Decoder-only LM: embeddings + decoder + (tied) head.  ``train=True``
    builds the training layout (fp32 masters with ``requires_grad``, a
    cast per layer; see the module doc)."""

    def __init__(self, cfg: ArchConfig, shcfg: ShardingConfig, device, *,
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.shcfg = shcfg
        self.train_layout = train
        self.device = torch.device(device)
        cdt = self._cdt = dtype_of(cfg.compute_dtype)
        pdt = dtype_of(cfg.param_dtype)
        held = pdt if train else cdt  # the dtype the leaves are held in
        self.tok_embed = _param((cfg.vocab, cfg.d_model), held, self.device)
        self.final_norm = nn.ParameterDict({
            "scale": _param((cfg.d_model,), pdt, self.device)})
        self.decoder = Decoder(
            cfg, attn_impl="kernels" if shcfg.use_kernels else "chunked",
            dtype=held, device=self.device, cast_dtype=cdt if train else None,
        )
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), held, self.device)
        if train:
            self.requires_grad_(True)

    def head(self):
        """The (d, V) head — this rank's (d, V/n) vocab slice when placed
        with the vocab over ``"model"``."""
        if self.cfg.tie_embeddings:
            return gather_data(self.tok_embed).T
        return gather_data(self.lm_head)

    def _vocab_tp(self, mesh):
        """The ``"model"`` shard when the vocab is split over it."""
        return vocab_tp(self.tok_embed, self.cfg.vocab, mesh)

    def _logits(self, x, mesh):
        """fp32 logits (B, V) of final-normed x (B, d): the vocab slices
        all-gathered over ``"model"`` when the head is split."""
        return vocab_logits(x, self.head(), self._vocab_tp(mesh))

    def _final_norm(self, h):
        return rmsnorm({"scale": gather_data(self.final_norm["scale"])}, h)

    # ----------------------------------------------------------- forward
    def _embed(self, tokens, embeds=None, mesh=None):
        """Token embeddings in the compute dtype, with the VLM's stub patch
        embeddings ``embeds`` (B, P, d) prepended (JAX ``_embed``); a
        vocab split over ``"model"`` as :func:`vocab_embed` looks it
        up."""
        h = vocab_embed(gather_data(self.tok_embed), tokens,
                        self._vocab_tp(mesh)).to(self._cdt)
        if embeds is not None:
            h = torch.cat([embeds.to(device=h.device, dtype=self._cdt), h],
                          dim=1)
        return h

    def _forward(self, tokens, embeds=None, *, return_cache: bool = False,
                 mesh=None):
        """(final-normed h, aux loss, cache | None): JAX's ``forward``."""
        remat = "none" if return_cache else self.shcfg.remat
        h, aux, cache = self.decoder(self._embed(tokens, embeds, mesh),
                                     return_cache=return_cache, remat=remat,
                                     mesh=mesh,
                                     seq_parallel=self.shcfg.seq_parallel)
        return self._final_norm(h), aux, cache

    def forward(self, tokens, embeds=None, *, return_cache: bool = False,
                mesh=None):
        """tokens (B,S) [and stub embeds (B,P,d), prepended: RoPE positions
        run over stub and text] → (final-normed h (B,P+S,d), cache | None);
        the MoE aux loss is dropped, as serving drops it.  Without a cache
        the decoder runs under ``shcfg.remat``, as JAX's does."""
        h, _, cache = self._forward(tokens, embeds, return_cache=return_cache,
                                    mesh=mesh)
        return h, cache

    def loss(self, batch, *, mesh=None):
        """batch: {tokens (B,S), labels (B,S), [embeds (B,P,d)], [mask
        (B,S)]} → (nll + ``router_aux_weight``·aux, {"nll", "aux"}) with
        :func:`chunked_xent` over ``shcfg.logits_chunk`` positions at a
        time (0: :data:`LOGITS_CHUNK`, JAX's default) on the text
        positions (the stub's P are dropped), and aux the MoE layers'
        summed router loss (0 for a stack without MoE): JAX's
        ``Transformer.loss``.  Under ``mesh`` the batch is this rank's
        rows, and the loss their mean."""
        embeds = batch.get("embeds")
        h, aux, _ = self._forward(batch["tokens"], embeds, mesh=mesh)
        if embeds is not None:
            h = h[:, embeds.shape[1]:]
        nll = chunked_xent(h, self.head(), batch["labels"], batch.get("mask"),
                           chunk=self.shcfg.logits_chunk or LOGITS_CHUNK,
                           tp=self._vocab_tp(mesh))
        aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
        loss = nll + self.cfg.moe.router_aux_weight * aux
        return loss, {"nll": nll, "aux": aux}

    def prefill(self, tokens, embeds=None, *, cache_len: Optional[int] = None,
                cache_dtype=torch.bfloat16, mesh=None):
        """Forward + cache build over the stub (if any) and the prompt.
        Returns (last-position logits (B,V) fp32, cache)."""
        h, cache = self.forward(tokens, embeds, return_cache=True, mesh=mesh)
        prompt_len = h.shape[1]
        cache = self.decoder.pack_cache(cache, prompt_len,
                                        cache_len or prompt_len, cache_dtype)
        return self._logits(h[:, -1], mesh), cache

    def init_cache(self, batch: int, cache_len: int,
                   cache_dtype=torch.bfloat16):
        """The slab decode cache (zeros), one dict per layer."""
        return self.decoder.init_cache(batch, cache_len, cache_dtype,
                                       self.device)

    def init_paged_cache(self, batch: int, cache_len: int, *, n_pages: int,
                         page_size: int, cache_dtype=torch.bfloat16):
        return self.decoder.init_paged_cache(
            batch, cache_len, n_pages=n_pages, page_size=page_size,
            cache_dtype=cache_dtype, device=self.device,
        )

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.decoder.chunkable

    def decode_step(self, token, cache, pos, *, pages=None, mesh=None,
                    seq_cache: bool = False):
        """token: (B,) ids; pos: scalar or (B,) positions; ``pages`` the page
        table; ``seq_cache``: a placed slab cache split over ``"model"``
        along its sequence.  Returns (logits (B,V) fp32, cache)."""
        x = self._embed(token, mesh=mesh)
        x, cache = self.decoder.decode_step(x, cache, pos, pages=pages,
                                            mesh=mesh, seq_cache=seq_cache)
        x = self._final_norm(x[:, None, :])[:, 0]
        return self._logits(x, mesh), cache

    def prefill_chunk(self, tokens, cache, pos0: int, *, pages, mesh=None):
        """One chunk of a paged prefill: tokens (B, C) at positions
        ``pos0..pos0+C-1``.  Returns (logits at the chunk's last position
        (B, V) fp32, cache) — the batcher takes the final chunk's logits as
        each request's first token."""
        h, cache = self.decoder.decode_chunk(self._embed(tokens), cache, pos0,
                                             pages=pages, mesh=mesh)
        h = self._final_norm(h)
        return self._logits(h[:, -1], mesh), cache
