"""Decoder-only transformer for the serving slices (port of
``repro/models/transformer.py``).

A layer is a sequence mixer followed by an FFN.  The mixer's kind comes
from the block pattern — ``attn`` (full causal attention over the paged
KV pools), ``local_attn`` (sliding-window attention with a circular
per-slot buffer) or ``rglru`` (Griffin's recurrent block,
:mod:`repro_torch.models.recurrent`) — so dense decoders such as qwen3,
MoE decoders such as qwen2-moe (whose FFN is
:func:`repro_torch.models.moe.moe_apply`) and the hybrid recurrentgemma
run on one stack.  The JAX package runs ``n_layers % len(pattern)``
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
the decoder's to ``compute_dtype`` on every call (``cast_floats``); the
port creates each parameter in the dtype it computes with and casts once,
at load (:meth:`Transformer.load_state`) — the same arithmetic, so
``cast_floats`` has no counterpart here.  ``final_norm`` stays in
``param_dtype``, as in JAX; the embedding table and the head are held in
``compute_dtype`` (JAX casts the looked-up rows and the head at use — the
same values).  The MoE router and the RG-LRU's ``lam`` stay fp32 whatever
the policy, as JAX keeps them (``layers.py`` ``_KEEP_F32``).  The RG-LRU
gate matrices ``w_r``/``w_i`` are cast to ``compute_dtype`` by JAX and
widened to fp32 at every use (``_rglru_gates``); the port holds them in
fp32 with the compute dtype's values (:data:`WIDENED`), rounded once at
load — the same products, for 2 × 4 bytes instead of 2 × 2 per element
(+1.7 GB at recurrentgemma-9b's full width) and no cast per call.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ArchConfig, ShardingConfig
from .attention import (attn_apply, attn_decode, attn_prefill_chunk,
                        page_slots)
from .layers import dtype_of, embed_lookup, mlp_apply, rmsnorm
from .moe import moe_apply
from .paging import paginate_cache
from .recurrent import (RGLRU_C, griffin_block_apply, griffin_block_decode,
                        griffin_state_init)

KINDS = ("attn", "local_attn", "rglru")  # the mixing kinds ported
#: leaves held in fp32 with the compute dtype's values (see the module doc)
WIDENED = ("w_r", "w_i")


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


def _mix_leaves(cfg: ArchConfig, kind: str, dtype, device):
    """``_mix_init``'s leaves: attention projections, or the Griffin
    block's (``griffin_block_init``: conv width 4, ``lam`` and the widened
    gate matrices in fp32)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
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
                             "w_r": _param((r, r), f32, device),
                             "w_i": _param((r, r), f32, device)}),
            "w_out": _param((r, d), dtype, device),
        })
    raise ValueError(f"mixing kind {kind!r} is not ported; one of {KINDS}")


class Block(nn.Module):
    """One pre-norm (mixer + FFN) layer: ``_layer_init``'s leaves."""

    def __init__(self, cfg: ArchConfig, kind: str, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = nn.ParameterDict({"scale": _param((d,), dtype, device)})
        self.mix = _mix_leaves(cfg, kind, dtype, device)
        self.norm2 = nn.ParameterDict({"scale": _param((d,), dtype, device)})
        self.ffn = _ffn_leaves(cfg, dtype, device)


def ffn_apply(p, h, cfg: ArchConfig, *, impl: str):
    """``_ffn_apply``: the MoE FFN (its aux loss dropped, as JAX serving
    drops it) or the SwiGLU, on (B, S, d)."""
    if cfg.is_moe:
        return moe_apply(p, h, cfg, use_kernels=impl == "kernels")[0]
    return mlp_apply(p, h)


def _mix_apply(p, h, cfg: ArchConfig, kind: str, *, impl: str):
    """Prefill sequence mixing on (B,S,d). Returns (y, raw decode state):
    {"k", "v"} of shape (B,S,K,hd) for attention, {"h", "conv"} for
    rglru."""
    if kind in ("attn", "local_attn"):
        y, kv = attn_apply(
            p, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            causal=True, qk_norm=cfg.qk_norm,
            window=cfg.local_window if kind == "local_attn" else 0,
            impl=impl, return_kv=True,
        )
        return y, {"k": kv[0], "v": kv[1]}
    if kind == "rglru":
        return griffin_block_apply(p, h, use_kernels=impl == "kernels")
    raise ValueError(kind)


def _mix_decode(p, x_t, state, pos, cfg: ArchConfig, kind: str, pages,
                slots, impl: str):
    """One-token mixing. x_t: (B, d). Returns (y (B,d), state).  Full
    attention goes through the paged pools; window and recurrent state is
    slot-major (O(W) / O(d) per slot — nothing to page)."""
    if kind in ("attn", "local_attn"):
        paged = kind == "attn"
        y, ck, cv = attn_decode(
            p, x_t[:, None, :], state["k"], state["v"], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm,
            window=0 if paged else cfg.local_window,
            page_table=pages if paged else None,
            slots=slots if paged else None, impl=impl,
        )
        return y[:, 0], {"k": ck, "v": cv}
    if kind == "rglru":
        return griffin_block_decode(p, x_t, state)
    raise ValueError(kind)


def _layer_apply(p: Block, h, cfg: ArchConfig, kind: str, *, impl: str):
    """One layer over a sequence. Returns (h, raw decode state)."""
    y, state = _mix_apply(p.mix, rmsnorm(p.norm1, h), cfg, kind, impl=impl)
    h = h + y
    h = h + ffn_apply(p.ffn, rmsnorm(p.norm2, h), cfg, impl=impl)
    return h, state


def _layer_decode(p: Block, x_t, state, pos, cfg: ArchConfig, kind: str,
                  pages, slots, impl):
    y, state = _mix_decode(p.mix, rmsnorm(p.norm1, x_t), state, pos, cfg,
                           kind, pages, slots, impl)
    h = x_t + y
    h = h + ffn_apply(p.ffn, rmsnorm(p.norm2, h[:, None, :]), cfg,
                      impl=impl)[:, 0]
    return h, state


def _layer_chunk(p: Block, x, pool, page_table, pos0: int, cfg: ArchConfig,
                 impl: str):
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
    h = h + ffn_apply(p.ffn, rmsnorm(p.norm2, h), cfg, impl=impl)
    return h, {"k": pk, "v": pv}


def _state_init(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                cache_dtype, device):
    """One layer's slab decode state (JAX ``_state_init``)."""
    if kind == "rglru":
        return griffin_state_init(batch, _rnn_width(cfg), dtype=cache_dtype,
                                  device=device)
    length = cache_len
    if kind == "local_attn":
        length = min(cfg.local_window or cache_len, cache_len)
    shape = (batch, cfg.n_kv_heads, length, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_dtype, device=device)}


class Decoder(nn.Module):
    """The layer stack (no embeddings — see :class:`Transformer`)."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str, dtype, device):
        super().__init__()
        self.cfg = cfg
        # "naive" | "kernels" (the kernels also take the MoE expert
        # products and the RG-LRU scan)
        self.attn_impl = attn_impl
        self.kinds = layer_kinds(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, kind, dtype, device) for kind in self.kinds)

    def forward(self, h, *, return_cache: bool = False):
        """h: (B,S,d) → (h, raw per-layer decode states | None)."""
        states = []
        for layer, kind in zip(self.layers, self.kinds):
            h, st = _layer_apply(layer, h, self.cfg, kind,
                                 impl=self.attn_impl)
            if return_cache:
                states.append(st)
        return h, (states if return_cache else None)

    def pack_cache(self, cache, prompt_len: int, cache_len: int,
                   cache_dtype=torch.bfloat16):
        """Raw forward states → the decode layout: full-attention K/V
        (B,S,K,hd) → (B,K,cache_len,hd), zero-padded; local K/V → the
        circular buffer (B,K,W,hd), W = min(window, cache_len) — the last
        W tokens rolled so that position p sits at p % W once S >= W,
        zero-padded below; rglru keeps ``h`` fp32 and casts ``conv``."""
        cfg = self.cfg

        def pack_one(kind, st):
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

    def decode_step(self, x_t, cache, pos, *, pages=None):
        """x_t: (B,d); pos: scalar or (B,) positions; ``pages`` the (B, n_pp)
        page table of the full-attention layers.  Pools and window buffers
        are updated in place; returns (x_t, cache)."""
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
            x_t, st = _layer_decode(layer, x_t, state, pos, self.cfg, kind,
                                    pages, slots, self.attn_impl)
            new.append(st)
        return x_t, new

    def decode_chunk(self, x, cache, pos0: int, *, pages):
        """One prefill chunk x (B, C, d) at base position ``pos0`` through
        the paged cache (all-attention stacks only, see :attr:`chunkable`);
        the pools are updated in place.  Returns (h (B, C, d), cache)."""
        if not self.chunkable:
            raise ValueError(f"chunked prefill needs an all-attention "
                             f"pattern, got {self.kinds}")
        new = []
        for layer, state in zip(self.layers, cache):
            x, st = _layer_chunk(layer, x, state, pages, pos0, self.cfg,
                                 self.attn_impl)
            new.append(st)
        return x, new


class Transformer(nn.Module):
    """Decoder-only LM: embeddings + decoder + (tied) head."""

    def __init__(self, cfg: ArchConfig, shcfg: ShardingConfig, device):
        super().__init__()
        self.cfg = cfg
        self.shcfg = shcfg
        self.device = torch.device(device)
        cdt = self._cdt = dtype_of(cfg.compute_dtype)
        self.tok_embed = _param((cfg.vocab, cfg.d_model), cdt, self.device)
        self.final_norm = nn.ParameterDict({
            "scale": _param((cfg.d_model,), dtype_of(cfg.param_dtype),
                            self.device)})
        self.decoder = Decoder(
            cfg, attn_impl="kernels" if shcfg.use_kernels else "naive",
            dtype=cdt, device=self.device,
        )
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.vocab), cdt, self.device)

    # ------------------------------------------------------------ params
    @torch.no_grad()
    def load_state(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Copy ``param_dtype`` values (by parameter name) into the model,
        casting each to the dtype its parameter holds (the compute policy
        applied once; a :data:`WIDENED` leaf is rounded to the compute
        dtype first).  Every parameter must be given."""
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
            if _leaf(name) in WIDENED:
                t = t.to(self._cdt)
            p.copy_(t.to(p.dtype))  # cast first: no staging copy on device

    def init(self, seed: int) -> None:
        """Random weights from ``seed`` with the JAX init's distributions:
        N(0, 1/d_in) matrices — ``d_in`` is the fan-in axis ``shape[-2]``,
        also for an ``(E, d_in, d_out)`` expert stack — N(0, 0.02²)
        embeddings, unit norm scales, zero dead experts (``moe_init`` pads
        them), and the RG-LRU's ``lam = softplus⁻¹(-log(u) / c)`` for ``u
        ~ U[0.9, 0.999]`` (``rglru_init``).  Each parameter is drawn on the
        CPU from a generator of its own, seeded from ``seed`` and the
        parameter's index, so one seed gives one model on every device,
        and cast there, so only its own dtype crosses to the device; the
        draws run in threads (torch releases the GIL), since a full-width
        MoE model holds ~15 B values."""
        n_live = self.cfg.moe.n_experts

        @torch.no_grad()
        def fill(i: int, name: str, p: nn.Parameter) -> None:
            leaf = _leaf(name)
            if leaf == "scale":
                p.fill_(1.0)
                return
            g = torch.Generator(device="cpu").manual_seed((seed << 20) + i)
            if leaf == "lam":
                u = torch.rand(p.shape, generator=g) * 0.099 + 0.9
                p.copy_(torch.log(torch.expm1(-torch.log(u) / RGLRU_C)))
                return
            std = 0.02 if leaf == "tok_embed" else 1.0 / math.sqrt(p.shape[-2])
            if p.dim() == 3:  # expert stack: live experts drawn, dead zero
                p.zero_()
                p = p[:n_live]
            w = torch.randn(p.shape, generator=g) * std
            if leaf in WIDENED:
                w = w.to(self._cdt)
            p.copy_(w.to(p.dtype))

        params = list(self.named_parameters())
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            for fut in [ex.submit(fill, i, n, p)
                        for i, (n, p) in enumerate(params)]:
                fut.result()  # re-raises a failed draw

    def head(self):
        if self.cfg.tie_embeddings:
            return self.tok_embed.T
        return self.lm_head

    # ----------------------------------------------------------- forward
    def _embed(self, tokens):
        return embed_lookup(self.tok_embed, tokens).to(
            dtype_of(self.cfg.compute_dtype))

    def forward(self, tokens, *, return_cache: bool = False):
        h, cache = self.decoder(self._embed(tokens), return_cache=return_cache)
        return rmsnorm(self.final_norm, h), cache

    def prefill(self, tokens, *, cache_len: Optional[int] = None,
                cache_dtype=torch.bfloat16):
        """Forward + cache build. Returns (last-position logits (B,V) fp32,
        cache)."""
        h, cache = self.forward(tokens, return_cache=True)
        prompt_len = h.shape[1]
        cache = self.decoder.pack_cache(cache, prompt_len,
                                        cache_len or prompt_len, cache_dtype)
        logits = (h[:, -1] @ self.head().to(h.dtype)).float()
        return logits, cache

    def init_paged_cache(self, batch: int, cache_len: int, *, n_pages: int,
                         page_size: int, cache_dtype=torch.bfloat16):
        return self.decoder.init_paged_cache(
            batch, cache_len, n_pages=n_pages, page_size=page_size,
            cache_dtype=cache_dtype, device=self.device,
        )

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.decoder.chunkable

    def decode_step(self, token, cache, pos, *, pages=None):
        """token: (B,) ids; pos: scalar or (B,) positions; ``pages`` the page
        table.  Returns (logits (B,V) fp32, cache)."""
        x = self._embed(token)
        x, cache = self.decoder.decode_step(x, cache, pos, pages=pages)
        x = rmsnorm(self.final_norm, x[:, None, :])[:, 0]
        logits = (x @ self.head().to(x.dtype)).float()
        return logits, cache

    def prefill_chunk(self, tokens, cache, pos0: int, *, pages):
        """One chunk of a paged prefill: tokens (B, C) at positions
        ``pos0..pos0+C-1``.  Returns (logits at the chunk's last position
        (B, V) fp32, cache) — the batcher takes the final chunk's logits as
        each request's first token."""
        h, cache = self.decoder.decode_chunk(self._embed(tokens), cache, pos0,
                                             pages=pages)
        h = rmsnorm(self.final_norm, h)
        logits = (h[:, -1] @ self.head().to(h.dtype)).float()
        return logits, cache
