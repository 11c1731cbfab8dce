"""Decoder-only transformer for the serving slice (port of
``repro/models/transformer.py``).

Only the all-``attn`` block pattern is ported: dense decoders such as
qwen3, and MoE decoders such as qwen2-moe, whose FFN is
:func:`repro_torch.models.moe.moe_apply` (``_ffn_apply`` dispatches on the
family, as in JAX).  The JAX package scans over layer groups stacked on a
leading axis; here each layer is its own :class:`Block` in a
``ModuleList`` and the scan is a Python loop (:mod:`repro_torch.bridge`
unstacks the group axis).  Parameter names follow the JAX leaves
(``norm1.scale``, ``mix.wq``, ``ffn.w_gate``, ``ffn.we_up``,
``ffn.shared.w_down``, ...), held in ``nn.ParameterDict``s (or, for the
FFN, whose MoE leaves nest, :class:`Leaves`) that the functional layers
index exactly like the JAX param dicts.

Precision policy: the JAX model keeps params in ``param_dtype`` and casts
the decoder's to ``compute_dtype`` on every call (``cast_floats``); the
port creates each parameter in the dtype it computes with and casts once,
at load (:meth:`Transformer.load_state`) — the same arithmetic, so
``cast_floats`` has no counterpart here.  ``final_norm`` stays in
``param_dtype``, as in JAX; the embedding table and the head are held in
``compute_dtype`` (JAX casts the looked-up rows and the head at use — the
same values).  The MoE router stays fp32 whatever the policy, as JAX
keeps it (``layers.py`` ``_KEEP_F32``).
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
from .attention import attn_apply, attn_decode, page_slots
from .layers import dtype_of, embed_lookup, mlp_apply, rmsnorm
from .moe import moe_apply
from .paging import paginate_cache


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


class Block(nn.Module):
    """One pre-norm (attention + FFN) layer: ``_layer_init``'s leaves."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, K = cfg.n_heads, cfg.n_kv_heads
        self.norm1 = nn.ParameterDict({"scale": _param((d,), dtype, device)})
        self.mix = nn.ParameterDict({
            "wq": _param((d, H * hd), dtype, device),
            "wk": _param((d, K * hd), dtype, device),
            "wv": _param((d, K * hd), dtype, device),
            "wo": _param((H * hd, d), dtype, device),
        })
        self.norm2 = nn.ParameterDict({"scale": _param((d,), dtype, device)})
        self.ffn = _ffn_leaves(cfg, dtype, device)


def ffn_apply(p, h, cfg: ArchConfig, *, impl: str):
    """``_ffn_apply``: the MoE FFN (its aux loss dropped, as JAX serving
    drops it) or the SwiGLU, on (B, S, d)."""
    if cfg.is_moe:
        return moe_apply(p, h, cfg, use_kernels=impl == "kernels")[0]
    return mlp_apply(p, h)


def _layer_apply(p: Block, h, cfg: ArchConfig, *, impl: str):
    """One layer over a sequence. Returns (h, {"k", "v"} of shape (B,S,K,hd))."""
    y, kv = attn_apply(
        p.mix, rmsnorm(p.norm1, h),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=True, qk_norm=cfg.qk_norm, impl=impl, return_kv=True,
    )
    h = h + y
    h = h + ffn_apply(p.ffn, rmsnorm(p.norm2, h), cfg, impl=impl)
    return h, {"k": kv[0], "v": kv[1]}


def _layer_decode(p: Block, x_t, state, pos, cfg: ArchConfig, pages, slots,
                  impl):
    y, ck, cv = attn_decode(
        p.mix, rmsnorm(p.norm1, x_t)[:, None, :], state["k"], state["v"], pos,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, page_table=pages, slots=slots, impl=impl,
    )
    h = x_t + y[:, 0]
    h = h + ffn_apply(p.ffn, rmsnorm(p.norm2, h[:, None, :]), cfg,
                      impl=impl)[:, 0]
    return h, {"k": ck, "v": cv}


class Decoder(nn.Module):
    """The layer stack (no embeddings — see :class:`Transformer`)."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str, dtype, device):
        super().__init__()
        self.cfg = cfg
        # "naive" | "kernels" (the kernels also take the MoE expert products)
        self.attn_impl = attn_impl
        self.layers = nn.ModuleList(
            Block(cfg, dtype, device) for _ in range(cfg.n_layers))

    def forward(self, h, *, return_cache: bool = False):
        """h: (B,S,d) → (h, raw per-layer KV states | None)."""
        states = []
        for layer in self.layers:
            h, st = _layer_apply(layer, h, self.cfg, impl=self.attn_impl)
            if return_cache:
                states.append(st)
        return h, (states if return_cache else None)

    def pack_cache(self, cache, prompt_len: int, cache_len: int,
                   cache_dtype=torch.bfloat16):
        """Raw forward states (B,S,K,hd) → decode layout (B,K,cache_len,hd)."""
        def pk(x):
            x = x.transpose(1, 2).to(cache_dtype)
            return F.pad(x, (0, 0, 0, cache_len - x.shape[2]))

        return [{"k": pk(st["k"]), "v": pk(st["v"])} for st in cache]

    def init_cache(self, batch: int, cache_len: int, cache_dtype, device):
        cfg = self.cfg
        shape = (batch, cfg.n_kv_heads, cache_len, cfg.resolved_head_dim)
        return [
            {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
             "v": torch.zeros(shape, dtype=cache_dtype, device=device)}
            for _ in self.layers
        ]

    def init_paged_cache(self, batch: int, cache_len: int, *, n_pages: int,
                         page_size: int, cache_dtype, device):
        """Paged decode cache: per layer, K and V pools (n_pages, K,
        page_size, hd).  Returns ``(cache, layout)``."""
        layout = [{"k": "kv0", "v": "kv0"} for _ in self.layers]
        return paginate_cache(
            self.init_cache(batch, cache_len, cache_dtype, "meta"), layout,
            n_pages=n_pages, page_size=page_size, device=device,
        )

    def decode_step(self, x_t, cache, pos, *, pages=None):
        """x_t: (B,d); pos: scalar or (B,) positions; ``pages`` the (B, n_pp)
        page table.  The pools are updated in place; returns (x_t, cache)."""
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x_t.device)
        pos = pos if pos.dim() else pos.expand(x_t.shape[0])
        slots = None
        if pages is not None:  # one write slot per row, shared by all layers
            slots = page_slots(pages, pos, cache[0]["k"].shape[2])
        new = []
        for layer, state in zip(self.layers, cache):
            x_t, st = _layer_decode(layer, x_t, state, pos, self.cfg, pages,
                                    slots, self.attn_impl)
            new.append(st)
        return x_t, new


class Transformer(nn.Module):
    """Decoder-only LM: embeddings + decoder + (tied) head."""

    def __init__(self, cfg: ArchConfig, shcfg: ShardingConfig, device):
        super().__init__()
        self.cfg = cfg
        self.shcfg = shcfg
        self.device = torch.device(device)
        cdt = dtype_of(cfg.compute_dtype)
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
        applied once).  Every parameter must be given."""
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
            p.copy_(t.to(p.device, p.dtype))

    def init(self, seed: int) -> None:
        """Random weights from ``seed`` with the JAX init's distributions:
        N(0, 1/d_in) matrices — ``d_in`` is the fan-in axis ``shape[-2]``,
        also for an ``(E, d_in, d_out)`` expert stack — N(0, 0.02²)
        embeddings, unit norm scales, and zero dead experts (``moe_init``
        pads them).  Each parameter is drawn on the CPU from a generator
        of its own, seeded from ``seed`` and the parameter's index, so one
        seed gives one model on every device; the draws run in threads
        (torch releases the GIL), since a full-width MoE model holds ~15 B
        values."""
        n_live = self.cfg.moe.n_experts

        @torch.no_grad()
        def fill(i: int, name: str, p: nn.Parameter) -> None:
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
                return
            g = torch.Generator(device="cpu").manual_seed((seed << 20) + i)
            std = 0.02 if leaf == "tok_embed" else 1.0 / math.sqrt(p.shape[-2])
            if p.dim() == 3:  # expert stack: live experts drawn, dead zero
                p.zero_()
                p = p[:n_live]
            p.copy_((torch.randn(p.shape, generator=g) * std).to(p.device,
                                                                 p.dtype))

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

    def decode_step(self, token, cache, pos, *, pages=None):
        """token: (B,) ids; pos: scalar or (B,) positions; ``pages`` the page
        table.  Returns (logits (B,V) fp32, cache)."""
        x = self._embed(token)
        x, cache = self.decoder.decode_step(x, cache, pos, pages=pages)
        x = rmsnorm(self.final_norm, x[:, None, :])[:, 0]
        logits = (x @ self.head().to(x.dtype)).float()
        return logits, cache
