"""Decoder-only transformer for the serving slice (port of
``repro/models/transformer.py``).

Only the all-``attn`` block pattern (dense decoders such as qwen3) is
ported.  The JAX package scans over layer groups stacked on a leading
axis; here each layer is its own :class:`Block` in a ``ModuleList`` and
the scan is a Python loop (:mod:`repro_torch.bridge` unstacks the group
axis).  Parameter names follow the JAX leaves (``norm1.scale``,
``mix.wq``, ``ffn.w_gate``, ...), held in ``nn.ParameterDict``s so the
functional layers index them exactly like the JAX param dicts.

Precision policy: the JAX model keeps params in ``param_dtype`` and casts
the decoder's to ``compute_dtype`` on every call (``cast_floats``); the
port creates each parameter in the dtype it computes with and casts once,
at load (:meth:`Transformer.load_state`) — the same arithmetic, so
``cast_floats`` has no counterpart here.  ``final_norm`` stays in
``param_dtype``, as in JAX; the embedding table and the head are held in
``compute_dtype`` (JAX casts the looked-up rows and the head at use — the
same values).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ArchConfig, ShardingConfig
from .attention import attn_apply, attn_decode, page_slots
from .layers import dtype_of, embed_lookup, mlp_apply, rmsnorm
from .paging import paginate_cache


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One pre-norm (attention + SwiGLU) layer: ``_layer_init``'s leaves."""

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
        self.ffn = nn.ParameterDict({
            "w_gate": _param((d, cfg.d_ff), dtype, device),
            "w_up": _param((d, cfg.d_ff), dtype, device),
            "w_down": _param((cfg.d_ff, d), dtype, device),
        })


def _layer_apply(p: Block, h, cfg: ArchConfig, *, impl: str):
    """One layer over a sequence. Returns (h, {"k", "v"} of shape (B,S,K,hd))."""
    y, kv = attn_apply(
        p.mix, rmsnorm(p.norm1, h),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        causal=True, qk_norm=cfg.qk_norm, impl=impl, return_kv=True,
    )
    h = h + y
    h = h + mlp_apply(p.ffn, rmsnorm(p.norm2, h))
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
    h = h + mlp_apply(p.ffn, rmsnorm(p.norm2, h[:, None, :]))[:, 0]
    return h, {"k": ck, "v": cv}


class Decoder(nn.Module):
    """The layer stack (no embeddings — see :class:`Transformer`)."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl  # "naive" | "kernels"
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

    @torch.no_grad()
    def init(self, seed: int) -> None:
        """Random weights from ``seed`` with the JAX init's distributions:
        N(0, 1/d_in) matrices, N(0, 0.02²) embeddings, unit norm scales.
        Drawn on the CPU, so one seed gives one model on every device."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                t = torch.ones(p.shape)
            elif leaf == "tok_embed":
                t = torch.randn(p.shape, generator=g) * 0.02
            else:
                t = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[0])
            p.copy_(t.to(p.device, p.dtype))

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
