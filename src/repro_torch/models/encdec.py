"""Encoder-decoder transformer (seamless-m4t family): port of
``repro/models/encdec.py``.

The modality frontend is a stub: ``frames`` arrive as precomputed (B,
S_enc, d) embeddings (speech frames after the conformer frontend).  The
encoder runs non-causal self-attention over them; the decoder is a causal
LM with per-layer cross-attention into the encoder memory, whose keys and
values (``memory @ wk`` / ``memory @ wv``) are computed once at prefill and
kept as the decode cache's ``cross_k`` / ``cross_v``.

As in :mod:`repro_torch.models.transformer`, the JAX model's layer scans
are Python loops over one module per layer (``enc_blocks.<i>`` and
``dec_blocks.<i>``; :mod:`repro_torch.bridge` unstacks JAX's leading layer
axis), and the decode cache is a list of per-layer dicts ``{"self_k",
"self_v", "cross_k", "cross_v"}``.  The precision policy is the
decoder-only model's: a serving model holds every leaf in the compute
dtype but ``enc_norm`` and ``final_norm`` (``param_dtype``, as JAX keeps
them); ``train=True`` holds fp32 masters with gradients and casts per
layer.

Attention follows ``ShardingConfig.use_kernels``.  Kernels on: the flash
kernel serves the encoder (non-causal), decoder self-attention (causal)
and cross-attention (non-causal, Sq the prompt, Sk the memory), each where
its query length exceeds 256, and the paged-decode kernel serves decoder
self-attention in decode.  Kernels off: ``chunked_attention`` and the
reference gather, which is what the JAX model runs (it passes no ``impl``,
so it never reaches a Pallas kernel).  Cross-attention decode is plain
arithmetic either way, as in JAX.  Decoder self-attention decodes
through the paged pools, or, given no page table, through its slab
(``self_k``/``self_v`` (B, K, cache_len, hd) beside the slot-major cross
memory; plain arithmetic, as in JAX).

Under a ``mesh`` (a model placed by the sharding rules: every parameter a
DTensor of this rank's block) each layer's leaves are gathered over their
data axes before use (:func:`~repro_torch.models.transformer.
local_leaves`), and the ``"model"`` split stays: the encoder's and the
decoder's self-attention, the cross attention and the SwiGLUs are
tensor-parallel on this rank's heads and hidden columns (the encoder
memory enters each layer's cross K/V projection through one
``replicated_in``, so its gradient is summed over ``"model"`` once), and
the embedding, the head and the loss are vocab-parallel where the vocab
divides the axis, else replicated over it (seamless-m4t-medium's 256,206
on 16).  The prefill's and the decode's cache is this rank's KV heads of
the self and cross slabs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ArchConfig, ShardingConfig
from ..parallel.collectives import replicated_in
from ..parallel.mesh import model_shard
from ..parallel.sharding import gather_data
from .attention import (attn_apply, attn_decode, kv_project, page_slots,
                        tp_sharded)
from .layers import dtype_of, mlp_apply, rmsnorm
from .paging import paginate_cache
from .transformer import (LOGITS_CHUNK, SeededParams, _mix_leaves,
                          _mlp_leaves, _param, chunked_xent, local_leaves,
                          vocab_embed, vocab_logits, vocab_tp)

#: per-layer decode cache leaves and their paged layout codes: the
#: decoder's self-attention KV pools, and the slot-major cross memory
#: (read-only, O(enc_len) per slot — nothing grows to page)
CACHE_LAYOUT = {"self_k": "kv0", "self_v": "kv0",
                "cross_k": "state0", "cross_v": "state0"}


def _norm(d: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": _param((d,), dtype, device)})


class EncBlock(nn.Module):
    """One encoder layer: ``_enc_layer_init``'s leaves."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = _norm(d, dtype, device)
        self.attn = _mix_leaves(cfg, "attn", dtype, device)
        self.norm2 = _norm(d, dtype, device)
        self.ffn = _mlp_leaves(d, cfg.d_ff, dtype, device)


class DecBlock(nn.Module):
    """One decoder layer: ``_dec_layer_init``'s leaves."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = _norm(d, dtype, device)
        self.self_attn = _mix_leaves(cfg, "attn", dtype, device)
        self.norm_x = _norm(d, dtype, device)
        self.cross_attn = _mix_leaves(cfg, "attn", dtype, device)
        self.norm2 = _norm(d, dtype, device)
        self.ffn = _mlp_leaves(d, cfg.d_ff, dtype, device)


class EncDecTransformer(SeededParams):
    """Encoder over stub frames + causal decoder with cross-attention."""

    def __init__(self, cfg: ArchConfig, shcfg: ShardingConfig, device, *,
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.shcfg = shcfg
        self.train_layout = train
        self.device = torch.device(device)
        self.attn_impl = "kernels" if shcfg.use_kernels else "chunked"
        cdt = self._cdt = dtype_of(cfg.compute_dtype)
        pdt = dtype_of(cfg.param_dtype)
        held = pdt if train else cdt  # the dtype the leaves are held in
        d, dev = cfg.d_model, self.device
        self.frame_proj = _param((d, d), held, dev)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, held, dev) for _ in range(cfg.n_enc_layers))
        self.enc_norm = _norm(d, pdt, dev)
        self.tok_embed = _param((cfg.vocab, d), held, dev)
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, held, dev) for _ in range(cfg.n_layers))
        self.final_norm = _norm(d, pdt, dev)
        self.lm_head = _param((d, cfg.vocab), held, dev)
        if train:
            self.requires_grad_(True)

    def _leaves(self, layer: nn.Module):
        """A layer's leaves in the compute dtype (a training model casts its
        fp32 masters here, differentiably; a placed one gathers them over
        their data axes)."""
        return local_leaves(layer, self._cdt if self.train_layout else None)

    def _attn_kw(self, rope: bool = True):
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim,
                    rope_theta=cfg.rope_theta if rope else 0.0,
                    impl=self.attn_impl)

    def _ffn(self, lp, h, tp):
        """The SwiGLU, tensor-parallel where its hidden dim is split."""
        return mlp_apply(lp.ffn, rmsnorm(lp.norm2, h),
                         tp if lp.ffn["w_gate"].shape[-1] != self.cfg.d_ff
                         else None)

    def _norm(self, norm, h):
        return rmsnorm({"scale": gather_data(norm["scale"])}, h)

    def _head_tp(self, mesh):
        return vocab_tp(self.lm_head, self.cfg.vocab, mesh, dim=-1)

    # ------------------------------------------------------------ encoder
    def encode(self, frames, mesh=None):
        """frames (B, S_enc, d) stub embeddings → encoder memory (B, S_enc,
        d) in the compute dtype."""
        cdt, tp = self._cdt, model_shard(mesh)
        h = (frames.to(device=self.device, dtype=cdt)
             @ gather_data(self.frame_proj).to(cdt))
        for layer in self.enc_blocks:
            lp = self._leaves(layer)
            h = h + attn_apply(lp.attn, rmsnorm(lp.norm1, h), causal=False,
                               tp=tp, **self._attn_kw())
            h = h + self._ffn(lp, h, tp)
        return self._norm(self.enc_norm, h)

    # ------------------------------------------------------------ decoder
    def _dec_layer(self, lp, h, memory, mem_in, tp=None):
        """One decoder layer over a sequence.  Returns (h, ((k, v), (mk,
        mv))): the self-attention K/V (B,S,K,hd) and the cross memory's
        (B,S_enc,K,hd), the KV heads this rank holds under ``tp``
        (``mem_in`` is ``memory`` through ``replicated_in``)."""
        cfg = self.cfg
        K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        y, kv = attn_apply(lp.self_attn, rmsnorm(lp.norm1, h), causal=True,
                           return_kv=True, tp=tp, **self._attn_kw())
        h = h + y
        # cross attention: K/V from the encoder memory, no RoPE
        ca = lp.cross_attn
        tpc = tp if tp_sharded(ca, cfg.n_heads, hd, tp) else None
        mk = kv_project(memory, ca["wk"], K, hd, tpc, mem_in)
        mv = kv_project(memory, ca["wv"], K, hd, tpc, mem_in)
        h = h + attn_apply(ca, rmsnorm(lp.norm_x, h), causal=False,
                           kv_override=(mk, mv), tp=tp,
                           **self._attn_kw(rope=False))
        h = h + self._ffn(lp, h, tp)
        return h, (kv, (mk, mv))

    def decode_forward(self, tokens, memory, *, return_cache: bool = False,
                       mesh=None):
        """tokens (B,S) against ``memory`` → (final-normed h (B,S,d), the
        per-layer ``((k, v), (mk, mv))`` | None)."""
        tp = model_shard(mesh)
        table = gather_data(self.tok_embed)
        h = vocab_embed(table, tokens, vocab_tp(self.tok_embed,
                                                self.cfg.vocab, mesh))
        h = h.to(self._cdt)
        mem_in = replicated_in(memory, tp.group if tp is not None else None)
        states = []
        for layer in self.dec_blocks:
            h, st = self._dec_layer(self._leaves(layer), h, memory, mem_in,
                                    tp)
            if return_cache:
                states.append(st)
        return (self._norm(self.final_norm, h),
                (states if return_cache else None))

    def loss(self, batch, *, mesh=None):
        """batch: {frames (B,S_enc,d), tokens (B,S), labels (B,S), [mask]}
        → (nll, {"nll", "aux"}), the NLL by :func:`chunked_xent` over
        ``shcfg.logits_chunk`` positions (0: :data:`LOGITS_CHUNK`); under
        ``mesh`` the batch is this rank's rows."""
        memory = self.encode(batch["frames"], mesh)
        h, _ = self.decode_forward(batch["tokens"], memory, mesh=mesh)
        nll = chunked_xent(h, gather_data(self.lm_head), batch["labels"],
                           batch.get("mask"),
                           chunk=self.shcfg.logits_chunk or LOGITS_CHUNK,
                           tp=self._head_tp(mesh))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return nll, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------ serving
    def prefill(self, tokens, frames, *, cache_len: Optional[int] = None,
                cache_dtype=torch.bfloat16, mesh=None):
        """Encode, then run the decoder over the prompt.  Returns
        (last-position logits (B,V) fp32, cache): per layer ``self_k`` /
        ``self_v`` (B,K,cache_len,hd), zero-padded, and ``cross_k`` /
        ``cross_v`` (B,K,S_enc,hd) — this rank's KV heads under ``mesh``."""
        memory = self.encode(frames, mesh)
        h, states = self.decode_forward(tokens, memory, return_cache=True,
                                        mesh=mesh)
        cache_len = cache_len or tokens.shape[1]

        def pack(x, length=None):  # (B,S,K,hd) -> (B,K,length,hd)
            x = x.transpose(1, 2).to(cache_dtype)
            return x if length is None else F.pad(
                x, (0, 0, 0, length - x.shape[2]))

        cache = [{"self_k": pack(k, cache_len), "self_v": pack(v, cache_len),
                  "cross_k": pack(mk), "cross_v": pack(mv)}
                 for (k, v), (mk, mv) in states]
        logits = vocab_logits(h[:, -1], gather_data(self.lm_head),
                              self._head_tp(mesh))
        return logits, cache

    def init_cache(self, batch: int, cache_len: int, enc_len: int,
                   cache_dtype=torch.bfloat16, device=None):
        """The slab decode cache (zeros), one dict per decoder layer."""
        cfg = self.cfg
        K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        dev = self.device if device is None else device

        def z(n):
            return torch.zeros((batch, K, n, hd), dtype=cache_dtype,
                               device=dev)

        return [{"self_k": z(cache_len), "self_v": z(cache_len),
                 "cross_k": z(enc_len), "cross_v": z(enc_len)}
                for _ in range(cfg.n_layers)]

    def init_paged_cache(self, batch: int, cache_len: int, enc_len: int, *,
                         n_pages: int, page_size: int,
                         cache_dtype=torch.bfloat16):
        """Paged decode cache: self-attention K/V pools (n_pages, K,
        page_size, hd), coded ``"kv0"``, and the slot-major cross memory,
        coded ``"state0"``.  Returns ``(cache, layout)``."""
        slab = self.init_cache(batch, cache_len, enc_len, cache_dtype, "meta")
        layout = [dict(CACHE_LAYOUT) for _ in slab]
        return paginate_cache(slab, layout, n_pages=n_pages,
                              page_size=page_size, device=self.device)

    @property
    def supports_chunked_prefill(self) -> bool:
        return False  # the encoder memory is not rebuilt chunk by chunk

    def decode_step(self, token, cache, pos, *, pages=None, mesh=None,
                    seq_cache: bool = False):
        """token (B,) ids; pos scalar or (B,) positions; ``pages`` the page
        table of the self-attention pools (None: the slab cache of
        :meth:`init_cache`); ``seq_cache``: a placed slab cache split over
        ``"model"`` along its sequence.  Pools and slabs are updated in
        place; returns (logits (B,V) fp32, cache)."""
        tp = model_shard(mesh, seq_cache=seq_cache)
        x = vocab_embed(gather_data(self.tok_embed), token,
                        vocab_tp(self.tok_embed, self.cfg.vocab, mesh))
        x = x.to(self._cdt)[:, None, :]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        pos = pos if pos.dim() else pos.expand(x.shape[0])
        slots = None
        if pages is not None and cache:
            slots = page_slots(pages, pos, cache[0]["self_k"].shape[2])
        new = []
        for layer, st in zip(self.dec_blocks, cache):
            lp = self._leaves(layer)
            y, sk, sv = attn_decode(
                lp.self_attn, rmsnorm(lp.norm1, x), st["self_k"],
                st["self_v"], pos, page_table=pages, slots=slots, tp=tp,
                **self._attn_kw())
            x = x + y
            y, _, _ = attn_decode(
                lp.cross_attn, rmsnorm(lp.norm_x, x), st["cross_k"],
                st["cross_v"], pos, cross=True, tp=tp,
                **self._attn_kw(rope=False))
            x = x + y
            x = x + self._ffn(lp, x, tp)
            new.append(dict(st, self_k=sk, self_v=sv))
        x = self._norm(self.final_norm, x)[:, 0]
        return vocab_logits(x, gather_data(self.lm_head),
                            self._head_tp(mesh)), new
