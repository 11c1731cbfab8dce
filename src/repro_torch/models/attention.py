"""Attention: GQA with RoPE / qk-norm, full-sequence and paged-decode paths.

Port of ``repro/models/attention.py`` for this slice: ``naive_attention``,
``attn_apply`` (with the JAX dispatch rule: the flash kernel when kernels
are on and ``S > 256``, naive otherwise), ``paged_gather``,
``page_slots``/``paged_scatter`` and the paged branch of ``attn_decode`` (the paged-decode
kernel when kernels are on, the reference gather otherwise).  The chunked
and sliding-window paths, and slab/cross-attention decode, come with the
slices that use them.  The JAX code is functional and returns new caches;
here ``paged_scatter`` updates the page pools in place (``index_put_``),
where the JAX decode step donates them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops
from .layers import apply_rope, rms_normalize

NEG_INF = -1e30
IMPLS = ("naive", "kernels")


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _repeat_kv(k, n_heads):
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H/K times."""
    K = k.shape[2]
    if K == n_heads:
        return k
    return k.repeat_interleave(n_heads // K, dim=2)


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd) already head-repeated. Returns (B,Sq,H,hd)."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attn_apply(
    params,
    x,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    causal: bool = True,
    qk_norm: bool = False,
    positions: Optional[torch.Tensor] = None,
    impl: str = "naive",
    return_kv: bool = False,
):
    """Full attention block on (B, S, d). Optionally returns (k, v) for caches."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    B, S, _ = x.shape
    q = _split_heads(x @ params["wq"], n_heads, head_dim)
    k = _split_heads(x @ params["wk"], n_kv, head_dim)
    v = _split_heads(x @ params["wv"], n_kv, head_dim)
    if qk_norm:
        q, k = rms_normalize(q), rms_normalize(k)
    pos = (positions if positions is not None
           else torch.arange(S, device=x.device)[None, :])
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if impl == "kernels" and S > 256:
        # flash kernel: head-major views, GQA-native (no KV repeat)
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal,
        ).transpose(1, 2)
    else:
        out = naive_attention(q, _repeat_kv(k, n_heads), _repeat_kv(v, n_heads),
                              causal=causal)
    y = out.reshape(B, S, n_heads * head_dim) @ params["wo"]
    if return_kv:
        return y, (k, v)
    return y


def paged_gather(pool, page_table):
    """Per-row contiguous KV view of a paged pool: pool (P, K, ps, hd) +
    page_table (B, n_pp) → (B, K, n_pp * ps, hd), logical position ``p``
    at index ``p`` — the slab layout the reference decode scores."""
    B, n_pp = page_table.shape
    _, K, ps, hd = pool.shape
    g = pool[page_table.long()]  # (B, n_pp, K, ps, hd)
    return g.permute(0, 2, 1, 3, 4).reshape(B, K, n_pp * ps, hd)


def page_slots(page_table, pos_b, page_size: int):
    """Where each row's decode token lands in a paged pool: the (page,
    offset) of logical position ``pos_b`` (B,) through the row's table
    (B, n_pp), as two (B,) int64 tensors.  Rows whose table row is zeroed
    land in the trash page 0.  So does a row whose position lies outside
    the table (a stale slot riding along in the fixed-shape decode): the
    JAX scatter drops that write, and here it goes to the page that takes
    every write that must land nowhere, so no mapped page changes and no
    index leaves the table.  Live rows never read the trash page with
    nonzero weight, so racing writes there are harmless.  The slots are
    the same in every layer of a decode step."""
    n_pp = page_table.shape[1]
    pos = pos_b.long()
    lp = torch.div(pos, page_size, rounding_mode="floor")
    pg = page_table.long().gather(1, lp.clamp(0, n_pp - 1)[:, None])[:, 0]
    keep = (pos >= 0) & (lp < n_pp)
    return torch.where(keep, pg, 0), pos.remainder(page_size)


def paged_scatter(pool, slots, vals):
    """Write one token's K or V per row, vals (B, K, hd), into a paged pool
    in place at ``slots = page_slots(...)``.  Returns ``pool``."""
    pg, off = slots
    pool[pg, :, off, :] = vals.to(pool.dtype)
    return pool


def attn_decode(
    params,
    x,
    cache_k,
    cache_v,
    pos,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    qk_norm: bool = False,
    page_table: Optional[torch.Tensor] = None,
    slots=None,
    impl: str = "naive",
):
    """One-token decode against a paged cache. x (B,1,d); cache_k/v are the
    shared pools (n_pages, K, page_size, hd); ``page_table`` (B, n_pp) maps
    each row's logical pages to physical ones; pos is a scalar or a (B,)
    vector of per-row positions.  The new token's K/V is scattered (in
    place) at ``slots``, which the caller may compute once per decode step
    with :func:`page_slots`, then attended: by the paged-decode kernel when
    ``impl="kernels"``, else by gathering the row's pages back into the slab
    layout.  Returns (y, cache_k, cache_v)."""
    if page_table is None:
        raise NotImplementedError(
            "slab-layout decode is not ported yet (ROADMAP queue 1: slab "
            "layout and the other families); pass page_table")
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    B = x.shape[0]
    S = page_table.shape[1] * cache_k.shape[2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos_b = pos if pos.dim() else pos.expand(B)  # (B,) per-row positions
    q = _split_heads(x @ params["wq"], n_heads, head_dim)  # (B,1,H,hd)
    k = _split_heads(x @ params["wk"], n_kv, head_dim)
    v = _split_heads(x @ params["wv"], n_kv, head_dim)
    if qk_norm:
        q, k = rms_normalize(q), rms_normalize(k)
    if rope_theta > 0:
        q = apply_rope(q, pos_b[:, None], rope_theta)
        k = apply_rope(k, pos_b[:, None], rope_theta)
    if slots is None:
        slots = page_slots(page_table, pos_b, cache_k.shape[2])
    paged_scatter(cache_k, slots, k[:, 0])
    paged_scatter(cache_v, slots, v[:, 0])

    if impl == "kernels":
        ctx = ops.paged_attention(
            q[:, 0].contiguous(), cache_k, cache_v,
            page_table.to(torch.int32), pos_b.contiguous(),
        )
        y = ctx.reshape(B, 1, n_heads * head_dim) @ params["wo"]
        return y, cache_k, cache_v

    view_k = paged_gather(cache_k, page_table)
    view_v = paged_gather(cache_v, page_table)
    rep = n_heads // view_k.shape[1]
    kk = view_k.repeat_interleave(rep, dim=1) if rep > 1 else view_k
    vv = view_v.repeat_interleave(rep, dim=1) if rep > 1 else view_v
    # JAX promotes mixed operands (e.g. fp32 compute over a bf16 cache);
    # torch's matmuls do not, so promote explicitly at the same places
    dt = torch.promote_types(q.dtype, kk.dtype)
    s = torch.einsum("bqhd,bhkd->bhqk", q.to(dt), kk.to(dt)).float()
    s = s / math.sqrt(head_dim)
    valid = torch.arange(S, device=x.device)[None, :] <= pos_b[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bqhd", p.to(vv.dtype), vv)
    wo = params["wo"]
    out = out.reshape(B, 1, n_heads * head_dim)
    y = out.to(torch.promote_types(out.dtype, wo.dtype)) @ wo
    return y, cache_k, cache_v
