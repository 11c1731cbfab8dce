"""Attention: GQA with RoPE / qk-norm, full-sequence, chunked, sliding-
window, cross-attention, paged-decode and circular-buffer decode paths.

Port of ``repro/models/attention.py``: ``naive_attention`` (with its
window mask), ``chunked_attention`` (online softmax over Q and KV chunks,
the reference's kernels-off path past 256 tokens), ``local_attention``,
``attn_apply`` (with the JAX dispatch rule: the flash kernel when kernels
are on, ``window == 0`` and ``S > 256``; otherwise naive when ``S <=
256``, ``local_attention`` when ``window > 0`` and ``chunked_attention``
else — ``impl="naive"`` always takes the naive path — and ``kv_override``
for cross-attention), ``paged_gather``, ``page_slots``/``paged_scatter``,
four branches of ``attn_decode`` — the paged one (the paged-decode kernel
when kernels are on, the reference gather otherwise), the full-attention
slab one (plain arithmetic over the per-row cache, as in JAX: no kernel),
the slab one of a local layer, a circular buffer of the last ``W`` tokens
per row, and the cross one over a fixed slot-major encoder memory — and
``attn_prefill_chunk``, one chunk of a chunked prefill against the page
pool (plain PyTorch, as the JAX one is plain XLA).  The JAX code is
functional and returns new caches; here ``paged_scatter``, the chunk's
scatter and the slab writes update the caches in place (``index_put_``),
where the JAX decode step donates them.

Tensor parallelism (``tp``, a :class:`~repro_torch.parallel.mesh.
ModelShard`, with the projections placed by the rules): ``wq``/``wk``/
``wv`` are column-parallel (the input enters through ``replicated_in``),
``wo`` row-parallel (the output leaves through ``sum_out``), and each
rank attends over its own query heads, read from the local shapes.
Under Megatron-SP (``tp.seq``) the input arrives gathered over the
sequence and the output is reduce-scattered back onto this rank's
positions (``collectives.tp_in``/``tp_out``).  A
``"model"`` shard that splits a head (``wk`` of 8 KV heads on a 16-way
axis) is all-gathered over ``"model"`` before attention, and a
replicated ``wk`` enters through ``replicated_in``, so every rank picks
the KV heads its query heads read.  Windowed attention runs on the
local heads as full attention does; cross attention projects q
column-parallel and reads the KV heads of the encoder memory this rank
holds (:func:`kv_project`, the caller's).  In a decode whose slab cache
is split over ``"model"`` along the sequence (a local layer's circular
buffer or a cross memory likewise), every rank scores all query heads
over its positions, only the rank holding the new position writes it,
and the partials are merged by log-sum-exp over ``"model"``.  Paged
decode under ``tp`` raises: the placed serve step decodes from a slab,
as JAX's does.  GSPMD computes the same functions from the same specs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops
from ..parallel.collectives import (all_reduce_, gather_shards, max_over,
                                    replicated_in, tp_in, tp_out)
from .layers import apply_rope, dense_init, rms_normalize

NEG_INF = -1e30
IMPLS = ("naive", "chunked", "kernels")


def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
              head_dim: int, dtype=torch.float32, device=None):
    """The projections ``wq``/``wk``/``wv``/``wo``, N(0, 1/fan-in) each."""
    return {
        "wq": dense_init(gen, d, n_heads * head_dim, dtype, device=device),
        "wk": dense_init(gen, d, n_kv * head_dim, dtype, device=device),
        "wv": dense_init(gen, d, n_kv * head_dim, dtype, device=device),
        "wo": dense_init(gen, n_heads * head_dim, d, dtype, device=device),
    }


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _repeat_kv(k, n_heads):
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H/K times."""
    K = k.shape[2]
    if K == n_heads:
        return k
    return k.repeat_interleave(n_heads // K, dim=2)


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd) already head-repeated. Returns (B,Sq,H,hd)."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal or window > 0:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = torch.where(mask[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      kv_chunk: int = 1024, q_offset: int = 0):
    """Online-softmax attention over Q chunks (outer) and KV chunks (inner),
    O(Sk·chunk) memory: q (B,Sq,H,hd), k/v (B,Sk,H,hd) head-repeated →
    (B,Sq,H,hd).  The causal mask is top-left with queries at ``q_offset +
    i``.  Scores, the running (max, denominator) and the accumulator are
    fp32; the output takes q's dtype.

    The JAX version pads Q and KV to whole chunks and masks the padded
    keys; here the last chunks are sliced short, which drops only masked
    scores (exactly zero weight).  KV blocks past the diagonal of a
    chunk's last query are skipped, as JAX skips them with ``lax.cond``;
    the first block always holds a visible key, so every row's running
    max is finite before any skipped or fully masked block."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0: q0 + q_chunk]
        c = qc.shape[1]
        qpos = torch.arange(c, device=q.device) + q0 + q_offset
        m = l = acc = None
        for k0 in range(0, Sk, kv_chunk):
            if causal and k0 > q0 + c - 1 + q_offset:
                break  # every later block lies above the diagonal
            kc, vc = k[:, k0: k0 + kv_chunk], v[:, k0: k0 + kv_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() * scale
            if causal:
                kpos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
                s = torch.where(kpos[None, :] <= qpos[:, None], s,
                                torch.full_like(s, NEG_INF))
            if m is None:
                m = torch.full(s.shape[:-1], NEG_INF, dtype=torch.float32,
                               device=q.device)
                l = torch.zeros_like(m)
                acc = torch.zeros((*m.shape, hd), dtype=torch.float32,
                                  device=q.device)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vc.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))  # (B,c,H,hd)
    return torch.cat(outs, dim=1)


def local_attention(q, k, v, *, window: int, q_chunk: int = 512):
    """Causal attention restricted to the last ``window`` positions, over q
    chunks: a chunk of ``c`` queries scores only the keys it can see, the
    ``window + c`` positions ending at its last query — O(S·(W+c)) work
    instead of O(S²).  q (B,Sq,H,hd), k/v (B,Sk,H,hd) head-repeated.

    The JAX version pads K/V on the left by ``window`` and masks the pad;
    here the slice is clipped to the keys that exist, which drops only
    masked scores (exactly zero weight), so both compute the same sums
    wherever the chunks tile S.  On a ragged last chunk the JAX slice runs
    past the padded keys and is clamped, which shifts them (a fault of the
    reference, ROADMAP queue 3); this version keeps the window's keys."""
    Sq, hd = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = q[:, q0: q0 + q_chunk]
        lo, hi = max(q0 - window, 0), min(q0 + q_chunk, Sk)
        kc, vc = k[:, lo:hi], v[:, lo:hi]
        qpos = torch.arange(qc.shape[1], device=q.device) + q0
        kpos = torch.arange(lo, hi, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() / math.sqrt(hd)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window))
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype), vc))
    return torch.cat(outs, dim=1)


def _attend(q, k, v, *, causal: bool, window: int, impl: str):
    """JAX's dispatch on q (B,S,H,hd) over k/v (B,Sk,K,hd): the flash
    kernel when kernels are on, ``window == 0`` and ``S > 256``;
    otherwise naive when ``S <= 256`` (or ``impl="naive"``),
    ``local_attention`` when ``window > 0``, ``chunked_attention`` else.
    Returns (B,S,H,hd)."""
    S, H = q.shape[1], q.shape[2]
    if impl == "kernels" and window == 0 and S > 256:
        # flash kernel: head-major views, GQA-native (no KV repeat)
        return ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal,
        ).transpose(1, 2)
    kfull, vfull = _repeat_kv(k, H), _repeat_kv(v, H)
    if impl == "naive" or S <= 256:
        return naive_attention(q, kfull, vfull, causal=causal, window=window)
    if window > 0:
        return local_attention(q, kfull, vfull, window=window)
    return chunked_attention(q, kfull, vfull, causal=causal)


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
    window: int = 0,
    positions: Optional[torch.Tensor] = None,
    impl: str = "naive",
    kv_override=None,
    return_kv: bool = False,
    tp=None,
):
    """Full (``window == 0``) or sliding-window attention block on (B, S,
    d). Optionally returns (k, v) for caches.  ``kv_override=(k, v)``
    (B, Sk, K, hd) supplies externally computed keys and values
    (cross-attention): only q is projected, normed and, when ``rope_theta
    > 0``, rotated.  The dispatch reads the query length ``S``.  Under
    ``tp`` with a model-sharded ``wq`` (see the module doc) the returned
    (k, v) are the KV heads this rank holds."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    B, S, _ = x.shape
    pos = (positions if positions is not None
           else torch.arange(S, device=x.device)[None, :])
    tp = tp if tp_sharded(params, n_heads, head_dim, tp) else None
    if kv_override is None:
        q, k, v, q0, k0 = _project(params, x, n_kv, head_dim, tp)
        if qk_norm:
            q, k = rms_normalize(q), rms_normalize(k)
        if rope_theta > 0:
            k = apply_rope(k, pos, rope_theta)
    else:  # the KV heads of the memory this rank holds
        q, q0 = _q_project(params, replicated_in(
            x, tp.group if tp is not None else None), head_dim, tp)
        k, v = kv_override
        k0 = _first_head(k.shape[2], n_kv, tp)
        if qk_norm:
            q = rms_normalize(q)
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
    g = n_heads // n_kv
    ka, va = (_kv_for(k, q0, q.shape[2], k0, g),
              _kv_for(v, q0, q.shape[2], k0, g))
    out = _attend(q, ka, va, causal=causal, window=window, impl=impl)
    y = _out_proj(out, params["wo"], q0, tp)
    if return_kv:
        return y, (k, v)
    return y


def tp_sharded(params, n_heads: int, head_dim: int, tp) -> bool:
    """Whether this layer's attention is tensor-parallel: a ``"model"``
    axis and a ``wq`` holding less than all the query heads' columns."""
    return tp is not None and params["wq"].shape[-1] != n_heads * head_dim


def _q_project(params, x_in, hd: int, tp, *, all_q: bool = False):
    """(q (B,S,Hq,hd) of the global query heads from ``q0``, q0) of x_in
    (B, S, d, entered through ``replicated_in`` under ``tp``);
    column-parallel, all-gathered where the shard splits a head (or with
    ``all_q``)."""
    group, rank = (tp.group, tp.rank) if tp is not None else (None, 0)
    q = x_in @ params["wq"]
    if all_q or q.shape[-1] % hd:
        q, q0 = gather_shards(q, group, -1), 0
    else:
        q0 = rank * (q.shape[-1] // hd)
    return _split_heads(q, q.shape[-1] // hd, hd), q0


def kv_project(x, w, n_kv: int, hd: int, tp, x_in=None):
    """x (B, S, d) @ ``wk`` or ``wv`` as (B, S, Kh, hd), the KV heads this
    rank holds under ``tp`` (see :func:`_first_head`): its columns of
    ``x_in`` (x through ``tp_in``, made here unless given), all of them
    all-gathered where the shard splits a head, or a replicated ``w``'s
    product entering through ``replicated_in`` (under Megatron-SP ``w``
    itself enters through it: x is the gathered input, whose cotangent
    each rank holds in part)."""
    group = tp.group if tp is not None else None
    if w.shape[-1] == n_kv * hd and tp is not None and tp.seq:
        # every KV head from the gathered input (Megatron-SP): each rank's
        # cotangent is its query heads' part, the weight's gradient summed
        y = x @ replicated_in(w, group)
    elif w.shape[-1] == n_kv * hd:  # every KV head (replicated)
        y = replicated_in(x @ w, group)
    else:
        y = (tp_in(x, tp) if x_in is None else x_in) @ w
        if y.shape[-1] % hd:  # the shard splits a head
            y = gather_shards(y, group, -1)
    return _split_heads(y, y.shape[-1] // hd, hd)


def _first_head(n_held: int, n_kv: int, tp) -> int:
    """The global index of the first of ``n_held`` KV heads a rank holds:
    0 when it holds all ``n_kv``, else its block's."""
    return 0 if tp is None or n_held == n_kv else tp.rank * n_held


def _project(params, x, n_kv: int, hd: int, tp, *, all_q: bool = False):
    """The projections of x (B, S, d): (q (B,S,Hq,hd) of the global query
    heads from ``q0``, k, v (B,S,Kh,hd) of the KV heads from ``k0``, q0,
    k0); without ``tp`` every head, from 0 (see :func:`_q_project` and
    :func:`kv_project`)."""
    x_in = tp_in(x, tp)
    q, q0 = _q_project(params, x_in, hd, tp, all_q=all_q)
    k = kv_project(x, params["wk"], n_kv, hd, tp, x_in)
    v = kv_project(x, params["wv"], n_kv, hd, tp, x_in)
    return q, k, v, q0, _first_head(k.shape[2], n_kv, tp)


def _kv_for(k, q0: int, n_q: int, k0: int, group: int, dim: int = 2):
    """The KV heads (along ``dim``) that query heads ``q0 .. q0+n_q-1`` read,
    of the heads ``k0 ..`` held in ``k`` (``group`` query heads per KV
    head): ``k`` itself when they are all of them, a slice when they map
    as GQA lays them out, else one KV head a query head."""
    idx = [(q0 + j) // group - k0 for j in range(n_q)]
    lo, hi = idx[0], idx[-1] + 1
    if n_q % (hi - lo) == 0 and idx == [lo + j // (n_q // (hi - lo))
                                        for j in range(n_q)]:
        return k if hi - lo == k.shape[dim] else k.narrow(dim, lo, hi - lo)
    return k.index_select(dim, torch.tensor(idx, device=k.device))


def _out_proj(out, wo, q0: int, tp):
    """out (B, S, Hq, hd), global query head ``q0`` first, through ``wo``
    (operands promoted as JAX promotes them).  Under ``tp`` ``wo`` is
    row-parallel: only the columns of out that meet this rank's rows
    enter, and the product leaves through ``tp_out``."""
    B, S, hq, hd = out.shape
    out = out.reshape(B, S, hq * hd)
    if tp is not None:
        lo = tp.rank * wo.shape[0] - q0 * hd
        out = out[..., lo:lo + wo.shape[0]]
    y = out.to(torch.promote_types(out.dtype, wo.dtype)) @ wo
    return tp_out(y, tp)


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
    window: int = 0,
    cross: bool = False,
    cross_len=None,
    page_table: Optional[torch.Tensor] = None,
    slots=None,
    impl: str = "naive",
    tp=None,
):
    """One-token decode. x (B,1,d); pos is a scalar or a (B,) vector of
    per-row positions.  Returns (y, cache_k, cache_v), the caches updated
    in place.

    Paged (full attention, ``page_table`` given): cache_k/v are the shared
    pools (n_pages, K, page_size, hd) and ``page_table`` (B, n_pp) maps each
    row's logical pages to physical ones.  The new token's K/V is scattered
    at ``slots``, which the caller may compute once per decode step with
    :func:`page_slots`, then attended: by the paged-decode kernel when
    ``impl="kernels"``, else by gathering the row's pages back into the slab
    layout.

    Slab, full attention (no ``page_table``, ``window == 0``): cache_k/v
    (B, K, S, hd) hold each row's positions ``0..S-1``.  The new token is
    written at the row's own position, clamped to S-1 as JAX's
    ``dynamic_update_slice`` clamps it (a freed slot's stale row rides
    along at ``pos == S``: the clamp keeps the write inside the row, so
    the cache equals JAX's leaf for leaf), and scored over the whole
    cache with keys ``<= pos`` valid, ``p`` rounded to the cache's dtype.
    No kernel runs on this branch, as in JAX.

    Slab (a local layer, ``window > 0``): cache_k/v (B, K, W, hd) are a
    circular buffer per row holding its last ``min(pos+1, window)`` tokens.
    The new token is written at ``pos % W``, W the buffer's own length.  For
    a live row that is JAX's ``pos % window`` (W == window, or pos < W ==
    cache_len); a freed slot's stale row can reach ``pos == cache_len ==
    W``, which JAX's ``dynamic_update_slice`` clamps to W-1 and which here
    wraps to 0 — both land in the stale row's own buffer, which admission
    overwrites.

    Cross (``cross=True``): cache_k/v (B, K, S_enc, hd) are a fixed
    slot-major encoder memory.  Nothing is written, q is not rotated, and
    keys below ``cross_len`` (all of them when it is None) are valid.  As
    in JAX this path is plain arithmetic (no kernel), with the same fp32
    scores and ``p`` rounded to the memory's dtype.

    Under ``tp`` with a model-sharded ``wq`` (slab and cross only: paged
    raises) the cache holds this rank's KV heads, or (with
    ``tp.seq_cache``) all KV heads at this rank's block of positions (of
    the whole buffer, the circular one of a local layer, or the cross
    memory): then only the rank holding the new position's slot writes
    it, every rank scores all query heads over its positions and the
    partial softmaxes are merged by log-sum-exp over ``"model"``."""
    paged = page_table is not None
    if paged and (cross or window > 0):
        raise ValueError("paged KV applies to full causal self-attention only")
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos_b = pos if pos.dim() else pos.expand(B)  # (B,) per-row positions
    tp = tp if tp_sharded(params, n_heads, head_dim, tp) else None
    if tp is not None and paged:
        raise NotImplementedError(
            "tensor-parallel paged decode is not ported: the placed serve "
            "step decodes from a slab, as JAX's does")
    seq = tp is not None and tp.seq_cache
    W = cache_k.shape[2]  # this rank's positions of the slab or memory
    base = tp.rank * W if seq else 0
    kpos = torch.arange(W, device=x.device)[None, :] + base
    if cross:
        q, q0 = _q_project(params, replicated_in(
            x, tp.group if tp is not None else None), head_dim, tp,
            all_q=seq)
        k0 = 0 if seq else _first_head(cache_k.shape[1], n_kv, tp)
        if qk_norm:
            q = rms_normalize(q)
        lim = (W * (tp.n if seq else 1) if cross_len is None else
               torch.as_tensor(cross_len, device=x.device).reshape(-1, 1))
        valid = (kpos < lim).expand(B, W)
        view_k, view_v = cache_k, cache_v
    else:
        q, k, v, q0, k0 = _project(params, x, n_kv, head_dim, tp, all_q=seq)
        if qk_norm:
            q, k = rms_normalize(q), rms_normalize(k)
        if rope_theta > 0:
            q = apply_rope(q, pos_b[:, None], rope_theta)
            k = apply_rope(k, pos_b[:, None], rope_theta)
    if paged:
        if slots is None:
            slots = page_slots(page_table, pos_b, cache_k.shape[2])
        paged_scatter(cache_k, slots, k[:, 0])
        paged_scatter(cache_v, slots, v[:, 0])
        if impl == "kernels":
            ctx = ops.paged_attention(
                q[:, 0].contiguous(), cache_k, cache_v,
                page_table.to(torch.int32), pos_b.contiguous(),
            )
            ctx = ctx.reshape(B, 1, n_heads, head_dim)
            return _out_proj(ctx, params["wo"], 0, None), cache_k, cache_v
        view_k = paged_gather(cache_k, page_table)
        view_v = paged_gather(cache_v, page_table)
        S = view_k.shape[2]
        valid = torch.arange(S, device=x.device)[None, :] <= pos_b[:, None]
    elif not cross:
        rows = torch.arange(B, device=x.device)
        whole = W * (tp.n if seq else 1)  # the buffer's length on all ranks
        if window > 0:
            slot = pos_b.long().remainder(whole) - base
            # circular buffer: slots hold the last min(pos+1, window) tokens
            valid = kpos < torch.clamp(pos_b + 1, max=window)[:, None]
        else:
            slot = pos_b.long().clamp(0, whole - 1) - base
            valid = kpos <= pos_b[:, None]
        if seq:
            own = (slot >= 0) & (slot < W)
            slot = slot.clamp(0, W - 1)
        for cache, new in ((cache_k, k), (cache_v, v)):
            new = new[:, 0].to(cache.dtype)
            if seq:
                new = torch.where(own[:, None, None], new, cache[rows, :, slot])
            cache[rows, :, slot] = new
        view_k, view_v = cache_k, cache_v
    g = n_heads // n_kv
    view_k = _kv_for(view_k, q0, q.shape[2], k0, g, dim=1)
    view_v = _kv_for(view_v, q0, q.shape[2], k0, g, dim=1)
    out = _decode_attend(q, view_k, view_v, valid, tp.group if seq else None)
    return _out_proj(out, params["wo"], q0, tp), cache_k, cache_v


def _decode_attend(q, view_k, view_v, valid, group=None):
    """The reference decode's scoring of q (B,1,H,hd) over a slab view (B,
    K, S, hd) with per-row validity (B, S): the attention output (B, 1, H,
    hd).  With ``group`` the view holds this rank's positions only: the
    partial softmaxes are merged by log-sum-exp over ``group``."""
    rep = q.shape[2] // view_k.shape[1]
    kk = view_k.repeat_interleave(rep, dim=1) if rep > 1 else view_k
    vv = view_v.repeat_interleave(rep, dim=1) if rep > 1 else view_v
    # JAX promotes mixed operands (e.g. fp32 compute over a bf16 cache);
    # torch's matmuls do not, so promote explicitly at the same places
    dt = torch.promote_types(q.dtype, kk.dtype)
    s = torch.einsum("bqhd,bhkd->bhqk", q.to(dt), kk.to(dt)).float()
    s = s / math.sqrt(q.shape[3])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if group is not None:
        m = max_over(s.amax(dim=-1), group)
        e = torch.exp(s - m[..., None])
        den = all_reduce_(e.sum(dim=-1), group)
        acc = all_reduce_(torch.einsum("bhqk,bhkd->bqhd", e, vv.float()),
                          group)
        return (acc / den.transpose(1, 2)[..., None]).to(dt)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bqhd", p.to(vv.dtype), vv)


def attn_prefill_chunk(
    params,
    x,
    pool_k,
    pool_v,
    page_table,
    pos0: int,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    qk_norm: bool = False,
):
    """One prefill chunk against a paged cache (JAX ``attn_prefill_chunk``).

    x (B, C, d) holds the chunk's embeddings for positions ``pos0 ..
    pos0+C-1`` (the same ``pos0`` for every row: a chunk job's rows share
    one prompt length and advance in lockstep).  The chunk's K/V is
    scattered into the pools in place through ``page_table[:, pos //
    page_size]``, then the whole prefix ``[0, pos0+C)`` is gathered back
    and scored with :func:`naive_attention` at ``q_offset=pos0`` — so with
    a lossless cache dtype the last chunk's outputs equal a one-shot
    prefill's.  Returns (y (B, C, d), pool_k, pool_v)."""
    B, C, _ = x.shape
    ps = pool_k.shape[2]
    seen = pos0 + C  # prefix length after this chunk
    q = _split_heads(x @ params["wq"], n_heads, head_dim)  # (B,C,H,hd)
    k = _split_heads(x @ params["wk"], n_kv, head_dim)
    v = _split_heads(x @ params["wv"], n_kv, head_dim)
    if qk_norm:
        q, k = rms_normalize(q), rms_normalize(k)
    pos = (pos0 + torch.arange(C, device=x.device))[None, :]
    if rope_theta > 0:
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)

    # scatter the chunk through the page tables (all C positions at once)
    pg = page_table.long()[:, pos[0] // ps]  # (B, C)
    off = (pos[0] % ps).expand(B, C)
    pool_k[pg, :, off, :] = k.to(pool_k.dtype)
    pool_v[pg, :, off, :] = v.to(pool_v.dtype)

    # gather the prefix (past chunks + this one) back into the slab layout
    n_need = -(-seen // ps)
    kf = paged_gather(pool_k, page_table[:, :n_need])[:, :, :seen]
    vf = paged_gather(pool_v, page_table[:, :n_need])[:, :, :seen]
    kf = _repeat_kv(kf.transpose(1, 2).to(x.dtype), n_heads)
    vf = _repeat_kv(vf.transpose(1, 2).to(x.dtype), n_heads)
    out = naive_attention(q, kf, vf, causal=True, q_offset=pos0)
    y = out.reshape(B, C, n_heads * head_dim) @ params["wo"]
    return y, pool_k, pool_v
