"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

Each function computes the same function as its CUDA kernel and is what
the kernel wrappers in :mod:`repro_torch.kernels.ops` run for a CPU
tensor; ``chip_smoke.py`` holds each kernel against it on the card.  All
compute in fp32 from upcast inputs and return the input's dtype (``q``'s,
``x``'s) — the kernels' contract; float64, which no kernel takes, stays
float64 (the gradient checks).  In fp32 that is exactly the JAX oracle's
arithmetic (the parity tests compare at fp32); in bf16 the oracle's
intermediate roundings are not repeated.

The causal mask is ``kpos <= qpos`` aligned top-left, as in the flash kernel
and ``naive_attention``.  The JAX oracle ``flash_attention_ref`` aligns it
bottom-right (``tril(k=Sk-Sq)``); the two agree when ``Sq == Sk``, the only
case any caller or test uses.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _wide(t):
    """``t`` in fp32, or float64 if it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _causal_mask(Sq: int, Sk: int, device):
    """(Sq, Sk) bool: key ``kpos <= qpos``, aligned top-left."""
    return (torch.arange(Sk, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None])


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        return_lse: bool = False):
    """q (B,H,Sq,hd); k/v (B,K,Sk,hd) with K dividing H. Returns (B,H,Sq,hd),
    and with ``return_lse`` also the (B,H,Sq) log-sum-exp of each row's
    scaled scores (natural log, fp32; the kernel's second output)."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    kk, vv = k.float(), v.float()
    if K != H:
        kk = kk.repeat_interleave(H // K, dim=1)
        vv = vv.repeat_interleave(H // K, dim=1)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if causal:
        mask = _causal_mask(Sq, Sk, q.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_backward_ref(q, k, v, o, lse, do, *, causal: bool = True):
    """(dq, dk, dv) of flash attention for the cotangent ``do`` of its
    output ``o``, from the forward's log-sum-exp ``lse`` (B,H,Sq), written
    out as the backward kernel computes it, in fp32: ``D = rowsum(do·o)``,
    ``P = exp(scale·QKᵀ − lse)`` (0 where masked; scale 1/sqrt(hd), the
    forward's), ``dV = Pᵀ dO``, ``dS = P ∘ (dO Vᵀ − D)``,
    ``dQ = scale·dS K``, ``dK = scale·dSᵀ Q``;
    each KV head's dK and dV sum its H/K query heads.  Returns q's, k's
    and v's dtypes."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qf, kf, vf, of, gf = (_wide(t) for t in (q, k, v, o, do))
    kk = kf.repeat_interleave(G, dim=1) if G > 1 else kf
    vv = vf.repeat_interleave(G, dim=1) if G > 1 else vf
    scale = 1.0 / math.sqrt(hd)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
                  - lse.to(qf.dtype)[..., None])
    if causal:
        p = torch.where(_causal_mask(Sq, Sk, q.device)[None, None], p,
                        torch.zeros((), dtype=p.dtype, device=p.device))
    dsum = (gf * of).sum(-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vv) - dsum[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dk = dk.reshape(B, K, G, Sk, hd).sum(2)
    dv = dv.reshape(B, K, G, Sk, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths, *,
                        sm_scale: Optional[float] = None):
    """Reference gather for paged decode attention.

    q (B,H,hd); k/v pools (P,K,ps,hd); page_table (B,n_pp) physical page
    ids; lengths (B,) — positions ``kpos <= lengths[b]`` are valid.  The
    pool is gathered back into the per-row slab layout and scored like the
    slab decode path.  Returns (B,H,hd)."""
    B, H, hd = q.shape
    K, ps = k_pool.shape[1], k_pool.shape[2]
    n_pp = page_table.shape[1]
    S = n_pp * ps
    table = page_table.long()

    def gather(pool):
        g = pool[table]  # (B, n_pp, K, ps, hd)
        return g.permute(0, 2, 1, 3, 4).reshape(B, K, S, hd).float()

    kk, vv = gather(k_pool), gather(v_pool)
    if K != H:
        kk = kk.repeat_interleave(H // K, dim=1)
        vv = vv.repeat_interleave(H // K, dim=1)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kk) * scale
    valid = torch.arange(S, device=q.device)[None, :] <= lengths.long()[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vv).to(q.dtype)


def grouped_matmul_ref(x, w, group_sizes=None):
    """x (E,C,d) @ w (E,d,f) → (E,C,f) in x's dtype, with the rows
    ``>= group_sizes[e]`` of group ``e`` exactly zero (``None``: every
    group is full)."""
    y = torch.einsum("ecd,edf->ecf", _wide(x), _wide(w))
    if group_sizes is not None:
        C = x.shape[1]
        live = (torch.arange(C, device=x.device)[None, :]
                < group_sizes.to(x.device)[:, None])  # (E, C)
        y = torch.where(live[..., None], y, torch.zeros((), device=x.device))
    return y.to(x.dtype)


def rglru_scan_ref(a, b):
    """h_t = a_t·h_{t-1} + b_t over a, b (B,S,D) from a zero state: a
    sequential loop over S with an fp32 carry (the multiply and the add
    rounded separately), each step rounded once to a's dtype."""
    a32, b32 = _wide(a), _wide(b)
    h = torch.zeros_like(a32[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h.to(a.dtype)
    return out


def rglru_scan_backward_ref(a, h, g):
    """(da, db) of ``h = rglru_scan_ref(a, b)`` for the cotangent ``g`` of
    h, as the reverse scan kernel computes them: a loop over t from S-1
    down to 0 with a wide carry, ``dh_t = a_{t+1}·dh_{t+1} + g_t`` (a_S =
    0; the multiply and the add rounded separately), dh_t rounded once to
    a's dtype; ``db = dh`` and ``da_t = dh_t·h_{t-1}`` in a's dtype (h_{-1}
    = 0)."""
    a32, g32 = _wide(a), _wide(g.to(a.dtype))
    S = a.shape[1]
    zero = torch.zeros_like(a32[:, 0])
    carry = zero
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(S - 1, -1, -1):
        carry = (a32[:, t + 1] if t + 1 < S else zero) * carry + g32[:, t]
        dh = carry.to(a.dtype)
        db[:, t] = dh
        da[:, t] = dh * (h[:, t - 1] if t > 0 else zero.to(a.dtype))
    return da, db
