"""Recurrent sequence mixers: Griffin's block (RG-LRU and the causal
conv1d) and xLSTM's mLSTM and sLSTM cells (port of
``repro/models/recurrent.py``).

The functions take parameter mappings keyed by the JAX leaf names
(``w_x``, ``w_gate``, ``conv.w``, ``rglru.lam|w_r|w_i``, ``w_out``).  The
sequence path runs the recurrence through the hand-written scan kernel
(:func:`repro_torch.kernels.ops.rglru_scan`) when ``use_kernels`` is on,
and otherwise through a log-depth doubling scan, the counterpart of the
JAX model's ``lax.associative_scan`` (the JAX model never calls its own
Pallas scan; both compute the same recurrence).  Both are differentiable:
the kernel's autograd function runs the scan reversed for its gradient
(:func:`repro_torch.kernels.ops.rglru_scan_backward`), and the folded
initial state ``h0`` gets its gradient through the fold.  Decode is the
O(1)-state one-token update.

Precision, as in JAX: the gates are computed in fp32 (``w_r``/``w_i``
widened to fp32, ``lam`` always fp32), the state ``h`` is fp32, and the
block's output returns to the input's dtype.  ``jax.nn.gelu`` is the tanh
approximation.

The xLSTM cells (leaves ``wq wk wv w_if wo ogate`` for mLSTM, ``w_in r
wo`` for sLSTM) are plain PyTorch, as the JAX ones are plain XLA.  mLSTM
trains and prefills through the stabilised parallel form, chunked over
square query/key blocks (the blocks above the diagonal are skipped by a
static test on the block indices, where JAX's ``lax.cond`` skips them);
its prefill state is the closed form, and decode the O(1) recurrent
update.  sLSTM is a sequential scan, a Python loop over the tokens (JAX's
``lax.scan``).  Everything the gates touch is fp32 whatever the params'
dtype, as in JAX: the gate pre-activations are widened after their
product, ``F`` (the cumulative log forget gate), the stabiliser ``m``, the
running ``l``/``acc`` and the decode states (mLSTM ``C n m``, sLSTM ``c n
h m``; ``m`` starts at -1e30) are fp32, and sLSTM's ``r`` is widened at
every call.  The query-key and value products run in the input's dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops

RGLRU_C = 8.0  # Griffin's fixed gate-sharpness constant


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _rglru_gates(params, x):
    """Returns (log_a, gated_input) in fp32. x: (..., d_rnn)."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ params["w_r"].float())
    i = torch.sigmoid(x32 @ params["w_i"].float())
    # a = exp(-c · r · softplus(Λ));  log_a ≤ 0
    log_a = -RGLRU_C * r * F.softplus(params["lam"].float())
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return log_a, beta * (i * x32)


def _doubling_scan(a, b):
    """h_t = a_t·h_{t-1} + b_t along axis 1 in log2(S) doubling steps
    (Hillis-Steele): after the step of offset ``o`` each (a, b) pair
    composes the 2·o inputs ending at it."""
    S = a.shape[1]
    o = 1
    while o < S:
        b = torch.cat([b[:, :o], a[:, o:] * b[:, :-o] + b[:, o:]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return b


def rglru_apply(params, x, h0: Optional[torch.Tensor] = None, *,
                use_kernels: bool = False):
    """Sequence-parallel RG-LRU. x: (B, S, d_rnn); h0: optional (B, d_rnn)
    initial state.  Returns (y (B,S,d_rnn) in x's dtype, h_last (B,d_rnn)
    fp32)."""
    with torch.profiler.record_function("repro.rglru_gates"):
        log_a, b = _rglru_gates(params, x)  # (B,S,d), fp32
    a = torch.exp(log_a)
    if h0 is not None:
        # fold the initial state into the first input: h1 = a1·h0 + b1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    if use_kernels:
        h = ops.rglru_scan(a.contiguous(), b.contiguous())
    else:
        h = _doubling_scan(a, b)
    # a copy, so the decode handoff does not hold the whole (B,S,d) scan
    return h.to(x.dtype), h[:, -1].clone()


def rglru_decode(params, x_t, h):
    """One-token update. x_t: (B, d_rnn); h: (B, d_rnn) fp32 state."""
    log_a, b = _rglru_gates(params, x_t[:, None, :])
    h_new = torch.exp(log_a[:, 0]) * h + b[:, 0]
    return h_new.to(x_t.dtype), h_new


def conv1d_apply(params, x):
    """Causal depthwise conv. x: (B, S, d) -> (B, S, d); the taps are
    summed in x's dtype, one rounding per tap, as in JAX."""
    w = params["w"]
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for k in range(width):  # width is tiny (4): unrolled taps
        out = out + pad[:, k: k + x.shape[1], :] * w[k]
    return out


def conv1d_decode(params, x_t, buf):
    """One-token causal conv. x_t (B,d); buf (B, width-1, d) previous inputs.
    Returns (y_t (B,d), new_buf)."""
    w = params["w"]
    hist = torch.cat([buf, x_t[:, None, :]], dim=1)  # (B, width, d)
    y = torch.einsum("bwd,wd->bd", hist.to(w.dtype), w)
    return y.to(x_t.dtype), hist[:, 1:]


def griffin_block_apply(params, x, h0=None, *, use_kernels: bool = False):
    """x: (B,S,d) -> (y, state) with state = {"h", "conv"} (decode handoff)."""
    u_pre = x @ params["w_x"]
    g = _gelu(x @ params["w_gate"])
    u = conv1d_apply(params["conv"], u_pre)
    y, h_last = rglru_apply(params["rglru"], u, h0, use_kernels=use_kernels)
    width = params["conv"]["w"].shape[0]
    S = x.shape[1]
    if S >= width - 1:
        conv_buf = u_pre[:, S - (width - 1):].clone()
    else:
        conv_buf = F.pad(u_pre, (0, 0, width - 1 - S, 0))
    state = {"h": h_last, "conv": conv_buf}
    return (g * y) @ params["w_out"], state


def griffin_block_decode(params, x_t, state):
    """x_t: (B,d); state = {"h": (B,d_rnn) fp32, "conv": (B,w-1,d_rnn)}.
    Returns (y (B,d), a new state; the old one is not modified)."""
    u = x_t @ params["w_x"]
    g = _gelu(x_t @ params["w_gate"])
    u, conv_buf = conv1d_decode(params["conv"], u, state["conv"])
    y, h = rglru_decode(params["rglru"], u, state["h"])
    out = (g * y) @ params["w_out"]
    return out, {"h": h, "conv": conv_buf}


def griffin_state_init(batch: int, d_rnn: int, conv_width: int = 4,
                       dtype=torch.float32, device=None):
    return {
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                            device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM's matrix-memory LSTM): chunked parallel form, O(1) decode
# ---------------------------------------------------------------------------

NEG = -1e30  # the stabiliser's start and the padded keys' log input gate


def _mlstm_qkv_gates(params, x, n_heads: int, head_dim: int):
    """q, k, v (B,S,H,hd) in x's dtype; log_i (the pre-activation ĩ, i =
    exp(ĩ)) and log_f = log σ(f̃) (B,S,H) in fp32."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_heads, head_dim)
    gates = (x @ params["w_if"]).float().reshape(B, S, 2, n_heads)
    return q, k, v, gates[:, :, 0], F.logsigmoid(gates[:, :, 1])


def mlstm_parallel(q, k, v, log_i, log_f, *, q_chunk: int = 256):
    """Stabilised parallel mLSTM (xLSTM eq. 19-21), chunked over queries.

    q,k,v: (B,S,H,hd); log_i/log_f: (B,S,H) fp32.  Returns (B,S,H,hd) in
    q's dtype.  D̃_ts = F_t − F_s + ĩ_s (s ≤ t), F = cumsum(log f); a
    flash-style running (m, l, acc) over the key blocks, m the running
    max of D̃ (gates only), l the *signed* weight sum, and h_t = acc /
    (max(|l|, exp(−m)) + 1e-6)."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    Fc = torch.cumsum(log_f.float(), dim=1)  # (B,S,H) inclusive
    logi_plus = log_i.float() - Fc  # ĩ_s − F_s, so D̃ = F_t + (ĩ_s − F_s)
    qc = min(q_chunk, S)
    nq = -(-S // qc)
    pad = nq * qc - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        Fc = F.pad(Fc, (0, 0, 0, pad))
        logi_plus = F.pad(logi_plus, (0, 0, 0, pad), value=NEG)
    Ft = Fc.transpose(1, 2)  # (B,H,S')
    lt = logi_plus.transpose(1, 2)
    pos = torch.arange(qc, device=q.device)
    outs = []
    for iq in range(nq):
        rows = slice(iq * qc, (iq + 1) * qc)
        qb, Fb = q[:, rows], Ft[:, :, rows]
        m = torch.full((B, H, qc), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, hd), dtype=torch.float32,
                          device=q.device)
        # square blocks: key block ik is live iff it starts at or before
        # the query block's last row, i.e. ik <= iq
        for ik in range(iq + 1):
            cols = slice(ik * qc, (ik + 1) * qc)
            D = Fb[..., :, None] + lt[:, :, None, cols]  # (B,H,qc,kc)
            if ik == iq:  # the diagonal block: causal mask
                D = torch.where(pos[None, :] <= pos[:, None], D,
                                torch.full_like(D, NEG))
            m_new = torch.maximum(m, D.amax(dim=-1))
            s = torch.einsum("bqhd,bkhd->bhqk", qb, k[:, cols]).float()
            w = s * scale * torch.exp(D - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + w.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", w, v[:, cols].float())
            m = m_new
        n = torch.maximum(l.abs(), torch.exp(-m)) + 1e-6
        outs.append((acc / n[..., None]).transpose(1, 2))  # (B,qc,H,hd)
    return torch.cat(outs, dim=1)[:, :S].to(q.dtype)


def mlstm_prefill_state(k, v, log_i, log_f):
    """Closed-form (C, n, m) after consuming the whole prefix:
    m_S = max_s (F_S − F_s + ĩ_s); C = Σ_s e^{F_S−F_s+ĩ_s−m_S} k_s v_sᵀ/√hd,
    n = Σ_s e^{…} k_s/√hd.  All fp32."""
    hd = k.shape[-1]
    Fc = torch.cumsum(log_f.float(), dim=1)  # (B,S,H)
    w_log = Fc[:, -1:] - Fc + log_i.float()
    m = w_log.amax(dim=1)  # (B,H)
    w = torch.exp(w_log - m[:, None]) * (1.0 / math.sqrt(hd))
    wk = w[..., None] * k.float()  # (B,S,H,hd)
    C = torch.einsum("bshd,bshe->bhde", wk, v.float())
    return {"C": C, "n": wk.sum(dim=1), "m": m}


def mlstm_apply(params, x, *, n_heads: int, head_dim: int,
                return_state: bool = False, q_chunk: int = 256):
    """The mLSTM block over (B,S,d): y (B,S,d) [and its decode state]."""
    q, k, v, log_i, log_f = _mlstm_qkv_gates(params, x, n_heads, head_dim)
    with torch.profiler.record_function("repro.mlstm_parallel"):
        h = mlstm_parallel(q, k, v, log_i, log_f, q_chunk=q_chunk)
    o = torch.sigmoid(x @ params["ogate"])
    B, S, _ = x.shape
    y = (o * h.reshape(B, S, -1)) @ params["wo"]
    if return_state:
        return y, mlstm_prefill_state(k, v, log_i, log_f)
    return y


def mlstm_state_init(batch: int, n_heads: int, head_dim: int, device=None):
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, n_heads, head_dim, head_dim), dtype=f32,
                         device=device),
        "n": torch.zeros((batch, n_heads, head_dim), dtype=f32, device=device),
        "m": torch.full((batch, n_heads), NEG, dtype=f32, device=device),
    }


def mlstm_decode(params, x_t, state, *, n_heads: int, head_dim: int):
    """One-token mLSTM update (xLSTM eq. 19, recurrent form). x_t: (B,d).
    Returns (y (B,d), a new state; the old one is not modified)."""
    B = x_t.shape[0]
    q, k, v, log_i, log_f = _mlstm_qkv_gates(params, x_t[:, None, :],
                                             n_heads, head_dim)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()  # (B,H,hd)
    log_i, log_f = log_i[:, 0], log_f[:, 0]  # (B,H)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(log_f + m, log_i)
    f_eff = torch.exp(log_f + m - m_new)[..., None]
    i_eff = torch.exp(log_i - m_new)[..., None]
    scale = 1.0 / math.sqrt(head_dim)
    C_new = (f_eff[..., None] * C
             + i_eff[..., None] * (k[..., :, None] * v[..., None, :]) * scale)
    n_new = f_eff * n + i_eff * k * scale
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    h = num / (den[..., None] + 1e-6)
    o = torch.sigmoid(x_t @ params["ogate"])
    y = (o * h.reshape(B, -1).to(x_t.dtype)) @ params["wo"]
    return y, {"C": C_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar-memory LSTM with recurrent gates): sequential scan
# ---------------------------------------------------------------------------


def slstm_scan(params, x, state, *, n_heads: int, head_dim: int):
    """Sequential sLSTM over (B,S,d) with stabilised exponential gating
    (xLSTM eq. 15-17).  state: {c, n, h} (B,H,hd) and m (B,H), fp32.
    Returns (y (B,S,d), the final state)."""
    B, S, _ = x.shape
    H, hd = n_heads, head_dim
    zifo = (x @ params["w_in"]).reshape(B, S, 4, H, hd).float()
    # the block-diagonal recurrent weights (4, H, hd, hd) as one (hd, 4·hd)
    # matrix per head: each step's recurrent term is a single bmm
    r = params["r"].float().permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    with torch.profiler.record_function("repro.slstm_scan"):
        # unbind: one view per token, and one stack in backward
        for pre in zifo.unbind(1):  # (B, 4, H, hd)
            rec = torch.bmm(h.transpose(0, 1), r).view(H, B, 4, hd)
            g = pre + rec.permute(1, 2, 0, 3)
            z = torch.tanh(g[:, 0])
            logi = g[:, 1]  # ĩ (pre-activation)
            logf = F.logsigmoid(g[:, 2])
            o = torch.sigmoid(g[:, 3])
            # per-head stabiliser (B,H)
            m_new = torch.maximum(logf.amax(dim=-1) + m, logi.amax(dim=-1))
            f_eff = torch.exp(logf + (m - m_new)[..., None])
            i_eff = torch.exp(logi - m_new[..., None])
            c = f_eff * c + i_eff * z
            n = f_eff * n + i_eff
            h = o * (c / torch.clamp(n, min=1e-6))
            m = m_new
            hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, -1).to(x.dtype) @ params["wo"]
    return y, {"c": c, "n": n, "h": h, "m": m}


def slstm_state_init(batch: int, n_heads: int, head_dim: int, device=None):
    def z():
        return torch.zeros((batch, n_heads, head_dim), dtype=torch.float32,
                           device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, n_heads), NEG, dtype=torch.float32,
                            device=device)}


def slstm_apply(params, x, *, n_heads: int, head_dim: int, state=None):
    st = state or slstm_state_init(x.shape[0], n_heads, head_dim, x.device)
    return slstm_scan(params, x, st, n_heads=n_heads, head_dim=head_dim)


def slstm_decode(params, x_t, state, *, n_heads: int, head_dim: int):
    y, st = slstm_scan(params, x_t[:, None, :], state, n_heads=n_heads,
                       head_dim=head_dim)
    return y[:, 0], st
