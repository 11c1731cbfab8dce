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

Tensor parallelism (``tp``, a :class:`~repro_torch.parallel.mesh.
ModelShard`, with the leaves placed by the sharding rules; read from the
local shapes, so an unplaced block under a mesh computes as before):

* Griffin: ``w_x`` and the gate matrices ``w_r``/``w_i`` hold a block of
  their input features, ``w_gate`` of its output features, ``w_out`` of
  its rows; ``conv.w`` and ``lam`` are replicated over ``"model"``.  Each
  rank owns one slice of the recurrence's features: ``x @ w_x`` is this
  rank's slice of x times its row block, the partial sums leaving through
  ``sum_scatter`` onto its features; ``w_gate`` is column-parallel; the
  gate products are row-parallel on the rank's features, reduce-scattered
  back onto them; the conv, the gates and the scan (the ``rglru_scan``
  kernel with kernels on) run on (B, S, d_rnn / n); ``w_out`` is
  row-parallel and the block leaves through ``sum_out``.  The decode
  state ``h``/``conv`` is the rank's features, as the cache rules split
  it.
* mLSTM and sLSTM: ``wo`` holds a block of rows, which fixes the output
  columns of ``h`` this rank multiplies.  Where that block is whole
  heads, the rank computes those heads (mLSTM: its ``wq``/``wk``/``wv``
  columns are them; the decode state is split over heads, as the rules
  split it).  Where it splits a head (xlstm-125m's 4 heads on a 16-way
  axis), every rank computes every head and keeps its columns: the q, k
  and v projections are all-gathered over ``"model"`` (a gather of three
  (B, S, H·hd) activations a layer), and the state stays whole.  sLSTM's
  ``w_in`` columns are gate-major, never a head's four gates, so its
  (B, S, 4·H·hd) pre-activations are always all-gathered over
  ``"model"`` (one gather a layer) and each rank runs the recurrence of
  its heads.  Replicated leaves that feed one rank's part only (``ogate``
  and sLSTM's ``r`` sliced to its heads, the gate pre-activations of
  ``w_if``) enter through ``replicated_in``, so their gradients sum over
  ``"model"``.

Under Megatron-SP (``tp.seq``) each block's input arrives gathered over
the sequence and its row-parallel output leaves reduce-scattered onto
this rank's positions (``collectives.tp_in``/``tp_out``).  Each rank
then holds its own part of the gathered input's cotangent, so the
mLSTM's ``w_if`` gates, which every rank computes whole, take ``w_if``
through ``replicated_in`` instead of their product.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.collectives import (gather_shards, replicated_in,
                                    sum_scatter, tp_in, tp_out)

RGLRU_C = 8.0  # Griffin's fixed gate-sharpness constant


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _group(tp):
    return None if tp is None else tp.group


def _cols(w, n: int, tp):
    """This rank's ``n`` trailing-dim entries of a leaf replicated over
    ``"model"`` (all of it without ``tp``); entering through
    ``replicated_in``, its gradient sums over the axis."""
    if tp is None:
        return w
    return replicated_in(w, tp.group)[..., tp.rank * n:(tp.rank + 1) * n]


def _rglru_gates(params, x, tp=None):
    """Returns (log_a, gated_input) in fp32. x: (..., d_rnn), this rank's
    features under ``tp`` (the gate products row-parallel, reduce-scattered
    back onto them)."""
    x32 = x.float()
    g = _group(tp)
    r = torch.sigmoid(sum_scatter(x32 @ params["w_r"].float(), g, -1))
    i = torch.sigmoid(sum_scatter(x32 @ params["w_i"].float(), g, -1))
    lam = _cols(params["lam"], x.shape[-1], tp)
    # a = exp(-c · r · softplus(Λ));  log_a ≤ 0
    log_a = -RGLRU_C * r * F.softplus(lam.float())
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
                use_kernels: bool = False, tp=None):
    """Sequence-parallel RG-LRU. x: (B, S, d_rnn); h0: optional (B, d_rnn)
    initial state.  Returns (y (B,S,d_rnn) in x's dtype, h_last (B,d_rnn)
    fp32).  Under ``tp`` d_rnn is this rank's features."""
    with torch.profiler.record_function("repro.rglru_gates"):
        log_a, b = _rglru_gates(params, x, tp)  # (B,S,d), fp32
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


def rglru_decode(params, x_t, h, tp=None):
    """One-token update. x_t: (B, d_rnn); h: (B, d_rnn) fp32 state."""
    log_a, b = _rglru_gates(params, x_t[:, None, :], tp)
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


def _griffin_tp(params, d: int, tp):
    """``tp`` when this Griffin block's leaves are split over ``"model"``
    (``w_x`` holding fewer than its ``d`` input rows), else None."""
    if tp is None or params["w_x"].shape[0] == d:
        return None
    r = params["conv"]["w"].shape[-1]
    n_in, n_f = params["w_x"].shape[0], params["w_gate"].shape[-1]
    if (n_in * tp.n, n_f * tp.n) != (d, r) or tuple(
            params["w_out"].shape) != (n_f, d):
        raise NotImplementedError(
            f"Griffin block split as w_x {tuple(params['w_x'].shape)}, "
            f"w_gate {tuple(params['w_gate'].shape)}, w_out "
            f"{tuple(params['w_out'].shape)} over {tp.n}: only input rows, "
            f"output columns and rows split alike are ported")
    return tp


def _griffin_in(params, x, tp):
    """(u_pre, g) of x (B, S, d): this rank's features under ``tp``."""
    if tp is None:
        return x @ params["w_x"], _gelu(x @ params["w_gate"])
    x_in = tp_in(x, tp)
    n = params["w_x"].shape[0]
    part = x_in[..., tp.rank * n:(tp.rank + 1) * n] @ params["w_x"]
    return (sum_scatter(part, tp.group, -1),
            _gelu(x_in @ params["w_gate"]))


def _griffin_conv(params, n: int, tp):
    return {"w": _cols(params["conv"]["w"], n, tp)}


def griffin_block_apply(params, x, h0=None, *, use_kernels: bool = False,
                        tp=None):
    """x: (B,S,d) -> (y, state) with state = {"h", "conv"} (decode handoff),
    under ``tp`` this rank's features of it."""
    tp = _griffin_tp(params, x.shape[-1], tp)
    u_pre, g = _griffin_in(params, x, tp)
    u = conv1d_apply(_griffin_conv(params, u_pre.shape[-1], tp), u_pre)
    y, h_last = rglru_apply(params["rglru"], u, h0, use_kernels=use_kernels,
                            tp=tp)
    width = params["conv"]["w"].shape[0]
    S = x.shape[1]
    if S >= width - 1:
        conv_buf = u_pre[:, S - (width - 1):].clone()
    else:
        conv_buf = F.pad(u_pre, (0, 0, width - 1 - S, 0))
    state = {"h": h_last, "conv": conv_buf}
    return tp_out((g * y) @ params["w_out"], tp), state


def griffin_block_decode(params, x_t, state, tp=None):
    """x_t: (B,d); state = {"h": (B,d_rnn) fp32, "conv": (B,w-1,d_rnn)}
    (this rank's features under ``tp``).  Returns (y (B,d), a new state;
    the old one is not modified)."""
    tp = _griffin_tp(params, x_t.shape[-1], tp)
    u, g = _griffin_in(params, x_t, tp)
    u, conv_buf = conv1d_decode(_griffin_conv(params, u.shape[-1], tp), u,
                                state["conv"])
    y, h = rglru_decode(params["rglru"], u, state["h"], tp)
    out = tp_out((g * y) @ params["w_out"], tp)
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


@dataclass(frozen=True)
class HeadShard:
    """The heads an xLSTM cell computes on this rank under ``tp`` (see the
    module doc): heads ``h0 .. h0+n-1``, and the columns ``lo ..
    lo+width-1`` of their (…, n·hd) output that meet this rank's rows of
    ``wo``.  ``local``: whole heads, the projections' own columns."""

    tp: Any
    h0: int
    n: int
    lo: int
    width: int
    local: bool


def _xlstm_heads(params, n_heads: int, head_dim: int, tp,
                proj: str) -> Optional[HeadShard]:
    """The :class:`HeadShard` of an xLSTM cell whose ``wo`` holds a block
    of its rows (None when it holds them all, or without ``tp``).
    ``proj`` names the column-parallel input projection that must split
    alike (``wq`` of mLSTM, ``w_in`` of sLSTM: 4 gates' columns)."""
    width, dh = params["wo"].shape[0], n_heads * head_dim
    if tp is None or width == dh:
        return None
    gates = 4 if proj == "w_in" else 1
    if width * tp.n != dh or params[proj].shape[-1] != gates * width:
        raise NotImplementedError(
            f"xLSTM cell split as wo {tuple(params['wo'].shape)}, {proj} "
            f"{tuple(params[proj].shape)} over {tp.n}: only wo's rows and "
            f"{proj}'s columns split alike are ported")
    lo = tp.rank * width
    if width % head_dim == 0:
        return HeadShard(tp, lo // head_dim, width // head_dim, 0, width,
                         True)
    return HeadShard(tp, 0, n_heads, lo, width, False)


def _xlstm_out(params, x, h, hs: Optional[HeadShard], gate: bool):
    """(σ(x @ ogate) ⊙ h) @ wo (no gate for sLSTM) on h (…, n·hd) in x's
    dtype; under ``hs`` this rank's columns of h, the row-parallel product
    leaving through ``tp_out``."""
    tp = None if hs is None else hs.tp
    if hs is not None:
        h = h[..., hs.lo:hs.lo + hs.width]
    if gate:
        og = params["ogate"] if hs is None else _cols(params["ogate"],
                                                      hs.width, hs.tp)
        h = torch.sigmoid(tp_in(x, tp) @ og) * h
    return tp_out(h @ params["wo"], tp)


def _mlstm_qkv_gates(params, x, n_heads: int, head_dim: int,
                     hs: Optional[HeadShard] = None):
    """q, k, v (B,S,H,hd) in x's dtype; log_i (the pre-activation ĩ, i =
    exp(ĩ)) and log_f = log σ(f̃) (B,S,H) in fp32 — under ``hs`` of the
    heads it names."""
    B, S, _ = x.shape
    tp = None if hs is None else hs.tp
    group = None if hs is None else tp.group
    x_in = tp_in(x, tp)

    def proj(name):
        y = x_in @ params[name]
        if hs is not None and not hs.local:  # the shard splits a head
            y = gather_shards(y, group, -1)
        return y.reshape(B, S, -1, head_dim)

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    if tp is not None and tp.seq:  # x gathered: the weight enters instead
        gates = (x @ replicated_in(params["w_if"], group)).float()
    else:
        gates = replicated_in((x @ params["w_if"]).float(), group)
    gates = gates.reshape(B, S, 2, n_heads)
    if hs is not None:
        gates = gates[..., hs.h0:hs.h0 + hs.n]
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
                return_state: bool = False, q_chunk: int = 256, tp=None):
    """The mLSTM block over (B,S,d): y (B,S,d) [and its decode state, of
    the heads this rank computes under ``tp``]."""
    hs = _xlstm_heads(params, n_heads, head_dim, tp, "wq")
    q, k, v, log_i, log_f = _mlstm_qkv_gates(params, x, n_heads, head_dim,
                                             hs)
    with torch.profiler.record_function("repro.mlstm_parallel"):
        h = mlstm_parallel(q, k, v, log_i, log_f, q_chunk=q_chunk)
    B, S, _ = x.shape
    y = _xlstm_out(params, x, h.reshape(B, S, -1), hs, gate=True)
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


def mlstm_decode(params, x_t, state, *, n_heads: int, head_dim: int,
                 tp=None):
    """One-token mLSTM update (xLSTM eq. 19, recurrent form). x_t: (B,d).
    Returns (y (B,d), a new state; the old one is not modified)."""
    B = x_t.shape[0]
    hs = _xlstm_heads(params, n_heads, head_dim, tp, "wq")
    q, k, v, log_i, log_f = _mlstm_qkv_gates(params, x_t[:, None, :],
                                             n_heads, head_dim, hs)
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
    y = _xlstm_out(params, x_t, h.reshape(B, -1).to(x_t.dtype), hs,
                   gate=True)
    return y, {"C": C_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar-memory LSTM with recurrent gates): sequential scan
# ---------------------------------------------------------------------------


def slstm_scan(params, x, state, *, n_heads: int, head_dim: int, tp=None):
    """Sequential sLSTM over (B,S,d) with stabilised exponential gating
    (xLSTM eq. 15-17).  state: {c, n, h} (B,H,hd) and m (B,H), fp32 — of
    the heads this rank computes under ``tp``.  Returns (y (B,S,d), the
    final state)."""
    B, S, _ = x.shape
    H, hd = n_heads, head_dim
    hs = _xlstm_heads(params, n_heads, head_dim, tp, "w_in")
    r = params["r"]
    if hs is None:
        zifo = (x @ params["w_in"]).reshape(B, S, 4, H, hd).float()
    else:  # gate-major columns: gathered, then this rank's heads
        g = hs.tp.group
        zifo = gather_shards(tp_in(x, hs.tp) @ params["w_in"], g, -1)
        zifo = zifo.reshape(B, S, 4, H, hd)[:, :, :, hs.h0:hs.h0 + hs.n]
        zifo = zifo.float()
        r = replicated_in(r, g)[:, hs.h0:hs.h0 + hs.n]
        H = hs.n
    # the block-diagonal recurrent weights (4, H, hd, hd) as one (hd, 4·hd)
    # matrix per head: each step's recurrent term is a single bmm
    r = r.float().permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    outs = []
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
            outs.append(h)
    y = _xlstm_out(params, x, torch.stack(outs, dim=1).reshape(B, S, -1).to(
        x.dtype), hs, gate=False)
    return y, {"c": c, "n": n, "h": h, "m": m}


def slstm_state_init(batch: int, n_heads: int, head_dim: int, device=None):
    def z():
        return torch.zeros((batch, n_heads, head_dim), dtype=torch.float32,
                           device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, n_heads), NEG, dtype=torch.float32,
                            device=device)}


def slstm_apply(params, x, *, n_heads: int, head_dim: int, state=None,
                tp=None):
    hs = _xlstm_heads(params, n_heads, head_dim, tp, "w_in")
    st = state or slstm_state_init(x.shape[0], n_heads if hs is None
                                   else hs.n, head_dim, x.device)
    return slstm_scan(params, x, st, n_heads=n_heads, head_dim=head_dim,
                      tp=tp)


def slstm_decode(params, x_t, state, *, n_heads: int, head_dim: int,
                 tp=None):
    y, st = slstm_scan(params, x_t[:, None, :], state, n_heads=n_heads,
                       head_dim=head_dim, tp=tp)
    return y[:, 0], st
