"""Griffin's recurrent block: RG-LRU and the causal conv1d (port of
``repro/models/recurrent.py:27-162``; the xLSTM cells come with ROADMAP
queue 1, item 4b).

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
"""

from __future__ import annotations

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
