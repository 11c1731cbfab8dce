"""Core layers: norms, rotary embeddings, SwiGLU MLP, embeddings, the
cross-entropy, and seeded initializers.

Port of ``repro/models/layers.py``.  The functions take a parameter
mapping (a plain dict of tensors, or the ``nn.ParameterDict`` a module
holds) keyed by the JAX package's leaf names, so a test can hand both
packages the same numpy params.  The initializers draw from an explicit
``torch.Generator`` on the CPU (JAX's threefry bits cannot be reproduced,
so they give the JAX init's distributions, not its values) and return
tensors in ``dtype`` on ``device``: one seed gives one model on every
device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=torch.float32,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """N(0, scale²) (d_in, d_out), ``scale`` 1/√d_in by default."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen) * scale
    return w.to(device=device, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen) * 0.02).to(
        device=device, dtype=dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
             device=None):
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device=device),
        "w_up": dense_init(gen, d, d_ff, dtype, device=device),
        "w_down": dense_init(gen, d_ff, d, dtype, scale=1.0 / math.sqrt(d_ff),
                             device=device),
    }


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def rms_normalize(x, eps: float = 1e-6):
    """Scale-free RMS norm (qk-norm without learned scale)."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(params, x, tp=None):
    """SwiGLU.  ``tp`` (a :class:`~repro_torch.parallel.mesh.ModelShard`,
    given when the hidden dim is split over ``"model"``): ``w_gate`` and
    ``w_up`` column-parallel, the input entering through
    ``replicated_in``; ``w_down`` row-parallel, the output leaving
    through ``sum_out``."""
    if tp is not None:
        from ..parallel.collectives import replicated_in, sum_out

        x = replicated_in(x, tp.group)
    gate = F.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    y = (gate * up) @ params["w_down"]
    return y if tp is None else sum_out(y, tp.group)


def embed_lookup(table, tokens):
    return table[tokens]


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in fp32. logits (..., V), labels (...);
    with ``mask`` (...), the mask-weighted mean."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
