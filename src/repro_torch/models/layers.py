"""Core layers: norms, rotary embeddings, SwiGLU MLP, embeddings.

Port of ``repro/models/layers.py``.  The functions take a parameter
mapping (a plain dict of tensors, or the ``nn.ParameterDict`` a module
holds) keyed by the JAX package's leaf names, so a test can hand both
packages the same numpy params.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


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


def mlp_apply(params, x):
    gate = F.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]


def embed_lookup(table, tokens):
    return table[tokens]
