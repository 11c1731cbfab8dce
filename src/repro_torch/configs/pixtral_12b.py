"""pixtral-12b — 40L d5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

[hf:mistralai/Pixtral-12B-2409; unverified]  Mistral-Nemo-style decoder
backbone (head_dim=128).  The pixtral-ViT frontend is a stub: requests
carry precomputed patch embeddings ``(P, d)`` in
``Request.extras["embeds"]``, prepended to the token stream (one image is
1,024 patches).  The same numbers as ``repro/configs/pixtral_12b.py``.
"""

from ..config import ArchConfig, register_arch

PIXTRAL_12B = register_arch(
    ArchConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=131072,
        head_dim=128,
        rope_theta=1e6,
        frontend_stub_len=1024,  # one image worth of patch embeddings
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        sharding_defaults=(("grad_accum", 8),),
        notes="pixtral-ViT stub + mistral-nemo backbone",
    )
)
