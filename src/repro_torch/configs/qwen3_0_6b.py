"""qwen3-0.6b — 28L d1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

[hf:Qwen/Qwen3-8B; hf]  Qwen3 small: explicit head_dim=128 (> d/H), qk-norm,
tied embeddings.  The same numbers as ``repro/configs/qwen3_0_6b.py``.
"""

from ..config import ArchConfig, register_arch

QWEN3_0_6B = register_arch(
    ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=3072,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        tie_embeddings=True,
        notes="qk_norm + GQA; tied embeddings",
    )
)
