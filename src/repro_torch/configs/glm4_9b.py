"""glm4-9b — 40L d4096 32H (GQA kv=2) d_ff=13696 vocab=151552.

[hf:THUDM/glm-4-9b; hf]  RoPE + aggressive GQA (kv=2: 16 query heads per
KV head).  The same numbers as ``repro/configs/glm4_9b.py``.
"""

from ..config import ArchConfig, register_arch

GLM4_9B = register_arch(
    ArchConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab=151552,
        head_dim=128,
        rope_theta=1e4,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        sharding_defaults=(("grad_accum", 8),),
        notes="RoPE, GQA kv=2",
    )
)
