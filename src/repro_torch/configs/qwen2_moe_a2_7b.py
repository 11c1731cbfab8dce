"""qwen2-moe-a2.7b — 24L d2048 16H (MHA, kv=16) MoE 60e top-4 + 4 shared.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  moe_intermediate_size=1408; the 4 shared
experts total 4·1408 = 5632 (one SwiGLU of that width).  60 routed experts
are padded to 64 physical ones (4 dead, zero, never routed).  The same
numbers as ``repro/configs/qwen2_moe_a2_7b.py``.
"""

from ..config import ArchConfig, MoEConfig, register_arch

QWEN2_MOE_A2_7B = register_arch(
    ArchConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=151936,
        head_dim=128,
        rope_theta=1e6,
        moe=MoEConfig(
            n_experts=60,
            top_k=4,
            n_shared_experts=4,
            d_ff_expert=1408,
            pad_to=64,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        sharding_defaults=(("grad_accum", 8),),
        notes="4 shared + 60 routed top-4; padded to 64 physical for EP",
    )
)
