"""qwen3-moe-30b-a3b — 48L d2048 32H (GQA kv=4) MoE 128e top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]  moe_intermediate_size=768, head_dim=128 with
qk-norm (Qwen3 family); no shared and no dead experts.  The same numbers
as ``repro/configs/qwen3_moe_30b_a3b.py``.
"""

from ..config import ArchConfig, MoEConfig, register_arch

QWEN3_MOE_30B_A3B = register_arch(
    ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1e6,
        moe=MoEConfig(
            n_experts=128,
            top_k=8,
            n_shared_experts=0,
            d_ff_expert=768,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        sharding_defaults=(("grad_accum", 8),),
        notes="128 routed experts top-8; EP over model axis",
    )
)
