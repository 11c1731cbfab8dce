"""recurrentgemma-9b — 38L d4096 16H (MQA kv=1) d_ff=12288 vocab=256000.

[arXiv:2402.19427; unverified]  Griffin: (RG-LRU, RG-LRU, local-attn)
repeating 1:2 attention:recurrent pattern; 38 = 12×3 + 2, the remainder two
recurrent layers run before the groups.  Local attention window 2048.  The
same numbers as ``repro/configs/recurrentgemma_9b.py``.
"""

from ..config import ArchConfig, register_arch

RECURRENTGEMMA_9B = register_arch(
    ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab=256000,
        head_dim=256,
        rope_theta=1e4,
        local_window=2048,
        block_pattern=("rglru", "rglru", "local_attn"),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        notes="RG-LRU + local attn 2:1; O(d) recurrent state decode",
    )
)
