"""llama3-405b — 126L d16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

[arXiv:2407.21783; unverified]  The heaviest assigned arch; its optimizer
moments are bf16.  The same numbers as ``repro/configs/llama3_405b.py``.
No single card holds its 405 B params: the port registers it for its
sharding rules (held against JAX's at full size) and runs it nowhere yet.
"""

from ..config import ArchConfig, register_arch

LLAMA3_405B = register_arch(
    ArchConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab=128256,
        head_dim=128,
        rope_theta=5e5,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        opt_dtype="bfloat16",
        sharding_defaults=(("remat", "sqrt"), ("grad_accum", 16),
                           ("accum_dtype", "bfloat16")),
        notes="GQA, 128k vocab; bf16 optimizer moments to fit one pod",
    )
)
