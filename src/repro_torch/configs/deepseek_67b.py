"""deepseek-67b — 95L d8192 64H (GQA kv=8) d_ff=22016 vocab=102400.

[arXiv:2401.02954; hf]  LLaMA-style dense decoder.  The same numbers as
``repro/configs/deepseek_67b.py``.  No single card holds its 67 B params:
the port registers it for its sharding rules (held against JAX's at full
size) and runs it nowhere yet.
"""

from ..config import ArchConfig, register_arch

DEEPSEEK_67B = register_arch(
    ArchConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=102400,
        head_dim=128,
        rope_theta=1e4,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
        sharding_defaults=(("remat", "sqrt"), ("grad_accum", 8)),
        notes="llama-arch dense",
    )
)
