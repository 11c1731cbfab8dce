"""seamless-m4t-medium — enc-dec 12L+12L d1024 16H (MHA) d_ff=4096 vocab=256206.

[arXiv:2308.11596; hf]  Multimodal enc-dec; the speech frontend is a stub:
requests carry precomputed frame embeddings ``(S_enc, d)`` in
``Request.extras["frames"]``.  The same numbers as
``repro/configs/seamless_m4t_medium.py``.
"""

from ..config import ArchConfig, register_arch

SEAMLESS_M4T_MEDIUM = register_arch(
    ArchConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,       # decoder depth
        n_enc_layers=12,   # encoder depth
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=256206,
        rope_theta=1e4,
        frontend_stub_len=1,  # marker: modality frontend is stubbed
        notes="enc-dec; speech frontend stubbed as precomputed frames",
    )
)
