"""xlstm-125m — 12L d768 4H, sLSTM + mLSTM blocks, vocab 50304.

[arXiv:2405.04517; unverified]  xLSTM[3:1]-style pattern (3 mLSTM : 1
sLSTM); ``d_ff=0`` — xLSTM blocks carry their own projections, so a layer
has no FFN.  The same numbers as ``repro/configs/xlstm_125m.py``.
"""

from ..config import ArchConfig, register_arch

XLSTM_125M = register_arch(
    ArchConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        head_dim=192,
        rope_theta=0.0,  # recurrence encodes position
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        tie_embeddings=True,
        notes="xLSTM[3:1]; O(1)-state decode",
    )
)
