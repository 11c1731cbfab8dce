"""Optimizer substrate: AdamW with dtype policies and clipping, and the
learning-rate schedule (port of ``repro.optim`` without the int8 gradient
compression, which comes with multi-GPU data parallelism: ROADMAP queue
1, item 5c)."""

from .adamw import AdamW, OptState, global_norm
from .schedule import warmup_cosine

__all__ = ["AdamW", "OptState", "global_norm", "warmup_cosine"]
