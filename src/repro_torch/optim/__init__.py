"""Optimizer substrate: AdamW with dtype policies and clipping, the
learning-rate schedule and int8-compressed gradient synchronization (port
of ``repro.optim``)."""

from .adamw import AdamW, OptState, global_norm
from .compress import (ErrorFeedback, compressed_mean, int8_compress,
                       int8_decompress)
from .schedule import warmup_cosine

__all__ = ["AdamW", "OptState", "global_norm", "warmup_cosine",
           "int8_compress", "int8_decompress", "compressed_mean",
           "ErrorFeedback"]
