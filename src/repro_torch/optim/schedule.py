"""Learning-rate schedules (port of ``repro/optim/schedule.py``): pure
functions of the step counter, in float32 as the JAX ones compute."""

from __future__ import annotations

import numpy as np


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` then cosine decay to ``final_frac·peak``."""
    f32 = np.float32
    step = f32(step)
    if step < warmup_steps:
        return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
    prog = np.clip((step - f32(warmup_steps))
                   / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
    cos = f32(peak_lr) * (f32(final_frac) + f32(1 - final_frac) * f32(0.5)
                          * (f32(1) + np.cos(f32(np.pi) * prog)))
    return float(cos)
