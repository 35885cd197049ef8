"""Learning-rate schedules, computed on the host in float32 as the reference
computes them on the device.  The cosine is taken in float64 and rounded
to float32: numpy's float32 ``cos`` is off by an ulp where XLA's is not,
and ``1 + cos`` near -1 turns that ulp into several of the rate."""
from __future__ import annotations

import math
from typing import Callable

import numpy as np


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``final_frac``
    of it.  ``lr(step)`` is a Python float holding a float32 value."""
    f32 = np.float32

    def lr(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
        t = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                    f32(0.0), f32(1.0))
        cos = f32(peak_lr) * (f32(final_frac) + f32((1 - final_frac) * 0.5)
                              * (f32(1) + f32(math.cos(f32(math.pi) * t))))
        return float(f32(cos))
    return lr
