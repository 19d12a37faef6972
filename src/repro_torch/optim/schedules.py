"""LR schedules: constant (the paper's local training) and cosine (the
paper's server-side distillation).

A schedule maps a Python step count to a Python float.  The arithmetic
runs in float32 as in the JAX package, where the step is a device int32,
so both packages feed their optimizers the same learning rates; the value
crosses into a kernel as a scalar argument, never through a host sync.
"""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    value = float(np.float32(lr))

    def sched(step: int) -> float:
        return value
    return sched


def cosine(lr: float, total_steps: int, final_frac: float = 0.0):
    f32 = np.float32

    def sched(step: int) -> float:
        t = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0.0), f32(1.0))
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t))
        return float(f32(lr) * (f32(final_frac)
                                + f32(1 - final_frac) * cos))
    return sched
