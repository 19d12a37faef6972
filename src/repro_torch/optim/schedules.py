"""LR schedules: constant (the paper's local training), cosine (the
paper's server-side distillation) and WSD warmup-stable-decay (MiniCPM,
arXiv:2404.06395).

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


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.03,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, long stable plateau, sharp
    exponential-ish (linear here) decay tail."""
    f32 = np.float32
    w = max(int(total_steps * warmup_frac), 1)
    d = max(int(total_steps * decay_frac), 1)
    stable_end = total_steps - d

    def sched(step: int) -> float:
        step = f32(step)
        if step < w:
            val = step / f32(w)
        elif step < stable_end:
            val = f32(1.0)
        else:
            val = f32(1.0) - f32(1.0 - final_frac) * (step - f32(stable_end)
                                                     ) / f32(d)
        val = np.clip(val, f32(final_frac), f32(1.0))
        return float(f32(lr) * val)
    return sched


def make_schedule(kind: str, lr: float, total_steps: int):
    if kind == "cosine":
        return cosine(lr, total_steps)
    if kind == "wsd":
        return wsd(lr, total_steps)
    return constant(lr)
