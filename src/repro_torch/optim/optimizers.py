"""Minimal functional optimizers over lists of tensors.

An :class:`Optimizer` is an ``(init, update)`` pair; ``update(grads,
state, params, step)`` returns parameter *deltas* to be added with
:func:`apply_updates`, as in the JAX package.  Leaves are plain lists (one
entry per trainable parameter) so every rule runs as PyTorch's multi-tensor
``_foreach`` ops: a handful of launches per step whatever the leaf count.
The arithmetic keeps the JAX package's operation order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Tuple, Union

import numpy as np
import torch

Schedule = Callable[[int], float]
Tensors = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], tuple]
    update: Callable[[Tensors, tuple, Tensors, int], Tuple[Tensors, tuple]]


def _schedule(lr: Union[Schedule, float]) -> Schedule:
    if isinstance(lr, (int, float)):
        value = float(np.float32(lr))
        return lambda step: value
    return lr


def apply_updates(params: Tensors, deltas: Tensors) -> Tensors:
    return torch._foreach_add(params, deltas)


def sgd(lr: Union[Schedule, float]) -> Optimizer:
    sched = _schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        return torch._foreach_mul(grads, -sched(step)), state

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    vel: Tensors


def momentum_sgd(lr: Union[Schedule, float], beta: float = 0.9,
                 nesterov: bool = False) -> Optimizer:
    """Heavy-ball SGD as in the JAX package: ``v = beta v + g`` and the
    delta ``-eta v`` (``-eta (beta v + g)`` with ``nesterov``)."""
    sched = _schedule(lr)

    def init(params):
        return MomentumState([torch.zeros_like(p) for p in params])

    def update(grads, state, params, step):
        eta = sched(step)
        vel = torch._foreach_mul(state.vel, beta)
        torch._foreach_add_(vel, grads)
        if nesterov:
            ahead = torch._foreach_mul(vel, beta)
            torch._foreach_add_(ahead, grads)
            return torch._foreach_mul(ahead, -eta), MomentumState(vel)
        return torch._foreach_mul(vel, -eta), MomentumState(vel)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Tensors
    nu: Tensors


def adam(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam as in the JAX package: fp32 moments, bias correction from
    ``step + 1``, eps outside the square root; with ``weight_decay`` the
    decoupled term ``eta * weight_decay * p`` (in float32) is subtracted
    from each delta."""
    sched = _schedule(lr)
    f32 = np.float32

    def init(params):
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)
                         for p in params]
        return AdamState(zeros(), zeros())

    def update(grads, state, params, step):
        eta = sched(step)
        t = f32(step) + f32(1.0)
        mh = float(f32(1.0) - f32(b1) ** t)
        nh = float(f32(1.0) - f32(b2) ** t)
        g32 = [g.float() for g in grads]
        mu = torch._foreach_mul(state.mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g32, 1 - b1))
        nu = torch._foreach_mul(state.nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g32, g32), 1 - b2))
        num = torch._foreach_mul(torch._foreach_div(mu, mh), -eta)
        den = torch._foreach_sqrt(torch._foreach_div(nu, nh))
        torch._foreach_add_(den, eps)
        deltas = torch._foreach_div(num, den)
        if weight_decay:
            decay = torch._foreach_mul([p.float() for p in params],
                                       float(f32(eta) * f32(weight_decay)))
            torch._foreach_sub_(deltas, decay)
        deltas = [d.to(p.dtype) for d, p in zip(deltas, params)]
        return deltas, AdamState(mu, nu)

    return Optimizer(init, update)
