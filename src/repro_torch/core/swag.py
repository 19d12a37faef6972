"""SWAG-style teacher augmentation for ensemble distillation (Table 7).

FedDistill (Chen & Chao, 2020, [10] in the paper) fits a Gaussian
posterior over the *received client models* (SWAG; Maddox et al., 2019)
and distils from models sampled out of it as well as from the received
models.  The diagonal form over the K received models:

    mean  = 1/K sum_k theta_k
    var   = 1/K sum_k (theta_k - mean)^2     (population variance, >= 0)
    theta_s ~ N(mean, scale * var / 2)

The sampled models join the received ones as extra distillation teachers
(the ensemble still averages logits over ALL teachers).

The standard normal draws come from the host, as the DP noise does
(``core/privacy.py``): one CPU ``torch.Generator`` seeded with the fusion
seed draws sample after sample, each leaf after leaf in
``privacy.leaf_order``, and the draws move to the device in one copy.
``draws=`` replaces them with a caller's: ``fn(seed, n_samples, {path:
shape}) -> [{path: array}] * n_samples``, keyed by leaf path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.common.pytree import (tree_flatten, tree_map, tree_stack,
                                       tree_unflatten)
from repro_torch.core.privacy import leaf_order, stack_draws

# fn(seed, n_samples, {leaf path: shape}) -> one {leaf path: draws} a sample
SwagDraws = Callable[[int, int, Dict[str, Tuple[int, ...]]], List[dict]]


def normal_samples(seed: int, n_samples: int,
                   shapes: Dict[str, Tuple[int, ...]]
                   ) -> List[Dict[str, torch.Tensor]]:
    """``n_samples`` trees of standard normal float32 draws on the CPU,
    from one generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(int(seed))
    return [{p: torch.randn(shapes[p], generator=g)
             for p in leaf_order(shapes)} for _ in range(n_samples)]


def _client_mean(s: torch.Tensor) -> torch.Tensor:
    """The mean over the client axis as the JAX package's float32 mean
    takes it on the CPU, bit for bit: the clients summed in order, times
    1/K."""
    acc = s[0]
    for x in s[1:]:
        acc = acc + x
    return acc * (1.0 / s.shape[0])


def swag_fit_stacked(stack):
    """Diagonal Gaussian directly over a stacked ``[K, ...]`` tree ->
    ``(mean, var)`` trees."""
    mean = tree_map(_client_mean, stack)
    var = tree_map(lambda s: torch.clamp(torch.var(s, dim=0, correction=0),
                                         min=0.0), stack)
    return mean, var


def swag_fit(client_params: Sequence[dict]):
    """Diagonal Gaussian over the received models -> ``(mean, var)``."""
    return swag_fit_stacked(tree_stack(client_params))


def swag_sample(mean, var, n_samples: int, *, scale: float = 0.5,
                seed: int = 0, draws: Optional[SwagDraws] = None
                ) -> List[dict]:
    """Draw ``n_samples`` models from ``N(mean, scale * var / 2)``."""
    fm, fv = tree_flatten(mean), tree_flatten(var)
    shapes = {p: tuple(m.shape) for p, m in fm.items()}
    noise = stack_draws((draws or normal_samples)(seed, n_samples, shapes),
                        shapes, next(iter(fm.values())).device)
    return [tree_unflatten({p: fm[p] + torch.sqrt(scale * fv[p] / 2.0)
                            * noise[p][i].to(fm[p].dtype) for p in fm})
            for i in range(n_samples)]


def swag_teachers_stacked(stack, n_samples: int, *, scale: float = 0.5,
                          seed: int = 0, draws: Optional[SwagDraws] = None):
    """Received client models + SWAG-sampled models on a stacked tree:
    ``[K, ...] -> [K + n_samples, ...]``."""
    if n_samples <= 0:
        return stack
    mean, var = swag_fit_stacked(stack)
    samples = swag_sample(mean, var, n_samples, scale=scale, seed=seed,
                          draws=draws)
    return tree_map(lambda s, *xs: torch.cat([s, torch.stack(xs)], dim=0),
                    stack, *samples)


def swag_teachers(client_params: Sequence[dict], n_samples: int, *,
                  scale: float = 0.5, seed: int = 0,
                  draws: Optional[SwagDraws] = None) -> List[dict]:
    """Received client models + SWAG-sampled models (Table 7's SWAG row):
    :func:`swag_teachers_stacked` on a list of trees."""
    out = swag_teachers_stacked(tree_stack(client_params), n_samples,
                                scale=scale, seed=seed, draws=draws)
    return [tree_map(lambda x: x[i], out)
            for i in range(len(client_params) + max(n_samples, 0))]
