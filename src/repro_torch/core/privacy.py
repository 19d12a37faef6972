"""Differentially-private client uploads (paper §3, "privacy-preserving
extension"; Geyer et al. 2017 [16]).

Client-level DP in the local-DP flavour: every uploaded model UPDATE (its
delta from the round's global model) is clipped to L2 norm ``<= clip``,
then perturbed with Gaussian noise ``N(0, (noise_multiplier * clip)^2)``
per coordinate, in the JAX package's order of operations:

    global + (clip(client - global) + sigma * n),  sigma = noise_multiplier * clip

With ``noise_multiplier == 0`` no noise is added.  The stacked form
(``[K, ...]`` uploads, the batched client update) takes one norm per
client over all its leaves; each unstacked function is its stacked form at
K = 1.

The standard normal draws ``n`` come from the host, as the distillation
sources' draws do (``data/distill_sources.py``): one CPU
``torch.Generator`` per client, seeded with the client's integer seed,
draws the leaves one after another in :func:`leaf_order`, and the draws
move to the device once.  So a run draws the same noise on the card and
on the CPU.  ``draws=`` replaces them with a caller's, e.g. the JAX
package's ``jax.random`` draws: ``fn(seed, {path: shape}) -> {path:
array}``, keyed by leaf path (``"dense_0/w"``), so the order a caller
draws in is its own.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import tree_flatten, tree_map, tree_stack

# fn(seed, {leaf path: shape}) -> {leaf path: standard normal draws}
NormalDraws = Callable[[int, Dict[str, Tuple[int, ...]]], Dict[str, object]]


def leaf_order(paths: Iterable[str]) -> List[str]:
    """The order the port draws a tree's leaves in: paths compared
    component by component as strings, which for a tree of dicts is the
    sorted-key order of ``jax.tree.leaves``."""
    return sorted(paths, key=lambda p: p.split("/"))


def normal_draws(seed: int, shapes: Dict[str, Tuple[int, ...]]
                 ) -> Dict[str, torch.Tensor]:
    """Standard normal float32 draws for every leaf, on the CPU, from one
    generator seeded with ``seed``, leaf after leaf in :func:`leaf_order`."""
    g = torch.Generator().manual_seed(int(seed))
    return {p: torch.randn(shapes[p], generator=g)
            for p in leaf_order(shapes)}


def stack_draws(trees: Sequence[dict], shapes: Dict[str, Tuple[int, ...]],
                device) -> Dict[str, torch.Tensor]:
    """Trees of draws (numpy or torch, keyed by path) stacked on a leading
    axis per leaf and moved to ``device`` in one copy."""
    paths = list(shapes)
    flat = torch.cat([torch.as_tensor(np.array(t[p], np.float32)).reshape(-1)
                      for p in paths for t in trees]).to(device)
    out, at = {}, 0
    for p in paths:
        n = len(trees) * int(np.prod(shapes[p], dtype=np.int64))
        out[p] = flat[at:at + n].reshape((len(trees),) + tuple(shapes[p]))
        at += n
    return out


def _one(stack):
    """The only client of a ``[1, ...]`` stack."""
    return tree_map(lambda x: x[0], stack)


def global_norm_stacked(stack) -> torch.Tensor:
    """[K]: each client's norm over all of its leaves."""
    return torch.sqrt(sum(torch.square(x.float()).reshape(x.shape[0], -1)
                          .sum(dim=1) for x in tree_flatten(stack).values()))


def global_norm(tree) -> torch.Tensor:
    return global_norm_stacked(tree_stack([tree]))[0]


def clip_by_global_norm_stacked(stack, clip: float):
    """Each client of a ``[K, ...]`` tree scaled by ``min(1, clip /
    max(norm, 1e-12))`` of its own norm."""
    factor = torch.clamp(
        clip / torch.clamp(global_norm_stacked(stack), min=1e-12), max=1.0)
    return tree_map(
        lambda x: x * factor.reshape((-1,) + (1,) * (x.dim() - 1)), stack)


def clip_by_global_norm(tree, clip: float):
    return _one(clip_by_global_norm_stacked(tree_stack([tree]), clip))


def gaussian_noise_stacked(stack, sigma: float, seeds: Sequence[int],
                           draws: NormalDraws = normal_draws):
    """``sigma * n`` for every leaf of a ``[K, ...]`` tree, client ``k``'s
    draws from ``seeds[k]``, on the leaves' device."""
    flat = tree_flatten(stack)
    shapes = {p: tuple(x.shape[1:]) for p, x in flat.items()}
    n = stack_draws([draws(s, shapes) for s in seeds], shapes,
                    next(iter(flat.values())).device)
    paths = iter(flat)          # tree_map visits the leaves in this order
    return tree_map(lambda x: sigma * n[next(paths)].to(x.dtype), stack)


def gaussian_noise_like(tree, sigma: float, seed: int,
                        draws: NormalDraws = normal_draws):
    return _one(gaussian_noise_stacked(tree_stack([tree]), sigma, [seed],
                                       draws))


def privatize_update_stacked(global_params, stack, *, clip: float,
                             noise_multiplier: float, seeds: Sequence[int],
                             draws: NormalDraws = normal_draws):
    """The DP version of each client of a stacked ``[K, ...]`` tree
    against the one (unstacked) global tree, ``global +
    noise(clip(client - global))``; client ``k``'s noise is drawn from
    ``seeds[k]``."""
    delta = clip_by_global_norm_stacked(
        tree_map(lambda c, g: c - g, stack, global_params), clip)
    if noise_multiplier > 0.0:
        delta = tree_map(torch.add, delta, gaussian_noise_stacked(
            delta, noise_multiplier * clip, seeds, draws))
    return tree_map(lambda g, d: g + d, global_params, delta)


def privatize_update(global_params, client_params, *, clip: float,
                     noise_multiplier: float, seed: int = 0,
                     draws: NormalDraws = normal_draws):
    return _one(privatize_update_stacked(
        global_params, tree_stack([client_params]), clip=clip,
        noise_multiplier=noise_multiplier, seeds=[seed], draws=draws))
