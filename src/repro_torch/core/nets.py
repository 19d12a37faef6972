"""Client models: the paper-validation ``mlp`` (norm none / bn / gn).

Nets are plain functions on parameter trees with the JAX package's names
and layouts (``dense_i.w`` is ``[din, dout]``, applied as ``x @ w + b``),
so a JAX tree loads 1:1 through ``repro_torch.convert``:

    init(generator) -> params      (on the CPU; BN running stats live in
                                    params['norm_i'], flagged non-trainable)
    apply(params, x, train=True) -> logits
    apply_with_stats(params, x) -> (logits, params with refreshed BN stats)

Every function also takes a *stacked* tree (a leading client axis K on
every leaf) with inputs ``[K, B, ...]``, or with one shared ``[B, ...]``
input that every client sees: the round engine trains K clients and the
logit bank evaluates K teachers that way, in one batched program.

``tiny_transformer`` waits for ROADMAP.md queue 1 item 4.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Net:
    init: Callable[[torch.Generator], dict]
    apply: Callable[..., torch.Tensor]  # (params, x, train=) -> logits
    name: str
    apply_with_stats: Callable[..., Tuple[torch.Tensor, dict]] = None  # type: ignore

    def trainable_mask(self, params: dict) -> Dict[str, bool]:
        """Flat ``{path: trainable}``; BN running statistics are not."""
        from repro_torch.common.pytree import tree_flatten
        return {p: "running" not in p for p in tree_flatten(params)}


def _dense_init(gen, din, dout, scale=1.0):
    w = torch.randn(din, dout, generator=gen) * (scale / math.sqrt(din))
    return {"w": w, "b": torch.zeros(dout)}


def _row(v: torch.Tensor, stacked: bool) -> torch.Tensor:
    """A per-feature vector ([C], or [K, C] when stacked) shaped to
    broadcast over the batch axis."""
    return v.unsqueeze(-2) if stacked else v


def _dense(p, x, stacked):
    return x @ p["w"] + _row(p["b"], stacked)


def _batchnorm(p, x, train: bool, stacked: bool, momentum=0.9, eps=1e-5):
    if train:
        mu = x.mean(dim=-2)
        var = x.var(dim=-2, unbiased=False)
        new_running = {
            "running_mean": momentum * p["running_mean"] + (1 - momentum) * mu,
            "running_var": momentum * p["running_var"] + (1 - momentum) * var,
        }
    else:
        mu, var = p["running_mean"], p["running_var"]
        new_running = {k: p[k] for k in ("running_mean", "running_var")}
    y = ((x - _row(mu, stacked)) * torch.rsqrt(_row(var, stacked) + eps)
         * _row(p["scale"], stacked) + _row(p["bias"], stacked))
    return y, new_running


def _groupnorm(p, x, groups, stacked, eps=1e-5):
    c = x.shape[-1]
    xg = x.reshape(*x.shape[:-1], groups, c // groups)
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * _row(p["scale"], stacked) + _row(p["bias"], stacked)


def mlp(in_dim: int, n_classes: int, hidden: Sequence[int] = (64, 64, 64),
        norm: str = "none", groups: int = 8, name: str | None = None) -> Net:
    """3-layer MLP (the paper's Fig. 1 toy uses exactly a 3-layer MLP)."""
    if norm not in ("none", "bn", "gn"):
        raise ValueError(f"norm must be 'none', 'bn' or 'gn', got {norm!r}")
    dims = [in_dim] + list(hidden) + [n_classes]

    def init(gen: torch.Generator):
        params = {}
        for i in range(len(dims) - 1):
            params[f"dense_{i}"] = _dense_init(gen, dims[i], dims[i + 1],
                                               scale=1.4)
            if i < len(dims) - 2 and norm in ("bn", "gn"):
                nd = dims[i + 1]
                p = {"scale": torch.ones(nd), "bias": torch.zeros(nd)}
                if norm == "bn":
                    p["running_mean"] = torch.zeros(nd)
                    p["running_var"] = torch.ones(nd)
                params[f"norm_{i}"] = p
        return params

    def _forward(params, x, train):
        stacked = params["dense_0"]["w"].dim() == 3
        lead = 2 if (stacked and x.dim() > 2) else 1
        x = x.reshape(*x.shape[:lead], -1)
        updated = dict(params)
        for i in range(len(dims) - 1):
            x = _dense(params[f"dense_{i}"], x, stacked)
            if i < len(dims) - 2:
                if norm == "bn":
                    x, new_run = _batchnorm(params[f"norm_{i}"], x, train,
                                            stacked)
                    updated[f"norm_{i}"] = {**params[f"norm_{i}"], **new_run}
                elif norm == "gn":
                    x = _groupnorm(params[f"norm_{i}"], x, groups, stacked)
                x = torch.relu(x)
        return x, updated

    def apply(params, x, train: bool = True):
        return _forward(params, x, train)[0]

    def apply_with_stats(params, x):
        return _forward(params, x, True)

    return Net(init=init, apply=apply, apply_with_stats=apply_with_stats,
               name=name or f"mlp-{norm}-{'x'.join(map(str, hidden))}")
