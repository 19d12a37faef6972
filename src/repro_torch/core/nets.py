"""Client models: the paper-validation ``mlp`` (norm none / bn / gn) and
``tiny_transformer``, the mean-pooled token classifier that stands in for
DistilBERT (paper Fig. 3).

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
For ``tiny_transformer`` the inputs are token ids, ``[B, S]`` or
``[K, B, S]``: the embedding lookup is one gather over the K stacked
tables, and every product carries the client axis.  Its attention is the JAX package's
plain einsum + softmax (no Pallas kernel there), so here it is plain
``torch.matmul`` too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F


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


def tiny_transformer(vocab: int, n_classes: int, seq_len: int,
                     d_model: int = 64, n_layers: int = 2, n_heads: int = 4,
                     name: str | None = None) -> Net:
    """Mean-pooled pre-norm transformer classifier (DistilBERT stand-in),
    with the JAX package's tree: ``embed`` [vocab, d], ``pos`` [seq, d],
    ``head`` and ``layer_l/{wqkv, wo, w1, w2, ln1, ln2}``."""
    hd = d_model // n_heads

    def init(gen: torch.Generator):
        params = {
            "embed": torch.randn(vocab, d_model, generator=gen) * 0.05,
            "pos": torch.randn(seq_len, d_model, generator=gen) * 0.05,
            "head": _dense_init(gen, d_model, n_classes),
        }
        s = 1.0 / math.sqrt(d_model)
        for l in range(n_layers):
            params[f"layer_{l}"] = {
                "wqkv": torch.randn(d_model, 3 * d_model, generator=gen) * s,
                "wo": torch.randn(d_model, d_model, generator=gen) * s,
                "w1": torch.randn(d_model, 4 * d_model, generator=gen) * s,
                "w2": torch.randn(4 * d_model, d_model, generator=gen)
                * (1.0 / math.sqrt(4 * d_model)),
                "ln1": torch.ones(d_model),
                "ln2": torch.ones(d_model),
            }
        return params

    def apply(params, x, train: bool = True):
        stacked = params["embed"].dim() == 3
        x = x.long()
        # the lookup through F.embedding: its backward sums each token's
        # rows in a fixed order (indexing's backward accumulates with
        # atomics on the CPU, another sum order from run to run)
        if stacked:
            k = params["embed"].shape[0]
            # client k's tokens index its own table, rows k*vocab onwards;
            # a shared [B, S] input broadcasts over the clients
            rows = torch.arange(k, device=x.device).reshape(k, 1, 1)
            h = F.embedding(x + rows * vocab,
                            params["embed"].reshape(k * vocab, d_model))
            pos = params["pos"][:, None, :x.shape[-1]]       # [K, B, S, d]
        else:
            h = F.embedding(x, params["embed"])              # [B, S, d]
            pos = params["pos"][None, :x.shape[-1]]
        h = h + pos
        lead = h.shape[:-2]                                  # [K,] B

        def mm(a, w):
            """``a @ w`` per client: [.., B, S, din] x [(K,) din, dout]."""
            if not stacked:
                return a @ w
            return (a.reshape(k, -1, a.shape[-1]) @ w).reshape(
                *a.shape[:-1], w.shape[-1])

        def rms(w, a):
            w = w[:, None, None] if stacked else w
            return a * torch.rsqrt((a * a).mean(-1, keepdim=True) + 1e-6) * w

        for l in range(n_layers):
            p = params[f"layer_{l}"]
            y = rms(p["ln1"], h)
            q, kk, v = mm(y, p["wqkv"]).split(d_model, dim=-1)
            heads = lambda a: a.reshape(*a.shape[:-1], n_heads, hd
                                        ).transpose(-2, -3)   # [.., H, S, hd]
            q, kk, v = heads(q), heads(kk), heads(v)
            att = torch.softmax(q @ kk.transpose(-1, -2) / math.sqrt(hd),
                                dim=-1)
            y = (att @ v).transpose(-2, -3).reshape(*lead, -1, d_model)
            h = h + mm(y, p["wo"])
            y = rms(p["ln2"], h)
            h = h + mm(F.gelu(mm(y, p["w1"]), approximate="tanh"), p["w2"])
        return _dense(params["head"], h.mean(dim=-2), stacked)

    return Net(init=init, apply=apply,
               apply_with_stats=lambda p, x: (apply(p, x, True), p),
               name=name or f"tinyT-{n_layers}L{d_model}d")
