"""Helpers over parameter trees: nested dicts, tuples and lists (named
tuples included) whose leaves are tensors.

Trees keep the JAX package's layout (``{"dense_0": {"w": [din, dout],
"b": [dout]}, ...}``; a model's ``{"blocks": ({...}, ...), "tail": (...)}``)
so a JAX tree converts 1:1 (``repro_torch.convert``).  A *stacked* tree
carries a leading client axis on every leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

Pytree = Any


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        if hasattr(tree, "_fields"):                    # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def _children(tree: Pytree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (tuple, list)):
        return enumerate(tree)
    return None


def tree_flatten(tree: Pytree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a/b": leaf}`` in insertion order; a tuple or list contributes
    its indices (``"blocks/0/mixer/wq"``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in _children(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if _children(v) is not None:
            out.update(tree_flatten(v, path))
        else:
            out[path] = v
    return out


def tree_unflatten(flat: Dict[str, torch.Tensor]) -> Pytree:
    """Inverse of :func:`tree_flatten` for trees of dicts (a tuple comes
    back as a dict keyed by its indices)."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def tree_leaves(tree: Pytree) -> list:
    return list(tree_flatten(tree).values())


def _walk_jax_order(tree: Pytree, prefix: str = ""):
    """``(path, leaf)`` pairs in ``jax.tree.flatten``'s order: dict keys
    sorted, tuples and lists by index; paths as :func:`tree_flatten`'s."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _walk_jax_order(v, f"{prefix}/{k}" if prefix else str(k))


def tree_leaves_jax(tree: Pytree) -> list:
    """The leaves in the JAX package's order.  Everything that indexes a
    flat payload (the fault model's crash cut, bit-flip and poison
    targets; the checkpoint's ``leaf_{i}`` keys) walks this order, so a
    draw hits the same tensor in both packages."""
    return [leaf for _, leaf in _walk_jax_order(tree)]


def tree_paths_jax(tree: Pytree) -> list:
    """The leaf paths (``"a/b"``) in the JAX package's order."""
    return [path for path, _ in _walk_jax_order(tree)]


def tree_unflatten_jax(like: Pytree, leaves: Sequence) -> Pytree:
    """``like``'s structure (its own key order kept) with ``leaves``, given
    in the JAX package's order, in place of its leaves."""
    paths = tree_paths_jax(like)
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(paths)}")
    by_path = dict(zip(paths, leaves))

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            out = [build(v, f"{prefix}/{i}" if prefix else str(i))
                   for i, v in enumerate(tree)]
            return type(tree)(*out) if hasattr(tree, "_fields") \
                else type(tree)(out)
        return by_path[prefix]
    return build(like, "")


def tree_stack(trees: Sequence[Pytree]) -> Pytree:
    """Stack homogeneous trees along a new leading (client) axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_zeros_like(tree: Pytree) -> Pytree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: Pytree, s) -> Pytree:
    return tree_map(lambda x: x * s, tree)


def tree_leading_dim(tree: Pytree) -> int:
    """Size of the leading (client) axis of a stacked tree."""
    return int(tree_leaves(tree)[0].shape[0])


def tree_weighted_mean_stacked(stack: Pytree, weights) -> Pytree:
    """FedAvg aggregation over the leading (client) axis: one contraction
    per leaf with the weights normalized in float64, then cast to fp32."""
    w = np.asarray(weights, dtype=np.float64)
    w = (w / w.sum()).astype(np.float32)

    def mean(x):
        wt = torch.as_tensor(w, device=x.device)
        return torch.tensordot(wt, x.float(), dims=([0], [0])).to(x.dtype)
    return tree_map(mean, stack)


def _weights_f32(weights) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    return (w / w.sum()).astype(np.float32)


def _sorted_clients(x: torch.Tensor, w: np.ndarray):
    """A leaf's client values sorted per coordinate, NaN last and ties in
    client order (``jnp.argsort``), with each rank's client weight."""
    k = x.shape[0]
    flat = x.float().reshape(k, -1)
    order = torch.argsort(flat, dim=0, stable=True)
    wt = torch.as_tensor(w, device=x.device)
    return torch.take_along_dim(flat, order, dim=0), wt[order]


def tree_trimmed_mean_stacked(stack: Pytree, weights, trim: int) -> Pytree:
    """Per-coordinate trimmed weighted mean over the leading (client) axis:
    the ``trim`` smallest and ``trim`` largest client values of every
    coordinate are discarded, the rest averaged with their renormalized
    weights.  ``trim == 0`` is :func:`tree_weighted_mean_stacked` bit for
    bit.  Trimmed slots are zeroed by selection, not by a zero weight, so
    a non-finite value in the trim region (NaN sorts last) stays out."""
    if trim == 0:
        return tree_weighted_mean_stacked(stack, weights)
    k = tree_leading_dim(stack)
    if 2 * trim >= k:
        raise ValueError(f"trim={trim} needs K >= {2 * trim + 1} uploads, "
                         f"got K={k}")
    w = _weights_f32(weights)

    def leaf(x):
        vals, wts = _sorted_clients(x, w)
        keep = torch.zeros((k, 1), dtype=torch.float32, device=x.device)
        keep[trim:k - trim] = 1.0
        kept_w = wts * keep
        kept = torch.where(keep > 0, vals, torch.zeros_like(vals))
        out = (kept * kept_w).sum(dim=0) / kept_w.sum(dim=0)
        return out.reshape(x.shape[1:]).to(x.dtype)
    return tree_map(leaf, stack)


def tree_coordinate_median_stacked(stack: Pytree, weights) -> Pytree:
    """Per-coordinate weighted median over the leading (client) axis: the
    smallest client value whose cumulative sorted-order weight reaches
    half the total."""
    w = _weights_f32(weights)

    def leaf(x):
        vals, wts = _sorted_clients(x, w)
        cum = torch.cumsum(wts, dim=0)
        # the first rank whose cumulative weight crosses 0.5 (argmax of
        # the boolean, as jnp.argmax: 0 where none does)
        idx = torch.argmax((cum >= 0.5).to(torch.int8), dim=0)
        med = torch.take_along_dim(vals, idx[None, :], dim=0)[0]
        return med.reshape(x.shape[1:]).to(x.dtype)
    return tree_map(leaf, stack)


def tree_isfinite(tree: Pytree) -> torch.Tensor:
    """0-dim bool tensor: every floating leaf is finite (no host sync)."""
    leaves = [torch.isfinite(x).all() for x in tree_leaves(tree)
              if x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack(leaves).all()


def tree_to(tree: Pytree, device) -> Pytree:
    return tree_map(lambda x: x.to(device), tree)


def tree_take(tree: Pytree, idx) -> Pytree:
    """Gather along the leading (client) axis of a stacked tree."""
    def take(x):
        return x[torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                 device=x.device)]
    return tree_map(take, tree)


def tree_cat(trees: Sequence[Pytree]) -> Pytree:
    """Concatenate stacked trees along the leading (client) axis."""
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *trees)


def tree_check_like(tree: Pytree, like: Pytree, what: str = "pytree") -> None:
    """Raise ValueError naming the first structural mismatch between
    ``tree`` and the prototype ``like`` (paths, shapes, dtypes).  The
    leaves of ``like`` are anything with ``.shape`` and ``.dtype``."""
    got, want = tree_flatten(tree), tree_flatten(like)
    if list(got) != list(want):
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        raise ValueError(
            f"{what} structure mismatch: missing leaves {missing[:4]}, "
            f"unexpected leaves {extra[:4]}")
    for p, g in got.items():
        w = want[p]
        if tuple(g.shape) != tuple(w.shape):
            raise ValueError(f"{what} leaf {p!r} has shape "
                             f"{tuple(g.shape)}, expected {tuple(w.shape)}")
        if g.dtype != w.dtype:
            raise ValueError(f"{what} leaf {p!r} has dtype {g.dtype}, "
                             f"expected {w.dtype}")
