"""Low-bit client models (paper §4.3, Table 4): binarized weights trained
with the straight-through estimator [Bengio et al.; Hubara et al.].

The client keeps a full-precision master copy; the forward pass sees
``sign(w) * mean|w|`` (XNOR-Net scaling) and the backward pass is the
identity (STE): ``w + (q - w).detach()``.  The sum is kept as the JAX
package writes it, because ``w + (q - w)`` and ``q`` can differ in the last
bit.  ``torch.sign(0) == 0``, as ``jnp.sign``.

A quantizer is ``fn(params, stacked=False) -> params``.  A *stacked* tree
(``[K, ...]`` leaves, the batched client update) is binarized client by
client, as the JAX package's ``vmap`` over clients does: ``mean|w|`` is
taken per client over every dimension but the first, and the size test
is made on one client's shape (``ndim - 1`` dimensions, ``numel // K``
elements), never on the stack's.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_leaves, tree_map


def _ste(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``sign(w) * scale`` forward, identity backward."""
    q = torch.sign(w) * scale
    return w + (q - w).detach()


def binarize_leaf(w: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    if stacked:
        scale = w.abs().reshape(w.shape[0], -1).mean(dim=1)
        scale = scale.reshape((-1,) + (1,) * (w.dim() - 1))
    else:
        scale = w.abs().mean()
    return _ste(w, scale)


def _binarizable(x: torch.Tensor, min_size: int = 32,
                 stacked: bool = False) -> bool:
    """A floating leaf of at least 2 dimensions and ``min_size`` elements
    (one client's, for a stacked leaf): a weight matrix, not a vector."""
    ndim = x.dim() - 1 if stacked else x.dim()
    size = x.numel() // x.shape[0] if stacked else x.numel()
    return x.is_floating_point() and ndim >= 2 and size >= min_size


def binarize(params, min_size: int = 32, stacked: bool = False):
    """Binarize the weight matrices; vectors (norms, biases, BN
    statistics) stay full precision, as is standard for binary nets."""
    return tree_map(lambda x: binarize_leaf(x, stacked)
                    if _binarizable(x, min_size, stacked) else x, params)


def comm_bytes(params, binarized: bool = False) -> int:
    """Per-round uplink cost of one client's tree (the Table 4
    motivation): 1 bit a weight plus an fp32 scale per binarized leaf."""
    total = 0
    for x in tree_leaves(params):
        if binarized and x.dim() >= 2 and x.numel() >= 32:
            total += (x.numel() + 7) // 8 + 4
        else:
            total += x.numel() * x.element_size()
    return int(total)
