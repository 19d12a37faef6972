"""Parameter trees between the JAX package's layout (nested dicts, tuples
and lists of arrays, handed over as numpy) and the port's tensors.

The layouts are identical by construction (``core/nets.py``), so the
conversion is leafwise: ``to_torch(jax_tree_as_numpy)`` and back with
``to_numpy``.  Tests use it to inject the JAX package's ``jax.random``
initialisation, which PyTorch cannot reproduce.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import tree_map


def to_torch(tree, device="cpu"):
    """Tree of array-likes -> the same tree of tensors on ``device``
    (copies, so later in-place use never aliases the caller's arrays)."""
    return tree_map(
        lambda x: torch.tensor(np.asarray(x), device=device), tree)


def to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
