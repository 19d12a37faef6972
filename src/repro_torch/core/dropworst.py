"""Drop-worst filtering (paper §4.2, Table 3): before aggregation, drop
received models whose server-validation accuracy is indistinguishable from
random guessing, which stabilises unnormalised architectures under
non-i.i.d. local data.

A model is kept when its accuracy is strictly above ``threshold_factor *
chance``; when that keeps none, the first most accurate one is kept (the
server must emit something).  The accuracies are those of the
full-precision uploads, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import tree_stack, tree_take
from repro_torch.core.client import evaluate_stacked
from repro_torch.core.nets import Net


def _keep(accs: Sequence[float], n_classes: int,
          threshold_factor: float) -> List[int]:
    chance = 1.0 / n_classes
    keep = [i for i, a in enumerate(accs) if a > threshold_factor * chance]
    return keep or [int(np.argmax(accs))]


def drop_worst(net: Net, client_params: List[dict],
               client_weights: Sequence[float], val_x: torch.Tensor,
               val_y: torch.Tensor, n_classes: int,
               threshold_factor: float = 1.5
               ) -> Tuple[List[dict], List[float], List[int]]:
    """:func:`drop_worst_stacked` on a list of trees.  Returns ``(kept
    params, kept weights, kept indices)``."""
    _, kept_w, keep = drop_worst_stacked(net, tree_stack(client_params),
                                         client_weights, val_x, val_y,
                                         n_classes, threshold_factor)
    return [client_params[i] for i in keep], kept_w, keep


def drop_worst_stacked(net: Net, stack, client_weights: Sequence[float],
                       val_x: torch.Tensor, val_y: torch.Tensor,
                       n_classes: int, threshold_factor: float = 1.5):
    """Drop-worst on a stacked ``[K, ...]`` tree: the K validation
    accuracies from one stacked forward per batch, the survivors gathered
    along the client axis.  Returns ``(kept stack, kept weights, kept
    indices)``."""
    accs = evaluate_stacked(net, stack, val_x, val_y)
    keep = _keep(accs, n_classes, threshold_factor)
    return (tree_take(stack, np.asarray(keep)),
            [client_weights[i] for i in keep], keep)
