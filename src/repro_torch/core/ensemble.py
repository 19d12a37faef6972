"""Naive logits-averaging ensemble: the fused model's accuracy upper bound
(Theorem 5.1; the solid-vs-ensemble gap in Fig. 4)."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core.client import stacked_logits_fn
from repro_torch.core.nets import Net


def _accuracy_of_summed_logits(logit_fns, x: torch.Tensor, y: torch.Tensor,
                               batch_size: int) -> float:
    """Top-1 accuracy of the sum of every fn's float32 logits; one host
    read."""
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    with torch.no_grad():
        for s in range(0, len(y), batch_size):
            xb = x[s:s + batch_size]
            acc_logits = None
            for fn in logit_fns:
                lg = fn(xb)
                acc_logits = lg if acc_logits is None else acc_logits + lg
            pred = acc_logits.argmax(dim=-1)
            correct += (pred == y[s:s + batch_size]).sum()
    return int(correct.item()) / len(y)


def ensemble_accuracy(groups: Sequence[Tuple[Net, List[dict]]],
                      x: torch.Tensor, y: torch.Tensor,
                      batch_size: int = 512) -> float:
    """Average logits over every model in every ``(net, params list)``
    group."""
    fns = [lambda xb, net=net, p=p: net.apply(p, xb, train=False).float()
           for net, plist in groups for p in plist]
    return _accuracy_of_summed_logits(fns, x, y, batch_size)


def ensemble_accuracy_stacked(groups: Sequence[Tuple[Net, object]],
                              x: torch.Tensor, y: torch.Tensor,
                              batch_size: int = 512) -> float:
    """Logits-averaging ensemble over stacked [K_g, ...] trees: one
    stacked forward per group instead of one per model."""
    fns = [lambda xb, f=stacked_logits_fn(net), st=stack:
           f(st, xb).float().sum(dim=0) for net, stack in groups]
    return _accuracy_of_summed_logits(fns, x, y, batch_size)
