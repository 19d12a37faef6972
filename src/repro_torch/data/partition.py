"""Dirichlet non-i.i.d. client partitioning (paper §4.1, Appendix C.2).

Each client's class distribution q_k ~ Dir(alpha * p), where p is the prior
class distribution.  alpha -> inf mimics identical local distributions;
alpha -> 0 gives one-class clients.  Partitions are *disjoint* — samples are
allocated class-by-class proportionally to the clients' Dirichlet weights,
exactly as in Yurochkin et al. / Hsu et al. (refs [79, 25] of the paper).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 1
                        ) -> List[np.ndarray]:
    """Return a list of disjoint index arrays, one per client."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    idx_by_class = {c: rng.permutation(np.where(labels == c)[0])
                    for c in classes}
    # client weights per class: column k of a [C, K] Dirichlet draw
    props = rng.dirichlet([alpha] * n_clients, size=len(classes))  # [C, K]
    client_idx: List[list] = [[] for _ in range(n_clients)]
    for ci, c in enumerate(classes):
        idx = idx_by_class[c]
        # proportional split with exact coverage
        cuts = (np.cumsum(props[ci]) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    out = [np.asarray(sorted(ix), dtype=np.int64) for ix in client_idx]
    # guarantee non-empty clients (tiny datasets + small alpha)
    pool = max(range(n_clients), key=lambda k: len(out[k]))
    for k in range(n_clients):
        while len(out[k]) < min_per_client and len(out[pool]) > min_per_client:
            out[k] = np.append(out[k], out[pool][-1])
            out[pool] = out[pool][:-1]
    return out


def class_histogram(labels: np.ndarray, parts: Sequence[np.ndarray],
                    n_classes: int) -> np.ndarray:
    """[K, C] sample counts — the paper's Fig. 2 dot plot data."""
    h = np.zeros((len(parts), n_classes), dtype=np.int64)
    for k, ix in enumerate(parts):
        for c in range(n_classes):
            h[k, c] = int(np.sum(labels[ix] == c))
    return h
