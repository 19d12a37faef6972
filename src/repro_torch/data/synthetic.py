"""Synthetic datasets for the paper-validation experiments (offline stand-ins
for CIFAR / AG News — see DESIGN.md "changed assumptions").

Two task families:

* ``gaussian_mixture`` — M-class Gaussian blobs in R^d (generalises the
  paper's Fig. 1 toy: 3-class, 2-D, 3-layer MLP).  Non-trivial class overlap
  so accuracy is a meaningful signal.
* ``token_sequences`` — M-class synthetic text: each class has its own
  token unigram distribution plus class-indicative marker tokens; a small
  transformer must aggregate evidence over the sequence (AG News stand-in).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray  # [N, ...] float or int
    y: np.ndarray  # [N] int
    n_classes: int

    def __len__(self):
        return len(self.y)

    def subset(self, idx: np.ndarray) -> "Dataset":
        return Dataset(self.x[idx], self.y[idx], self.n_classes)


def gaussian_mixture(n: int, n_classes: int = 3, dim: int = 2,
                     spread: float = 2.2, noise: float = 1.0,
                     seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    # class means on a circle (dim>=2) / random directions otherwise
    means = rng.normal(size=(n_classes, dim))
    means = spread * means / np.linalg.norm(means, axis=1, keepdims=True)
    y = rng.integers(0, n_classes, size=n)
    x = means[y] + noise * rng.normal(size=(n, dim))
    return Dataset(x.astype(np.float32), y.astype(np.int64), n_classes)


def token_sequences(n: int, n_classes: int = 4, vocab: int = 64,
                    seq_len: int = 16, marker_rate: float = 0.3,
                    seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    # per-class unigram dists + dedicated marker tokens
    base = rng.dirichlet([0.5] * (vocab - n_classes), size=n_classes)
    y = rng.integers(0, n_classes, size=n)
    x = np.empty((n, seq_len), dtype=np.int64)
    for i in range(n):
        c = y[i]
        toks = rng.choice(vocab - n_classes, size=seq_len, p=base[c])
        marks = rng.random(seq_len) < marker_rate
        toks[marks] = vocab - n_classes + c
        x[i] = toks
    return Dataset(x, y.astype(np.int64), n_classes)


def train_val_test_split(ds: Dataset, val_frac: float = 0.1,
                         test_frac: float = 0.2, seed: int = 0
                         ) -> Tuple[Dataset, Dataset, Dataset]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    n_test = int(len(ds) * test_frac)
    n_val = int(len(ds) * val_frac)
    return (ds.subset(idx[n_test + n_val:]), ds.subset(idx[n_test:n_test + n_val]),
            ds.subset(idx[:n_test]))


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int,
            epochs: int = 1):
    rng = np.random.default_rng(seed)
    n = len(y)
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            ix = order[s:s + batch_size]
            yield x[ix], y[ix]
        if n < batch_size:  # tiny client: one padded batch per epoch
            ix = rng.choice(n, size=batch_size, replace=True)
            yield x[ix], y[ix]
