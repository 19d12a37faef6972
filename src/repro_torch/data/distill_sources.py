"""Distillation data sources for FedDF's server-side fusion (paper §3).

Every source exposes ``sample(generator, batch_size) -> inputs``.  A source
backed by a finite pool also exposes ``pool()`` and ``sample_indices(
generator, batch_size)``, with ``sample(g, b) == pool()[sample_indices(g,
b)]`` for equal generator states, which is what the teacher-logit bank
(``core/logit_bank.py``) builds on.

The distillation loop draws its indices through :meth:`DistillSource.
index_stream`: one ``[chunk, batch_size]`` int64 block per ``eval_every``
chunk, drawn on the host from a CPU ``torch.Generator`` seeded by the
fusion seed and moved to the device once per chunk.  The stream is
therefore the same whichever device the fusion runs on.  ``index_stream``
is also the seam through which a caller injects an exact index sequence
(for example the one the JAX package's key chain draws).

Only :class:`UnlabeledDataset` is ported; the generator and noise sources
synthesize inputs on the fly and wait for ROADMAP.md queue 1 item 9.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

# fn(seed, batch_size, chunk) -> iterator of [chunk, batch_size] index blocks
IndexStream = Callable[[int, int, int], Iterator]


class DistillSource:
    def sample(self, generator: torch.Generator, batch_size: int):
        raise NotImplementedError

    def pool(self) -> Optional[torch.Tensor]:
        """Full indexable candidate tensor [N, ...], or None when samples
        are synthesized on the fly (None disables the logit bank)."""
        return None

    def sample_indices(self, generator: torch.Generator,
                       batch_size: int) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} exposes no indexable pool")

    def index_stream(self, seed: int, batch_size: int,
                     chunk: int) -> Iterator[torch.Tensor]:
        raise NotImplementedError(
            f"{type(self).__name__} exposes no indexable pool")


class UnlabeledDataset(DistillSource):
    """Random minibatches from an unlabeled pool held on ``device``.

    ``indices`` replaces the default index stream: a callable
    ``(seed, batch_size, chunk) -> iterator`` yielding ``[chunk,
    batch_size]`` integer arrays (numpy or torch)."""

    def __init__(self, x: np.ndarray, device="cpu",
                 indices: Optional[IndexStream] = None):
        self.x = torch.as_tensor(np.asarray(x), device=device)
        self.indices = indices

    def __len__(self) -> int:
        return int(self.x.shape[0])

    def pool(self):
        return self.x

    def sample_indices(self, generator, batch_size):
        return torch.randint(0, len(self), (batch_size,),
                             generator=generator)

    def sample(self, generator, batch_size):
        idx = self.sample_indices(generator, batch_size)
        return self.x[idx.to(self.x.device)]

    def index_stream(self, seed, batch_size, chunk):
        if self.indices is not None:
            for block in self.indices(seed, batch_size, chunk):
                yield torch.as_tensor(np.asarray(block), dtype=torch.int64)
            return
        g = torch.Generator().manual_seed(int(seed))
        while True:
            yield torch.stack([self.sample_indices(g, batch_size)
                               for _ in range(chunk)])
