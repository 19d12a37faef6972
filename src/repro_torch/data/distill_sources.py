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

The generator and noise sources (paper Fig. 5) have no pool: they
synthesize inputs on the fly, so distillation runs the on-the-fly path
(kernel K2).  Their random numbers (latents, uniform draws) come the same
way, one ``[chunk, batch_size, ...]`` block per chunk from a CPU
``torch.Generator``, moved once; :meth:`DistillSource.input_stream`
yields the chunk's inputs on the device.  ``draws=`` replaces those random
numbers with a caller's, through the same ``(seed, batch_size, chunk) ->
iterator`` signature as ``UnlabeledDataset(indices=)``.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

# fn(seed, batch_size, chunk) -> iterator of [chunk, batch_size, ...] blocks
# (indices for a pool, latents or uniform draws for the synthetic sources)
IndexStream = Callable[[int, int, int], Iterator]
DrawStream = IndexStream


def _injected(stream: IndexStream, seed: int, batch_size: int, chunk: int,
              dtype) -> Iterator[torch.Tensor]:
    for block in stream(seed, batch_size, chunk):
        yield torch.as_tensor(np.asarray(block), dtype=dtype)


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

    def input_stream(self, seed: int, batch_size: int,
                     chunk: int) -> Iterator[torch.Tensor]:
        """One ``[chunk, batch_size, ...]`` block of distillation inputs
        per ``eval_every`` chunk, on the source's device."""
        pool = self.pool()
        for idx in self.index_stream(seed, batch_size, chunk):
            yield pool[idx.to(pool.device)]


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
            yield from _injected(self.indices, seed, batch_size, chunk,
                                 torch.int64)
            return
        g = torch.Generator().manual_seed(int(seed))
        while True:
            yield torch.stack([self.sample_indices(g, batch_size)
                               for _ in range(chunk)])


class _SyntheticSource(DistillSource):
    """Shared draw plumbing of the pool-less sources: the random numbers
    of each chunk (``_draw_shape`` per sample) come from a CPU
    ``torch.Generator`` seeded by the fusion seed, or from ``draws``."""

    draws: Optional[DrawStream] = None
    device = torch.device("cpu")

    def _draw_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def _draw(self, generator: torch.Generator, shape) -> torch.Tensor:
        raise NotImplementedError

    def _decode(self, draws: torch.Tensor) -> torch.Tensor:
        """[..., B, draw] random numbers on the device -> inputs."""
        raise NotImplementedError

    def _draw_stream(self, seed: int, batch_size: int,
                     chunk: int) -> Iterator[torch.Tensor]:
        g = torch.Generator().manual_seed(int(seed))
        while True:
            yield self._draw(g, (chunk, batch_size) + self._draw_shape())

    def input_stream(self, seed, batch_size, chunk):
        blocks = (self._draw_stream(seed, batch_size, chunk)
                  if self.draws is None else
                  _injected(self.draws, seed, batch_size, chunk,
                            torch.float32))
        for block in blocks:
            yield self._decode(block.to(self.device))

    def sample(self, generator, batch_size):
        return self._decode(self._draw(
            generator, (batch_size,) + self._draw_shape()).to(self.device))


def _no_tokens(discrete_vocab: Optional[int]) -> None:
    if discrete_vocab is not None:
        raise NotImplementedError("token inputs from a synthetic source "
                                  "wait for the tokens task, ROADMAP.md "
                                  "queue 1 item 8")


class GeneratorSource(_SyntheticSource):
    """Frozen generator: pseudo-data = decoder(noise), a frozen random MLP
    decoder whose outputs are matched to the data's first two moments (a
    quality-degraded generator, the regime of the paper's Fig. 5).

    ``w1`` [latent_dim, hidden] and ``w2`` [hidden, prod(out_shape)]
    (numpy) replace the decoder weights, which are otherwise drawn from a
    CPU ``torch.Generator`` seeded by ``seed``."""

    def __init__(self, out_shape, latent_dim: int = 16, hidden: int = 64,
                 seed: int = 0, mean: float = 0.0, std: float = 1.0,
                 discrete_vocab: Optional[int] = None, device="cpu",
                 w1: Optional[np.ndarray] = None,
                 w2: Optional[np.ndarray] = None,
                 draws: Optional[DrawStream] = None):
        _no_tokens(discrete_vocab)
        self.out_shape = tuple(out_shape)
        self.latent_dim, self.hidden = int(latent_dim), int(hidden)
        self.mean, self.std = float(mean), float(std)
        self.device = torch.device(device)
        self.draws = draws
        out_dim = int(np.prod(self.out_shape))
        g = torch.Generator().manual_seed(int(seed))
        w1 = (torch.randn(self.latent_dim, self.hidden, generator=g) * 0.5
              if w1 is None else torch.from_numpy(np.array(w1, np.float32)))
        w2 = (torch.randn(self.hidden, out_dim, generator=g) * 0.5
              if w2 is None else torch.from_numpy(np.array(w2, np.float32)))
        self.w1, self.w2 = w1.to(self.device), w2.to(self.device)
        if (tuple(self.w1.shape) != (self.latent_dim, self.hidden)
                or tuple(self.w2.shape) != (self.hidden, out_dim)):
            raise ValueError(f"decoder weights must be [{self.latent_dim}, "
                             f"{self.hidden}] and [{self.hidden}, "
                             f"{out_dim}], got {tuple(self.w1.shape)} and "
                             f"{tuple(self.w2.shape)}")

    def _draw_shape(self):
        return (self.latent_dim,)

    def _draw(self, generator, shape):
        return torch.randn(shape, generator=generator)

    def _decode(self, z):
        out = torch.tanh(z @ self.w1) @ self.w2
        # the population std (ddof 0) over each batch, as jnp.std
        std = out.std(dim=(-2, -1), correction=0, keepdim=True)
        out = self.mean + self.std * out / (std + 1e-6)
        return out.reshape(out.shape[:-1] + self.out_shape)


class RandomNoiseSource(_SyntheticSource):
    """Uniform random inputs on ``[low, high)``: the paper's 'dramatically
    different manifold' control.  ``draws`` injects the samples
    themselves (already on ``[low, high)``)."""

    def __init__(self, out_shape, low: float = -3.0, high: float = 3.0,
                 discrete_vocab: Optional[int] = None, device="cpu",
                 draws: Optional[DrawStream] = None):
        _no_tokens(discrete_vocab)
        self.out_shape = tuple(out_shape)
        self.low, self.high = float(low), float(high)
        self.device = torch.device(device)
        self.draws = draws

    def _draw_shape(self):
        return self.out_shape

    def _draw(self, generator, shape):
        u = torch.rand(shape, generator=generator)
        return self.low + (self.high - self.low) * u

    def _decode(self, x):
        return x
