"""Cohort sampling policies behind a registry (mirrors core/strategies.py).

The scheduler owns the *who trains next* decision.  ``RoundEngine``
delegates its historic ``rng.choice`` draw here (``uniform`` with a full
population reproduces it bit-for-bit), while the buffered-async driver
passes an availability mask so offline / in-flight clients are skipped.

Samplers:

- ``uniform``        — the paper's i.i.d. cohort draw.
- ``capacity_aware`` — fills PR 5's run-fixed (prototype, step-bucket)
  client capacities cell by cell, fullest cells first, so fewer buckets
  open per round and padded-slot waste drops (docs/bucketing.md).
- ``prioritized``    — O(log N) sum-tree draw keyed on last observed
  staleness: clients whose uploads keep arriving stale (or who were
  recently dropped) are resampled sooner, pulling their freshness up.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Type

import numpy as np

from repro_torch.population.sumtree import SumTree


@dataclasses.dataclass
class SamplerContext:
    """Run-fixed population facts a sampler may condition on."""
    n_clients: int                 # population size N
    n_partitions: int              # engine data partitions (<= N)
    proto: np.ndarray              # [N] prototype group of each client
    bucket: np.ndarray             # [N] step-bucket within its prototype
    bucket_client_caps: List[List[int]]  # per proto: client cap per bucket
    priority_init: float = 1.0


class CohortSampler:
    """Base policy: bind once to a run's context, then draw cohorts."""
    kind = "base"

    def bind(self, ctx: SamplerContext) -> "CohortSampler":
        self.ctx = ctx
        return self

    def sample(self, rng: np.random.Generator, k: int,
               available: Optional[np.ndarray] = None,
               tick: int = 0) -> np.ndarray:
        raise NotImplementedError

    def observe(self, ids, staleness=None) -> None:
        """Feedback after uploads are consumed (no-op by default)."""

    def penalize(self, ids, priority) -> None:
        """Downweight quarantined clients (no-op for unweighted policies)."""

    def load_priorities(self, values) -> None:
        """Restore per-client sampling state from a checkpoint (no-op)."""


_SAMPLERS: Dict[str, Type[CohortSampler]] = {}


def register_sampler(name: str):
    def deco(cls):
        cls.kind = name
        _SAMPLERS[name] = cls
        return cls
    return deco


def get_sampler(name: str) -> Type[CohortSampler]:
    if name not in _SAMPLERS:
        raise KeyError(f"unknown cohort sampler {name!r}; "
                       f"options: {sorted(_SAMPLERS)}")
    return _SAMPLERS[name]


def make_sampler(name: str) -> CohortSampler:
    return get_sampler(name)()


def available_samplers() -> List[str]:
    return sorted(_SAMPLERS)


@register_sampler("uniform")
class UniformSampler(CohortSampler):
    """The historic engine draw: k distinct clients, equal probability.

    With ``available=None`` (everyone reachable) this is *exactly*
    ``rng.choice(N, size=k, replace=False)`` — the call the engine made
    before the scheduler seam existed — so default-config trajectories
    stay bit-identical.
    """

    def sample(self, rng, k, available=None, tick=0):
        if available is None:
            k = min(k, self.ctx.n_clients)
            return rng.choice(self.ctx.n_clients, size=k, replace=False)
        available = np.asarray(available)
        k = min(k, len(available))
        return rng.choice(available, size=k, replace=False)


@register_sampler("capacity_aware")
class CapacityAwareSampler(CohortSampler):
    """Fill run-fixed (prototype, bucket) capacities, fullest cells first.

    ``build_round_batches`` pads every *opened* bucket to its run-fixed
    client capacity x step capacity, so the waste metric is driven by how
    many cells a cohort opens and how full each is.  Greedy: shuffle the
    available pool, group by cell, take whole cells in decreasing
    fill-count order up to each cell's cap; spill past the caps only when
    the cohort can't otherwise be filled.
    """

    def sample(self, rng, k, available=None, tick=0):
        ctx = self.ctx
        ids = (np.arange(ctx.n_clients) if available is None
               else np.asarray(available))
        ids = ids[rng.permutation(len(ids))]
        k = min(k, len(ids))
        by_cell: Dict[tuple, list] = {}
        for i in ids:
            by_cell.setdefault(
                (int(ctx.proto[i]), int(ctx.bucket[i])), []).append(int(i))

        def cap(cell):
            caps = ctx.bucket_client_caps[cell[0]]
            return caps[cell[1]] if cell[1] < len(caps) else k

        cells = sorted(by_cell.items(),
                       key=lambda kv: (-min(len(kv[1]), cap(kv[0])), kv[0]))
        chosen: list = []
        taken: Dict[tuple, int] = {}
        for cell, members in cells:
            if len(chosen) >= k:
                break
            take = min(cap(cell), len(members), k - len(chosen))
            chosen.extend(members[:take])
            taken[cell] = take
        if len(chosen) < k:   # capacities exhausted: spill round-robin
            for cell, members in cells:
                extra = members[taken.get(cell, 0):]
                take = min(len(extra), k - len(chosen))
                chosen.extend(extra[:take])
                if len(chosen) >= k:
                    break
        return np.asarray(chosen, dtype=np.int64)


@register_sampler("prioritized")
class PrioritizedSampler(CohortSampler):
    """Sum-tree draw proportional to per-client priority (1 + staleness).

    ``observe`` bumps a client's priority to ``1 + s`` after its upload
    is consumed at staleness ``s``, so chronically stale clients are
    redrawn sooner.  Unseen clients keep ``priority_init``.  Masking an
    availability subset costs O(U log N) for U unavailable clients
    (priorities are zeroed for the draw and restored after).
    """

    def bind(self, ctx):
        super().bind(ctx)
        self.tree = SumTree.from_values(
            np.full(ctx.n_clients, ctx.priority_init, np.float64))
        return self

    def sample(self, rng, k, available=None, tick=0):
        n = self.ctx.n_clients
        if available is None:
            return self.tree.sample(rng, min(k, n))
        available = np.asarray(available)
        mask = np.zeros(n, np.bool_)
        mask[available] = True
        off = np.flatnonzero(~mask)
        saved = [(int(i), self.tree.get(int(i))) for i in off]
        try:
            for i, _ in saved:
                self.tree.set(i, 0.0)
            return self.tree.sample(rng, min(k, len(available)))
        finally:
            for i, v in saved:
                self.tree.set(i, v)

    def observe(self, ids, staleness=None):
        s = 0.0 if staleness is None else staleness
        self.tree.set_many(np.asarray(ids), 1.0 + np.asarray(s, np.float64))

    def penalize(self, ids, priority):
        """Sink quarantined clients: set their mass to ``priority``."""
        self.tree.set_many(np.asarray(ids),
                           np.asarray(priority, np.float64))

    def load_priorities(self, values):
        self.tree = SumTree.from_values(np.asarray(values, np.float64))
