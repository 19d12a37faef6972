"""O(log N) prioritized sampling over a complete binary sum tree.

The classic prioritized-replay structure: leaf ``i`` holds a non-negative
priority, internal nodes hold subtree sums, so point updates and
prefix-sum lookups (sample u ~ U[0, total), walk down to the leaf whose
cumulative interval contains u) are both O(log N).  Backs the
``prioritized`` cohort sampler (population/scheduler.py) at population
scale, where a naive ``searchsorted(cumsum(p))`` would be O(N) per
update.
"""
from __future__ import annotations

import numpy as np


class SumTree:
    """Fixed-capacity sum tree over ``n`` non-negative priorities.

    Stored as a flat heap-ordered array of ``2 * capacity`` float64 slots
    (capacity = next power of two >= n); leaves live at
    ``[capacity, capacity + n)`` and the root sum at index 1.
    """

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"sum tree needs n >= 1, got {n}")
        self.n = int(n)
        cap = 1
        while cap < self.n:
            cap *= 2
        self._cap = cap
        self._tree = np.zeros(2 * cap, dtype=np.float64)

    @classmethod
    def from_values(cls, values) -> "SumTree":
        """Vectorized O(N) build: fill the leaves, sum level by level."""
        values = np.asarray(values, dtype=np.float64)
        if values.ndim != 1:
            raise ValueError("from_values expects a 1-D priority array")
        if (values < 0).any():
            raise ValueError("priorities must be non-negative")
        t = cls(len(values))
        t._tree[t._cap:t._cap + t.n] = values
        level = t._tree[t._cap:2 * t._cap]
        lo = t._cap
        while lo > 1:
            lo //= 2
            level = level[0::2] + level[1::2]
            t._tree[lo:2 * lo] = level
        return t

    def total(self) -> float:
        return float(self._tree[1])

    def get(self, i: int) -> float:
        return float(self._tree[self._cap + i])

    def values(self) -> np.ndarray:
        """Copy of the current leaf priorities (length n)."""
        return self._tree[self._cap:self._cap + self.n].copy()

    def set(self, i: int, value: float) -> None:
        """Point update, propagating sums to the root: O(log N)."""
        if not 0 <= i < self.n:
            raise IndexError(f"leaf {i} out of range [0, {self.n})")
        if value < 0:
            raise ValueError("priorities must be non-negative")
        node = self._cap + i
        delta = float(value) - self._tree[node]
        while node >= 1:
            self._tree[node] += delta
            node //= 2

    def set_many(self, ids, values) -> None:
        ids = np.asarray(ids)
        values = np.broadcast_to(np.asarray(values, np.float64), ids.shape)
        for i, v in zip(ids.ravel(), values.ravel()):
            self.set(int(i), float(v))

    def find(self, u: float) -> int:
        """Leaf whose cumulative-priority interval contains ``u``.

        Equivalent to ``searchsorted(cumsum(values), u, side='right')``
        for ``u`` in ``[0, total)``, in O(log N).
        """
        node = 1
        while node < self._cap:
            left = 2 * node
            if u < self._tree[left]:
                node = left
            else:
                u -= self._tree[left]
                node = left + 1
        return min(node - self._cap, self.n - 1)

    def sample(self, rng: np.random.Generator, k: int,
               replace: bool = False) -> np.ndarray:
        """Draw ``k`` leaves with probability proportional to priority.

        Without replacement, drawn leaves are temporarily zeroed and
        restored afterwards, so the tree is unchanged on return.
        """
        out = np.empty(k, dtype=np.int64)
        if replace:
            for j in range(k):
                out[j] = self.find(rng.random() * self.total())
            return out
        saved = []
        try:
            for j in range(k):
                total = self.total()
                if total <= 0.0:
                    raise ValueError(
                        f"sum tree exhausted after {j} draws (k={k}): "
                        f"not enough positive-priority leaves")
                i = self.find(rng.random() * total)
                out[j] = i
                saved.append((i, self.get(i)))
                self.set(i, 0.0)
        finally:
            for i, v in reversed(saved):
                self.set(i, v)
        return out
