"""Round-driver protocol + registry.

A :class:`Driver` owns the round loop over a :class:`~repro_torch.core.
engine.RoundEngine`; the engine owns the math.  ``sync`` and
``buffered_async`` are ported; the JAX package's other drivers raise
``NotImplementedError`` naming their ROADMAP.md item.  Every driver keeps
``phase_seconds``: each round's wall seconds per phase, with the device
synchronised at each phase end so that queued work is charged to the
phase that issued it.  Every driver keeps one log list per prototype
group.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.engine import FLResult, RoundEngine, RoundLog

_PENDING = {"async_pipelined": "ROADMAP.md queue 1 item 10",
            "distributed": "ROADMAP.md queue 1 item 10",
            "multihost": "ROADMAP.md queue 1 item 11"}


class Driver:
    """Interface: compose engine phases into a full run.  ``run`` returns
    ``(per-prototype FLResults, final globals, rounds_to_target)``."""

    kind: str = "base"

    def __init__(self, staleness: int = 0, prefetch: int = 1):
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.staleness = staleness
        self.prefetch = prefetch
        self.phase_seconds: List[Dict[str, float]] = []

    def run(self, engine: RoundEngine, *,
            init_globals: Optional[List[dict]] = None
            ) -> Tuple[List[FLResult], List[dict], Optional[int]]:
        raise NotImplementedError

    def _setup(self, engine: RoundEngine, init_globals):
        globals_ = (list(init_globals) if init_globals is not None
                    else engine.init_globals())
        state = engine.init_state(globals_)
        logs: List[List[RoundLog]] = [[] for _ in range(engine.n_proto)]
        return globals_, state, logs, engine.make_rng()

    @staticmethod
    def _timed(engine: RoundEngine, phases: Dict[str, float], name: str,
               fn, *args):
        """``fn(*args)``, its wall seconds added to ``phases[name]``."""
        t0 = time.perf_counter()
        out = fn(*args)
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
        return out

    @staticmethod
    def _results(engine: RoundEngine, logs, globals_, rounds_to_target):
        results = [FLResult(logs=logs[p], global_params=globals_[p])
                   for p in range(engine.n_proto)]
        return results, globals_, rounds_to_target


_REGISTRY: Dict[str, type] = {}


def register_driver(name: str):
    def deco(cls):
        cls.kind = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_driver(name: str) -> type:
    if name in _PENDING:
        raise NotImplementedError(f"driver {name!r} is not ported yet "
                                  f"({_PENDING[name]})")
    if name not in _REGISTRY:
        raise ValueError(f"unknown driver {name!r}; registered: "
                         f"{available_drivers()}")
    return _REGISTRY[name]


def make_driver(name: str, *, staleness: int = 0,
                prefetch: int = 1) -> Driver:
    return get_driver(name)(staleness=staleness, prefetch=prefetch)


def available_drivers() -> List[str]:
    return sorted(_REGISTRY)
