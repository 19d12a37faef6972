"""Round-driver protocol + registry.

A :class:`Driver` owns the round loop over a :class:`~repro_torch.core.
engine.RoundEngine`; the engine owns the math.  ``sync``,
``async_pipelined``, ``buffered_async`` and ``distributed`` are ported;
``multihost`` raises ``NotImplementedError`` naming its ROADMAP.md item.
Every driver keeps ``phase_seconds``: each round's wall seconds per
phase, with the issuing thread's current CUDA stream synchronised at each
phase end, so that queued work is charged to the phase that issued it and
a phase never waits for work another thread queued on another stream
(the pipelined driver's fusion).  Every driver keeps one log list per
prototype group, and stamps its name on the flight recorder's spans.

Resume (``api/experiment.Experiment.resume``): ``run`` takes the
checkpointed ``init_globals`` / ``init_state`` / ``init_logs`` and
``start_round = <last completed round> + 1``; the sync, pipelined and
distributed drivers replay the completed rounds' cohort draws, the
pipelined one retrains its in-flight rounds from the bases the
checkpoint carries, and the buffered one restores its population snapshot
and the cohort rng's exact state (``wrap_state``).
``round_end_hook(t, globals_, state, logs, rounds_to_target)`` fires
after every completed round, in round order: the checkpoint seam.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import FLResult, RoundEngine, RoundLog
from repro_torch.obs import trace as _trace

# the strategy state's default: ``engine.init_state`` (None is a state)
_UNSET = object()

# marker key of a wrapped checkpoint state; a plain dict, so
# checkpoint/io.save_obj round-trips it without special cases
_STATE_KEY = "__async_pipeline__"


def wrap_state(strategy_state, prev_globals, *, base_ring=None,
               population=None):
    """A checkpoint state carrying more than the strategy's, in the JAX
    package's format.  The pipelined driver (staleness S >= 1) stores the
    training bases of its in-flight rounds: ``prev_globals`` is the next
    round's base, and ``base_ring`` (S > 1 only) the ordered bases of
    every unjoined round.  The buffered-async driver stores
    ``population``: the manager snapshot (registry, pending uploads,
    screen) and the cohort rng's bit-generator state."""
    d = {_STATE_KEY: True, "strategy_state": strategy_state,
         "prev_globals": prev_globals}
    if base_ring is not None:
        d["base_ring"] = list(base_ring)
    if population is not None:
        d["population"] = population
    return d


def unwrap_state(state):
    """``(strategy_state, prev_globals or None)`` from a possibly wrapped
    checkpoint state; a sync resume of a pipelined checkpoint just drops
    the stale base."""
    if isinstance(state, dict) and state.get(_STATE_KEY):
        return state["strategy_state"], state.get("prev_globals")
    return state, None


def _to_device(obj, device):
    """Arrays of a checkpointed state (numpy, or CPU tensors) -> tensors
    on ``device``, through dicts, lists and tuples."""
    if isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        return torch.as_tensor(obj).to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj

_PENDING = {"multihost": "ROADMAP.md queue 1 item 11"}


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

    def run(self, engine: RoundEngine, *, log_fn: Optional[Callable] = None,
            init_globals: Optional[List[dict]] = None, init_state=_UNSET,
            start_round: int = 1,
            init_logs: Optional[List[List[RoundLog]]] = None,
            round_end_hook: Optional[Callable] = None
            ) -> Tuple[List[FLResult], List[dict], Optional[int]]:
        raise NotImplementedError

    def _setup(self, engine: RoundEngine, init_globals, init_state=_UNSET,
               init_logs=None, start_round: int = 1):
        """Initial globals / state / logs, and the cohort rng with the
        completed rounds' draws replayed (identical resume trajectories).
        A checkpointed state's arrays move onto the engine's device; the
        pipelined driver's stale bases and a buffered-async snapshot are
        kept for the driver to restore."""
        _trace.set_context(driver=self.kind)
        globals_ = (list(init_globals) if init_globals is not None
                    else engine.init_globals())
        state = (engine.init_state(globals_) if init_state is _UNSET
                 else init_state)
        self._resume_population = self._resume_base_ring = None
        if isinstance(state, dict) and state.get(_STATE_KEY):
            self._resume_population = state.get("population")
            self._resume_base_ring = _to_device(state.get("base_ring"),
                                                engine.device)
        state, prev_base = unwrap_state(state)
        self._resume_prev_base = _to_device(prev_base, engine.device)
        if init_state is not _UNSET:
            state = _to_device(state, engine.device)
        logs: List[List[RoundLog]] = (
            [list(l) for l in init_logs] if init_logs is not None
            else [[] for _ in range(engine.n_proto)])
        rng = engine.make_rng()
        for _ in range(start_round - 1):
            engine.sample_cohort(rng)
        return globals_, state, logs, rng

    @staticmethod
    def _emit_round(engine: RoundEngine, round_logs: List[RoundLog],
                    logs: List[List[RoundLog]], log_fn) -> Tuple[bool, bool]:
        """Append the round's logs and notify ``log_fn`` per group
        (``(group, RoundLog)`` in a heterogeneous run).  Returns
        ``(target_reached, stop_requested)``: a log_fn returning the
        literal ``True`` requests a stop after this round."""
        stop_requested = False
        for p, log in enumerate(round_logs):
            logs[p].append(log)
            if log_fn is not None:
                ret = log_fn((p, log) if engine.heterogeneous else log)
                stop_requested = stop_requested or ret is True
        return engine.target_reached(round_logs), stop_requested

    @staticmethod
    def _timed(engine: RoundEngine, phases: Dict[str, float], name: str,
               fn, *args):
        """``fn(*args)``, its wall seconds added to ``phases[name]``; on
        the card, up to the end of the work it queued on the calling
        thread's current stream."""
        t0 = time.perf_counter()
        out = fn(*args)
        if engine.device.type == "cuda":
            torch.cuda.current_stream(engine.device).synchronize()
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


def pending_drivers() -> List[str]:
    """Driver kinds the JAX package has and the port does not run yet
    (:func:`get_driver` raises ``NotImplementedError`` for them)."""
    return sorted(_PENDING)
