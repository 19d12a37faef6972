"""The serial reference driver.

Phase order per round t:

    sample_cohort -> build_round_batches -> train_clients -> aggregate
    -> evaluate_round

Nothing overlaps; round t+1's client training starts from round t's
fused globals.  ``phase_seconds`` keeps each round's wall seconds per
phase.  ``log_fn`` receives each group's ``RoundLog`` as the round ends
(``(group, RoundLog)`` in a heterogeneous run).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.engine import RoundEngine
from repro_torch.drivers.base import Driver, register_driver


@register_driver("sync")
class SyncDriver(Driver):
    def __init__(self, staleness: int = 0, prefetch: int = 1):
        if staleness != 0:
            raise ValueError(
                f"{type(self).__name__} runs sync semantics; staleness="
                f"{staleness} only applies to the async_pipelined driver")
        super().__init__(staleness=staleness, prefetch=prefetch)

    def run(self, engine: RoundEngine, *, init_globals=None, log_fn=None):
        globals_, state, logs, rng = self._setup(engine, init_globals)
        rounds_to_target = None

        def timed(phases, name, fn, *args):
            return self._timed(engine, phases, name, fn, *args)

        for t in range(1, engine.cfg.rounds + 1):
            phases: Dict[str, float] = {}
            active = timed(phases, "sample_cohort", engine.sample_cohort,
                           rng)
            batches = timed(phases, "build_round_batches",
                            engine.build_round_batches, t, active)
            groups = timed(phases, "train_clients", engine.train_clients, t,
                           globals_, batches)
            globals_, state, infos = timed(phases, "aggregate",
                                           engine.aggregate, t, groups,
                                           state)
            round_logs = timed(phases, "evaluate_round",
                               engine.evaluate_round, t, globals_, groups,
                               infos)
            self.phase_seconds.append(phases)
            stop = False
            for p, log in enumerate(round_logs):
                logs[p].append(log)
                if log_fn is not None:
                    # a log_fn returning the literal True requests a stop
                    ret = log_fn((p, log) if engine.heterogeneous else log)
                    stop = stop or ret is True
            if engine.target_reached(round_logs):
                rounds_to_target = t
                break
            if stop:
                break

        return self._results(engine, logs, globals_, rounds_to_target)
