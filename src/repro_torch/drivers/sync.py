"""The serial reference driver.

Phase order per round t:

    sample_cohort -> build_round_batches -> train_clients
    -> fault_pipeline -> aggregate -> guard_globals -> evaluate_round
    -> log -> round_end_hook

Nothing overlaps; round t+1's client training starts from round t's
fused globals.  ``phase_seconds`` keeps each round's wall seconds per
phase (``aggregate`` includes ``guard_globals``).  ``log_fn`` receives
each group's ``RoundLog`` as the round ends (``(group, RoundLog)`` in a
heterogeneous run).

The fault seam (docs/robustness.md) is inert unless ``cfg.faults``
enables an injection class: ``fault_pipeline`` corrupts, screens and
retries the trained stacks, a quorum shortfall skips aggregation for the
round (the globals carry over, ``RoundLog.fused=False``), and
``guard_globals`` rolls non-finite fused params back to the round's
starting globals.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.engine import RoundEngine
from repro_torch.drivers.base import _UNSET, Driver, register_driver


@register_driver("sync")
class SyncDriver(Driver):
    def __init__(self, staleness: int = 0, prefetch: int = 1):
        if staleness != 0:
            raise ValueError(
                f"{type(self).__name__} runs sync semantics; staleness="
                f"{staleness} only applies to the async_pipelined driver")
        super().__init__(staleness=staleness, prefetch=prefetch)

    def run(self, engine: RoundEngine, *, log_fn=None, init_globals=None,
            init_state=_UNSET, start_round=1, init_logs=None,
            round_end_hook=None):
        globals_, state, logs, rng = self._setup(
            engine, init_globals, init_state, init_logs, start_round)
        rounds_to_target = None
        n = engine.n_proto

        def timed(phases, name, fn, *args):
            return self._timed(engine, phases, name, fn, *args)

        def aggregate(t, groups, state, prev):
            globals_, state, infos = engine.aggregate(t, groups, state)
            globals_, rolled = engine.guard_globals(globals_, prev)
            return globals_, state, infos, rolled

        for t in range(start_round, engine.cfg.rounds + 1):
            phases: Dict[str, float] = {}
            active = timed(phases, "sample_cohort", engine.sample_cohort,
                           rng)
            batches = timed(phases, "build_round_batches",
                            engine.build_round_batches, t, active)
            groups = timed(phases, "train_clients", engine.train_clients, t,
                           globals_, batches)
            fstats = timed(phases, "fault_pipeline", engine.fault_pipeline,
                           t, groups, batches)
            fuse = engine.quorum_met(fstats)
            if fuse:
                globals_, state, infos, rolled = timed(
                    phases, "aggregate", aggregate, t, groups, state,
                    list(globals_))
            else:  # quorum shortfall: carry the globals, skip fusion
                infos, rolled = [{} for _ in range(n)], [False] * n
            round_logs = timed(phases, "evaluate_round",
                               engine.evaluate_round, t, globals_, groups,
                               infos)
            self.phase_seconds.append(phases)
            if fstats is not None:
                for p, log in enumerate(round_logs):
                    log.n_corrupted = fstats["corrupted"]
                    log.n_quarantined = fstats["quarantined"]
                    log.n_retries = fstats["retries"]
                    log.fused = fuse
                    log.rolled_back = bool(log.rolled_back or rolled[p])
            reached, stop = self._emit_round(engine, round_logs, logs,
                                             log_fn)
            if reached:
                rounds_to_target = t
            # the target check precedes the hook, so a checkpoint records
            # the stop and a resumed run does not retrain past it
            if round_end_hook is not None:
                round_end_hook(t, globals_, state, logs, rounds_to_target)
            if rounds_to_target is not None or stop:
                break

        return self._results(engine, logs, globals_, rounds_to_target)
