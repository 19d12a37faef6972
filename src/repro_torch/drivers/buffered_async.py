"""FedBuff-style buffered-asynchronous round driver.

Instead of one synchronized cohort per round, client training is
dispatched in WAVES over a registered population (``repro_torch.
population``): each wave's uploads land in a virtual-time buffer after a
traffic-drawn latency, and the server aggregates as soon as ``M =
buffer_size`` usable uploads have arrived.  Stragglers from earlier waves
fuse late with a FedAsync importance ``(1 + s)^-a`` (``s`` = fusions
completed since the upload's training base, ``a = staleness_exponent``),
which FedDF turns into a weighted teacher consensus (kernel K3 on the
on-the-fly path, a weighted logit bank otherwise).  Uploads older than
``max_staleness`` are discarded with telemetry.

Several prototypes (Algorithm 3): the consumed uploads regroup by
prototype into one ``GroupRound`` each.  A prototype with no consumed
upload keeps its globals (``stack=None``), an all-fresh group keeps
``importance=None``, and a group with stale uploads carries ``(1 + s)^-a``;
the heterogeneous fusion turns those into teacher weights over every
group's teachers (uniform for a group without importance).  The round's
population telemetry is stamped on every group's log.

Degenerate equality: with ``buffer_size == n_active``, zero latency, the
uniform sampler and ``staleness=0``, every round is exactly one wave
whose uploads all fuse fresh, and the trajectory is bit-identical to the
``sync`` driver.

Staleness knob (bounded <= 1; upload-level staleness is governed by
``max_staleness``):

  staleness=0  fill-then-fuse: each round's waves train from the newest
               fused globals.
  staleness=1  the round's waves train from the PREVIOUS fusion while
               the current one runs on a worker thread: client training
               overlaps server-side distillation, at the cost of one
               extra round of upload staleness.  The worker sets its own
               grad mode (thread-local in PyTorch) and launches on the
               default stream.

``phase_seconds`` records per round: ``fill`` (wave dispatch and client
training), ``join_fusion`` (the wait for the fusion) and
``evaluate_round``.

Quorum semantics (docs/robustness.md): with ``FaultSpec.quorum`` set, a
round whose wave dispatch cannot buffer ``M`` usable uploads (screening
quarantined too many, or the population ran out of dispatchable clients)
fuses PARTIALLY when at least ``ceil(quorum * M)`` usable uploads are
buffered, and otherwise SKIPS fusion for the round: the globals carry
over, the round is still evaluated, logged (``RoundLog.fused=False``) and
checkpointed.  ``quorum=None`` keeps the strict behaviour: a fill
shortfall raises.

Checkpoint/resume: the ``round_end_hook`` state is wrapped
(``drivers.base.wrap_state``) with the full population snapshot: the
registry arrays, virtual clock, fault counters, the screen's window,
pending uploads (trained params included) and the cohort rng's
bit-generator state.  Waves per round depend on traffic, so the rng
cannot be replayed by round count as the sync driver does; restoring its
exact state makes a resumed run's wave schedule, and so its trajectory,
the uninterrupted run's.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_cat
from repro_torch.core.engine import RoundEngine
from repro_torch.core.strategies import GroupRound
from repro_torch.drivers.base import (_UNSET, Driver, _to_device,
                                      register_driver, wrap_state)
from repro_torch.obs.trace import span


@register_driver("buffered_async")
class BufferedAsyncDriver(Driver):
    def __init__(self, staleness: int = 0, prefetch: int = 1):
        if staleness not in (0, 1):
            raise ValueError(
                f"buffered_async bounds the training-overlap staleness "
                f"knob to 0 or 1 (got {staleness}); upload staleness is "
                f"governed by PopulationSpec.max_staleness instead")
        super().__init__(staleness=staleness, prefetch=prefetch)

    def run(self, engine: RoundEngine, *, log_fn=None, init_globals=None,
            init_state=_UNSET, start_round=1, init_logs=None,
            round_end_hook=None):
        globals_, state, logs, rng = self._setup(
            engine, init_globals, init_state, init_logs, start_round)
        pop = engine.population()
        if self._resume_population is not None:
            manager = dict(self._resume_population["manager"])
            manager["pending"] = [
                {**up, "params": _to_device(up["params"], engine.device)}
                for up in manager["pending"]]
            pop.load_state(manager)
            # waves per round vary with traffic, so the cohort rng is
            # restored by exact state, not replayed by round count
            rng.bit_generator.state = _plain(
                self._resume_population["rng"])
        m = pop.buffer_size
        a = float(engine.cfg.population.staleness_exponent)
        quorum = engine.cfg.faults.quorum
        rounds_to_target = None
        fused = start_round - 1      # completed fusions (= base version)
        grad_mode = torch.is_grad_enabled()

        agg_ex = ThreadPoolExecutor(max_workers=1)
        agg_fut = None
        agg_round: Optional[int] = None
        agg_tele: Optional[dict] = None
        phases: Dict[int, Dict[str, float]] = {}

        def aggregate_task(t, groups, st):
            # grad mode is thread-local: the worker takes the caller's
            with torch.set_grad_enabled(grad_mode):
                return (groups,) + engine.aggregate(t, groups, st)

        def fill(t: int) -> bool:
            """Dispatch waves until M usable uploads are buffered.  Returns
            False on a shortfall when a quorum is configured (the caller
            then fuses partially or skips the round); without a quorum a
            shortfall raises."""
            max_waves = 64 + 16 * (-(-m // max(1, pop.n_active)))
            waves = 0
            while pop.usable_pending(t) < m:
                if waves >= max_waves:
                    if quorum is not None:
                        return False
                    raise RuntimeError(
                        f"round {t}: {waves} waves did not buffer "
                        f"{m} usable uploads; lower traffic.dropout / "
                        f"buffer_size or raise max_staleness")
                waves += 1
                try:
                    w, cohort = pop.next_wave(rng)
                except RuntimeError:
                    if quorum is not None:  # population exhausted
                        return False
                    raise
                # wave spans nest under the round's fill span; the engine
                # phases inside carry round=w (the wave number)
                with span("wave", round=t, wave=w):
                    parts = pop.registry.partition[np.asarray(cohort)]
                    batches = engine.build_round_batches(w, parts)
                    groups = engine.train_clients(w, globals_, batches)
                    pop.push_wave(w, cohort, groups, base_version=fused)
            return True

        def close_round(t, round_logs):
            """Log round t, then checkpoint it with the population
            snapshot; True when the run stops after it."""
            nonlocal rounds_to_target
            self.phase_seconds.append(phases[t])
            reached, stop = self._emit_round(engine, round_logs, logs,
                                             log_fn)
            if reached:
                rounds_to_target = t
            if round_end_hook is not None:
                round_end_hook(t, globals_, wrap_state(
                    state, globals_,
                    population={"manager": pop.state_dict(),
                                "rng": rng.bit_generator.state}),
                    logs, rounds_to_target)
            return rounds_to_target is not None or stop

        def finish():
            """Join the pending fusion, guard, evaluate, close the round."""
            nonlocal globals_, state, fused
            t, ph = agg_round, phases[agg_round]
            with span("join_fusion", round=t):
                groups, globals_, state, infos = self._timed(
                    engine, ph, "join_fusion", agg_fut.result)
            globals_, rolled = engine.guard_globals(
                globals_, [g.prev_global for g in groups])
            round_logs = self._timed(engine, ph, "evaluate_round",
                                     engine.evaluate_round, t, globals_,
                                     groups, infos)
            self._stamp(round_logs, agg_tele)
            for p, log in enumerate(round_logs):
                log.rolled_back = bool(log.rolled_back or rolled[p])
            fused = t
            return close_round(t, round_logs)

        def skip_round(t):
            """Quorum shortfall: evaluate the carried globals without
            fusing, stamp ``fused=False`` and the fault telemetry, close
            the round (checkpointed as usual)."""
            groups = [GroupRound(engine.nets[p], globals_[p], None,
                                 np.zeros(0))
                      for p in range(engine.n_proto)]
            round_logs = self._timed(
                engine, phases[t], "evaluate_round", engine.evaluate_round,
                t, globals_, groups, [{} for _ in range(engine.n_proto)])
            fc = pop.fault_counters(reset=True)
            for log in round_logs:
                log.fused = False
                log.n_corrupted = fc["n_corrupted"]
                log.n_quarantined = fc["n_quarantined"]
                log.n_retries = fc["n_retries"]
            return close_round(t, round_logs)

        try:
            stopped = False
            for t in range(start_round, engine.cfg.rounds + 1):
                phases[t] = {}
                if self.staleness == 0 and agg_fut is not None:
                    stopped = finish()  # sync-gated: fuse before new waves
                    agg_fut = None
                    if stopped:
                        break
                with span("fill", round=t):
                    filled = self._timed(engine, phases[t], "fill", fill, t)
                if agg_fut is not None:  # staleness=1: overlap fill/fuse
                    stopped = finish()
                    agg_fut = None
                    if stopped:
                        break
                m_t = m
                if not filled:  # quorum semantics: partial fuse or skip
                    need = max(1, int(np.ceil(quorum * m - 1e-9)))
                    usable = pop.usable_pending(t)
                    if usable < need:
                        stopped = skip_round(t)
                        if stopped:
                            break
                        continue
                    m_t = usable
                uploads, tele = pop.pop(t, m_t)
                groups = self._build_groups(engine, globals_,
                                            pop.regroup(uploads), a)
                agg_fut = agg_ex.submit(aggregate_task, t, groups, state)
                agg_round, agg_tele = t, tele
            if agg_fut is not None and not stopped:
                finish()
        finally:
            agg_ex.shutdown(wait=True, cancel_futures=True)

        return self._results(engine, logs, globals_, rounds_to_target)

    @staticmethod
    def _build_groups(engine, globals_, per_proto, a) -> List[GroupRound]:
        """Consumed uploads -> per-prototype GroupRounds.  All-fresh
        rounds keep ``importance=None``, the plain aggregation path."""
        groups: List[GroupRound] = []
        for p in range(engine.n_proto):
            e = per_proto.get(p)
            if e is None:
                groups.append(GroupRound(engine.nets[p], globals_[p], None,
                                         np.zeros(0)))
                continue
            stack = tree_cat(e["params"])
            weights = np.asarray(e["weights"], np.float64)
            s = np.asarray(e["staleness"], np.float64)
            imp = None if not s.any() else (1.0 + s) ** (-a)
            groups.append(GroupRound(engine.nets[p], globals_[p], stack,
                                     weights, importance=imp))
        return groups

    @staticmethod
    def _stamp(round_logs, tele) -> None:
        """Population and fault telemetry onto the round's logs."""
        for log in round_logs:
            log.staleness_hist = list(tele["staleness_hist"])
            log.buffer_fill = int(tele["buffer_fill"])
            log.n_straggling = int(tele["n_straggling"])
            log.n_dropped_uploads = int(tele["n_dropped_uploads"])
            log.n_stale_dropped = int(tele["n_stale_dropped"])
            log.eff_participants = float(tele["eff_participants"])
            log.n_corrupted = int(tele.get("n_corrupted", 0))
            log.n_quarantined = int(tele.get("n_quarantined", 0))
            log.n_retries = int(tele.get("n_retries", 0))


def _plain(rng_state):
    """Bit-generator state with checkpoint-roundtripped numpy scalars
    coerced back to builtin ints (numpy requires exact types here)."""
    if isinstance(rng_state, dict):
        return {k: _plain(v) for k, v in rng_state.items()}
    if isinstance(rng_state, np.ndarray):
        return rng_state
    if isinstance(rng_state, np.integer):
        return int(rng_state)
    return rng_state
