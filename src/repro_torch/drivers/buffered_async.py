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
``evaluate_round``.  Quorum semantics, checkpoints and resume wait for
fault injection and checkpointing (ROADMAP.md queue 1 items 10 and 8).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_cat
from repro_torch.core.engine import RoundEngine
from repro_torch.core.strategies import GroupRound
from repro_torch.drivers.base import Driver, register_driver


@register_driver("buffered_async")
class BufferedAsyncDriver(Driver):
    def __init__(self, staleness: int = 0, prefetch: int = 1):
        if staleness not in (0, 1):
            raise ValueError(
                f"buffered_async bounds the training-overlap staleness "
                f"knob to 0 or 1 (got {staleness}); upload staleness is "
                f"governed by PopulationSpec.max_staleness instead")
        super().__init__(staleness=staleness, prefetch=prefetch)

    def run(self, engine: RoundEngine, *, init_globals=None):
        globals_, state, logs, rng = self._setup(engine, init_globals)
        pop = engine.population()
        m = pop.buffer_size
        a = float(engine.cfg.population.staleness_exponent)
        rounds_to_target = None
        fused = 0                    # completed fusions (= base version)
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

        def fill(t: int) -> None:
            """Dispatch waves until M usable uploads are buffered."""
            max_waves = 64 + 16 * (-(-m // max(1, pop.n_active)))
            waves = 0
            while pop.usable_pending(t) < m:
                if waves >= max_waves:
                    raise RuntimeError(
                        f"round {t}: {waves} waves did not buffer "
                        f"{m} usable uploads; lower traffic.dropout / "
                        f"buffer_size or raise max_staleness")
                waves += 1
                w, cohort = pop.next_wave(rng)
                parts = pop.registry.partition[np.asarray(cohort)]
                batches = engine.build_round_batches(w, parts)
                groups = engine.train_clients(w, globals_, batches)
                pop.push_wave(w, cohort, groups, base_version=fused)

        def finish():
            nonlocal globals_, state, fused, rounds_to_target
            ph = phases[agg_round]
            groups, globals_, state, infos = self._timed(
                engine, ph, "join_fusion", agg_fut.result)
            globals_, _ = engine.guard_globals(
                globals_, [g.prev_global for g in groups])
            round_logs = self._timed(engine, ph, "evaluate_round",
                                     engine.evaluate_round, agg_round,
                                     globals_, groups, infos)
            self._stamp(round_logs, agg_tele)
            for p, log in enumerate(round_logs):
                logs[p].append(log)
            self.phase_seconds.append(ph)
            fused = agg_round
            if engine.target_reached(round_logs):
                rounds_to_target = agg_round
            return rounds_to_target is not None

        try:
            stopped = False
            for t in range(1, engine.cfg.rounds + 1):
                phases[t] = {}
                if self.staleness == 0 and agg_fut is not None:
                    stopped = finish()  # sync-gated: fuse before new waves
                    agg_fut = None
                    if stopped:
                        break
                self._timed(engine, phases[t], "fill", fill, t)
                if agg_fut is not None:  # staleness=1: overlap fill/fuse
                    stopped = finish()
                    agg_fut = None
                    if stopped:
                        break
                uploads, tele = pop.pop(t, m)
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
        """Population telemetry onto the round's logs."""
        for log in round_logs:
            log.staleness_hist = list(tele["staleness_hist"])
            log.buffer_fill = int(tele["buffer_fill"])
            log.n_straggling = int(tele["n_straggling"])
            log.n_dropped_uploads = int(tele["n_dropped_uploads"])
            log.n_stale_dropped = int(tele["n_stale_dropped"])
            log.eff_participants = float(tele["eff_participants"])
