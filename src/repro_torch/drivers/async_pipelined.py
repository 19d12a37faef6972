"""Async-pipelined round driver: round t's server-side fusion overlaps
round t+1's client training.

FedDF's round cost is dominated by two phases with no data dependency
once the teacher snapshot is taken: the batched client training of the
NEXT round and the ensemble-distillation fusion of the CURRENT one.  This
driver runs fusion (``engine.aggregate``) on a worker thread while the
driver thread trains the next round's clients; host batch building runs
``prefetch`` rounds ahead on a second worker.

On the card the fusion runs on a CUDA stream of its own, created once per
run, so that its kernels (K1 on the logit bank, K2 on the fly) and the
client training's can run side by side:

- the fusion stream waits on an event recorded on the driver thread's
  stream after ``train_clients``, so it reads the finished uploads;
- the driver thread's stream waits on an event recorded at the fusion's
  end before the join returns, so the next training and the evaluation
  read the finished globals;
- every tensor that one stream allocated and the other reads is marked
  with ``Tensor.record_stream``, so that the caching allocator does not
  hand its memory out again while the other stream may still read it;
- the worker sets its own grad mode and current stream (both are
  thread-local in PyTorch).

On the CPU the same code runs without streams.

Staleness semantics (``staleness`` S >= 0):

  S=0  sync semantics, bit for bit: round t+1's training waits for round
       t's fused globals; only host batch building is prefetched.
  S    up to S rounds of client training run concurrently with the
       oldest round's fusion: round t's clients start from the newest
       fusion that has completed, at most S rounds staler than sync.
       Each round's aggregation still consumes every upload.

Checkpoint/resume: ``round_end_hook`` fires in round order.  Under S >= 1
the hook's state is wrapped (``drivers.base.wrap_state``) with the
training bases of every round still in flight, so a resumed run retrains
the interrupted rounds from the bases an uninterrupted pipeline used.
In-flight work past the last completed hook is discarded and recomputed
on resume.  As in the JAX package, this driver runs neither the fault
pipeline nor the divergence guard.

``phase_seconds`` records per round ``join_batches`` (the wait for the
prefetched batches), ``train_clients``, ``join_fusion`` (the driver
thread's wait for the fusion), ``evaluate_round``, and ``aggregate``,
timed on the worker against the fusion stream.  The wall of a round is
not their sum: ``aggregate`` overlaps the next round's training.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Deque, Dict, Tuple

import torch

from repro_torch.core.engine import RoundEngine
from repro_torch.core.strategies import GroupRound
from repro_torch.drivers.base import (_UNSET, Driver, register_driver,
                                      wrap_state)
from repro_torch.obs.trace import span


def _record_stream(obj, stream) -> None:
    """``record_stream(stream)`` on every CUDA tensor in ``obj`` (through
    dicts, lists, tuples and GroupRounds' params)."""
    if isinstance(obj, GroupRound):
        _record_stream([obj.stack, obj.prev_global], stream)
    elif isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, dict):
        for v in obj.values():
            _record_stream(v, stream)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _record_stream(v, stream)


@register_driver("async_pipelined")
class AsyncPipelinedDriver(Driver):
    def run(self, engine: RoundEngine, *, log_fn=None, init_globals=None,
            init_state=_UNSET, start_round=1, init_logs=None,
            round_end_hook=None):
        globals_, state, logs, rng = self._setup(
            engine, init_globals, init_state, init_logs, start_round)
        # bases the interrupted in-flight rounds trained from, oldest
        # first; rounds start_round, start_round+1, ... consume them in
        # order, then fall back to the newest completed fusion
        pending_bases: Deque = deque()
        if self.staleness > 0:
            if self._resume_base_ring:
                pending_bases.extend(self._resume_base_ring)
            elif self._resume_prev_base is not None:
                pending_bases.append(self._resume_prev_base)
        rounds = engine.cfg.rounds
        rounds_to_target = None
        stopped = False
        grad_mode = torch.is_grad_enabled()
        cuda = engine.device.type == "cuda"
        fusion_stream = torch.cuda.Stream(engine.device) if cuda else None
        phases: Dict[int, Dict[str, float]] = {}

        # fusion gets a dedicated worker: sharing one with the batch
        # prefetcher could queue an aggregate behind host batch building
        agg_ex = ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="fusion")
        batch_ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="batches")
        batch_futs: Dict[int, object] = {}
        next_draw = start_round

        def prefetch_to(limit: int) -> None:
            # cohort draws stay on the driver thread in round order (the
            # rng sequence is the resume contract); only the pure host
            # batch building goes to the worker
            nonlocal next_draw
            while next_draw <= min(limit, rounds):
                t_, next_draw = next_draw, next_draw + 1
                active = engine.sample_cohort(rng)
                batch_futs[t_] = batch_ex.submit(engine.build_round_batches,
                                                 t_, active)

        def aggregate_task(t, groups, st, ready):
            """Round t's fusion on the worker; returns the groups, the
            aggregate's outputs, its seconds and the end-of-fusion event
            (None on the CPU)."""
            stream_ctx = (torch.cuda.stream(fusion_stream) if cuda
                          else contextlib.nullcontext())
            with torch.set_grad_enabled(grad_mode), stream_ctx:
                if cuda:
                    fusion_stream.wait_event(ready)
                    _record_stream([groups, st], fusion_stream)
                t0 = time.perf_counter()
                out = engine.aggregate(t, groups, st)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record(fusion_stream)
                    fusion_stream.synchronize()
                seconds = time.perf_counter() - t0
            return (groups,) + out + (seconds, done)

        # submitted-but-unjoined rounds, oldest first: (future, round,
        # training base).  len(ring) never exceeds max(staleness, 1).
        ring: Deque[Tuple[object, int, object]] = deque()
        try:
            for t in range(start_round, rounds + 1):
                ph = phases[t] = {}
                prefetch_to(t + self.prefetch)
                with span("join_batches", round=t):
                    batches = self._timed(engine, ph, "join_batches",
                                          batch_futs.pop(t).result)

                if self.staleness == 0 and ring:
                    # sync semantics: fused globals gate the next training
                    fut, r, _ = ring.popleft()
                    globals_, state, rounds_to_target, stop = self._finish(
                        engine, fut, r, phases, logs, log_fn,
                        round_end_hook, ring_bases=None)
                    if rounds_to_target is not None or stop:
                        stopped = True
                        break

                base = pending_bases.popleft() if pending_bases else globals_
                groups = self._timed(engine, ph, "train_clients",
                                     engine.train_clients, t, base, batches)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(engine.device))

                if self.staleness > 0 and len(ring) == self.staleness:
                    # ring full: join the oldest fusion after dispatching
                    # round t's training; its checkpoint carries the bases
                    # of every round still in flight (t's included)
                    fut, r, _ = ring.popleft()
                    bases = [b for _, _, b in ring] + [base]
                    globals_, state, rounds_to_target, stop = self._finish(
                        engine, fut, r, phases, logs, log_fn,
                        round_end_hook, ring_bases=bases)
                    if rounds_to_target is not None or stop:
                        stopped = True  # in-flight trained rounds dropped
                        break

                ring.append((agg_ex.submit(aggregate_task, t, groups, state,
                                           ready), t, base))

            while ring and not stopped:
                fut, r, _ = ring.popleft()
                bases = [b for _, _, b in ring] or None
                globals_, state, rounds_to_target, stop = self._finish(
                    engine, fut, r, phases, logs, log_fn, round_end_hook,
                    ring_bases=bases)
                if rounds_to_target is not None or stop:
                    break  # later in-flight rounds dropped, as in sync
        finally:
            batch_ex.shutdown(wait=True, cancel_futures=True)
            agg_ex.shutdown(wait=True, cancel_futures=True)

        return self._results(engine, logs, globals_, rounds_to_target)

    def _finish(self, engine, agg_fut, t, phases, logs, log_fn,
                round_end_hook, ring_bases):
        """Join round t's fusion, then evaluate, log and checkpoint it.
        ``ring_bases`` are the training bases of the rounds still in
        flight (oldest first), wrapped into the checkpoint state so that a
        resumed pipeline retrains them from the same bases."""
        ph = phases.pop(t)
        # the driver thread blocked on the fusion worker: the overlap the
        # pipeline exists to create is 1 - this / the round's wall
        with span("join_fusion", round=t):
            groups, globals_, state, infos, agg_s, done = self._timed(
                engine, ph, "join_fusion", agg_fut.result)
        ph["aggregate"] = agg_s
        if done is not None:
            main = torch.cuda.current_stream(engine.device)
            main.wait_event(done)
            _record_stream([globals_, state], main)
        round_logs = self._timed(engine, ph, "evaluate_round",
                                 engine.evaluate_round, t, globals_, groups,
                                 infos)
        self.phase_seconds.append(ph)
        reached, stop_requested = self._emit_round(engine, round_logs, logs,
                                                   log_fn)
        rounds_to_target = t if reached else None
        if round_end_hook is not None:
            hook_state = state
            if self.staleness > 0:
                bases = ring_bases if ring_bases else [globals_]
                hook_state = wrap_state(
                    state, bases[0],
                    base_ring=bases if len(bases) > 1 else None)
            round_end_hook(t, globals_, hook_state, logs, rounds_to_target)
        return globals_, state, rounds_to_target, stop_requested
