"""`Experiment`: the run / resume entry point over the round engine.

    spec = ExperimentSpec(...)                   # the same JSON as the JAX
    result = Experiment(spec).run()              # package's; on the card
    result = Experiment.resume(directory)        # continue a checkpointed run

``device`` defaults to ``"cuda"``; without a CUDA device the constructor
(and ``resume``) raises unless the caller asked for ``"cpu"``.  Nothing
carries on on the CPU by itself.

Observation is typed: observers receive a :class:`RoundEvent` per
prototype group and round, and may request a stop after the round.

Resume: ``run(checkpoint_dir=...)`` writes the spec and per-round
snapshots (globals per prototype, server-strategy state, round logs)
through ``checkpoint/io.py`` in the JAX package's layout, so each package
reads the other's round snapshots; ``Experiment.resume(dir)`` rebuilds
everything from the spec, reloads the newest complete snapshot and
continues.  The sync driver replays the cohort draws of the completed
rounds and the buffered one restores its population snapshot, so the
resumed trajectory is the uninterrupted one.

Flight recorder (``spec.obs``, docs/observability.md): an enabled
``ObsSpec`` arms ``repro_torch.obs.trace`` for the run (spans in memory,
streamed to ``trace_path``; a ``torch.profiler`` trace into
``profile_dir`` with ``profile``) and streams per-round metric records to
``metrics_dir/metrics.jsonl`` and ``.csv``; the recorder's summary lands
in ``RunResult.obs`` and ``summary()["obs"]``.  A recorder armed by the
caller is read the same way.  An armed run computes what a disarmed one
does, bit for bit.

Meshes (``spec.sharding.shard_clients``, or the ``multihost`` driver):
every rank of a ``torch.distributed`` world runs the same experiment,
the engine's client axis sharded over ``launch/mesh.make_client_mesh()``;
rank 0 alone writes the checkpoints, the metrics files and the trace,
and every rank can resume from them.

:func:`build_engine` compiles a spec to its :class:`RoundEngine`; a tcp
client pod (``python -m repro_torch.dist.pods``) rebuilds the fusion pod's
engine with it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.registries import (TaskBundle, get_model,
                                        get_quantizer, get_source, get_task)
from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint import io as ckpt
from repro_torch.common.pytree import tree_to
from repro_torch.core.engine import (BucketConfig, FLConfig, FLResult,
                                     RoundEngine, RoundLog)
from repro_torch.core.feddf import FusionConfig
from repro_torch.core.nets import Net
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import Dataset, train_val_test_split
from repro_torch.dist.config import DistConfig
from repro_torch.drivers import make_driver
from repro_torch.drivers.base import _UNSET
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import CSVSink, JSONLSink, MetricsObserver
from repro_torch.population.config import FaultConfig


@dataclasses.dataclass
class RoundEvent:
    """One prototype group's per-round observation (group 0 in a
    homogeneous run).  An observer may call :meth:`request_stop` to end
    the run after the current round; such a stop does not set
    ``rounds_to_target``, and a checkpointed run resumes past it.  An
    observer that raises interrupts the run."""

    round: int
    group: int
    n_groups: int
    heterogeneous: bool
    log: RoundLog
    stop_requested: bool = dataclasses.field(default=False, compare=False)

    def request_stop(self) -> None:
        self.stop_requested = True


Observer = Callable[[RoundEvent], None]


@dataclasses.dataclass
class RunResult:
    """One :class:`FLResult` per prototype group, plus where it ran, each
    round's wall seconds per engine phase (rounds this call ran), and the
    flight recorder's summary when the run was traced."""

    spec: ExperimentSpec
    results: List[FLResult]
    global_params: List[dict]
    rounds_to_target: Optional[int]
    net_names: List[str]
    device: str = "cuda"
    phase_seconds: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)
    obs: Optional[dict] = None

    @property
    def heterogeneous(self) -> bool:
        return len(self.results) > 1

    @property
    def result(self) -> FLResult:
        if self.heterogeneous:
            raise ValueError("heterogeneous run: use .results[group]")
        return self.results[0]

    @property
    def final_acc(self) -> float:
        return max(r.final_acc for r in self.results)

    @property
    def best_acc(self) -> float:
        return max(r.best_acc for r in self.results)

    @staticmethod
    def _bank_summary(logs) -> dict:
        """The last round's bank decision, storage dtype and bytes."""
        last = logs[-1] if logs else None
        return {"decision": getattr(last, "bank", ""),
                "dtype": getattr(last, "bank_dtype", ""),
                "nbytes": getattr(last, "bank_nbytes", 0)}

    @staticmethod
    def _population_summary(logs) -> Optional[dict]:
        """Buffered-async population telemetry, or None for runs that
        never set it (the sync driver)."""
        plogs = [l for l in logs if l.staleness_hist is not None]
        if not plogs:
            return None
        hist = [0] * max(len(l.staleness_hist) for l in plogs)
        for l in plogs:
            for s, c in enumerate(l.staleness_hist):
                hist[s] += int(c)
        total = sum(hist)
        mean_s = (sum(s * c for s, c in enumerate(hist)) / total
                  if total else 0.0)
        return {
            "uploads_fused": total,
            "mean_staleness": mean_s,
            "staleness_hist": hist,
            "last_buffer_fill": int(plogs[-1].buffer_fill),
            "last_straggling": int(plogs[-1].n_straggling),
            "dropped_uploads": sum(int(l.n_dropped_uploads)
                                   for l in plogs),
            "stale_dropped": sum(int(l.n_stale_dropped) for l in plogs),
            "mean_eff_participants": float(
                np.mean([l.eff_participants for l in plogs])),
        }

    @staticmethod
    def _fault_summary(logs) -> Optional[dict]:
        """Fault and defense telemetry (docs/robustness.md), or None for
        runs where the fault seam never fired."""
        corrupted = sum(int(l.n_corrupted) for l in logs)
        quarantined = sum(int(l.n_quarantined) for l in logs)
        retries = sum(int(l.n_retries) for l in logs)
        filtered = sum(int(l.n_teachers_filtered) for l in logs)
        skipped = sum(1 for l in logs if not l.fused)
        rollbacks = sum(1 for l in logs if l.rolled_back)
        if not (corrupted or quarantined or retries or filtered
                or skipped or rollbacks):
            return None
        return {"corrupted_uploads": corrupted,
                "quarantined_uploads": quarantined,
                "retries": retries,
                "teachers_filtered": filtered,
                "rounds_skipped": skipped,
                "rollbacks": rollbacks}

    @staticmethod
    def _dist_summary(logs) -> Optional[dict]:
        """Wire telemetry (docs/distributed.md), or None for runs that
        never touched the wire (every other driver)."""
        bytes_up = sum(int(l.wire_bytes_up) for l in logs)
        bytes_down = sum(int(l.wire_bytes_down) for l in logs)
        if not (bytes_up or bytes_down):
            return None
        return {"bytes_up": bytes_up, "bytes_down": bytes_down,
                "wire_retries": sum(int(l.n_wire_retries) for l in logs),
                "crc_failures": sum(int(l.n_crc_failures) for l in logs),
                "deadline_misses": sum(int(l.n_deadline_misses)
                                       for l in logs),
                "wire_lost": sum(int(l.n_wire_lost) for l in logs),
                "min_pods_alive": min(int(l.n_pods_alive) for l in logs)}

    def summary(self) -> dict:
        """The JAX package's summary shapes: a buffered-async run adds a
        ``population`` section, a run where a fault fired a ``faults``
        section, a distributed run a ``dist`` section and a traced run an
        ``obs`` section."""
        if not self.heterogeneous:
            r = self.results[0]
            out = {"final": r.final_acc, "best": r.best_acc,
                   "rounds_to_target": self.rounds_to_target,
                   "per_round": [l.test_acc for l in r.logs],
                   "bank": self._bank_summary(r.logs)}
            pop = self._population_summary(r.logs)
            faults = self._fault_summary(r.logs)
        else:
            out = {f"proto_{g}": {"final": r.final_acc, "best": r.best_acc,
                                  "per_round": [l.test_acc for l in r.logs],
                                  "bank": self._bank_summary(r.logs)}
                   for g, r in enumerate(self.results)}
            pop = self._population_summary(self.results[0].logs)
            faults = self._fault_summary(
                [l for r in self.results for l in r.logs])
        # wire telemetry is per round (every group's log of a round
        # carries the same counters), so one group's logs hold it
        dist = self._dist_summary(self.results[0].logs)
        if pop is not None:
            out["population"] = pop
        if faults is not None:
            out["faults"] = faults
        if dist is not None:
            out["dist"] = dist
        if self.obs is not None:
            out["obs"] = self.obs
        return out


def resolve_device(device) -> torch.device:
    """``"cuda"`` (the default everywhere) needs a CUDA device and raises
    without one; ``"cpu"`` must be asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the card unless the caller passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def build_task_bundle(spec: ExperimentSpec) -> TaskBundle:
    seed = spec.task.seed if spec.task.seed is not None else spec.seed
    return get_task(spec.task.name)(
        n_samples=spec.task.n_samples, seed=seed, **spec.task.params)


def build_splits(spec: ExperimentSpec, bundle: TaskBundle
                 ) -> Tuple[Dataset, Dataset, Dataset, List[np.ndarray]]:
    train, val, test = train_val_test_split(bundle.dataset, seed=spec.seed)
    pseed = (spec.partition.seed if spec.partition.seed is not None
             else spec.seed)
    parts = dirichlet_partition(
        train.y, spec.partition.n_clients, spec.partition.alpha, seed=pseed,
        min_per_client=spec.partition.min_per_client)
    return train, val, test, parts


def build_cohort(spec: ExperimentSpec, bundle: TaskBundle
                 ) -> Tuple[List[Net], List[int]]:
    nets = [get_model(m.name)(bundle, **m.params)
            for m in spec.cohort.prototypes]
    return nets, spec.cohort.client_prototypes(spec.partition.n_clients)


def build_source(spec: ExperimentSpec, bundle: TaskBundle, train: Dataset,
                 device):
    if spec.source is None:
        return None
    return get_source(spec.source.name)(bundle, train, seed=spec.seed,
                                        device=device, **spec.source.params)


def to_fl_config(spec: ExperimentSpec) -> FLConfig:
    """Compile the declarative spec into the engine-level config."""
    s = spec.strategy
    quantize = (None if spec.privacy.quantizer is None
                else get_quantizer(spec.privacy.quantizer))
    faults = FaultConfig(**spec.faults.to_dict())
    # the distill divergence guard rides the fault axis: a per-chunk
    # finiteness check and rollback only when faults can fire, so
    # fault-free fusions keep the guard-free path
    fusion = FusionConfig(**s.fusion.to_dict(),
                          divergence_guard=faults.enabled)
    # tcp client pods rebuild their engine from the serialized spec, so
    # the fusion pod carries it into the config it hands the driver
    dist = DistConfig(
        transport=spec.dist.transport, wire_codec=spec.dist.wire_codec,
        n_pods=spec.dist.n_pods, heartbeat_s=spec.dist.heartbeat_s,
        upload_deadline_s=spec.dist.upload_deadline_s,
        verify_crc=spec.dist.verify_crc, wire_log=spec.dist.wire_log,
        spec_json=(spec.to_json() if spec.dist.transport == "tcp"
                   else None))
    return FLConfig(
        rounds=spec.rounds, client_fraction=spec.client_fraction,
        local_epochs=spec.local_epochs,
        local_batch_size=spec.local_batch_size, local_lr=spec.local_lr,
        strategy=s.name, prox_mu=s.prox_mu,
        server_momentum=s.server_momentum, drop_worst=s.drop_worst,
        trim_frac=s.trim_frac, faults=faults, dist=dist,
        seed=spec.seed, local_optimizer=spec.local_optimizer,
        local_adam_lr=spec.local_adam_lr, quantize=quantize,
        fusion=fusion,
        feddf_init_from=s.feddf_init_from,
        target_accuracy=spec.target_accuracy,
        dp_clip=spec.privacy.clip,
        dp_noise_multiplier=spec.privacy.noise_multiplier,
        bucketing=BucketConfig(kind=spec.bucket.kind,
                               max_buckets=spec.bucket.max_buckets),
        population=spec.population_config())


def build_mesh(spec: ExperimentSpec):
    """The client mesh over every rank of the world when the spec shards
    the client axis, else None (``launch/mesh.make_client_mesh``)."""
    if not spec.sharding.shard_clients:
        return None
    from repro_torch.launch.mesh import make_client_mesh
    return make_client_mesh()


def build_engine(spec: ExperimentSpec, device="cuda", *, index_stream=None,
                 draw_stream=None, dp_draws=None, swag_draws=None,
                 filter_probe=None) -> RoundEngine:
    """Compile a spec all the way to a :class:`RoundEngine` on ``device``
    (``"cuda"`` raises without a card).  The spec is the single source of
    truth: a tcp client pod that rebuilds the engine from it derives the
    fusion pod's data splits, prototypes and client updates.  The
    keyword streams replace the run's own draws (:meth:`Experiment.
    run`)."""
    device = resolve_device(device)
    spec = spec.validate()
    bundle = build_task_bundle(spec)
    train, val, test, parts = build_splits(spec, bundle)
    nets, client_proto = build_cohort(spec, bundle)
    source = build_source(spec, bundle, train, device)
    if source is None and (index_stream is not None
                           or draw_stream is not None):
        raise ValueError("index_stream / draw_stream given, but the spec "
                         "has no distillation source")
    if index_stream is not None:
        source.indices = index_stream
    if draw_stream is not None:
        source.draws = draw_stream
    return RoundEngine(nets, client_proto, train, parts, val, test,
                       to_fl_config(spec), source=source,
                       heterogeneous=len(nets) > 1, device=device,
                       dp_draws=dp_draws, swag_draws=swag_draws,
                       filter_probe=filter_probe, mesh=build_mesh(spec),
                       client_axis=spec.sharding.client_axis)


# ---------------------------------------------------------------------------
# checkpoint round trip (the JAX package's directory layout)
# ---------------------------------------------------------------------------

def _jsonable(o):
    if isinstance(o, np.bool_):
        return bool(o)
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, (np.floating, torch.Tensor)):
        return float(o)
    return str(o)


def _round_dir(checkpoint_dir: str, t: int) -> str:
    return os.path.join(checkpoint_dir, "rounds", f"{t:05d}")


_KEEP_ROUND_DIRS = 2  # latest + one fallback against partial writes


def _save_round(checkpoint_dir: str, t: int, globals_: List[dict], state,
                logs: List[List[RoundLog]],
                rounds_to_target: Optional[int]) -> None:
    with _trace.span("checkpoint_write", round=int(t)):
        rd = _round_dir(checkpoint_dir, t)
        os.makedirs(rd, exist_ok=True)
        for g, params in enumerate(globals_):
            ckpt.save(os.path.join(rd, f"global_{g}"), params)
        ckpt.save_obj(os.path.join(rd, "state"), state)
        # logs.json is written LAST and atomically: its presence marks the
        # snapshot complete, so a crash mid-checkpoint leaves a directory the
        # loader recognises as partial and skips
        tmp = os.path.join(rd, "logs.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"round": t, "rounds_to_target": rounds_to_target,
                       "logs": [[dataclasses.asdict(l) for l in group]
                                for group in logs]},
                      f, default=_jsonable)
        os.replace(tmp, os.path.join(rd, "logs.json"))
        # resume reads only the newest snapshot (it holds the whole log
        # history), so superseded round directories are pruned
        rounds_dir = os.path.join(checkpoint_dir, "rounds")
        stale = sorted(e for e in os.listdir(rounds_dir)
                       if e.isdigit())[:-_KEEP_ROUND_DIRS]
        for e in stale:
            shutil.rmtree(os.path.join(rounds_dir, e), ignore_errors=True)


def _load_latest_round(checkpoint_dir: str, nets: List[Net], device
                       ) -> Tuple[int, List[dict], object,
                                  List[List[RoundLog]], Optional[int]]:
    """The newest complete snapshot: ``(round, globals on device, state
    with numpy arrays, logs, rounds_to_target)``.  A directory without a
    parseable ``logs.json`` is a partial write and is skipped."""
    rounds_dir = os.path.join(checkpoint_dir, "rounds")
    entries = (sorted(e for e in os.listdir(rounds_dir) if e.isdigit())
               if os.path.isdir(rounds_dir) else [])
    payload = None
    for entry in reversed(entries):
        rd = os.path.join(rounds_dir, entry)
        try:
            with open(os.path.join(rd, "logs.json")) as f:
                payload = json.load(f)
            break
        except (FileNotFoundError, json.JSONDecodeError):
            continue
    if payload is None:
        raise FileNotFoundError(
            f"no complete round checkpoint under {rounds_dir!r}; was "
            f"the run started with checkpoint_dir set?")
    t = int(payload["round"])
    logs = [[RoundLog(**d) for d in group] for group in payload["logs"]]
    globals_ = [
        ckpt.restore(os.path.join(rd, f"global_{g}"), like=tree_to(
            net.init(torch.Generator().manual_seed(0)), device))
        for g, net in enumerate(nets)]
    state = ckpt.load_obj(os.path.join(rd, "state"))
    return t, globals_, state, logs, payload.get("rounds_to_target")


class Experiment:
    """A validated, runnable experiment on ``device``.

    ``run(checkpoint_dir=...)`` persists the spec and per-round state;
    ``Experiment.resume(dir)`` continues an interrupted run to
    ``spec.rounds`` with the uninterrupted run's trajectory."""

    def __init__(self, spec: ExperimentSpec, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec.validate()

    def run(self, *, observers: Sequence[Observer] = (),
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
            init_globals: Optional[List[dict]] = None,
            index_stream=None, draw_stream=None, dp_noise_stream=None,
            swag_draw_stream=None, filter_probe=None) -> RunResult:
        """Run every round; a cohort of several prototypes runs the
        paper's Algorithm 3, with one result, one global tree and one net
        name per prototype group.  ``observers`` get a :class:`RoundEvent`
        per group and round; with ``checkpoint_dir`` every
        ``checkpoint_every``-th round (and the last, and a target stop)
        is snapshotted there.  ``init_globals`` (one tree per group, on
        any device), ``index_stream`` (a pool source's distillation
        indices, shared by every group's fusion; see
        ``data/distill_sources.UnlabeledDataset``), ``draw_stream`` (a
        generator or noise source's random draws), ``dp_noise_stream``
        (the DP noise, ``core/privacy.NormalDraws``),
        ``swag_draw_stream`` (the SWAG samples' draws,
        ``core/swag.SwagDraws``) and ``filter_probe`` (the teacher
        filter's probe batches, ``core/strategies.FilterProbe``) replace
        the run's own initialisation and draws, e.g. with the JAX
        package's.  A stream the spec has no use for is refused."""
        spec = self.spec
        if dp_noise_stream is not None and spec.privacy.clip is None:
            raise ValueError("dp_noise_stream given, but the spec has no "
                             "DP uploads (privacy.clip is None)")
        if swag_draw_stream is not None \
                and spec.strategy.fusion.swag_samples <= 0:
            raise ValueError("swag_draw_stream given, but the spec draws no "
                             "SWAG teachers (fusion.swag_samples is 0)")
        if filter_probe is not None and not (
                spec.strategy.name == "feddf"
                and to_fl_config(spec).faults.teacher_filter_active):
            raise ValueError("filter_probe given, but the spec runs no "
                             "FedDF teacher filter")
        return self._run(observers, checkpoint_dir, checkpoint_every,
                         resume=False, init_globals=init_globals,
                         index_stream=index_stream, draw_stream=draw_stream,
                         dp_noise_stream=dp_noise_stream,
                         swag_draw_stream=swag_draw_stream,
                         filter_probe=filter_probe)

    @classmethod
    def resume(cls, directory: str, *, device="cuda",
               observers: Sequence[Observer] = (),
               checkpoint_every: int = 1) -> RunResult:
        """Continue a checkpointed run from ``directory`` (the
        ``spec.json`` and ``rounds/`` a checkpointed :meth:`run` wrote, by
        either package) on ``device``.  A run whose snapshot records a
        stop at ``target_accuracy`` is returned as it stands."""
        spec = ExperimentSpec.load(os.path.join(directory, "spec.json"))
        return cls(spec, device=device)._run(observers, directory,
                                             checkpoint_every, resume=True)

    def _run(self, observers, checkpoint_dir, checkpoint_every, *,
             resume: bool, init_globals=None, index_stream=None,
             draw_stream=None, dp_noise_stream=None, swag_draw_stream=None,
             filter_probe=None) -> RunResult:
        spec = self.spec
        engine = build_engine(spec, self.device, index_stream=index_stream,
                              draw_stream=draw_stream,
                              dp_draws=dp_noise_stream,
                              swag_draws=swag_draw_stream,
                              filter_probe=filter_probe)
        nets, cfg = engine.nets, engine.cfg
        heterogeneous = engine.heterogeneous
        if init_globals is not None:
            init_globals = [tree_to(g, self.device) for g in init_globals]

        init_state, init_logs, start_round = _UNSET, None, 1
        if resume:
            (last, init_globals, init_state, init_logs,
             stored_rtt) = _load_latest_round(checkpoint_dir, nets,
                                              self.device)
            start_round = last + 1
            if stored_rtt is not None:
                # the checkpointed run already stopped on
                # target_accuracy: do not retrain past the stop
                return RunResult(
                    spec=spec,
                    results=[FLResult(logs=init_logs[g],
                                      global_params=init_globals[g])
                             for g in range(len(nets))],
                    global_params=init_globals, rounds_to_target=stored_rtt,
                    net_names=[n.name for n in nets],
                    device=str(self.device))

        def log_fn(entry):
            g, log = entry if heterogeneous else (0, entry)
            event = RoundEvent(round=log.round, group=g, n_groups=len(nets),
                               heterogeneous=heterogeneous, log=log)
            for observer in observers:
                observer(event)
            return event.stop_requested  # True -> the driver stops

        # over a mesh every rank runs the same rounds; rank 0 alone writes
        # the checkpoints and the metrics files
        from repro_torch.launch.mesh import world_rank
        writer = world_rank() == 0
        round_end_hook = None
        if checkpoint_dir is not None and checkpoint_every > 0 and writer:
            os.makedirs(checkpoint_dir, exist_ok=True)
            spec.save(os.path.join(checkpoint_dir, "spec.json"))

            def round_end_hook(t, globals_, state, logs, rounds_to_target):
                if (t % checkpoint_every == 0 or t == cfg.rounds
                        or rounds_to_target is not None):
                    _save_round(checkpoint_dir, t, globals_, state, logs,
                                rounds_to_target)

        driver = make_driver(spec.driver.kind,
                             staleness=spec.driver.staleness,
                             prefetch=spec.driver.prefetch)
        # the flight recorder: armed per spec.obs, or a recorder the
        # caller armed is read; a disarmed run takes none of these paths
        armed_here = spec.obs.enabled
        metrics_obs = None
        if armed_here:
            _trace.arm(path=spec.obs.trace_path if writer else None,
                       profile_dir=(spec.obs.profile_dir
                                    if spec.obs.profile and writer
                                    else None))
            if spec.obs.metrics_dir and writer:
                metrics_obs = MetricsObserver([
                    JSONLSink(os.path.join(spec.obs.metrics_dir,
                                           "metrics.jsonl")),
                    CSVSink(os.path.join(spec.obs.metrics_dir,
                                         "metrics.csv"))])
                observers = list(observers) + [metrics_obs]
        try:
            results, globals_, rounds_to_target = driver.run(
                engine, log_fn=log_fn, init_globals=init_globals,
                init_state=init_state, start_round=start_round,
                init_logs=init_logs, round_end_hook=round_end_hook)
            rec = _trace.recorder()
            obs_summary = rec.summary() if rec is not None else None
        finally:
            if metrics_obs is not None:
                metrics_obs.close()
            if armed_here:
                _trace.disarm()
        return RunResult(spec=spec, results=results, global_params=globals_,
                         rounds_to_target=rounds_to_target,
                         net_names=[n.name for n in nets],
                         device=str(self.device),
                         phase_seconds=list(driver.phase_seconds),
                         obs=obs_summary)
