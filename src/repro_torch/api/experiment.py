"""`Experiment` — the run entry point over the round engine.

    spec = ExperimentSpec(...)                   # the same JSON as the JAX
    result = Experiment(spec).run()              # package's; on the card

``device`` defaults to ``"cuda"``; without a CUDA device the constructor
raises unless the caller asked for ``"cpu"``.  Nothing carries on on the
CPU by itself.  Checkpointing and resume wait for ROADMAP.md queue 1
item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.registries import (TaskBundle, get_model,
                                        get_quantizer, get_source, get_task)
from repro_torch.api.spec import ExperimentSpec
from repro_torch.common.pytree import tree_to
from repro_torch.core.engine import (BucketConfig, FLConfig, FLResult,
                                     RoundEngine)
from repro_torch.core.feddf import FusionConfig
from repro_torch.core.nets import Net
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import Dataset, train_val_test_split
from repro_torch.drivers import make_driver


@dataclasses.dataclass
class RunResult:
    """One :class:`FLResult` per prototype group, plus where it ran and
    each round's wall seconds per engine phase."""

    spec: ExperimentSpec
    results: List[FLResult]
    global_params: List[dict]
    rounds_to_target: Optional[int]
    net_names: List[str]
    device: str = "cuda"
    phase_seconds: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)

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
    return FLConfig(
        rounds=spec.rounds, client_fraction=spec.client_fraction,
        local_epochs=spec.local_epochs,
        local_batch_size=spec.local_batch_size, local_lr=spec.local_lr,
        strategy=s.name, prox_mu=s.prox_mu,
        server_momentum=s.server_momentum, drop_worst=s.drop_worst,
        seed=spec.seed, local_optimizer=spec.local_optimizer,
        local_adam_lr=spec.local_adam_lr, quantize=quantize,
        fusion=FusionConfig(**s.fusion.to_dict()),
        feddf_init_from=s.feddf_init_from,
        target_accuracy=spec.target_accuracy,
        dp_clip=spec.privacy.clip,
        dp_noise_multiplier=spec.privacy.noise_multiplier,
        bucketing=BucketConfig(kind=spec.bucket.kind,
                               max_buckets=spec.bucket.max_buckets),
        population=spec.population_config())


class Experiment:
    """A validated, runnable experiment on ``device``."""

    def __init__(self, spec: ExperimentSpec, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec.validate()

    def run(self, *, init_globals: Optional[List[dict]] = None,
            index_stream=None, draw_stream=None, dp_noise_stream=None,
            swag_draw_stream=None) -> RunResult:
        """Run every round; a cohort of several prototypes runs the
        paper's Algorithm 3, with one result, one global tree and one net
        name per prototype group.  ``init_globals`` (one tree per group,
        on any device), ``index_stream`` (a pool source's distillation
        indices, shared by every group's fusion; see
        ``data/distill_sources.UnlabeledDataset``), ``draw_stream`` (a
        generator or noise source's random draws), ``dp_noise_stream``
        (the DP noise, ``core/privacy.NormalDraws``) and
        ``swag_draw_stream`` (the SWAG samples' draws,
        ``core/swag.SwagDraws``) replace the run's own initialisation and
        draws, e.g. with the JAX package's.  A stream the spec has no use
        for is refused."""
        spec = self.spec
        bundle = build_task_bundle(spec)
        train, val, test, parts = build_splits(spec, bundle)
        nets, client_proto = build_cohort(spec, bundle)
        source = build_source(spec, bundle, train, self.device)
        if source is None and (index_stream is not None
                               or draw_stream is not None):
            raise ValueError("index_stream / draw_stream given, but the "
                             "spec has no distillation source")
        if dp_noise_stream is not None and spec.privacy.clip is None:
            raise ValueError("dp_noise_stream given, but the spec has no "
                             "DP uploads (privacy.clip is None)")
        if swag_draw_stream is not None \
                and spec.strategy.fusion.swag_samples <= 0:
            raise ValueError("swag_draw_stream given, but the spec draws no "
                             "SWAG teachers (fusion.swag_samples is 0)")
        if index_stream is not None:
            source.indices = index_stream
        if draw_stream is not None:
            source.draws = draw_stream
        if init_globals is not None:
            init_globals = [tree_to(g, self.device) for g in init_globals]
        engine = RoundEngine(nets, client_proto, train, parts, val, test,
                             to_fl_config(spec), source=source,
                             heterogeneous=len(nets) > 1,
                             device=self.device, dp_draws=dp_noise_stream,
                             swag_draws=swag_draw_stream)

        driver = make_driver(spec.driver.kind,
                             staleness=spec.driver.staleness,
                             prefetch=spec.driver.prefetch)
        results, globals_, rounds_to_target = driver.run(
            engine, init_globals=init_globals)
        return RunResult(spec=spec, results=results, global_params=globals_,
                         rounds_to_target=rounds_to_target,
                         net_names=[n.name for n in nets],
                         device=str(self.device),
                         phase_seconds=list(driver.phase_seconds))
