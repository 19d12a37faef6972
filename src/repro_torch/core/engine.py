"""Vectorized federated round engine.

A round decomposes into explicit phases that round *drivers*
(``repro_torch.drivers``) compose:

  ``sample_cohort``        draw the round's active clients through the
                           configured cohort sampler (the only phase that
                           advances the host rng);
  ``build_round_batches``  host-side numpy batch tensors per prototype
                           group, a pure function of ``(round, cohort)``;
  ``train_clients``        every group's clients in one batched local
                           update (``client.make_batched_local_update``)
                           on the engine's device;
  ``aggregate``            drop-worst (Table 3) per prototype group, then
                           dispatch of the stacks to the configured
                           :class:`ServerStrategy` -> new globals;
  ``evaluate_round``       test/val accuracy per prototype (of the
                           quantized globals for low-bit clients) ->
                           ``RoundLog``.

Every tensor of a run lives on the engine's ``device``; the numpy batches
cross to it once per round and the eval sets once per run.
``population()`` is the buffered-async driver's seam (registry, traffic
model and upload buffer over the engine's sampler).

Heterogeneous cohorts (``heterogeneous=True``, the paper's Algorithm 3)
train each prototype group's clients in their own batched update, add
the all-groups logits-averaging ensemble's accuracy to every group's log,
and keep a group's previous global in a round that drew none of its
clients.  The JAX package pads each group's client axis to a run-fixed
size so that ``jit`` compiles once; the eager update here needs no fixed
size, and the padded clients never reach aggregation there, so leaving
them out changes no result.

Low-bit clients (``quantize``) and DP uploads (``dp_clip``) run inside
the batched client update; client ``k``'s DP noise in round ``t`` is
drawn from the JAX package's integer ``seed * 7919 + t * 131 + k``.
Step-count bucketing other than ``none``, fault injection and meshes wait
for their ROADMAP.md items and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.options import BUCKET_KINDS
from repro_torch.common.pytree import tree_to
from repro_torch.core import feddf as feddf_mod
from repro_torch.core.client import (assign_buckets, bucket_capacities,
                                     build_batched_batches, evaluate,
                                     make_batched_local_update,
                                     n_local_steps)
from repro_torch.core.dropworst import drop_worst_stacked
from repro_torch.core.ensemble import ensemble_accuracy_stacked
from repro_torch.core.nets import Net
from repro_torch.core.privacy import normal_draws
from repro_torch.core.strategies import GroupRound, RoundContext, get_strategy
from repro_torch.data.distill_sources import DistillSource
from repro_torch.data.synthetic import Dataset
from repro_torch.optim.optimizers import Optimizer, adam, sgd
from repro_torch.population.config import FaultConfig, PopulationConfig
from repro_torch.population.scheduler import SamplerContext, make_sampler


@dataclasses.dataclass
class BucketConfig:
    """Step-count bucketing of the client axis; only ``none`` (pad every
    client of a group to the group maximum) is ported."""

    kind: str = "none"        # none | pow2 | quantile
    max_buckets: int = 4


@dataclasses.dataclass
class FLConfig:
    """The engine-level run config: the JAX package's ``FLConfig`` fields
    that the port runs, plus the guards of those it does not run yet."""

    rounds: int = 20
    client_fraction: float = 0.4  # C
    local_epochs: int = 20        # E
    local_batch_size: int = 32
    local_lr: float = 0.1
    strategy: str = "fedavg"      # any name in the strategy registry
    prox_mu: float = 0.01         # fedprox
    server_momentum: float = 0.3  # beta for fedavgm
    drop_worst: bool = False
    seed: int = 0
    local_optimizer: str = "sgd"  # sgd | adam (Table 6 ablation)
    local_adam_lr: float = 1e-3   # adam local lr (sgd uses local_lr)
    quantize: Optional[Callable] = None  # low-bit client forwards
    fusion: feddf_mod.FusionConfig = dataclasses.field(
        default_factory=feddf_mod.FusionConfig)
    feddf_init_from: str = "average"  # average | previous
    target_accuracy: Optional[float] = None
    # client-level DP on uploads (paper §3; core/privacy.py)
    dp_clip: Optional[float] = None
    dp_noise_multiplier: float = 0.0
    bucketing: BucketConfig = dataclasses.field(default_factory=BucketConfig)
    # population / traffic / sampler axis; the defaults reproduce the
    # fixed-roster uniform draw bit for bit
    population: PopulationConfig = dataclasses.field(
        default_factory=PopulationConfig)
    # fault injection (not ported: an enabled config raises)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)


@dataclasses.dataclass
class RoundLog:
    round: int
    test_acc: float
    val_acc: float
    ensemble_acc: Optional[float] = None
    pre_distill_acc: Optional[float] = None
    distill_steps: int = 0
    n_participants: int = 0
    n_dropped: int = 0
    # teacher batch-forwards this round's fusion cost (0 when the shared
    # logit bank served a group, or for non-distillation strategies)
    teacher_forwards: int = 0
    # how the fusion sourced its teacher logits this round: "bank" (built),
    # "bank_reused" (persistent bank hit), "on_the_fly", or
    # "skipped_small_run" (the auto heuristic predicted too few distill
    # steps to amortize a bank build); "" for non-distillation strategies
    bank: str = ""
    # the bank's storage dtype ("float32" | "bfloat16" | "int8" |
    # "fp8_e4m3") and device bytes (quantized rows + per-row scales) —
    # the observable memory the quantized dtypes shrink; ""/0 when no
    # bank served this round
    bank_dtype: str = ""
    bank_nbytes: int = 0
    # population telemetry (buffered_async driver; docs/population.md).
    # Defaults keep pre-population checkpoints loadable via RoundLog(**d).
    staleness_hist: Optional[List[int]] = None  # uploads fused at age s
    buffer_fill: int = 0          # ready-but-unconsumed uploads after agg
    n_straggling: int = 0         # in-flight uploads not yet arrived
    n_dropped_uploads: int = 0    # uploads lost to dropout since last agg
    n_stale_dropped: int = 0      # uploads discarded as > max_staleness
    eff_participants: float = 0.0  # sum of (1+s)^-a importance weights
    # fault telemetry (docs/robustness.md).  Defaults keep pre-fault
    # checkpoints loadable via RoundLog(**d).
    n_corrupted: int = 0          # uploads a fault fired on this round
    n_quarantined: int = 0        # uploads rejected by screening
    n_retries: int = 0            # re-dispatch attempts after rejection
    n_teachers_filtered: int = 0  # teachers dropped by consensus filter
    fused: bool = True            # False when quorum skipped aggregation
    rolled_back: bool = False     # non-finite globals restored to last-good
    # distributed wire telemetry (docs/distributed.md).  Defaults keep
    # pre-dist checkpoints loadable via RoundLog(**d).
    wire_bytes_up: int = 0        # accepted UPLOAD frame bytes this round
    wire_bytes_down: int = 0      # TRAIN frame bytes dispatched this round
    n_wire_retries: int = 0       # TRAIN re-dispatches (deadline/CRC)
    n_crc_failures: int = 0       # frames rejected by checksum
    n_deadline_misses: int = 0    # uploads past their per-attempt deadline
    n_wire_lost: int = 0          # clients lost at the wire layer
    n_pods_alive: int = 0         # live client pods at round end


@dataclasses.dataclass
class FLResult:
    logs: List[RoundLog]
    global_params: dict
    rounds_to_target: Optional[int] = None

    @property
    def final_acc(self) -> float:
        return self.logs[-1].test_acc if self.logs else 0.0

    @property
    def best_acc(self) -> float:
        return max(l.test_acc for l in self.logs) if self.logs else 0.0


@dataclasses.dataclass
class RoundBatches:
    """One prototype group's round inputs, on the engine's device: the
    clients padded to the group's run-fixed scan length."""

    ks: List[int]                # active client ids of this group
    xb: torch.Tensor             # [K, n_steps, B, ...]
    yb: torch.Tensor             # [K, n_steps, B]
    step_mask: torch.Tensor      # [K, n_steps]
    weights: np.ndarray          # [K] local dataset sizes, in ks order
    dp_seeds: Optional[List[int]] = None  # [K] DP noise seeds, in ks order


def _make_opt(cfg: FLConfig) -> Optimizer:
    if cfg.local_optimizer == "adam":
        return adam(cfg.local_adam_lr)
    return sgd(cfg.local_lr)


def _pending(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                              f"queue 1 item {item})")


class RoundEngine:
    """The per-round phases plus the run-wide state (batched client
    updates, fixed scan lengths, device-resident eval sets)."""

    def __init__(self, nets: List[Net], client_proto: Sequence[int],
                 train: Dataset, parts: Sequence[np.ndarray], val: Dataset,
                 test: Dataset, cfg: FLConfig, *,
                 source: Optional[DistillSource] = None,
                 heterogeneous: bool = False, device="cuda",
                 dp_draws: Optional[Callable] = None,
                 swag_draws: Optional[Callable] = None):
        """``dp_draws`` (``core/privacy.NormalDraws``) and ``swag_draws``
        (``core/swag.SwagDraws``) replace the DP noise's and the SWAG
        samples' CPU generators with a caller's draws, e.g. the JAX
        package's."""
        if cfg.bucketing.kind not in BUCKET_KINDS:
            raise ValueError(
                f"bucketing.kind must be one of {BUCKET_KINDS}, got "
                f"{cfg.bucketing.kind!r}")
        if cfg.bucketing.kind != "none":
            _pending(f"bucketing kind {cfg.bucketing.kind!r}", "9")
        cfg.faults.validate()
        if cfg.faults.enabled:
            _pending("fault injection", "10")
        self.nets = nets
        self.client_proto = list(client_proto)
        self.train = train
        self.parts = parts
        self.val = val
        self.test = test
        self.cfg = cfg
        self.source = source
        self.swag_draws = swag_draws
        self.heterogeneous = heterogeneous
        self.device = torch.device(device)
        self.strategy = get_strategy(cfg.strategy)
        self.n_clients = len(parts)
        self.n_active = max(1, int(round(cfg.client_fraction
                                         * self.n_clients)))
        self.n_proto = len(nets)
        # fixed scan length per prototype: the group-wide maximum
        self.client_steps = [
            n_local_steps(len(parts[k]), cfg.local_batch_size,
                          cfg.local_epochs)
            for k in range(self.n_clients)]
        self.steps_cap = [
            max([self.client_steps[k] for k in range(self.n_clients)
                 if self.client_proto[k] == p] or [1])
            for p in range(self.n_proto)]
        self.batch_seed_mult = 99991 if heterogeneous else 100_003
        self._init_sampler()
        self.val_x = torch.as_tensor(val.x, device=self.device)
        self.val_y = torch.as_tensor(val.y, device=self.device)
        self.test_x = torch.as_tensor(test.x, device=self.device)
        self.test_y = torch.as_tensor(test.y, device=self.device)
        prox = self.strategy.local_prox_mu(cfg)
        self.updates = [
            make_batched_local_update(
                self.nets[p], _make_opt(cfg), prox_mu=prox,
                quantize=cfg.quantize, dp_clip=cfg.dp_clip,
                dp_noise_multiplier=cfg.dp_noise_multiplier,
                dp_draws=dp_draws or normal_draws)
            for p in range(self.n_proto)]

    def _init_sampler(self) -> None:
        """Bind the cohort sampler to the run-fixed population facts, as
        the JAX package's engine does.  The default (uniform sampler,
        population == partitions) is ``rng.choice(n_clients, n_active,
        replace=False)`` bit for bit."""
        cfg = self.cfg
        cfg.population.validate()
        proto_counts = [sum(1 for q in self.client_proto if q == p)
                        for p in range(self.n_proto)]
        k_cap = [min(self.n_active, c) if c else 1 for c in proto_counts]
        self.population_size = int(cfg.population.size or self.n_clients)
        self._part_bucket = np.zeros(self.n_clients, np.int64)
        sampler_caps = []
        for p in range(self.n_proto):
            ks = [k for k in range(self.n_clients)
                  if self.client_proto[k] == p]
            steps_p = [self.client_steps[k] for k in ks]
            caps = bucket_capacities(steps_p or [1], cfg.bucketing.kind,
                                     cfg.bucketing.max_buckets)
            counts = np.bincount(assign_buckets(steps_p, caps)
                                 if steps_p else [], minlength=len(caps))
            if ks:
                self._part_bucket[ks] = assign_buckets(steps_p, caps)
            sampler_caps.append([min(k_cap[p], int(c)) or 1 for c in counts])
        pop_part = np.arange(self.population_size,
                             dtype=np.int64) % self.n_clients
        self.sampler = make_sampler(cfg.population.sampler).bind(
            SamplerContext(
                n_clients=self.population_size,
                n_partitions=self.n_clients,
                proto=np.asarray(self.client_proto, np.int64)[pop_part],
                bucket=self._part_bucket[pop_part],
                bucket_client_caps=sampler_caps))
        self._population = None  # built lazily by population()

    def make_rng(self) -> np.random.Generator:
        return np.random.default_rng(self.cfg.seed)

    def init_globals(self) -> List[dict]:
        """Drawn on the CPU from the run seed (prototype p of a
        heterogeneous run from ``seed + p``), then moved: the same init
        whichever device the run uses."""
        seed = self.cfg.seed
        return [tree_to(self.nets[p].init(torch.Generator().manual_seed(
            seed + p if self.heterogeneous else seed)), self.device)
            for p in range(self.n_proto)]

    def init_state(self, globals_: List[dict]):
        return self.strategy.init_state(globals_)

    # -- phases -----------------------------------------------------------

    def sample_cohort(self, rng: np.random.Generator) -> np.ndarray:
        """Draw the round's active clients through the cohort sampler.
        With a registered population larger than the partition roster,
        sampled ids map onto data partitions round-robin."""
        active = self.sampler.sample(rng, self.n_active)
        if self.population_size != self.n_clients:
            active = np.asarray(active) % self.n_clients
        return active

    def population(self):
        """The lazily-built :class:`PopulationManager` (buffered-async
        driver seam): registry + traffic model + upload buffer sharing
        this engine's bound sampler."""
        if self._population is None:
            from repro_torch.population.manager import PopulationManager
            self._population = PopulationManager(
                self.cfg.population, seed=self.cfg.seed,
                n_partitions=self.n_clients,
                partition_sizes=[len(p) for p in self.parts],
                client_steps=self.client_steps,
                client_proto=self.client_proto,
                client_bucket=self._part_bucket,
                n_active=self.n_active, sampler=self.sampler,
                faults=self.cfg.faults)
        return self._population

    def guard_globals(self, globals_: List[dict], last_good: List[dict]
                      ) -> Tuple[List[dict], List[bool]]:
        """Divergence rollback of non-finite fused globals, which the JAX
        package gates on fault injection.  The engine refuses an enabled
        ``FaultConfig``, so here it is the identity."""
        return globals_, [False] * len(globals_)

    def build_round_batches(self, t: int, active: np.ndarray
                            ) -> List[Optional[RoundBatches]]:
        cfg = self.cfg
        by_proto: List[List[int]] = [[] for _ in range(self.n_proto)]
        for k in active:
            by_proto[self.client_proto[k]].append(int(k))
        out: List[Optional[RoundBatches]] = []
        for p in range(self.n_proto):
            ks = by_proto[p]
            if not ks:
                out.append(None)
                continue
            seeds = [cfg.seed * self.batch_seed_mult + t * 131 + k
                     for k in ks]
            xb, yb, step_mask = build_batched_batches(
                self.train.x, self.train.y, [self.parts[k] for k in ks],
                cfg.local_batch_size, cfg.local_epochs, seeds,
                n_steps=self.steps_cap[p])
            weights = np.array([float(len(self.parts[k])) for k in ks])
            dp_seeds = ([cfg.seed * 7919 + t * 131 + k for k in ks]
                        if cfg.dp_clip is not None else None)
            to = lambda a: torch.from_numpy(a).to(self.device)
            out.append(RoundBatches(ks=ks, xb=to(xb), yb=to(yb),
                                    step_mask=to(step_mask),
                                    weights=weights, dp_seeds=dp_seeds))
        return out

    def train_clients(self, t: int, globals_: List[dict],
                      batches: List[Optional[RoundBatches]]
                      ) -> List[GroupRound]:
        groups: List[GroupRound] = []
        for p, rb in enumerate(batches):
            if rb is None:
                groups.append(GroupRound(self.nets[p], globals_[p], None,
                                         np.zeros(0)))
                continue
            stack = self.updates[p](globals_[p], rb.xb, rb.yb, globals_[p],
                                    rb.step_mask, rb.dp_seeds)
            groups.append(GroupRound(self.nets[p], globals_[p], stack,
                                     rb.weights))
        return groups

    def aggregate(self, t: int, groups: List[GroupRound], state):
        """Drop-worst, then strategy dispatch.  With ``drop_worst`` each
        group's uploads at chance on the validation set leave its stack,
        weights and importance (in place, as in the JAX package), and each
        group's info carries ``n_dropped``.  A heterogeneous round also
        scores the logits-averaging ensemble of every non-empty group's
        uploads, and each group's info carries it as ``ensemble_acc``."""
        dropped = [0] * self.n_proto
        if self.cfg.drop_worst:
            for p, g in enumerate(groups):
                if g.stack is None:
                    continue
                g.stack, kept_w, kept_i = drop_worst_stacked(
                    g.net, g.stack, g.weights, self.val_x, self.val_y,
                    self.train.n_classes)
                dropped[p] = len(g.weights) - len(kept_i)
                g.weights = np.asarray(kept_w)
                if g.importance is not None:
                    g.importance = np.asarray(g.importance)[kept_i]
        ens_acc = None
        if self.heterogeneous:
            ens_acc = ensemble_accuracy_stacked(
                [(g.net, g.stack) for g in groups if g.stack is not None],
                self.test_x, self.test_y)
        ctx = RoundContext(cfg=self.cfg, round=t,
                           heterogeneous=self.heterogeneous,
                           source=self.source, val_x=self.val_x,
                           val_y=self.val_y, test_x=self.test_x,
                           test_y=self.test_y, swag_draws=self.swag_draws)
        globals_, state, infos = self.strategy.aggregate(groups, state, ctx)
        infos = [{**info, "n_dropped": d} for info, d in zip(infos, dropped)]
        if ens_acc is not None:
            infos = [{**info, "ensemble_acc": ens_acc} for info in infos]
        return globals_, state, infos

    def evaluate_round(self, t: int, globals_: List[dict],
                       groups: List[GroupRound], infos: List[dict]
                       ) -> List[RoundLog]:
        out = []
        for p in range(self.n_proto):
            acc = evaluate(self.nets[p], globals_[p], self.test_x,
                           self.test_y, quantize=self.cfg.quantize)
            vacc = evaluate(self.nets[p], globals_[p], self.val_x,
                            self.val_y, quantize=self.cfg.quantize)
            out.append(RoundLog(
                round=t, test_acc=acc, val_acc=vacc,
                ensemble_acc=infos[p].get("ensemble_acc"),
                pre_distill_acc=infos[p].get("pre_distill_acc"),
                distill_steps=infos[p].get("distill_steps", 0),
                n_participants=len(groups[p].weights),
                n_dropped=infos[p].get("n_dropped", 0),
                teacher_forwards=infos[p].get("teacher_forwards", 0),
                bank=infos[p].get("bank", ""),
                bank_dtype=infos[p].get("bank_dtype", ""),
                bank_nbytes=infos[p].get("bank_nbytes", 0),
                rolled_back=bool(infos[p].get("diverged", False))))
        return out

    def target_reached(self, round_logs: List[RoundLog]) -> bool:
        if self.cfg.target_accuracy is None:
            return False
        return max(l.test_acc for l in round_logs) >= self.cfg.target_accuracy
