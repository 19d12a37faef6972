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
clients.  Each step bucket's client axis is zero-padded to a run-fixed
size, as the JAX package pads it for ``jit``: here it keeps a client's
products at one shape whichever clients share its bucket (the card's
batched GEMMs pick their algorithm by shape), so an upload does not
depend on the grouping.  The padded clients never reach aggregation.

Step-count bucketing (``BucketConfig`` ``pow2`` / ``quantile``,
docs/bucketing.md) splits each group's clients over run-fixed scan
capacities: each non-empty bucket is its own stack, padded only to its
capacity, and ``train_clients`` runs the batched update once per bucket
and rejoins the stacks in the group's client order.  The update is one
host loop over the steps, so a round makes the SUM of its buckets'
capacities in host steps (against the group maximum unbucketed); what
bucketing saves is the masked lanes' work on the card.  ``padded_slots``
counts the JAX package's padded layout (the run-fixed client cap times
the scan length per bucket), so both packages report one number.

Low-bit clients (``quantize``) and DP uploads (``dp_clip``) run inside
the batched client update; client ``k``'s DP noise in round ``t`` is
drawn from the JAX package's integer ``seed * 7919 + t * 131 + k``.

Fault injection (docs/robustness.md): with an enabled ``FaultConfig``,
``fault_pipeline`` takes the trained stacks to host numpy (the JAX
package's leaf order), corrupts, screens and retries them there with the
counter-based ``population/faults.FaultModel``, and rebuilds a stack on
the device only when a fault touched it; ``quorum_met`` decides whether
the round fuses, and ``guard_globals`` rolls non-finite fused globals
back.  A run with faults disabled copies nothing and is bit for bit the
fault-free run.

With a device mesh (``mesh=`` or :meth:`RoundEngine.attach_mesh`, the
``multihost`` driver's seam), every rank of the world runs the same
engine: the host draws (cohort, batches, DP seeds) are made whole on
every rank, the batched update trains the rank's block of the client
axis and all-gathers the stack (``core/client.py``), and aggregation and
evaluation run on every rank on the same uploads.  The unbucketed
homogeneous path needs every cohort size to be a multiple of the axis
size; heterogeneous and bucketed runs round their run-fixed client caps
up to it instead (the padded lanes take no step and are sliced off).

While the flight recorder is armed (``repro_torch.obs.trace``), every
phase runs inside a span of its name, stamped with its round.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.options import BUCKET_KINDS
from repro_torch.common.pytree import (tree_cat, tree_isfinite,
                                       tree_leaves_jax, tree_map, tree_take,
                                       tree_to, tree_unflatten_jax)
from repro_torch.core import feddf as feddf_mod
from repro_torch.core.client import (assign_buckets, bucket_capacities,
                                     build_bucketed_batches, evaluate,
                                     make_batched_local_update,
                                     n_local_steps)
from repro_torch.core.dropworst import drop_worst_stacked
from repro_torch.core.ensemble import ensemble_accuracy_stacked
from repro_torch.core.nets import Net
from repro_torch.core.privacy import normal_draws
from repro_torch.core.strategies import GroupRound, RoundContext, get_strategy
from repro_torch.data.distill_sources import DistillSource
from repro_torch.data.synthetic import Dataset
from repro_torch.dist.config import DistConfig
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import REGISTRY
from repro_torch.optim.optimizers import Optimizer, adam, sgd
from repro_torch.population.config import FaultConfig, PopulationConfig
from repro_torch.population.scheduler import SamplerContext, make_sampler


def _spanned(name: str):
    """Wrap a phase method in a flight-recorder span stamped with the
    driver's step index as ``round=``: the round for the sync, pipelined
    and distributed drivers, the wave number when buffered_async trains
    inside a fill wave.  Free while disarmed."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(self, t, *args, **kwargs):
            if _trace.recorder() is None:
                return fn(self, t, *args, **kwargs)
            with _trace.span(name, round=int(t)):
                return fn(self, t, *args, **kwargs)
        return wrapped
    return deco


@dataclasses.dataclass
class BucketConfig:
    """Step-count bucketing of the client axis: ``none`` (pad every client
    of a group to the group maximum), ``pow2`` (power-of-two scan
    capacities) or ``quantile`` (capacities at step-count quantiles), at
    most ``max_buckets`` per prototype.  Bucketing regroups the client
    axis and changes no client's trajectory."""

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
    trim_frac: float = 0.2        # trimmed_mean: per-end trim fraction
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
    # fault injection + robust-fusion defenses (docs/robustness.md)
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    # the distributed driver's pods, transport and wire codec
    # (docs/distributed.md); read by that driver only
    dist: DistConfig = dataclasses.field(default_factory=DistConfig)


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
class BucketBatch:
    """One (prototype, step bucket)'s round inputs, on the engine's
    device: the bucket's clients padded to its scan capacity.  Unbucketed,
    a group has exactly one, padded to the group maximum."""

    pos: np.ndarray              # positions into RoundBatches.ks
    xb: torch.Tensor             # [k_real, cap_steps, B, ...]
    yb: torch.Tensor             # [k_real, cap_steps, B]
    step_mask: torch.Tensor      # [k_real, cap_steps]
    dp_seeds: Optional[List[int]]  # [k_real] DP noise seeds, in pos order
    k_real: int                  # the bucket's clients this round
    cap_clients: int             # its run-fixed client cap (JAX's padding)
    cap_steps: int               # its run-fixed scan length


@dataclasses.dataclass
class RoundBatches:
    """One prototype group's round inputs, split over the run-fixed step
    buckets, with the JAX package's padding accounting."""

    ks: List[int]                # active client ids of this group
    buckets: List[BucketBatch]
    k_real: int                  # the group's clients over all buckets
    weights: np.ndarray          # [k_real] local dataset sizes, in ks order
    real_steps: int              # unmasked client steps this group runs
    padded_slots: int            # sum of cap_clients * cap_steps


def _make_opt(cfg: FLConfig) -> Optimizer:
    if cfg.local_optimizer == "adam":
        return adam(cfg.local_adam_lr)
    return sgd(cfg.local_lr)


class RoundEngine:
    """The per-round phases plus the run-wide state (batched client
    updates, fixed scan lengths, device-resident eval sets)."""

    def __init__(self, nets: List[Net], client_proto: Sequence[int],
                 train: Dataset, parts: Sequence[np.ndarray], val: Dataset,
                 test: Dataset, cfg: FLConfig, *,
                 source: Optional[DistillSource] = None,
                 heterogeneous: bool = False, device="cuda",
                 dp_draws: Optional[Callable] = None,
                 swag_draws: Optional[Callable] = None,
                 filter_probe: Optional[Callable] = None, mesh=None,
                 client_axis: str = "data"):
        """``dp_draws`` (``core/privacy.NormalDraws``), ``swag_draws``
        (``core/swag.SwagDraws``) and ``filter_probe`` (the teacher
        filter's probe batch, ``core/strategies.FilterProbe``) replace the
        DP noise's, the SWAG samples' and the probe's CPU generators with
        a caller's draws, e.g. the JAX package's.  ``mesh`` shards the
        client axis over its ``client_axis`` (``launch/mesh.py``)."""
        if cfg.bucketing.kind not in BUCKET_KINDS:
            raise ValueError(
                f"bucketing.kind must be one of {BUCKET_KINDS}, got "
                f"{cfg.bucketing.kind!r}")
        cfg.faults.validate()
        self.nets = nets
        self.client_proto = list(client_proto)
        self.train = train
        self.parts = parts
        self.val = val
        self.test = test
        self.cfg = cfg
        self.source = source
        self.swag_draws = swag_draws
        self.filter_probe = filter_probe
        self.heterogeneous = heterogeneous
        self.mesh = mesh
        self.client_axis = client_axis
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
        proto_counts = [sum(1 for q in self.client_proto if q == p)
                        for p in range(self.n_proto)]
        self.k_cap = [min(self.n_active, c) if c else 1
                      for c in proto_counts]
        # per-prototype scan capacities and each bucket's client count: a
        # pure function of the static per-client step counts
        self.bucket_caps, self._bucket_counts = [], []
        self._part_bucket = np.zeros(self.n_clients, np.int64)
        for p in range(self.n_proto):
            ks = [k for k in range(self.n_clients)
                  if self.client_proto[k] == p]
            steps_p = [self.client_steps[k] for k in ks]
            caps = bucket_capacities(steps_p or [1], cfg.bucketing.kind,
                                     cfg.bucketing.max_buckets)
            which = assign_buckets(steps_p, caps) if ks else []
            self.bucket_caps.append(caps)
            self._bucket_counts.append(np.bincount(which,
                                                   minlength=len(caps)))
            if ks:
                self._part_bucket[ks] = which
        self.batch_seed_mult = 99991 if heterogeneous else 100_003
        self._init_sampler()
        self.val_x = torch.as_tensor(val.x, device=self.device)
        self.val_y = torch.as_tensor(val.y, device=self.device)
        self.test_x = torch.as_tensor(test.x, device=self.device)
        self.test_y = torch.as_tensor(test.y, device=self.device)
        self.dp_draws = dp_draws or normal_draws
        # the batched updates, built at the first training so that a
        # driver can still attach a mesh
        self._updates: Optional[List[Callable]] = None
        if self.mesh is not None:
            self._validate_mesh(self.mesh, self.client_axis)

    def _validate_mesh(self, mesh, client_axis: str) -> None:
        """Fail where both mesh paths (the constructor's and a driver's
        ``attach_mesh``) meet.  Heterogeneous and bucketed runs round
        their client caps up to the axis size, so only the unbucketed
        homogeneous path needs every cohort size to divide."""
        if self.heterogeneous or self.cfg.bucketing.kind != "none":
            return
        from repro_torch.common.sharding import axis_size
        axis = axis_size(mesh, client_axis)
        bad = [k for k in self.k_cap if k % axis]
        if bad:
            raise ValueError(
                f"active cohort size(s) {bad} do not divide the "
                f"{client_axis!r} mesh axis ({axis} devices); pick "
                f"client_fraction/n_clients so K is a multiple of the "
                f"device count")

    def attach_mesh(self, mesh, client_axis: str = "data") -> None:
        """Shard the client axis of local training over ``mesh`` (the
        multihost driver's seam); only before the first training."""
        if self._updates is not None:
            raise RuntimeError("attach_mesh must be called before the "
                               "first train_clients call")
        self._validate_mesh(mesh, client_axis)
        self.mesh = mesh
        self.client_axis = client_axis

    @property
    def updates(self) -> List[Callable]:
        """Each prototype's batched client update (over the mesh, if
        any)."""
        if self._updates is None:
            cfg = self.cfg
            prox = self.strategy.local_prox_mu(cfg)
            self._updates = [
                make_batched_local_update(
                    self.nets[p], _make_opt(cfg), prox_mu=prox,
                    quantize=cfg.quantize, dp_clip=cfg.dp_clip,
                    dp_noise_multiplier=cfg.dp_noise_multiplier,
                    dp_draws=self.dp_draws, mesh=self.mesh,
                    client_axis=self.client_axis)
                for p in range(self.n_proto)]
        return self._updates

    def _init_sampler(self) -> None:
        """Bind the cohort sampler to the run-fixed population facts, as
        the JAX package's engine does.  The default (uniform sampler,
        population == partitions) is ``rng.choice(n_clients, n_active,
        replace=False)`` bit for bit."""
        cfg = self.cfg
        cfg.population.validate()
        self.population_size = int(cfg.population.size or self.n_clients)
        # the capacity_aware sampler's fill guide: the run-fixed client cap
        # of every (prototype, bucket), without a mesh's rounding
        sampler_caps = [[min(self.k_cap[p], int(c)) or 1
                         for c in self._bucket_counts[p]]
                        for p in range(self.n_proto)]
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
        self._fault_model = None  # built lazily by fault_model()

    def _bucket_client_cap(self, p: int, b: int) -> int:
        """Run-fixed client-axis size of (prototype p, bucket b), as the
        JAX package pads it: no round activates more of the bucket's
        clients than exist, nor more than the cohort; with a mesh it is
        rounded up to the axis size (but on the strictly validated
        unbucketed homogeneous path)."""
        cap = min(self.k_cap[p], int(self._bucket_counts[p][b])) or 1
        if self.mesh is not None and (self.heterogeneous
                                      or self.cfg.bucketing.kind != "none"):
            from repro_torch.common.sharding import axis_size
            axis = axis_size(self.mesh, self.client_axis)
            cap = -(-cap // axis) * axis
        return cap

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
        with _trace.span("sample_cohort"):
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

    def fault_model(self):
        """The lazily-built counter-based :class:`FaultModel` (None when
        no fault class is enabled: the fault-free path)."""
        if self._fault_model is None and self.cfg.faults.enabled:
            from repro_torch.population.faults import FaultModel
            self._fault_model = FaultModel(
                self.cfg.faults, self.cfg.seed, self.population_size)
        return self._fault_model

    def fault_pipeline(self, t: int, groups: List[GroupRound], batches):
        """:meth:`_fault_pipeline_body` in a ``fault_pipeline`` span that
        carries the screen's outcome; the same counts feed the
        ``core.faults.*`` registry counters."""
        with _trace.span("fault_pipeline", round=int(t)) as sp:
            stats = self._fault_pipeline_body(t, groups, batches)
            if stats is not None:
                sp.annotate(corrupted=stats["corrupted"],
                            quarantined=stats["quarantined"],
                            retries=stats["retries"])
                for k in ("corrupted", "quarantined", "retries"):
                    REGISTRY.counter(f"core.faults.{k}").add(stats[k])
            return stats

    def _fault_pipeline_body(self, t: int, groups: List[GroupRound],
                             batches):
        """Inject, screen and retry on the trained group stacks: the sync
        driver's fault seam (docs/robustness.md).

        Corruption is keyed on ``(seed, wave=t, client, attempt)`` so the
        fault trace never replays across resumes; a retry redraws the
        transport faults on the client's clean params (training is
        deterministic), while byzantine clients stay corrupted on every
        attempt and end up quarantined.  Screening (finite-ness + robust-z
        of the delta norm within the cohort) mutates the groups in place,
        dropping quarantined rows.  ``batches`` holds each group's
        ``RoundBatches``, or its client ids as a list (the distributed
        driver's assembled uploads).  Returns a stats dict, or None when
        faults are disabled (the stacks are then untouched).  The uploads
        cross to host numpy once; a group's stack goes back to the device
        only when a fault or the screen touched it.
        """
        faults = self.cfg.faults
        fm = self.fault_model()
        if fm is None:
            return None
        from repro_torch.population.faults import (delta_norm, leaves_finite,
                                                   outlier_mask, robust_z)
        stats = {"corrupted": 0, "quarantined": 0, "retries": 0,
                 "dispatched": 0, "kept": 0}
        for p, (g, rb) in enumerate(zip(groups, batches)):
            if g.stack is None or rb is None:
                continue
            ids = rb.ks if isinstance(rb, RoundBatches) else list(rb)
            flat = tree_leaves_jax(g.stack)
            host = [l.detach().cpu().numpy() for l in flat]
            base = [l.detach().cpu().numpy()
                    for l in tree_leaves_jax(g.prev_global)]
            k = len(ids)
            stats["dispatched"] += k
            clean = [[h[i] for h in host] for i in range(k)]
            rows, touched = [], False
            for i, c in enumerate(ids):
                row, kinds = fm.corrupt(t, c, clean[i], base, attempt=0)
                rows.append(row)
                if kinds:
                    stats["corrupted"] += 1
                    touched = True
            keep = np.ones(k, np.bool_)
            if faults.screen_active:
                # Pass 1, transport retries: resolve non-finite uploads
                # BEFORE the norm screen, otherwise a burst of NaN drops
                # can gut the cohort and hand the finite median to a
                # byzantine minority.
                next_attempt = np.ones(k, np.int64)
                for i in range(k):
                    while (not leaves_finite(rows[i])
                           and next_attempt[i] <= faults.retries):
                        stats["retries"] += 1
                        row, _ = fm.corrupt(t, ids[i], clean[i], base,
                                            attempt=int(next_attempt[i]))
                        next_attempt[i] += 1
                        if leaves_finite(row):
                            rows[i] = row
                # Pass 2, the adversarial screen over the finite cohort.
                norms = np.array([
                    delta_norm(r, base) if leaves_finite(r) else np.nan
                    for r in rows])
                bad = outlier_mask(norms, faults.norm_sigma)
                ok_norms = norms[~bad]
                med = (float(np.median(ok_norms)) if ok_norms.size else 0.0)
                mad = (float(np.median(np.abs(ok_norms - med)))
                       if ok_norms.size else 0.0)
                for i in np.flatnonzero(bad):
                    accepted = False
                    for attempt in range(int(next_attempt[i]),
                                         faults.retries + 1):
                        stats["retries"] += 1
                        row, _ = fm.corrupt(t, ids[i], clean[i], base,
                                            attempt=attempt)
                        if not leaves_finite(row):
                            continue
                        nrm = delta_norm(row, base)
                        if (ok_norms.size and float(robust_z(
                                np.asarray([nrm]), med, mad)[0])
                                > faults.norm_sigma):
                            continue
                        rows[i] = row
                        accepted = True
                        break
                    if not accepted:
                        keep[i] = False
                        stats["quarantined"] += 1
                        self.sampler.penalize([int(ids[i])], 0.5)
                touched = touched or not keep.all()
            stats["kept"] += int(keep.sum())
            if not touched:
                continue
            kept_i = np.flatnonzero(keep)
            if kept_i.size:
                g.stack = tree_unflatten_jax(g.stack, [
                    torch.from_numpy(np.stack([rows[i][li] for i in kept_i],
                                              axis=0)).to(l.device)
                    for li, l in enumerate(flat)])
            else:
                g.stack = None
            g.weights = np.asarray(g.weights)[kept_i]
            if g.importance is not None:
                g.importance = np.asarray(g.importance)[kept_i]
        return stats

    def quorum_met(self, stats) -> bool:
        """Did enough uploads survive screening to fuse this round?"""
        q = self.cfg.faults.quorum
        if q is None or stats is None or stats["dispatched"] == 0:
            return True
        return stats["kept"] >= math.ceil(q * stats["dispatched"] - 1e-9)

    def guard_globals(self, globals_: List[dict], last_good: List[dict]
                      ) -> Tuple[List[dict], List[bool]]:
        """Divergence rollback: any group whose fused globals hold a
        non-finite value is restored to its last-good params.  Gated on
        faults being enabled, so fault-free runs never pay the device
        reduction and its host read; returns ``(globals, rolled_back per
        group)``."""
        rolled = [False] * len(globals_)
        if not self.cfg.faults.enabled:
            return globals_, rolled
        out = []
        for p, (gp, lg) in enumerate(zip(globals_, last_good)):
            if bool(tree_isfinite(gp)):
                out.append(gp)
            else:
                out.append(lg)
                rolled[p] = True
        return out, rolled

    @_spanned("build_round_batches")
    def build_round_batches(self, t: int, active: np.ndarray
                            ) -> List[Optional[RoundBatches]]:
        """Numpy batches per prototype group and step bucket, moved to the
        device: a pure function of ``(t, active)``."""
        cfg = self.cfg
        by_proto: List[List[int]] = [[] for _ in range(self.n_proto)]
        for k in active:
            by_proto[self.client_proto[k]].append(int(k))
        to = lambda a: torch.from_numpy(a).to(self.device)
        out: List[Optional[RoundBatches]] = []
        for p in range(self.n_proto):
            ks = by_proto[p]
            if not ks:
                out.append(None)
                continue
            caps = self.bucket_caps[p]
            seeds = [cfg.seed * self.batch_seed_mult + t * 131 + k
                     for k in ks]
            buckets: List[BucketBatch] = []
            real_steps = padded_slots = 0
            for b, pos, xb, yb, step_mask in build_bucketed_batches(
                    self.train.x, self.train.y, [self.parts[k] for k in ks],
                    cfg.local_batch_size, cfg.local_epochs, seeds, caps):
                kb = [ks[i] for i in pos]
                dp_seeds = ([cfg.seed * 7919 + t * 131 + k for k in kb]
                            if cfg.dp_clip is not None else None)
                cap_k = self._bucket_client_cap(p, b)
                real_steps += int(step_mask.sum())
                padded_slots += cap_k * int(caps[b])
                buckets.append(BucketBatch(
                    pos=np.asarray(pos), xb=to(xb), yb=to(yb),
                    step_mask=to(step_mask), dp_seeds=dp_seeds,
                    k_real=len(kb), cap_clients=cap_k,
                    cap_steps=int(caps[b])))
            weights = np.array([float(len(self.parts[k])) for k in ks])
            out.append(RoundBatches(ks=ks, buckets=buckets, k_real=len(ks),
                                    weights=weights, real_steps=real_steps,
                                    padded_slots=padded_slots))
        return out

    @_spanned("train_clients")
    def train_clients(self, t: int, globals_: List[dict],
                      batches: List[Optional[RoundBatches]]
                      ) -> List[GroupRound]:
        """Every group's batched local update from ``globals_``, once per
        step bucket; the buckets' stacks are rejoined in the group's
        client order, so aggregation sees the same inputs bucketed or
        not."""
        groups: List[GroupRound] = []
        for p, rb in enumerate(batches):
            if rb is None:
                groups.append(GroupRound(self.nets[p], globals_[p], None,
                                         np.zeros(0)))
                continue
            stack = tree_cat([self._train_bucket(p, globals_[p], bb)
                              for bb in rb.buckets])
            pos = np.concatenate([bb.pos for bb in rb.buckets])
            if not np.array_equal(pos, np.arange(rb.k_real)):
                inv = np.empty_like(pos)
                inv[pos] = np.arange(len(pos))
                stack = tree_take(stack, inv)
            groups.append(GroupRound(self.nets[p], globals_[p], stack,
                                     rb.weights))
        return groups

    def _train_bucket(self, p: int, global_: dict, bb: BucketBatch):
        """One bucket's batched update, its client axis zero-padded to the
        run-fixed ``cap_clients`` as the JAX package pads it.  The padded
        clients take no step and are cut from the stack.  A fixed client
        axis runs every product of a client at one shape whichever
        clients share its bucket, so its upload does not depend on the
        grouping: a distributed pod training a shard of the cohort uploads
        what the full cohort's update computes, bit for bit."""
        xb, yb, mask, seeds = bb.xb, bb.yb, bb.step_mask, bb.dp_seeds
        pad = bb.cap_clients - bb.k_real
        if pad > 0:
            def pad0(a):
                return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
            xb, yb, mask = pad0(xb), pad0(yb), pad0(mask)
            seeds = None if seeds is None else list(seeds) + [0] * pad
        stack = self.updates[p](global_, xb, yb, global_, mask, seeds)
        if pad > 0:
            stack = tree_map(lambda x: x[:bb.k_real], stack)
        return stack

    @_spanned("aggregate")
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
                           test_y=self.test_y, swag_draws=self.swag_draws,
                           filter_probe=self.filter_probe)
        globals_, state, infos = self.strategy.aggregate(groups, state, ctx)
        infos = [{**info, "n_dropped": d} for info, d in zip(infos, dropped)]
        if ens_acc is not None:
            infos = [{**info, "ensemble_acc": ens_acc} for info in infos]
        return globals_, state, infos

    @_spanned("evaluate_round")
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
                n_teachers_filtered=infos[p].get("teachers_filtered", 0),
                rolled_back=bool(infos[p].get("diverged", False))))
        return out

    def target_reached(self, round_logs: List[RoundLog]) -> bool:
        if self.cfg.target_accuracy is None:
            return False
        return max(l.test_acc for l in round_logs) >= self.cfg.target_accuracy
