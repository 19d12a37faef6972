"""Declarative, JSON-round-trippable experiment specification.

A copy of the JAX package's ``api/spec.py``: the same dataclasses, fields
and serialization, so the same JSON parses in both packages.  Only
:meth:`ExperimentSpec.validate` differs: it resolves names against the
port's registries, and a spec that asks for an axis the port does not run
yet raises ``NotImplementedError`` naming its ROADMAP.md item.

An :class:`ExperimentSpec` is the single source of truth for a federated
run: what data (``TaskSpec``), how it is split across clients
(``PartitionSpec``), which model prototypes the clients run
(``CohortSpec`` — homogeneous FL is simply a one-prototype cohort), how
the server fuses uploads (``StrategySpec``), what unlabeled data feeds
the distillation (``SourceSpec``), the privacy/compression treatment of
uploads (``PrivacySpec``) and the device layout (``ShardingSpec``).

Every component is referenced *by registry name* (``api/registries.py``),
so a run is fully describable — and reproducible — as data:

    spec = ExperimentSpec.from_json(spec.to_json())   # lossless
    Experiment(spec).run()

Design rules:

* every field is JSON-native (lists not tuples, names not callables) so
  ``from_json(to_json(spec)) == spec`` holds exactly;
* ``from_dict`` rejects unknown keys — a typo'd config fails loudly
  instead of silently running the defaults;
* ``validate()`` resolves every registry name eagerly, before any data
  or device work starts.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Union


def _check_keys(cls, d: dict) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"{cls.__name__}: unknown field(s) {sorted(unknown)}; "
            f"known fields: {sorted(known)}")


@dataclasses.dataclass
class TaskSpec:
    """Which dataset family to build (resolved via the task registry)."""

    name: str = "blobs"
    n_samples: int = 6000
    seed: Optional[int] = None       # None -> inherit ExperimentSpec.seed
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TaskSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class PartitionSpec:
    """Non-iid client split (Dirichlet, paper §4.1)."""

    n_clients: int = 20
    alpha: float = 1.0
    seed: Optional[int] = None       # None -> inherit ExperimentSpec.seed
    min_per_client: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PartitionSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class ModelSpec:
    """One client-model prototype (resolved via the model registry)."""

    name: str = "mlp"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class CohortSpec:
    """The client fleet: a list of model prototypes plus the client ->
    prototype assignment.  One prototype == homogeneous FL (Algorithm 1);
    several == heterogeneous fusion (Algorithm 3).

    ``assignment`` is either ``"round_robin"`` (client k runs prototype
    ``k % P``) or an explicit list of prototype indices, one per client.
    """

    prototypes: List[ModelSpec] = dataclasses.field(
        default_factory=lambda: [ModelSpec()])
    assignment: Union[str, List[int]] = "round_robin"

    def to_dict(self) -> dict:
        return {"prototypes": [m.to_dict() for m in self.prototypes],
                "assignment": self.assignment}

    @classmethod
    def from_dict(cls, d: dict) -> "CohortSpec":
        _check_keys(cls, d)
        d = dict(d)
        if "prototypes" in d:
            d["prototypes"] = [ModelSpec.from_dict(m)
                               for m in d["prototypes"]]
        return cls(**d)

    def client_prototypes(self, n_clients: int) -> List[int]:
        """Materialise the assignment as a per-client prototype index."""
        if self.assignment == "round_robin":
            return [k % len(self.prototypes) for k in range(n_clients)]
        return [int(p) for p in self.assignment]


@dataclasses.dataclass
class SourceSpec:
    """Distillation-data source (resolved via the source registry)."""

    name: str = "unlabeled"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SourceSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class FusionSpec:
    """Server-side distillation hyperparameters (paper §4.1 defaults).

    ``logit_bank`` controls the teacher-logit-bank fast path
    (``core/logit_bank.py``; see docs/distill_fast_path.md): ``auto``
    precomputes averaged teacher logits whenever the source exposes an
    indexable pool, ``on`` insists (warns + falls back otherwise),
    ``off`` keeps per-step teacher forwards.  ``bank_dtype`` trades bank
    memory against trajectory fidelity: ``float32`` (N x C x 4 bytes) is
    bitwise-identical to on-the-fly, ``bfloat16`` halves the rows,
    ``int8`` / ``fp8_e4m3`` store quantized rows plus one fp32 scale per
    row (N x C x 1 + N x 4 — docs/distill_fast_path.md).
    ``use_fused_kernel='auto'`` picks the Pallas kernel on TPU and the
    jnp reference path elsewhere.

    ``batch_sizes`` (heterogeneous cohorts only) gives each prototype
    group its own distillation batch size — one entry per cohort
    prototype; ``distill_bucket`` / ``distill_max_buckets`` bucket those
    sizes into run-fixed padded capacities (docs/bucketing.md)."""

    max_steps: int = 10_000
    patience: int = 1_000
    eval_every: int = 100
    batch_size: int = 128
    lr: float = 1e-3
    temperature: float = 1.0
    use_fused_kernel: Union[bool, str] = "auto"  # True | False | "auto"
    optimizer: str = "adam"          # adam | sgd (Table 7)
    swag_samples: int = 0
    swag_scale: float = 0.5
    logit_bank: str = "auto"         # auto | on | off
    bank_dtype: str = "float32"      # float32 | bfloat16 | int8 | fp8_e4m3
    batch_sizes: Optional[List[int]] = None  # per-prototype distill batch
    distill_bucket: str = "none"     # none | pow2 | quantile
    distill_max_buckets: int = 4

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FusionSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class StrategySpec:
    """Server aggregation rule (resolved via the strategy registry in
    ``core/strategies.py``) plus its hyperparameters."""

    name: str = "feddf"
    prox_mu: float = 0.01            # fedprox local proximal coefficient
    server_momentum: float = 0.3     # fedavgm beta
    drop_worst: bool = False
    trim_frac: float = 0.2           # trimmed_mean per-end trim fraction
    feddf_init_from: str = "average"  # average | previous (Table 5)
    fusion: FusionSpec = dataclasses.field(default_factory=FusionSpec)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fusion"] = self.fusion.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StrategySpec":
        _check_keys(cls, d)
        d = dict(d)
        if "fusion" in d:
            d["fusion"] = FusionSpec.from_dict(d["fusion"])
        return cls(**d)


@dataclasses.dataclass
class PrivacySpec:
    """Client-upload treatment: DP clip+noise (``core/privacy.py``) and
    low-bit quantization by registry name (``core/quantize.py``)."""

    clip: Optional[float] = None         # None -> DP off
    noise_multiplier: float = 0.0
    quantizer: Optional[str] = None      # e.g. "binarize"; None -> fp32

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PrivacySpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class ShardingSpec:
    """Device layout for the round engine's stacked client axis."""

    shard_clients: bool = False
    client_axis: str = "data"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ShardingSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class BucketSpec:
    """Step-count bucketing of the round engine's client axis
    (docs/bucketing.md).

    ``kind``: ``none`` (pad every client of a prototype group to the
    group-wide maximum scan length — the historic path), ``pow2``
    (power-of-two scan capacities) or ``quantile`` (capacities at
    step-count quantiles).  ``max_buckets`` bounds the per-run compile
    count (at most buckets x prototypes client-update programs).
    Bucketing never changes a trajectory — it only regroups the vmap
    axis — but on skewed Dirichlet splits it removes most of the masked
    no-op padding steps."""

    kind: str = "none"               # none | pow2 | quantile
    max_buckets: int = 4

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BucketSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class TrafficSpec:
    """Virtual-time client traffic model (docs/population.md).

    ``arrival``: ``always`` (every client reachable every wave — the
    historic implicit model) or ``bernoulli`` (each client online with
    probability ``rate`` per wave).  ``latency`` is the mean virtual
    upload delay; ``jitter`` is the sigma of a lognormal multiplier
    applied both per-client (static speed) and per-upload.  A
    ``straggler_frac`` fraction of clients upload ``straggler_mult``
    times slower, persistently.  ``dropout`` is the per-upload loss
    probability.  All draws are counter-keyed on (seed, wave), so a
    trace is a pure function of the spec — deterministic and
    resumable."""

    arrival: str = "always"          # always | bernoulli
    rate: float = 1.0                # bernoulli online probability
    latency: float = 0.0             # mean virtual upload latency
    jitter: float = 0.0              # lognormal sigma (speed + per-upload)
    straggler_frac: float = 0.0      # fraction of persistently slow clients
    straggler_mult: float = 8.0      # their latency multiplier
    dropout: float = 0.0             # per-upload loss probability

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class PopulationSpec:
    """The registered client population + cohort scheduling
    (docs/population.md; ``repro.population``).

    ``size=None`` keeps the population equal to the partition roster
    (the historic fixed-roster semantics, bit-identical); a larger size
    maps clients onto data partitions round-robin.  ``sampler`` is a
    cohort-sampler registry name (``uniform`` | ``capacity_aware`` |
    ``prioritized``).  ``buffer_size`` (buffered_async driver) is the
    upload count M that triggers an aggregation — None means the active
    cohort size K, the degenerate sync-equivalent setting.
    ``max_staleness`` bounds how many fusions old an upload may be and
    still fuse; older uploads are dropped with telemetry.
    ``staleness_exponent`` is ``a`` in the FedAsync importance
    ``(1 + s)^-a``."""

    size: Optional[int] = None
    sampler: str = "uniform"
    buffer_size: Optional[int] = None
    max_staleness: int = 4
    staleness_exponent: float = 0.5
    traffic: TrafficSpec = dataclasses.field(default_factory=TrafficSpec)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["traffic"] = self.traffic.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PopulationSpec":
        _check_keys(cls, d)
        d = dict(d)
        if "traffic" in d and isinstance(d["traffic"], dict):
            d["traffic"] = TrafficSpec.from_dict(d["traffic"])
        return cls(**d)


@dataclasses.dataclass
class FaultSpec:
    """Fault injection + robust-fusion defenses (docs/robustness.md).

    Injection knobs are per-upload probabilities; draws are
    counter-based on ``(seed, domain, wave, client, attempt)``
    (``repro_torch.population.faults``) so a fault trace is a pure function of
    the spec — resumed runs never replay or shift it.  ``byzantine_frac``
    marks a persistent (static-domain) subset of clients adversarial,
    like traffic stragglers.

    Defenses (``screen`` — finite-ness + delta-norm quarantine;
    ``teacher_filter`` — FedDF logit-consensus teacher dropping) default
    to ``"auto"``: active iff any injection rate is positive, which
    keeps fault-free configs bit-identical to historic trajectories.
    ``quorum`` is the minimum usable-upload fraction a round needs to
    fuse (``None`` keeps the historic strict behavior); ``retries`` /
    ``backoff`` govern re-dispatch of rejected uploads."""

    nan_rate: float = 0.0            # P(NaN/Inf poisoning) per upload
    byzantine_frac: float = 0.0      # persistent adversarial client frac
    byzantine_scale: float = 10.0    # delta amplification
    byzantine_mode: str = "sign_flip"  # sign_flip | scale
    bitflip_rate: float = 0.0        # P(payload bit corruption) per upload
    bitflip_bits: int = 4            # XOR'd bits per corrupted payload
    crash_rate: float = 0.0          # P(mid-round crash -> partial upload)
    screen: str = "auto"             # auto | on | off
    norm_sigma: float = 6.0          # robust-z quarantine threshold
    teacher_filter: str = "auto"     # auto | on | off
    teacher_sigma: float = 6.0       # robust-z teacher-consensus threshold
    quorum: Optional[float] = None   # min usable fraction to fuse
    retries: int = 2                 # re-dispatch attempts per rejection
    backoff: float = 2.0             # exponential backoff base (virtual s)
    # transport-domain faults (distributed driver; docs/distributed.md):
    # injected on UPLOAD frames in flight, drawn from the same
    # counter-based rng under domain "transport" keyed by (wave, pod,
    # attempt) — a retry is a fresh draw, never a replay
    transport_drop: float = 0.0      # P(frame silently lost)
    transport_corrupt: float = 0.0   # P(frame bytes flipped in flight)
    transport_delay: float = 0.0     # P(frame delivery delayed)
    transport_delay_s: float = 0.25  # delay duration when delayed
    transport_disconnect: float = 0.0  # P(pod link goes dark mid-round)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class DriverSpec:
    """Round-driver selection (``repro.drivers`` registry; see
    docs/drivers.md).

    ``kind``: ``sync`` (serial reference loop) | ``async_pipelined``
    (round t+1's client training overlaps round t's fusion) |
    ``multihost`` (client axis sharded over a host/device mesh) — or any
    registered extension.  ``staleness`` bounds how many rounds the
    async driver's training base may lag the newest fusion (0 == exact
    sync semantics, 1 == one-round overlap; async only).  ``prefetch``
    is how many rounds of host-side batch building run ahead."""

    kind: str = "sync"
    staleness: int = 0
    prefetch: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DriverSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class ObsSpec:
    """Flight-recorder observability (docs/observability.md).

    Everything defaults OFF; a disarmed run is bit-identical to the
    historic trajectory (pinned in ``tests/test_obs.py``).  ``trace``
    arms phase-span tracing for the run — spans land in memory (they
    feed ``RunResult.summary()["obs"]``) and, when ``trace_path`` is
    set, stream to an append-only JSONL file (a resumed run pointed at
    the same path continues the stream).  ``metrics_dir`` streams one
    per-round metrics record (registry counter deltas + accuracy +
    device watermark) to ``<dir>/metrics.jsonl`` and ``.csv``.
    ``profile`` additionally runs the JAX package's
    ``jax.profiler.start_trace(profile_dir)`` with a ``TraceAnnotation``
    per span, and the port's ``torch.profiler.profile`` with a
    ``record_function`` per span (a Chrome trace written to
    ``profile_dir/trace.json``), putting the span taxonomy on the
    profiler's timeline; it requires ``profile_dir``."""

    trace: bool = False
    trace_path: Optional[str] = None
    metrics_dir: Optional[str] = None
    profile: bool = False
    profile_dir: Optional[str] = None

    @property
    def enabled(self) -> bool:
        """Does this spec arm the recorder at all?"""
        return bool(self.trace or self.trace_path or self.metrics_dir
                    or self.profile)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ObsSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class DistSpec:
    """Distributed-runtime topology + wire protocol (docs/distributed.md;
    ``repro.dist``; only read by ``driver.kind == "distributed"``).

    ``transport``: ``loopback`` (pods are threads, links are queues —
    the CI transport) or ``tcp`` (one subprocess per pod on localhost).
    ``wire_codec`` names the payload codec for client uploads
    (``repro.dist.frames``: ``fp32`` exact, ``binarize`` / ``int8``
    low-bit) — the downlink globals always travel fp32 so pods train
    from bit-identical params.  ``heartbeat_s`` is the pod heartbeat
    period (a pod is presumed dead after 3 missed beats);
    ``upload_deadline_s`` bounds each TRAIN->UPLOAD wait before the
    fusion pod re-dispatches with exponential backoff
    (``faults.backoff``).  ``verify_crc=False`` is the *undefended*
    ablation: corrupted frames are accepted instead of retried.
    ``wire_log`` appends every accepted UPLOAD frame to a crash-safe
    record log; a restarted fusion pod replays it so in-flight work
    survives the restart.

    The degenerate setting — loopback, fp32, zero transport faults —
    is bit-identical to ``driver.kind == "sync"`` (pinned in
    ``tests/test_dist.py``)."""

    transport: str = "loopback"      # loopback | tcp
    wire_codec: str = "fp32"         # fp32 | binarize | int8
    n_pods: int = 2
    heartbeat_s: float = 5.0
    upload_deadline_s: float = 30.0
    verify_crc: bool = True
    wire_log: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DistSpec":
        _check_keys(cls, d)
        return cls(**d)


@dataclasses.dataclass
class ExperimentSpec:
    """The complete, serializable description of one federated run."""

    task: TaskSpec = dataclasses.field(default_factory=TaskSpec)
    partition: PartitionSpec = dataclasses.field(
        default_factory=PartitionSpec)
    cohort: CohortSpec = dataclasses.field(default_factory=CohortSpec)
    strategy: StrategySpec = dataclasses.field(default_factory=StrategySpec)
    source: Optional[SourceSpec] = dataclasses.field(
        default_factory=SourceSpec)
    privacy: PrivacySpec = dataclasses.field(default_factory=PrivacySpec)
    sharding: ShardingSpec = dataclasses.field(default_factory=ShardingSpec)
    driver: DriverSpec = dataclasses.field(default_factory=DriverSpec)
    bucket: BucketSpec = dataclasses.field(default_factory=BucketSpec)
    population: PopulationSpec = dataclasses.field(
        default_factory=PopulationSpec)
    faults: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    dist: DistSpec = dataclasses.field(default_factory=DistSpec)
    # round loop
    rounds: int = 20
    client_fraction: float = 0.4
    local_epochs: int = 20
    local_batch_size: int = 32
    local_lr: float = 0.1
    local_optimizer: str = "sgd"     # sgd | adam (Table 6)
    local_adam_lr: float = 1e-3
    target_accuracy: Optional[float] = None
    seed: int = 0

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "task": self.task.to_dict(),
            "partition": self.partition.to_dict(),
            "cohort": self.cohort.to_dict(),
            "strategy": self.strategy.to_dict(),
            "source": None if self.source is None else self.source.to_dict(),
            "privacy": self.privacy.to_dict(),
            "sharding": self.sharding.to_dict(),
            "driver": self.driver.to_dict(),
            "bucket": self.bucket.to_dict(),
            "population": self.population.to_dict(),
            "faults": self.faults.to_dict(),
            "obs": self.obs.to_dict(),
            "dist": self.dist.to_dict(),
            "rounds": self.rounds,
            "client_fraction": self.client_fraction,
            "local_epochs": self.local_epochs,
            "local_batch_size": self.local_batch_size,
            "local_lr": self.local_lr,
            "local_optimizer": self.local_optimizer,
            "local_adam_lr": self.local_adam_lr,
            "target_accuracy": self.target_accuracy,
            "seed": self.seed,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        _check_keys(cls, d)
        d = dict(d)
        nested = {"task": TaskSpec, "partition": PartitionSpec,
                  "cohort": CohortSpec, "strategy": StrategySpec,
                  "privacy": PrivacySpec, "sharding": ShardingSpec,
                  "driver": DriverSpec, "bucket": BucketSpec,
                  "population": PopulationSpec, "faults": FaultSpec,
                  "obs": ObsSpec, "dist": DistSpec}
        for key, sub in nested.items():
            if key in d and isinstance(d[key], dict):
                d[key] = sub.from_dict(d[key])
        if d.get("source") is not None and isinstance(d["source"], dict):
            d["source"] = SourceSpec.from_dict(d["source"])
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def population_config(self):
        """The engine-level :class:`PopulationConfig` of this spec."""
        from repro_torch.population.config import (PopulationConfig,
                                                   TrafficConfig)
        pop = self.population
        return PopulationConfig(
            size=pop.size, sampler=pop.sampler,
            buffer_size=pop.buffer_size, max_staleness=pop.max_staleness,
            staleness_exponent=pop.staleness_exponent,
            traffic=TrafficConfig(**pop.traffic.to_dict()))

    # -- validation -------------------------------------------------------

    def validate(self) -> "ExperimentSpec":
        """Resolve every registry name and check ranges; returns self so
        ``Experiment(spec.validate())`` chains."""
        from repro_torch.api import registries as R
        from repro_torch.common.options import (BANK_DTYPES, BUCKET_KINDS,
                                                FUSED_KERNEL_MODES,
                                                LOGIT_BANK_MODES,
                                                SAMPLER_KINDS,
                                                TRANSPORT_KINDS, WIRE_CODECS)
        from repro_torch.core.strategies import get_strategy
        from repro_torch.drivers import get_driver

        R.get_task(self.task.name)
        for m in self.cohort.prototypes:
            R.get_model(m.name)
        if self.source is not None:
            R.get_source(self.source.name)
        if self.privacy.quantizer is not None:
            R.get_quantizer(self.privacy.quantizer)
        strategy = get_strategy(self.strategy.name)
        if strategy.needs_source and self.source is None:
            raise ValueError(
                f"strategy {self.strategy.name!r} needs a distillation "
                f"source but spec.source is None")

        fusion = self.strategy.fusion
        if fusion.logit_bank not in LOGIT_BANK_MODES:
            raise ValueError(
                f"fusion.logit_bank must be one of {LOGIT_BANK_MODES}, "
                f"got {fusion.logit_bank!r}")
        if fusion.bank_dtype not in BANK_DTYPES:
            raise ValueError(
                f"fusion.bank_dtype must be one of {BANK_DTYPES}, got "
                f"{fusion.bank_dtype!r}")
        if not (isinstance(fusion.use_fused_kernel, bool)
                or fusion.use_fused_kernel == "auto"):
            raise ValueError(
                f"fusion.use_fused_kernel must be one of "
                f"{FUSED_KERNEL_MODES}, got {fusion.use_fused_kernel!r}")
        if fusion.distill_bucket not in BUCKET_KINDS:
            raise ValueError(
                f"fusion.distill_bucket must be one of {BUCKET_KINDS}, "
                f"got {fusion.distill_bucket!r}")
        if self.bucket.kind not in BUCKET_KINDS:
            raise ValueError(
                f"bucket.kind must be one of {BUCKET_KINDS}, got "
                f"{self.bucket.kind!r}")
        get_driver(self.driver.kind)
        if self.driver.staleness < 0 or self.driver.prefetch < 0:
            raise ValueError("driver.staleness and driver.prefetch must be "
                             ">= 0")
        if self.driver.staleness and self.driver.kind not in (
                "async_pipelined", "buffered_async"):
            raise ValueError(
                f"driver.staleness > 0 only applies to the "
                f"'async_pipelined' / 'buffered_async' drivers, got kind "
                f"{self.driver.kind!r}")
        if self.driver.kind == "buffered_async" \
                and self.driver.staleness > 1:
            raise ValueError(
                f"buffered_async bounds driver.staleness to 0 or 1 "
                f"(upload staleness is population.max_staleness), got "
                f"{self.driver.staleness}")
        if self.dist.transport not in TRANSPORT_KINDS:
            raise ValueError(
                f"dist.transport must be one of {TRANSPORT_KINDS}, got "
                f"{self.dist.transport!r}")
        if self.dist.wire_codec not in WIRE_CODECS:
            raise ValueError(
                f"dist.wire_codec must be one of {WIRE_CODECS}, got "
                f"{self.dist.wire_codec!r}")
        if self.population.sampler not in SAMPLER_KINDS:
            raise ValueError(
                f"population.sampler must be one of {SAMPLER_KINDS}, got "
                f"{self.population.sampler!r}")
        # population knobs share their ranges with the engine-level
        # mirror: one validator, no drift between the two layers
        self.population_config().validate()
        if self.driver.kind == "buffered_async" \
                and self.driver.staleness > self.population.max_staleness:
            raise ValueError(
                f"buffered_async with driver.staleness="
                f"{self.driver.staleness} needs population.max_staleness "
                f">= {self.driver.staleness} (overlap-trained uploads "
                f"would all be stale-dropped), got "
                f"{self.population.max_staleness}")

        if not self.cohort.prototypes:
            raise ValueError("cohort needs at least one prototype")
        if (self.cohort.assignment != "round_robin"
                and not isinstance(self.cohort.assignment, list)):
            raise ValueError(
                "cohort.assignment must be 'round_robin' or a list of "
                "prototype indices")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")
        if not 0.0 < self.client_fraction <= 1.0:
            raise ValueError(
                f"client_fraction must be in (0, 1], got "
                f"{self.client_fraction}")
        if self.partition.n_clients < 1:
            raise ValueError("partition.n_clients must be >= 1")
        if self.local_epochs < 1 or self.local_batch_size < 1:
            raise ValueError("local_epochs and local_batch_size must be "
                             ">= 1")
        if self.local_optimizer not in ("sgd", "adam"):
            raise ValueError(
                f"local_optimizer must be 'sgd' or 'adam', got "
                f"{self.local_optimizer!r}")

        # fault knobs share their ranges and messages with the
        # engine-level mirror: one validator, no drift between the layers
        from repro_torch.population.config import FaultConfig
        FaultConfig(**self.faults.to_dict()).validate()
        if not 0.0 <= self.strategy.trim_frac < 0.5:
            raise ValueError(
                f"strategy.trim_frac must be in [0, 0.5) (trimming half "
                f"or more from each end leaves nothing), got "
                f"{self.strategy.trim_frac}")

        if self.obs.profile and not self.obs.profile_dir:
            raise ValueError(
                "obs.profile=True needs obs.profile_dir (where the "
                "torch.profiler trace is written)")

        # the client axis over a mesh runs under the sync and multihost
        # drivers; the others wait for item 11.8.6
        if self.sharding.shard_clients and self.driver.kind in (
                "buffered_async", "async_pipelined", "distributed"):
            raise NotImplementedError(
                f"sharding.shard_clients under the {self.driver.kind} "
                f"driver is not ported yet (ROADMAP.md queue 1 item 11.8.6)")
        return self
