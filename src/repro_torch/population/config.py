"""Engine-level population / traffic configuration (dependency-free), a
copy of the JAX package's.

These mirror the spec-layer :class:`repro_torch.api.spec.PopulationSpec` /
:class:`TrafficSpec` the way ``FLConfig`` mirrors ``ExperimentSpec``:
plain dataclasses the engine and drivers consume, with no knowledge of
JSON round-tripping.  ``docs/population.md`` documents the knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.common.options import ARRIVAL_KINDS, BYZANTINE_MODES, SCREEN_MODES


@dataclasses.dataclass
class TrafficConfig:
    """Arrival / latency / dropout model for the client population.

    All draws are counter-based (keyed on ``(seed, domain, wave)``), so a
    trace is a pure function of the config + seed: resuming a run never
    replays or shifts the schedule.
    """
    arrival: str = "always"       # always | bernoulli (per-wave online draw)
    rate: float = 1.0             # P(online) per wave under bernoulli
    latency: float = 0.0          # mean upload latency, virtual seconds
    jitter: float = 0.0           # lognormal sigma: per-client speed AND
    #                               per-upload latency noise
    straggler_frac: float = 0.0   # fraction of persistently slow clients
    straggler_mult: float = 8.0   # their latency multiplier
    dropout: float = 0.0          # P(upload lost) per dispatch

    def validate(self) -> None:
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival process {self.arrival!r}; "
                             f"options: {ARRIVAL_KINDS}")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"traffic rate must be in (0, 1], got {self.rate}")
        if self.latency < 0 or self.jitter < 0:
            raise ValueError("latency and jitter must be >= 0")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError(f"straggler_frac must be in [0, 1], "
                             f"got {self.straggler_frac}")
        if self.straggler_mult < 1.0:
            raise ValueError(f"straggler_mult must be >= 1, "
                             f"got {self.straggler_mult}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")


@dataclasses.dataclass
class FaultConfig:
    """Fault injection + defense knobs (mirrors spec-layer ``FaultSpec``).

    Injection rates are per-upload probabilities drawn counter-based by
    ``population/faults.FaultModel``.  Byzantine clients are a persistent
    (static-domain) subset like traffic stragglers.  Defenses
    default to ``"auto"``: active iff any injection rate is positive, so
    fault-free configs stay bit-identical to historic trajectories.
    """
    nan_rate: float = 0.0         # P(one tensor entry -> NaN/Inf) per upload
    byzantine_frac: float = 0.0   # fraction of persistently adversarial
    #                               clients (static draw, like stragglers)
    byzantine_scale: float = 10.0  # delta amplification for byzantine rows
    byzantine_mode: str = "sign_flip"  # sign_flip | scale
    bitflip_rate: float = 0.0     # P(payload bit corruption) per upload
    bitflip_bits: int = 4         # XOR'd bits per corrupted payload
    crash_rate: float = 0.0      # P(client crashes mid-round) per upload:
    #                               trailing leaves of the delta are zeroed
    screen: str = "auto"          # auto | on | off: finite + norm screening
    norm_sigma: float = 6.0       # robust-z threshold for delta-norm outliers
    teacher_filter: str = "auto"  # auto | on | off: FedDF consensus filter
    teacher_sigma: float = 6.0    # robust-z threshold on logit divergence
    quorum: Optional[float] = None  # min usable-upload fraction to fuse;
    #                                 None keeps historic strictness
    retries: int = 2              # re-dispatch attempts for rejected uploads
    backoff: float = 2.0          # exponential backoff base, virtual seconds
    # transport fault domain (distributed runtime, docs/distributed.md):
    # per-UPLOAD-frame probabilities drawn counter-based per
    # (round, pod, attempt) — a retry is a fresh draw, never a replay
    transport_drop: float = 0.0        # frame silently discarded
    transport_corrupt: float = 0.0     # frame bytes flipped (CRC catches)
    transport_delay: float = 0.0       # frame held transport_delay_s
    transport_delay_s: float = 0.25    # hold duration, wall seconds
    transport_disconnect: float = 0.0  # pod goes dark for the round

    @property
    def enabled(self) -> bool:
        """True iff any *parameter* fault class can actually fire.

        Deliberately excludes the transport domain: frame-level faults
        are defended at the wire layer (CRC / deadline / quorum), and
        arming the statistical screens for them would perturb fault-free
        parameter paths.
        """
        return (self.nan_rate > 0 or self.byzantine_frac > 0
                or self.bitflip_rate > 0 or self.crash_rate > 0)

    @property
    def transport_enabled(self) -> bool:
        """True iff any transport (frame-level) fault class can fire."""
        return (self.transport_drop > 0 or self.transport_corrupt > 0
                or self.transport_delay > 0 or self.transport_disconnect > 0)

    @property
    def screen_active(self) -> bool:
        return self.screen == "on" or (self.screen == "auto" and self.enabled)

    @property
    def teacher_filter_active(self) -> bool:
        return (self.teacher_filter == "on"
                or (self.teacher_filter == "auto" and self.enabled))

    def validate(self) -> None:
        for name in ("nan_rate", "bitflip_rate", "crash_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if not 0.0 <= self.byzantine_frac <= 1.0:
            raise ValueError(f"byzantine_frac must be in [0, 1], "
                             f"got {self.byzantine_frac}")
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown byzantine_mode "
                             f"{self.byzantine_mode!r}; "
                             f"options: {BYZANTINE_MODES}")
        if self.byzantine_scale <= 0:
            raise ValueError(f"byzantine_scale must be > 0, "
                             f"got {self.byzantine_scale}")
        if self.bitflip_bits < 1:
            raise ValueError(f"bitflip_bits must be >= 1, "
                             f"got {self.bitflip_bits}")
        for name in ("screen", "teacher_filter"):
            v = getattr(self, name)
            if v not in SCREEN_MODES:
                raise ValueError(f"unknown {name} mode {v!r}; "
                                 f"options: {SCREEN_MODES}")
        if self.norm_sigma <= 0 or self.teacher_sigma <= 0:
            raise ValueError("norm_sigma and teacher_sigma must be > 0")
        if self.quorum is not None and not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {self.quorum}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        for name in ("transport_drop", "transport_corrupt",
                     "transport_delay", "transport_disconnect"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.transport_delay_s < 0:
            raise ValueError(f"transport_delay_s must be >= 0, "
                             f"got {self.transport_delay_s}")


@dataclasses.dataclass
class PopulationConfig:
    """Population size, cohort sampling policy and upload-buffer shape."""
    size: Optional[int] = None         # registered clients; None -> one per
    #                                    data partition (the classic roster)
    sampler: str = "uniform"           # population/scheduler.py registry
    buffer_size: Optional[int] = None  # M uploads per aggregation; None -> K
    max_staleness: int = 4             # uploads older than S rounds dropped
    staleness_exponent: float = 0.5    # a in the (1 + s)^-a FedAsync weight
    traffic: TrafficConfig = dataclasses.field(default_factory=TrafficConfig)

    def validate(self) -> None:
        if self.size is not None and self.size < 1:
            raise ValueError(f"population size must be >= 1, got {self.size}")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, "
                             f"got {self.buffer_size}")
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, "
                             f"got {self.max_staleness}")
        if self.staleness_exponent < 0:
            raise ValueError(f"staleness_exponent must be >= 0, "
                             f"got {self.staleness_exponent}")
        self.traffic.validate()
