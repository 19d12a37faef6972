"""Compact host-side client registry: struct-of-arrays for ~10^6 clients.

Each registered client is one row across a handful of numpy arrays — no
per-client Python objects — so a million-client registry costs
``size * 45`` bytes (see :attr:`ClientRegistry.nbytes` and the memory
formula in docs/population.md).  Clients map onto the engine's data
partitions round-robin (``partition[i] = i % n_partitions``): many
devices can share one data shard, which is how a fixed benchmark dataset
serves an arbitrarily large simulated population.

The registry is mutable run state; ``state_dict`` is a flat dict of
arrays, checkpointed with the buffered-async driver's population
snapshot (``api/experiment.py``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# EMA smoothing for observed upload latency (registry.ema_latency).
EMA_DECAY = 0.9

# Arrays persisted by state_dict, in a fixed order.
_FIELDS = ("partition", "proto", "steps", "bucket", "data_size",
           "last_seen", "uploads", "dropouts", "stale_drops", "in_flight",
           "ema_latency", "priority", "quarantines")

# Fields absent from pre-PR 8 checkpoints load with these defaults.
_FIELD_DEFAULTS = {"quarantines": (np.int32, 0)}


class ClientRegistry:
    """Struct-of-arrays state for a registered client population.

    Static per-client facts (data partition, prototype, local step count
    and PR 5 step-bucket) are derived once from the engine's partition
    tables; dynamic counters (last-seen wave, uploads, dropouts, EMA
    latency, sampling priority) are updated by the
    :class:`~repro_torch.population.manager.PopulationManager` as traffic flows.
    """

    def __init__(self, size: int, partition_sizes: Sequence[int],
                 client_steps: Sequence[int], client_proto: Sequence[int],
                 client_bucket: Sequence[int]):
        n_parts = len(partition_sizes)
        if size < 1 or n_parts < 1:
            raise ValueError("registry needs size >= 1 and >= 1 partition")
        self.size = int(size)
        part = (np.arange(self.size, dtype=np.int64) % n_parts)
        # static (derived, but persisted so a resumed registry never
        # depends on re-derivation order)
        self.partition = part.astype(np.int32)
        self.proto = np.asarray(client_proto, np.int16)[part]
        self.steps = np.asarray(client_steps, np.int32)[part]
        self.bucket = np.asarray(client_bucket, np.int16)[part]
        self.data_size = np.asarray(partition_sizes, np.int32)[part]
        # dynamic
        self.last_seen = np.full(self.size, -1, np.int32)   # wave index
        self.uploads = np.zeros(self.size, np.int32)
        self.dropouts = np.zeros(self.size, np.int32)
        self.stale_drops = np.zeros(self.size, np.int32)
        self.in_flight = np.zeros(self.size, np.bool_)
        self.ema_latency = np.zeros(self.size, np.float32)
        self.priority = np.ones(self.size, np.float32)
        self.quarantines = np.zeros(self.size, np.int32)

    # -- traffic hooks ---------------------------------------------------

    def record_dispatch(self, ids: np.ndarray, wave: int) -> None:
        self.last_seen[ids] = wave
        self.in_flight[ids] = True

    def record_dropout(self, ids) -> None:
        self.dropouts[ids] += 1
        self.in_flight[ids] = False

    def record_stale_drop(self, ids) -> None:
        self.stale_drops[ids] += 1
        self.in_flight[ids] = False

    def record_upload(self, ids, latency, staleness) -> None:
        self.uploads[ids] += 1
        self.in_flight[ids] = False
        prev = self.ema_latency[ids]
        obs = np.asarray(latency, np.float32)
        first = self.uploads[ids] == 1
        self.ema_latency[ids] = np.where(
            first, obs, EMA_DECAY * prev + (1.0 - EMA_DECAY) * obs)
        # stale clients bubble up for the prioritized sampler
        self.priority[ids] = 1.0 + np.asarray(staleness, np.float32)

    def record_quarantine(self, ids) -> None:
        """An upload was rejected by screening (docs/robustness.md)."""
        self.quarantines[ids] += 1
        self.in_flight[ids] = False
        # quarantined clients sink in the prioritized sampler: repeat
        # offenders decay geometrically toward never-sampled
        self.priority[ids] = self.priority[ids] * np.float32(0.5)

    # -- checkpointing ---------------------------------------------------

    @property
    def nbytes(self) -> int:
        """Host bytes across all per-client arrays (45 B/client)."""
        return sum(getattr(self, f).nbytes for f in _FIELDS)

    def state_dict(self) -> Dict[str, np.ndarray]:
        d: Dict[str, np.ndarray] = {"size": self.size}
        for f in _FIELDS:
            d[f] = getattr(self, f)
        return d

    @classmethod
    def from_state(cls, d: Dict[str, np.ndarray]) -> "ClientRegistry":
        reg = cls.__new__(cls)
        reg.size = int(d["size"])
        for f in _FIELDS:
            if f not in d:  # field newer than the checkpoint
                dt, fill = _FIELD_DEFAULTS[f]
                setattr(reg, f, np.full(reg.size, fill, dt))
                continue
            # np.array (not asarray): checkpoint restore hands back
            # read-only device-backed arrays; registry rows are mutable
            setattr(reg, f, np.array(d[f]))
        return reg

    def load_state(self, d: Dict[str, np.ndarray]) -> None:
        if int(d["size"]) != self.size:
            raise ValueError(f"registry size mismatch: checkpoint has "
                             f"{d['size']}, run has {self.size}")
        for f in _FIELDS:
            cur = getattr(self, f)
            if f not in d:
                dt, fill = _FIELD_DEFAULTS[f]
                setattr(self, f, np.full(self.size, fill, dt))
                continue
            setattr(self, f, np.array(d[f], dtype=cur.dtype))
