"""Population manager: wave dispatch, upload buffer, virtual clock.

Glue between the traffic model, the client registry, the cohort sampler
and the buffered-async driver.  Time is *virtual*: waves are dispatched
at the current clock, each upload becomes ready ``latency`` seconds
later, and consuming an upload advances the clock to its ready time —
so a trace is fully deterministic and independent of wall time.

The buffer is a min-heap ordered by ``(ready, seq)``: FedBuff-style
aggregation pops the M earliest-ready uploads; anything staler than
``max_staleness`` rounds at pop time is dropped (with telemetry) rather
than fused.  ``state_dict`` / ``load_state`` capture the whole manager
state (registry arrays, clock, wave / sequence counters, the fault
counters, the ``NormScreen``'s rolling window and the pending heap,
client params included); it rides in the buffered-async driver's round
checkpoint (``api/experiment.py``), so a resumed run replays the exact
same schedule.  Pending params come back from a checkpoint as numpy
arrays; the driver moves them onto its device.

A copy of the JAX package's manager with its pytree operations on the
port's trees.  With an enabled ``FaultConfig`` every upload crosses to
host numpy (in the JAX package's leaf order) for injection and
screening, and only an upload a fault touched is rebuilt on the device.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.common.pytree import (tree_check_like, tree_leaves_jax,
                                       tree_map, tree_take,
                                       tree_unflatten_jax)
from repro_torch.population.config import FaultConfig, PopulationConfig
from repro_torch.population.registry import ClientRegistry
from repro_torch.population.scheduler import CohortSampler
from repro_torch.population.traffic import TrafficModel


@dataclasses.dataclass(frozen=True)
class _LeafSpec:
    """Shape and dtype of one expected upload leaf (a leaf of the tree
    helpers, which walk tuples)."""
    shape: tuple
    dtype: Any


_UPLOAD_FIELDS = ("client", "part", "proto", "wave", "base_version",
                  "ready", "seq", "latency", "weight", "attempt")

# Upload fields absent from older snapshots load with these defaults.
_UPLOAD_DEFAULTS = {"attempt": 0}


@dataclasses.dataclass
class Upload:
    """One client's trained parameters in flight to the server."""
    client: int         # population id
    part: int           # data partition backing the client
    proto: int          # prototype group
    wave: int           # dispatch wave (also the batch-seed round index)
    base_version: int   # completed fusions when the wave was dispatched
    ready: float        # virtual arrival time
    seq: int            # tie-break / FIFO order
    latency: float      # drawn upload latency
    weight: float       # aggregation weight (client data size)
    params: Any         # [1, ...] stacked-tree slice of trained params
    attempt: int = 0    # retry count that produced this upload

    def to_dict(self) -> Dict[str, Any]:
        d = {f: getattr(self, f) for f in _UPLOAD_FIELDS}
        d["params"] = self.params
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Upload":
        kw = {f: d.get(f, _UPLOAD_DEFAULTS.get(f)) for f in _UPLOAD_FIELDS}
        for f in ("client", "part", "proto", "wave", "base_version", "seq",
                  "attempt"):
            kw[f] = int(kw[f])
        kw["ready"] = float(kw["ready"])
        kw["latency"] = float(kw["latency"])
        kw["weight"] = float(kw["weight"])
        return cls(params=d["params"], **kw)


class PopulationManager:
    """Traffic-driven upload production/consumption over a population."""

    def __init__(self, cfg: PopulationConfig, *, seed: int,
                 n_partitions: int, partition_sizes: Sequence[int],
                 client_steps: Sequence[int], client_proto: Sequence[int],
                 client_bucket: Sequence[int], n_active: int,
                 sampler: CohortSampler,
                 faults: Optional[FaultConfig] = None):
        cfg.validate()
        self.cfg = cfg
        self.size = int(cfg.size or n_partitions)
        self.registry = ClientRegistry(self.size, partition_sizes,
                                       client_steps, client_proto,
                                       client_bucket)
        self.traffic = TrafficModel(cfg.traffic, seed, self.size)
        self.sampler = sampler
        self.n_active = int(n_active)
        self.buffer_size = int(cfg.buffer_size or n_active)
        self.clock = 0.0
        self.wave = 0          # last dispatched wave index
        self.seq = 0           # monotone upload counter
        self._heap: List[Tuple[float, int, Upload]] = []
        # telemetry accumulated between pops
        self._dropped_since = 0
        self._stale_since = 0
        # fault injection + screening (docs/robustness.md); both stay None
        # for fault-free configs so push_wave is the fault-free path
        self.faults = faults if faults is not None and faults.enabled \
            else None
        self.fault_model = None
        self.screen = None
        if self.faults is not None:
            from repro_torch.population.faults import FaultModel, NormScreen
            self.fault_model = FaultModel(self.faults, seed, self.size)
            if self.faults.screen_active:
                self.screen = NormScreen(sigma=self.faults.norm_sigma)
        self._corrupted_since = 0
        self._quarantined_since = 0
        self._retries_since = 0
        self._upload_spec: Dict[int, Any] = {}

    # -- dispatch --------------------------------------------------------

    def available(self, wave: int) -> Optional[np.ndarray]:
        """Reachable, not-in-flight clients for ``wave``.

        Returns ``None`` when *every* client is available, so the uniform
        sampler can take its bit-identical historic ``rng.choice(N, k)``
        path.
        """
        online = self.traffic.online_mask(wave)
        free = online & ~self.registry.in_flight
        if free.all():
            return None
        return np.flatnonzero(free)

    def next_wave(self, rng: np.random.Generator):
        """Draw and dispatch the next cohort; returns ``(wave, cohort)``."""
        w = self.wave + 1
        cohort = self.sampler.sample(rng, self.n_active,
                                     available=self.available(w), tick=w)
        if len(cohort) == 0:
            raise RuntimeError(
                f"wave {w}: no clients available to dispatch "
                f"(population={self.size}, in-flight="
                f"{int(self.registry.in_flight.sum())}); grow the "
                f"population or lower the traffic dropout/arrival skew")
        self.wave = w
        self.registry.record_dispatch(cohort, w)
        return w, cohort

    def _check_upload(self, p: int, g, params) -> None:
        """Wire-safety: the upload's tree must match the prototype's
        expected [1, ...]-stacked structure (shapes, dtypes, leaf paths).
        Metadata-only, no trajectory effect."""
        ref = self._upload_spec.get(p)
        if ref is None:
            # the [K, ...] trained stack defines the prototype's wire
            # contract: every upload must be a [1, ...] slice of it
            ref = tree_map(lambda x: _LeafSpec((1,) + tuple(x.shape[1:]),
                                               x.dtype), g.stack)
            self._upload_spec[p] = ref
        tree_check_like(params, ref, what=f"proto {p} upload")

    def _inject_and_screen(self, wave: int, c: int, p: int, g, params):
        """Fault seam for one upload: corrupt, screen, retry.

        Returns ``(params, attempt, backoff_delay)`` for an accepted
        upload, or ``None`` when every attempt was rejected (the client is
        quarantined).  Counter-based draws keyed on (wave, client,
        attempt) mean a resumed trace corrupts identically and a retry
        redraws only the transport faults; byzantine clients fail every
        attempt and sink in the sampler.
        """
        from repro_torch.population.faults import delta_norm, leaves_finite
        flat = tree_leaves_jax(params)
        clean = [l[0].detach().cpu().numpy() for l in flat]
        base = [l.detach().cpu().numpy()
                for l in tree_leaves_jax(g.prev_global)]
        faults = self.faults
        for attempt in range(faults.retries + 1):
            if attempt > 0:
                self._retries_since += 1
            row, kinds = self.fault_model.corrupt(wave, c, clean, base,
                                                  attempt=attempt)
            if attempt == 0 and kinds:
                self._corrupted_since += 1
            if self.screen is not None:
                if not leaves_finite(row):
                    continue
                ok, _ = self.screen.check(p, delta_norm(row, base))
                if not ok:
                    continue
            if kinds:
                params = tree_unflatten_jax(params, [
                    torch.from_numpy(np.ascontiguousarray(r[None])).to(
                        l.device) for r, l in zip(row, flat)])
            # exponential backoff: attempt k re-arrives backoff^k virtual
            # seconds later than the clean upload would have
            delay = (faults.backoff ** attempt) - 1.0 if attempt else 0.0
            return params, attempt, delay
        self.registry.record_quarantine([c])
        self.sampler.penalize([c], float(self.registry.priority[c]))
        self._quarantined_since += 1
        return None

    def push_wave(self, wave: int, cohort: np.ndarray, groups,
                  base_version: int) -> int:
        """Split trained group stacks into per-client buffered uploads.

        ``groups[p].stack`` rows are in cohort order filtered by
        prototype (the engine's ``ks`` order), so a per-proto cursor
        recovers each client's row.  Each upload is structure-validated
        against its prototype, then (when faults are configured) run
        through the inject/screen/retry seam: rejected uploads quarantine
        their client instead of entering the buffer.  Returns the number
        of uploads buffered.
        """
        latency, dropped = self.traffic.upload_draws(wave, cohort)
        cursor = [0] * len(groups)
        pushed = 0
        for j, c in enumerate(cohort):
            c = int(c)
            p = int(self.registry.proto[c])
            row = cursor[p]
            cursor[p] += 1
            if dropped[j]:
                self.registry.record_dropout([c])
                self._dropped_since += 1
                continue
            g = groups[p]
            params = tree_take(g.stack, np.asarray([row]))
            self._check_upload(p, g, params)
            attempt, delay = 0, 0.0
            if self.fault_model is not None:
                res = self._inject_and_screen(wave, c, p, g, params)
                if res is None:
                    continue
                params, attempt, delay = res
            self.seq += 1
            up = Upload(client=c, part=int(self.registry.partition[c]),
                        proto=p, wave=wave, base_version=int(base_version),
                        ready=self.clock + float(latency[j]) + delay,
                        seq=self.seq, latency=float(latency[j]),
                        weight=float(g.weights[row]), params=params,
                        attempt=attempt)
            heapq.heappush(self._heap, (up.ready, up.seq, up))
            pushed += 1
        return pushed

    # -- consumption -----------------------------------------------------

    def _staleness(self, up: Upload, t: int) -> int:
        return (t - 1) - up.base_version

    def usable_pending(self, t: int) -> int:
        """Buffered uploads that would survive the staleness cut at t."""
        s_max = self.cfg.max_staleness
        return sum(1 for _, _, up in self._heap
                   if self._staleness(up, t) <= s_max)

    def pop(self, t: int, m: int):
        """Consume the M earliest-ready usable uploads for round ``t``.

        Advances the virtual clock to the latest arrival consumed (stale
        discards also arrived, so they advance it too).  Returns
        ``(uploads, telemetry)`` where ``uploads`` is a list of
        ``(Upload, staleness)`` and ``telemetry`` feeds ``RoundLog``.
        """
        s_max = self.cfg.max_staleness
        out: List[Tuple[Upload, int]] = []
        hist = [0] * (s_max + 1)
        while len(out) < m and self._heap:
            ready, _, up = heapq.heappop(self._heap)
            self.clock = max(self.clock, ready)
            s = self._staleness(up, t)
            if s > s_max:
                self.registry.record_stale_drop([up.client])
                self._stale_since += 1
                continue
            self.registry.record_upload([up.client], up.latency, s)
            self.sampler.observe([up.client], s)
            hist[s] += 1
            out.append((up, s))
        if len(out) < m:
            raise RuntimeError(
                f"round {t}: buffer underflow ({len(out)}/{m} usable "
                f"uploads) — caller must fill until usable_pending >= M")
        a = self.cfg.staleness_exponent
        tele = {
            "staleness_hist": hist,
            "buffer_fill": sum(1 for r, _, _ in self._heap
                               if r <= self.clock),
            "n_straggling": sum(1 for r, _, _ in self._heap
                                if r > self.clock),
            "n_dropped_uploads": self._dropped_since,
            "n_stale_dropped": self._stale_since,
            "eff_participants": float(sum((1.0 + s) ** (-a)
                                          for _, s in out)),
        }
        tele.update(self.fault_counters(reset=True))
        self._dropped_since = 0
        self._stale_since = 0
        return out, tele

    def fault_counters(self, reset: bool = False) -> Dict[str, int]:
        """Fault telemetry accumulated since the last reset (fed into
        ``RoundLog`` by the buffered-async driver)."""
        d = {"n_corrupted": self._corrupted_since,
             "n_quarantined": self._quarantined_since,
             "n_retries": self._retries_since}
        if reset:
            self._corrupted_since = 0
            self._quarantined_since = 0
            self._retries_since = 0
        return d

    def regroup(self, uploads) -> Dict[int, Dict[str, list]]:
        """Bucket consumed uploads by prototype, preserving pop order."""
        per: Dict[int, Dict[str, list]] = {}
        for up, s in uploads:
            e = per.setdefault(up.proto, {"params": [], "weights": [],
                                          "staleness": [], "clients": []})
            e["params"].append(up.params)
            e["weights"].append(up.weight)
            e["staleness"].append(s)
            e["clients"].append(up.client)
        return per

    # -- checkpointing ---------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        d = {
            "registry": self.registry.state_dict(),
            "clock": float(self.clock),
            "wave": int(self.wave),
            "seq": int(self.seq),
            "dropped_since": int(self._dropped_since),
            "stale_since": int(self._stale_since),
            "corrupted_since": int(self._corrupted_since),
            "quarantined_since": int(self._quarantined_since),
            "retries_since": int(self._retries_since),
            "pending": [up.to_dict()
                        for _, _, up in sorted(self._heap,
                                               key=lambda e: e[:2])],
        }
        if self.screen is not None:
            d["screen"] = self.screen.state_dict()
        return d

    def load_state(self, d: Dict[str, Any]) -> None:
        self.registry.load_state(d["registry"])
        self.clock = float(d["clock"])
        self.wave = int(d["wave"])
        self.seq = int(d["seq"])
        self._dropped_since = int(d["dropped_since"])
        self._stale_since = int(d["stale_since"])
        # fault counters / screen state: absent from older snapshots
        self._corrupted_since = int(d.get("corrupted_since", 0))
        self._quarantined_since = int(d.get("quarantined_since", 0))
        self._retries_since = int(d.get("retries_since", 0))
        if self.screen is not None and "screen" in d:
            self.screen.load_state(d["screen"])
        self._heap = []
        for entry in d["pending"]:
            up = Upload.from_dict(entry)
            heapq.heappush(self._heap, (up.ready, up.seq, up))
        self.sampler.load_priorities(self.registry.priority)
