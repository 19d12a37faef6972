"""Deterministic, counter-based traffic model for the client population.

Every draw is keyed on ``(salt, seed, domain, wave)`` through
``np.random.default_rng``'s SeedSequence, so the trace is a pure function
of (config, seed): there is no sequential RNG state to checkpoint, no
replay on resume, and wave ``w``'s arrivals/latencies/dropouts are
identical whether the run reached ``w`` in one go or through five
resumes.

Static per-client character (a lognormal speed multiplier and a
persistent straggler flag) is drawn once from the ``static`` domain;
per-wave noise (online mask, upload jitter, dropout) comes from
wave-indexed domains.
"""
from __future__ import annotations

import numpy as np

from repro_torch.population.config import TrafficConfig

_SALT = 0x5EEDFEED
_DOMAINS = {"static": 0, "online": 1, "upload": 2}


class TrafficModel:
    """Arrival / latency / dropout draws for ``n`` registered clients."""

    def __init__(self, cfg: TrafficConfig, seed: int, n: int):
        cfg.validate()
        self.cfg = cfg
        self.seed = int(seed)
        self.n = int(n)
        rng = self._rng("static")
        self.speed = (np.exp(rng.normal(0.0, cfg.jitter, self.n))
                      if cfg.jitter > 0 else np.ones(self.n))
        self.straggler = (rng.random(self.n) < cfg.straggler_frac
                          if cfg.straggler_frac > 0
                          else np.zeros(self.n, np.bool_))
        mult = np.where(self.straggler, cfg.straggler_mult, 1.0)
        self.base_latency = (cfg.latency * self.speed * mult).astype(
            np.float64)

    def _rng(self, domain: str, wave: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            (_SALT, self.seed, _DOMAINS[domain], int(wave)))

    def online_mask(self, wave: int) -> np.ndarray:
        """Boolean [n]: which clients are reachable for wave ``wave``."""
        if self.cfg.arrival == "always":
            return np.ones(self.n, np.bool_)
        return self._rng("online", wave).random(self.n) < self.cfg.rate

    def upload_draws(self, wave: int, clients: np.ndarray):
        """Latency and dropout draws for one dispatched cohort.

        Returns ``(latency[float64 k], dropped[bool k])`` aligned with
        ``clients``.  Deterministic given (seed, wave, cohort order).
        """
        clients = np.asarray(clients)
        k = len(clients)
        rng = self._rng("upload", wave)
        lat = self.base_latency[clients].copy()
        if self.cfg.jitter > 0:
            lat *= np.exp(rng.normal(0.0, self.cfg.jitter, k))
        dropped = (rng.random(k) < self.cfg.dropout
                   if self.cfg.dropout > 0 else np.zeros(k, np.bool_))
        return lat, dropped
