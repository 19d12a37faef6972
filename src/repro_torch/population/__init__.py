"""Population subsystem: traffic-driven cohorts over the round engine,
host-side numpy code copied from the JAX package.

- :mod:`repro_torch.population.registry`  — struct-of-arrays client state
- :mod:`repro_torch.population.traffic`   — counter-based arrival/latency
- :mod:`repro_torch.population.scheduler` — cohort sampler registry
  (uniform / capacity_aware / prioritized sum-tree)
- :mod:`repro_torch.population.manager`   — upload buffer + virtual clock
  backing the ``buffered_async`` driver

- :mod:`repro_torch.population.faults`    — counter-based fault
  injection and the upload norm screen (docs/robustness.md)
"""
