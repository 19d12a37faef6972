"""The flat entry points over the round engine and the ``sync`` driver:
``run_federated`` (homogeneous, Algorithm 1) and
``run_federated_heterogeneous`` (Algorithm 3), with the JAX package's
signatures; ``run_rounds`` also takes its ``mesh`` / ``client_axis``
(``launch/mesh.py``) and ``driver``.

``device`` defaults to ``"cuda"`` and raises without a CUDA device unless
the caller asks for ``"cpu"``; ``init_globals`` replaces the run's own
initialisation (one tree per prototype, on any device)."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.pytree import tree_to
from repro_torch.core.engine import FLConfig, FLResult, RoundEngine, RoundLog
from repro_torch.core.nets import Net
from repro_torch.data.distill_sources import DistillSource
from repro_torch.data.synthetic import Dataset

__all__ = ["FLConfig", "FLResult", "RoundLog", "run_federated",
           "run_federated_heterogeneous", "run_rounds"]


def run_rounds(nets: List[Net], client_proto: Sequence[int], train: Dataset,
               parts: Sequence[np.ndarray], val: Dataset, test: Dataset,
               cfg: FLConfig, *, source: Optional[DistillSource] = None,
               log_fn: Optional[Callable] = None,
               heterogeneous: bool = False, device="cuda",
               init_globals: Optional[List[dict]] = None, mesh=None,
               client_axis: str = "data", driver=None
               ) -> Tuple[List[FLResult], List[dict], Optional[int]]:
    """The shared round loop.  Returns ``(per-prototype results, final
    globals, rounds_to_target)``.  ``log_fn`` receives a ``RoundLog``
    (homogeneous) or ``(group, RoundLog)`` (heterogeneous).  ``mesh``
    shards the client axis of local training over ``client_axis``;
    ``driver`` is a registered name, a driver instance, or None for
    ``sync``."""
    from repro_torch.api.experiment import resolve_device
    from repro_torch.drivers import Driver, make_driver
    dev = resolve_device(device)
    engine = RoundEngine(nets, client_proto, train, parts, val, test, cfg,
                         source=source, heterogeneous=heterogeneous,
                         device=dev, mesh=mesh, client_axis=client_axis)
    if init_globals is not None:
        init_globals = [tree_to(g, dev) for g in init_globals]
    drv = driver if isinstance(driver, Driver) else \
        make_driver(driver or "sync")
    return drv.run(engine, init_globals=init_globals, log_fn=log_fn)


def run_federated(net: Net, train: Dataset, parts: Sequence[np.ndarray],
                  val: Dataset, test: Dataset, cfg: FLConfig,
                  source: Optional[DistillSource] = None,
                  log_fn: Optional[Callable[[RoundLog], None]] = None, *,
                  device="cuda", init_globals: Optional[dict] = None
                  ) -> FLResult:
    """Homogeneous FL (Algorithm 1)."""
    results, _, rounds_to_target = run_rounds(
        [net], [0] * len(parts), train, parts, val, test, cfg,
        source=source, log_fn=log_fn, heterogeneous=False, device=device,
        init_globals=None if init_globals is None else [init_globals])
    return dataclasses.replace(results[0], rounds_to_target=rounds_to_target)


def run_federated_heterogeneous(
        nets: List[Net], client_proto: Sequence[int], train: Dataset,
        parts: Sequence[np.ndarray], val: Dataset, test: Dataset,
        cfg: FLConfig, source: Optional[DistillSource] = None, log_fn=None,
        *, device="cuda", init_globals: Optional[List[dict]] = None
) -> Tuple[List[FLResult], List[dict]]:
    """Heterogeneous FL (Algorithm 3).  ``strategy='fedavg'`` averages
    within each prototype group only (paper Fig. 4's dashed lines);
    ``'feddf'`` fuses each group against the all-groups ensemble."""
    results, globals_, _ = run_rounds(
        nets, client_proto, train, parts, val, test, cfg, source=source,
        log_fn=log_fn, heterogeneous=True, device=device,
        init_globals=init_globals)
    return results, globals_
