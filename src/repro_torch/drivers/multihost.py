"""Multi-host round driver: sync semantics, client axis sharded over a
device mesh (the JAX package's ``drivers/multihost.py`` in PyTorch).

Two entry points at two scales:

* :class:`MultiHostDriver`, the experiment path.  It attaches a 1-D
  client mesh (``launch/mesh.make_client_mesh``) to the
  :class:`~repro_torch.core.engine.RoundEngine` when the engine has none,
  so the K active clients of the batched update train data-parallel over
  the world's ranks.  Every rank runs this driver on the same spec: the
  host draws are whole on every rank, each rank trains its block of
  clients and all-gathers the uploads, and the fusion runs on every rank
  on the same uploads.  After each round the ranks' globals are compared
  by digest and a difference raises: nothing is broadcast over it.
  Unbucketed homogeneous runs need K to be a multiple of the axis size;
  heterogeneous and bucketed runs pad their run-fixed client caps up to
  it.  Round semantics are exactly the sync driver's.

* :func:`drive_fed_rounds`, the model-zoo path: per round, the global
  goes to this rank's client slots of ``launch/steps.make_fed_round_step``
  over a ``("data", "model")`` (or ``("pod", "data", "model")``) mesh,
  the step runs, and the uploads' float32 mean comes from an all-reduce
  of each rank's float32 sums over the data axes, cast back to the
  parameters' dtype.  With a ``"model"`` axis > 1 each client's replica
  is tensor-parallel: a rank holds its block of the global (drawn whole
  and cut), the mean is taken blockwise, and the run ends with the
  global gathered and the ranks' digests of it compared.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.drivers.base import register_driver
from repro_torch.drivers.sync import SyncDriver


@register_driver("multihost")
class MultiHostDriver(SyncDriver):
    """Sync driver over a client-sharded mesh."""

    def __init__(self, staleness: int = 0, prefetch: int = 1, mesh=None):
        super().__init__(staleness=staleness, prefetch=prefetch)
        self._mesh = mesh

    def run(self, engine, **kw):
        if engine.mesh is None:
            from repro_torch.launch.mesh import make_client_mesh
            mesh = self._mesh if self._mesh is not None else \
                make_client_mesh()
            engine.attach_mesh(mesh, client_axis=engine.client_axis)
        hook = kw.get("round_end_hook")

        def agreed(t, globals_, state, logs, rounds_to_target):
            check_globals_agree(t, globals_)
            if hook is not None:
                hook(t, globals_, state, logs, rounds_to_target)

        kw["round_end_hook"] = agreed
        return super().run(engine, **kw)


def check_globals_agree(t: int, globals_: List[dict]) -> None:
    """Raise unless every rank holds the same globals, bit for bit."""
    from repro_torch.common.sharding import all_gather_object, tree_digest
    digests = all_gather_object([tree_digest(g) for g in globals_])
    if any(d != digests[0] for d in digests):
        raise RuntimeError(f"round {t}: the ranks' globals differ (digests "
                           f"{digests})")


def drive_fed_rounds(cfg, mesh, *, rounds: int = 2, n_clients: int = 4,
                     local_steps: int = 2, batch_size: int = 2,
                     seq_len: int = 32, lr: float = 3e-4, seed: int = 0,
                     vocab: Optional[int] = None, param_dtype=None,
                     device=None, init_params: Optional[dict] = None,
                     upload_hook: Optional[Callable] = None
                     ) -> Tuple[dict, List[dict]]:
    """The driver loop of ``make_fed_round_step`` on a mesh.

    ``cfg`` is an :class:`~repro_torch.common.arch_config.ArchConfig`;
    the step is built once and reused every round.  The global starts
    from ``init_params`` (any device; e.g. the JAX package's init) or
    from ``T.init`` with a CPU generator seeded ``seed``, on ``device``:
    by default this rank's, or outside a world the card (raising without
    one; the CPU must be asked for); with a ``"model"`` axis > 1 each
    rank keeps its block of it.  Every round's tokens are drawn whole
    from ``default_rng(seed)`` on every rank, as the one-device loop draws
    them, and sliced to this rank's clients.  ``upload_hook(t, clients,
    stack)`` sees each round's uploads of this rank's clients (global
    indices; whole leaves, gathered over ``"model"``) before the mean.
    Returns ``(final global params, per-round stats)``: ``update_norm``
    (the global update's L2 norm, as JAX's: a leaf split over ``"model"``
    summed over it, a whole one counted once), ``round_s``, the mean's
    all-reduce ``all_reduce_bytes`` and ``all_reduce_s``, and
    ``peak_mem_bytes`` on a card.  With a ``"model"`` axis > 1 the final
    global is gathered, and the ranks' digests of it must agree."""
    from repro_torch.api.experiment import resolve_device
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.steps import make_fed_round_step
    from repro_torch.models import transformer as T

    if param_dtype is None:
        param_dtype = torch.float32
    if device is None:
        device = mesh_mod._WORLD["device"] or "cuda"
    device = resolve_device(device)
    bundle = make_fed_round_step(cfg, mesh, n_clients=n_clients,
                                 local_steps=local_steps,
                                 batch_size=batch_size, seq_len=seq_len,
                                 lr=lr, param_dtype=param_dtype)
    tp = bundle.layout
    if init_params is None:
        init_params = T.init(cfg, torch.Generator().manual_seed(seed),
                             param_dtype)
    params = tree_map(lambda x: torch.as_tensor(x).to(device, param_dtype),
                      init_params)
    if tp is not None:
        params = shd.shard_tree(params, tp.pspecs, mesh)
    block = bundle.client_slice
    k_local = block.stop - block.start
    v = vocab if vocab is not None else cfg.vocab_size
    rng = np.random.default_rng(seed)
    stats: List[dict] = []
    for t in range(1, rounds + 1):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        # the global, broadcast to this rank's client slots
        stacked = tree_map(lambda p: p.unsqueeze(0).expand(
            (k_local,) + tuple(p.shape)).clone(), params)
        toks = rng.integers(0, v, (n_clients, local_steps, batch_size,
                                   seq_len), dtype=np.int32)
        mine = torch.from_numpy(np.ascontiguousarray(toks[block])).to(device)
        stacked = bundle.fn(stacked, {"tokens": mine, "labels": mine})
        if upload_hook is not None:
            upload_hook(t, list(range(block.start, block.stop)),
                        stacked if tp is None else shd.gather_tree(
                            stacked, shd.stacked_specs(tp.pspecs), mesh))
        reduced = {"bytes": 0, "s": 0.0}

        def mean(s):
            total = s.float().sum(dim=0)
            if bundle.client_axes:
                t1 = time.perf_counter()
                total = shd.all_reduce_sum(total, mesh, bundle.client_axes)
                reduced["s"] += time.perf_counter() - t1
                reduced["bytes"] += total.numel() * total.element_size()
            return (total / n_clients).to(s.dtype)

        new = tree_map(mean, stacked)
        del stacked
        sq = _update_sq(new, params, tp)
        params = new
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats.append({
            "round": t, "update_norm": sq ** 0.5,
            "round_s": time.perf_counter() - t0,
            "all_reduce_bytes": reduced["bytes"],
            "all_reduce_s": reduced["s"],
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else 0)})
    if tp is not None:
        params = shd.gather_tree(params, tp.pspecs, mesh)
        digests = shd.all_gather_object(shd.tree_digest(params))
        if any(d != digests[0] for d in digests):
            raise RuntimeError(f"the ranks' gathered globals differ "
                               f"(digests {digests})")
    return params, stats


def _update_sq(new: dict, old: dict, tp) -> float:
    """The global squared L2 norm of ``new - old`` (trees of this rank's
    blocks under ``tp``, or whole): the parts split over ``"model"``
    summed over it, the parts whole on every rank counted once."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves
    if tp is None:
        return sum(float(((a.float() - b.float()) ** 2).sum())
                   for a, b in zip(tree_leaves(new), tree_leaves(old)))
    split, whole = [], []

    def one(spec, a, b):
        d2 = (a.float() - b.float()) ** 2
        for dim, entry in enumerate(spec):
            if isinstance(entry, shd.Segmented):
                m = shd.axis_size(tp.mesh, entry.axis)
                sizes = [n // m if cut else n
                         for n, cut in zip(entry.sizes, entry.split)]
                for part, cut in zip(torch.split(d2, sizes, dim=dim),
                                     entry.split):
                    (split if cut else whole).append(part.sum())
                return
            if entry is not None:
                split.append(d2.sum())
                return
        whole.append(d2.sum())
    shd.map_specs(one, tp.pspecs, new, old)
    zero = torch.zeros((), device=tree_leaves(new)[0].device)
    total = shd.all_reduce_sum(sum(split, zero), tp.mesh,
                               (tp.model_axis,))
    return float(total + sum(whole, zero))
