"""Pluggable server aggregation strategies + registry.

The round engine trains all active clients into one stacked tree per
prototype group and hands the stacks to a :class:`ServerStrategy`.

Every rule of the JAX package's registry: ``fedavg`` (weighted
parameter average), ``fedprox`` (FedAvg's rule; the proximal term lives
in the local loss), ``trimmed_mean`` and ``coordinate_median`` (the
per-coordinate robust rules of docs/robustness.md), ``fedavgm`` (server
momentum) and ``feddf`` (FedAvg init + server-side ensemble
distillation, homogeneous and heterogeneous: Algorithms 1 and 3), with
its teacher-consensus filter in front when the fault config asks for it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import (Pytree, tree_add,
                                       tree_coordinate_median_stacked,
                                       tree_leading_dim, tree_leaves,
                                       tree_scale, tree_sub, tree_take,
                                       tree_trimmed_mean_stacked,
                                       tree_weighted_mean_stacked,
                                       tree_zeros_like)
from repro_torch.core.client import evaluate
from repro_torch.core.nets import Net


@dataclasses.dataclass
class GroupRound:
    """One prototype group's view of a round: the clients' locally
    trained params stacked on a leading [K_g] axis, plus their data
    weights."""

    net: Net
    prev_global: dict
    stack: Optional[Pytree]      # [K_g, ...]; None if no client this round
    weights: np.ndarray          # [K_g] local dataset sizes
    # FedAsync staleness importance (1+s)^-a per client, set by the
    # buffered_async driver; None (every sync round, and every buffered
    # round whose uploads are all fresh) keeps the plain aggregation
    importance: Optional[np.ndarray] = None

    def effective_weights(self) -> np.ndarray:
        """Data weights scaled by staleness importance (if any)."""
        if self.importance is None:
            return self.weights
        return (np.asarray(self.weights, np.float64)
                * np.asarray(self.importance, np.float64))


@dataclasses.dataclass
class RoundContext:
    """Server-side context a strategy may consume when aggregating."""

    cfg: Any                     # FLConfig
    round: int
    heterogeneous: bool
    source: Any = None
    val_x: Any = None
    val_y: Any = None
    test_x: Any = None
    test_y: Any = None
    swag_draws: Any = None       # a caller's SWAG draws (core/swag.py)
    filter_probe: Any = None     # a caller's teacher-filter probe batches


# fn(seed, n) -> the teacher filter's [n, ...] probe inputs (numpy or
# torch), in place of ``source.sample`` from a CPU generator
FilterProbe = Callable[[int, int], Any]


class ServerStrategy:
    """Interface: consume stacked client trees, emit new globals
    ``(new globals per group, new server state, per-group info dicts)``."""

    name: str = "base"
    needs_source: bool = False

    def local_prox_mu(self, cfg) -> float:
        return 0.0

    def init_state(self, globals_: List[dict]):
        return None

    def aggregate(self, groups: List[GroupRound], state, ctx: RoundContext
                  ) -> Tuple[List[dict], Any, List[dict]]:
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[[], ServerStrategy]] = {}


def register_strategy(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> ServerStrategy:
    if name not in _REGISTRY:
        raise ValueError(f"unknown strategy {name!r}; registered: "
                         f"{available_strategies()}")
    return _REGISTRY[name]()


def available_strategies() -> List[str]:
    return sorted(_REGISTRY)


@register_strategy("fedavg")
class FedAvg(ServerStrategy):
    def aggregate(self, groups, state, ctx):
        new = [g.prev_global if g.stack is None
               else tree_weighted_mean_stacked(g.stack,
                                               g.effective_weights())
               for g in groups]
        return new, state, [{} for _ in groups]


@register_strategy("fedprox")
class FedProx(FedAvg):
    """Identical server rule; the proximal term lives in the local loss."""

    def local_prox_mu(self, cfg) -> float:
        return cfg.prox_mu


@register_strategy("trimmed_mean")
class TrimmedMean(ServerStrategy):
    """Per-coordinate trimmed weighted mean (docs/robustness.md):
    ``cfg.trim_frac`` of the client axis is trimmed from each side of
    every coordinate's sorted values, clamped to ``(K-1)//2`` so one value
    survives; ``trim_frac == 0`` is fedavg bit for bit."""

    def aggregate(self, groups, state, ctx):
        frac = float(ctx.cfg.trim_frac)
        new = []
        for g in groups:
            if g.stack is None:
                new.append(g.prev_global)
                continue
            k = tree_leading_dim(g.stack)
            trim = min(int(frac * k), (k - 1) // 2)
            new.append(tree_trimmed_mean_stacked(
                g.stack, g.effective_weights(), trim))
        return new, state, [{} for _ in groups]


@register_strategy("coordinate_median")
class CoordinateMedian(ServerStrategy):
    """Per-coordinate weighted median: tolerates ``(K-1)//2`` corrupted
    uploads per coordinate, at the cost of averaging's variance
    reduction (docs/robustness.md)."""

    def aggregate(self, groups, state, ctx):
        new = [g.prev_global if g.stack is None
               else tree_coordinate_median_stacked(g.stack,
                                                   g.effective_weights())
               for g in groups]
        return new, state, [{} for _ in groups]


@register_strategy("fedavgm")
class FedAvgM(ServerStrategy):
    """dv = beta v + dx ; x = x - dv   (dx = x_old - avg), per group."""

    def init_state(self, globals_):
        return [None] * len(globals_)

    def aggregate(self, groups, state, ctx):
        beta = ctx.cfg.server_momentum
        new, bufs = [], list(state)
        for gi, g in enumerate(groups):
            if g.stack is None:
                new.append(g.prev_global)
                continue
            avg = tree_weighted_mean_stacked(g.stack,
                                             g.effective_weights())
            dx = tree_sub(g.prev_global, avg)
            buf = tree_zeros_like(dx) if bufs[gi] is None else bufs[gi]
            buf = tree_add(tree_scale(buf, beta), dx)
            bufs[gi] = buf
            new.append(tree_sub(g.prev_global, buf))
        return new, bufs, [{} for _ in groups]


def _probe_batch(ctx: RoundContext, n: int, device) -> torch.Tensor:
    """The teacher filter's probe inputs for this round.  The JAX package
    samples ``n`` rows from the source with ``PRNGKey(seed + 7919 (round +
    1))``; the port draws them from a CPU generator seeded the same way,
    or takes them from ``ctx.filter_probe``."""
    seed = ctx.cfg.seed + 7919 * (ctx.round + 1)
    if ctx.filter_probe is not None:
        x = torch.as_tensor(np.array(ctx.filter_probe(seed, n)))
    else:
        x = ctx.source.sample(torch.Generator().manual_seed(seed), n)
    return x.to(device)


def _filter_teachers(groups: List[GroupRound], ctx: RoundContext
                     ) -> Tuple[List[GroupRound], List[int]]:
    """FedDF teacher-consensus defense: drop non-finite / divergent
    teachers from each group's stack BEFORE the student init and the
    logit-bank rows are computed.  Active only when ``cfg.faults`` asks
    for it, so fault-free configs never pay the probe forward."""
    from repro_torch.core import feddf as feddf_mod
    faults = ctx.cfg.faults
    if not faults.teacher_filter_active:
        return groups, [0] * len(groups)
    probe_n = min(64, int(ctx.cfg.fusion.batch_size))
    probe_x = None
    out, dropped = [], []
    for g in groups:
        if g.stack is None:
            out.append(g)
            dropped.append(0)
            continue
        if probe_x is None:
            probe_x = _probe_batch(ctx, probe_n,
                                   tree_leaves(g.stack)[0].device)
        kept, n_drop = feddf_mod.filter_teacher_stack(
            g.net, g.stack, probe_x, sigma=faults.teacher_sigma)
        if n_drop == 0:
            out.append(g)
        elif kept.size == 0:
            # every teacher poisoned: skip this group's fusion entirely
            out.append(dataclasses.replace(g, stack=None))
        else:
            out.append(dataclasses.replace(
                g, stack=tree_take(g.stack, kept),
                weights=np.asarray(g.weights)[kept],
                importance=(None if g.importance is None
                            else np.asarray(g.importance)[kept])))
        dropped.append(n_drop)
    return out, dropped


def _fusion_info(info: dict, n_filtered: int = 0) -> dict:
    """A fusion's ``info`` -> the per-group keys ``evaluate_round`` reads."""
    return {"distill_steps": info.get("steps", 0),
            "teacher_forwards": info.get("teacher_batch_forwards", 0),
            "logit_bank": info.get("logit_bank", False),
            "bank": info.get("bank_decision", ""),
            "bank_dtype": info.get("bank_dtype", ""),
            "bank_nbytes": info.get("bank_nbytes", 0),
            "teachers_filtered": n_filtered,
            "diverged": info.get("diverged", False)}


@register_strategy("feddf")
class FedDF(ServerStrategy):
    """Ensemble distillation fusion.  Homogeneous (Algorithm 1): one group,
    its own stack as teachers.  Heterogeneous (Algorithm 3): every group
    distils against the ALL-groups teacher ensemble."""

    needs_source = True

    def aggregate(self, groups, state, ctx):
        from repro_torch.core import feddf as feddf_mod
        cfg = ctx.cfg
        if ctx.source is None:
            raise ValueError("FedDF needs a distillation source")
        groups, n_filtered = _filter_teachers(groups, ctx)
        if ctx.heterogeneous:
            protos = [(g.net, g.stack, g.effective_weights())
                      for g in groups]
            fused, infos = feddf_mod.feddf_fuse_heterogeneous_stacked(
                protos, ctx.source, cfg.fusion, ctx.val_x, ctx.val_y,
                seed=cfg.seed + ctx.round,
                importances=[g.importance for g in groups])
            new = [g.prev_global if f is None else f
                   for g, f in zip(groups, fused)]
            return new, state, [
                ({"teachers_filtered": nf} if nf else {}) if f is None
                else _fusion_info(info, nf)
                for f, info, nf in zip(fused, infos, n_filtered)]
        g = groups[0]
        if g.stack is None:
            return [g.prev_global], state, [
                {"teachers_filtered": n_filtered[0]} if n_filtered[0]
                else {}]
        w_eff = g.effective_weights()
        avg = tree_weighted_mean_stacked(g.stack, w_eff)
        pre_acc = (evaluate(g.net, avg, ctx.test_x, ctx.test_y)
                   if ctx.test_x is not None else None)
        student = avg if cfg.feddf_init_from == "average" else g.prev_global
        fused, info = feddf_mod.feddf_fuse_stacked(
            g.net, g.stack, w_eff, ctx.source, cfg.fusion,
            ctx.val_x, ctx.val_y, seed=cfg.seed + ctx.round,
            student=student, teacher_weights=g.importance,
            swag_draws=ctx.swag_draws)
        return [fused], state, [{**_fusion_info(info, n_filtered[0]),
                                 "pre_distill_acc": pre_acc}]
