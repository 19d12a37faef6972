"""Pluggable server aggregation strategies + registry.

The round engine trains all active clients into one stacked tree per
prototype group and hands the stacks to a :class:`ServerStrategy`.

Ported: ``fedavg`` (weighted parameter average), ``fedprox`` (FedAvg's
rule; the proximal term lives in the local loss), ``fedavgm`` (server
momentum) and ``feddf`` (FedAvg init + server-side ensemble
distillation, homogeneous and heterogeneous: Algorithms 1 and 3).  The
robust rules the JAX package registers raise ``NotImplementedError``
naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.common.pytree import (Pytree, tree_add, tree_scale,
                                       tree_sub, tree_weighted_mean_stacked,
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
# strategies of the JAX package that the port does not run yet
_PENDING = {"trimmed_mean": "ROADMAP.md queue 1 item 10",
            "coordinate_median": "ROADMAP.md queue 1 item 10"}


def register_strategy(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_strategy(name: str) -> ServerStrategy:
    if name in _PENDING:
        raise NotImplementedError(f"strategy {name!r} is not ported yet "
                                  f"({_PENDING[name]})")
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


def _fusion_info(info: dict) -> dict:
    """A fusion's ``info`` -> the per-group keys ``evaluate_round`` reads."""
    return {"distill_steps": info.get("steps", 0),
            "teacher_forwards": info.get("teacher_batch_forwards", 0),
            "logit_bank": info.get("logit_bank", False),
            "bank": info.get("bank_decision", ""),
            "bank_dtype": info.get("bank_dtype", ""),
            "bank_nbytes": info.get("bank_nbytes", 0),
            "teachers_filtered": 0,
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
        if ctx.heterogeneous:
            protos = [(g.net, g.stack, g.effective_weights())
                      for g in groups]
            fused, infos = feddf_mod.feddf_fuse_heterogeneous_stacked(
                protos, ctx.source, cfg.fusion, ctx.val_x, ctx.val_y,
                seed=cfg.seed + ctx.round,
                importances=[g.importance for g in groups])
            new = [g.prev_global if f is None else f
                   for g, f in zip(groups, fused)]
            return new, state, [{} if f is None else _fusion_info(info)
                                for f, info in zip(fused, infos)]
        g = groups[0]
        if g.stack is None:
            return [g.prev_global], state, [{}]
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
        return [fused], state, [{**_fusion_info(info),
                                 "pre_distill_acc": pre_acc}]
