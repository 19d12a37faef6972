"""Mixture-of-Experts block (Qwen3-MoE / Granite-MoE style), the JAX
package's ``models/moe.py`` in PyTorch.

Two execution paths, one math:

* ``_moe_capacity`` — sort-based capacity dispatch (no [T,E,C] one-hots).
  Used for train / prefill, and for decode once ``T * top_k >= n_experts``.
  Each expert takes ``capacity(cfg, T)`` slots; the slots past it are
  dropped in token order (the latest tokens first), as in JAX.
* ``_moe_gather`` — per-token expert-weight gathering, used when
  ``T * top_k < n_experts`` (single-token decode): reads only the touched
  experts' weights.

* ``_moe_expert_parallel`` — JAX's ``_moe_shard_map`` on the port's
  meshes (``moe_block(mesh=...)``, under JAX's conditions): a rank holds
  ``n_experts / m`` whole experts of the ``"model"`` axis of ``m`` and
  its data shard of the tokens, routes them with the whole router,
  dispatches to its experts with a capacity from its own token count,
  and the partial outputs are summed over ``"model"``; the aux loss is
  the mean of the shards' over the data axes (JAX's ``pmean``, not the
  global batch's).

No Pallas kernel runs here in JAX; the per-expert SwiGLU products are
plain batched products here too.

Router: softmax gates, top-k, renormalised weights, Switch-style load-balance
auxiliary loss.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.arch_config import ArchConfig
from repro_torch.models.layers import ParamSpec

UNPORTED = ("the MoE's global path over experts split on the model axis "
            "beside tokens split on data axes (the dp_heavy layouts split "
            "the tokens over the model axis too), or over too few tokens "
            "(JAX's partitioner path), is not ported (ROADMAP queue 1 item "
            "11.8.4(c))")


def moe_specs(cfg: ArchConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", None)),
        "wi_gate": ParamSpec((e, d, ff), ("experts", "embed", "mlp")),
        "wi_up": ParamSpec((e, d, ff), ("experts", "embed", "mlp")),
        "wo": ParamSpec((e, ff, d), ("experts", "mlp", "embed")),
    }


def _route(p: dict, cfg: ArchConfig, x: torch.Tensor):
    """x: [T, d] -> (weights [T,k], idx [T,k], aux_loss scalar)."""
    logits = (x @ p["router"]).float()  # [T, E]
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(gates, cfg.top_k, dim=-1)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # Switch-style load balance: E * sum_e f_e * P_e
    e = cfg.n_experts
    assign = torch.zeros((x.shape[0], e), dtype=gates.dtype, device=x.device)
    assign.scatter_(1, idx, 1.0)
    f = torch.mean(assign, dim=0)  # fraction routed (over top-k slots)
    pe = torch.mean(gates, dim=0)
    aux = e * torch.sum(f * pe) / cfg.top_k
    return w.to(x.dtype), idx, aux


def _expert_ffn(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """buf: [E_local, C, d] -> [E_local, C, d] (per-expert SwiGLU)."""
    g = F.silu(torch.bmm(buf, p["wi_gate"]))
    u = torch.bmm(buf, p["wi_up"])
    return torch.bmm(g * u, p["wo"])


def capacity(cfg: ArchConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens, with JAX's float arithmetic."""
    return max(1, int(math.ceil(t * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)))


class Dispatch(NamedTuple):
    """Where each of the ``T * k`` (token, slot) choices goes, in the
    stable order of the local expert index (``order``)."""
    order: torch.Tensor  # [n] position in the flat (token, slot) list
    src: torch.Tensor    # [n] token of each sorted choice
    e_idx: torch.Tensor  # [n] local expert, e_local where dropped
    p_idx: torch.Tensor  # [n] slot in the expert's buffer, 0 where dropped
    valid: torch.Tensor  # [n] bool: the choice got a slot


def dispatch(cfg: ArchConfig, idx: torch.Tensor, e_start: int,
             e_local: int) -> Dispatch:
    """The sort-based capacity dispatch of ``_moe_capacity`` for expert
    choices ``idx`` [T, k]: a stable sort by local expert (the drop bucket
    ``e_local`` last), each choice's position within its expert from a
    left-side ``searchsorted``, and the choices past the capacity
    dropped."""
    t, k = idx.shape
    n = t * k
    dev = idx.device
    fe = idx.reshape(n)
    tok = torch.arange(n, device=dev) // k
    mine = (fe >= e_start) & (fe < e_start + e_local)
    le = torch.where(mine, fe - e_start, e_local)  # e_local == drop bucket
    order = torch.argsort(le, stable=True)
    le_s = le[order]
    starts = torch.searchsorted(le_s, torch.arange(e_local, device=dev))
    pos = torch.arange(n, device=dev) - starts[le_s.clamp(0, e_local - 1)]
    valid = (le_s < e_local) & (pos < capacity(cfg, t))
    return Dispatch(order, tok[order], torch.where(valid, le_s, e_local),
                    torch.where(valid, pos, 0), valid)


def _moe_capacity(p: dict, cfg: ArchConfig, x: torch.Tensor, w, idx,
                  e_start: int, e_local: int) -> torch.Tensor:
    """Sort-based capacity dispatch over the local expert slice."""
    t, d = x.shape
    k = cfg.top_k
    dp = dispatch(cfg, idx, e_start, e_local)
    buf = x.new_zeros((e_local, capacity(cfg, t), d))
    # JAX's .set(mode="drop") skips the out-of-range drop bucket; PyTorch
    # raises on it, so the dropped choices are masked out first
    buf[dp.e_idx[dp.valid], dp.p_idx[dp.valid]] = x[dp.src[dp.valid]]

    y = _expert_ffn(p, buf)  # [e_local, cap, d]
    y_tok = y[dp.e_idx.clamp(0, e_local - 1), dp.p_idx]  # [n, d]
    y_tok = y_tok * (w.reshape(-1)[dp.order] * dp.valid)[:, None]
    # back to (token, slot) order through the inverse permutation, then a
    # sum over the k slots: a fixed order, where index_add_ would sum by
    # atomics on CUDA
    flat = torch.empty_like(y_tok)
    flat[dp.order] = y_tok
    return flat.reshape(t, k, d).sum(dim=1)


def _moe_gather(p: dict, cfg: ArchConfig, x: torch.Tensor, w, idx
                ) -> torch.Tensor:
    """Tiny-T decode path: gather only the touched experts' weights."""
    wg = p["wi_gate"][idx]  # [T, k, d, ff]
    wu = p["wi_up"][idx]
    wo = p["wo"][idx]  # [T, k, ff, d]
    g = F.silu(torch.einsum("td,tkdf->tkf", x, wg))
    u = torch.einsum("td,tkdf->tkf", x, wu)
    y = torch.einsum("tkf,tkfd->tkd", g * u, wo)
    return torch.einsum("tkd,tk->td", y, w)


def moe_block(p: dict, cfg: ArchConfig, x: torch.Tensor, mesh=None,
              dp_axes: Tuple[str, ...] = ()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux loss).

    With a ``mesh`` that has a ``"model"`` axis, ``p`` is this rank's
    block (its experts whole, the router whole) and ``x`` its data shard
    over ``dp_axes``, equal on every ``"model"`` rank; the block runs
    expert-parallel where JAX's runs ``_moe_shard_map`` (the experts
    divide the axis, and the global tokens times top-k reach the expert
    count; with no ``dp_axes``, as in the federated round's client,
    whose batch is whole on every rank, the capacity and the drops are
    one device's).  Elsewhere the block runs on one device's whole
    weights and raises where its experts are split; with the tokens split
    over ``"model"`` beside the experts (``dp_axes`` holding it, the
    ``dp_heavy*`` layouts) it raises (item 11.8.4(c))."""
    from repro_torch.common import sharding as shd
    if "model" in dp_axes:
        raise NotImplementedError(f"moe_block over tokens split on the "
                                  f"model axis: {UNPORTED}")
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    t = b * s
    e = cfg.n_experts
    split = p["wi_gate"].shape[0] != e
    if mesh is not None and "model" in shd.axis_names(mesh):
        dp = tuple(a for a in dp_axes if a in shd.axis_names(mesh))
        dp_size = math.prod(shd.axis_size(mesh, a) for a in dp)
        m = shd.axis_size(mesh, "model")
        if e % m == 0 and t * dp_size * cfg.top_k >= e:
            out, aux = _moe_expert_parallel(p, cfg, x2, mesh, dp)
            return out.reshape(b, s, d), aux
        if split or dp_size > 1:
            raise NotImplementedError(f"moe_block(mesh=...) over {t} local "
                                      f"tokens: {UNPORTED}")
    elif split:
        raise NotImplementedError(f"moe_block over experts split on the "
                                  f"model axis: {UNPORTED}")
    w, idx, aux = _route(p, cfg, x2)
    if t * cfg.top_k < cfg.n_experts:
        out = _moe_gather(p, cfg, x2, w, idx)
    else:
        out = _moe_capacity(p, cfg, x2, w, idx, 0, cfg.n_experts)
    return out.reshape(b, s, d), aux


def _moe_expert_parallel(p: dict, cfg: ArchConfig, x2: torch.Tensor, mesh,
                         dp: Tuple[str, ...]):
    """JAX's ``_moe_shard_map`` on this rank: (its tokens' output summed
    over ``"model"``, the aux loss's mean over ``dp``).  The tokens and
    the router enter through ``copy_to``: each rank's gradient of them is
    its experts' share.  The aux loss is the same on every ``"model"``
    rank, so its gradient is carried at 1 / (m * |dp|) of the loss's
    (the model axis's sum and the data axes' sum of the router's gradient
    restore JAX's ``pmean``), while its value is the mean itself."""
    from repro_torch.common import sharding as shd
    m = shd.axis_size(mesh, "model")
    dp_size = math.prod(shd.axis_size(mesh, a) for a in dp)
    e_local = cfg.n_experts // m
    x2 = shd.copy_to(x2, mesh, ("model",))
    pl = dict(p, router=shd.copy_to(p["router"], mesh, ("model",)))
    w, idx, aux = _route(pl, cfg, x2)
    out = _moe_capacity(pl, cfg, x2, w, idx,
                        shd.axis_index(mesh, "model") * e_local, e_local)
    out = shd.reduce_from(out, mesh, ("model",))
    mean = aux.detach()
    if dp:
        mean = shd.all_reduce_sum(mean, mesh, dp) / dp_size
    carried = aux / (m * dp_size)
    return out, carried + (mean - carried).detach()
