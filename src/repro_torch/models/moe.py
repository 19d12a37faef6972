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

Two routes on the port's meshes, as JAX's ``moe_block`` takes them:

* ``_moe_expert_parallel`` — JAX's ``_moe_shard_map``
  (``moe_block(mesh=...)``, under JAX's conditions): a rank holds
  ``n_experts / m`` whole experts of the ``"model"`` axis of ``m`` and
  the tokens of its data shard (JAX's ``dp_axes``; under the
  ``dp_heavy*`` layouts, whose batch splits over ``"model"`` too, the
  rank's rows all-gathered over ``"model"``), routes them with the whole
  router, dispatches to its experts with a capacity from the shard's
  token count, and the partial outputs are summed over ``"model"``; the
  aux loss is the mean of the shards' over the data axes (JAX's
  ``pmean``, not the global batch's).
* ``_moe_global`` — JAX's local route on global arrays, which XLA's
  partitioner spreads over the mesh without changing its mathematics
  (``moe_block(layout=...)`` without ``mesh``, and where the
  expert-parallel conditions fail): every rank all-gathers the tokens
  over the axes that split them, routes every global token, dispatches
  to its experts with the global capacity (the stable sort restricted to
  its experts leaves each choice's position within its expert as it
  is, so the same choices drop as on one device), and keeps its own rows
  of the outputs summed over ``"model"``; the aux loss is the global
  batch's.

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


def _moe_gather(p: dict, cfg: ArchConfig, x: torch.Tensor, w, idx,
                e_start: int = 0) -> torch.Tensor:
    """Tiny-T decode path: gather only the touched experts' weights.  With
    ``p`` a block of experts from ``e_start``, the choices of the other
    experts weigh 0 (the ranks that hold them add their share)."""
    e_local = p["wi_gate"].shape[0]
    if e_local != cfg.n_experts:
        local = idx - e_start
        w = w * ((local >= 0) & (local < e_local)).to(w.dtype)
        idx = local.clamp(0, e_local - 1)
    wg = p["wi_gate"][idx]  # [T, k, d, ff]
    wu = p["wi_up"][idx]
    wo = p["wo"][idx]  # [T, k, ff, d]
    g = F.silu(torch.einsum("td,tkdf->tkf", x, wg))
    u = torch.einsum("td,tkdf->tkf", x, wu)
    y = torch.einsum("tkf,tkfd->tkd", g * u, wo)
    return torch.einsum("tkd,tk->td", y, w)


def moe_block(p: dict, cfg: ArchConfig, x: torch.Tensor, mesh=None,
              dp_axes: Tuple[str, ...] = (), layout=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux loss).

    Without ``mesh`` or ``layout``: one device's whole weights and
    tokens.  On a mesh ``p`` is this rank's block (its experts, whole
    or split over ``"model"``, the router whole) and ``x`` its rows of
    the global batch: over the ``layout``'s ``batch_axes`` (a
    ``TPLayout``), or over ``dp_axes`` without one.  With ``mesh`` the
    block runs expert-parallel where JAX's runs ``_moe_shard_map`` (over
    JAX's data axes: the layout's ``dp_axes`` but its model axis, or
    ``dp_axes`` without a layout; the experts divide the model axis, and
    the global tokens divide the data axes and times top-k reach the
    expert count); elsewhere, and with a ``layout`` but no ``mesh``, it
    runs JAX's partitioner path (``_moe_global``)."""
    from repro_torch.common import sharding as shd
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    where = mesh if mesh is not None else getattr(layout, "mesh", None)
    if where is None:
        if p["wi_gate"].shape[0] != cfg.n_experts:
            raise ValueError("experts split over the model axis: give the "
                             "layout of this rank's blocks (layout=)")
        w, idx, aux = _route(p, cfg, x2)
        if b * s * cfg.top_k < cfg.n_experts:
            out = _moe_gather(p, cfg, x2, w, idx)
        else:
            out = _moe_capacity(p, cfg, x2, w, idx, 0, cfg.n_experts)
        return out.reshape(b, s, d), aux
    names = shd.axis_names(where)
    if layout is not None:
        rows = tuple(layout.batch_axes)
        dp = tuple(a for a in layout.dp_axes if a != layout.model_axis)
    else:
        rows = tuple(a for a in dp_axes if a in names)
        dp = tuple(a for a in rows if a != "model")
    t = b * s * shd.block_index(where, rows)[1]          # global tokens
    if mesh is not None and "model" in names:
        dp_size = math.prod(shd.axis_size(mesh, a) for a in dp)
        m, e = shd.axis_size(mesh, "model"), cfg.n_experts
        if (e % m == 0 and p["wi_gate"].shape[0] * m == e
                and t % dp_size == 0 and t >= dp_size
                and t * cfg.top_k >= e):
            out, aux = _moe_expert_parallel(p, cfg, x2, mesh, rows, dp,
                                            layout)
            return out.reshape(b, s, d), aux
    out, aux = _moe_global(p, cfg, x2, where, rows, layout)
    return out.reshape(b, s, d), aux


def _carried(aux: torch.Tensor, value: torch.Tensor, n: int) -> torch.Tensor:
    """``value`` (the aux loss every rank reports), its gradient carried
    at ``aux / n``: ``n`` ranks each add their share of the router's and
    the tokens' gradient to the sums over the mesh that follow."""
    carried = aux / n
    return carried + (value - carried).detach()


def _layout_ranks(layout, mesh, dp: Tuple[str, ...]) -> int:
    """The ranks whose gradients of a leaf whole on the data axes are
    summed: the layout's data axes, or ``dp`` without a layout."""
    from repro_torch.common import sharding as shd
    if layout is not None:
        return layout.dp_size
    return math.prod(shd.axis_size(mesh, a) for a in dp)


def _replicas(layout, alike: bool) -> str:
    """How the ranks of the model axis, each holding its own experts, hold
    the tokens: ``"gathered"`` (each its own rows, all-gathered over the
    axis), ``"copies"`` (the same rows, each computing what follows in
    full: the ``tp`` layout's model axis) or ``"shares"`` (the same rows,
    each carrying its share of their loss: a ``dp_heavy*`` batch the axes
    do not divide, whose model ranks are data ranks)."""
    if not alike:
        return "gathered"
    shares = layout is not None and layout.model_axis in layout.dp_axes
    return "shares" if shares else "copies"


def _enter(p: dict, x2: torch.Tensor, mesh, model: str, mode):
    """(the tokens, the parameters) as the rank's experts take them: as
    copies, through ``copy_to`` with the router (each rank's gradient of
    them is its experts' share, summed over the axis); else as they are
    (their gradients are summed over the axis later: by the gather's
    backward, or over the data axes the model axis is one of)."""
    from repro_torch.common import sharding as shd
    if mode != "copies":
        return x2, p
    return (shd.copy_to(x2, mesh, (model,)),
            dict(p, router=shd.copy_to(p["router"], mesh, (model,))))


def _leave(out: torch.Tensor, mesh, model: str, mode) -> torch.Tensor:
    """The rank's experts' partial outputs summed over the model axis: cut
    to the rank's rows with their gradient all-gathered (``"gathered"``),
    as the same rows with the gradient as it is (``"copies"``, each rank
    carrying the whole loss), or with the gradient summed too
    (``"shares"``: every share of the loss reaches each rank's
    experts)."""
    from repro_torch.common import sharding as shd
    if mode == "gathered":
        return shd.scatter_from(out, mesh, (model,), 0)
    if mode == "copies":
        return shd.reduce_from(out, mesh, (model,))
    if mode == "shares":
        return shd.sum_over(out, mesh, (model,))
    return out


def _moe_expert_parallel(p: dict, cfg: ArchConfig, x2: torch.Tensor, mesh,
                         rows: Tuple[str, ...], dp: Tuple[str, ...],
                         layout=None):
    """JAX's ``_moe_shard_map`` on this rank: (its rows' output summed
    over ``"model"``, the aux loss's mean over ``dp``).  JAX's shard is
    the global tokens' block over ``dp``: this rank's rows (over
    ``rows``) all-gathered over the axes of ``rows`` not in ``dp`` (the
    ``dp_heavy*`` layouts' ``"model"``), or cut to this rank's block of
    them over the axes of ``dp`` whose ranks hold the same rows (a batch
    the data axes do not divide; the outputs all-gathered back).  The
    model axis's ranks meet as :func:`_replicas` says (``_enter`` /
    ``_leave``), and the aux loss's gradient is carried once over the
    ranks that sum it."""
    from repro_torch.common import sharding as shd
    m = shd.axis_size(mesh, "model")
    e_local = cfg.n_experts // m
    extra = tuple(a for a in rows if a not in dp)
    chunk = tuple(a for a in dp if a not in rows)
    if extra:
        x2 = shd.gather_from(x2, mesh, extra, 0)
    if chunk:
        i, n = shd.block_index(mesh, chunk)
        per = x2.shape[0] // n
        x2 = x2.narrow(0, i * per, per)
    mode = _replicas(layout, "model" not in extra)
    x2, pl = _enter(p, x2, mesh, "model", mode)
    w, idx, aux = _route(pl, cfg, x2)
    out = _moe_capacity(pl, cfg, x2, w, idx,
                        shd.axis_index(mesh, "model") * e_local, e_local)
    out = _leave(out, mesh, "model", mode)
    if chunk:
        out = shd.gather_from(out, mesh, chunk, 0)
    mean = aux.detach()
    if dp:
        mean = shd.all_reduce_sum(mean, mesh, dp) / math.prod(
            shd.axis_size(mesh, a) for a in dp)
    n = (m if mode == "copies" else 1) * _layout_ranks(layout, mesh, dp)
    return out, _carried(aux, mean, n)


def _moe_global(p: dict, cfg: ArchConfig, x2: torch.Tensor, mesh,
                rows: Tuple[str, ...], layout=None):
    """JAX's local route on the global tokens, from this rank's rows
    (over ``rows``) and experts: (its rows' output, the global batch's
    aux loss).  The rows are all-gathered over ``rows``; every rank
    routes every token with the whole router and dispatches to its
    experts with the global capacity (``dispatch`` at the global count),
    or gathers its experts' weights where ``T * top_k < n_experts``.
    With the experts split over ``"model"``, its ranks meet as
    :func:`_replicas` says (``_enter`` / ``_leave``; with the tokens
    split over ``"model"`` too, ``dp_heavy*``, the sum cut to this rank's
    rows is ``scatter_from``).  A rank keeps its rows (the others'
    gradient 0), so the gather's backward (a reduce-scatter) counts every
    row once; the aux loss, equal on every rank, carries its gradient
    once over the ranks that sum it."""
    from repro_torch.common import sharding as shd
    model = "model"
    e_local = p["wi_gate"].shape[0]
    split = e_local != cfg.n_experts
    e0 = shd.axis_index(mesh, model) * e_local if split else 0
    if split and model in rows and rows[-1] != model:
        raise ValueError(f"rows over {rows}: the model axis comes last")
    if rows:
        x2 = shd.gather_from(x2, mesh, rows, 0)
    mode = _replicas(layout, model not in rows) if split else None
    x2, pl = _enter(p, x2, mesh, model, mode)
    w, idx, aux = _route(pl, cfg, x2)
    t = x2.shape[0]
    if t * cfg.top_k < cfg.n_experts:
        out = _moe_gather(pl, cfg, x2, w, idx, e0)
    else:
        out = _moe_capacity(pl, cfg, x2, w, idx, e0, e_local)
    if mode != "gathered":
        out = _leave(out, mesh, model, mode)
    keep = tuple(a for a in rows if not (split and a == model))
    i, n = shd.block_index(mesh, keep)
    if n > 1:
        per = out.shape[0] // n
        out = out.narrow(0, i * per, per)
    if mode == "gathered":
        out = _leave(out, mesh, model, mode)
    m = shd.axis_size(mesh, model) if mode == "copies" else 1
    return out, _carried(aux, aux.detach(), m * _layout_ranks(layout, mesh,
                                                              rows))
