"""Logical-axis sharding rules (MaxText-style) and the collectives of the
port's device mesh (the JAX package's ``common/sharding.py`` in PyTorch).

Model code annotates every parameter / activation dimension with a
*logical* name; the rules table maps logical names onto physical mesh
axes.  Changing a distribution strategy = changing one rules table, not
the model.  The rules, :func:`logical_to_pspec`, :func:`tree_pspecs`,
:func:`fit_pspec(s) <fit_pspec>` and :func:`kv_cache_rules` are pure
logic and return what the JAX package's return, with
:class:`PartitionSpec` a tuple of the port's own.  ``fit_pspec`` reads an
axis's size by name (:func:`axis_size`), from a
``torch.distributed.device_mesh.DeviceMesh`` or from anything whose
``shape`` maps axis names to sizes.

Physical mesh axes:
  single-pod: ("data", "model")
  multi-pod : ("pod", "data", "model")

A mesh is a ``DeviceMesh`` with one process per rank
(``launch/mesh.py``).  Where JAX's ``shard_map`` hands its caller a global
array, the port's ranks hold their own block and meet through the
collectives below: :func:`all_gather` along a mesh axis (the blocks in
rank order, as ``P(axis)`` lays them out) and :func:`all_reduce_sum`.
Under ``gloo`` a CUDA tensor is staged through host memory for the
collective only (gloo's CUDA support lacks ``all_gather``); under
``nccl`` it stays on the card.  :data:`COLLECTIVES` counts each kind's
calls, bytes and seconds (:func:`reset_collectives`).

Only the client axis is sharded in the port so far (``shard_clients``);
``tree_shardings`` and the model axis wait for ROADMAP queue 1 item 11.8.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Rules = Dict[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of axis names (JAX's ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`PartitionSpec`: which tensor dimension splits
    over which mesh axes (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


# Logical axis vocabulary -------------------------------------------------
#   batch      global batch dimension
#   seq        sequence dimension of activations
#   cache_seq  KV-cache sequence dimension (sequence parallelism for decode)
#   vocab      vocabulary dimension (embedding + lm head + logits)
#   embed      d_model dimension (FSDP shard target)
#   heads      query-head dimension
#   kv_heads   kv-head dimension
#   qkv        per-head feature dim (never sharded)
#   mlp        feed-forward hidden dimension
#   experts    MoE expert dimension (expert parallelism)
#   inner      mamba inner-channel dimension
#   state      SSM state dimension (never sharded)
#   layers     stacked-layer dimension of repeated params
#   clients    stacked client / teacher dimension of the federated round


def make_rules(*, multi_pod: bool = False, fsdp: bool = True,
               shard_cache_seq: bool = False, shard_clients: bool = False,
               layout: str = "tp", extra: Optional[Rules] = None) -> Rules:
    """``shard_clients=True`` puts the stacked-client leading axis of the
    federated round on the data axes (clients train data-parallel; see
    ``core/client.make_batched_local_update``).  Layouts:

    tp        batch over (pod,)data; heads / mlp / experts tensor-parallel
              over "model"; d_model FSDP over data (the baseline).
    dp_heavy  ZeRO-style: batch over both (data, model) axes; weights
              sharded on d_model over "data" and vocab over "model"; no
              tensor parallelism.
    dp_heavy_z3  as dp_heavy, with d_model sharded over every axis.
    """
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    if layout in ("dp_heavy", "dp_heavy_z3"):
        dp_all = dp + ("model",)
        rules: Rules = {
            "batch": dp_all,
            "seq": (),
            "cache_seq": (),
            "vocab": ("model",),
            "embed": (dp_all if layout == "dp_heavy_z3" else ("data",))
                     if fsdp else (),
            "heads": (),
            "kv_heads": (),
            "qkv": (),
            "mlp": (),
            "experts": ("model",),
            "inner": (),
            "state": (),
            "conv": (),
            "layers": (),
            "clients": dp if shard_clients else (),
        }
    else:
        rules = {
            "batch": dp,
            "seq": (),
            "cache_seq": ("data",) if shard_cache_seq else (),
            "vocab": ("model",),
            "embed": dp if fsdp else (),
            "heads": ("model",),
            "kv_heads": ("model",),
            "qkv": (),
            "mlp": ("model",),
            "experts": ("model",),
            "inner": ("model",),
            "state": (),
            "conv": (),
            "layers": (),
            "clients": dp if shard_clients else (),
        }
    if extra:
        rules.update(extra)
    return rules


def logical_to_pspec(logical: Sequence[Optional[str]],
                     rules: Rules) -> PartitionSpec:
    """Map a tuple of logical names (one per tensor dim) to a
    PartitionSpec.  A mesh axis appears at most once: on conflicts the
    first dimension wins and later dims are replicated."""
    used: set = set()
    spec = []
    for name in logical:
        if name is None:
            spec.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ()) if a not in used)
        used.update(axes)
        if len(axes) == 0:
            spec.append(None)
        elif len(axes) == 1:
            spec.append(axes[0])
        else:
            spec.append(axes)
    return P(*spec)


def _is_logical(x) -> bool:
    return (isinstance(x, tuple) and not isinstance(x, PartitionSpec)
            and len(x) > 0
            and all(isinstance(e, (str, type(None))) for e in x))


def _map(fn, tree, is_leaf):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [_map(fn, v, is_leaf) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree)


def tree_pspecs(logical_tree: Any, rules: Rules) -> Any:
    """Map a tree of logical-axis tuples to a tree of PartitionSpecs."""
    return _map(lambda names: logical_to_pspec(names, rules), logical_tree,
                _is_logical)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = tuple(mesh.shape)
    return tuple(names)


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (JAX's ``mesh.shape[name]``)."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, collections.abc.Mapping):
        return int(shape[name])
    return int(mesh.size(axis_names(mesh).index(name)))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along mesh axis ``name``."""
    return int(mesh.get_coordinate()[axis_names(mesh).index(name)])


def fit_pspec(spec: PartitionSpec, shape: Tuple[int, ...],
              mesh) -> PartitionSpec:
    """Drop mesh axes that do not divide the corresponding dim size
    (e.g. 4 kv heads on a 16-way "model" axis are replicated); tuple
    entries are trimmed from the right."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        while axes:
            prod = 1
            for a in axes:
                prod *= axis_size(mesh, a)
            if dim % prod == 0:
                break
            axes = axes[:-1]
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def fit_pspecs(pspec_tree: Any, struct_tree: Any, mesh) -> Any:
    """:func:`fit_pspec` leafwise; ``struct_tree``'s leaves have ``shape``."""
    def walk(spec, leaf):
        if isinstance(spec, PartitionSpec):
            return fit_pspec(spec, tuple(leaf.shape), mesh)
        if isinstance(spec, dict):
            return {k: walk(spec[k], leaf[k]) for k in spec}
        out = [walk(s, l) for s, l in zip(spec, leaf, strict=True)]
        return type(spec)(*out) if hasattr(spec, "_fields") \
            else type(spec)(out)
    return walk(pspec_tree, struct_tree)


def kv_cache_rules(rules: Rules, *, batch: int, data_size: int) -> Rules:
    """Decode-cache sharding: the cache SEQUENCE dim over "model"; with a
    batch smaller than the data axis the batch dim is released and the
    sequence dim takes both axes."""
    out = dict(rules)
    if batch < data_size:
        out["batch"] = ()
        out["cache_seq"] = ("data", "model")
    else:
        out["cache_seq"] = ("model",)
        out["kv_heads"] = ()  # avoid conflicting with cache_seq
    return out


# ---------------------------------------------------------------------------
# collectives over the mesh (the port's side of JAX's shard_map)
# ---------------------------------------------------------------------------

COLLECTIVES: Dict[str, Dict[str, float]] = {
    "all_gather": {"calls": 0, "bytes": 0, "seconds": 0.0},
    "all_reduce": {"calls": 0, "bytes": 0, "seconds": 0.0},
}


def reset_collectives() -> None:
    for v in COLLECTIVES.values():
        v.update(calls=0, bytes=0, seconds=0.0)


def axes_group(mesh, axes: Sequence[str]):
    """The process group spanning ``axes`` of ``mesh``: one axis's group,
    or the world's when ``axes`` cover every axis of size > 1."""
    import torch.distributed as dist
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    rest = [a for a in axis_names(mesh) if a not in axes]
    if all(axis_size(mesh, a) == 1 for a in rest):
        return dist.group.WORLD
    raise NotImplementedError(
        f"a collective over axes {axes} beside axes {rest} of size > 1 "
        f"(ROADMAP queue 1 item 11.8)")


def _staged(tensor: torch.Tensor, group) -> bool:
    import torch.distributed as dist
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def _count(kind: str, nbytes: int, t0: float) -> None:
    c = COLLECTIVES[kind]
    c["calls"] += 1
    c["bytes"] += int(nbytes)
    c["seconds"] += time.perf_counter() - t0


def all_gather(tensor: torch.Tensor, mesh, axes: Sequence[str] = ("data",)
               ) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated along dim 0 in
    rank order over ``axes``: the global array of a ``P(axes)`` block."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    group = axes_group(mesh, axes)
    n = dist.get_world_size(group)
    if n == 1:
        return tensor
    staged = _staged(tensor, group)
    src = tensor.detach().cpu() if staged else tensor.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    if staged:
        out = out.to(tensor.device)
    _count("all_gather", out.numel() * out.element_size(), t0)
    return out


def all_reduce_sum(tensor: torch.Tensor, mesh,
                   axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The sum of every rank's ``tensor`` over ``axes`` (every axis by
    default), as a new tensor on ``tensor``'s device."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    group = axes_group(mesh, axis_names(mesh) if axes is None else axes)
    if dist.get_world_size(group) == 1:
        return tensor.clone()
    staged = _staged(tensor, group)
    buf = tensor.detach().cpu() if staged else tensor.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if staged:
        buf = buf.to(tensor.device)
    _count("all_reduce", buf.numel() * buf.element_size(), t0)
    return buf


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order over the world."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def tensor_digest(t: torch.Tensor) -> int:
    """A position-weighted 64-bit sum of ``t``'s bytes, computed where
    ``t`` lives: equal for equal bits, and moved by any one element's
    change."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.numel() == 0:
        return 0
    width = flat.element_size()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[width]
    bits = flat.view(ints).to(torch.int64)
    pos = torch.arange(flat.numel(), device=flat.device, dtype=torch.int64)
    weight = (pos * 0x9E3779B1 + 0x7F4A7C15) % 2147483647 + 1
    return int(((bits + 1) * weight).sum())


def tree_digest(tree) -> int:
    """:func:`tensor_digest` over a tree's leaves in key order."""
    from repro_torch.common.pytree import tree_flatten
    h = 0
    for i, (path, leaf) in enumerate(sorted(tree_flatten(tree).items())):
        h = (h * 1000003 + tensor_digest(leaf) + i) % (1 << 61)
    return h
