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
rank order, as ``P(axis)`` lays them out), :func:`all_reduce_sum` and
:func:`reduce_scatter_sum`.  Under ``gloo`` a CUDA tensor is staged
through host memory for the collective only (gloo's CUDA support lacks
``all_gather``), in float32 where it is a lower-precision float that a
reduction sums (an all-gather moves its bytes as they are), and a
reduce-scatter is an all-reduce and this rank's slice; under ``nccl`` it
stays on the card.  :data:`COLLECTIVES` counts each kind's calls, bytes
and seconds, and :data:`COLLECTIVE_AXES` the same per mesh axes
(:func:`reset_collectives`).

The model axis (JAX's GSPMD result of the ``tp`` rules) is written out by
hand, Megatron-style: a rank holds its block of each parameter
(:func:`shard_tree` of the global tree under the fitted PartitionSpecs;
:func:`gather_tree` returns the global one) and the model code meets the
other ranks through collectives that autograd differentiates
(:func:`copy_to`, :func:`reduce_from`, :func:`sum_over`,
:func:`gather_from` and its adjoint :func:`scatter_from`).  A
:class:`TPLayout` carries the mesh, the parameters' specs and the data
axes to the model code.  A :class:`Segmented` entry splits a dimension
by segments rather than in contiguous blocks (the Mamba2 conv's ``[x |
B | C]`` channels).
"""
from __future__ import annotations

import collections.abc
import dataclasses
import math
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
    sequence dim takes both axes.  (A cache's leaves are laid out by
    ``fit_pspec`` of these rules, as JAX fits them: a sequence the axes
    do not divide stays whole on every rank, ``models/transformer.
    cache_pspecs``.)"""
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

_KINDS = ("all_gather", "all_reduce", "reduce_scatter")
COLLECTIVES: Dict[str, Dict[str, float]] = {
    k: {"calls": 0, "bytes": 0, "seconds": 0.0} for k in _KINDS}
# {"data" / "model" / "pod+data" ...: {kind: {calls, bytes, seconds}}}
COLLECTIVE_AXES: Dict[str, Dict[str, Dict[str, float]]] = {}
# {(the mesh's ranks, its shape, its axis names, axes): (world, group)}
_GROUPS: Dict[tuple, Tuple[Any, Any]] = {}


def reset_collectives() -> None:
    for v in COLLECTIVES.values():
        v.update(calls=0, bytes=0, seconds=0.0)
    COLLECTIVE_AXES.clear()


def axes_group(mesh, axes: Sequence[str]):
    """The process group spanning ``axes`` of ``mesh``: one axis's group,
    the world's when ``axes`` cover every axis of size > 1, else a group
    of every rank that shares this rank's coordinates on the other axes
    (built once per rank layout and axes of each world, by every rank, in
    the same order).  Its ranks run in the row-major order of ``axes``,
    as ``P(axes)`` lays out the blocks."""
    import torch.distributed as dist
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = axis_names(mesh)
    rest = [a for a in names if a not in axes]
    if all(axis_size(mesh, a) == 1 for a in rest):
        return dist.group.WORLD
    key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
           names, axes)
    world = dist.group.WORLD
    if key not in _GROUPS or _GROUPS[key][0] is not world:
        ranks = mesh.mesh.permute(
            [names.index(a) for a in rest] + [names.index(a) for a in axes])
        groups = ranks.reshape(-1, math.prod(axis_size(mesh, a)
                                             for a in axes)).tolist()
        _GROUPS[key] = (world, dist.new_subgroups_by_enumeration(groups)[0])
    return _GROUPS[key][1]


def _staged(tensor: torch.Tensor, group) -> bool:
    import torch.distributed as dist
    return dist.get_backend(group) == "gloo" and (
        tensor.is_cuda or tensor.dtype in (torch.bfloat16, torch.float16))


def _to_wire(tensor: torch.Tensor, staged: bool) -> torch.Tensor:
    """The buffer a collective works on: a host float32 copy under gloo
    for a CUDA or lower-precision tensor, else a contiguous copy."""
    if not staged:
        return tensor.detach().contiguous().clone()
    t = tensor.detach().cpu()
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def _count(kind: str, axes: Sequence[str], nbytes: int, t0: float) -> None:
    dt = time.perf_counter() - t0
    for c in (COLLECTIVES[kind], COLLECTIVE_AXES.setdefault(
            "+".join(axes), {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
                             for k in _KINDS})[kind]):
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        c["seconds"] += dt


def _axes(mesh, axes) -> Tuple[str, ...]:
    return axis_names(mesh) if axes is None else tuple(axes)


def all_gather(tensor: torch.Tensor, mesh, axes: Sequence[str] = ("data",),
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated along ``dim``
    in rank order over ``axes``: the global array of a block laid out
    ``P(axes)`` on that dimension."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    axes = _axes(mesh, axes)
    group = axes_group(mesh, axes)
    n = dist.get_world_size(group)
    if n == 1:
        return tensor
    staged = _staged(tensor, group)
    half = (staged and tensor.dim() > 0
            and tensor.dtype in (torch.bfloat16, torch.float16))
    # a gather moves bits: a 16-bit float travels as its two bytes, not
    # widened to float32
    src = (tensor.detach().cpu().contiguous().view(torch.uint8) if half
           else _to_wire(tensor, staged))
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if half:
        out = out.view(tensor.dtype)
    if staged:
        out = out.to(tensor.device, tensor.dtype)
    _count("all_gather", axes, out.numel() * out.element_size(), t0)
    return out


def _all_reduce(tensor: torch.Tensor, mesh, axes: Sequence[str],
                op) -> torch.Tensor:
    import torch.distributed as dist
    t0 = time.perf_counter()
    group = axes_group(mesh, axes)
    if dist.get_world_size(group) == 1:
        return tensor.clone()
    staged = _staged(tensor, group)
    buf = _to_wire(tensor, staged)
    dist.all_reduce(buf, op=op, group=group)
    if staged:
        buf = buf.to(tensor.device, tensor.dtype)
    _count("all_reduce", axes, buf.numel() * buf.element_size(), t0)
    return buf


def all_reduce_sum(tensor: torch.Tensor, mesh,
                   axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The sum of every rank's ``tensor`` over ``axes`` (every axis by
    default), as a new tensor on ``tensor``'s device."""
    import torch.distributed as dist
    return _all_reduce(tensor, mesh, _axes(mesh, axes), dist.ReduceOp.SUM)


def all_reduce_max(tensor: torch.Tensor, mesh,
                   axes: Sequence[str]) -> torch.Tensor:
    """The elementwise largest of every rank's ``tensor`` over ``axes``
    (counted with the all-reduces)."""
    import torch.distributed as dist
    return _all_reduce(tensor, mesh, tuple(axes), dist.ReduceOp.MAX)


def reduce_scatter_sum(tensor: torch.Tensor, mesh, axes: Sequence[str],
                       dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's
    ``tensor`` over ``axes`` (blocks in rank order, as
    :func:`all_gather` concatenates them)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    axes = tuple(axes)
    group = axes_group(mesh, axes)
    n = dist.get_world_size(group)
    if n == 1:
        return tensor.clone()
    per = tensor.shape[dim] // n
    me = dist.get_rank(group)
    if dist.get_backend(group) == "gloo":
        buf = _to_wire(tensor, _staged(tensor, group))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        out = buf.narrow(dim, me * per, per).to(tensor.device, tensor.dtype)
    else:
        src = tensor.detach().movedim(dim, 0).contiguous()
        out = src.new_empty((per,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=group)
        out = out.movedim(0, dim)
    _count("reduce_scatter", axes, tensor.numel() * tensor.element_size(),
           t0)
    return out.contiguous()


# ---------------------------------------------------------------------------
# collectives that autograd differentiates (the model axis, FSDP)
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward, a sum over the axes backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """A sum over the axes forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumOver(torch.autograd.Function):
    """A sum over the axes forward and backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh, ctx.axes), None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward, reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_sum(g, ctx.mesh, ctx.axes, ctx.dim), None,
                None, None)


def copy_to(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axes``.  A tensor equal
    on every rank of ``axes`` enters a region where each rank computes
    its own part with it (its heads, columns, experts, vocab rows)."""
    return _CopyTo.apply(x, mesh, tuple(axes))


def reduce_from(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over ``axes``; its gradient
    as it is (what follows is computed alike on every rank of ``axes``)."""
    return _ReduceFrom.apply(x, mesh, tuple(axes))


def sum_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes`` where each rank goes on
    to compute its own part with it: the gradient is summed too."""
    return _SumOver.apply(x, mesh, tuple(axes))


def gather_from(x: torch.Tensor, mesh, axes: Sequence[str],
                dim: int) -> torch.Tensor:
    """The whole of a block split over ``axes`` along ``dim`` (FSDP's
    gather); its gradient summed over ``axes`` and cut back to this
    rank's block (a reduce-scatter)."""
    return _GatherFrom.apply(x, mesh, tuple(axes), dim)


class _ScatterFrom(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward, all-gather backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return reduce_scatter_sum(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def scatter_from(x: torch.Tensor, mesh, axes: Sequence[str],
                 dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's partial
    ``x`` over ``axes`` (the adjoint of :func:`gather_from`): its gradient
    all-gathered, each rank's partial feeding every rank's block (the
    MoE's outputs of tokens gathered over ``"model"``)."""
    return _ScatterFrom.apply(x, mesh, tuple(axes), dim)


class _GatherAlike(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's block of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        i, n = block_index(ctx.mesh, ctx.axes)
        per = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, i * per, per), None, None, None


def gather_alike(x: torch.Tensor, mesh, axes: Sequence[str],
                 dim: int) -> torch.Tensor:
    """The whole of a block split over ``axes`` along ``dim`` where what
    follows is computed alike on every rank of ``axes`` (the naive loss's
    gathered logits): its gradient is this rank's block of the gradient,
    as it is."""
    return _GatherAlike.apply(x, mesh, tuple(axes), dim)


# ---------------------------------------------------------------------------
# blocks of parameter trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segmented:
    """A spec entry that cuts a dimension into ``sizes`` segments and
    splits over ``axis`` only those whose ``split`` is True, each in
    contiguous blocks; the others stay whole on every rank.  A rank's
    block is its piece of each segment, in segment order."""

    axis: str
    sizes: Tuple[int, ...]
    split: Tuple[bool, ...]


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one PartitionSpec entry, in order (empty for
    None)."""
    if entry is None:
        return ()
    if isinstance(entry, Segmented):
        return (entry.axis,)
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's block, number of blocks) of a dimension split over
    ``axes`` in row-major order."""
    n, i = 1, 0
    for a in axes:
        n *= axis_size(mesh, a)
        i = i * axis_size(mesh, a) + axis_index(mesh, a)
    return i, n


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a ``shape`` array laid out
    ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if isinstance(entry, Segmented):
            m = axis_size(mesh, entry.axis)
            out[d] = sum(s // m if cut else s
                         for s, cut in zip(entry.sizes, entry.split))
        elif entry is not None:
            out[d] //= block_index(mesh, entry_axes(entry))[1]
    return tuple(out)


def shard_tensor(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` laid out ``spec`` (a copy)."""
    for d, entry in enumerate(spec):
        if isinstance(entry, Segmented):
            i, m = axis_index(mesh, entry.axis), axis_size(mesh, entry.axis)
            parts = torch.split(x, list(entry.sizes), dim=d)
            x = torch.cat([p.narrow(d, i * (p.shape[d] // m), p.shape[d] // m)
                           if cut else p
                           for p, cut in zip(parts, entry.split)], dim=d)
        elif entry is not None:
            i, n = block_index(mesh, entry_axes(entry))
            per = x.shape[d] // n
            x = x.narrow(d, i * per, per)
    return x.clone(memory_format=torch.contiguous_format)


def gather_tensor(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The global array of this rank's block ``x`` laid out ``spec``
    (whole segments from this rank's copy)."""
    for d, entry in enumerate(spec):
        if isinstance(entry, Segmented):
            m = axis_size(mesh, entry.axis)
            sizes = [s // m if cut else s
                     for s, cut in zip(entry.sizes, entry.split)]
            x = torch.cat([all_gather(p, mesh, (entry.axis,), d)
                           if cut else p for p, cut in zip(
                               torch.split(x, sizes, dim=d), entry.split)],
                          dim=d)
        elif entry is not None:
            x = all_gather(x, mesh, entry_axes(entry), d)
    return x


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def map_specs(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over a tree of PartitionSpecs and trees of
    the same structure."""
    if _is_spec(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, spec_tree[k], *(t[k] for t in trees))
                for k in spec_tree}
    out = [map_specs(fn, s, *(t[i] for t in trees))
           for i, s in enumerate(spec_tree)]
    return type(spec_tree)(*out) if hasattr(spec_tree, "_fields") \
        else type(spec_tree)(out)


def tree_shardings(mesh, pspecs) -> Any:
    """A :class:`NamedSharding` per PartitionSpec (JAX's
    ``tree_shardings``)."""
    return map_specs(lambda s: NamedSharding(mesh, s), pspecs)


def shard_tree(global_tree, pspecs, mesh):
    """This rank's blocks of ``global_tree`` under ``pspecs``."""
    return map_specs(lambda s, x: shard_tensor(x, s, mesh), pspecs,
                      global_tree)


def gather_tree(local_tree, pspecs, mesh):
    """The global tree of this rank's blocks ``local_tree`` under
    ``pspecs`` (for checks, snapshots and digests)."""
    return map_specs(lambda s, x: gather_tensor(x, s, mesh), pspecs,
                      local_tree)


def local_structs(structs, pspecs, mesh):
    """Meta tensors of this rank's block shapes for ``structs`` (anything
    with ``shape`` and ``dtype``)."""
    return map_specs(lambda s, x: torch.empty(
        local_shape(x.shape, s, mesh), dtype=x.dtype, device="meta"),
        pspecs, structs)


def reshard_tensor(x: torch.Tensor, src: PartitionSpec, dst: PartitionSpec,
                   mesh) -> torch.Tensor:
    """This rank's block under ``dst`` of the array whose block under
    ``src`` is ``x``: each dimension laid out differently is all-gathered
    over its ``src`` axes, then cut to this rank's ``dst`` block, either
    side by segments where it is :class:`Segmented` (the all-gathers
    counted in :data:`COLLECTIVE_AXES`)."""
    for d, (a, b) in enumerate(zip(src, dst)):
        if a == b or (not isinstance(a, Segmented)
                      and not isinstance(b, Segmented)
                      and entry_axes(a) == entry_axes(b)):
            continue
        at = lambda e: P(*((None,) * d), e)
        if a is not None:
            x = gather_tensor(x, at(a), mesh)
        if b is not None:
            x = shard_tensor(x, at(b), mesh)
    return x.contiguous()


def stacked_specs(pspecs, lead=None):
    """``pspecs`` with one more leading dimension laid out ``lead``."""
    return map_specs(lambda s: P(lead, *tuple(s)), pspecs)


def inner_specs(pspecs):
    """``pspecs`` without their leading dimension (one layer of a stack)."""
    return map_specs(lambda s: P(*tuple(s)[1:]), pspecs)


@dataclasses.dataclass(eq=False)
class TPLayout:
    """What a sharded forward needs to know: the mesh, the parameters'
    PartitionSpecs (this rank holds its block of each leaf), and the data
    axes the batch splits over (empty: the batch is whole on every rank,
    as in a client of the federated round).  The model code reads which
    of its dimensions are local from its blocks' shapes; the specs say
    which dimensions FSDP split over the data axes.

    Under the ``dp_heavy*`` rules the model axis is a data axis too
    (``dp_axes`` ends with it): no module is tensor-parallel, every leaf
    split over ``"model"`` (the embedding's and head's vocabulary, and
    under z3 d_model) is gathered whole where it runs, as FSDP gathers,
    and the logits come out whole."""

    mesh: Any
    pspecs: Any
    dp_axes: Tuple[str, ...] = ()
    model_axis: str = "model"
    # the axes a batch's rows split over, where JAX's fitted spec gives
    # fewer than dp_axes (a batch they do not divide stays whole; FSDP
    # still gathers over dp_axes); None: dp_axes
    batch_axes: Optional[Tuple[str, ...]] = None
    # the serve layout's decode caches (transformer.cache_pspecs); None
    # elsewhere: caches at this rank's heads, as prefill makes them
    cache_pspecs: Any = None

    def __post_init__(self):
        names = axis_names(self.mesh)
        self.dp_axes = tuple(a for a in self.dp_axes if a in names)
        if self.batch_axes is None:
            self.batch_axes = self.dp_axes

    @property
    def model_size(self) -> int:
        return axis_size(self.mesh, self.model_axis)

    @property
    def model_index(self) -> int:
        return axis_index(self.mesh, self.model_axis)

    @property
    def dp_size(self) -> int:
        return math.prod(axis_size(self.mesh, a) for a in self.dp_axes)

    @property
    def dp_index(self) -> int:
        return block_index(self.mesh, self.dp_axes)[0]

    @property
    def batch_entry(self):
        """The batch dimension's PartitionSpec entry (``batch_axes``)."""
        axes = tuple(self.batch_axes)
        return None if not axes else axes[0] if len(axes) == 1 else axes

    def copy_to(self, x):
        return copy_to(x, self.mesh, (self.model_axis,))

    def reduce_from(self, x):
        return reduce_from(x, self.mesh, (self.model_axis,))

    def sum_over(self, x):
        return sum_over(x, self.mesh, (self.model_axis,))

    def fsdp_axes(self, spec: PartitionSpec) -> list:
        """(dimension, axes) of each dimension of ``spec`` split over
        data axes."""
        out = []
        for d, entry in enumerate(spec):
            axes = entry_axes(entry)
            if axes and all(a in self.dp_axes for a in axes):
                out.append((d, axes))
        return out

    def gather_fsdp(self, tree, specs):
        """``tree`` with every leaf split over data axes gathered whole
        (its gradient reduce-scattered back)."""
        def one(spec, x):
            for d, axes in self.fsdp_axes(spec):
                x = gather_from(x, self.mesh, axes, d)
            return x
        return map_specs(one, specs, tree)

    def sum_replicated_grads(self, grads, specs):
        """``grads`` with the gradient of every leaf summed over the data
        axes it is whole on (one float32 all-reduce per set of axes, the
        leaves in tree order); over the axes it splits over, its gradient
        came back summed from :meth:`gather_fsdp`.  Under the ``tp`` rules
        a leaf is split over every data axis or whole on them; under
        ``dp_heavy`` a leaf split over ``"data"`` alone is summed over
        ``"model"``, whose ranks hold other rows of the batch.  Where the
        ranks of an axis hold the same rows (a batch the axes do not
        divide, ``batch_axes``), each rank's loss carries its share
        (:func:`steps.token_xent` divides by ``dp_size``), so the sums
        count every row once."""
        if self.dp_size == 1:
            return grads
        flat_g, flat_s = [], []
        map_specs(lambda s, g: (flat_s.append(s), flat_g.append(g)),
                   specs, grads)
        groups: Dict[Tuple[str, ...], list] = {}
        for i, s in enumerate(flat_s):
            split = {a for _, axes in self.fsdp_axes(s) for a in axes}
            rest = tuple(a for a in self.dp_axes if a not in split)
            if rest:
                groups.setdefault(rest, []).append(i)
        for axes, idx in groups.items():
            buf = torch.cat([flat_g[i].reshape(-1).float() for i in idx])
            buf = all_reduce_sum(buf, self.mesh, axes)
            for i, part in zip(idx, torch.split(
                    buf, [flat_g[i].numel() for i in idx])):
                flat_g[i] = part.reshape(flat_g[i].shape).to(
                    flat_g[i].dtype)
        it = iter(flat_g)
        return map_specs(lambda s: next(it), specs)


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
