"""Unified model from one config (the JAX package's ``models/
transformer.py`` in PyTorch): dense / MoE / SSM / hybrid / audio / VLM.

Layers are grouped by *pattern position*: ``pattern[j]`` repeats
``n_layers // len(pattern)`` times (stacked params with a leading
``n_full`` axis, as in JAX, applied by a Python loop over repeats), plus an
unrolled remainder ``tail`` so exact layer counts are preserved.
``shared_attn`` positions (Zamba2) hold a single weight set (``shared``)
reused on every repeat.

Public surface:
  param_specs / init      — parameters
  forward(params, batch)  — full-sequence logits (and the MoE aux loss)
  prefill(params, batch)  — logits + populated caches
  decode_step(params, …)  — one-token logits; caches updated in place
  init_caches / cache_logical / cache_pspecs — decode-state construction
  serve_caches            — prefill's caches on a mesh into the serve layout

Inputs are tokens, or audio frames (``frontend == "audio_frames"``: the
encoder-only hubert, no embedding, always a head), with projected vision
patches prepended to the tokens (``"vision_patches"``; decode steps carry
none, the patches live in the KV cache).

The model axis of a mesh (JAX's GSPMD result of the ``tp`` rules,
written out by hand): ``forward`` and ``prefill`` take a ``layout`` (a
``common/sharding.TPLayout`` from :func:`tp_layout`) and this rank's
block of every parameter (:func:`param_pspecs`).  Each layer's leaves
split over the data axes (FSDP) are gathered where the layer runs, inside
its remat, their gradients reduce-scattered back; each module computes
its own heads, inner channels, MLP columns or experts and meets the
other ranks through ``copy_to`` / ``reduce_from``; the embedding and the
head are split over the vocabulary (a masked take summed over
``"model"``; the logits stay this rank's vocabulary columns).  ``mesh``
keeps JAX's meaning: it routes the MoE blocks through the expert-parallel
path; a ``layout`` without it routes them through JAX's partitioner path
(``moe._moe_global``: the global tokens, the global capacity).  Under the
``dp_heavy*`` rules (a ``TPLayout`` whose data axes end with
``"model"``) every module runs whole heads, columns and vocabulary: each
leaf is gathered whole where it runs and the logits come out whole, but
for the MoE's experts, which stay split over ``"model"`` (JAX's
``"experts"`` rule) and meet the rows of that axis's ranks (the MoE
reads JAX's data axes, the layout's without ``"model"``).
``act_sharding`` (JAX's activation constraint at every block boundary)
is a check here: the hidden state already is this rank's ``("batch",
None, None)`` block.

Decode on a mesh takes the serve layout (a ``TPLayout`` whose
``cache_pspecs`` are :func:`cache_pspecs`, JAX's ``kv_cache_rules``):
the parameters as in the tensor-parallel layout (FSDP gathered per
layer), the attention caches split by sequence with every head on each
rank, the SSM caches at the rank's heads.  :func:`serve_caches` turns a
sharded prefill's caches (at each rank's heads) into that layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.arch_config import ArchConfig, BlockSpec
from repro_torch.common.pytree import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamSpec, gelu_mlp, gelu_mlp_specs, init_params, rmsnorm, rmsnorm_spec,
    stack_specs, swiglu, swiglu_specs)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a config the port's model path cannot run: every config
    of the registry runs (on one device), an unknown frontend does not."""
    if cfg.frontend not in ("none", "audio_frames", "vision_patches"):
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _mixer_specs(cfg: ArchConfig, spec: BlockSpec) -> dict:
    if spec.mixer == "mamba":
        return ssm_mod.ssm_specs(cfg)
    return attn.attn_specs(cfg)


def _mlp_specs(cfg: ArchConfig, spec: BlockSpec) -> Optional[dict]:
    if spec.mlp == "swiglu":
        return swiglu_specs(cfg.d_model, cfg.d_ff)
    if spec.mlp == "gelu":
        return gelu_mlp_specs(cfg.d_model, cfg.d_ff)
    if spec.mlp == "moe":
        return moe_mod.moe_specs(cfg)
    return None


def _block_specs(cfg: ArchConfig, spec: BlockSpec) -> dict:
    d = {"norm1": rmsnorm_spec(cfg.d_model), "mixer": _mixer_specs(cfg, spec)}
    mlp = _mlp_specs(cfg, spec)
    if mlp is not None:
        d["norm2"] = rmsnorm_spec(cfg.d_model)
        d["mlp"] = mlp
    return d


def _layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    p = len(cfg.pattern)
    return p, cfg.n_layers // p, cfg.n_layers % p


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    p, n_full, rem = _layout(cfg)
    specs: Dict[str, Any] = {}
    if cfg.frontend != "audio_frames":
        specs["embed"] = ParamSpec((cfg.vocab_size, cfg.d_model),
                                   ("vocab", None), scale=1.0)
    blocks = []
    for j in range(p):
        bs = cfg.pattern[j]
        if bs.mixer == "shared_attn":
            blocks.append({})  # weights live in specs["shared"]
        else:
            blocks.append(stack_specs(_block_specs(cfg, bs), n_full)
                          if n_full > 0 else {})
    specs["blocks"] = tuple(blocks)
    specs["tail"] = tuple(
        {} if cfg.pattern[j].mixer == "shared_attn"
        else _block_specs(cfg, cfg.pattern[j])
        for j in range(rem))
    if any(b.mixer == "shared_attn" for b in cfg.pattern):
        shared_spec = dataclasses.replace(cfg.pattern[
            next(j for j, b in enumerate(cfg.pattern)
                 if b.mixer == "shared_attn")], mixer="attn_global")
        specs["shared"] = _block_specs(cfg, shared_spec)
    specs["final_norm"] = rmsnorm_spec(cfg.d_model)
    if not cfg.tie_embeddings or cfg.frontend == "audio_frames":
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                  (None, "vocab"))
    return specs


def logical(cfg: ArchConfig):
    """The parameters' logical axes (``common/sharding.tree_pspecs``)."""
    return tree_map(lambda s: s.logical, param_specs(cfg))


def param_pspecs(cfg: ArchConfig, rules, mesh):
    """The parameters' PartitionSpecs on ``mesh`` under ``rules``:
    JAX's ``fit_pspecs(tree_pspecs(logical(cfg), rules), ...)`` with two
    deviations the port's hand-written parallelism needs.  A Mamba2
    block's heads and inner channels split together or not at all (a
    rank computes whole heads), and its conv splits by segment
    (``sharding.Segmented``: the x channels of the rank's heads, B and C
    whole) where JAX's would cut ``d_inner + 2 * ssm_state`` channels in
    contiguous blocks; an attention block whose query heads stay whole
    keeps its key / value heads whole too."""
    from repro_torch.common import sharding as shd
    fitted = shd.fit_pspecs(shd.tree_pspecs(logical(cfg), rules),
                            param_specs(cfg), mesh)
    di, ns = cfg.d_inner, cfg.ssm_state

    def fix(block: dict) -> dict:
        mix = block.get("mixer")
        if not mix:
            return block
        mix = dict(mix)
        if "A_log" in mix:
            heads, inner = mix["A_log"][-1], mix["wz"][-1]
            if heads != inner:
                raise NotImplementedError(
                    f"{cfg.name}: SSM heads laid out {heads!r} beside inner "
                    f"channels {inner!r} (ROADMAP queue 1 item 11.8.4)")
            seg = None if inner is None else shd.Segmented(
                inner, (di, ns, ns), (True, False, False))
            for k in ("conv_w", "conv_b"):
                mix[k] = shd.P(*tuple(mix[k])[:-1], seg)
        elif mix["wq"][-2] is None:
            for k in ("wk", "wv"):
                spec = list(mix[k])
                spec[-2] = None
                mix[k] = shd.P(*spec)
        return dict(block, mixer=mix)
    out = dict(fitted)
    out["blocks"] = tuple(fix(b) for b in fitted["blocks"])
    out["tail"] = tuple(fix(b) for b in fitted["tail"])
    if "shared" in fitted:
        out["shared"] = fix(fitted["shared"])
    return out


def tp_layout(cfg: ArchConfig, mesh, rules, dp_axes=()):
    """The ``TPLayout`` of ``cfg``'s parameters on ``mesh`` under
    ``rules``, the batch split over ``dp_axes``."""
    from repro_torch.common.sharding import TPLayout
    return TPLayout(mesh, param_pspecs(cfg, rules, mesh), tuple(dp_axes))


def init(cfg: ArchConfig, generator: torch.Generator, dtype=torch.float32,
         device="cpu", layout=None):
    """Parameters from ``generator`` (drawn where it lives, then moved to
    ``device``); with ``layout`` (a ``TPLayout``) this rank's blocks of
    them, each leaf cut as soon as it is drawn, from the same draws in
    the same order."""
    cut = None
    if layout is not None:
        from repro_torch.common.sharding import map_specs, shard_tensor
        cut = map_specs(lambda s: lambda x: shard_tensor(x, s, layout.mesh),
                        layout.pspecs)
    return init_params(param_specs(cfg), generator, dtype, device, cut)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _apply_mlp(bp: dict, cfg: ArchConfig, spec: BlockSpec, h: torch.Tensor,
               tp=None, mesh=None):
    """(h + the MLP of h, the MoE aux loss or 0.0); ``tp`` a
    ``TPLayout`` (this rank's MLP columns or experts), ``mesh`` the MoE's
    expert-parallel route (without it, on a layout, the partitioner
    path)."""
    if spec.mlp == "none":
        return h, 0.0
    x = rmsnorm(bp["norm2"], h, cfg.norm_eps)
    if spec.mlp in ("swiglu", "gelu"):
        mlp = swiglu if spec.mlp == "swiglu" else gelu_mlp
        split = tp is not None and bp["mlp"]["wo"].shape[0] != cfg.d_ff
        return h + mlp(bp["mlp"], x, tp if split else None), 0.0
    out, aux = moe_mod.moe_block(bp["mlp"], cfg, x, mesh, layout=tp)
    return h + out, aux


def _gather_layer(tp, bp: dict, bspec: dict) -> dict:
    """A layer's leaves split over the data axes gathered whole (FSDP),
    but for the MoE's expert dimension: its blocks of experts stay this
    rank's (under ``dp_heavy*`` too, whose data axes hold ``"model"``)."""
    mlp = bspec.get("mlp", {})
    if "router" in mlp:
        from repro_torch.common.sharding import P
        bspec = dict(bspec, mlp={k: P(None, *tuple(v)[1:])
                                 if k in ("wi_gate", "wi_up", "wo") else v
                                 for k, v in mlp.items()})
    return tp.gather_fsdp(bp, bspec)


def _apply_block(bp: dict, cfg: ArchConfig, spec: BlockSpec,
                 h: torch.Tensor, tp=None, mesh=None, bspec=None):
    """One layer; with ``tp`` its leaves split over the data axes are
    gathered first (``bspec`` their specs)."""
    if tp is not None:
        bp = _gather_layer(tp, bp, bspec)
    x = rmsnorm(bp["norm1"], h, cfg.norm_eps)
    if spec.mixer == "mamba":
        h = h + ssm_mod.ssm_forward(bp["mixer"], cfg, x, tp=tp)
    else:
        h = h + attn.attention(bp["mixer"], cfg, x,
                               local=spec.mixer == "attn_local", tp=tp)
    return _apply_mlp(bp, cfg, spec, h, tp, mesh)


def _resolve(cfg: ArchConfig, j: int, bp: dict, shared: Optional[dict]):
    spec = cfg.pattern[j]
    if spec.mixer == "shared_attn":
        return dataclasses.replace(spec, mixer="attn_global"), shared
    return spec, bp


def _layers(params: dict, cfg: ArchConfig, tp=None):
    """(block params, spec, (where, j, r), the block's PartitionSpecs
    under ``tp`` or None) for every layer in order: the ``n_full`` repeats
    of the pattern, then the tail.  ``where`` is ``"blocks"`` (repeat
    ``r`` of pattern position ``j``) or ``"tail"``."""
    from repro_torch.common.sharding import inner_specs
    p, n_full, rem = _layout(cfg)
    shared = params.get("shared")
    ps = None if tp is None else tp.pspecs
    layer_specs = None if ps is None else [
        inner_specs(b) if b else b for b in ps["blocks"]]
    for r in range(n_full):
        for j in range(p):
            bp = tree_map(lambda x: x[r], params["blocks"][j])
            spec, bp = _resolve(cfg, j, bp, shared)
            yield bp, spec, ("blocks", j, r), None if ps is None else \
                _resolve(cfg, j, layer_specs[j], ps.get("shared"))[1]
    for j in range(rem):
        spec, bp = _resolve(cfg, j, params["tail"][j], shared)
        yield bp, spec, ("tail", j, None), None if ps is None else \
            _resolve(cfg, j, ps["tail"][j], ps.get("shared"))[1]


# ---------------------------------------------------------------------------
# Forward (full-sequence eval)
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, cfg: ArchConfig, batch: dict,
                 tp=None) -> torch.Tensor:
    """Input hidden states: audio frames [B, S, d] as they are, or the
    embedded tokens [B, S] with vision patches [B, P, d] prepended when
    the batch has them (decode steps carry none: they live in the KV
    cache).  With ``tp`` and the embedding split over the vocabulary, each
    rank takes the rows it holds (zero elsewhere) and the ranks' rows are
    summed over ``"model"``."""
    if cfg.frontend == "audio_frames":
        return batch["frames"]
    emb, toks = params["embed"], batch["tokens"]
    if tp is not None and emb.shape[0] != cfg.vocab_size:
        n = emb.shape[0]
        local = toks - tp.model_index * n
        mine = (local >= 0) & (local < n)
        h = tp.reduce_from(emb[local.clamp(0, n - 1)]
                           * mine[..., None].to(emb.dtype))
    else:
        h = emb[toks]
    if cfg.frontend == "vision_patches" and "patches" in batch:
        h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
    return h


def unembed(params: dict, cfg: ArchConfig, h: torch.Tensor,
            tp=None) -> torch.Tensor:
    """The logits; with ``tp`` and the head split over the vocabulary,
    this rank's vocabulary columns (``h`` enters through ``copy_to``)."""
    w = params["head"] if "head" in params else params["embed"].T
    if tp is not None and w.shape[-1] != cfg.vocab_size:
        h = tp.copy_to(h)
    return h @ w


def _check_mesh(mesh, layout, act_sharding):
    """The activations' PartitionSpec (None without ``act_sharding``, a
    PartitionSpec or a NamedSharding, as JAX takes it), held to JAX's
    contract: the port's hidden state is this rank's block of the global
    [B, S, d] laid out ``("batch", None, None)``, its rows over the
    layout's ``batch_axes`` (none without a layout), so a spec that lays
    it out so changes nothing, and any other raises."""
    if mesh is not None and layout is None:
        raise ValueError("a mesh needs the layout of this rank's parameter "
                         "blocks (layout=tp_layout(cfg, mesh, rules))")
    if act_sharding is None:
        return None
    from repro_torch.common.sharding import entry_axes
    spec = tuple(getattr(act_sharding, "spec", act_sharding))
    rows = () if layout is None else tuple(layout.batch_axes)
    if (len(spec) != 3 or spec[1:] != (None, None)
            or entry_axes(spec[0]) != rows):
        raise ValueError(f"act_sharding {spec!r}: the hidden state is this "
                         f"rank's block of [B, S, d] with its rows over "
                         f"{rows} and the rest whole")
    return spec


def _top(params: dict, tp) -> dict:
    """The leaves outside the layers, FSDP-gathered under ``tp``."""
    if tp is None:
        return params
    keys = [k for k in ("embed", "final_norm", "head") if k in params]
    return {**params, **tp.gather_fsdp({k: params[k] for k in keys},
                                       {k: tp.pspecs[k] for k in keys})}


def forward(params: dict, cfg: ArchConfig, batch: dict, *,
            return_aux: bool = False, mesh=None, dp_axes=(),
            remat: bool = False, unroll: bool = False, act_sharding=None,
            layout=None):
    """Full-sequence logits [B, S, V]; with ``return_aux``, ``(logits, aux)``
    as JAX returns them, aux the MoE load-balance loss summed over layers
    (a float32 scalar, 0 without MoE).

    ``remat`` recomputes each block's activations in the backward pass
    (``torch.utils.checkpoint``, as JAX's ``jax.checkpoint``), keeping
    only each block's input (and re-running its collectives, in the same
    order on every rank); the result is the same bit for bit.
    ``unroll`` changes nothing: the layer loop is already unrolled.  With
    ``layout`` (a ``TPLayout``) ``params`` are this rank's blocks and
    ``batch`` its data shard; the logits are [B_local, S, V_local] and
    ``mesh`` routes the MoE through the expert-parallel path (without
    it, JAX's partitioner path over the layout's blocks).
    ``dp_axes`` is the layout's (JAX reads it only with a mesh);
    ``act_sharding`` is checked (:func:`_check_mesh`) and changes
    nothing."""
    check_supported(cfg)
    _check_mesh(mesh, layout, act_sharding)
    del unroll, dp_axes
    top = _top(params, layout)
    h = embed_inputs(top, cfg, batch, layout)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for bp, spec, _, bspec in _layers(params, cfg, layout):
        if remat:
            h, a = checkpoint(_apply_block, bp, cfg, spec, h, layout, mesh,
                              bspec, use_reentrant=False)
        else:
            h, a = _apply_block(bp, cfg, spec, h, layout, mesh, bspec)
        aux = aux + a
    h = rmsnorm(top["final_norm"], h, cfg.norm_eps)
    logits = unembed(top, cfg, h, layout)
    return (logits, aux) if return_aux else logits


# ---------------------------------------------------------------------------
# Decode: cache construction + prefill + one-token step
# ---------------------------------------------------------------------------

def _layer_cache_init(cfg: ArchConfig, spec: BlockSpec, batch: int,
                      max_seq: int, dtype, device, tp=None, bspec=None):
    """A layer's zero caches; with ``tp``, at this rank's heads (``bspec``
    the layer's PartitionSpecs)."""
    from repro_torch.common.sharding import local_shape
    local = lambda k: local_shape(_mixer_specs(cfg, spec)[k].shape,
                                  bspec["mixer"][k], tp.mesh)
    if spec.mixer == "mamba":
        heads = None if tp is None else local("A_log")[0]
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device, heads)
    kv = None
    if tp is not None:
        h_loc, kv = local("wq")[1], local("wk")[1]
        if h_loc != cfg.n_heads and kv == cfg.n_kv_heads:
            kv = len(attn.kv_keep(cfg, h_loc, tp.model_index))
    return attn.init_cache(cfg, spec.mixer == "attn_local", batch, max_seq,
                           dtype, device, kv)


def _stack_caches(caches: list):
    return tree_map(lambda *xs: torch.stack(xs), *caches)


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.float32, device="cpu", layout=None) -> dict:
    """Zero decode caches for a global ``batch``; with ``layout``, this
    rank's blocks: in the serve layout (``layout.cache_pspecs``), else at
    its heads and batch rows, as a sharded ``prefill`` returns them."""
    check_supported(cfg)
    if layout is not None and layout.cache_pspecs is not None:
        from repro_torch.common.sharding import local_structs
        return tree_map(lambda m: torch.zeros(m.shape, dtype=dtype,
                                              device=device),
                        local_structs(init_caches(cfg, batch, max_seq, dtype,
                                                  "meta"),
                                      layout.cache_pspecs, layout.mesh))
    p, n_full, rem = _layout(cfg)
    specs = {}
    if layout is not None:
        from repro_torch.common.sharding import block_index
        batch //= block_index(layout.mesh, layout.batch_axes)[1]
        meta = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                        param_specs(cfg))
        for _, _, (kind, j, _), bspec in _layers(meta, cfg, layout):
            specs[(kind, j)] = bspec
    one = lambda kind, j: _layer_cache_init(
        cfg, cfg.pattern[j], batch, max_seq, dtype, device, layout,
        specs.get((kind, j)))
    return {
        "blocks": tuple(
            _stack_caches([one("blocks", j) for _ in range(n_full)])
            for j in range(p)) if n_full > 0 else tuple({} for _ in range(p)),
        "tail": tuple(one("tail", j) for j in range(rem)),
    }


def _layer_cache(caches: dict, where: Tuple):
    kind, j, r = where
    if kind == "tail":
        return caches["tail"][j]
    return tree_map(lambda x: x[r], caches["blocks"][j])


def cache_logical(cfg: ArchConfig) -> dict:
    """The caches' logical axes (JAX's ``cache_logical``)."""
    p, n_full, rem = _layout(cfg)

    def one(spec: BlockSpec, stacked: bool):
        ax = (ssm_mod.ssm_cache_logical_axes() if spec.mixer == "mamba"
              else attn.cache_logical_axes(spec.mixer == "attn_local"))
        return type(ax)(*(("layers",) + a if stacked else a for a in ax))

    return {"blocks": tuple(one(cfg.pattern[j], True) if n_full > 0 else {}
                            for j in range(p)),
            "tail": tuple(one(cfg.pattern[j], False) for j in range(rem))}


def cache_pspecs(cfg: ArchConfig, cache_rules, mesh, batch: int,
                 max_seq: int, param_pspecs):
    """The decode caches' PartitionSpecs on ``mesh`` under
    ``cache_rules`` (``sharding.kv_cache_rules``): JAX's ``fit_pspecs(
    tree_pspecs(cache_logical(cfg), cache_rules), ...)`` (an attention
    cache's sequence over ``"model"``, or ``("data", "model")`` with the
    batch released, each dropped where it does not divide), with the SSM
    caches laid out as their layer's parameters (``param_pspecs``): the
    state at the heads of ``A_log``, the conv history by segment as
    ``conv_w``."""
    from repro_torch.common import sharding as shd
    fitted = shd.fit_pspecs(shd.tree_pspecs(cache_logical(cfg), cache_rules),
                            init_caches(cfg, batch, max_seq, torch.float32,
                                        "meta"), mesh)

    def fix(spec, params, stacked: bool):
        if not isinstance(spec, ssm_mod.SSMCache):
            return spec
        lead = (None,) if stacked else ()
        mix = params["mixer"]
        b = spec.conv[len(lead)]
        return ssm_mod.SSMCache(
            conv=shd.P(*lead, b, None, tuple(mix["conv_w"])[-1]),
            state=shd.P(*lead, b, tuple(mix["A_log"])[-1], None, None))
    return {"blocks": tuple(fix(c, param_pspecs["blocks"][j], True)
                            for j, c in enumerate(fitted["blocks"])),
            "tail": tuple(fix(c, param_pspecs["tail"][j], False)
                          for j, c in enumerate(fitted["tail"]))}


def serve_caches(caches: dict, cfg: ArchConfig, prefill_layout,
                 serve_layout) -> dict:
    """This rank's serve-layout caches (``serve_layout.cache_pspecs``)
    from a sharded prefill's (``prefill_layout``: at this rank's heads and
    batch rows; every head under ``dp_heavy*``).  An attention cache's
    heads split over the model axis are all-gathered over it (where the
    key / value heads stay whole while the query heads split, each rank
    held the heads its query heads read: ``attn.kv_keep``), then cut to
    this rank's block of the sequence; a batch or SSM heads laid out
    otherwise are gathered and cut the same way
    (``sharding.reshard_tensor``, the bytes counted per axis)."""
    from repro_torch.common import sharding as shd
    meta = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                    param_specs(cfg))
    mixers = {(kind, j): bspec["mixer"] for _, _, (kind, j, _), bspec
              in _layers(meta, cfg, prefill_layout)}
    src_b, tp = prefill_layout.batch_entry, serve_layout

    def attn_leaf(x, dst, mix):
        lead = x.dim() - 4
        h_loc = shd.local_shape((cfg.n_heads,), shd.P(mix["wq"][-2]),
                                tp.mesh)[0]
        if h_loc != cfg.n_heads:        # heads at each rank's: gather them
            x = shd.all_gather(x, tp.mesh, (tp.model_axis,), x.dim() - 2)
            if mix["wk"][-2] is None:   # each held its kv_keep heads
                held = torch.cat([attn.kv_keep(cfg, h_loc, r) for r in
                                  range(tp.model_size)]).tolist()
                first = [held.index(k) for k in range(cfg.n_kv_heads)]
                x = x[..., first, :]
        src = shd.P(*((None,) * lead), src_b, None, None, None)
        return shd.reshard_tensor(x, src, dst, tp.mesh)

    out = {}
    for kind in ("blocks", "tail"):
        group = []
        for j, (c, spec) in enumerate(zip(caches[kind],
                                          tp.cache_pspecs[kind])):
            if isinstance(c, attn.KVCache):
                mix = mixers[(kind, j)]
                c = attn.KVCache(*(attn_leaf(x, d, mix)
                                   for x, d in zip(c, spec)))
            elif isinstance(c, ssm_mod.SSMCache):
                lead = (None,) * (1 if kind == "blocks" else 0)
                mix = mixers[(kind, j)]
                src = ssm_mod.SSMCache(
                    conv=shd.P(*lead, src_b, None, tuple(mix["conv_w"])[-1]),
                    state=shd.P(*lead, src_b, tuple(mix["A_log"])[-1], None,
                                None))
                c = ssm_mod.SSMCache(*(shd.reshard_tensor(x, a, d, tp.mesh)
                                       for x, a, d in zip(c, src, spec)))
            group.append(c)
        out[kind] = tuple(group)
    return out


def decode_step(params: dict, cfg: ArchConfig, batch: dict, caches: dict,
                cur_len: int, layout=None):
    """batch: one new token per sequence ({"tokens": [B, 1]}); ``cur_len``
    tokens are in the caches.  Returns (logits [B,1,V], caches); the
    caches are updated in place (JAX returns updated copies).  With
    ``layout`` (the serve layout, ``cache_pspecs`` set) ``params``,
    ``batch`` and ``caches`` are this rank's blocks and the logits its
    vocabulary columns."""
    check_supported(cfg)
    if layout is not None and layout.cache_pspecs is None:
        raise ValueError("decode on a mesh takes the serve layout (a "
                         "TPLayout with cache_pspecs)")
    top = _top(params, layout)
    h = embed_inputs(top, cfg, batch, layout)
    for bp, spec, where, bspec in _layers(params, cfg, layout):
        cache = _layer_cache(caches, where)
        if layout is not None:
            bp = _gather_layer(layout, bp, bspec)
        x = rmsnorm(bp["norm1"], h, cfg.norm_eps)
        if spec.mixer == "mamba":
            out, _ = ssm_mod.ssm_decode_step(bp["mixer"], cfg, x, cache,
                                             tp=layout)
        else:
            seq = () if layout is None else _seq_axes(layout, where)
            out, _ = attn.decode_step(bp["mixer"], cfg, x, cache, cur_len,
                                      local=spec.mixer == "attn_local",
                                      tp=layout, seq_axes=seq)
        h, _ = _apply_mlp(bp, cfg, spec, h + out, layout)
    h = rmsnorm(top["final_norm"], h, cfg.norm_eps)
    return unembed(top, cfg, h, layout), caches


def _seq_axes(layout, where) -> Tuple[str, ...]:
    """The mesh axes a layer's attention cache splits its sequence
    over."""
    from repro_torch.common.sharding import entry_axes
    kind, j, _ = where
    return entry_axes(layout.cache_pspecs[kind][j].k[-3])


def prefill(params: dict, cfg: ArchConfig, batch: dict, max_seq: int,
            last_only: bool = False, *, mesh=None, layout=None,
            act_sharding=None):
    """Full-prompt forward that also populates the decode caches.  Returns
    (logits [B,S,V], or [B,1,V] with ``last_only``, and the caches).
    ``layout``, ``mesh`` and ``act_sharding`` as :func:`forward`'s: this
    rank's vocabulary columns of the logits and its caches at its heads
    (the tensor-parallel layout), or the whole vocabulary and every head
    (``dp_heavy*``), at its batch rows."""
    check_supported(cfg)
    _check_mesh(mesh, layout, act_sharding)
    p, n_full, rem = _layout(cfg)
    top = _top(params, layout)
    h = embed_inputs(top, cfg, batch, layout)
    block_caches = [[] for _ in range(p)]
    tail_caches = []
    for bp, spec, (kind, j, _), bspec in _layers(params, cfg, layout):
        if layout is not None:
            bp = _gather_layer(layout, bp, bspec)
        x = rmsnorm(bp["norm1"], h, cfg.norm_eps)
        if spec.mixer == "mamba":
            out, cache = ssm_mod.ssm_forward(bp["mixer"], cfg, x,
                                             return_cache=True, tp=layout)
        else:
            out, cache = attn.prefill_cache(bp["mixer"], cfg, x, max_seq,
                                            local=spec.mixer == "attn_local",
                                            tp=layout)
        h, _ = _apply_mlp(bp, cfg, spec, h + out, layout, mesh)
        (block_caches[j] if kind == "blocks" else tail_caches).append(cache)
    if last_only:
        h = h[:, -1:]
    h = rmsnorm(top["final_norm"], h, cfg.norm_eps)
    caches = {"blocks": tuple(_stack_caches(c) if c else {}
                              for c in block_caches),
              "tail": tuple(tail_caches)}
    return unembed(top, cfg, h, layout), caches
