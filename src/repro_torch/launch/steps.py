"""Step builders: per (architecture x input shape) programs with their
input stand-ins (the JAX package's ``launch/steps.py`` in PyTorch).

  train_4k     -> train_step    (forward + next-token loss + grad + Adam)
  prefill_32k  -> prefill_step  (full-prompt forward, returns caches)
  decode_32k   -> serve_step    (ONE new token against a seq_len cache)
  long_500k    -> serve_step    (sub-quadratic archs only)
  (extra)      -> distill_step  (FedDF server fusion: K teachers + student)
  (extra)      -> fed_round_step (K clients' local-SGD loops)

A builder allocates nothing: a :class:`StepBundle`'s ``args`` and ``outs``
are trees of tensors on the ``meta`` device (shapes and dtypes, the
counterpart of JAX's ``ShapeDtypeStruct``), which ``launch/dryrun.py``
counts.  ``bundle.init_args(generator, device)`` draws real arguments
(``cuda`` by default; it raises without a card unless asked for ``cpu``),
and ``bundle.fn(*args)`` runs the step on them: K4 and K5 (and K2 in the
distill loss) on CUDA tensors, their plain versions on the CPU.  A donated
argument is updated in place and returned.

On a mesh (``launch/mesh.py``, one process per rank) every builder takes
a ``("data", "model")`` or ``("pod", "data", "model")`` mesh under the
``tp`` rules, or, for the train and prefill steps, JAX's other
``layout``s: ``args``, ``outs`` and ``make_args`` are this rank's blocks
(``bundle.layout``, a ``TPLayout``): parameters drawn leaf by leaf from
the one generator on every rank and cut (``sharding.shard_tensor``), so a
sharded run starts from the unsharded run's weights; batches drawn whole
and cut over the batch axes.  ``fsdp=True`` splits d_model over the data
axes (each leaf gathered where its layer runs, its gradient
reduce-scattered; Adam is elementwise, so it runs on the blocks); the
gradients of leaves whole on some data axes are summed over them.  The
``tp`` losses are vocab-parallel (:func:`token_xent`, and the distill
step's K2 over vocabulary shards, ``ops.ensemble_kl_loss_split``): the
[B, S, V] logits are never gathered.  ``layout="dp_heavy"`` (ZeRO: the
batch over every axis, d_model over ``"data"``, the vocabulary over
``"model"``, no tensor parallelism) and ``"dp_heavy_z3"`` (d_model over
every axis) are FSDP over every axis the batch splits over: each leaf is
gathered whole where it runs and the logits come out whole.  A global
batch the axes do not divide keeps the axes JAX's fitted spec keeps; the
ranks of the others hold the same rows, each carrying its share of
their loss.  ``constrain_acts`` passes JAX's activation sharding to the
forward, which checks it and changes nothing; ``naive_xent`` gathers the
logits over the vocabulary first.  Prefill returns the next-token logits
(split over the vocabulary under ``tp``) and the caches at this rank's
heads; ``T.serve_caches`` lays them out for ``make_serve_step``, whose
caches follow JAX's ``kv_cache_rules`` (:func:`serve_layout`: the
sequence split, every head on each rank).  ``make_fed_round_step``
spreads its clients over the data axes (the ``shard_clients`` rules,
fsdp off), each client's replica tensor-parallel over ``"model"``.

An MoE model's blocks take JAX's two routes (``models/moe.py``): the
train and prefill steps pass the ``mesh`` (JAX's expert-parallel
``shard_map`` where its conditions hold, per data shard, under every
layout: the ``dp_heavy*`` batch's rows gathered over ``"model"``, whose
ranks hold the experts); ``use_moe_shard_map=False``, the distill
step's student and teachers and the serve step's decode pass none, as
JAX's do, and take the partitioner path (the global tokens gathered,
the global capacity, the global batch's aux loss).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.api.experiment import resolve_device
from repro_torch.common.arch_config import ArchConfig
from repro_torch.common.pytree import (tree_leaves, tree_leaves_jax,
                                       tree_map)
from repro_torch.common.sharding import P
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.frontends import (fake_audio_frames,
                                          fake_vision_patches)
from repro_torch.optim.optimizers import AdamState, adam, apply_updates

META = torch.device("meta")
LAYOUTS = ("tp", "dp_heavy", "dp_heavy_z3")


@dataclasses.dataclass
class StepBundle:
    """A step ``fn`` and the structure of its arguments and results."""

    fn: Callable
    args: Tuple[Any, ...]          # trees of meta tensors
    outs: Any                      # the results' trees of meta tensors
    make_args: Callable            # (generator, device) -> real args
    donate_argnums: Tuple[int, ...] = ()
    # a client-sharded step's block of the global client axis, and the
    # mesh axes the clients split over (empty: every rank runs them all)
    client_slice: Optional[slice] = None
    client_axes: Tuple[str, ...] = ()
    # on a mesh, the TPLayout of this rank's parameter blocks
    layout: Any = None

    def init_args(self, generator: Optional[torch.Generator] = None,
                  device="cuda") -> tuple:
        """Real arguments on ``device``: parameters drawn from
        ``generator`` (seed 0 on the CPU when None), optimizer states and
        caches zero, step 0 (on the CPU), random token / frame / patch
        batches."""
        device = resolve_device(device)
        return self.make_args(generator or torch.Generator().manual_seed(0),
                              device)


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape,
                act_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for one batch (no allocation)."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    batch: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = _meta((b, s, cfg.d_model), act_dtype)
    else:
        n_text = s
        if cfg.frontend == "vision_patches" and shape.kind != "decode":
            n_text = max(s - cfg.n_frontend_tokens, 1)
            batch["patches"] = _meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                     act_dtype)
        batch["tokens"] = _meta((b, n_text), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), torch.int32)
    return batch


def _draw_batch(specs: dict, cfg: ArchConfig, gen: torch.Generator,
                device) -> dict:
    """Real tensors for a batch of meta ``specs``: tokens and labels
    uniform over the vocabulary, frames and patches as the frontends draw
    them."""
    out = {}
    for k, m in specs.items():
        if k in ("tokens", "labels"):
            out[k] = torch.randint(0, cfg.vocab_size, m.shape, generator=gen,
                                   device=gen.device).to(m.dtype).to(device)
        elif k == "frames":
            b, s, _ = m.shape
            out[k] = fake_audio_frames(gen, cfg, b, s, m.dtype, device)
        else:
            out[k] = fake_vision_patches(gen, cfg, m.shape[0], m.dtype,
                                         device)
    return out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def token_xent_naive(logits: torch.Tensor, labels: torch.Tensor,
                     cfg: ArchConfig, layout=None) -> torch.Tensor:
    """v0 loss: slices the logits and gathers the label logit (JAX keeps
    it for its sharding record: on vocab-split logits it makes the
    partitioner all-gather them).  With ``layout`` (a ``TPLayout``) the
    logits are this rank's rows and, where the head splits the
    vocabulary, its columns: they are all-gathered over ``"model"``
    first, that all-gather written out; the result is this shard's sum
    over the global row count (its sum over the data axes is the
    loss)."""
    if layout is not None and logits.shape[-1] != cfg.vocab_size:
        from repro_torch.common.sharding import gather_alike
        logits = gather_alike(logits, layout.mesh, (layout.model_axis,),
                              logits.dim() - 1)
    if cfg.frontend == "vision_patches":
        logits = logits[:, cfg.n_frontend_tokens:]
        labels = labels[:, : logits.shape[1]]
    if cfg.is_decoder:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())
    if layout is None:
        return torch.mean(nll)
    return torch.sum(nll) / (nll.numel() * layout.dp_size)


def token_xent(logits: torch.Tensor, labels: torch.Tensor,
               cfg: ArchConfig, layout=None) -> torch.Tensor:
    """Next-token LM loss for decoders; per-frame classification for
    encoders.  VLM: the prepended patch positions are masked out.  The
    labels are rolled and the last position masked, as JAX writes it to
    keep the logits whole; the label logit is gathered (JAX's one-hot
    select sums it with zeros: the same value).

    With ``layout`` (a ``TPLayout``) ``logits`` are this rank's data
    shard and, where the head splits the vocabulary, its vocabulary
    columns: the row max and the sum of exponentials are summed over
    ``"model"``, and the label logit comes from the rank that holds it
    (the [B, S, V] logits are never gathered).  The result is this shard's
    masked sum over the global mask count: its sum over the data axes is
    the loss."""
    b, s = logits.shape[0], logits.shape[1]
    pos = torch.arange(s, device=logits.device)[None, :]
    if cfg.is_decoder:
        targets = torch.roll(labels, -1, dims=1)
        mask = (pos < s - 1).float()
    else:
        targets = labels
        mask = torch.ones((1, s), device=logits.device)
    if cfg.frontend == "vision_patches":
        mask = mask * (pos >= cfg.n_frontend_tokens)
    lg = logits.float()
    v = lg.shape[-1]
    if layout is not None and v != cfg.vocab_size:
        from repro_torch.common.sharding import all_reduce_max
        top = all_reduce_max(lg.detach().amax(dim=-1), layout.mesh,
                             (layout.model_axis,))
        z = top + torch.log(layout.reduce_from(
            torch.exp(lg - top[..., None]).sum(dim=-1)))         # [B,S]
        local = targets.long() - layout.model_index * v
        mine = (local >= 0) & (local < v)
        picked = layout.reduce_from(torch.gather(
            lg, -1, local.clamp(0, v - 1)[..., None])[..., 0] * mine)
    else:
        z = torch.logsumexp(lg, dim=-1)                          # [B,S]
        picked = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    count = torch.sum(mask * torch.ones((b, 1), device=logits.device))
    if layout is not None:
        count = count * layout.dp_size
    return torch.sum((z - picked) * mask) / count


# ---------------------------------------------------------------------------
# Structures
# ---------------------------------------------------------------------------

def _param_structs(cfg: ArchConfig, dtype=torch.bfloat16, layout=None):
    """Meta tensors of the parameters (this rank's blocks with a
    ``layout``)."""
    structs = tree_map(lambda s: _meta(s.shape, dtype), T.param_specs(cfg))
    if layout is None:
        return structs
    from repro_torch.common.sharding import local_structs
    return local_structs(structs, layout.pspecs, layout.mesh)


def _opt_structs(params) -> AdamState:
    """Adam's float32 moments, trees like ``params`` (as JAX holds them)."""
    f32 = lambda: tree_map(lambda p: _meta(p.shape, torch.float32), params)
    return AdamState(f32(), f32())


def _stacked(params, n: int):
    return tree_map(lambda s: _meta((n,) + tuple(s.shape), s.dtype), params)


def _zeros_like_meta(tree, device):
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                          device=device), tree)


def _tp(cfg: ArchConfig, mesh, fsdp: bool, batch: int, layout: str = "tp",
        constrain_acts: bool = False):
    """(the ``TPLayout`` of the train, prefill and distill steps on
    ``mesh``, None without one; JAX's activation sharding, None without
    ``constrain_acts``).  Under ``layout``'s rules the batch splits over
    the data axes (``dp_heavy*``: and ``"model"``), of which a global
    ``batch`` keeps the axes JAX's fitted spec keeps (the others hold the
    same rows).  Without a mesh every knob leaves the mathematics as it
    is, as JAX's do on one device."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: not one of {LAYOUTS}")
    if mesh is None:
        return None, (P(None, None, None) if constrain_acts else None)
    from repro_torch.common import sharding as shd
    rules = shd.make_rules(multi_pod="pod" in shd.axis_names(mesh),
                           fsdp=fsdp, layout=layout)
    tp = T.tp_layout(cfg, mesh, rules, rules["batch"])
    tp.batch_axes = _fitted_axes(shd.logical_to_pspec(("batch",), rules),
                                 batch, mesh)
    acts = None
    if constrain_acts:
        acts = shd.fit_pspec(shd.logical_to_pspec(("batch", None, None),
                                                  rules), (batch, 1, 1), mesh)
    return tp, acts


def _vocab_out(cfg: ArchConfig, params, tp) -> int:
    """The logits' last dimension on this rank: its vocabulary columns
    where the head splits them over a tensor-parallel ``"model"`` axis,
    else the whole vocabulary (``dp_heavy*`` gathers the head)."""
    if tp is None or tp.model_axis in tp.dp_axes:
        return cfg.vocab_size
    return (params["head"].shape[1] if "head" in params
            else params["embed"].shape[0])


def _fitted_axes(spec, n: int, mesh) -> Tuple[str, ...]:
    """The mesh axes a dimension of ``n`` laid out ``spec[0]`` keeps under
    ``fit_pspec``."""
    from repro_torch.common import sharding as shd
    return shd.entry_axes(shd.fit_pspec(spec, (n,), mesh)[0])


def batch_block(batch: dict, layout) -> dict:
    """This rank's rows of a whole batch (dimension 0 over the layout's
    ``batch_axes``, its data axes unless the batch stays whole; JAX's
    ``batch_pspecs``)."""
    if layout is None:
        return batch
    from repro_torch.common.sharding import block_index
    i, n = block_index(layout.mesh, layout.batch_axes)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"a batch of {v.shape[0]} does not divide over "
                             f"the axes {layout.batch_axes} of {n} ranks")
        per = v.shape[0] // n
        out[k] = v if n == 1 else v[i * per:(i + 1) * per]
    return out


def _as_param_dtype(batch: dict, dtype) -> dict:
    """Frames and patches in the parameters' dtype (JAX promotes them)."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in batch.items()}


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _grads(params, loss_fn):
    """(gradient leaves in ``tree_leaves`` order, loss_fn's extra): the
    gradient of ``loss_fn(p)[0]`` at ``params`` (zero for unused
    leaves)."""
    ps = tree_map(lambda x: x.detach().requires_grad_(), params)
    total, extra = loss_fn(ps)
    leaves = tree_leaves(ps)
    gs = torch.autograd.grad(total, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, leaves)], extra


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def train_grads(params, cfg: ArchConfig, batch: dict, *,
                microbatch: int = 1, remat: bool = True,
                unroll: bool = False, naive_xent: bool = False,
                layout=None, mesh=None, act_sharding=None):
    """(grads, {"loss", "moe_aux"}): the gradient of ``loss +
    router_aux_coef * aux`` over every leaf of ``params`` (a tree like
    it), as the train step takes it.  With ``microbatch`` > 1 the batch
    is split along its first axis and the gradients accumulated in
    float32, then averaged (JAX's scan over microbatch slices).

    With ``layout`` (a ``TPLayout``) ``params`` and ``batch`` are this
    rank's blocks and so are the gradients, each the global loss's;
    ``mesh`` routes the MoE expert-parallel (JAX's ``use_moe_shard_map``;
    without it, the partitioner path).
    Microbatch ``i`` is JAX's: the i-th slice of the global batch, of
    which this rank takes its block over the layout's ``batch_axes``.
    ``act_sharding`` goes to ``T.forward``, which checks it."""
    xent = token_xent_naive if naive_xent else token_xent
    dtype = tree_leaves(params)[0].dtype

    def one(mb):
        mb = _as_param_dtype(mb, dtype)

        def loss_fn(p):
            logits, aux = T.forward(p, cfg, mb, return_aux=True,
                                    remat=remat, unroll=unroll,
                                    layout=layout, mesh=mesh,
                                    act_sharding=act_sharding)
            loss = xent(logits, mb["labels"], cfg, layout)
            return loss + cfg.router_aux_coef * aux, (loss.detach(),
                                                      aux.detach())
        return _grads(params, loss_fn)

    if microbatch == 1:
        grads, (loss, aux) = one(batch)
    else:
        mbs = _microbatches(batch, microbatch, layout)
        leaves = tree_leaves(params)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        aux = torch.zeros_like(loss)
        for mb in mbs:
            g, (l, a) = one(mb)
            torch._foreach_add_(grads, g)
            loss, aux = loss + l, aux + a
            del g
        torch._foreach_div_(grads, float(microbatch))
        loss, aux = loss / microbatch, aux / microbatch
    grads = _unflatten(params, grads)
    if layout is not None:
        from repro_torch.common.sharding import all_reduce_sum
        grads = layout.sum_replicated_grads(grads, layout.pspecs)
        if layout.dp_axes:
            loss = all_reduce_sum(loss, layout.mesh, layout.dp_axes)
    return grads, {"loss": loss, "moe_aux": aux}


def _microbatches(batch: dict, microbatch: int, layout) -> list:
    """The ``microbatch`` slices of the global batch along its first
    axis, each this rank's block of it over the layout's ``batch_axes``
    (on one device, or with the batch whole on every rank, the local
    batch's slices)."""
    from repro_torch.common.sharding import all_gather, block_index
    b = next(iter(batch.values())).shape[0]
    i, nb = (0, 1) if layout is None else block_index(layout.mesh,
                                                      layout.batch_axes)
    if b % microbatch:
        raise ValueError(f"batch {b * nb} is not a multiple of microbatch "
                         f"{microbatch} x {nb} batch blocks")
    if nb > 1:
        batch = {k: all_gather(v, layout.mesh, layout.batch_axes)
                 for k, v in batch.items()}
    n = b * nb // microbatch
    per = n // nb
    return [{k: v[j * n + i * per: j * n + (i + 1) * per]
             for k, v in batch.items()} for j in range(microbatch)]


ADAM_CHUNK = 1 << 26      # elements an Adam update takes at a time


def _adam_groups(quads) -> list:
    """(param, mu, nu, grad) quads packed into groups of at most
    ADAM_CHUNK elements: whole leaves together, a larger leaf in slices
    along its first dimension (views, so an update lands in the leaf)."""
    parts = []
    for q in quads:
        n = q[0].numel()
        if n <= ADAM_CHUNK or q[0].dim() == 0:
            parts.append(q)
            continue
        rows = q[0].shape[0]
        per = max(1, ADAM_CHUNK * rows // n)
        parts += [tuple(x[i:i + per] for x in q) for i in range(0, rows, per)]
    groups, size = [[]], 0
    for q in parts:
        if groups[-1] and size + q[0].numel() > ADAM_CHUNK:
            groups.append([])
            size = 0
        groups[-1].append(q)
        size += q[0].numel()
    return groups


def _adam_step(opt, params, opt_state: AdamState, grads, step) -> AdamState:
    """One Adam update of ``params`` and ``opt_state`` (trees like it) in
    place; leaves pair by path (the JAX package's order), whatever each
    tree's key order.  The update is elementwise, so it runs one
    multi-tensor call per group of :func:`_adam_groups` (the same values;
    its float32 temporaries stay a group's size)."""
    quads = zip(tree_leaves_jax(params), tree_leaves_jax(opt_state.mu),
                tree_leaves_jax(opt_state.nu), tree_leaves_jax(grads))
    with torch.no_grad():
        for group in _adam_groups(quads):
            p, m, v, g = (list(x) for x in zip(*group))
            deltas, new = opt.update(g, AdamState(m, v), p, int(step))
            for dst, src in zip(p + m + v, apply_updates(p, deltas)
                                + new.mu + new.nu):
                dst.copy_(src)
    return opt_state


def _step_scalar(device=META) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def make_train_step(cfg: ArchConfig, shape: InputShape, mesh=None, *,
                    fsdp: bool = True, remat: bool = True,
                    use_moe_shard_map: bool = True, unroll: bool = False,
                    naive_xent: bool = False, layout: str = "tp",
                    constrain_acts: bool = False, microbatch: int = 1,
                    param_dtype=torch.bfloat16) -> StepBundle:
    """(params, opt_state, step, batch) -> (params, opt_state, step + 1,
    {"loss", "moe_aux"}): Adam at 3e-4 with float32 moments; params and
    opt_state are donated (updated in place).  On a ``mesh``, every
    argument and result is this rank's block (``bundle.layout``) under
    ``layout``'s rules; ``fsdp`` splits d_model over the data axes, and
    shards nothing on one device.  The forward takes the mesh for its
    MoE blocks (expert-parallel where JAX's conditions hold), or none
    with ``use_moe_shard_map=False`` (JAX's ``moe_mesh``: the
    partitioner path)."""
    tp, acts = _tp(cfg, mesh, fsdp, shape.global_batch, layout,
                   constrain_acts)
    moe_mesh = mesh if use_moe_shard_map else None
    params = _param_structs(cfg, param_dtype, tp)
    opt_state = _opt_structs(params)
    whole = input_specs(cfg, shape)
    batch = batch_block(whole, tp)
    opt = adam(3e-4)

    def train_step(params, opt_state, step, batch):
        grads, metrics = train_grads(params, cfg, batch,
                                     microbatch=microbatch, remat=remat,
                                     unroll=unroll, naive_xent=naive_xent,
                                     layout=tp, mesh=moe_mesh,
                                     act_sharding=acts)
        _adam_step(opt, params, opt_state, grads, step)
        return params, opt_state, step + 1, metrics

    def make_args(gen, device):
        p = _init_block(cfg, gen, param_dtype, device, tp)
        return (p, _zeros_like_meta(opt_state, device),
                _step_scalar("cpu"),
                batch_block(_draw_batch(whole, cfg, gen, device), tp))

    outs = (params, opt_state, _step_scalar(),
            {"loss": _meta((), torch.float32),
             "moe_aux": _meta((), torch.float32)})
    return StepBundle(train_step, (params, opt_state, _step_scalar(), batch),
                      outs, make_args, donate_argnums=(0, 1), layout=tp)


def _init_block(cfg: ArchConfig, gen, dtype, device, layout):
    """``T.init`` from ``gen``, each leaf cut to this rank's block under
    ``layout`` as it is drawn."""
    return T.init(cfg, gen, dtype, device, layout)


def make_prefill_step(cfg: ArchConfig, shape: InputShape, mesh=None, *,
                      fsdp: bool = True, unroll: bool = False,
                      layout: str = "tp", constrain_acts: bool = False,
                      param_dtype=torch.bfloat16) -> StepBundle:
    """(params, batch) -> (next-token logits [B, 1, V], caches sized
    ``shape.seq_len``); on a ``mesh``, this rank's blocks under
    ``layout``'s rules: the logits of its batch rows and (``tp``)
    vocabulary columns, the caches at its heads (``T.serve_caches`` lays
    them out for ``make_serve_step``).  A batch the batch axes do not
    divide stays whole on the ranks of those it does not keep, as JAX's
    fitted spec leaves it."""
    del unroll
    tp, acts = _tp(cfg, mesh, fsdp, shape.global_batch, layout,
                   constrain_acts)
    params = _param_structs(cfg, param_dtype, tp)
    whole = input_specs(cfg, shape)
    batch = batch_block(whole, tp)
    max_seq = shape.seq_len

    def prefill_step(params, batch):
        with torch.no_grad():
            return T.prefill(params, cfg,
                             _as_param_dtype(batch, param_dtype), max_seq,
                             last_only=True, mesh=mesh, layout=tp,
                             act_sharding=acts)

    def make_args(gen, device):
        return (_init_block(cfg, gen, param_dtype, device, tp),
                batch_block(_draw_batch(whole, cfg, gen, device), tp))

    b, v = next(iter(batch.values())).shape[0], _vocab_out(cfg, params, tp)
    outs = (_meta((b, 1, v), param_dtype),
            T.init_caches(cfg, shape.global_batch, max_seq, param_dtype, META,
                          layout=tp))
    return StepBundle(prefill_step, (params, batch), outs, make_args,
                      layout=tp)


def serve_layout(cfg: ArchConfig, mesh, batch: int, seq_len: int,
                 fsdp: bool = True):
    """The serve step's ``TPLayout`` on ``mesh``: the parameters as in
    the train step's (``tp`` rules, FSDP over the data axes), the batch
    and the caches under JAX's ``kv_cache_rules`` (the batch released and
    the cache's sequence over ``("data", "model")`` when the batch is
    smaller than the data axis, else the batch over the data axes and
    the sequence over ``"model"``), fitted to ``batch`` and ``seq_len``."""
    from repro_torch.common import sharding as shd
    multi_pod = "pod" in shd.axis_names(mesh)
    rules = shd.make_rules(multi_pod=multi_pod, fsdp=fsdp)
    cache_rules = shd.kv_cache_rules(rules, batch=batch,
                                     data_size=shd.axis_size(mesh, "data"))
    tp = T.tp_layout(cfg, mesh, rules,
                     ("pod", "data") if multi_pod else ("data",))
    tp.batch_axes = _fitted_axes(shd.logical_to_pspec(("batch",),
                                                      cache_rules),
                                 batch, mesh)
    tp.cache_pspecs = T.cache_pspecs(cfg, cache_rules, mesh, batch, seq_len,
                                     tp.pspecs)
    return tp


def make_serve_step(cfg: ArchConfig, shape: InputShape, mesh=None, *,
                    fsdp: bool = True, unroll: bool = False,
                    param_dtype=torch.bfloat16,
                    cache_dtype=torch.bfloat16) -> StepBundle:
    """One-token decode against a populated cache of ``shape.seq_len``
    tokens: (params, batch, caches, cur_len) -> (logits [B, 1, V],
    caches), the caches donated (updated in place), ``cur_len`` a host
    int.  On a ``mesh``, every argument and result is this rank's block
    under :func:`serve_layout` (``bundle.layout``): the logits of its
    batch rows and vocabulary columns (JAX's ``logits_spec``).  As in JAX
    the decode takes no ``mesh``: an MoE model's blocks take the
    partitioner path, the batch's tokens gathered and, at ``T * top_k <
    n_experts``, only the touched experts' weights read, each rank its
    own experts'."""
    del unroll
    b = shape.global_batch
    tp = None if mesh is None else serve_layout(cfg, mesh, b, shape.seq_len,
                                                fsdp)
    params = _param_structs(cfg, param_dtype, tp)
    whole = input_specs(cfg, shape)
    batch = batch_block(whole, tp)
    caches = T.init_caches(cfg, b, shape.seq_len, cache_dtype, META,
                           layout=tp)
    cur_len = _step_scalar()

    def serve_step(params, batch, caches, cur_len):
        with torch.no_grad():
            return T.decode_step(params, cfg, batch, caches, int(cur_len),
                                 layout=tp)

    def make_args(gen, device):
        return (_init_block(cfg, gen, param_dtype, device, tp),
                batch_block(_draw_batch(whole, cfg, gen, device), tp),
                _zeros_like_meta(caches, device), _step_scalar("cpu"))

    v = _vocab_out(cfg, params, tp)
    outs = (_meta((next(iter(batch.values())).shape[0], 1, v), param_dtype),
            caches)
    return StepBundle(serve_step, (params, batch, caches, cur_len), outs,
                      make_args, donate_argnums=(2,), layout=tp)


def teacher_logits(teachers, cfg: ArchConfig, batch: dict, *,
                   unroll: bool = False, layout=None,
                   act_sharding=None) -> torch.Tensor:
    """[K, B, S, V] logits of the stacked ``teachers`` [K, ...], one
    forward after another (JAX vmaps them); with ``layout`` each
    teacher's blocks, FSDP-gathered per layer, and the logits this rank's
    rows and vocabulary columns."""
    k = tree_leaves(teachers)[0].shape[0]
    with torch.no_grad():
        out = None
        for i in range(k):
            lg = T.forward(tree_map(lambda x: x[i], teachers), cfg, batch,
                           unroll=unroll, layout=layout,
                           act_sharding=act_sharding)
            if out is None:
                out = lg.new_empty((k,) + tuple(lg.shape))
            out[i] = lg
            del lg
    return out


def distill_grads(student, teachers, cfg: ArchConfig, batch: dict, *,
                  remat: bool = True, unroll: bool = False, layout=None,
                  act_sharding=None):
    """(grads, loss): the gradient over every leaf of ``student`` (a tree
    like it) of the AVGLOGITS loss against the teachers' mean logits plus
    ``router_aux_coef * aux``, as the distill step takes it.  The loss
    takes float32 student logits and the teachers' in their own dtype:
    K2 on CUDA tensors, its plain version on the CPU.

    With ``layout`` (a ``TPLayout``) ``student``, ``teachers`` and
    ``batch`` are this rank's blocks and so are the gradients, each the
    global loss's.  Where the head splits the vocabulary over
    ``"model"`` the loss runs over the shards
    (``ops.ensemble_kl_loss_split``: K2s, the statistics merged over the
    model axis, K2b with the merged log-sum-exps); each data shard
    contributes its rows' share of the global mean, and the loss returned
    is summed over the data axes.  ``act_sharding`` goes to every
    forward, which checks it."""
    t_logits = teacher_logits(teachers, cfg, batch, unroll=unroll,
                              layout=layout, act_sharding=act_sharding)
    n, v = t_logits.shape[0], t_logits.shape[-1]
    rows = t_logits[0].numel() // v
    n_rows = rows * (1 if layout is None else layout.dp_size)

    def loss_fn(p):
        s_logits, aux = T.forward(p, cfg, batch, return_aux=True,
                                  remat=remat, unroll=unroll, layout=layout,
                                  act_sharding=act_sharding)
        s2, t3 = s_logits.reshape(-1, v).float(), t_logits.reshape(n, -1, v)
        if layout is not None and v != cfg.vocab_size:
            loss = ops.ensemble_kl_loss_split(s2, t3, layout.mesh,
                                              layout.model_axis, n_rows)
        else:
            loss = ops.ensemble_kl_loss(s2, t3) * (rows / n_rows)
        return loss + cfg.router_aux_coef * aux, loss.detach()

    grads, loss = _grads(student, loss_fn)
    grads = _unflatten(student, grads)
    if layout is not None:
        from repro_torch.common.sharding import all_reduce_sum
        grads = layout.sum_replicated_grads(grads, layout.pspecs)
        if layout.dp_axes:
            loss = all_reduce_sum(loss, layout.mesh, layout.dp_axes)
    return grads, loss


def make_distill_step(cfg: ArchConfig, mesh=None, *, n_teachers: int = 4,
                      batch_size: int = 128, seq_len: int = 512,
                      fsdp: bool = True, unroll: bool = False,
                      constrain_acts: bool = False, remat: bool = True,
                      param_dtype=torch.bfloat16) -> StepBundle:
    """FedDF's server fusion: K stacked teacher forwards (one after
    another) and one student AVGLOGITS update, Adam at 1e-3.  (student,
    teachers [K, ...], opt_state, step, batch) -> (student, opt_state,
    step + 1, loss); student and opt_state donated.  The loss takes
    float32 student logits and the teachers' in their own dtype: K2 on
    CUDA tensors, its plain version on the CPU (JAX runs the Pallas
    kernel's jnp reference).  On a ``mesh`` every argument is this
    rank's block (``bundle.layout``, the train step's): the student in
    the ``tp`` specs, the teachers stacked with the leading axis whole
    and the student's specs inside (JAX's ``t_specs``), the batch over
    the data axes; the loss runs over vocabulary shards
    (:func:`distill_grads`).  As in JAX the forwards take no ``mesh``: an
    MoE model's blocks take the partitioner path (the global capacity
    and aux loss); and the ``tp`` rules only (JAX's distill step takes
    no ``layout``)."""
    tp, acts = _tp(cfg, mesh, fsdp, batch_size, constrain_acts=constrain_acts)
    student = _param_structs(cfg, param_dtype, tp)
    teachers = _stacked(student, n_teachers)
    opt_state = _opt_structs(student)
    whole = {"tokens": _meta((batch_size, seq_len), torch.int32)}
    batch = batch_block(whole, tp)
    opt = adam(1e-3)

    def distill_step(student, teachers, opt_state, step, batch):
        grads, loss = distill_grads(student, teachers, cfg, batch,
                                    remat=remat and not unroll,
                                    unroll=unroll, layout=tp,
                                    act_sharding=acts)
        _adam_step(opt, student, opt_state, grads, step)
        return student, opt_state, step + 1, loss

    def make_args(gen, device):
        s = _init_block(cfg, gen, param_dtype, device, tp)
        t = [_init_block(cfg, gen, param_dtype, device, tp)
             for _ in range(n_teachers)]
        stacked = tree_map(lambda *xs: torch.stack(xs), *t)
        del t
        return (s, stacked, _zeros_like_meta(opt_state, device),
                _step_scalar("cpu"),
                batch_block(_draw_batch(whole, cfg, gen, device), tp))

    outs = (student, opt_state, _step_scalar(), _meta((), torch.float32))
    return StepBundle(distill_step, (student, teachers, opt_state,
                                     _step_scalar(), batch), outs, make_args,
                      donate_argnums=(0, 2), layout=tp)


def make_fed_round_step(cfg: ArchConfig, mesh=None, *, n_clients: int = 8,
                        local_steps: int = 4, batch_size: int = 8,
                        seq_len: int = 512, remat: bool = True,
                        unroll: bool = False, lr: float = 3e-4,
                        param_dtype=torch.bfloat16) -> StepBundle:
    """One federated round's client phase: K clients' stacked params [K,
    ...] run ``local_steps`` of plain SGD each, every update computed in
    float32 and cast back to the parameter's dtype.  JAX vmaps over the
    clients; here they run one after another (one client's activations
    live at a time) and the stacked params are updated in place
    (donated).  (stacked, batch) -> stacked.  On a ``mesh`` the clients
    spread over its data axes (the ``shard_clients`` rules, fsdp off,
    fitted to K as ``fit_pspec`` fits them): ``args`` and ``fn`` are this
    rank's ``client_slice`` of the K; with a ``"model"`` axis > 1 each
    client's replica is tensor-parallel over it (``bundle.layout``; the
    stacked leaves are this rank's blocks, the client's batch whole on
    every model rank)."""
    client_slice, client_axes, tp = slice(0, n_clients), (), None
    if mesh is not None:
        client_slice, client_axes = _client_block(mesh, n_clients)
        tp = _client_layout(cfg, mesh)
    k_local = client_slice.stop - client_slice.start
    params = _param_structs(cfg, param_dtype, tp)
    stacked = _stacked(params, k_local)
    shape4 = (k_local, local_steps, batch_size, seq_len)
    batch = {"tokens": _meta(shape4, torch.int32),
             "labels": _meta(shape4, torch.int32)}

    def fed_round_step(stacked_params, batch):
        for k in range(k_local):
            p = tree_map(lambda x: x[k], stacked_params)
            for i in range(local_steps):
                t, lab = batch["tokens"][k, i], batch["labels"][k, i]

                def loss_fn(pp):
                    logits, aux = T.forward(
                        pp, cfg, {"tokens": t, "labels": lab},
                        return_aux=True, remat=remat and not unroll,
                        unroll=unroll, layout=tp,
                        mesh=None if tp is None else tp.mesh)
                    return (token_xent(logits, lab, cfg, tp)
                            + cfg.router_aux_coef * aux), None

                g, _ = _grads(p, loss_fn)
                with torch.no_grad():
                    for w, gw in zip(tree_leaves(p), g):
                        w.copy_((w.float() - lr * gw.float()).to(w.dtype))
                del g
        return stacked_params

    def make_args(gen, device):
        t = [_init_block(cfg, gen, param_dtype, device, tp)
             for _ in range(k_local)]
        s = tree_map(lambda *xs: torch.stack(xs), *t)
        del t
        return s, _draw_batch(batch, cfg, gen, device)

    return StepBundle(fed_round_step, (stacked, batch), stacked, make_args,
                      donate_argnums=(0,), client_slice=client_slice,
                      client_axes=client_axes, layout=tp)


def _client_block(mesh, n_clients: int) -> Tuple[slice, Tuple[str, ...]]:
    """This rank's contiguous block of the client axis and the mesh axes
    it splits over: JAX's ``P(client_axes)`` fitted to ``n_clients``."""
    from repro_torch.common import sharding as shd
    names = shd.axis_names(mesh)
    rules = shd.make_rules(multi_pod="pod" in names, fsdp=False,
                           shard_clients=True)
    entry = shd.fit_pspec(shd.logical_to_pspec(("clients",), rules),
                          (n_clients,), mesh)[0]
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    index, n_blocks = shd.block_index(mesh, axes)
    per = n_clients // n_blocks
    return slice(index * per, (index + 1) * per), axes


def _client_layout(cfg: ArchConfig, mesh):
    """A client's tensor-parallel layout on ``mesh`` (None without a
    ``"model"`` axis > 1): the ``shard_clients`` rules with fsdp off, the
    client's batch whole on every rank of it."""
    from repro_torch.common import sharding as shd
    names = shd.axis_names(mesh)
    if "model" not in names or shd.axis_size(mesh, "model") == 1:
        return None
    rules = shd.make_rules(multi_pod="pod" in names, fsdp=False,
                           shard_clients=True)
    return T.tp_layout(cfg, mesh, rules, ())


def make_step(cfg: ArchConfig, shape: InputShape, mesh=None,
              **kw) -> StepBundle:
    if shape.kind == "train":
        return make_train_step(cfg, shape, mesh, **kw)
    kw.pop("remat", None)
    kw.pop("use_moe_shard_map", None)
    kw.pop("naive_xent", None)
    kw.pop("microbatch", None)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, mesh, **kw)
    kw.pop("constrain_acts", None)  # decode: cache rules govern layout
    kw.pop("layout", None)
    return make_serve_step(cfg, shape, mesh, **kw)
