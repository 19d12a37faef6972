"""Step builders: per (architecture x input shape) programs with their
input stand-ins (the JAX package's ``launch/steps.py`` in PyTorch, on one
device).

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

``make_fed_round_step`` takes a mesh with a data axis (``launch/mesh.
py``): its clients spread over every data axis (``("pod", "data")``
where present) by the ``shard_clients`` rules with ``fsdp=False``, and
the bundle's ``args`` / ``fn`` are this rank's block of them
(``bundle.client_slice`` of the global client axis, ``client_axes`` the
mesh axes it splits over).  Its ``"model"`` axis must be 1.  The other
builders run one device: a ``mesh``, ``layout`` other than ``"tp"``,
``constrain_acts`` or ``use_moe_shard_map`` with a mesh raises, as does
a model axis larger than 1 (ROADMAP queue 1 item 11.8, the model axis);
``fsdp`` shards nothing on one device either way.  ``batch_pspecs``,
``_shardings`` and ``kv_cache_rules`` in the steps wait for 11.8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.api.experiment import resolve_device
from repro_torch.common.arch_config import ArchConfig
from repro_torch.common.pytree import (tree_leaves, tree_leaves_jax,
                                       tree_map)
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.frontends import (fake_audio_frames,
                                          fake_vision_patches)
from repro_torch.optim.optimizers import AdamState, adam, apply_updates

META = torch.device("meta")
PENDING = ("not ported yet (ROADMAP queue 1 item 11.8: the model axis "
           "and parameter shardings); the port's step builders but the "
           "federated round's client axis run one device")


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
                     cfg: ArchConfig) -> torch.Tensor:
    """v0 loss: slices the logits and gathers the label logit (JAX keeps
    it for its sharding record; here it is the same loss by another
    route)."""
    if cfg.frontend == "vision_patches":
        logits = logits[:, cfg.n_frontend_tokens:]
        labels = labels[:, : logits.shape[1]]
    if cfg.is_decoder:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())
    return torch.mean(nll)


def token_xent(logits: torch.Tensor, labels: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """Next-token LM loss for decoders; per-frame classification for
    encoders.  VLM: the prepended patch positions are masked out.  The
    labels are rolled and the last position masked, as JAX writes it to
    keep the logits whole; the label logit is gathered (JAX's one-hot
    select sums it with zeros: the same value)."""
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
    z = torch.logsumexp(lg, dim=-1)                              # [B,S]
    picked = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    return (torch.sum((z - picked) * mask)
            / torch.sum(mask * torch.ones((b, 1), device=logits.device)))


# ---------------------------------------------------------------------------
# Structures
# ---------------------------------------------------------------------------

def _param_structs(cfg: ArchConfig, dtype=torch.bfloat16):
    return tree_map(lambda s: _meta(s.shape, dtype), T.param_specs(cfg))


def _opt_structs(params) -> AdamState:
    """Adam's float32 moments, trees like ``params`` (as JAX holds them)."""
    f32 = lambda: tree_map(lambda p: _meta(p.shape, torch.float32), params)
    return AdamState(f32(), f32())


def _stacked(params, n: int):
    return tree_map(lambda s: _meta((n,) + tuple(s.shape), s.dtype), params)


def _zeros_like_meta(tree, device):
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                          device=device), tree)


def _no_mesh(mesh, **knobs) -> None:
    """Raise for a mesh or a sharding knob the single device cannot mean."""
    if mesh is not None:
        raise NotImplementedError(f"mesh={mesh!r}: {PENDING}")
    for name, (value, one_device) in knobs.items():
        if value != one_device:
            raise NotImplementedError(f"{name}={value!r}: {PENDING}")


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
                unroll: bool = False, naive_xent: bool = False):
    """(grads, {"loss", "moe_aux"}): the gradient of ``loss +
    router_aux_coef * aux`` over every leaf of ``params`` (a tree like
    it), as the train step takes it.  With ``microbatch`` > 1 the batch
    is split along its first axis and the gradients accumulated in
    float32, then averaged (JAX's scan over microbatch slices)."""
    xent = token_xent_naive if naive_xent else token_xent
    dtype = tree_leaves(params)[0].dtype

    def one(mb):
        mb = _as_param_dtype(mb, dtype)

        def loss_fn(p):
            logits, aux = T.forward(p, cfg, mb, return_aux=True,
                                    remat=remat, unroll=unroll)
            loss = xent(logits, mb["labels"], cfg)
            return loss + cfg.router_aux_coef * aux, (loss.detach(),
                                                      aux.detach())
        return _grads(params, loss_fn)

    if microbatch == 1:
        grads, (loss, aux) = one(batch)
    else:
        b = next(iter(batch.values())).shape[0]
        if b % microbatch:
            raise ValueError(f"batch {b} is not a multiple of microbatch "
                             f"{microbatch}")
        n = b // microbatch
        leaves = tree_leaves(params)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        aux = torch.zeros_like(loss)
        for i in range(microbatch):
            g, (l, a) = one({k: v[i * n: (i + 1) * n]
                             for k, v in batch.items()})
            torch._foreach_add_(grads, g)
            loss, aux = loss + l, aux + a
            del g
        torch._foreach_div_(grads, float(microbatch))
        loss, aux = loss / microbatch, aux / microbatch
    return _unflatten(params, grads), {"loss": loss, "moe_aux": aux}


def _adam_step(opt, params, opt_state: AdamState, grads, step) -> AdamState:
    """One Adam update of ``params`` and ``opt_state`` (trees like it) in
    place; leaves pair by path (the JAX package's order), whatever each
    tree's key order."""
    leaves = tree_leaves_jax(params)
    state = AdamState(tree_leaves_jax(opt_state.mu),
                      tree_leaves_jax(opt_state.nu))
    deltas, new = opt.update(tree_leaves_jax(grads), state, leaves,
                             int(step))
    updated = apply_updates(leaves, deltas)
    with torch.no_grad():
        for dst, src in zip(leaves + state.mu + state.nu,
                            updated + new.mu + new.nu):
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
    opt_state are donated (updated in place)."""
    del fsdp, use_moe_shard_map        # one device: nothing to shard
    _no_mesh(mesh, layout=(layout, "tp"),
             constrain_acts=(constrain_acts, False))
    params = _param_structs(cfg, param_dtype)
    opt_state = _opt_structs(params)
    batch = input_specs(cfg, shape)
    opt = adam(3e-4)

    def train_step(params, opt_state, step, batch):
        grads, metrics = train_grads(params, cfg, batch,
                                     microbatch=microbatch, remat=remat,
                                     unroll=unroll, naive_xent=naive_xent)
        _adam_step(opt, params, opt_state, grads, step)
        return params, opt_state, step + 1, metrics

    def make_args(gen, device):
        p = T.init(cfg, gen, param_dtype, device)
        return (p, _zeros_like_meta(opt_state, device),
                _step_scalar("cpu"), _draw_batch(batch, cfg, gen, device))

    outs = (params, opt_state, _step_scalar(),
            {"loss": _meta((), torch.float32),
             "moe_aux": _meta((), torch.float32)})
    return StepBundle(train_step, (params, opt_state, _step_scalar(), batch),
                      outs, make_args, donate_argnums=(0, 1))


def make_prefill_step(cfg: ArchConfig, shape: InputShape, mesh=None, *,
                      fsdp: bool = True, unroll: bool = False,
                      layout: str = "tp", constrain_acts: bool = False,
                      param_dtype=torch.bfloat16) -> StepBundle:
    """(params, batch) -> (next-token logits [B, 1, V], caches sized
    ``shape.seq_len``)."""
    del fsdp, unroll
    _no_mesh(mesh, layout=(layout, "tp"),
             constrain_acts=(constrain_acts, False))
    params = _param_structs(cfg, param_dtype)
    batch = input_specs(cfg, shape)
    max_seq = shape.seq_len

    def prefill_step(params, batch):
        with torch.no_grad():
            return T.prefill(params, cfg,
                             _as_param_dtype(batch, param_dtype), max_seq,
                             last_only=True)

    def make_args(gen, device):
        return (T.init(cfg, gen, param_dtype, device),
                _draw_batch(batch, cfg, gen, device))

    outs = (_meta((shape.global_batch, 1, cfg.vocab_size), param_dtype),
            T.init_caches(cfg, shape.global_batch, max_seq, param_dtype,
                          META))
    return StepBundle(prefill_step, (params, batch), outs, make_args)


def make_serve_step(cfg: ArchConfig, shape: InputShape, mesh=None, *,
                    fsdp: bool = True, unroll: bool = False,
                    param_dtype=torch.bfloat16,
                    cache_dtype=torch.bfloat16) -> StepBundle:
    """One-token decode against a populated cache of ``shape.seq_len``
    tokens: (params, batch, caches, cur_len) -> (logits [B, 1, V],
    caches), the caches donated (updated in place)."""
    del fsdp, unroll
    _no_mesh(mesh)
    params = _param_structs(cfg, param_dtype)
    batch = input_specs(cfg, shape)
    caches = T.init_caches(cfg, shape.global_batch, shape.seq_len,
                           cache_dtype, META)
    cur_len = _step_scalar()

    def serve_step(params, batch, caches, cur_len):
        with torch.no_grad():
            return T.decode_step(params, cfg, batch, caches, int(cur_len))

    def make_args(gen, device):
        return (T.init(cfg, gen, param_dtype, device),
                _draw_batch(batch, cfg, gen, device),
                _zeros_like_meta(caches, device), _step_scalar("cpu"))

    outs = (_meta((shape.global_batch, 1, cfg.vocab_size), param_dtype),
            caches)
    return StepBundle(serve_step, (params, batch, caches, cur_len), outs,
                      make_args, donate_argnums=(2,))


def teacher_logits(teachers, cfg: ArchConfig, batch: dict, *,
                   unroll: bool = False) -> torch.Tensor:
    """[K, B, S, V] logits of the stacked ``teachers`` [K, ...], one
    forward after another (JAX vmaps them)."""
    k = tree_leaves(teachers)[0].shape[0]
    with torch.no_grad():
        out = None
        for i in range(k):
            lg = T.forward(tree_map(lambda x: x[i], teachers), cfg, batch,
                           unroll=unroll)
            if out is None:
                out = lg.new_empty((k,) + tuple(lg.shape))
            out[i] = lg
            del lg
    return out


def distill_grads(student, teachers, cfg: ArchConfig, batch: dict, *,
                  remat: bool = True, unroll: bool = False):
    """(grads, loss): the gradient over every leaf of ``student`` (a tree
    like it) of the AVGLOGITS loss against the teachers' mean logits plus
    ``router_aux_coef * aux``, as the distill step takes it.  The loss
    takes float32 student logits and the teachers' in their own dtype:
    K2 on CUDA tensors, its plain version on the CPU."""
    t_logits = teacher_logits(teachers, cfg, batch, unroll=unroll)
    n, v = t_logits.shape[0], t_logits.shape[-1]

    def loss_fn(p):
        s_logits, aux = T.forward(p, cfg, batch, return_aux=True,
                                  remat=remat, unroll=unroll)
        loss = ops.ensemble_kl_loss(s_logits.reshape(-1, v).float(),
                                    t_logits.reshape(n, -1, v))
        return loss + cfg.router_aux_coef * aux, loss.detach()

    grads, loss = _grads(student, loss_fn)
    return _unflatten(student, grads), loss


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
    kernel's jnp reference)."""
    del fsdp
    _no_mesh(mesh, constrain_acts=(constrain_acts, False))
    student = _param_structs(cfg, param_dtype)
    teachers = _stacked(student, n_teachers)
    opt_state = _opt_structs(student)
    batch = {"tokens": _meta((batch_size, seq_len), torch.int32)}
    opt = adam(1e-3)

    def distill_step(student, teachers, opt_state, step, batch):
        grads, loss = distill_grads(student, teachers, cfg, batch,
                                    remat=remat and not unroll,
                                    unroll=unroll)
        _adam_step(opt, student, opt_state, grads, step)
        return student, opt_state, step + 1, loss

    def make_args(gen, device):
        s = T.init(cfg, gen, param_dtype, device)
        t = [T.init(cfg, gen, param_dtype, device)
             for _ in range(n_teachers)]
        stacked = tree_map(lambda *xs: torch.stack(xs), *t)
        del t
        return (s, stacked, _zeros_like_meta(opt_state, device),
                _step_scalar("cpu"), _draw_batch(batch, cfg, gen, device))

    outs = (student, opt_state, _step_scalar(), _meta((), torch.float32))
    return StepBundle(distill_step, (student, teachers, opt_state,
                                     _step_scalar(), batch), outs, make_args,
                      donate_argnums=(0, 2))


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
    rank's ``client_slice`` of the K."""
    client_slice, client_axes = slice(0, n_clients), ()
    if mesh is not None:
        client_slice, client_axes = _client_block(mesh, n_clients)
    k_local = client_slice.stop - client_slice.start
    params = _param_structs(cfg, param_dtype)
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
                        unroll=unroll)
                    return (token_xent(logits, lab, cfg)
                            + cfg.router_aux_coef * aux), None

                g, _ = _grads(p, loss_fn)
                with torch.no_grad():
                    for w, gw in zip(tree_leaves(p), g):
                        w.copy_((w.float() - lr * gw.float()).to(w.dtype))
                del g
        return stacked_params

    def make_args(gen, device):
        t = [T.init(cfg, gen, param_dtype, device)
             for _ in range(k_local)]
        s = tree_map(lambda *xs: torch.stack(xs), *t)
        del t
        return s, _draw_batch(batch, cfg, gen, device)

    return StepBundle(fed_round_step, (stacked, batch), stacked, make_args,
                      donate_argnums=(0,), client_slice=client_slice,
                      client_axes=client_axes)


def _client_block(mesh, n_clients: int) -> Tuple[slice, Tuple[str, ...]]:
    """This rank's contiguous block of the client axis and the mesh axes
    it splits over: JAX's ``P(client_axes)`` fitted to ``n_clients``."""
    from repro_torch.common import sharding as shd
    names = shd.axis_names(mesh)
    if "model" in names and shd.axis_size(mesh, "model") > 1:
        raise NotImplementedError(
            f"a 'model' mesh axis of {shd.axis_size(mesh, 'model')}: "
            f"{PENDING}")
    rules = shd.make_rules(multi_pod="pod" in names, fsdp=False,
                           shard_clients=True)
    entry = shd.fit_pspec(shd.logical_to_pspec(("clients",), rules),
                          (n_clients,), mesh)[0]
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    n_blocks, index = 1, 0
    for a in axes:
        n_blocks *= shd.axis_size(mesh, a)
        index = index * shd.axis_size(mesh, a) + shd.axis_index(mesh, a)
    per = n_clients // n_blocks
    return slice(index * per, (index + 1) * per), axes


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
