"""JAX's MoE partitioner path on the port's meshes (ROADMAP item
11.8.4(c)): ``moe_block`` over experts split on ``"model"`` and tokens
split over the data axes (``_moe_global``), the MoE under the
``dp_heavy*`` layouts, ``use_moe_shard_map=False``, and an MoE model's
distill and serve steps on a mesh, on gloo ranks on the CPU, against the
JAX package and the port's one-device runs.

One module-scoped ``launch_ranks`` world of 4 ranks runs the 2 x 2 cases
and one of 2 ranks, started beside it, the 2 x 1 and 1 x 2 cases (a mesh
spans its whole world).  The ranks import no JAX; the parent computes the
references meanwhile, JAX's expert-parallel ones in a subprocess with 4
forced host devices (``tests/test_torch_model_axis.py``'s pattern).
Every case runs at the default capacity factor, where slots drop: the
block inputs lean towards expert 0, and the step cases' tokens (seed 2)
drop slots on one device and on each data shard; each case asserts its
drops.

* ``moe_block(layout=...)`` (no mesh: the partitioner path) on 2 x 2
  (rows over ``"data"``, experts over ``"model"``), 2 x 1 (experts whole),
  1 x 2, 2 x 2 with the rows over both axes (``dp_heavy``) and 2 x 2 with
  one row whole on every rank, on reduced granite-moe-1b-a400m and
  qwen3-moe-235b-a22b: against JAX's ``moe_block(mesh=None)`` on the
  global tokens, the output within ``MOE_ATOL``, the aux loss within
  ``AUX_ATOL``, and the dropped (token, slot) choices equal to those of
  JAX's ``_moe_capacity`` (the choices past each expert's capacity in flat
  order, from JAX's expert choices).  A batch of one token (``T * k <
  E``) takes the gather route over split experts.
* ``moe_block(mesh=...)`` under ``dp_heavy`` (the rows over both axes,
  gathered over ``"model"``) and with one row whole on every rank (the
  tokens cut over ``"data"``, as JAX's ``shard_map`` cuts them): against
  JAX's own ``moe_block(mesh=jax.make_mesh((2, 2)))``.
* The same 2 x 2 world's expert-parallel route (``mesh=``) drops other
  choices and gives another aux loss than the partitioner path: the two
  routes differ.
* The train step (``make_train_step``'s gradients, taken from its Adam
  call, gathered whole) under ``dp_heavy`` on 1 x 2 (one data shard:
  the one device's capacity) and 2 x 2, ``dp_heavy_z3`` on 2 x 2, and
  ``use_moe_shard_map=False`` under ``tp`` and under ``dp_heavy_z3`` with
  a batch the axes do not divide; the distill step on 2 x 2; held within
  ``SPREAD_FACTOR`` times the port's own 1-ulp spread against the
  one-device port (or, where two data shards each route their own, JAX's
  gradient on its 2 x 2 mesh of 4 forced host devices), and against
  JAX's step on a 1 x 1 mesh within ``SPREAD_FACTOR`` times the larger
  spread plus the one-device port's gap (ROADMAP queue 3's convention);
  the loss within ``LOSS_REL``; each layer's dropped slots equal to the
  one-device run's (the partitioner path) or to each data shard's own run
  (the expert-parallel route).
* A prefill on 2 x 2 (expert-parallel, two data shards) and on 1 x 2,
  then ``N_TOK`` tokens through ``make_serve_step`` (the partitioner
  path: the decode batch's tokens gathered; at batch 1, ``T * k < E``,
  the gather route over split experts): each token's logits within
  ``SERVE_REL`` of the largest against the one-device prefill of each
  data shard's rows and ``decode_step`` of the whole batch.
* A gpu-marked ``moe_block`` on the partitioner path over 2 gloo ranks
  sharing the card, against the same call on the CPU.
"""
import concurrent.futures
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh
from test_torch_model_axis import (SPREAD_FACTOR, _flat_np, _nudged_t, _rel,
                                   _to_jax)

MOE_ATOL, AUX_ATOL = 1e-4, 1e-6       # test_torch_model_axis.py's
LOSS_REL = 1e-5
SERVE_REL = 1e-3                      # tests/test_torch_serve.py's
B, S = 4, 16
PROMPT, MAX_SEQ, N_TOK = 12, 24, 3
TEACHERS = 2
RANK_TIMEOUT_S = 300
NAMES = ("data", "model")
ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")
GRANITE = ARCHS[0]
TOKEN_SEED = 2           # drops slots on one device and on each data shard
LEAN = 0.3               # the block inputs' lean towards expert 0

# (id, mesh, the rows' axes, the layout's data axes, rows of x)
BLOCK_CASES = [
    ("2x2", (2, 2), ("data",), ("data",), B),
    ("2x1", (2, 1), ("data",), ("data",), B),
    ("1x2", (1, 2), ("data",), ("data",), B),
    ("2x2-dph", (2, 2), NAMES, NAMES, B),
    ("2x2-whole", (2, 2), (), ("data",), 1),
    ("2x2-one-token", (2, 2), (), ("data",), "token"),
]
# (id, arch, mesh, batch, make_train_step's knobs, the reference: "port"
#  the one-device port, "jax2x2" JAX's gradient on its 2 x 2 mesh)
TRAIN_CASES = [
    ("dph-1x2", GRANITE, (1, 2), B, dict(layout="dp_heavy"), "port"),
    ("dph-2x2", GRANITE, (2, 2), B, dict(layout="dp_heavy"), "jax2x2"),
    ("z3-2x2", GRANITE, (2, 2), B, dict(layout="dp_heavy_z3"), "jax2x2"),
    ("noep-2x2", GRANITE, (2, 2), B, dict(use_moe_shard_map=False), "port"),
    ("qwen3moe-noep-2x2", ARCHS[1], (2, 2), B,
     dict(use_moe_shard_map=False), "port"),
    ("z3-noep-2x2-b2", GRANITE, (2, 2), 2,
     dict(layout="dp_heavy_z3", use_moe_shard_map=False), "port"),
]
# (id, mesh, batch): a prefill, then N_TOK tokens through the serve step
SERVE_CASES = [("serve-2x2", (2, 2), B), ("serve-1x2-b1", (1, 2), 1)]


def _cfg(arch):
    from repro_torch import configs
    from repro_torch.common.arch_config import reduced
    return reduced(configs.get(arch))


def _init(arch, layout=None, seed=0):
    from repro_torch.models import transformer as T
    return T.init(_cfg(arch), torch.Generator().manual_seed(seed),
                  layout=layout)


def _tokens(cfg, rows, cols, seed=TOKEN_SEED):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (rows, cols)).astype(np.int32)


def _block_inputs(arch):
    """The MoE's parameters and a [B, S, d] input, from numpy: the input
    leans along a direction the router favours for expert 0, so that the
    global batch and each data shard overflow it."""
    from repro_torch.models import moe
    cfg = _cfg(arch)
    rng = np.random.default_rng(3)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(
        np.float32) for k, s in moe.moe_specs(cfg).items()}
    lean = rng.standard_normal(cfg.d_model) / np.sqrt(cfg.d_model)
    p["router"][:, 0] += (LEAN * lean).astype(np.float32)
    x = (rng.standard_normal((B, S, cfg.d_model))
         + LEAN * lean * np.sqrt(cfg.d_model)).astype(np.float32)
    return p, x


def _case_x(x, rows):
    """A block case's input: ``rows`` rows of x, or one token."""
    return x[:1, :1] if rows == "token" else x[:rows]


def _jax_dropped(idx: np.ndarray, n_experts: int, cap: int) -> set:
    """The (token, slot) choices JAX's ``_moe_capacity`` drops: within
    each expert, the choices in flat (token, slot) order past the first
    ``cap``."""
    seen = [0] * n_experts
    dropped = set()
    for tok, slots in enumerate(idx):
        for slot, e in enumerate(slots):
            seen[e] += 1
            if seen[e] > cap:
                dropped.add((tok, slot))
    return dropped


# ---------------------------------------------------------------------------
# what the ranks run (port code only)
# ---------------------------------------------------------------------------

class _Drops:
    """While open, each ``moe.dispatch`` call appends the (token, slot)
    choices of this rank's experts it drops, by their index in the
    tokens it dispatched."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe.dispatch

        def dispatch(cfg, idx, e_start, e_local):
            dp = self._orig(cfg, idx, e_start, e_local)
            fe = idx.reshape(-1)
            mine = (fe >= e_start) & (fe < e_start + e_local)
            lost = dp.order[~dp.valid & mine[dp.order]]
            k = idx.shape[1]
            self.calls.append(sorted((int(f) // k, int(f) % k)
                                     for f in lost))
            return dp
        moe.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.dispatch = self._orig


def _local_experts(p: dict, cfg, mesh) -> dict:
    """This rank's block of the MoE's numpy parameters: its experts of
    the ``"model"`` axis (all of them where the axis does not divide
    them), the router whole."""
    from repro_torch.common import sharding as shd
    m = shd.axis_size(mesh, "model")
    per = cfg.n_experts // m if cfg.n_experts % m == 0 else cfg.n_experts
    e0 = shd.axis_index(mesh, "model") * per if per != cfg.n_experts else 0
    return {k: torch.from_numpy(v if k == "router" else v[e0:e0 + per])
            for k, v in p.items()}


def _rows(x: torch.Tensor, mesh, rows) -> torch.Tensor:
    """This rank's block of ``x``'s rows over ``rows``."""
    from repro_torch.common import sharding as shd
    i, n = shd.block_index(mesh, rows)
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def _world_drops(calls: list) -> list:
    """Each call's dropped choices, the union over every rank."""
    from repro_torch.common import sharding as shd
    every = shd.all_gather_object(calls)
    return [sorted({c for r in every for c in r[i]})
            for i in range(len(calls))]


def block_case(arch, inputs, shape, rows, dp_axes, n_rows, mesh_route):
    """``moe_block`` on this rank's rows and experts: (the output
    gathered whole, the aux loss, the dropped choices of every call over
    every rank, by global token).  ``mesh_route``: the expert-parallel
    route (``mesh=``), whose shards' token indices are shifted to the
    global ones; else the partitioner path (``layout=`` alone)."""
    from repro_torch.common import sharding as shd
    from repro_torch.models import moe
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, NAMES)
    layout = shd.TPLayout(mesh, None, dp_axes)
    layout.batch_axes = rows
    p, x = inputs
    x = torch.from_numpy(_case_x(x, n_rows))
    local = _local_experts(p, cfg, mesh)
    with _Drops() as rec:
        if mesh_route:
            out, aux = moe.moe_block(local, cfg, _rows(x, mesh, rows),
                                     mesh=mesh, dp_axes=("data",),
                                     layout=layout)
        else:
            out, aux = moe.moe_block(local, cfg, _rows(x, mesh, rows),
                                     layout=layout)
    calls = rec.calls
    if mesh_route:              # JAX's data shard: a block of the tokens
        t = x.shape[0] * x.shape[1]
        shard = shd.axis_index(mesh, "data") * t // shd.axis_size(mesh,
                                                                  "data")
        calls = [[(tok + shard, s) for tok, s in c] for c in calls]
    entry = None if not rows else rows[0] if len(rows) == 1 else rows
    whole = shd.gather_tensor(out, shd.P(entry, None, None), mesh)
    return whole.numpy(), float(aux), _world_drops(calls)


def _zero_opt(params):
    from repro_torch.common.pytree import tree_map
    from repro_torch.optim.optimizers import AdamState
    return AdamState(*(tree_map(torch.zeros_like, params)
                       for _ in range(2)))


def _builder_grads(bundle, args):
    """(the gradients a step's Adam takes, the step's results)."""
    from repro_torch.launch import steps
    took, orig = [], steps._adam_step

    def adam_step(opt, params, opt_state, grads, step):
        took.append(grads)
        return orig(opt, params, opt_state, grads, step)
    steps._adam_step = adam_step
    try:
        out = bundle.fn(*args)
    finally:
        steps._adam_step = orig
    return took[0], out


def _layer_drops(calls, n_layers: int, mesh) -> list:
    """Each layer's dropped slots in the forward (remat's recompute comes
    after), summed over the model axis: the global batch's (the
    partitioner path) or this data shard's (expert-parallel)."""
    from repro_torch.common import sharding as shd
    mine = torch.tensor([float(len(c)) for c in calls[:n_layers]])
    return [int(v) for v in shd.all_reduce_sum(mine, mesh, ("model",))]


def train_case(arch, shape, b, kw) -> dict:
    """One ``make_train_step`` from zero moments: its gradients gathered
    whole, the loss, each layer's drops."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, NAMES)
    bundle = steps.make_train_step(cfg, InputShape("t", S, b, "train"), mesh,
                                   param_dtype=torch.float32, **kw)
    tp = bundle.layout
    params = _init(arch, tp)
    toks = torch.from_numpy(_tokens(cfg, b, S))
    with _Drops() as rec:
        grads, (_, _, _, m) = _builder_grads(bundle, (
            params, _zero_opt(params), torch.zeros((), dtype=torch.int32),
            steps.batch_block({"tokens": toks, "labels": toks}, tp)))
    out = {"loss": float(m["loss"]), "aux": float(m["moe_aux"]),
           "drops": _layer_drops(rec.calls, cfg.n_layers, mesh),
           "data": shd.axis_index(mesh, "data")}
    g = shd.gather_tree(grads, tp.pspecs, mesh)
    if tmesh.world_rank() == 0:
        out["grads"] = _flat_np(g)
    return out


def _teachers(arch, layout=None):
    from repro_torch.common.pytree import tree_map
    return tree_map(lambda *xs: torch.stack(xs), *[
        _init(arch, layout, 10 + i) for i in range(TEACHERS)])


def distill_case(arch, shape) -> dict:
    """One ``make_distill_step`` (its forwards on the partitioner path):
    its gradients gathered whole and its loss."""
    from repro_torch.common import sharding as shd
    from repro_torch.launch import steps
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, NAMES)
    bundle = steps.make_distill_step(cfg, mesh, n_teachers=TEACHERS,
                                     batch_size=B, seq_len=S,
                                     param_dtype=torch.float32)
    tp = bundle.layout
    student = _init(arch, tp)
    toks = torch.from_numpy(_tokens(cfg, B, S, 4))
    with _Drops() as rec:
        grads, (_, _, _, loss) = _builder_grads(bundle, (
            student, _teachers(arch, tp), _zero_opt(student),
            torch.zeros((), dtype=torch.int32),
            steps.batch_block({"tokens": toks}, tp)))
    out = {"loss": float(loss), "drops": sum(len(c) for c in rec.calls)}
    g = shd.gather_tree(grads, tp.pspecs, mesh)
    if tmesh.world_rank() == 0:
        out["grads"] = _flat_np(g)
    return out


def serve_case(arch, shape, b) -> dict:
    """A prefill of the prompt on ``shape``, its caches into the serve
    layout, then N_TOK tokens through ``make_serve_step``: the prefill's
    next-token logits and each token's, gathered whole."""
    from repro_torch.common import sharding as shd
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, NAMES)
    toks = torch.from_numpy(_tokens(cfg, b, PROMPT + N_TOK, 5))
    pre = steps.make_prefill_step(cfg, InputShape("p", MAX_SEQ, b,
                                                  "prefill"), mesh,
                                  param_dtype=torch.float32)
    serve = steps.make_serve_step(cfg, InputShape("d", MAX_SEQ, b, "decode"),
                                  mesh, param_dtype=torch.float32,
                                  cache_dtype=torch.float32)
    logits, caches = pre.fn(_init(arch, pre.layout), steps.batch_block(
        {"tokens": toks[:, :PROMPT]}, pre.layout))
    rows = lambda tp: shd.P(tp.batch_entry, None, None)
    out = {"prefill": shd.gather_tensor(logits, rows(pre.layout),
                                        mesh).numpy(), "decode": []}
    caches = T.serve_caches(caches, cfg, pre.layout, serve.layout)
    params, tp = _init(arch, serve.layout), serve.layout
    with _Drops() as rec:
        for i in range(N_TOK):
            tok = steps.batch_block(
                {"tokens": toks[:, PROMPT + i:PROMPT + i + 1]}, tp)
            lg, _ = serve.fn(params, tok, caches, PROMPT + i)
            out["decode"].append(shd.gather_tensor(lg, rows(tp),
                                                   mesh).numpy())
    out["capacity_calls"] = len(rec.calls)
    return out


def rank_suite(block_inputs):
    """Every case whose mesh this world's size fits, in order."""
    n = tmesh.world_size()
    out = {}
    for arch in ARCHS:
        for cid, shape, rows, dp, n_rows in BLOCK_CASES:
            if math.prod(shape) == n:
                out[(arch, cid)] = block_case(arch, block_inputs[arch],
                                              shape, rows, dp, n_rows, False)
        if n == 4:
            for cid, rows, dp, n_rows in (("ep-2x2", ("data",), ("data",), B),
                                          ("ep-dph", NAMES, NAMES, B),
                                          ("ep-whole", (), ("data",), 1)):
                out[(arch, cid)] = block_case(arch, block_inputs[arch],
                                              (2, 2), rows, dp, n_rows, True)
    for cid, arch, shape, b, kw, _ in TRAIN_CASES:
        if math.prod(shape) == n:
            out[cid] = train_case(arch, shape, b, kw)
    if n == 4:
        out["distill"] = distill_case(GRANITE, (2, 2))
    for cid, shape, b in SERVE_CASES:
        if math.prod(shape) == n:
            out[cid] = serve_case(GRANITE, shape, b)
    return out


# ---------------------------------------------------------------------------
# the parent: the references
# ---------------------------------------------------------------------------

JAX_MESH = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.common.arch_config import reduced
from repro.launch import steps
from repro.models import moe as moe_mod
from repro.models import transformer as JT
got = np.load(sys.argv[1])
res = {}
mesh = jax.make_mesh((2, 2), ("data", "model"))
for a, arch in enumerate(sys.argv[3].split(",")):
    cfg = reduced(configs.get(arch))
    p = {k.split("_", 2)[2]: jnp.asarray(got[k]) for k in got.files
         if k.startswith(f"p_{a}_")}
    block = jax.jit(lambda p, x: moe_mod.moe_block(
        p, cfg, x, mesh=mesh, dp_axes=("data",)))
    for tag, x in (("rows", got[f"x_{a}"]), ("whole", got[f"x_{a}"][:1])):
        out, aux = block(p, jnp.asarray(x))
        res[f"out_{a}_{tag}"], res[f"aux_{a}_{tag}"] = (np.asarray(out),
                                                        np.asarray(aux))
# granite's train-step loss and gradients on this mesh, as
# make_train_step takes them, at the parameters and their 1-ulp nudge
ct = reduced(configs.get(sys.argv[3].split(",")[0]))
treedef = jax.tree.structure(jax.eval_shape(
    lambda: JT.init(ct, jax.random.PRNGKey(0), jnp.float32)))
batch = {"tokens": got["tokens"], "labels": got["tokens"]}


def loss(p, batch):
    lg, aux = JT.forward(p, ct, batch, mesh=mesh, dp_axes=("data",))
    lv = steps.token_xent(lg, batch["labels"], ct)
    return lv + ct.router_aux_coef * aux, {"loss": lv, "moe_aux": aux}


grad = jax.jit(jax.grad(loss, has_aux=True))
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
for tag in ("t", "n"):
    leaves = [jnp.asarray(got[f"{tag}_{i}"])
              for i in range(treedef.num_leaves)]
    with mesh:
        g, m = grad(jax.tree.unflatten(treedef, leaves), batch)
    res.update({f"g{tag}_{i}": np.asarray(v)
                for i, v in enumerate(jax.tree.leaves(g))})
    if tag == "t":
        res.update(loss=np.asarray(m["loss"]), aux=np.asarray(m["moe_aux"]))
np.savez(sys.argv[2], **res)
"""


def _jax_mesh(tmp, block_inputs):
    """JAX on a 2 x 2 mesh of 4 host devices: ``moe_block``'s
    expert-parallel output and aux per arch, at the B rows and at one
    row; granite's train-step loss, aux and gradients (the port's leaf
    paths) at the parameters and at their 1-ulp nudge."""
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro_torch.common.pytree import tree_leaves_jax
    from test_torch_model_axis import _from_jax
    pt = _init(GRANITE)
    arrays = {f"{tag}_{i}": v.numpy() for tag, tree in
              (("t", pt), ("n", _nudged_t(pt)))
              for i, v in enumerate(tree_leaves_jax(tree))}
    for a, arch in enumerate(ARCHS):
        p, x = block_inputs[arch]
        arrays[f"x_{a}"] = x
        arrays.update({f"p_{a}_{k}": v for k, v in p.items()})
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(src, tokens=_tokens(_cfg(GRANITE), B, S), **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", JAX_MESH, src, dst,
                          ",".join(ARCHS)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": "src",
                                           "JAX_PLATFORMS": "cpu"}, cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.load(dst)
    n = sum(1 for k in got.files if k.startswith("gt_"))
    cj = jreduced(jconfigs.get(GRANITE))
    out = {"loss": float(got["loss"]), "aux": float(got["aux"])}
    for tag, key in (("t", "j"), ("n", "j_n")):
        out[key] = _flat_np(_from_jax([got[f"g{tag}_{i}"] for i in range(n)],
                                      cj))
    for a, arch in enumerate(ARCHS):
        for tag in ("rows", "whole"):
            out[(arch, tag)] = (got[f"out_{a}_{tag}"],
                                float(got[f"aux_{a}_{tag}"]))
    return out


def _jax_blocks(block_inputs):
    """JAX's ``moe_block(mesh=None)`` on each block case's global input:
    (output, aux, the dropped (token, slot) choices)."""
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.models import moe as jmoe
    out = {}
    for arch in ARCHS:
        cfg = jreduced(jconfigs.get(arch))
        p, x = block_inputs[arch]
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        for n_rows in {c[4] for c in BLOCK_CASES}:
            xr = _case_x(x, n_rows)
            o, aux = jmoe.moe_block(pj, cfg, jnp.asarray(xr))
            t = xr.shape[0] * xr.shape[1]
            _, idx, _ = jmoe._route(pj, cfg, jnp.asarray(xr).reshape(t, -1))
            cap = max(1, math.ceil(t * cfg.top_k / cfg.n_experts
                                   * cfg.capacity_factor))
            dropped = (sorted(_jax_dropped(np.asarray(idx), cfg.n_experts,
                                           cap))
                       if t * cfg.top_k >= cfg.n_experts else None)
            out[(arch, n_rows)] = (np.asarray(o), float(aux), dropped)
    return out


def _one_device_train(arch, b):
    """The port's one-device step (no mesh: every knob changes nothing):
    gradients at the parameters and at their 1-ulp nudge, the loss and
    aux."""
    from repro_torch.launch import steps
    cfg = _cfg(arch)
    toks = torch.from_numpy(_tokens(cfg, b, S))
    out = {}
    for tag, params in (("t", _init(arch)), ("t_n", _nudged_t(_init(arch)))):
        # the one-device builder's gradient (its Adam is not patched here:
        # the parent's threads share the steps module)
        grads, m = steps.train_grads(params, cfg, {"tokens": toks,
                                                   "labels": toks})
        out[tag] = _flat_np(grads)
        if tag == "t":
            out.update(loss=float(m["loss"]), aux=float(m["moe_aux"]))
    return out


def _one_device_drops(arch, b) -> dict:
    """Each layer's dropped slots in one device's forward of the step's
    batch and of each data shard's rows of a 2 x 2 mesh (in the main
    thread: the recorder patches the port's module)."""
    from repro_torch.models import transformer as T
    cfg, p = _cfg(arch), _init(arch)
    toks = torch.from_numpy(_tokens(cfg, b, S))

    def drops(t):
        with _Drops() as rec:
            T.forward(p, cfg, {"tokens": t})
        return [len(c) for c in rec.calls]
    return {"drops": drops(toks),
            "shard_drops": [drops(toks[i:i + b // 2]) for i in (0, b // 2)]}


def _jax_train(arch, b, kw):
    """JAX's ``make_train_step`` with ``kw`` ``.jit()``-ed on a 1 x 1 mesh
    in float32 from zero moments, at the parameters and at their 1-ulp
    nudge: its first moment over ``1 - b1`` (the gradient; the port's
    leaf paths) and loss."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.configs.shapes import InputShape as JShape
    from repro.launch import steps as jsteps
    from repro.optim import optimizers as jopt
    from repro_torch import convert
    cj = jreduced(jconfigs.get(arch))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             NAMES)
    jb = jsteps.make_train_step(cj, JShape("t", S, b, "train"), mesh,
                                param_dtype=jnp.float32, **kw)
    toks = _tokens(_cfg(arch), b, S)
    out = {}
    with mesh:
        fn = jb.jit()
        for tag, pt in (("j", _init(arch)), ("j_n", _nudged_t(_init(arch)))):
            p = _to_jax(pt, cj)
            _, opt, _, m = fn(p, jopt.adam(3e-4).init(p), jnp.int32(0),
                              {"tokens": toks, "labels": toks})
            mu = _flat_np(convert.to_torch(jax.tree.map(np.asarray, opt.mu)))
            out[tag] = {k: v / 0.1 for k, v in mu.items()}
            if tag == "j":
                out["loss"] = float(m["loss"])
    return out


def _distill_refs(arch):
    """The distill step's loss and gradient, JAX's (its loss through
    ``jax.grad`` on a 1 x 1 mesh, as ``tests/test_torch_mesh_serve.py``
    takes it) and the one-device port's, each at the student and at its
    1-ulp nudge."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.kernels import ref as jkref
    from repro.models import transformer as JT
    from repro_torch import convert
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import steps
    cj = jreduced(jconfigs.get(arch))
    ct = _cfg(arch)
    toks = _tokens(ct, B, S, 4)

    def jloss(p, teachers, tokens):
        t_logits, _ = jax.vmap(lambda q: JT.forward(
            q, cj, {"tokens": tokens}))(teachers)
        s_logits, aux = JT.forward(p, cj, {"tokens": tokens})
        v = s_logits.shape[-1]
        loss = jkref.ensemble_kl(s_logits.reshape(-1, v),
                                 t_logits.reshape(TEACHERS, -1, v))
        return loss + cj.router_aux_coef * aux, loss

    ref = jax.jit(jax.grad(jloss, has_aux=True))
    pt, tt = _init(arch), _teachers(arch)
    pn = _nudged_t(pt)
    tj = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        _to_jax(tree_map(lambda x: x[i], tt), cj) for i in range(TEACHERS)])
    gj, jl = ref(_to_jax(pt, cj), tj, toks)
    gj_n, _ = ref(_to_jax(pn, cj), tj, toks)
    tb = {"tokens": torch.from_numpy(toks)}
    gt, tl = steps.distill_grads(pt, tt, ct, tb)
    gt_n, _ = steps.distill_grads(pn, tt, ct, tb)
    jflat = lambda g: _flat_np(convert.to_torch(jax.tree.map(np.asarray,
                                                             g)))
    return {"loss": float(jl), "loss_t": float(tl), "j": jflat(gj),
            "j_n": jflat(gj_n), "t": _flat_np(gt), "t_n": _flat_np(gt_n)}


def _serve_refs(shape, b):
    """One device: the prefill of each data shard's rows (the
    expert-parallel prefill's capacity is its shard's), their caches
    joined, then ``decode_step`` of the whole batch: the prefill's
    next-token logits and each token's."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import transformer as T
    cfg = _cfg(GRANITE)
    p = _init(GRANITE)
    toks = torch.from_numpy(_tokens(cfg, b, PROMPT + N_TOK, 5))
    shards = shape[0] if b % shape[0] == 0 else 1
    per = b // shards
    runs = [T.prefill(p, cfg, {"tokens": toks[i:i + per, :PROMPT]}, MAX_SEQ,
                      last_only=True) for i in range(0, b, per)]
    caches = tree_map(lambda *xs: torch.cat(xs, dim=xs[0].dim() - 4),
                      *[c for _, c in runs])
    out = {"prefill": torch.cat([lg for lg, _ in runs]).numpy(),
           "decode": []}
    for i in range(N_TOK):
        lg, caches = T.decode_step(
            p, cfg, {"tokens": toks[:, PROMPT + i:PROMPT + i + 1]}, caches,
            PROMPT + i)
        out["decode"].append(lg.numpy())
    return out


@pytest.fixture(scope="module")
def world():
    import jax  # noqa: F401  (imported once, before the threads use it)
    threads = max(1, (os.cpu_count() or 4) // 8)
    inputs = {a: _block_inputs(a) for a in ARCHS}
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        four = pool.submit(tmesh.launch_ranks, rank_suite, 4, "cpu",
                           args=(inputs,), timeout_s=RANK_TIMEOUT_S,
                           threads=threads)
        two = pool.submit(tmesh.launch_ranks, rank_suite, 2, "cpu",
                          args=(inputs,), timeout_s=RANK_TIMEOUT_S,
                          threads=threads)
        mesh_j = pool.submit(_jax_mesh, tmp, inputs)
        blocks = pool.submit(_jax_blocks, inputs)
        keys = {(c[1], c[3], tuple(sorted(c[4].items()))): c
                for c in TRAIN_CASES}
        ports = {k: pool.submit(_one_device_train, c[1], c[3])
                 for k, c in keys.items()}
        jaxs = {_key(c): pool.submit(_jax_train, c[1], c[3], c[4])
                for c in TRAIN_CASES if c[5] == "port"}
        distill = pool.submit(_distill_refs, GRANITE)
        serve = {c[0]: pool.submit(_serve_refs, c[1], c[2])
                 for c in SERVE_CASES}
        ranks = {k: [r[k] for r in runs.result()] for runs in (four, two)
                 for k in runs.result()[0]}
        out = {"ranks": ranks, "inputs": inputs, "jax_mesh": mesh_j.result(),
               "blocks": blocks.result(),
               "port": {k: f.result() for k, f in ports.items()},
               "jax": {k: f.result() for k, f in jaxs.items()},
               "distill": distill.result(),
               "serve": {k: f.result() for k, f in serve.items()}}
    for k, port in out["port"].items():     # every thread has ended
        port.update(_one_device_drops(k[0], k[1]))
    return out


def _key(case):
    return (case[1], case[3], tuple(sorted(case[4].items())))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cid", [c[0] for c in BLOCK_CASES])
def test_partitioner_path_matches_jax_on_the_global_tokens(world, arch, cid):
    n_rows = next(c[4] for c in BLOCK_CASES if c[0] == cid)
    want, aux_j, dropped = world["blocks"][(arch, n_rows)]
    for out, aux, drops in world["ranks"][(arch, cid)]:
        assert out.shape == want.shape
        np.testing.assert_allclose(out, want, rtol=0, atol=MOE_ATOL)
        assert abs(aux - aux_j) <= AUX_ATOL, (aux, aux_j)
        if dropped is None:                 # the gather route: no dispatch
            assert drops == []
            continue
        assert drops == [[tuple(d) for d in dropped]], cid
        assert dropped, f"{cid}: no slot dropped"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cid,tag", [("ep-dph", "rows"),
                                     ("ep-2x2", "rows"),
                                     ("ep-whole", "whole")])
def test_expert_parallel_route_matches_jax_shard_map(world, arch, cid, tag):
    """Under ``dp_heavy`` (the rows gathered over ``"model"``), under
    ``tp`` and with one row whole on every rank (its tokens cut over
    ``"data"``): JAX's ``_moe_shard_map`` on its 2 x 2 mesh."""
    want, aux_j = world["jax_mesh"][(arch, tag)]
    for out, aux, drops in world["ranks"][(arch, cid)]:
        np.testing.assert_allclose(out, want, rtol=0, atol=MOE_ATOL)
        assert abs(aux - aux_j) <= AUX_ATOL, (aux, aux_j)
        assert drops[0], f"{cid}: no slot dropped"


@pytest.mark.parametrize("arch", ARCHS)
def test_the_partitioner_path_drops_and_averages_other_than_expert_parallel(
        world, arch):
    """On the same 2 x 2 world and rows, the two routes differ: each data
    shard's capacity drops other choices than the global one, and the
    shards' mean aux loss is not the global batch's."""
    _, aux_g, drops_g = world["ranks"][(arch, "2x2")][0]
    _, aux_e, drops_e = world["ranks"][(arch, "ep-2x2")][0]
    assert drops_g != drops_e
    assert abs(aux_g - aux_e) > 10 * AUX_ATOL, (aux_g, aux_e)
    want, _ = world["jax_mesh"][(arch, "rows")]
    got, _, _ = world["ranks"][(arch, "2x2")][0]
    assert float(np.abs(got - want).max()) > MOE_ATOL


@pytest.mark.parametrize("cid", [c[0] for c in TRAIN_CASES])
def test_train_step_matches_one_device_and_jax(world, cid):
    case = next(c for c in TRAIN_CASES if c[0] == cid)
    port = world["port"][_key(case)]
    runs = world["ranks"][cid]
    assert all(r["loss"] == runs[0]["loss"] for r in runs)
    got = runs[0]["grads"]
    own = _rel(port["t_n"], port["t"])
    if case[5] == "jax2x2":
        # two data shards route, drop and average their own tokens: JAX's
        # gradient on its 2 x 2 mesh; the one-device port's gap to JAX
        # measured on one device (noep-2x2's reference, the same batch)
        want = world["jax_mesh"]
        spread = max(own, _rel(want["j_n"], want["j"]))
        gap = _rel(got, want["j"])
        one_device_gap = _rel(port["t"], world["jax"][_key(next(
            c for c in TRAIN_CASES if c[0] == "noep-2x2"))]["j"])
        print(f"{cid}: gap to JAX on 2 x 2 {gap:.3g} (larger spread "
              f"{spread:.3g}; one device's gap {one_device_gap:.3g})")
        assert gap <= SPREAD_FACTOR * spread + one_device_gap, (gap, spread)
        for r in runs:
            assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_REL)
            assert abs(r["aux"] - want["aux"]) <= AUX_ATOL
            assert r["drops"] == port["shard_drops"][r["data"]]
        assert sum(map(sum, port["shard_drops"])) > 0, f"{cid}: no drop"
        return
    for r in runs:
        assert r["loss"] == pytest.approx(port["loss"], rel=LOSS_REL)
        assert abs(r["aux"] - port["aux"]) <= AUX_ATOL
        assert r["drops"] == port["drops"], (r["drops"], port["drops"])
    assert sum(port["drops"]) > 0, f"{cid}: no slot dropped"
    gap = _rel(got, port["t"])
    print(f"{cid}: gap to the one-device port {gap:.3g} (its 1-ulp spread "
          f"{own:.3g})")
    assert gap <= SPREAD_FACTOR * own, (gap, own)
    want = world["jax"][_key(case)]
    assert runs[0]["loss"] == pytest.approx(want["loss"], rel=LOSS_REL)
    spread = max(own, _rel(want["j_n"], want["j"]))
    gap_j, one_device_gap = _rel(got, want["j"]), _rel(port["t"], want["j"])
    print(f"{cid}: gap to JAX {gap_j:.3g} (the one-device port's "
          f"{one_device_gap:.3g}; larger spread {spread:.3g})")
    assert gap_j <= SPREAD_FACTOR * spread + one_device_gap, (
        gap_j, spread, one_device_gap)


def test_distill_step_matches_one_device_and_jax(world):
    ref = world["distill"]
    runs = world["ranks"]["distill"]
    for r in runs:
        assert r["loss"] == pytest.approx(ref["loss"], rel=LOSS_REL)
        assert r["loss"] == pytest.approx(ref["loss_t"], rel=LOSS_REL)
    assert sum(r["drops"] for r in runs) > 0
    got = runs[0]["grads"]
    own = _rel(ref["t_n"], ref["t"])
    spread = max(own, _rel(ref["j_n"], ref["j"]))
    gap, gap_j = _rel(got, ref["t"]), _rel(got, ref["j"])
    one_device_gap = _rel(ref["t"], ref["j"])
    print(f"distill: gap to the one-device port {gap:.3g} (spread "
          f"{own:.3g}), to JAX {gap_j:.3g} (one device {one_device_gap:.3g})")
    assert gap <= SPREAD_FACTOR * own, (gap, own)
    assert gap_j <= SPREAD_FACTOR * spread + one_device_gap


@pytest.mark.parametrize("cid", [c[0] for c in SERVE_CASES])
def test_prefill_and_serve_steps_match_one_device(world, cid):
    want = world["serve"][cid]
    for r in world["ranks"][cid]:
        np.testing.assert_allclose(
            r["prefill"], want["prefill"], rtol=0,
            atol=SERVE_REL * np.abs(want["prefill"]).max())
        assert len(r["decode"]) == N_TOK
        for got, w in zip(r["decode"], want["decode"]):
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=SERVE_REL * np.abs(w).max())
        # batch 1: T * k < E, the gather route (no capacity dispatch)
        assert (r["capacity_calls"] == 0) == (cid == "serve-1x2-b1")


def test_an_moe_model_builds_on_a_mesh_under_every_step():
    """Each builder of an MoE model on a 2 x 2 view of a mesh: one rank's
    blocks, the expert leaves at a half of their experts (JAX's
    ``"experts"`` rule in every layout), and the dry run counts them."""
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun, steps
    cfg = _cfg(GRANITE)
    view = dryrun.RankView((2, 2))
    shape = InputShape("t", S, B, "train")
    bundles = [steps.make_train_step(cfg, shape, view, layout=lay, **kw)
               for lay in steps.LAYOUTS
               for kw in ({}, {"use_moe_shard_map": False})]
    bundles += [steps.make_prefill_step(cfg, InputShape("p", S, B, "prefill"),
                                        view, layout="dp_heavy"),
                steps.make_distill_step(cfg, view, batch_size=B, seq_len=S),
                steps.make_serve_step(cfg, InputShape("d", S, B, "decode"),
                                      view)]
    for b in bundles:
        flat = tree_flatten(b.args[0])
        gates = [v for k, v in flat.items() if k.endswith("wi_gate")]
        assert gates and all(g.shape[-3] == cfg.n_experts // 2
                             for g in gates)
    rec = dryrun.run_one("granite-moe-1b-a400m", "train_4k", mesh=(2, 2),
                         step_kw={"layout": "dp_heavy"}, out_dir="")
    assert rec["ok"], rec
    rec = dryrun.run_one("granite-moe-1b-a400m", "distill_fusion",
                         distill=True, mesh=(2, 2), out_dir="")
    assert rec["ok"], rec


def card_block(inputs) -> tuple:
    """The partitioner path's ``moe_block`` on 1 x 2 ranks sharing the
    card, on CUDA tensors: the output gathered and the aux loss."""
    from repro_torch.common import sharding as shd
    from repro_torch.models import moe
    cfg = _cfg(GRANITE)
    mesh = tmesh.make_mesh((1, 2), NAMES)
    layout = shd.TPLayout(mesh, None, ("data",))
    p, x = inputs
    local = {k: v.cuda() for k, v in _local_experts(p, cfg, mesh).items()}
    out, aux = moe.moe_block(local, cfg, torch.from_numpy(x).cuda(),
                             layout=layout)
    return out.cpu().numpy(), float(aux)


@pytest.mark.gpu
def test_partitioner_path_on_the_card_matches_the_cpu():
    """``moe_block``'s partitioner path over 2 gloo ranks sharing the card
    against the same call on CPU ranks: the output within ``MOE_ATOL``,
    the aux loss within ``AUX_ATOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inputs = _block_inputs(GRANITE)
    card = tmesh.launch_ranks(card_block, 2, "cuda", args=(inputs,),
                              timeout_s=RANK_TIMEOUT_S)
    cpu = tmesh.launch_ranks(block_case, 2, "cpu", args=(
        GRANITE, inputs, (1, 2), ("data",), ("data",), B, False),
        timeout_s=RANK_TIMEOUT_S)
    for (out, aux), (want, aux_c, _) in zip(card, cpu):
        np.testing.assert_allclose(out, want, rtol=0, atol=MOE_ATOL)
        assert abs(aux - aux_c) <= AUX_ATOL
