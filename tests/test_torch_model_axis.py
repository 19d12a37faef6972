"""The model axis of a mesh (tensor parallelism over ``"model"``, FSDP over
the data axes, the expert-parallel MoE) on gloo ranks on the CPU, against
the JAX package.

One module-scoped ``launch_ranks`` world of 4 ranks builds the 2 x 2,
1 x 4 and 2 x 1 x 2 (``("pod", "data", "model")``) meshes in turn; a
world of 2 ranks, started beside it, builds the 1 x 2 mesh (a mesh spans
its whole world).  The ranks import no JAX: the parent draws the
parameters with the port's ``T.init`` (JAX gets the same leaves), cuts
nothing, and computes the JAX references while the ranks run:

* ``make_train_step``'s gradients (gathered whole from the ranks' blocks)
  against the gradient JAX's ``make_train_step`` takes (its loss: JAX's
  forward, ``token_xent`` and the aux term) on a 1 x 1 mesh in float32,
  by ``tests/test_torch_steps.py``'s 1-ulp-spread method: within
  ``SPREAD_FACTOR`` times the port's own 1-ulp spread of its one-device
  gradients (the sharding's share), and within ``SPREAD_FACTOR`` times
  the larger spread of the two packages plus the one-device port's own
  gap to JAX (zamba2's SSD decay, ROADMAP queue 3: at these weights that
  gap alone is up to 8x the spread); the loss within 1e-5 of JAX's; in
  the 2 x 2 cases one step's Adam on the blocks equal, bit for bit, to
  Adam on the gathered gradients, and (dense models) the gradient of 2
  microbatches, each JAX's slice of the global batch cut over the data
  axis, within 1e-5 of the whole batch's.  Reduced zamba2-1.2b and qwen3-8b at
  ``vocab_size`` 512 (the vocabulary split over ``"model"``), zamba2 once
  at its own 503 (left whole); qwen3-8b on 1 x 4, where its 2 key / value
  heads stay whole beside one query head a rank; granite-moe on 1 x 2,
  where one data rank's capacity is the global one, so the router's
  gradient is JAX's, and on 2 x 2 (two data ranks: each shard's own
  capacity and the aux loss's ``pmean``, whose gradient the port carries
  at 1 / (m·|dp|)) against JAX's gradient on a 2 x 2 mesh of 4 forced
  host devices, within ``SPREAD_FACTOR`` times the larger 1-ulp spread
  plus the one-device port's gap to JAX.  A model-axis sum of the
  gradients of ``wB`` /
  ``wC``, of the conv's B / C channels or of the router left out moves
  these gradients far past the bound.
* ``make_prefill_step``'s next-token logits, gathered, against JAX's
  prefill at ``test_prefill_and_serve_steps_match_jax``'s 1e-3 of the
  largest.
* ``moe_block(mesh=...)`` on 2 x 2 (reduced granite-moe, the default
  capacity factor, so shards drop slots) against JAX's own
  ``moe_block(mesh=jax.make_mesh((2, 2)))`` in a subprocess with 4 forced
  host devices (``tests/test_moe.py``'s pattern): the output within 1e-4,
  the aux loss (JAX's ``pmean`` over the data shards) within 1e-6.
* ``axes_group`` over ``("pod", "model")`` of a 2 x 2 x 1 mesh, then of a
  1 x 2 x 2 mesh built after the first is gone: each sums over its own
  ranks (a group cached for the first mesh is not reused).
"""
import gc
import concurrent.futures
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh

SPREAD_FACTOR = 4.0           # tests/test_torch_steps.py's
LOSS_REL = 1e-5
PREFILL_REL = 1e-3            # test_prefill_and_serve_steps_match_jax's
MOE_ATOL, AUX_ATOL = 1e-4, 1e-6
B, S = 4, 16
RANK_TIMEOUT_S = 300
NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}

# (id, arch, vocab_size or None for the reduced config's 503, mesh, prefill)
CASES = [
    ("zamba2-2x2", "zamba2-1.2b", 512, (2, 2), True),
    ("qwen3-2x2", "qwen3-8b", 512, (2, 2), True),
    ("zamba2-2x2-v503", "zamba2-1.2b", None, (2, 2), False),
    ("qwen3-1x4", "qwen3-8b", 512, (1, 4), False),
    ("qwen3-2x1x2", "qwen3-8b", 512, (2, 1, 2), False),
    ("zamba2-1x2", "zamba2-1.2b", 512, (1, 2), True),
    ("granite-1x2", "granite-moe-1b-a400m", 512, (1, 2), False),
    ("granite-2x2", "granite-moe-1b-a400m", 512, (2, 2), False),
]
# cases held against JAX's train step on their own mesh (4 forced host
# devices): two data ranks route and drop on their own shards, and the aux
# loss is JAX's pmean, so neither one device's gradient is the reference
ON_JAX_MESH = ("granite-2x2",)


def _cfg(arch, vocab):
    from repro_torch import configs
    from repro_torch.common.arch_config import reduced
    over = {} if vocab is None else {"vocab_size": vocab}
    return reduced(configs.get(arch), **over)


def _init(arch, vocab):
    from repro_torch.models import transformer as T
    return T.init(_cfg(arch, vocab), torch.Generator().manual_seed(0))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _moe_inputs():
    """Reduced granite-moe's MoE parameters and a [B, S, d] input, from
    numpy."""
    from repro_torch.models import moe
    cfg = _cfg("granite-moe-1b-a400m", None)
    rng = np.random.default_rng(2)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(
        np.float32) for k, s in moe.moe_specs(cfg).items()}
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return p, x


# ---------------------------------------------------------------------------
# what the ranks run (port code only)
# ---------------------------------------------------------------------------

def train_case(arch, vocab, shape) -> dict:
    """The train step's gathered gradients and loss on this world's mesh,
    and whether one step's Adam on the blocks equals Adam on them whole."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import (tree_flatten, tree_leaves,
                                           tree_map)
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers as topt
    cfg = _cfg(arch, vocab)
    mesh = tmesh.make_mesh(shape, NAMES[len(shape)])
    bundle = steps.make_train_step(cfg, InputShape("t", S, B, "train"), mesh,
                                   param_dtype=torch.float32)
    tp = bundle.layout
    whole = _init(arch, vocab)
    params = shd.shard_tree(whole, tp.pspecs, mesh)
    batch = steps.batch_block({k: torch.from_numpy(v)
                               for k, v in _batch(cfg).items()}, tp)
    grads, m = steps.train_grads(params, cfg, batch, layout=tp, mesh=mesh)
    g_whole = shd.gather_tree(grads, tp.pspecs, mesh)
    out = {"loss": float(m["loss"]), "aux": float(m["moe_aux"])}
    if shape == (2, 2):
        # the step: Adam on the blocks, in place
        zeros = tree_map(torch.zeros_like, whole)
        opt = topt.AdamState(*(shd.shard_tree(zeros, tp.pspecs, mesh)
                               for _ in range(2)))
        bundle.fn(params, opt, torch.zeros((), dtype=torch.int32), batch)
        stepped = tree_leaves(shd.gather_tree(params, tp.pspecs, mesh))
        w = tree_leaves(whole)
        deltas, _ = topt.adam(3e-4).update(tree_leaves(g_whole),
                                           topt.adam(3e-4).init(w), w, 0)
        out["adam_equal"] = all(torch.equal(a, b) for a, b in zip(
            stepped, topt.apply_updates(w, deltas)))
    if cfg.n_experts == 0 and shape == (2, 2):
        # 2 microbatches, each JAX's slice of the global batch cut over
        # the data axis: the same mean gradient
        g2, m2 = steps.train_grads(shd.shard_tree(whole, tp.pspecs, mesh),
                                   cfg, batch, microbatch=2, layout=tp,
                                   mesh=mesh)
        g2 = shd.gather_tree(g2, tp.pspecs, mesh)
        out["microbatch_rel"] = max(
            float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(tree_leaves(g2), tree_leaves(g_whole)))
        out["microbatch_loss"] = float(m2["loss"])
    if tmesh.world_rank() == 0:
        out["grads"] = {k: v.numpy() for k, v in tree_flatten(g_whole).items()}
    return out


def prefill_case(arch, vocab, shape) -> np.ndarray:
    """The prefill step's next-token logits, gathered whole (the caches
    of the shapes the bundle's ``outs`` promise)."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    cfg = _cfg(arch, vocab)
    mesh = tmesh.make_mesh(shape, NAMES[len(shape)])
    bundle = steps.make_prefill_step(cfg, InputShape("p", S, B, "prefill"),
                                     mesh, param_dtype=torch.float32)
    tp = bundle.layout
    params = shd.shard_tree(_init(arch, vocab), tp.pspecs, mesh)
    batch = steps.batch_block(
        {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}, tp)
    logits, caches = bundle.fn(params, batch)
    assert tuple(logits.shape) == tuple(bundle.outs[0].shape)
    for c, m in zip(tree_leaves(caches), tree_leaves(bundle.outs[1]),
                    strict=True):
        assert tuple(c.shape) == tuple(m.shape)
    split = "model" if logits.shape[-1] != cfg.vocab_size else None
    return shd.gather_tensor(logits, shd.P(tp.dp_axes, None, split),
                             mesh).numpy()


def moe_case(p, x) -> tuple:
    """``moe_block(mesh=...)`` on a 2 x 2 mesh: this rank's experts and
    data rows in, the output gathered over the data axis out."""
    from repro_torch.common import sharding as shd
    from repro_torch.models import moe
    cfg = _cfg("granite-moe-1b-a400m", None)
    mesh = tmesh.make_debug_mesh(2, 2)
    per = cfg.n_experts // 2
    e0 = shd.axis_index(mesh, "model") * per
    local = {k: torch.from_numpy(v if k == "router" else v[e0:e0 + per])
             for k, v in p.items()}
    rows = x.shape[0] // 2
    d0 = shd.axis_index(mesh, "data") * rows
    out, aux = moe.moe_block(local, cfg, torch.from_numpy(x[d0:d0 + rows]),
                             mesh=mesh, dp_axes=("data",))
    return shd.all_gather(out, mesh, ("data",)).numpy(), float(aux)


class MeshView:
    """What ``axes_group`` reads of a mesh over more than one axis: its
    rank layout and axis names.  Dropped and made again at once, a view
    takes its predecessor's ``id``, as a garbage-collected mesh may."""

    def __init__(self, shape):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = NAMES[3]
        self.shape = dict(zip(NAMES[3], shape))


def groups_case() -> list:
    """The sum of the ranks over ``("pod", "model")`` of two 3-axis
    meshes built in turn, the first dropped before the second: real
    meshes, then views of them."""
    from repro_torch.common import sharding as shd
    sums = []
    for make in (lambda shape: tmesh.make_mesh(shape, NAMES[3]), MeshView):
        for shape in ((2, 2, 1), (1, 2, 2)):
            mesh = make(shape)
            rank = torch.tensor([float(tmesh.world_rank())])
            sums.append(float(shd.all_reduce_sum(rank, mesh,
                                                 ("pod", "model"))))
            del mesh
            gc.collect()
    return sums


def rank_suite(moe_inputs):
    """Every case whose mesh this world's size fits, in order."""
    n = tmesh.world_size()
    out = {}
    if n == 4:
        out["groups"] = groups_case()
    for cid, arch, vocab, shape, prefill in CASES:
        if int(np.prod(shape)) != n:
            continue
        out[cid] = train_case(arch, vocab, shape)
        if prefill:
            out[cid]["prefill"] = prefill_case(arch, vocab, shape)
    if n == 4:
        out["moe"] = moe_case(*moe_inputs)
    return out


# ---------------------------------------------------------------------------
# the parent: JAX's references
# ---------------------------------------------------------------------------

JAX_MOE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.common.arch_config import reduced
from repro.models import moe as moe_mod
got = np.load(sys.argv[1])
cfg = reduced(configs.get("granite-moe-1b-a400m"))
p = {k[2:]: jnp.asarray(got[k]) for k in got.files if k.startswith("p_")}
mesh = jax.make_mesh((2, 2), ("data", "model"))
out, aux = jax.jit(lambda p, x: moe_mod.moe_block(
    p, cfg, x, mesh=mesh, dp_axes=("data",)))(p, jnp.asarray(got["x"]))
res = {"out": np.asarray(out), "aux": np.asarray(aux)}
# the train step's loss and gradients on this mesh, as make_train_step
# takes them, at the parameters and at their 1-ulp nudge
from repro.launch import steps
from repro.models import transformer as JT
ct = reduced(configs.get("granite-moe-1b-a400m"), vocab_size=512)
treedef = jax.tree.structure(jax.eval_shape(
    lambda: JT.init(ct, jax.random.PRNGKey(0), jnp.float32)))
batch = {"tokens": got["tokens"], "labels": got["tokens"]}


def loss(p, batch):
    lg, aux = JT.forward(p, ct, batch, mesh=mesh, dp_axes=("data",))
    lv = steps.token_xent(lg, batch["labels"], ct)
    return lv + ct.router_aux_coef * aux, {"loss": lv, "moe_aux": aux}


grad = jax.jit(jax.grad(loss, has_aux=True))
# an Auto-typed mesh (as the 1 x 1 references use): jax.make_mesh's
# Explicit axes refuse the unembedding's contraction over the data shards
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
        res.update(loss=np.asarray(m["loss"]),
                   moe_aux=np.asarray(m["moe_aux"]))
np.savez(sys.argv[2], **res)
"""


def _jax_moe(tmp):
    """JAX on a 2 x 2 mesh of 4 host devices: ``moe_block``'s output and
    aux, and granite-2x2's train-step loss, aux and gradients (flat, the
    port's leaf paths), at the parameters and at their 1-ulp nudge."""
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro_torch.common.pytree import tree_leaves_jax
    p, x = _moe_inputs()
    arch = "granite-moe-1b-a400m"
    pt = _init(arch, 512)
    leaves = {f"{tag}_{i}": v.numpy() for tag, tree in
              (("t", pt), ("n", _nudged_t(pt)))
              for i, v in enumerate(tree_leaves_jax(tree))}
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(src, x=x, tokens=_batch(_cfg(arch, 512))["tokens"], **leaves,
             **{"p_" + k: v for k, v in p.items()})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", JAX_MOE, src, dst],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": "src",
                              "JAX_PLATFORMS": "cpu"}, cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.load(dst)
    n = sum(1 for k in got.files if k.startswith("gt_"))
    cj = jreduced(jconfigs.get(arch), vocab_size=512)
    train = {"loss": float(got["loss"]), "aux": float(got["moe_aux"])}
    for tag, key in (("t", "j"), ("n", "j_n")):
        train[key] = _flat_np(_from_jax([got[f"g{tag}_{i}"]
                                         for i in range(n)], cj))
    return got["out"], float(got["aux"]), {"granite-2x2": train}


def _from_jax(leaves, cfg_j):
    """JAX's flat leaves (JAX's order) as the port's tree."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro_torch import convert
    struct = jax.eval_shape(lambda: JT.init(cfg_j, jax.random.PRNGKey(0),
                                            jnp.float32))
    return convert.to_torch(jax.tree.unflatten(jax.tree.structure(struct),
                                               [np.asarray(v)
                                                for v in leaves]))


def _to_jax(tree_t, cfg_j):
    """The port's tree as JAX's (the same leaves in JAX's order)."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    from repro_torch.common.pytree import tree_leaves_jax
    struct = jax.eval_shape(lambda: JT.init(cfg_j, jax.random.PRNGKey(0),
                                            jnp.float32))
    return jax.tree.unflatten(jax.tree.structure(struct), [
        jnp.asarray(x.numpy()) for x in tree_leaves_jax(tree_t)])


def _nudged_t(tree, seed=5):
    from repro_torch.common.pytree import tree_map
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: torch.from_numpy(
        (x.numpy() * (1 + 2.0 ** -23 * rng.standard_normal(x.shape)))
        .astype(np.float32)), tree)


def _flat_np(tree_t) -> dict:
    from repro_torch.common.pytree import tree_flatten
    return {k: v.detach().double().numpy()
            for k, v in tree_flatten(tree_t).items()}


def _jax_refs(arch, vocab, prefill):
    """JAX's float32 train-step loss and gradients (and those at a 1-ulp
    nudge), the port's own one-device gradients at the nudge and the
    unnudged ones, and JAX's prefill logits, at the parameters the ranks
    draw."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.configs.shapes import InputShape as JShape
    from repro.launch import steps as jsteps
    from repro.models import transformer as JT
    from repro_torch import convert
    from repro_torch.launch import steps
    over = {} if vocab is None else {"vocab_size": vocab}
    cj = jreduced(jconfigs.get(arch), **over)
    ct = _cfg(arch, vocab)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))

    def loss(p, batch):
        """make_train_step's loss on a 1 x 1 mesh (its MoE route)."""
        lg, aux = JT.forward(p, cj, batch, mesh=mesh, dp_axes=("data",))
        lv = jsteps.token_xent(lg, batch["labels"], cj)
        return lv + cj.router_aux_coef * aux, {"loss": lv, "moe_aux": aux}

    ref = jax.jit(jax.grad(loss, has_aux=True))
    pt = _init(arch, vocab)
    pn = _nudged_t(pt)
    nb = _batch(ct)
    with mesh:
        gj, jm = ref(_to_jax(pt, cj), nb)
        gj_n, _ = ref(_to_jax(pn, cj), nb)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    gt, _ = steps.train_grads(pt, ct, tb, remat=False)
    gt_n, _ = steps.train_grads(pn, ct, tb, remat=False)
    jflat = lambda g: _flat_np(convert.to_torch(jax.tree.map(np.asarray,
                                                             g)))
    out = {"loss": float(jm["loss"]), "aux": float(jm["moe_aux"]),
           "j": jflat(gj), "j_n": jflat(gj_n), "t": _flat_np(gt),
           "t_n": _flat_np(gt_n)}
    if prefill:
        jp = jsteps.make_prefill_step(cj, JShape("p", S, B, "prefill"), mesh,
                                      param_dtype=jnp.float32)
        with mesh:
            out["logits"] = np.asarray(jp.jit()(
                _to_jax(pt, cj), {"tokens": nb["tokens"]})[0])
    return out


@pytest.fixture(scope="module")
def world():
    threads = max(1, (os.cpu_count() or 4) // 8)
    moe_inputs = _moe_inputs()
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        four = pool.submit(tmesh.launch_ranks, rank_suite, 4, "cpu",
                           args=(moe_inputs,), timeout_s=RANK_TIMEOUT_S,
                           threads=threads)
        two = pool.submit(tmesh.launch_ranks, rank_suite, 2, "cpu",
                          args=(moe_inputs,), timeout_s=RANK_TIMEOUT_S,
                          threads=threads)
        moe_j = pool.submit(_jax_moe, tmp)
        prefill = {}
        for _, arch, vocab, _, pre in CASES:
            prefill[(arch, vocab)] = prefill.get((arch, vocab), False) or pre
        refs = {key: pool.submit(_jax_refs, *key, pre)
                for key, pre in prefill.items()}
        refs = {key: r.result() for key, r in refs.items()}
        ranks = {**{k: [r[k] for r in four.result()] for k in
                    four.result()[0]},
                 **{k: [r[k] for r in two.result()] for k in
                    two.result()[0]}}
        out_j, aux_j, on_mesh = moe_j.result()
        return {"ranks": ranks, "refs": refs, "moe_j": (out_j, aux_j),
                "on_mesh": on_mesh, "moe_inputs": moe_inputs}


def _rel(a: dict, b: dict) -> float:
    """Largest per-leaf gap as a share of the second tree's leaf's
    largest entry."""
    return max(float(np.abs(a[k] - b[k]).max()
                     / max(float(np.abs(b[k]).max()), 1e-30)) for k in b)


@pytest.mark.parametrize("cid", [c[0] for c in CASES])
def test_train_step_on_a_mesh_matches_jax(world, cid):
    arch, vocab = next((c[1], c[2]) for c in CASES if c[0] == cid)
    ref = world["refs"][(arch, vocab)]
    want = world["on_mesh"].get(cid, ref)
    runs = world["ranks"][cid]
    for r in runs:
        assert r["loss"] == pytest.approx(want["loss"], rel=LOSS_REL)
        assert r["aux"] == pytest.approx(want["aux"], rel=LOSS_REL, abs=1e-7)
        assert r.get("adam_equal", True), cid
        if "microbatch_rel" in r:
            assert r["microbatch_loss"] == pytest.approx(r["loss"],
                                                         rel=1e-6)
            assert r["microbatch_rel"] <= 1e-5, r["microbatch_rel"]
    assert all(r["loss"] == runs[0]["loss"] for r in runs)
    got = runs[0]["grads"]
    assert sorted(got) == sorted(want["j"]) == sorted(ref["t"])
    own = _rel(ref["t_n"], ref["t"])
    spread = max(own, _rel(want["j_n"], want["j"]))
    port_gap, one_device_gap = _rel(got, ref["t"]), _rel(ref["t"], ref["j"])
    gap = _rel(got, want["j"])
    print(f"{cid}: gradient gap to the one-device port {port_gap:.3g} (its "
          f"1-ulp spread {own:.3g}), to JAX {gap:.3g} (the one-device "
          f"port's {one_device_gap:.3g}; larger spread {spread:.3g})")
    if cid not in ON_JAX_MESH:
        assert port_gap <= SPREAD_FACTOR * own, (port_gap, own)
    assert gap <= SPREAD_FACTOR * spread + one_device_gap, (
        gap, spread, one_device_gap)


@pytest.mark.parametrize("cid", [c[0] for c in CASES if c[4]])
def test_prefill_on_a_mesh_matches_jax(world, cid):
    arch, vocab = next((c[1], c[2]) for c in CASES if c[0] == cid)
    want = world["refs"][(arch, vocab)]["logits"]
    for r in world["ranks"][cid]:
        got = r["prefill"]
        assert got.shape == want.shape == (B, 1, 512)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=PREFILL_REL * np.abs(want).max())


def test_expert_parallel_moe_block_matches_jax_shard_map(world):
    want, aux_j = world["moe_j"]
    p, x = world["moe_inputs"]
    for out, aux in world["ranks"]["moe"]:
        assert out.shape == want.shape == x.shape
        np.testing.assert_allclose(out, want, rtol=0, atol=MOE_ATOL)
        assert abs(aux - aux_j) <= AUX_ATOL, (aux, aux_j)
    # the shards' capacity dropped slots: the global one would differ
    from repro_torch.models import moe
    cfg = _cfg("granite-moe-1b-a400m", None)
    whole, _ = moe.moe_block({k: torch.from_numpy(v) for k, v in p.items()},
                             cfg, torch.from_numpy(x))
    assert float(np.abs(whole.numpy() - want).max()) > MOE_ATOL


def test_groups_follow_the_mesh_layout_not_the_mesh_object(world):
    """("pod", "model") of 2 x 2 x 1 joins ranks {0, 2} and {1, 3}; of
    1 x 2 x 2, built after the first mesh is gone, {0, 1} and {2, 3}."""
    want = {r: 2 * s for r, s in {0: [2.0, 1.0], 1: [4.0, 1.0],
                                  2: [2.0, 5.0], 3: [4.0, 5.0]}.items()}
    assert {r: got for r, got in enumerate(world["ranks"]["groups"])} == want


class StubMesh:
    """A mesh's shape and one rank's coordinates, without a world."""

    def __init__(self, shape, names, coord):
        self.shape = dict(zip(names, shape))
        self.mesh_dim_names = tuple(names)
        self._coord = list(coord)

    def get_coordinate(self):
        return self._coord


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "granite-moe-1b-a400m"])
def test_blocks_of_every_rank_rebuild_the_global_tree(arch):
    """``shard_tree`` on each rank of a 2 x 2 mesh (the conv's segments
    included) gives blocks of ``local_shape`` that, put back in rank
    order along each split dimension, are the global leaves;
    ``tree_shardings`` wraps every spec."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.models import transformer as T
    cfg = _cfg(arch, 512)
    whole = tree_flatten(_init(arch, 512))
    names = ("data", "model")
    rules = shd.make_rules(fsdp=True)
    specs = _flat_specs(T.param_pspecs(cfg, rules, StubMesh(
        (2, 2), names, (0, 0))), whole)
    assert any(isinstance(e, shd.Segmented) for s in specs.values()
               for e in s) == (arch == "zamba2-1.2b")
    blocks = {}
    for d in range(2):
        for m in range(2):
            mesh = StubMesh((2, 2), names, (d, m))
            got = tree_flatten(shd.shard_tree(
                _init(arch, 512), T.param_pspecs(cfg, rules, mesh), mesh))
            for k, v in got.items():
                assert tuple(v.shape) == shd.local_shape(
                    whole[k].shape, specs[k], mesh), k
            blocks[(d, m)] = got
    for k, spec in specs.items():
        def rebuild(x_of, dims):
            """Concatenate along the split dimensions, the last first."""
            if not dims:
                return x_of({})
            dim, entry = dims[-1]
            axis = shd.entry_axes(entry)[0]
            parts = [rebuild(lambda c, i=i: x_of({**c, axis: i}), dims[:-1])
                     for i in range(2)]
            if isinstance(entry, shd.Segmented):
                cut = [torch.split(p, [n // 2 if s else n for n, s in zip(
                    entry.sizes, entry.split)], dim=dim) for p in parts]
                return torch.cat([torch.cat([c[j] for c in cut], dim=dim)
                                  if s else cut[0][j] for j, s in
                                  enumerate(entry.split)], dim=dim)
            return torch.cat(parts, dim=dim)
        dims = [(d, e) for d, e in enumerate(spec) if e is not None]
        got = rebuild(lambda c: blocks[(c.get("data", 0),
                                        c.get("model", 0))][k], dims)
        assert torch.equal(got, whole[k]), k
    shardings = list(tree_flatten(shd.tree_shardings("mesh", T.param_pspecs(
        cfg, rules, StubMesh((2, 2), names, (0, 0))))).values())
    assert [s.spec for s in shardings] == list(specs.values())
    assert all(s.mesh == "mesh" for s in shardings)


def _flat_specs(pspecs, like) -> dict:
    """{leaf path of ``like``: its PartitionSpec}."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten
    out = []
    shd.map_specs(out.append, pspecs)
    return dict(zip(tree_flatten(like), out, strict=True))
