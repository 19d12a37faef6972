"""The port's step builders (``repro_torch.launch.steps``), ``wsd`` and the
K4 / K5 autograd functions against the JAX package, at ``reduced`` widths
on the CPU.

The JAX reference runs its own step builders on a 1 x 1 CPU mesh with
float32 parameters; its ``jax.random`` init crosses through
``repro_torch.convert``; batches come from numpy seeds.

Gradient bounds come from a measured 1-ulp spread, not from a chosen
number: each test nudges every weight of the same init by about one unit
in the last place (x (1 + 2^-23 N(0, 1))) and measures how far each
package's own gradients move (per leaf, as a share of the leaf's largest
gradient; the spread is the largest share over the leaves).  The gap
between the packages, measured the same way, must stay within
``SPREAD_FACTOR`` times the larger of the two spreads.  On the reduced
models the gap is 0.75-1.8 times that spread (each test prints its
figures: ``pytest -s -k "train_step or distill"
tests/test_torch_steps.py``): largest for zamba2-1.2b, whose init puts
dt * A near 1e3, where JAX's ``ssd_chunked`` takes the decay exponents as
differences of cumulative sums and the port sums them directly (ROADMAP
queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common.arch_config import reduced as jreduced
from repro.configs.shapes import InputShape as JShape
from repro.kernels import ref as jkref
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsch
from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_map
from repro_torch.common.sharding import P
from repro_torch.configs.shapes import InputShape
from repro_torch.convert import to_torch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsch

MESH = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
SPREAD_FACTOR = 4.0
B, S = 2, 32


def _cfgs(name, **over):
    return (jreduced(jconfigs.get(name), **over),
            reduced(configs.get(name), **over))


@functools.lru_cache(maxsize=None)
def _jinit_fn(cfg_j):
    return jax.jit(lambda key: JT.init(cfg_j, key, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jinit(cfg_j, seed):
    return _jinit_fn(cfg_j)(jax.random.PRNGKey(seed))


def _init(cfg_j, seed=0):
    """JAX's float32 init of ``cfg_j`` (drawn once per module) and the
    port's copy of it."""
    pj = _jinit(cfg_j, seed)
    return pj, to_torch(jax.tree.map(np.asarray, pj))


def _np_batch(specs, cfg, seed=0):
    """numpy arrays for a tree of JAX ShapeDtypeStructs: ids uniform over
    the vocabulary, float inputs (frames, patches) at std 0.02, float32."""
    rng = np.random.default_rng(seed)
    return {k: (rng.integers(0, cfg.vocab_size, v.shape).astype(np.int32)
                if v.dtype == jnp.int32 else
                (rng.normal(size=v.shape) * 0.02).astype(np.float32))
            for k, v in specs.items()}


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _nudged(pj, seed=5):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        (np.asarray(x) * (1 + 2.0 ** -23 * rng.standard_normal(x.shape))
         ).astype(np.float32)), pj)


def _flat(tree) -> dict:
    return {k: v.detach().double() for k, v in tree_flatten(tree).items()}


def _jflat(tree) -> dict:
    return _flat(to_torch(jax.tree.map(np.asarray, tree)))


def _rel(a: dict, b: dict) -> float:
    """Largest per-leaf gap between two gradient trees, as a share of the
    second tree's leaf's largest entry."""
    return max(float((a[k] - b[k]).abs().max()
                     / max(float(b[k].abs().max()), 1e-30)) for k in b)


def _assert_grads_within_spread(gt, gt_n, gj, gj_n):
    """The packages' gradients within SPREAD_FACTOR x their 1-ulp spread."""
    t, tn, j, jn = _flat(gt), _flat(gt_n), _jflat(gj), _jflat(gj_n)
    assert sorted(t) == sorted(j)
    spread = max(_rel(tn, t), _rel(jn, j))
    gap = _rel(t, j)
    print(f"gradient gap {gap:.3g}, larger 1-ulp spread {spread:.3g} "
          f"({gap / spread:.2f}x)")
    assert gap <= SPREAD_FACTOR * spread, (gap, spread)
    return gap, spread


# ---------------------------------------------------------------------------
# Schedules and Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total", [1, 10, 1000])
def test_wsd_and_make_schedule_match_jax_bit_for_bit(total):
    w = max(int(total * 0.03), 1)
    stable_end = total - max(int(total * 0.1), 1)
    steps_ = sorted({s for s in (0, 1, w - 1, w, stable_end - 1, stable_end,
                                 total - 1, total, total + 5) if s >= 0})
    for kind in ("wsd", "cosine", "constant"):
        js, ts = (jsch.make_schedule(kind, 3e-4, total),
                  tsch.make_schedule(kind, 3e-4, total))
        for step in steps_:
            want = np.float32(js(jnp.int32(step)))
            got = np.float32(ts(step))
            if kind != "cosine":
                assert got.tobytes() == want.tobytes(), (kind, step)
            else:
                assert got == pytest.approx(want, rel=1e-6), (kind, step)


def test_adam_weight_decay_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jo = jopt.adam(1e-2, weight_decay=0.1)
    to = topt.adam(1e-2, weight_decay=0.1)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jd, js = jo.update({str(i): jnp.asarray(x) for i, x in enumerate(g)},
                           js, jp, jnp.int32(step))
        jp = jopt.apply_updates(jp, jd)
        td, ts = to.update([torch.from_numpy(x) for x in g], ts, tp, step)
        tp = topt.apply_updates(tp, td)
    for i, t in enumerate(tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[str(i)]),
                                   rtol=1e-6, atol=1e-7)
    # the decay term moves the parameters: not the same as without it
    assert not np.allclose(tp[0].numpy(), params[0], atol=1e-3)


def test_adam_step_in_groups_equals_one_update_bit_for_bit(monkeypatch):
    """``_adam_step`` packs small leaves together and slices a leaf larger
    than ADAM_CHUNK: at a chunk of 16 elements the same bits as one
    multi-tensor update over every leaf."""
    rng = np.random.default_rng(0)
    shapes = {"a": (10, 7), "b": (5,), "c": (), "d": (3, 4, 2), "e": (2,)}
    dtypes = {"a": torch.bfloat16}

    def tree():
        return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(dtypes.get(k, torch.float32))
                for k, s in shapes.items()}
    params = tree()
    grads = [tree() for _ in range(2)]
    opt = topt.adam(1e-2)
    out = {}
    for chunk in (1 << 40, 16):
        monkeypatch.setattr(steps, "ADAM_CHUNK", chunk)
        p = tree_map(torch.clone, params)
        state = topt.AdamState(*(tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), p)
            for _ in range(2)))
        quads = list(zip(*(tree_leaves(t) for t in
                           (p, state.mu, state.nu, grads[0]))))
        groups = steps._adam_groups(quads)
        assert all(sum(q[0].numel() for q in g) <= chunk for g in groups)
        assert len(groups) == (1 if chunk > 100 else 8), len(groups)
        for step, g in enumerate(grads):
            steps._adam_step(opt, p, state, g, step)
        out[chunk] = tree_leaves((p, state.mu, state.nu))
    for got, want in zip(out[16], out[1 << 40]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert not torch.equal(out[16][0], params["a"])


# ---------------------------------------------------------------------------
# Inputs and losses
# ---------------------------------------------------------------------------

def test_input_specs_match_jax_for_every_arch_and_shape_kind():
    kinds = [JShape("t", 64, 2, "train"), JShape("p", 64, 2, "prefill"),
             JShape("d", 64, 2, "decode")]
    for name in jconfigs.ASSIGNED:
        cj, ct = jconfigs.get(name), configs.get(name)
        for sh in kinds:
            want = jsteps.input_specs(cj, sh)
            got = steps.input_specs(ct, InputShape(sh.name, sh.seq_len,
                                                   sh.global_batch, sh.kind))
            assert list(got) == list(want), (name, sh.kind)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert got[k].device.type == "meta"
                assert str(got[k].dtype).split(".")[-1] == \
                    jnp.dtype(want[k].dtype).name, (name, k)


@pytest.mark.parametrize("name", ["qwen3-8b", "hubert-xlarge",
                                  "internvl2-1b"])
def test_token_xent_and_naive_match_jax(name):
    cj, ct = _cfgs(name)
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(2, 24, ct.vocab_size)) * 3).astype(np.float32)
    labels = rng.integers(0, ct.vocab_size, (2, 24)).astype(np.int32)
    for jf, tf in ((jsteps.token_xent, steps.token_xent),
                   (jsteps.token_xent_naive, steps.token_xent_naive)):
        want = float(jf(jnp.asarray(logits), jnp.asarray(labels), cj))
        got = float(tf(torch.from_numpy(logits), torch.from_numpy(labels),
                       ct))
        assert got == pytest.approx(want, rel=1e-6)
    # the roll-and-mask loss equals the sliced one (the VLM's two losses
    # read different label positions, in JAX as here)
    assert ct.frontend == "vision_patches" or float(steps.token_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels), ct)) == \
        pytest.approx(float(steps.token_xent_naive(
            torch.from_numpy(logits), torch.from_numpy(labels), ct)),
            rel=1e-6)


# ---------------------------------------------------------------------------
# forward(remat=) and the train step
# ---------------------------------------------------------------------------

def test_forward_remat_equals_plain_bit_for_bit():
    ct = reduced(configs.get("zamba2-1.2b"))
    pt = T.init(ct, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, ct.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    g0, m0 = steps.train_grads(pt, ct, batch, remat=False)
    g1, m1 = steps.train_grads(pt, ct, batch, remat=True)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def _jax_loss(cj):
    def loss(p, batch):
        lg, aux = JT.forward(p, cj, batch)
        lv = jsteps.token_xent(lg, batch["labels"], cj)
        return lv + cj.router_aux_coef * aux
    return loss


@pytest.mark.parametrize("name", ["zamba2-1.2b", "granite-moe-1b-a400m",
                                  "internvl2-1b"])
def test_train_step_matches_jax(name):
    cj, ct = _cfgs(name)
    # remat changes no value, and compiles slower on the CPU
    jb = jsteps.make_train_step(cj, JShape("t", S, B, "train"), MESH,
                                remat=False, param_dtype=jnp.float32)
    loss = _jax_loss(cj)

    @jax.jit
    def jax_ref(p, batch):
        """JAX's train step's metrics and the gradient it takes."""
        metrics = jb.fn(p, jopt.adam(3e-4).init(p), jnp.int32(0), batch)[3]
        return metrics, jax.grad(loss)(p, batch)

    pj, pt = _init(cj)
    nb = _np_batch(jb.args[3], cj)
    pn = _nudged(pj)
    with MESH:
        jm, gj = jax_ref(pj, nb)
        _, gj_n = jax_ref(pn, nb)
    tb = steps.make_train_step(ct, InputShape("t", S, B, "train"),
                               param_dtype=torch.float32)
    assert tb.donate_argnums == (0, 1)
    batch = _torch(nb)
    grads, m = steps.train_grads(pt, ct, batch)
    for k in ("loss", "moe_aux"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7)

    # the step: the port's own Adam on those gradients, in place
    params = tree_map(torch.clone, pt)
    opt_state = topt.AdamState(*(tree_map(torch.zeros_like, pt)
                                 for _ in range(2)))
    out = tb.fn(params, opt_state, torch.zeros((), dtype=torch.int32), batch)
    assert out[0] is params and out[1] is opt_state and int(out[2]) == 1
    assert float(out[3]["loss"]) == float(m["loss"])
    leaves = tree_leaves(pt)
    deltas, _ = topt.adam(3e-4).update(tree_leaves(grads),
                                       topt.adam(3e-4).init(leaves), leaves,
                                       0)
    for got, want in zip(tree_leaves(params),
                         topt.apply_updates(leaves, deltas)):
        assert torch.equal(got, want)

    # the gradients against JAX's, within their 1-ulp spread
    gn, _ = steps.train_grads(to_torch(jax.tree.map(np.asarray, pn)), ct,
                              batch)
    _assert_grads_within_spread(grads, gn, gj, gj_n)

    # gradient accumulation over 2 microbatches: the same mean (an MoE
    # routes each microbatch with its own capacity and aux loss, so only
    # the dense and hybrid models are held to it)
    if not ct.has_moe:
        g2, m2 = steps.train_grads(pt, ct, batch, microbatch=2)
        assert float(m2["loss"]) == pytest.approx(float(m["loss"]),
                                                  rel=1e-6)
        for a, b in zip(tree_leaves(g2), tree_leaves(grads)):
            assert float((a - b).abs().max()) <= \
                1e-6 * float(b.abs().max()) + 1e-12


# ---------------------------------------------------------------------------
# Prefill and serve
# ---------------------------------------------------------------------------

def _grown(small, big_shape_tree):
    """``small`` copied into zeros of ``big_shape_tree``'s shapes (a cache
    with room for more tokens)."""
    def grow(s, b):
        out = np.zeros(b.shape, np.asarray(s).dtype)
        out[tuple(slice(0, n) for n in np.shape(s))] = np.asarray(s)
        return out
    return jax.tree.map(grow, small, big_shape_tree)


@pytest.mark.parametrize("name", ["zamba2-1.2b", "qwen3-8b"])
def test_prefill_and_serve_steps_match_jax(name):
    cj, ct = _cfgs(name)
    prompt = 16
    pj, pt = _init(cj)
    jp = jsteps.make_prefill_step(cj, JShape("p", prompt, B, "prefill"),
                                  MESH, param_dtype=jnp.float32)
    nb = _np_batch(jp.args[1], cj)
    with MESH:
        jlog, jcache = jp.jit()(pj, nb)
    tp = steps.make_prefill_step(ct, InputShape("p", prompt, B, "prefill"),
                                 param_dtype=torch.float32)
    tlog, tcache = tp.fn(pt, _torch(nb))
    assert tuple(tlog.shape) == tuple(jlog.shape) == (B, 1, ct.vocab_size)
    scale = float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-3 * scale)
    jc, tc = _jflat(jcache), _flat(tcache)
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert float((tc[k] - jc[k]).abs().max()) <= \
            1e-3 * float(jc[k].abs().max()) + 1e-12, k

    # one decode token against the caches grown by one slot
    dshape = JShape("d", prompt + 1, B, "decode")
    js = jsteps.make_serve_step(cj, dshape, MESH, param_dtype=jnp.float32,
                                cache_dtype=jnp.float32)
    tok = _np_batch(js.args[1], cj, seed=3)
    caches = _grown(jcache, js.args[2])
    with MESH:
        jlog2, jcache2 = js.jit()(pj, tok, jax.tree.map(jnp.asarray, caches),
                                  jnp.int32(prompt))
    ts = steps.make_serve_step(ct, InputShape("d", prompt + 1, B, "decode"),
                               param_dtype=torch.float32,
                               cache_dtype=torch.float32)
    assert ts.donate_argnums == (2,)
    tcaches = to_torch(caches)
    tlog2, tcache2 = ts.fn(pt, _torch(tok), tcaches, prompt)
    assert tcache2 is tcaches                        # updated in place
    scale = float(np.abs(np.asarray(jlog2)).max())
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), rtol=0,
                               atol=1e-3 * scale)
    jc, tc = _jflat(jcache2), _flat(tcache2)
    for k in jc:
        assert float((tc[k] - jc[k]).abs().max()) <= \
            1e-3 * float(jc[k].abs().max()) + 1e-12, k


# ---------------------------------------------------------------------------
# FedDF: the distill step and the clients' round
# ---------------------------------------------------------------------------

def test_distill_step_matches_jax():
    cj, ct = _cfgs("qwen3-8b")
    k, b, s = 2, 2, 16
    jb = jsteps.make_distill_step(cj, MESH, n_teachers=k, batch_size=b,
                                  seq_len=s, remat=False,
                                  param_dtype=jnp.float32)

    def jloss_fn(p, teachers, tokens):
        t_logits, _ = jax.vmap(lambda q: JT.forward(
            q, cj, {"tokens": tokens}))(teachers)
        s_logits, aux = JT.forward(p, cj, {"tokens": tokens})
        v = s_logits.shape[-1]
        return (jkref.ensemble_kl(s_logits.reshape(-1, v),
                                  t_logits.reshape(k, -1, v))
                + cj.router_aux_coef * aux)

    @jax.jit
    def jax_ref(p, teachers, batch):
        """JAX's distill step's loss and the gradient it takes."""
        loss = jb.fn(p, teachers, jopt.adam(1e-3).init(p), jnp.int32(0),
                     batch)[3]
        return loss, jax.grad(jloss_fn)(p, teachers, batch["tokens"])

    pj, pt = _init(cj)
    pn = _nudged(pj)
    tj = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        _jinit(cj, 10 + i) for i in range(k)])
    nb = _np_batch(jb.args[4], cj)
    with MESH:
        jloss, gj = jax_ref(pj, tj, nb)
        _, gj_n = jax_ref(pn, tj, nb)
    tt = to_torch(jax.tree.map(np.asarray, tj))
    batch = _torch(nb)
    grads, loss = steps.distill_grads(pt, tt, ct, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)

    tb = steps.make_distill_step(ct, n_teachers=k, batch_size=b, seq_len=s,
                                 param_dtype=torch.float32)
    student = tree_map(torch.clone, pt)
    opt_state = topt.AdamState(*(tree_map(torch.zeros_like, pt)
                                 for _ in range(2)))
    out = tb.fn(student, tt, opt_state, torch.zeros((), dtype=torch.int32),
                batch)
    assert out[0] is student and float(out[3]) == float(loss)

    gn, _ = steps.distill_grads(to_torch(jax.tree.map(np.asarray, pn)), tt,
                                ct, batch)
    _assert_grads_within_spread(grads, gn, gj, gj_n)


def test_fed_round_step_matches_jax():
    cj, ct = _cfgs("qwen3-8b")
    kw = dict(n_clients=2, local_steps=2, batch_size=2, seq_len=16)
    jb = jsteps.make_fed_round_step(cj, MESH, param_dtype=jnp.float32, **kw)
    stacked_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        _jinit(cj, i) for i in range(2)])
    nb = _np_batch(jb.args[1], cj)
    stacked_t = to_torch(jax.tree.map(np.asarray, stacked_j))
    with MESH:
        jout = jb.jit()(jax.tree.map(jnp.copy, stacked_j), nb)
    tb = steps.make_fed_round_step(ct, param_dtype=torch.float32, **kw)
    before = tree_map(torch.clone, stacked_t)
    tout = tb.fn(stacked_t, _torch(nb))
    assert tout is stacked_t
    want, got, was = _jflat(jout), _flat(tout), _flat(before)
    for k in want:
        assert float((got[k] - want[k]).abs().max()) <= \
            1e-5 * float(want[k].abs().max()), k
    # the round moved the clients
    assert any(not torch.equal(got[k], was[k]) for k in got)


# ---------------------------------------------------------------------------
# What the port does not run yet, and where it runs
# ---------------------------------------------------------------------------

def test_meshes_and_sharding_knobs_raise_naming_item_11_7():
    """What raised until item 11.8.4(c), JAX's MoE partitioner path, now
    builds: an MoE model under ``dp_heavy*`` on a mesh,
    ``use_moe_shard_map=False`` on a mesh, and the serve and distill steps
    of an MoE model whose experts split on ``"model"`` (each rank's
    bundle holds half the experts; ``tests/test_torch_moe_mesh.py`` runs
    them).  The train, prefill, distill and serve steps, every layout,
    ``constrain_acts`` and ``naive_xent``, and the federated round's model
    axis run on meshes (``tests/test_torch_model_axis.py``,
    ``tests/test_torch_mesh_serve.py``, ``tests/test_torch_layouts.py``,
    ``tests/test_torch_multihost.py``); without a mesh the layout knobs
    change nothing, as in JAX on one device.  An unknown layout
    raises."""
    from test_torch_model_axis import StubMesh
    from repro_torch.common.pytree import tree_flatten
    ct = reduced(configs.get("qwen3-8b"))
    cm = reduced(configs.get("granite-moe-1b-a400m"))
    shape = InputShape("t", S, B, "train")
    stub = StubMesh((1, 2), ("data", "model"), (0, 0))

    def half_experts(bundle):
        gates = [v for k, v in tree_flatten(bundle.args[0]).items()
                 if k.endswith("wi_gate")]
        return bool(gates) and all(g.shape[-3] == cm.n_experts // 2
                                   for g in gates)
    for build, cfg, kw in (
            (steps.make_train_step, cm, dict(layout="dp_heavy")),
            (steps.make_prefill_step, cm, dict(layout="dp_heavy_z3")),
            (steps.make_train_step, ct, dict(use_moe_shard_map=False)),
            (steps.make_train_step, cm, dict(use_moe_shard_map=False))):
        bundle = build(cfg, shape, stub, **kw)
        assert bundle.layout is not None
        assert cfg is ct or half_experts(bundle)
        assert build(cfg, shape, **kw).layout is None
    for bundle in (steps.make_serve_step(cm, InputShape("d", S, B, "decode"),
                                         stub),
                   steps.make_distill_step(cm, stub)):
        assert half_experts(bundle)
    for kw in (dict(layout="dp_heavy", constrain_acts=True,
                    naive_xent=True), dict(layout="dp_heavy_z3")):
        steps.make_train_step(ct, shape, **kw)
        steps.make_train_step(ct, shape, stub, **kw)
    with pytest.raises(ValueError, match="layout"):
        steps.make_train_step(ct, shape, layout="fsdp")
    # the federated round's client axis runs on a data-only mesh (11.7)
    from repro_torch.launch import mesh as tmesh
    with tmesh.one_rank_world("cpu"):
        for mesh in (tmesh.make_client_mesh(), tmesh.make_host_mesh(1, 1)):
            b = steps.make_fed_round_step(ct, mesh, n_clients=2)
            assert b.client_slice == slice(0, 2)
            assert b.client_axes == ("data",)
            assert b.layout is None
            assert tuple(tree_leaves(b.args[0])[0].shape)[0] == 2
    with pytest.raises(ValueError, match="act_sharding"):
        T.forward(T.init(ct, torch.Generator().manual_seed(0)), ct,
                  {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                  act_sharding=P("data", None, None))
    # fsdp shards nothing on one device: both values build
    steps.make_train_step(ct, shape, fsdp=False)
    bundle = steps.make_train_step(ct, shape, param_dtype=torch.float32)
    args = bundle.init_args(torch.Generator().manual_seed(0), device="cpu")
    assert all(x.device.type == "cpu" for x in tree_leaves(args[0]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bundle.init_args()


def _as_kernel(monkeypatch):
    """Stand the plain versions in for the CUDA kernels, so the autograd
    functions' wiring runs on CPU tensors."""
    from repro_torch.kernels import ssd_scan, swa_attn
    monkeypatch.setattr(swa_attn, "swa_attn", tref.swa_attn)
    monkeypatch.setattr(ssd_scan, "ssd_scan", lambda *a: tref.ssd_scan(
        *a[:5], 8, a[5]))


@pytest.mark.parametrize("with_state", [False, True])
def test_autograd_functions_backward_is_the_plain_gradient(monkeypatch,
                                                           with_state):
    _as_kernel(monkeypatch)
    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v = r(2, 4, 12, 8), r(2, 2, 12, 8), r(2, 2, 12, 8)
    go = r(2, 4, 12, 8)
    for window, causal in ((None, True), (5, True), (None, False)):
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        b = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ops._SwaAttn.apply(*a, window, causal)
        torch.autograd.backward(out, go)
        torch.autograd.backward(tref.swa_attn(*b, window, causal), go)
        for x, y in zip(a, b):
            assert torch.equal(x.grad, y.grad)
    x, dt = r(2, 20, 3, 4), torch.rand(2, 20, 3) * 0.1
    a_log, bm, cm = r(3) * 0.1, r(2, 20, 5), r(2, 20, 5)
    s0 = r(2, 3, 5, 4) if with_state else None
    gy, gs = r(2, 20, 3, 4), r(2, 3, 5, 4)
    ins = [t for t in (x, dt, a_log, bm, cm, s0)]
    for use_state_grad in (False, True):
        a = [None if t is None else t.clone().requires_grad_() for t in ins]
        b = [None if t is None else t.clone().requires_grad_() for t in ins]
        y, st = ops._SsdScan.apply(*a, 8)
        y2, st2 = tref.ssd_scan(*b[:5], 8, b[5])
        assert torch.equal(y, y2) and torch.equal(st, st2)
        loss = (y * gy).sum() + ((st * gs).sum() if use_state_grad else 0)
        loss2 = (y2 * gy).sum() + ((st2 * gs).sum() if use_state_grad
                                   else 0)
        loss.backward()
        loss2.backward()
        for p, p2 in zip(a, b):
            if p is not None:
                assert torch.equal(p.grad, p2.grad)


def test_autograd_functions_differentiate_only_what_needs_it(monkeypatch):
    _as_kernel(monkeypatch)
    rng = np.random.default_rng(1)
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v = r(1, 2, 6, 4).requires_grad_(), r(1, 2, 6, 4), r(1, 2, 6, 4)
    ops._SwaAttn.apply(q, k, v, None, True).sum().backward()
    q2 = q.detach().clone().requires_grad_()
    tref.swa_attn(q2, k, v, None, True).sum().backward()
    assert torch.equal(q.grad, q2.grad) and k.grad is None
    x = r(1, 8, 2, 3).requires_grad_()
    rest = (torch.rand(1, 8, 2) * 0.1, r(2) * 0.1, r(1, 8, 4), r(1, 8, 4))
    y, st = ops._SsdScan.apply(x, *rest, None, 8)
    y.sum().backward()
    x2 = x.detach().clone().requires_grad_()
    tref.ssd_scan(x2, *rest, 8, None)[0].sum().backward()
    assert torch.equal(x.grad, x2.grad)
    assert all(t.grad is None for t in rest)
