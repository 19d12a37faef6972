"""The distill and serve steps on a mesh (items 11.8.1's rest and 11.8.2) on
gloo ranks on the CPU, against the JAX package.

A module-scoped ``launch_ranks`` world of 4 ranks runs the 2 x 2 cases
and a world of 2 ranks, started beside it, the 1 x 2 and 2 x 1 cases (a
mesh spans its whole world).  The ranks import no JAX: they draw the
parameters with the port's ``T.init`` (JAX gets the same leaves), and
the parent computes the JAX references while the ranks run.

* ``make_distill_step`` (reduced zamba2-1.2b and qwen3-8b at a
  vocabulary of 512, split over ``"model"``: K2 over vocabulary shards;
  2 teachers stacked with their leading axis whole; the batch over the
  data axis, FSDP over it on 2 x 2): the loss within 1e-5 of JAX's
  ``make_distill_step`` on a 1 x 1 mesh, the gradients gathered whole
  against JAX's by ``tests/test_torch_model_axis.py``'s method (within
  ``SPREAD_FACTOR`` times the port's own 1-ulp spread of its one-device
  gradients, and within ``SPREAD_FACTOR`` times the larger spread of the
  two packages plus the one-device port's gap to JAX), and the step's
  Adam on the blocks equal, bit for bit, to Adam on the gathered
  gradients.
* ``make_serve_step`` (reduced zamba2-1.2b, qwen3-8b and gemma3-4b,
  whose local layers decode on a ring buffer of its window): a sharded
  ``make_prefill_step`` of a 29-token prompt, ``T.serve_caches`` into
  JAX's ``kv_cache_rules`` layout (the sequence of a 64-slot cache over
  ``"model"``, every head on each rank), then 6 tokens through the serve
  step, ``cur_len`` 29 to 34: past slot 32, where the global caches'
  shards meet, and around the 32-slot ring, whose shards meet at 16.  On
  1 x 2 and 2 x 2 at batch 2 (the batch over the data axis) and on 2 x 1
  at batch 1 (the batch released, the sequence over ``("data",
  "model")``).  Each token's logits, gathered, within 1e-3 of the
  largest against JAX's one-device ``prefill`` + ``decode_step``
  (``tests/test_torch_serve.py``'s bound); the caches' blocks of the
  shapes the bundle promises.
"""
import concurrent.futures
import os

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh
from test_torch_model_axis import (_flat_np, _nudged_t, _rel, _to_jax,
                                   SPREAD_FACTOR)

LOSS_REL = 1e-5
SERVE_REL = 1e-3              # tests/test_torch_serve.py's
VOCAB = 512
DISTILL_B, DISTILL_S, TEACHERS = 4, 16, 2
PROMPT, MAX_SEQ, N_TOK = 29, 64, 6
RANK_TIMEOUT_S = 300
NAMES = ("data", "model")

DISTILL_CASES = [(f"{a.split('-')[0]}-{m[0]}x{m[1]}", a, m)
                 for a in ("zamba2-1.2b", "qwen3-8b")
                 for m in ((1, 2), (2, 2))]
SERVE_CASES = [(f"{a.split('-')[0]}-{m[0]}x{m[1]}-b{b}", a, m, b)
               for a in ("zamba2-1.2b", "qwen3-8b", "gemma3-4b")
               for m, b in (((1, 2), 2), ((2, 2), 2), ((2, 1), 1))]


def _cfg(arch):
    from repro_torch import configs
    from repro_torch.common.arch_config import reduced
    return reduced(configs.get(arch), vocab_size=VOCAB)


def _student(arch):
    from repro_torch.models import transformer as T
    return T.init(_cfg(arch), torch.Generator().manual_seed(0))


def _teachers(arch):
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import transformer as T
    return tree_map(lambda *xs: torch.stack(xs), *[
        T.init(_cfg(arch), torch.Generator().manual_seed(10 + i))
        for i in range(TEACHERS)])


def _distill_tokens(cfg):
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size,
                        (DISTILL_B, DISTILL_S)).astype(np.int32)


def _serve_tokens(cfg):
    rng = np.random.default_rng(2)
    return rng.integers(0, cfg.vocab_size, (2, PROMPT + N_TOK)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# what the ranks run (port code only)
# ---------------------------------------------------------------------------

def distill_case(arch, shape) -> dict:
    """The distill step's gathered gradients and loss on this world's
    mesh, and whether its Adam on the blocks equals Adam on them whole."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import (tree_flatten, tree_leaves,
                                           tree_map)
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers as topt
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, NAMES)
    bundle = steps.make_distill_step(
        cfg, mesh, n_teachers=TEACHERS, batch_size=DISTILL_B,
        seq_len=DISTILL_S, param_dtype=torch.float32)
    tp = bundle.layout
    whole = _student(arch)
    student = shd.shard_tree(whole, tp.pspecs, mesh)
    teachers = shd.shard_tree(_teachers(arch), shd.stacked_specs(tp.pspecs),
                              mesh)
    for a, m in zip(tree_leaves((student, teachers)),
                    tree_leaves(bundle.args[:2]), strict=True):
        assert tuple(a.shape) == tuple(m.shape)
    batch = steps.batch_block(
        {"tokens": torch.from_numpy(_distill_tokens(cfg))}, tp)
    grads, loss = steps.distill_grads(student, teachers, cfg, batch,
                                      layout=tp)
    g_whole = shd.gather_tree(grads, tp.pspecs, mesh)
    zeros = tree_map(torch.zeros_like, whole)
    opt = topt.AdamState(*(shd.shard_tree(zeros, tp.pspecs, mesh)
                           for _ in range(2)))
    out_loss = bundle.fn(student, teachers, opt,
                         torch.zeros((), dtype=torch.int32), batch)[3]
    stepped = tree_leaves(shd.gather_tree(student, tp.pspecs, mesh))
    w = tree_leaves(whole)
    deltas, _ = topt.adam(1e-3).update(tree_leaves(g_whole),
                                       topt.adam(1e-3).init(w), w, 0)
    out = {"loss": float(loss), "step_loss": float(out_loss),
           "adam_equal": all(torch.equal(a, b) for a, b in zip(
               stepped, topt.apply_updates(w, deltas)))}
    if tmesh.world_rank() == 0:
        out["grads"] = {k: v.numpy()
                        for k, v in tree_flatten(g_whole).items()}
    return out


def serve_case(arch, shape, batch) -> list:
    """Each decoded token's logits, gathered whole, after a sharded
    prefill and the reshard to the serve layout."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(shape, NAMES)
    toks = torch.from_numpy(_serve_tokens(cfg)[:batch])
    pre = steps.make_prefill_step(
        cfg, InputShape("p", MAX_SEQ, batch, "prefill"), mesh,
        param_dtype=torch.float32)
    serve = steps.make_serve_step(
        cfg, InputShape("d", MAX_SEQ, batch, "decode"), mesh,
        param_dtype=torch.float32, cache_dtype=torch.float32)
    params = shd.shard_tree(_student(arch), pre.layout.pspecs, mesh)
    _, caches = pre.fn(params, steps.batch_block(
        {"tokens": toks[:, :PROMPT]}, pre.layout))
    caches = T.serve_caches(caches, cfg, pre.layout, serve.layout)
    for c, m in zip(tree_leaves(caches), tree_leaves(serve.outs[1]),
                    strict=True):
        assert tuple(c.shape) == tuple(m.shape)
    tp, out = serve.layout, []
    for i in range(N_TOK):
        tok = steps.batch_block(
            {"tokens": toks[:, PROMPT + i:PROMPT + i + 1]}, tp)
        logits, got = serve.fn(params, tok, caches, PROMPT + i)
        assert got is caches and tuple(logits.shape) == tuple(
            serve.outs[0].shape)
        out.append(shd.gather_tensor(
            logits, shd.P(tp.batch_entry, None, "model"), mesh).numpy())
    return out


def rank_suite():
    """Every case whose mesh this world's size fits, in order."""
    n = tmesh.world_size()
    out = {}
    for cid, arch, shape in DISTILL_CASES:
        if int(np.prod(shape)) == n:
            out[cid] = distill_case(arch, shape)
    for cid, arch, shape, batch in SERVE_CASES:
        if int(np.prod(shape)) == n:
            out[cid] = serve_case(arch, shape, batch)
    return out


# ---------------------------------------------------------------------------
# the parent: JAX's references
# ---------------------------------------------------------------------------

def _jax_distill(arch):
    """JAX's distill-step loss and gradient (its loss: the teachers'
    vmapped forwards, the student's, ``ensemble_kl``'s reference) on a
    1 x 1 mesh, at the student and at its 1-ulp nudge, and the port's
    one-device gradients at both."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.kernels import ref as jkref
    from repro.launch import steps as jsteps
    from repro.models import transformer as JT
    from repro.optim import optimizers as jopt
    from repro_torch import convert
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import steps
    cj = jreduced(jconfigs.get(arch), vocab_size=VOCAB)
    ct = _cfg(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             NAMES)
    jb = jsteps.make_distill_step(cj, mesh, n_teachers=TEACHERS,
                                  batch_size=DISTILL_B, seq_len=DISTILL_S,
                                  remat=False, param_dtype=jnp.float32)

    def jloss(p, teachers, tokens):
        t_logits, _ = jax.vmap(lambda q: JT.forward(
            q, cj, {"tokens": tokens}))(teachers)
        s_logits, aux = JT.forward(p, cj, {"tokens": tokens})
        v = s_logits.shape[-1]
        return (jkref.ensemble_kl(s_logits.reshape(-1, v),
                                  t_logits.reshape(TEACHERS, -1, v))
                + cj.router_aux_coef * aux)

    @jax.jit
    def ref(p, teachers, tokens):
        loss = jb.fn(p, teachers, jopt.adam(1e-3).init(p), jnp.int32(0),
                     {"tokens": tokens})[3]
        return loss, jax.grad(jloss)(p, teachers, tokens)

    pt, tt = _student(arch), _teachers(arch)
    pn = _nudged_t(pt)
    tj = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        _to_jax(tree_map(lambda x: x[i], tt), cj) for i in range(TEACHERS)])
    toks = _distill_tokens(ct)
    with mesh:
        jl, gj = ref(_to_jax(pt, cj), tj, toks)
        _, gj_n = ref(_to_jax(pn, cj), tj, toks)
    tb = {"tokens": torch.from_numpy(toks)}
    gt, _ = steps.distill_grads(pt, tt, ct, tb, remat=False)
    gt_n, _ = steps.distill_grads(pn, tt, ct, tb, remat=False)
    jflat = lambda g: _flat_np(convert.to_torch(jax.tree.map(np.asarray,
                                                             g)))
    return {"loss": float(jl), "j": jflat(gj), "j_n": jflat(gj_n),
            "t": _flat_np(gt), "t_n": _flat_np(gt_n)}


def _jax_serve(arch):
    """JAX's one-device prefill of the prompt and ``decode_step`` of each
    next token, at batch 2: each token's logits."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.models import transformer as JT
    cj = jreduced(jconfigs.get(arch), vocab_size=VOCAB)
    params = _to_jax(_student(arch), cj)
    toks = jnp.asarray(_serve_tokens(_cfg(arch)))
    _, caches = jax.jit(lambda p, t: JT.prefill(p, cj, {"tokens": t},
                                                MAX_SEQ))(params,
                                                          toks[:, :PROMPT])
    step = jax.jit(lambda p, t, c, n: JT.decode_step(p, cj, {"tokens": t},
                                                     c, n))
    out = []
    for i in range(N_TOK):
        logits, caches = step(params, toks[:, PROMPT + i:PROMPT + i + 1],
                              caches, jnp.int32(PROMPT + i))
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def world():
    threads = max(1, (os.cpu_count() or 4) // 8)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        four = pool.submit(tmesh.launch_ranks, rank_suite, 4, "cpu",
                           timeout_s=RANK_TIMEOUT_S, threads=threads)
        two = pool.submit(tmesh.launch_ranks, rank_suite, 2, "cpu",
                          timeout_s=RANK_TIMEOUT_S, threads=threads)
        distill = {a: pool.submit(_jax_distill, a)
                   for a in {c[1] for c in DISTILL_CASES}}
        serve = {a: pool.submit(_jax_serve, a)
                 for a in {c[1] for c in SERVE_CASES}}
        ranks = {k: [r[k] for r in runs.result()] for runs in (four, two)
                 for k in runs.result()[0]}
        return {"ranks": ranks,
                "distill": {a: f.result() for a, f in distill.items()},
                "serve": {a: f.result() for a, f in serve.items()}}


@pytest.mark.parametrize("cid", [c[0] for c in DISTILL_CASES])
def test_distill_step_on_a_mesh_matches_jax(world, cid):
    arch = next(c[1] for c in DISTILL_CASES if c[0] == cid)
    ref = world["distill"][arch]
    runs = world["ranks"][cid]
    for r in runs:
        assert r["loss"] == pytest.approx(ref["loss"], rel=LOSS_REL)
        assert r["step_loss"] == r["loss"]
        assert r["adam_equal"], cid
    got = runs[0]["grads"]
    assert sorted(got) == sorted(ref["j"]) == sorted(ref["t"])
    own = _rel(ref["t_n"], ref["t"])
    spread = max(own, _rel(ref["j_n"], ref["j"]))
    port_gap, one_device_gap = _rel(got, ref["t"]), _rel(ref["t"], ref["j"])
    gap = _rel(got, ref["j"])
    print(f"{cid}: gradient gap to the one-device port {port_gap:.3g} (its "
          f"1-ulp spread {own:.3g}), to JAX {gap:.3g} (the one-device "
          f"port's {one_device_gap:.3g}; larger spread {spread:.3g})")
    assert port_gap <= SPREAD_FACTOR * own, (port_gap, own)
    assert gap <= SPREAD_FACTOR * spread + one_device_gap, (
        gap, spread, one_device_gap)


@pytest.mark.parametrize("cid", [c[0] for c in SERVE_CASES])
def test_serve_step_on_a_mesh_matches_jax(world, cid):
    arch, batch = next((c[1], c[3]) for c in SERVE_CASES if c[0] == cid)
    want = world["serve"][arch]
    for run in world["ranks"][cid]:
        assert len(run) == N_TOK
        for got, w in zip(run, want):
            w = w[:batch]
            assert got.shape == w.shape == (batch, 1, VOCAB)
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=SERVE_REL * np.abs(w).max())
