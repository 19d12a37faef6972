"""JAX's other step-builder layouts on the port's meshes (ROADMAP items
11.8.4 (a)-(b)): ``layout="dp_heavy"`` / ``"dp_heavy_z3"``,
``constrain_acts`` / ``act_sharding`` and ``naive_xent``, on gloo ranks on
the CPU, against the port's one-device steps and the JAX package.

A module-scoped ``launch_ranks`` world of 4 ranks runs the 2 x 2 cases and
a world of 2 ranks, started beside it, the 1 x 2 cases (a mesh spans its
whole world).  The ranks import no JAX: they draw the parameters with the
port's ``T.init`` (each leaf cut to the rank's block as it is drawn; JAX
gets the same leaves), and the parent computes the references meanwhile.

* The train step (``make_train_step(..., layout=, constrain_acts=,
  microbatch=, naive_xent=)``), reduced widths, 16 tokens a row: one step
  from zero Adam moments, whose first moment is ``(1 - b1)`` times the
  gradient in every package, gathered whole.  Held within
  ``SPREAD_FACTOR`` times the port's own 1-ulp spread of its one-device
  step (the same builder and knobs without a mesh), and, where JAX's row
  is given, within ``SPREAD_FACTOR`` times the larger spread of the two
  packages plus the one-device port's gap to JAX (zamba2's SSD decay,
  ROADMAP queue 3) against JAX's ``make_train_step`` with the same knobs
  ``.jit()``-ed on a 1 x 1 mesh (JAX's own 2 x 2 lowering of these
  layouts fails under the JAX of this repo's tests, queue 3); the loss
  within ``LOSS_REL``.  The rows of JAX's variant table
  (``tests/test_perf_variants.py``): gemma3-4b, zamba2-1.2b and qwen3-8b
  with ``microbatch=2``, each with ``constrain_acts``; minicpm-2b with
  ``dp_heavy`` (its odd vocabulary of 503 left whole on ``"model"``, as
  JAX's fitted spec leaves the full model's 122753); phi3-medium-14b with
  ``dp_heavy_z3``; and zamba2-1.2b under both ``dp_heavy`` layouts at a
  vocabulary of 512 (split over ``"model"``, then gathered; JAX's row
  under ``dp_heavy_z3``, the same mathematics on one device).
* ``microbatch=2`` under ``dp_heavy``: the first moment within
  ``MICROBATCH_REL`` of the same mesh's single batch, the loss within
  1e-6 (JAX's ``test_microbatch_accumulation_matches_single_batch``).
* A global batch of 2 on 2 x 2 under ``dp_heavy_z3``: JAX's fitted spec
  keeps ``("data",)`` and the two model ranks hold the same rows; the
  gradients, reduce-scattered over both axes, must not count them twice.
* ``naive_xent`` on a ``tp`` mesh (the logits all-gathered over
  ``"model"``): against JAX's ``token_xent_naive`` step on one device.
* ``constrain_acts``: the train, prefill and distill steps equal bit for
  bit to the same steps without it, on a mesh and on one device.
* A ``dp_heavy`` / ``dp_heavy_z3`` prefill (every head, the batch over
  both axes) through ``T.serve_caches`` into the ``tp`` serve step on 2 x
  2: each of 6 tokens' logits within ``SERVE_REL`` of the largest against
  the unsharded prefill + ``decode_step``.
* An MoE model builds under ``dp_heavy*`` on a mesh (it raised until
  item 11.8.4(c); ``tests/test_torch_moe_mesh.py`` runs it); what
  raises: an ``act_sharding`` that is not the layout's.
* ``launch/dryrun.py --layout --mesh``: the per-rank argument bytes under
  ``dp_heavy_z3`` on 2 x 2 a quarter of the unsharded bytes, but for the
  leaves that stay whole.
"""
import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh
from test_torch_model_axis import (SPREAD_FACTOR, StubMesh, _flat_np,
                                   _nudged_t, _rel, _to_jax)

LOSS_REL = 1e-5
MICROBATCH_REL = 1e-5         # test_torch_model_axis.py's
SERVE_REL = 1e-3              # tests/test_torch_serve.py's
B, S = 4, 16
PROMPT, MAX_SEQ, N_TOK = 29, 64, 6
RANK_TIMEOUT_S = 300
NAMES = ("data", "model")
ACTS = dict(constrain_acts=True)

# (id, arch, vocab or None for the reduced 503, mesh, batch, step knobs,
#  whether JAX's step is the reference too)
TRAIN_CASES = [
    ("zamba2-dph-1x2", "zamba2-1.2b", 512, (1, 2), B,
     dict(layout="dp_heavy", **ACTS), False),
    ("zamba2-z3-2x2", "zamba2-1.2b", 512, (2, 2), B,
     dict(layout="dp_heavy_z3", **ACTS), True),
    ("minicpm-dph-2x2", "minicpm-2b", None, (2, 2), 2 * B,
     dict(layout="dp_heavy", **ACTS), True),
    ("phi3-z3-2x2", "phi3-medium-14b", 512, (2, 2), B,
     dict(layout="dp_heavy_z3", **ACTS), True),
    ("gemma3-tp-2x2", "gemma3-4b", None, (2, 2), B, dict(ACTS), False),
    ("zamba2-tp-2x2", "zamba2-1.2b", None, (2, 2), B, dict(ACTS), False),
    ("qwen3-mb2-2x2", "qwen3-8b", None, (2, 2), B,
     dict(microbatch=2, **ACTS), False),
    ("minicpm-dph-mb2-2x2", "minicpm-2b", None, (2, 2), 2 * B,
     dict(layout="dp_heavy", microbatch=2, **ACTS), False),
    ("zamba2-z3-2x2-b2", "zamba2-1.2b", 512, (2, 2), 2,
     dict(layout="dp_heavy_z3"), False),
    ("qwen3-naive-1x2", "qwen3-8b", 512, (1, 2), B, dict(naive_xent=True),
     True),
    ("qwen3-naive-2x2", "qwen3-8b", 512, (2, 2), B, dict(naive_xent=True),
     True),
]
# the train cases also run without constrain_acts, to be held equal bit
# for bit: one under tp, one under each dp_heavy layout
ACTS_PAIRED = ("gemma3-tp-2x2", "zamba2-dph-1x2", "phi3-z3-2x2")
# (id, arch, vocab, layout): a sharded prefill, then the tp serve step
SERVE_CASES = [("zamba2-dph-serve", "zamba2-1.2b", 512, "dp_heavy"),
               ("qwen3-z3-serve", "qwen3-8b", 512, "dp_heavy_z3")]
# JAX's variant rows that are not train steps: granite-moe's prefill and
# the distill step, each with constrain_acts
PREFILL_ARCH, DISTILL_ARCH = "granite-moe-1b-a400m", "gemma3-4b"
DISTILL_KW = dict(n_teachers=2, batch_size=B, seq_len=S)


def _cfg(arch, vocab):
    from repro_torch import configs
    from repro_torch.common.arch_config import reduced
    return reduced(configs.get(arch),
                   **({} if vocab is None else {"vocab_size": vocab}))


def _init(arch, vocab, layout=None, seed=0):
    from repro_torch.models import transformer as T
    return T.init(_cfg(arch, vocab), torch.Generator().manual_seed(seed),
                  layout=layout)


def _tokens(cfg, rows, cols, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (rows, cols)).astype(np.int32)


def _train_batch(cfg, b):
    toks = torch.from_numpy(_tokens(cfg, b, S))
    return {"tokens": toks, "labels": toks}


def _zero_opt(params):
    from repro_torch.common.pytree import tree_map
    from repro_torch.optim.optimizers import AdamState
    return AdamState(*(tree_map(torch.zeros_like, params)
                       for _ in range(2)))


def _train_run(cfg, b, mesh, kw, params=None):
    """One step of ``make_train_step`` from zero moments: (the first
    moment gathered whole, the loss)."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    bundle = steps.make_train_step(cfg, InputShape("t", S, b, "train"), mesh,
                                   param_dtype=torch.float32, **kw)
    tp = bundle.layout
    if params is None:
        params = T.init(cfg, torch.Generator().manual_seed(0), layout=tp)
    _, opt, _, m = bundle.fn(params, _zero_opt(params),
                             torch.zeros((), dtype=torch.int32),
                             steps.batch_block(_train_batch(cfg, b), tp))
    mu = opt.mu if tp is None else shd.gather_tree(opt.mu, tp.pspecs, mesh)
    return {k: v.double().numpy() for k, v in tree_flatten(mu).items()}, \
        float(m["loss"])


# ---------------------------------------------------------------------------
# what the ranks run (port code only)
# ---------------------------------------------------------------------------

def train_case(cid, arch, vocab, shape, b, kw) -> dict:
    """The step's gathered first moment and loss on this world's mesh;
    for the cases of ACTS_PAIRED, whether the step without
    ``constrain_acts`` is the same bit for bit."""
    mesh = tmesh.make_mesh(shape, NAMES)
    cfg = _cfg(arch, vocab)
    mu, loss = _train_run(cfg, b, mesh, kw)
    out = {"loss": loss}
    if cid in ACTS_PAIRED:
        plain = {k: v for k, v in kw.items() if k != "constrain_acts"}
        mu2, loss2 = _train_run(cfg, b, mesh, plain)
        out["acts_equal"] = loss2 == loss and all(
            np.array_equal(mu[k], mu2[k]) for k in mu)
    if tmesh.world_rank() == 0:
        out["mu"] = mu
    return out


def prefill_case(mesh, arch, vocab, layout, b, seq, acts) -> tuple:
    """A sharded prefill's next-token logits gathered whole and its
    caches at this rank's blocks, of the shapes its bundle promises."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    cfg = _cfg(arch, vocab)
    pre = steps.make_prefill_step(cfg, InputShape("p", seq, b, "prefill"),
                                  mesh, layout=layout, constrain_acts=acts,
                                  param_dtype=torch.float32)
    toks = torch.from_numpy(_tokens(cfg, b, PROMPT + N_TOK, 2))
    logits, caches = pre.fn(_init(arch, vocab, pre.layout), steps.batch_block(
        {"tokens": toks[:, :PROMPT]}, pre.layout))
    for c, m in zip(tree_leaves((logits, caches)), tree_leaves(pre.outs),
                    strict=True):
        assert tuple(c.shape) == tuple(m.shape)
    split = "model" if logits.shape[-1] != cfg.vocab_size else None
    whole = shd.gather_tensor(logits, shd.P(pre.layout.batch_entry, None,
                                            split), mesh)
    return whole, caches, pre


def serve_case(arch, vocab, layout) -> dict:
    """A ``layout`` prefill of the prompt (with and without
    ``constrain_acts``: equal bit for bit), its caches into the ``tp``
    serve layout, then N_TOK decode steps: each token's gap to the
    unsharded prefill + decode_step, as a share of its largest logit."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    mesh = tmesh.make_mesh((2, 2), NAMES)
    cfg = _cfg(arch, vocab)
    lg, caches, pre = prefill_case(mesh, arch, vocab, layout, B, MAX_SEQ,
                                   True)
    lg2, caches2, _ = prefill_case(mesh, arch, vocab, layout, B, MAX_SEQ,
                                   False)
    out = {"acts_equal": all(torch.equal(x, y) for x, y in zip(
        tree_leaves((lg, caches)), tree_leaves((lg2, caches2))))}
    serve = steps.make_serve_step(
        cfg, InputShape("d", MAX_SEQ, B, "decode"), mesh,
        param_dtype=torch.float32, cache_dtype=torch.float32)
    caches = T.serve_caches(caches, cfg, pre.layout, serve.layout)
    for c, m in zip(tree_leaves(caches), tree_leaves(serve.outs[1]),
                    strict=True):
        assert tuple(c.shape) == tuple(m.shape)
    toks = torch.from_numpy(_tokens(cfg, B, PROMPT + N_TOK, 2))
    whole = _init(arch, vocab)
    _, ref = T.prefill(whole, cfg, {"tokens": toks[:, :PROMPT]}, MAX_SEQ)
    params, tp, gaps = _init(arch, vocab, serve.layout), serve.layout, []
    for i in range(N_TOK):
        tok = {"tokens": toks[:, PROMPT + i:PROMPT + i + 1]}
        logits, caches = serve.fn(params, steps.batch_block(tok, tp), caches,
                                  PROMPT + i)
        got = shd.gather_tensor(logits, shd.P(tp.batch_entry, None, "model"),
                                mesh)
        want, ref = T.decode_step(whole, cfg, tok, ref, PROMPT + i)
        gaps.append(float((got - want).abs().max() / want.abs().max()))
    out["gaps"] = gaps
    return out


def prefill_variant() -> dict:
    """JAX's granite-moe prefill row on 1 x 2 (one data rank: the
    expert-parallel blocks drop the one device's slots), with and without
    ``constrain_acts``."""
    from repro_torch.common.pytree import tree_leaves
    mesh = tmesh.make_mesh((1, 2), NAMES)
    runs = [prefill_case(mesh, PREFILL_ARCH, None, "tp", B, S + PROMPT, a)
            for a in (True, False)]
    return {"prefill": runs[0][0].numpy(), "prefill_acts_equal": all(
        torch.equal(x, y) for x, y in zip(tree_leaves(runs[0][:2]),
                                          tree_leaves(runs[1][:2])))}


def distill_variant() -> dict:
    """JAX's distill-step row on 2 x 2, with and without
    ``constrain_acts``."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten, tree_leaves
    mesh = tmesh.make_mesh((2, 2), NAMES)
    out = {}
    distill = [distill_run(mesh, a) for a in (True, False)]
    out["distill_acts_equal"] = distill[0][1] == distill[1][1] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(distill[0][0]),
                                          tree_leaves(distill[1][0])))
    tp = distill[0][2]
    mu = shd.gather_tree(distill[0][0], tp.pspecs, mesh)
    out["distill_mu"] = {k: v.double().numpy()
                         for k, v in tree_flatten(mu).items()}
    out["distill_loss"] = distill[0][1]
    return out


def distill_run(mesh, acts: bool, params=None):
    """One distill step from zero moments: (its first moment, the loss,
    the layout)."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import steps
    cfg = _cfg(DISTILL_ARCH, None)
    bundle = steps.make_distill_step(cfg, mesh, constrain_acts=acts,
                                     param_dtype=torch.float32, **DISTILL_KW)
    tp = bundle.layout
    student = (_init(DISTILL_ARCH, None, tp) if params is None
               else tree_map(torch.clone, params))
    teachers = tree_map(lambda *xs: torch.stack(xs), *[
        _init(DISTILL_ARCH, None, tp, seed=10 + i)
        for i in range(DISTILL_KW["n_teachers"])])
    batch = {"tokens": torch.from_numpy(_tokens(cfg, B, S, 3))}
    if tp is not None:
        from repro_torch.launch.steps import batch_block
        batch = batch_block(batch, tp)
    _, opt, _, loss = bundle.fn(student, teachers, _zero_opt(student),
                                torch.zeros((), dtype=torch.int32), batch)
    return opt.mu, float(loss), tp


def gather_case() -> dict:
    """``all_gather`` over "model" of 1 x 2 along each dimension, per
    dtype: equal bit for bit to the ranks' tensors concatenated (16-bit
    floats travel as their bytes under gloo)."""
    from repro_torch.common import sharding as shd
    mesh = tmesh.make_mesh((1, 2), NAMES)
    out = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        parts = [torch.randn(3, 5, generator=torch.Generator().manual_seed(r))
                 .to(dt) for r in range(2)]
        me = parts[shd.axis_index(mesh, "model")]
        out[str(dt)] = all(
            torch.equal(got, torch.cat(parts, dim=d)) and got.dtype == dt
            for d in (0, 1, -1)
            for got in [shd.all_gather(me, mesh, ("model",), d)])
    return out


def rank_suite():
    """Every case whose mesh this world's size fits, in order."""
    n = tmesh.world_size()
    out = {}
    if n == 2:
        out["gather"] = gather_case()
    for cid, arch, vocab, shape, b, kw, _ in TRAIN_CASES:
        if int(np.prod(shape)) == n:
            out[cid] = train_case(cid, arch, vocab, shape, b, kw)
    if n == 4:
        for cid, arch, vocab, layout in SERVE_CASES:
            out[cid] = serve_case(arch, vocab, layout)
        out["distill"] = distill_variant()
    else:
        out["prefill"] = prefill_variant()
    return out


# ---------------------------------------------------------------------------
# the parent: the references
# ---------------------------------------------------------------------------

def _one_device(arch, vocab, b, kw):
    """The port's one-device step with ``kw`` (no mesh: the layout
    changes nothing), at the parameters and at their 1-ulp nudge."""
    cfg = _cfg(arch, vocab)
    mu, loss = _train_run(cfg, b, None, kw, _init(arch, vocab))
    mu_n, _ = _train_run(cfg, b, None, kw, _nudged_t(_init(arch, vocab)))
    return {"t": mu, "t_n": mu_n, "loss_t": loss}


def _jax_train(arch, vocab, b, kw):
    """JAX's ``make_train_step`` with ``kw`` ``.jit()``-ed on a 1 x 1 mesh
    in float32 from zero moments, at the parameters and at their 1-ulp
    nudge: its first moment (the port's leaf paths) and loss."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.configs.shapes import InputShape as JShape
    from repro.launch import steps as jsteps
    from repro.optim import optimizers as jopt
    from repro_torch import convert
    cj = jreduced(jconfigs.get(arch),
                  **({} if vocab is None else {"vocab_size": vocab}))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             NAMES)
    jb = jsteps.make_train_step(cj, JShape("t", S, b, "train"), mesh,
                                param_dtype=jnp.float32, **kw)
    toks = _tokens(_cfg(arch, vocab), b, S)
    out = {}
    with mesh:
        fn = jb.jit()
        for tag, pt in (("j", _init(arch, vocab)),
                        ("j_n", _nudged_t(_init(arch, vocab)))):
            p = _to_jax(pt, cj)
            _, opt, _, m = fn(p, jopt.adam(3e-4).init(p), jnp.int32(0),
                              {"tokens": toks, "labels": toks})
            out[tag] = _flat_np(convert.to_torch(
                jax.tree.map(np.asarray, opt.mu)))
            if tag == "j":
                out["loss"] = float(m["loss"])
    return out


def _one_device_variants():
    """The port's one-device granite-moe prefill (with and without
    ``constrain_acts``) and distill step (and its nudge)."""
    from repro_torch.common.pytree import tree_flatten, tree_leaves
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    cfg = _cfg(PREFILL_ARCH, None)
    toks = torch.from_numpy(_tokens(cfg, B, PROMPT + N_TOK, 2))
    out = {}
    for acts in (True, False):
        pre = steps.make_prefill_step(
            cfg, InputShape("p", S + PROMPT, B, "prefill"),
            constrain_acts=acts, param_dtype=torch.float32)
        out[acts] = pre.fn(_init(PREFILL_ARCH, None),
                           {"tokens": toks[:, :PROMPT]})
    flat = lambda mu: {k: v.double().numpy()
                       for k, v in tree_flatten(mu).items()}
    pt = _init(DISTILL_ARCH, None)
    d = {acts: distill_run(None, acts, pt) for acts in (True, False)}
    mu_n, _, _ = distill_run(None, True, _nudged_t(_init(DISTILL_ARCH, None)))
    return {"prefill": out[True][0].numpy(),
            "prefill_acts_equal": all(torch.equal(x, y) for x, y in zip(
                tree_leaves(out[True]), tree_leaves(out[False]))),
            "distill_acts_equal": d[True][1] == d[False][1] and all(
                torch.equal(x, y) for x, y in zip(
                    tree_leaves(d[True][0]), tree_leaves(d[False][0]))),
            "t": flat(d[True][0]), "t_n": flat(mu_n),
            "loss_t": d[True][1]}


def _ref_key(case):
    _, arch, vocab, _, b, kw, _ = case
    return (arch, vocab, b, tuple(sorted(kw.items())))


@pytest.fixture(scope="module")
def world():
    threads = max(1, (os.cpu_count() or 4) // 8)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        four = pool.submit(tmesh.launch_ranks, rank_suite, 4, "cpu",
                           timeout_s=RANK_TIMEOUT_S, threads=threads)
        two = pool.submit(tmesh.launch_ranks, rank_suite, 2, "cpu",
                          timeout_s=RANK_TIMEOUT_S, threads=threads)
        keys = {_ref_key(c): c for c in TRAIN_CASES}
        ports = {k: pool.submit(_one_device, c[1], c[2], c[4], c[5])
                 for k, c in keys.items()}
        jaxs = {k: pool.submit(_jax_train, c[1], c[2], c[4], c[5])
                for k, c in keys.items() if c[6]}
        variants = pool.submit(_one_device_variants)
        ranks = {k: [r[k] for r in runs.result()] for runs in (four, two)
                 for k in runs.result()[0]}
        return {"ranks": ranks,
                "port": {k: f.result() for k, f in ports.items()},
                "jax": {k: f.result() for k, f in jaxs.items()},
                "variants": variants.result()}


@pytest.mark.parametrize("cid", [c[0] for c in TRAIN_CASES])
def test_train_step_layouts_match_one_device_and_jax(world, cid):
    case = next(c for c in TRAIN_CASES if c[0] == cid)
    ref = world["port"][_ref_key(case)]
    runs = world["ranks"][cid]
    for r in runs:
        assert r["loss"] == pytest.approx(ref["loss_t"], rel=LOSS_REL)
        assert r["acts_equal"] if cid in ACTS_PAIRED else True, cid
    assert all(r["loss"] == runs[0]["loss"] for r in runs)
    got = runs[0]["mu"]
    assert sorted(got) == sorted(ref["t"])
    own = _rel(ref["t_n"], ref["t"])
    port_gap = _rel(got, ref["t"])
    print(f"{cid}: gap to the one-device port {port_gap:.3g} (its 1-ulp "
          f"spread {own:.3g})")
    assert port_gap <= SPREAD_FACTOR * own, (port_gap, own)
    if case[6]:
        want = world["jax"][_ref_key(case)]
        assert runs[0]["loss"] == pytest.approx(want["loss"], rel=LOSS_REL)
        spread = max(own, _rel(want["j_n"], want["j"]))
        gap, one_device_gap = _rel(got, want["j"]), _rel(ref["t"], want["j"])
        print(f"{cid}: gap to JAX {gap:.3g} (the one-device port's "
              f"{one_device_gap:.3g}; larger spread {spread:.3g})")
        assert gap <= SPREAD_FACTOR * spread + one_device_gap, (
            gap, spread, one_device_gap)


def test_microbatches_under_dp_heavy_match_the_single_batch(world):
    one = world["ranks"]["minicpm-dph-2x2"]
    two = world["ranks"]["minicpm-dph-mb2-2x2"]
    for a, b in zip(one, two):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-6)
    assert _rel(two[0]["mu"], one[0]["mu"]) <= MICROBATCH_REL


def test_a_batch_the_axes_do_not_divide_counts_each_row_once(world):
    """Global batch 2 on 2 x 2 under dp_heavy_z3: rows over "data" only,
    each model rank a copy; counted twice, every gradient would double."""
    from repro_torch.launch import steps
    bundle = steps.make_train_step(
        _cfg("zamba2-1.2b", 512), _shape(2), StubMesh((2, 2), NAMES, (0, 1)),
        layout="dp_heavy_z3")
    assert bundle.layout.batch_axes == ("data",)
    assert bundle.layout.dp_axes == NAMES
    assert tuple(bundle.args[3]["tokens"].shape) == (1, S)
    case = next(c for c in TRAIN_CASES if c[0] == "zamba2-z3-2x2-b2")
    ref = world["port"][_ref_key(case)]
    got = world["ranks"][case[0]][0]["mu"]
    assert _rel(got, ref["t"]) <= SPREAD_FACTOR * _rel(ref["t_n"], ref["t"])


def _shape(b):
    from repro_torch.configs.shapes import InputShape
    return InputShape("t", S, b, "train")


@pytest.mark.parametrize("cid", [c[0] for c in SERVE_CASES])
def test_dp_heavy_prefill_serves_on_the_tp_mesh(world, cid):
    for r in world["ranks"][cid]:
        assert r["acts_equal"], cid
        assert len(r["gaps"]) == N_TOK
        assert max(r["gaps"]) <= SERVE_REL, r["gaps"]


@pytest.mark.parametrize("step", ["prefill", "distill"])
def test_variant_rows_on_a_mesh_and_one_device(world, step):
    """granite-moe's prefill (its expert-parallel blocks, 1 x 2) and
    gemma3-4b's distill step (2 x 2), each with constrain_acts: equal bit
    for bit to the run without it, on the mesh and on one device, and the
    mesh within the bounds above of the one-device run."""
    one = world["variants"]
    for r in world["ranks"][step]:
        assert r[f"{step}_acts_equal"]
        if step == "prefill":
            np.testing.assert_allclose(
                r["prefill"], one["prefill"], rtol=0,
                atol=SERVE_REL * np.abs(one["prefill"]).max())
        else:
            assert r["distill_loss"] == pytest.approx(one["loss_t"],
                                                      rel=LOSS_REL)
    assert one[f"{step}_acts_equal"]
    if step == "distill":
        got = world["ranks"]["distill"][0]["distill_mu"]
        assert _rel(got, one["t"]) <= SPREAD_FACTOR * _rel(one["t_n"],
                                                           one["t"])


@pytest.mark.parametrize("dtype", ["torch.bfloat16", "torch.float16",
                                   "torch.float32"])
def test_all_gather_moves_each_dtypes_bits(world, dtype):
    assert all(r[dtype] for r in world["ranks"]["gather"])


@pytest.mark.parametrize("layout", ["dp_heavy", "dp_heavy_z3"])
def test_an_moe_model_under_dp_heavy_raises_naming_its_item(layout):
    """An MoE model under ``dp_heavy*`` on a mesh once raised naming item
    11.8.4(c); it builds now (``tests/test_torch_moe_mesh.py`` runs it):
    the batch over both axes, the experts split over ``"model"`` (JAX's
    ``"experts"`` rule in every layout) and kept split where the layer
    runs, every other leaf gathered whole; without a mesh the layout
    changes nothing, as in JAX on one device; and on one device the MoE
    block reads no ``dp_axes`` (JAX reads them only with a mesh)."""
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.models import moe
    cfg = _cfg("granite-moe-1b-a400m", None)
    mesh = StubMesh((2, 2), NAMES, (0, 0))
    for build, kind in ((steps.make_train_step, "train"),
                        (steps.make_prefill_step, "prefill")):
        bundle = build(cfg, InputShape("x", S, B, kind), mesh, layout=layout)
        tp = bundle.layout
        assert tp.batch_axes == NAMES and tp.dp_axes == NAMES
        flat = tree_flatten(bundle.args[0])
        gates = [v for k, v in flat.items() if k.endswith("wi_gate")]
        assert gates and all(g.shape[-3] == cfg.n_experts // 2
                             for g in gates)
        spec = tp.pspecs["blocks"][0]["mlp"]["wi_gate"]   # [L, E, d, ff]
        assert tuple(spec) == (None, "model", "data", None), spec
    steps.make_train_step(cfg, _shape(B), layout=layout)
    p = _init("granite-moe-1b-a400m", None)["blocks"][0]["mlp"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((1, 2, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    got = moe.moe_block(p, cfg, x, None, NAMES)
    want = moe.moe_block(p, cfg, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_act_sharding_is_the_layouts_batch_block_or_raises():
    from repro_torch.common import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = _cfg("qwen3-8b", None)
    p = _init("qwen3-8b", None)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 8))}
    plain = T.forward(p, cfg, batch)
    same = T.forward(p, cfg, batch, act_sharding=shd.P(None, None, None))
    named = T.forward(p, cfg, batch, act_sharding=shd.NamedSharding(
        None, shd.P(None, None, None)))
    assert torch.equal(plain, same) and torch.equal(plain, named)
    for bad in (shd.P("data", None, None), shd.P(None, "model", None),
                shd.P(None, None)):
        with pytest.raises(ValueError, match="act_sharding"):
            T.forward(p, cfg, batch, act_sharding=bad)
    # on a mesh: the layout's batch axes, fitted as JAX fits them
    for layout, b, want in (("tp", 4, "data"), ("dp_heavy", 4, NAMES),
                            ("dp_heavy_z3", 2, "data"), ("tp", 1, None)):
        tp, acts = steps._tp(cfg, StubMesh((2, 2), NAMES, (0, 0)), True, b,
                             layout, True)
        assert tuple(acts) == (want, None, None)
        assert T._check_mesh(None, tp, acts) == tuple(acts)
        with pytest.raises(ValueError, match="act_sharding"):
            T._check_mesh(None, tp, shd.P(("data", "model") if want == "data"
                                          else "data", None, None))


@pytest.mark.parametrize("layout", ["tp", "dp_heavy", "dp_heavy_z3"])
def test_blocks_drawn_leaf_by_leaf_are_the_whole_draws_cut(layout):
    """``T.init(layout=)`` cuts each leaf as it is drawn: the same
    blocks as drawing the whole tree and cutting it; under ``dp_heavy*``
    the Mamba2 heads, inner channels and conv stay whole (no
    ``Segmented``); the embedding's vocabulary splits over ``"model"``
    in every layout, d_model over ``"data"`` (z3: every axis)."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.launch import steps
    cfg = _cfg("zamba2-1.2b", 512)
    mesh = StubMesh((2, 2), NAMES, (1, 1))
    tp, _ = steps._tp(cfg, mesh, True, B, layout)
    got = tree_flatten(_init("zamba2-1.2b", 512, tp))
    want = tree_flatten(shd.shard_tree(_init("zamba2-1.2b", 512), tp.pspecs,
                                       mesh))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    specs = []
    shd.map_specs(specs.append, tp.pspecs)
    segmented = any(isinstance(e, shd.Segmented) for s in specs for e in s)
    assert segmented == (layout == "tp")
    assert tuple(tp.pspecs["embed"]) == ("model", None)
    assert tuple(tp.pspecs["final_norm"]) == (
        (NAMES,) if layout == "dp_heavy_z3" else ("data",))


@pytest.mark.parametrize("layout", ["tp", "dp_heavy", "dp_heavy_z3"])
def test_dryrun_cli_counts_each_layouts_rank_bytes(layout, tmp_path,
                                                   capsys):
    """``launch/dryrun.py --layout L --mesh 2x2`` in-process: one record
    of rank 0's argument bytes; under dp_heavy_z3 a quarter of the
    unsharded bytes, but for the leaves that are not cut in four (those
    whole on every rank, and the embedding and head, split over
    ``"model"`` only)."""
    import json
    from repro_torch import configs
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.launch import dryrun, steps
    arch, shape = "zamba2-1.2b", "train_4k"
    args = ["--arch", arch, "--shape", shape, "--out-dir", str(tmp_path),
            "--constrain-acts", "--naive-xent"]
    assert dryrun.main(args + ["--variant", "one"]) == 0
    assert dryrun.main(args + ["--layout", layout, "--mesh", "2x2",
                               "--variant", layout]) == 0
    recs = {v: json.loads((tmp_path / f"{arch}__{shape}__h100__{v}.json")
                          .read_text()) for v in ("one", layout)}
    assert recs[layout]["mesh"] == [2, 2] and recs["one"]["mesh"] is None
    assert recs[layout]["step_kw"].get("layout", "tp") == layout
    one = recs["one"]["memory"]["argument_bytes"]
    rank = recs[layout]["memory"]["argument_bytes"]
    assert rank < one
    cfg, sh = configs.get(arch), configs.get_shape(shape)
    whole = tree_leaves(steps.make_train_step(cfg, sh).args)
    mine = tree_leaves(steps.make_train_step(
        cfg, sh, dryrun.RankView((2, 2)), layout=layout).args)
    nbytes = lambda m: m.numel() * m.element_size()
    assert rank == sum(nbytes(m) for m in mine)
    if layout == "dp_heavy_z3":
        uncut = sum(nbytes(w) for w, m in zip(whole, mine, strict=True)
                    if 4 * m.numel() != w.numel())
        assert uncut < one / 10
        assert one / 4 <= rank <= one / 4 + 3 * uncut / 4, (one, rank, uncut)
    assert "OK" in capsys.readouterr().out
