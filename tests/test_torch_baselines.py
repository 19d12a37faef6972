"""The paper's FL baselines in the port against the JAX package:
``momentum_sgd``, the ``fedprox`` and ``fedavgm`` server rules, local
Adam in the batched client update, and whole ``fedavgm`` / ``fedprox`` /
local-Adam FedDF runs through both packages' ``Experiment`` on the CPU.

Tolerances: the optimizer and the server rules are a few float32
operations a step, 1e-6 absolute over 20 steps or 3 rounds of state.
Local Adam is held against JAX's SEQUENTIAL ``make_local_update``, client
by client (JAX's batched Adam parts from its own sequential update under
BN; ROADMAP.md queue 3): float32 matmul sums in another order, divided by
sqrt(v) on every step, 1e-5 absolute over up to 24 steps on O(1) weights
without BN.  The whole runs are held at ``test_torch_slice.py``'s bounds:
globals within 1e-4, test accuracy within one test example, equal
distill steps and bank decisions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import client as jclient
from repro.core import nets as jnets
from repro.core import strategies as jstrat
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import gaussian_mixture
from repro.optim import optimizers as jopt
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten
from repro_torch.core import client as tclient
from repro_torch.core import engine as tengine
from repro_torch.core import nets as tnets
from repro_torch.core import strategies as tstrat
from repro_torch.optim import optimizers as topt

from test_torch_slice import jax_index_stream, tiny_spec


def assert_tree_close(tree, jtree, atol):
    flat = tree_flatten(tree)
    for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        np.testing.assert_allclose(flat[key].cpu().numpy(), np.asarray(v),
                                   rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_sgd_matches_jax(nesterov):
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    j_opt = jopt.momentum_sgd(0.05, beta=0.9, nesterov=nesterov)
    t_opt = topt.momentum_sgd(0.05, beta=0.9, nesterov=nesterov)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for step in range(20):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jd, js = j_opt.update([jnp.asarray(x) for x in g], js, jp,
                              jnp.int32(step))
        jp = jopt.apply_updates(jp, jd)
        td, ts = t_opt.update([torch.from_numpy(x) for x in g], ts, tp,
                              step)
        tp = topt.apply_updates(tp, td)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


class _Cfg:
    server_momentum = 0.3
    prox_mu = 0.01


def _stack(rng, k):
    return {"dense_0": {"w": rng.normal(size=(k, 4, 3)).astype(np.float32),
                        "b": rng.normal(size=(k, 3)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["fedprox", "fedavgm"])
def test_server_rules_match_jax_over_three_rounds(name):
    """Two groups, three rounds of server state; group 1 draws no client
    in round 2 and keeps its global (and its momentum buffer)."""
    rng = np.random.default_rng(1)
    jrule, trule = jstrat.get_strategy(name), tstrat.get_strategy(name)
    assert trule.local_prox_mu(_Cfg) == jrule.local_prox_mu(_Cfg)
    nets = (jnets.mlp(4, 3, ()), tnets.mlp(4, 3, ()))
    jglob = [jax.tree.map(lambda a: a[0], _stack(rng, 1)) for _ in range(2)]
    tglob = [convert.to_torch(g) for g in jglob]
    jstate, tstate = jrule.init_state(jglob), trule.init_state(tglob)
    jctx = jstrat.RoundContext(cfg=_Cfg, round=1, heterogeneous=True)
    tctx = tstrat.RoundContext(cfg=_Cfg, round=1, heterogeneous=True)
    for t in range(3):
        jgroups, tgroups = [], []
        for gi in range(2):
            if t == 1 and gi == 1:
                stack, w = None, np.zeros(0)
            else:
                k = 3 + gi
                stack = _stack(rng, k)
                w = rng.uniform(1, 5, k)
            jgroups.append(jstrat.GroupRound(
                nets[0], jglob[gi],
                None if stack is None else jax.tree.map(jnp.asarray, stack),
                w))
            tgroups.append(tstrat.GroupRound(
                nets[1], tglob[gi],
                None if stack is None else convert.to_torch(stack), w))
        jglob, jstate, _ = jrule.aggregate(jgroups, jstate, jctx)
        tglob, tstate, _ = trule.aggregate(tgroups, tstate, tctx)
        for tg, jg in zip(tglob, jglob):
            assert_tree_close(tg, jg, 1e-6)


def _clients():
    ds = gaussian_mixture(500, seed=2)
    parts = dirichlet_partition(ds.y, 5, 0.3, seed=2)[:4]
    seeds = [21, 22, 23, 24]
    return ds, parts, seeds


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_batched_local_adam_matches_jax_sequential(prox_mu):
    ds, parts, seeds = _clients()
    xb, yb, mask = tclient.build_batched_batches(ds.x, ds.y, parts, 16, 2,
                                                 seeds)
    steps = mask.sum(axis=1)
    assert len(set(steps.tolist())) > 1  # ragged: padded steps are hit
    jn, tn = jnets.mlp(2, 3, (16, 16)), tnets.mlp(2, 3, (16, 16))
    jp = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(3)))
    tp = convert.to_torch(jp)
    update = tclient.make_batched_local_update(tn, topt.adam(1e-2),
                                               prox_mu=prox_mu)
    stack = update(tp, torch.from_numpy(xb), torch.from_numpy(yb), tp,
                   torch.from_numpy(mask))
    seq = jclient.make_local_update(jn, jopt.adam(1e-2), prox_mu=prox_mu)
    for k, (idx, s) in enumerate(zip(parts, seeds)):
        bx, by = jclient.build_batches(ds.x[idx], ds.y[idx], 16, 2, seed=s)
        want = seq(jp, jnp.asarray(bx), jnp.asarray(by), jp)
        got = {p: v[k] for p, v in tree_flatten(stack).items()}
        assert_tree_close(got, want, 1e-5)


@pytest.mark.parametrize("opt,norm", [("sgd", "none"), ("sgd", "bn"),
                                      ("adam", "none"),
                                      ("momentum", "none")])
def test_batched_local_update_matches_own_sequential(opt, norm):
    """The batched update against the port's own one-client loop: a
    padded step leaves the params and the optimizer state (Adam's m and
    v, the momentum buffer) as they were.  Same arithmetic per client,
    batched matmuls in another order: 1e-6 absolute (1e-5 under BN,
    whose bias gradients are rounding noise)."""
    ds, parts, seeds = _clients()
    xb, yb, mask = tclient.build_batched_batches(ds.x, ds.y, parts, 16, 2,
                                                 seeds)
    make = {"sgd": lambda: topt.sgd(0.05), "adam": lambda: topt.adam(1e-2),
            "momentum": lambda: topt.momentum_sgd(0.05)}[opt]
    tn = tnets.mlp(2, 3, (16, 16), norm=norm)
    tp = tn.init(torch.Generator().manual_seed(3))
    stack = tclient.make_batched_local_update(tn, make())(
        tp, torch.from_numpy(xb), torch.from_numpy(yb), tp,
        torch.from_numpy(mask))
    seq = tclient.make_local_update(tn, make())
    flat = tree_flatten(stack)
    for k, (idx, s) in enumerate(zip(parts, seeds)):
        bx, by = tclient.build_batches(ds.x[idx], ds.y[idx], 16, 2, seed=s)
        want = tree_flatten(seq(tp, torch.from_numpy(bx),
                                torch.from_numpy(by), tp))
        for p, v in want.items():
            np.testing.assert_allclose(flat[p][k].numpy(), v.numpy(),
                                       rtol=0,
                                       atol=1e-5 if norm == "bn" else 1e-6,
                                       err_msg=p)


def test_engine_builds_its_local_optimizer_from_the_config():
    cfg = tengine.FLConfig(local_optimizer="adam", local_adam_lr=0.02)
    assert isinstance(tengine._make_opt(cfg).init([torch.zeros(2)]),
                      topt.AdamState)
    assert tengine._make_opt(tengine.FLConfig()).init([torch.zeros(2)]) \
        == ()
    for f in ("prox_mu", "server_momentum", "local_adam_lr"):
        assert getattr(tengine.FLConfig(), f) == getattr(
            __import__("repro.core.engine", fromlist=["FLConfig"]
                       ).FLConfig(), f)


def baseline_spec(pkg, name):
    """``test_torch_slice.tiny_spec`` with a baseline's axis changed."""
    d = tiny_spec(pkg).to_dict()
    if name in ("fedavgm", "fedprox"):
        d["strategy"]["name"] = name
        d["strategy"]["prox_mu"] = 0.1
        d["strategy"]["server_momentum"] = 0.5
        d["source"] = None
    else:                                  # FedDF with local Adam
        d["local_optimizer"] = "adam"
        d["local_adam_lr"] = 5e-3
    return pkg.ExperimentSpec.from_dict(d)


@pytest.mark.parametrize("name", ["fedavgm", "fedprox", "local_adam"])
def test_baseline_spec_matches_jax_round_by_round(name):
    jspec = baseline_spec(japi, name)
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(jspec.seed)))
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=[convert.to_torch(init)],
        index_stream=jax_index_stream(300) if tspec.source else None)
    n_test = int(600 * 0.2)
    assert len(tres.result.logs) == len(jres.result.logs) == 2
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        assert tl.bank == jl.bank
        assert tl.distill_steps == jl.distill_steps
        assert tl.n_participants == jl.n_participants
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / n_test + 1e-12
    assert_tree_close(tres.global_params[0], jres.global_params[0], 1e-4)


@pytest.mark.parametrize("stream", ["index_stream", "draw_stream"])
def test_run_refuses_a_stream_without_a_source(stream):
    """A distillation stream given to a spec with no source is refused,
    not ignored."""
    spec = baseline_spec(tapi, "fedavgm")
    with pytest.raises(ValueError, match="no distillation source"):
        tapi.Experiment(spec, device="cpu").run(
            **{stream: jax_index_stream(300)})


def test_feddf_init_from_previous_runs_and_differs_from_average():
    """Table 5's ablation: the student starts from last round's global."""
    d = tiny_spec(tapi).to_dict()
    d["rounds"] = 1
    runs = {}
    for init_from in ("average", "previous"):
        d["strategy"]["feddf_init_from"] = init_from
        spec = tapi.ExperimentSpec.from_dict(d)
        runs[init_from] = tapi.Experiment(spec, device="cpu").run()
    a, p = (tree_flatten(runs[k].global_params[0])
            for k in ("average", "previous"))
    assert any(not torch.equal(a[k], p[k]) for k in a)
    assert runs["previous"].result.logs[0].distill_steps > 0


@pytest.mark.parametrize("target", [None, 0.5])
def test_run_federated_matches_jax(target):
    """The flat homogeneous entry point, ``fedavgm``: the same logs,
    globals and ``rounds_to_target`` (the run stops at the target)."""
    from repro.core import server as jserver
    from repro.core.engine import FLConfig as JCfg
    from repro.data.synthetic import train_val_test_split
    from repro_torch.core import server as tserver
    from repro_torch.data.synthetic import Dataset
    ds = gaussian_mixture(600, seed=4)
    train, val, test = train_val_test_split(ds, seed=4)
    parts = dirichlet_partition(train.y, 6, 0.5, seed=4)
    kw = dict(rounds=3, client_fraction=0.5, local_epochs=2, local_lr=0.05,
              strategy="fedavgm", server_momentum=0.5, seed=2,
              target_accuracy=target)
    jn, tn = jnets.mlp(2, 3, (16, 16)), tnets.mlp(2, 3, (16, 16))
    jlogs, tlogs = [], []
    jres = jserver.run_federated(jn, train, parts, val, test, JCfg(**kw),
                                 log_fn=jlogs.append)
    init = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(2)))
    tds = [Dataset(d.x, d.y, d.n_classes) for d in (train, val, test)]
    tres = tserver.run_federated(
        tn, tds[0], parts, tds[1], tds[2], tengine.FLConfig(**kw),
        log_fn=tlogs.append, device="cpu",
        init_globals=convert.to_torch(init))
    assert tres.rounds_to_target == jres.rounds_to_target
    if target is not None:
        assert tres.rounds_to_target is not None
    assert len(tlogs) == len(jlogs) == len(tres.logs)
    for jl, tl in zip(jres.logs, tres.logs, strict=True):
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / len(test.y) + 1e-12
    assert_tree_close(tres.global_params, jres.global_params, 1e-4)


def test_evaluate_stacked_matches_jax():
    ds = gaussian_mixture(1100, seed=4)
    jn, tn = jnets.mlp(2, 3, (8,)), tnets.mlp(2, 3, (8,))
    trees = [jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(k)))
             for k in range(3)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    got = tclient.evaluate_stacked(tn, convert.to_torch(
        jax.tree.map(np.asarray, jstack)), torch.from_numpy(ds.x),
        torch.from_numpy(ds.y))
    want = jclient.evaluate_stacked(jn, jstack, ds.x, ds.y)
    np.testing.assert_array_equal(got, want)
