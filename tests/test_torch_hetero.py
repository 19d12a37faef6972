"""Heterogeneous cohorts (the paper's Algorithm 3) in the port against the
JAX package on the CPU: the heterogeneous fuse with the shared logit bank
(JAX through its default fused path, as its own tests run it; the port
through K1's plain version) and on the fly (K2's plain version), with and
without teacher importances and with an empty group; the bank's one build
and where it is charged; the logits-averaging ensemble; whole
3-prototype runs through both packages' ``Experiment`` and through
``run_federated_heterogeneous``; the prototype ladder.

The JAX init and distill index streams are injected into the port.
Tolerances: a fuse is a few hundred float32 Adam steps whose sums run in
another order, 2e-5 absolute on O(1) weights (``test_torch_feddf.py``'s);
whole runs are held at ``test_torch_slice.py``'s bounds: globals within
1e-4, test and ensemble accuracy within one test example, equal distill
steps, bank decisions and participants per group."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import registries as jreg
from repro.core import engine as jengine
from repro.core import ensemble as jens
from repro.core import feddf as jfeddf
from repro.core import nets as jnets
from repro.core import server as jserver
from repro.data.distill_sources import UnlabeledDataset as JSource
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import gaussian_mixture, train_val_test_split
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import registries as treg
from repro_torch.common.pytree import tree_flatten, tree_stack
from repro_torch.core import engine as tengine
from repro_torch.core import ensemble as tens
from repro_torch.core import feddf as tfeddf
from repro_torch.core import logit_bank as tbank
from repro_torch.core import nets as tnets
from repro_torch.core import server as tserver
from repro_torch.data.distill_sources import UnlabeledDataset as TSource
from repro_torch.data.synthetic import Dataset

from test_torch_baselines import assert_tree_close
from test_torch_slice import jax_index_stream

HIDDEN = [(16, 16), (24, 24), (16, 16, 16)]
FUSE_ATOL = 2e-5


def _groups(empty: bool):
    """Three prototype groups of 3, 2 and 4 teachers (group 0 empty when
    ``empty``), in both packages, with data weights."""
    jn = [jnets.mlp(2, 3, h) for h in HIDDEN]
    tn = [tnets.mlp(2, 3, h) for h in HIDDEN]
    rng = np.random.default_rng(5)
    out_j, out_t = [], []
    for gi, k in enumerate((3, 2, 4)):
        trees = [jax.tree.map(np.asarray, jn[gi].init(
            jax.random.PRNGKey(10 * gi + i))) for i in range(k)]
        w = rng.uniform(1, 4, k)
        if empty and gi == 0:
            out_j.append((jn[gi], None, np.zeros(0)))
            out_t.append((tn[gi], None, np.zeros(0)))
            continue
        out_j.append((jn[gi], jax.tree.map(lambda *xs: jnp.stack(xs),
                                           *trees), w))
        out_t.append((tn[gi], tree_stack([convert.to_torch(t)
                                          for t in trees]), w))
    return out_j, out_t


@pytest.mark.parametrize("bank,importance,empty", [
    ("auto", False, False), ("off", False, False), ("auto", True, False),
    ("off", True, False), ("auto", False, True), ("off", True, True)])
def test_heterogeneous_fuse_matches_jax(bank, importance, empty):
    gj, gt = _groups(empty)
    pool = np.random.default_rng(7).uniform(-3, 3, (300, 2)).astype(
        np.float32)
    val = gaussian_mixture(200, seed=8)
    fj = jfeddf.FusionConfig(max_steps=60, patience=40, eval_every=20,
                             batch_size=32, temperature=2.0,
                             logit_bank=bank)
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    imps = None
    if importance:
        imps = [None if (empty and gi == 0) else
                np.random.default_rng(gi).uniform(0.3, 1.0, 3 + gi)
                for gi in range(3)]
        imps[1] = None        # a group without importance votes uniformly
        imps[2] = np.random.default_rng(2).uniform(0.3, 1.0, 4)
    jp, jinfo = jfeddf.feddf_fuse_heterogeneous_stacked(
        gj, JSource(pool), fj, jnp.asarray(val.x), val.y, seed=4,
        importances=imps)
    tbank.TEACHER_FORWARDS.reset()
    tp, tinfo = tfeddf.feddf_fuse_heterogeneous_stacked(
        gt, TSource(pool, indices=jax_index_stream(300)), ft,
        torch.from_numpy(val.x), torch.from_numpy(val.y), seed=4,
        importances=imps)
    fused = [gi for gi in range(3) if not (empty and gi == 0)]
    k_total = sum((3, 2, 4)[gi] for gi in fused)
    want_decision = "bank" if bank == "auto" else "on_the_fly"
    for gi in range(3):
        if gi not in fused:
            assert tp[gi] is None and jp[gi] is None
            assert tinfo[gi] == jinfo[gi] == {"skipped": True}
            continue
        assert tinfo[gi]["bank_decision"] == jinfo[gi]["bank_decision"] \
            == want_decision
        for k in ("steps", "best_step", "logit_bank", "bank_nbytes",
                  "teacher_batch_forwards"):
            assert tinfo[gi][k] == jinfo[gi][k], (gi, k)
        assert_tree_close(tp[gi], jp[gi], FUSE_ATOL)
    # the teacher forwards: one bank build over every group's teachers,
    # charged to the first fused group, or K_total a step on the fly
    forwards = [tinfo[gi]["teacher_batch_forwards"] for gi in fused]
    if bank == "auto":
        assert forwards == [k_total] + [0] * (len(fused) - 1)
        assert tbank.TEACHER_FORWARDS.count == k_total  # 300 rows, 1 chunk
    else:
        assert forwards == [tinfo[gi]["steps"] * k_total for gi in fused]
        assert tbank.TEACHER_FORWARDS.count == sum(forwards)


def test_refused_bank_is_not_retried_per_group(monkeypatch):
    """``auto`` that finds the run too short builds nothing, and every
    group then distils on the fly with ``logit_bank`` forced off: the
    resolution runs once for the whole fuse."""
    gj, gt = _groups(False)
    calls = []
    real = tfeddf.resolve_bank

    def counting(*a, **k):
        calls.append(k.get("expected_steps"))
        return real(*a, **k)
    monkeypatch.setattr(tfeddf, "resolve_bank", counting)
    pool = np.random.default_rng(7).uniform(-3, 3, (3000, 2)).astype(
        np.float32)
    val = gaussian_mixture(200, seed=8)
    fj = jfeddf.FusionConfig(max_steps=40, patience=20, eval_every=20,
                             batch_size=4)
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    _, jinfo = jfeddf.feddf_fuse_heterogeneous_stacked(
        gj, JSource(pool), fj, jnp.asarray(val.x), val.y, seed=1)
    _, tinfo = tfeddf.feddf_fuse_heterogeneous_stacked(
        gt, TSource(pool, indices=jax_index_stream(3000)), ft,
        torch.from_numpy(val.x), torch.from_numpy(val.y), seed=1)
    assert calls == [40 * 3]          # the three students' steps, once
    for t, j in zip(tinfo, jinfo):
        assert t["bank_decision"] == j["bank_decision"] == \
            "skipped_small_run"
        assert t["steps"] == j["steps"]
        assert not t["logit_bank"]


def test_equal_per_group_distill_batches_match_jax():
    """``fusion.batch_sizes`` with one size for every group: each group
    distils at that size with no padding, as the fusion without per-group
    sizes does, and as the JAX package does."""
    gj, gt = _groups(False)
    pool = np.random.default_rng(7).uniform(-3, 3, (300, 2)).astype(
        np.float32)
    val = gaussian_mixture(200, seed=8)
    fj = jfeddf.FusionConfig(max_steps=40, patience=20, eval_every=20,
                             batch_size=16, batch_sizes=(32, 32, 32))
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    jp, jinfo = jfeddf.feddf_fuse_heterogeneous_stacked(
        gj, JSource(pool), fj, jnp.asarray(val.x), val.y, seed=2)
    tp, tinfo = tfeddf.feddf_fuse_heterogeneous_stacked(
        gt, TSource(pool, indices=jax_index_stream(300)), ft,
        torch.from_numpy(val.x), torch.from_numpy(val.y), seed=2)
    plain, _ = tfeddf.feddf_fuse_heterogeneous_stacked(
        gt, TSource(pool, indices=jax_index_stream(300)),
        dataclasses.replace(ft, batch_size=32, batch_sizes=None),
        torch.from_numpy(val.x), torch.from_numpy(val.y), seed=2)
    for gi in range(3):
        assert tinfo[gi]["batch_capacity"] == jinfo[gi]["batch_capacity"] \
            == 32
        assert tinfo[gi]["padded_rows_per_step"] == 0
        assert tinfo[gi]["steps"] == jinfo[gi]["steps"]
        assert_tree_close(tp[gi], jp[gi], FUSE_ATOL)
        for k, v in tree_flatten(tp[gi]).items():
            assert torch.equal(v, tree_flatten(plain[gi])[k]), k


def test_ensemble_accuracy_stacked_matches_jax():
    gj, gt = _groups(False)
    ds = gaussian_mixture(700, seed=3)
    want = jens.ensemble_accuracy_stacked(
        [(n, s) for n, s, _ in gj], ds.x, ds.y, batch_size=256)
    got = tens.ensemble_accuracy_stacked(
        [(n, s) for n, s, _ in gt], torch.from_numpy(ds.x),
        torch.from_numpy(ds.y), batch_size=256)
    assert got == want
    # the list form over unstacked trees agrees with the stacked one
    lists = [(n, [{p: {q: v[i] for q, v in leaf.items()}
                   for p, leaf in s.items()}
                  for i in range(len(w))]) for n, s, w in gt]
    assert tens.ensemble_accuracy(lists, torch.from_numpy(ds.x),
                                  torch.from_numpy(ds.y)) == got


def hetero_spec(pkg, strategy="feddf", bank="auto", rounds=2):
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=600),
        partition=pkg.PartitionSpec(n_clients=6, alpha=1.0),
        cohort=pkg.CohortSpec(prototypes=[
            pkg.ModelSpec("mlp", {"hidden": list(h), "name": f"p{i}"})
            for i, h in enumerate(HIDDEN)]),
        strategy=pkg.StrategySpec(name=strategy, fusion=pkg.FusionSpec(
            max_steps=60, patience=40, eval_every=20, batch_size=32,
            logit_bank=bank)),
        source=(pkg.SourceSpec(name="unlabeled", params={"n": 300})
                if strategy == "feddf" else None),
        rounds=rounds, client_fraction=0.5, local_epochs=2,
        local_batch_size=32, local_lr=0.05, seed=1)


def jax_hetero_init(jspec):
    """JAX's heterogeneous init: prototype p from PRNGKey(seed + p)."""
    bundle = japi.build_task_bundle(jspec)
    jnets_ = japi.build_cohort(jspec, bundle)[0]
    return [convert.to_torch(jax.tree.map(np.asarray, n.init(
        jax.random.PRNGKey(jspec.seed + p)))) for p, n in enumerate(jnets_)]


def assert_runs_agree(tres_results, tglobals, jres_results, jglobals,
                      n_test):
    for g, (jr, tr) in enumerate(zip(jres_results, tres_results,
                                     strict=True)):
        for jl, tl in zip(jr.logs, tr.logs, strict=True):
            assert tl.bank == jl.bank, g
            assert tl.distill_steps == jl.distill_steps, g
            assert tl.n_participants == jl.n_participants, g
            assert tl.teacher_forwards == jl.teacher_forwards, g
            assert abs(tl.test_acc - jl.test_acc) <= 1.0 / n_test + 1e-12
            assert abs(tl.ensemble_acc - jl.ensemble_acc) <= \
                1.0 / n_test + 1e-12
        assert_tree_close(tglobals[g], jglobals[g], 1e-4)


@pytest.mark.parametrize("strategy,bank", [("feddf", "auto"),
                                           ("feddf", "off"),
                                           ("fedavg", "auto")])
def test_three_prototype_spec_matches_jax_per_group(strategy, bank):
    jspec = hetero_spec(japi, strategy, bank)
    jres = japi.Experiment(jspec).run()
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=jax_hetero_init(jspec),
        index_stream=jax_index_stream(300) if tspec.source else None)
    assert tres.heterogeneous and tres.net_names == jres.net_names
    # round-robin over 3 prototypes, 3 of 6 clients a round: a round may
    # leave a group without a client, which then keeps its global
    assert_runs_agree(tres.results, tres.global_params, jres.results,
                      jres.global_params, int(600 * 0.2))
    if strategy == "feddf":
        logs = [l for r in tres.results for l in r.logs
                if l.n_participants]
        assert logs and all(l.bank == ("bank" if bank == "auto"
                                       else "on_the_fly") for l in logs)


def test_run_federated_heterogeneous_matches_jax():
    ds = gaussian_mixture(600, seed=2)
    train, val, test = train_val_test_split(ds, seed=2)
    parts = dirichlet_partition(train.y, 6, 1.0, seed=2)
    proto = [k % 3 for k in range(6)]
    fusion = dict(max_steps=40, patience=20, eval_every=20, batch_size=32)
    jcfg = jengine.FLConfig(rounds=2, client_fraction=0.5, local_epochs=2,
                            local_lr=0.05, strategy="feddf", seed=3,
                            fusion=jfeddf.FusionConfig(**fusion))
    tcfg = tengine.FLConfig(rounds=2, client_fraction=0.5, local_epochs=2,
                            local_lr=0.05, strategy="feddf", seed=3,
                            fusion=tfeddf.FusionConfig(**fusion))
    pool = np.random.default_rng(9).uniform(-3, 3, (300, 2)).astype(
        np.float32)
    jn = [jnets.mlp(2, 3, h) for h in HIDDEN]
    tn = [tnets.mlp(2, 3, h) for h in HIDDEN]
    jlogs, tlogs = [], []
    jres, jglob = jserver.run_federated_heterogeneous(
        jn, proto, train, parts, val, test, jcfg, JSource(pool),
        log_fn=jlogs.append)
    init = [convert.to_torch(jax.tree.map(np.asarray, n.init(
        jax.random.PRNGKey(3 + p)))) for p, n in enumerate(jn)]
    tds = [Dataset(d.x, d.y, d.n_classes) for d in (train, val, test)]
    tres, tglob = tserver.run_federated_heterogeneous(
        tn, proto, tds[0], parts, tds[1], tds[2], tcfg,
        TSource(pool, indices=jax_index_stream(300)), log_fn=tlogs.append,
        device="cpu", init_globals=init)
    assert [g for g, _ in tlogs] == [g for g, _ in jlogs]
    assert_runs_agree(tres, tglob, jres, jglob, len(test.y))


def test_default_prototype_ladder_matches_jax():
    for task in ("blobs", "tokens"):
        assert treg.default_prototype_ladder(task) == \
            jreg.default_prototype_ladder(task)
    with pytest.raises(ValueError):
        treg.default_prototype_ladder("nope")


def test_buffered_async_with_several_prototypes_validates():
    """The spec validates in both packages and round-trips equal; the run
    itself is held against JAX in ``test_torch_buffered_hetero.py``."""
    d = hetero_spec(japi).to_dict()
    d["driver"] = {"kind": "buffered_async", "staleness": 0, "prefetch": 1}
    jspec = japi.ExperimentSpec.from_dict(d).validate()
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    assert tspec.validate() is tspec
    assert tspec.to_json() == jspec.to_json()


def test_list_wrappers_match_jax():
    """``feddf_fuse_heterogeneous`` over lists of trees (one group
    empty), and ``feddf_fuse_homogeneous`` with Table 5's
    ``init_from='previous'``, against the JAX package's wrappers."""
    gj, gt = _groups(True)
    unstack = lambda s, k, j: (jax.tree.map(lambda a: a[j], s) if k
                               else {p: {q: v[j] for q, v in leaf.items()}
                                     for p, leaf in s.items()})
    lj = [(n, [] if s is None else [unstack(s, True, j)
                                    for j in range(len(w))], w)
          for n, s, w in gj]
    lt = [(n, [] if s is None else [unstack(s, False, j)
                                    for j in range(len(w))], w)
          for n, s, w in gt]
    pool = np.random.default_rng(7).uniform(-3, 3, (300, 2)).astype(
        np.float32)
    val = gaussian_mixture(200, seed=8)
    fj = jfeddf.FusionConfig(max_steps=40, patience=20, eval_every=20,
                             batch_size=32)
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    jp, _ = jfeddf.feddf_fuse_heterogeneous(
        lj, JSource(pool), fj, jnp.asarray(val.x), val.y, seed=2)
    tp, _ = tfeddf.feddf_fuse_heterogeneous(
        lt, TSource(pool, indices=jax_index_stream(300)), ft,
        torch.from_numpy(val.x), torch.from_numpy(val.y), seed=2)
    assert tp[0] is None and jp[0] is None
    for g in (1, 2):
        assert_tree_close(tp[g], jp[g], FUSE_ATOL)
    net_j, plist_j, w = lj[2]
    net_t, plist_t, _ = lt[2]
    jh, jinfo = jfeddf.feddf_fuse_homogeneous(
        net_j, plist_j, w, JSource(pool), fj, jnp.asarray(val.x), val.y,
        seed=3, init_from="previous", prev_global=plist_j[0])
    th, tinfo = tfeddf.feddf_fuse_homogeneous(
        net_t, plist_t, w, TSource(pool, indices=jax_index_stream(300)), ft,
        torch.from_numpy(val.x), torch.from_numpy(val.y), seed=3,
        init_from="previous", prev_global=plist_t[0])
    assert tinfo["steps"] == jinfo["steps"]
    assert_tree_close(th, jh, FUSE_ATOL)
