"""Step-count bucketing of the round engine's client axis and
distill-axis bucketing of the heterogeneous fusion, in the port against
the JAX package on the CPU.

Step-count (``bucket.kind`` ``pow2`` / ``quantile``), on a skewed split
so that a group's clients fall into several buckets, homogeneous and
over 2 prototypes:
- the round's batches and padding accounting (``real_steps``,
  ``padded_slots``: JAX pads each bucket's client axis to its run-fixed
  cap, and the port counts the same slots without computing them) equal
  JAX's, the batches bitwise;
- the port's bucketed uploads equal its unbucketed ones (float32 batched
  matmuls over fewer clients; equal bit for bit on the CPU, held to
  1e-5);
- each uploaded client equals JAX's SEQUENTIAL ``make_local_update`` on
  its own batches within 1e-5 (``test_torch_baselines.py``'s bound);
- the whole spec through both ``Experiment``\\ s: globals within 1e-4,
  accuracy within one test example, equal distill steps and bank
  decisions;
- the ``capacity_aware`` sampler's cohorts, which read the buckets' client
  caps, stay bitwise equal.

Distill-axis (``fusion.batch_sizes`` with each ``distill_bucket`` kind):
``feddf_fuse_heterogeneous_stacked`` with a different distill batch per
group, bank and on the fly, against JAX within ``test_torch_hetero.py``'s
2e-5, with the capacity and padded rows in each group's info equal.  A
``bn`` student sees its padded rows in its batch statistics in the JAX
package (``train=True``), and the port matches that: held against JAX
and shown to differ from the unpadded fusion."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.experiment import build_engine
from repro.core import client as jclient
from repro.core import feddf as jfeddf
from repro.core import nets as jnets
from repro.data.distill_sources import UnlabeledDataset as JSource
from repro.data.synthetic import gaussian_mixture
from repro.optim import optimizers as jopt
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import experiment as texp
from repro_torch.common.pytree import tree_flatten, tree_stack
from repro_torch.core import feddf as tfeddf
from repro_torch.core import nets as tnets
from repro_torch.core.engine import RoundEngine
from repro_torch.data.distill_sources import UnlabeledDataset as TSource

from test_torch_baselines import assert_tree_close
from test_torch_buffered import jax_noise_stream
from test_torch_hetero import assert_runs_agree, jax_hetero_init
from test_torch_slice import jax_index_stream

HIDDEN = [(16, 16), (24, 24)]


def bucket_spec(pkg, kind: str, hetero: bool, sampler: str = "uniform",
                rounds: int = 2):
    protos = ([pkg.ModelSpec("mlp", {"hidden": list(h), "name": f"p{i}"})
               for i, h in enumerate(HIDDEN)] if hetero else
              [pkg.ModelSpec("mlp", {"hidden": [16, 16]})])
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=900),
        partition=pkg.PartitionSpec(n_clients=10, alpha=0.1),
        cohort=pkg.CohortSpec(prototypes=protos),
        strategy=pkg.StrategySpec(name="feddf", fusion=pkg.FusionSpec(
            max_steps=40, patience=20, eval_every=20, batch_size=32)),
        source=pkg.SourceSpec(name="unlabeled", params={"n": 300}),
        bucket=pkg.BucketSpec(kind=kind, max_buckets=4),
        population=pkg.PopulationSpec(sampler=sampler),
        rounds=rounds, client_fraction=0.6, local_epochs=2,
        local_batch_size=16, local_lr=0.05, seed=2)


def port_engine(tspec):
    bundle = texp.build_task_bundle(tspec)
    train, val, test, parts = texp.build_splits(tspec, bundle)
    nets, proto = texp.build_cohort(tspec, bundle)
    return RoundEngine(nets, proto, train, parts, val, test,
                       texp.to_fl_config(tspec), heterogeneous=len(nets) > 1,
                       device="cpu")


def jax_init(jspec):
    if len(jspec.cohort.prototypes) > 1:
        return jax_hetero_init(jspec)
    bundle = japi.build_task_bundle(jspec)
    net = japi.build_cohort(jspec, bundle)[0][0]
    return [convert.to_torch(jax.tree.map(
        np.asarray, net.init(jax.random.PRNGKey(jspec.seed))))]


def max_diff(a, b) -> float:
    fa, fb = tree_flatten(a), tree_flatten(b)
    return max(float((fa[k] - fb[k]).abs().max()) for k in fa)


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("kind", ["pow2", "quantile"])
def test_bucketed_round_matches_unbucketed_and_jax_sequential(kind, hetero):
    jspec = bucket_spec(japi, kind, hetero)
    je = build_engine(jspec)
    te = port_engine(tapi.ExperimentSpec.from_json(jspec.to_json()))
    te_none = port_engine(tapi.ExperimentSpec.from_json(
        bucket_spec(japi, "none", hetero).to_json()))
    assert te.bucket_caps == je.bucket_caps
    assert [list(c) for c in te._bucket_counts] == \
        [list(c) for c in je._bucket_counts]
    globals_ = jax_init(jspec)
    rng = te.make_rng()
    split = False
    for t in (1, 2):
        active = te.sample_cohort(rng)
        tb = te.build_round_batches(t, active)
        jb = je.build_round_batches(t, active)
        for p, (a, b) in enumerate(zip(tb, jb, strict=True)):
            if b is None:
                assert a is None
                continue
            assert a.ks == b.ks and a.k_real == b.k_real
            assert (a.real_steps, a.padded_slots) == \
                (b.real_steps, b.padded_slots)
            assert len(a.buckets) == len(b.buckets)
            split |= len(a.buckets) > 1
            for ab, bb in zip(a.buckets, b.buckets):
                assert np.array_equal(ab.pos, bb.pos)
                assert (ab.k_real, ab.cap_clients, ab.cap_steps) == \
                    (bb.k_real, bb.cap_clients, bb.cap_steps)
                for f in ("xb", "yb", "step_mask"):
                    np.testing.assert_array_equal(
                        getattr(ab, f).numpy(), getattr(bb, f)[:bb.k_real])
        groups = te.train_clients(t, globals_, tb)
        plain = te_none.train_clients(
            t, globals_, te_none.build_round_batches(t, active))
        for g, h in zip(groups, plain):
            if g.stack is not None:
                assert max_diff(g.stack, h.stack) <= 1e-5
        # every uploaded client against JAX's one-client update
        for p, (g, b) in enumerate(zip(groups, tb)):
            if b is None:
                continue
            seq = jclient.make_local_update(je.nets[p], jopt.sgd(0.05))
            jp = jax.tree.map(jnp.asarray, convert.to_numpy(globals_[p]))
            flat = tree_flatten(g.stack)
            for i, k in enumerate(b.ks):
                idx = te.parts[k]
                bx, by = jclient.build_batches(
                    te.train.x[idx], te.train.y[idx], 16, 2,
                    seed=2 * te.batch_seed_mult + t * 131 + k)
                want = seq(jp, jnp.asarray(bx), jnp.asarray(by), jp)
                assert_tree_close({q: v[i] for q, v in flat.items()}, want,
                                  1e-5)
    assert split, "no group split over several buckets"


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("kind", ["pow2", "quantile"])
def test_bucketed_spec_matches_jax(kind, hetero):
    jspec = bucket_spec(japi, kind, hetero)
    jres = japi.Experiment(jspec).run()
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    assert tspec.to_json() == jspec.to_json()
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=jax_init(jspec), index_stream=jax_index_stream(300))
    n_test = int(900 * 0.2)
    if hetero:
        assert_runs_agree(tres.results, tres.global_params, jres.results,
                          jres.global_params, n_test)
        return
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        assert (tl.bank, tl.distill_steps, tl.n_participants) == \
            (jl.bank, jl.distill_steps, jl.n_participants)
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / n_test + 1e-12
    assert_tree_close(tres.global_params[0], jres.global_params[0], 1e-4)


@pytest.mark.parametrize("kind", ["pow2", "quantile"])
def test_capacity_aware_cohorts_match_jax_under_bucketing(kind):
    jspec = bucket_spec(japi, kind, True, sampler="capacity_aware")
    je = build_engine(jspec)
    te = port_engine(tapi.ExperimentSpec.from_json(jspec.to_json()))
    np.testing.assert_array_equal(te._part_bucket, je._part_bucket)
    assert len(set(te._part_bucket.tolist())) > 1
    jr, tr = je.make_rng(), te.make_rng()
    for _ in range(5):
        np.testing.assert_array_equal(je.sample_cohort(jr),
                                      te.sample_cohort(tr))


# -- distill-axis bucketing ----------------------------------------------

SIZES = (12, 32, 20)


def _fuse_groups(norm: str = "none"):
    """Three prototype groups of 2, 3 and 2 teachers in both packages."""
    hidden = [(16, 16), (24, 24), (16, 16, 16)]
    jn = [jnets.mlp(2, 3, h, norm=norm) for h in hidden]
    tn = [tnets.mlp(2, 3, h, norm=norm) for h in hidden]
    rng = np.random.default_rng(4)
    gj, gt = [], []
    for gi, k in enumerate((2, 3, 2)):
        trees = [jax.tree.map(np.asarray, jn[gi].init(
            jax.random.PRNGKey(20 * gi + i))) for i in range(k)]
        w = rng.uniform(1, 4, k)
        gj.append((jn[gi], jax.tree.map(lambda *xs: jnp.stack(xs), *trees),
                   w))
        gt.append((tn[gi], tree_stack([convert.to_torch(t) for t in trees]),
                   w))
    return gj, gt


def _fuse_both(gj, gt, source: str, fusion: dict, importances=None):
    val = gaussian_mixture(200, seed=8)
    fj = jfeddf.FusionConfig(**fusion)
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    if source == "unlabeled":
        pool = np.random.default_rng(7).uniform(-3, 3, (300, 2)).astype(
            np.float32)
        js, ts = JSource(pool), TSource(pool, indices=jax_index_stream(300))
    else:
        from repro.data.distill_sources import RandomNoiseSource
        from repro_torch.data.distill_sources import RandomNoiseSource as TN
        js, ts = RandomNoiseSource((2,)), TN((2,), draws=jax_noise_stream())
    jp, jinfo = jfeddf.feddf_fuse_heterogeneous_stacked(
        gj, js, fj, jnp.asarray(val.x), val.y, seed=3,
        importances=importances)
    tp, tinfo = tfeddf.feddf_fuse_heterogeneous_stacked(
        gt, ts, ft, torch.from_numpy(val.x), torch.from_numpy(val.y),
        seed=3, importances=importances)
    return jp, jinfo, tp, tinfo


@pytest.mark.parametrize("source", ["unlabeled", "noise"])
@pytest.mark.parametrize("kind,want_caps", [
    ("none", [32, 32, 32]), ("pow2", [16, 32, 32]),
    ("quantile", [12, 32, 20])])
def test_per_group_distill_batches_match_jax(kind, want_caps, source):
    gj, gt = _fuse_groups()
    fusion = dict(max_steps=40, patience=20, eval_every=20, batch_size=32,
                  batch_sizes=SIZES, distill_bucket=kind,
                  distill_max_buckets=3, temperature=2.0,
                  logit_bank="auto" if source == "unlabeled" else "off")
    imps = [None, np.array([1.0, 0.5, 0.5]), None]
    jp, jinfo, tp, tinfo = _fuse_both(gj, gt, source, fusion, imps)
    want_bank = "bank" if source == "unlabeled" else "on_the_fly"
    for gi in range(3):
        assert tinfo[gi]["bank_decision"] == jinfo[gi]["bank_decision"] \
            == want_bank
        for k in ("steps", "best_step", "batch_capacity",
                  "padded_rows_per_step", "teacher_batch_forwards"):
            assert tinfo[gi][k] == jinfo[gi][k], (gi, k)
        assert tinfo[gi]["batch_capacity"] == want_caps[gi]
        assert tinfo[gi]["padded_rows_per_step"] == want_caps[gi] - SIZES[gi]
        assert_tree_close(tp[gi], jp[gi], 2e-5)


def test_wrong_number_of_batch_sizes_raises():
    _, gt = _fuse_groups()
    with pytest.raises(ValueError, match="batch_sizes"):
        tfeddf.feddf_fuse_heterogeneous_stacked(
            gt, TSource(np.zeros((10, 2), np.float32)),
            tfeddf.FusionConfig(batch_sizes=(32, 32)))
    with pytest.raises(ValueError, match="batch_capacity"):
        tfeddf.distill(gt[0][0], {}, [], TSource(np.zeros((10, 2),
                                                         np.float32)),
                       tfeddf.FusionConfig(batch_size=8, batch_capacity=4))


def test_bn_student_sees_its_padded_rows_as_in_jax():
    """A ``bn`` student's batch statistics include the padded rows in the
    JAX package; the port matches it, so the padded fusion is held to
    JAX's and differs from the same fusion unpadded (``quantile`` with
    three buckets: capacity = size).  The fusion takes its SGD rule
    (Table 7): a dense bias ahead of BN has a zero gradient, and Adam
    would scale both packages' rounding noise there to lr-sized steps."""
    gj, gt = _fuse_groups(norm="bn")
    fusion = dict(max_steps=40, patience=20, eval_every=20, batch_size=32,
                  batch_sizes=SIZES, distill_bucket="none", optimizer="sgd",
                  lr=0.1)
    jp, jinfo, tp, tinfo = _fuse_both(gj, gt, "unlabeled", fusion)
    for gi in range(3):
        assert tinfo[gi]["steps"] == jinfo[gi]["steps"]
        assert tinfo[gi]["padded_rows_per_step"] == 32 - SIZES[gi]
        assert_tree_close(tp[gi], jp[gi], 2e-5)
    exact = dict(fusion, distill_bucket="quantile", distill_max_buckets=3)
    _, _, tq, qinfo = _fuse_both(gj, gt, "unlabeled", exact)
    assert qinfo[0]["padded_rows_per_step"] == 0
    assert max_diff(tq[0], tp[0]) > 1e-4     # the padding moved group 0
    assert max_diff(tq[1], tp[1]) == 0.0     # group 1 was never padded


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8",
                                        "fp8_e4m3"])
@pytest.mark.parametrize("b", [32, 48])
def test_k1_at_the_distill_buckets_batches_matches_plain_on_card(b,
                                                                  dtype_name):
    """K1 at the distill batches of 32 and 48 rows (3 classes) that
    per-group batch sizes give it over a pool of 4000: against its plain
    version within ``test_torch_kernels.py``'s tolerances, two launches
    equal bit for bit."""
    from test_torch_ablations import _card_with_nvcc
    from test_torch_kernels import check_k1_on_card
    why = _card_with_nvcc()
    if why:
        pytest.skip(why)
    check_k1_on_card(b, 4000, 3, dtype_name)
