"""Data synthesis, the Dirichlet partition, the cohort draw and the round
batches: the port's numpy code is a verbatim copy of the JAX package's,
so every array must be bitwise equal for the same seeds."""
import numpy as np
import pytest

from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn


def _eq(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_and_split_bitwise(seed):
    a = jsyn.gaussian_mixture(700, n_classes=3, dim=2, seed=seed)
    b = tsyn.gaussian_mixture(700, n_classes=3, dim=2, seed=seed)
    _eq(a.x, b.x)
    _eq(a.y, b.y)
    for da, db in zip(jsyn.train_val_test_split(a, seed=seed),
                      tsyn.train_val_test_split(b, seed=seed)):
        _eq(da.x, db.x)
        _eq(da.y, db.y)
    ta = jsyn.token_sequences(50, seed=seed)
    tb = tsyn.token_sequences(50, seed=seed)
    _eq(ta.x, tb.x)


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_dirichlet_partition_bitwise(alpha):
    y = jsyn.gaussian_mixture(900, seed=1).y
    pa = jpart.dirichlet_partition(y, 20, alpha, seed=2)
    pb = tpart.dirichlet_partition(y, 20, alpha, seed=2)
    assert len(pa) == len(pb)
    for a, b in zip(pa, pb):
        _eq(a, b)


def _specs():
    from repro.api import (CohortSpec, ExperimentSpec, FusionSpec,
                           ModelSpec, PartitionSpec, SourceSpec,
                           StrategySpec, TaskSpec)
    spec = ExperimentSpec(
        task=TaskSpec(name="blobs", n_samples=900),
        partition=PartitionSpec(n_clients=10, alpha=0.1),
        cohort=CohortSpec(prototypes=[ModelSpec("mlp",
                                                {"hidden": [8, 8]})]),
        strategy=StrategySpec(name="fedavg", fusion=FusionSpec()),
        source=SourceSpec(name="unlabeled", params={"n": 100}),
        rounds=3, client_fraction=0.4, local_epochs=2, local_batch_size=16,
        local_lr=0.05, seed=4)
    from repro_torch.api import ExperimentSpec as TSpec
    return spec, TSpec.from_json(spec.to_json())


def test_cohort_draw_and_round_batches_bitwise():
    from repro.api.experiment import build_engine
    from repro_torch.api import experiment as texp
    from repro_torch.core.engine import RoundEngine
    jspec, tspec = _specs()
    je = build_engine(jspec)
    bundle = texp.build_task_bundle(tspec)
    train, val, test, parts = texp.build_splits(tspec, bundle)
    nets, proto = texp.build_cohort(tspec, bundle)
    te = RoundEngine(nets, proto, train, parts, val, test,
                     texp.to_fl_config(tspec), device="cpu")
    _eq(je.train.x, te.train.x)
    for a, b in zip(je.parts, te.parts):
        _eq(a, b)
    # one bucket per prototype, at the group's largest scan length
    assert te.bucket_caps == je.bucket_caps == [[c] for c in je.steps_cap]
    jr, tr = je.make_rng(), te.make_rng()
    for t in range(1, 4):
        ja, ta = je.sample_cohort(jr), te.sample_cohort(tr)
        _eq(np.asarray(ja), np.asarray(ta))
        jb = je.build_round_batches(t, ja)[0]
        tb = te.build_round_batches(t, ta)[0]
        assert jb.ks == tb.ks and len(jb.buckets) == len(tb.buckets) == 1
        _eq(jb.buckets[0].xb, tb.buckets[0].xb.numpy())
        _eq(jb.buckets[0].yb, tb.buckets[0].yb.numpy())
        _eq(jb.buckets[0].step_mask, tb.buckets[0].step_mask.numpy())
        _eq(jb.weights, tb.weights)
        assert (jb.real_steps, jb.padded_slots) == \
            (tb.real_steps, tb.padded_slots)


def test_build_batched_batches_bitwise():
    from repro.core import client as jc
    from repro_torch.core import client as tc
    ds = jsyn.gaussian_mixture(400, seed=5)
    parts = jpart.dirichlet_partition(ds.y, 6, 0.3, seed=5)
    seeds = [11, 12, 13, 14, 15, 16]
    for a, b in zip(jc.build_batched_batches(ds.x, ds.y, parts, 8, 2, seeds),
                    tc.build_batched_batches(ds.x, ds.y, parts, 8, 2, seeds)):
        _eq(a, b)
    steps = [jc.n_local_steps(len(p), 8, 2) for p in parts]
    assert steps == [tc.n_local_steps(len(p), 8, 2) for p in parts]
    for kind in ("none", "pow2", "quantile"):
        caps = jc.bucket_capacities(steps, kind, 3)
        assert caps == tc.bucket_capacities(steps, kind, 3)
        _eq(jc.assign_buckets(steps, caps), tc.assign_buckets(steps, caps))
        for ja, ta in zip(
                jc.build_bucketed_batches(ds.x, ds.y, parts, 8, 2, seeds,
                                          caps),
                tc.build_bucketed_batches(ds.x, ds.y, parts, 8, 2, seeds,
                                          caps)):
            assert ja[0] == ta[0]
            for a, b in zip(ja[1:], ta[1:]):
                _eq(a, b)
