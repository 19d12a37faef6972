"""The buffered-async driver and the engine's cohort sampler in the port,
against the port's ``sync`` driver and against the JAX package.

- Degenerate setting (buffer = active cohort, zero latency, uniform
  sampler, staleness 0): every round is one wave whose uploads fuse
  fresh, so the trajectory equals ``sync`` bit for bit.
- A shrunk staleness-1 run with traffic latency and the ``noise`` source,
  through ``repro.api.Experiment`` and ``repro_torch.api.Experiment`` with
  the JAX init and noise samples injected.  Stale uploads reach rounds 2
  and 3, so fusion takes the weighted consensus (kernel K3's plain
  version).  The population telemetry is numpy on both sides and must
  match exactly; globals agree to 1e-4 (float32 summation order over 3
  rounds of SGD and Adam) and test accuracy to one test example."""
import jax
import numpy as np
import pytest

from repro import api as japi
from repro.api.experiment import build_engine
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import experiment as texp
from repro_torch.common.pytree import tree_flatten
from repro_torch.core.engine import RoundEngine


def spec(pkg, source="unlabeled", strategy="feddf", driver="sync",
         staleness=0, population=None, rounds=3):
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=600),
        partition=pkg.PartitionSpec(n_clients=6, alpha=0.1),
        cohort=pkg.CohortSpec(prototypes=[pkg.ModelSpec(
            "mlp", {"hidden": [32, 32, 32]})]),
        strategy=pkg.StrategySpec(name=strategy, fusion=pkg.FusionSpec(
            max_steps=40, patience=20, eval_every=20, batch_size=32)),
        source=pkg.SourceSpec(name=source, params={}),
        driver=pkg.DriverSpec(kind=driver, staleness=staleness),
        population=population or pkg.PopulationSpec(),
        rounds=rounds, client_fraction=0.5, local_epochs=2,
        local_batch_size=32, local_lr=0.05, seed=0)


def stale_population(pkg):
    return pkg.PopulationSpec(buffer_size=3, max_staleness=4,
                              traffic=pkg.TrafficSpec(latency=1.0,
                                                      jitter=0.2))


def jax_noise_stream(low=-3.0, high=3.0):
    def stream(seed, batch_size, chunk):
        key = jax.random.PRNGKey(seed)
        while True:
            block = []
            for _ in range(chunk):
                key, k1 = jax.random.split(key)
                block.append(np.asarray(jax.random.uniform(
                    k1, (batch_size, 2), minval=low, maxval=high)))
            yield np.stack(block)
    return stream


@pytest.mark.parametrize("strategy", ["fedavg", "feddf"])
def test_degenerate_buffered_matches_sync(strategy):
    sync = tapi.Experiment(spec(tapi, strategy=strategy),
                           device="cpu").run()
    buf = tapi.Experiment(spec(tapi, strategy=strategy,
                               driver="buffered_async"), device="cpu").run()
    logs = buf.result.logs
    assert all(sum(l.staleness_hist[1:]) == 0 for l in logs)
    assert [l.test_acc for l in logs] == \
        [l.test_acc for l in sync.result.logs]
    assert [l.val_acc for l in logs] == [l.val_acc for l in sync.result.logs]
    a, b = tree_flatten(buf.global_params[0]), tree_flatten(
        sync.global_params[0])
    for k in a:
        assert bool((a[k] == b[k]).all()), k
    assert [set(p) for p in buf.phase_seconds] == \
        [{"fill", "join_fusion", "evaluate_round"}] * 3


def test_staleness_one_run_matches_jax():
    jspec = spec(japi, source="noise", driver="buffered_async", staleness=1,
                 population=stale_population(japi))
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=[convert.to_torch(init)],
        draw_stream=jax_noise_stream())

    jl, tl = jres.result.logs, tres.result.logs
    assert any(sum(l.staleness_hist[1:]) > 0 for l in tl)  # weighted path
    n_test = int(600 * 0.2)
    for a, b in zip(jl, tl, strict=True):
        for k in ("staleness_hist", "buffer_fill", "n_straggling",
                  "n_dropped_uploads", "n_stale_dropped", "eff_participants",
                  "bank", "distill_steps", "teacher_forwards",
                  "n_participants"):
            assert getattr(a, k) == getattr(b, k), k
        assert abs(a.test_acc - b.test_acc) <= 1.0 / n_test + 1e-12
    tflat = tree_flatten(tres.global_params[0])
    for path, v in jax.tree_util.tree_flatten_with_path(
            jres.global_params[0])[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(tflat[key].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("sampler,size", [("uniform", None),
                                          ("capacity_aware", 25),
                                          ("prioritized", 14)])
def test_engine_cohort_draws_match_jax(sampler, size):
    pop = {"size": size, "sampler": sampler}
    jspec = spec(japi, strategy="fedavg",
                 population=japi.PopulationSpec(**pop))
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    je = build_engine(jspec)
    bundle = texp.build_task_bundle(tspec)
    train, val, test, parts = texp.build_splits(tspec, bundle)
    nets, proto = texp.build_cohort(tspec, bundle)
    te = RoundEngine(nets, proto, train, parts, val, test,
                     texp.to_fl_config(tspec), device="cpu")
    assert te.population_size == je.population_size
    np.testing.assert_array_equal(te._part_bucket, je._part_bucket)
    jr, tr = je.make_rng(), te.make_rng()
    for _ in range(4):
        np.testing.assert_array_equal(je.sample_cohort(jr),
                                      te.sample_cohort(tr))


def test_buffered_spec_validation():
    ok = spec(tapi, driver="buffered_async", staleness=1,
              population=stale_population(tapi))
    assert ok.validate() is ok
    for change, exc in (
            ({"driver": {"kind": "buffered_async", "staleness": 2,
                         "prefetch": 1}}, ValueError),
            ({"driver": {"kind": "sync", "staleness": 1, "prefetch": 1}},
             ValueError),
            ({"population": {"max_staleness": 0}}, ValueError),
            ({"population": {"traffic": {"dropout": 1.0}}}, ValueError),
            ({"faults": {"quorum": 0.5, "byzantine_mode": "nope"}},
             ValueError)):
        d = ok.to_dict()
        for key, sub in change.items():
            d[key] = {**d[key], **sub}
        with pytest.raises(exc):
            tapi.ExperimentSpec.from_dict(d).validate()
