"""The whole slice: the FedDF quickstart (shrunk) through
``repro.api.Experiment`` and through ``repro_torch.api.Experiment`` on
the CPU, with the JAX package's init and distill index streams injected
into the port.  Plus the spec JSON in both packages, the import
boundary, and the no-CUDA refusal.

Tolerance: the runs differ only by float32 summation order (XLA vs
PyTorch CPU kernels) over 2 rounds of local SGD and Adam distillation;
globals agree to 1e-4 absolute, test accuracy to one test example, and
the discrete per-round facts (distill steps, bank decision) exactly."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_spec(pkg):
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=600),
        partition=pkg.PartitionSpec(n_clients=6, alpha=0.1),
        cohort=pkg.CohortSpec(prototypes=[pkg.ModelSpec(
            "mlp", {"hidden": [32, 32, 32]})]),
        strategy=pkg.StrategySpec(name="feddf", fusion=pkg.FusionSpec(
            max_steps=60, patience=40, eval_every=20, batch_size=32)),
        source=pkg.SourceSpec(name="unlabeled", params={"n": 300}),
        rounds=2, client_fraction=0.5, local_epochs=2,
        local_batch_size=32, local_lr=0.05, seed=0)


def jax_index_stream(n_pool):
    from repro.data.distill_sources import UnlabeledDataset
    src = UnlabeledDataset(np.zeros((n_pool, 1), np.float32))

    def stream(seed, batch_size, chunk):
        key = jax.random.PRNGKey(seed)
        while True:
            block = []
            for _ in range(chunk):
                key, k1 = jax.random.split(key)
                block.append(np.asarray(src.sample_indices(k1, batch_size)))
            yield np.stack(block)
    return stream


def test_tiny_quickstart_matches_jax_round_by_round():
    jspec = tiny_spec(japi)
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(jspec.seed)))

    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=[convert.to_torch(init)],
        index_stream=jax_index_stream(300))

    n_test = int(600 * 0.2)
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        assert tl.bank == jl.bank == "bank"
        assert tl.distill_steps == jl.distill_steps
        assert tl.n_participants == jl.n_participants
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / n_test + 1e-12
        assert abs(tl.pre_distill_acc - jl.pre_distill_acc) <= \
            1.0 / n_test + 1e-12
    tflat = tree_flatten(tres.global_params[0])
    for path, v in jax.tree_util.tree_flatten_with_path(
            jres.global_params[0])[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(tflat[key].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)


def test_spec_json_round_trips_in_both_packages():
    jspec = tiny_spec(japi)
    text = jspec.to_json()
    tspec = tapi.ExperimentSpec.from_json(text)
    assert tspec.to_json() == text
    assert tspec.validate() is tspec
    default = tapi.ExperimentSpec().to_json()
    assert japi.ExperimentSpec.from_json(default).to_json() == default
    assert default == japi.ExperimentSpec().to_json()


def jax_latent_stream(latent_dim):
    """The latents JAX's generator source draws per distill step."""
    def stream(seed, batch_size, chunk):
        key = jax.random.PRNGKey(seed)
        while True:
            block = []
            for _ in range(chunk):
                key, k1 = jax.random.split(key)
                block.append(np.asarray(jax.random.normal(
                    k1, (batch_size, latent_dim))))
            yield np.stack(block)
    return stream


def generator_spec(pkg):
    d = tiny_spec(pkg).to_dict()
    d["source"] = {"name": "generator", "params": {"latent_dim": 8}}
    return pkg.ExperimentSpec.from_dict(d)


def test_generator_quickstart_matches_jax_round_by_round(monkeypatch):
    """The Fig. 5 generator source: no pool, so every round distils on
    the fly (K2's plain version).  The JAX decoder weights, init and
    latents are injected into the port."""
    from repro_torch.api import experiment as texp
    from repro_torch.data.distill_sources import GeneratorSource
    jspec = generator_spec(japi)
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    jsrc = japi.build_source(jspec, bundle,
                             japi.build_splits(jspec, bundle)[0])
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(jspec.seed)))

    def source_with_jax_weights(spec, bundle, train, device):
        return GeneratorSource(
            (2,), latent_dim=8, hidden=jsrc.hidden, mean=jsrc.mean,
            std=jsrc.std, device=device, w1=np.asarray(jsrc._w1),
            w2=np.asarray(jsrc._w2))
    monkeypatch.setattr(texp, "build_source", source_with_jax_weights)
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=[convert.to_torch(init)],
        draw_stream=jax_latent_stream(8))

    n_test = int(600 * 0.2)
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        assert tl.bank == jl.bank == "on_the_fly"
        assert tl.distill_steps == jl.distill_steps
        assert tl.teacher_forwards == jl.teacher_forwards == \
            tl.distill_steps * tl.n_participants
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / n_test + 1e-12
    tflat = tree_flatten(tres.global_params[0])
    for path, v in jax.tree_util.tree_flatten_with_path(
            jres.global_params[0])[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(tflat[key].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("change", [
    {"source": {"name": "generator", "params": {"latent_dim": 8}}},
    {"source": {"name": "noise", "params": {"low": -2.0}}},
    {"source": {"name": "in_domain", "params": {}}},
    {"driver": {"kind": "buffered_async", "staleness": 1, "prefetch": 1},
     "population": {"size": 12, "sampler": "prioritized", "buffer_size": 2,
                    "max_staleness": 3, "staleness_exponent": 0.5,
                    "traffic": {"arrival": "bernoulli", "rate": 0.9,
                                "latency": 1.0, "jitter": 0.2,
                                "straggler_frac": 0.1,
                                "straggler_mult": 4.0, "dropout": 0.05}}},
    {"bucket": {"kind": "pow2", "max_buckets": 4}},
    {"bucket": {"kind": "quantile", "max_buckets": 2}},
    {"cohort": {"prototypes": [{"name": "mlp", "params": {}}] * 2,
                "assignment": "round_robin"},
     "strategy": {"name": "feddf",
                  "fusion": {"batch_sizes": [32, 64],
                             "distill_bucket": "pow2"}}},
    {"task": {"name": "tokens", "n_samples": 600, "seed": None,
              "params": {"vocab": 32}},
     "cohort": {"prototypes": [{"name": "tiny_transformer",
                                "params": {"d_model": 32}}],
                "assignment": "round_robin"}},
])
def test_new_spec_json_round_trips_in_both_packages(change):
    d = tiny_spec(japi).to_dict()
    d.update(change)
    jspec = japi.ExperimentSpec.from_dict(d).validate()
    text = jspec.to_json()
    tspec = tapi.ExperimentSpec.from_json(text)
    assert tspec.to_json() == text
    assert tspec.validate() is tspec


@pytest.mark.parametrize("change,exc", [
    ({"driver": {"kind": "async_pipelined", "staleness": 1,
                 "prefetch": 1}}, NotImplementedError),
    ({"faults": {"nan_rate": 0.1}}, NotImplementedError),
    ({"sharding": {"shard_clients": True}}, NotImplementedError),
    ({"strategy": {"name": "trimmed_mean"}}, NotImplementedError),
    ({"task": {"name": "nope", "n_samples": 10, "seed": None,
               "params": {}}}, ValueError),
])
def test_unported_or_unknown_spec_axes_raise(change, exc):
    d = tiny_spec(tapi).to_dict()
    d.update(change)
    with pytest.raises(exc):
        tapi.ExperimentSpec.from_dict(d).validate()


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_experiment_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.Experiment(tiny_spec(tapi)).run()
