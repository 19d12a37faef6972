"""The port's ``async_pipelined`` driver on the CPU, against the port's
``sync`` driver and against the JAX package's ``async_pipelined``.

- Staleness 0 equals ``sync`` bit for bit, homogeneous and over 3
  prototypes.
- Staleness 1 and 2 equal JAX's pipelined runs with the JAX init and
  distillation indices injected: the same discrete facts, globals within
  ``test_torch_slice.py``'s 1e-4 and accuracy within one test example.
- Checkpoint/resume: a run killed at round 3 and resumed from its round-2
  snapshot equals the uninterrupted run for staleness 1 and 2 (the
  snapshot carries the in-flight rounds' bases, ``base_ring`` at 2); each
  package resumes the other's pipelined snapshot, the first resumed round
  training from the stored base.
- An observer's stop ends the pipeline after its round.
- ``gpu``: K1 and K2 launched on a side stream equal their launches on
  the default stream bit for bit, and staleness 0 equals ``sync`` on the
  card.

JAX is imported inside the tests that use it, so the file also loads
where only PyTorch is installed (``pytest -m gpu`` on the card's machine).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.checkpoint import io as ckpt
from repro_torch.common.pytree import tree_flatten
from repro_torch.core.engine import RoundEngine
from repro_torch.drivers import make_driver, unwrap_state, wrap_state

N_SAMPLES, POOL = 600, 300
N_TEST = int(N_SAMPLES * 0.2)


def spec(pkg, staleness=0, driver="async_pipelined", rounds=3,
         strategy="feddf", hetero=False):
    protos = ([pkg.ModelSpec("mlp", {"hidden": [16]}),
               pkg.ModelSpec("mlp", {"hidden": [8, 8]}),
               pkg.ModelSpec("mlp", {"hidden": [12]})] if hetero
              else [pkg.ModelSpec("mlp", {"hidden": [16, 16]})])
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=N_SAMPLES),
        partition=pkg.PartitionSpec(n_clients=6, alpha=1.0),
        cohort=pkg.CohortSpec(prototypes=protos),
        strategy=pkg.StrategySpec(name=strategy, fusion=pkg.FusionSpec(
            max_steps=40, patience=40, eval_every=20, batch_size=32)),
        source=(pkg.SourceSpec(name="unlabeled", params={"n": POOL})
                if strategy == "feddf" else None),
        driver=pkg.DriverSpec(kind=driver, staleness=staleness,
                              prefetch=2 if driver == "async_pipelined"
                              else 1),
        rounds=rounds, client_fraction=0.5, local_epochs=2,
        local_batch_size=32, local_lr=0.05, seed=0)


def assert_bit_equal(a, b):
    assert [r.logs for r in a.results] == [r.logs for r in b.results]
    assert a.rounds_to_target == b.rounds_to_target
    for ga, gb in zip(a.global_params, b.global_params, strict=True):
        fa, fb = tree_flatten(ga), tree_flatten(gb)
        for k in fa:
            assert torch.equal(fa[k].cpu(), fb[k].cpu()), k


class _StopAfter(Exception):
    pass


# ---------------------------------------------------------------------------
# driver surface
# ---------------------------------------------------------------------------

def test_registry_and_state_wrapping():
    from repro_torch.drivers import available_drivers, get_driver
    assert {"sync", "async_pipelined", "buffered_async",
            "distributed"} <= set(available_drivers())
    from repro_torch.drivers import MultiHostDriver
    from repro_torch.drivers.base import pending_drivers
    assert get_driver("multihost") is MultiHostDriver
    assert "multihost" in available_drivers() and pending_drivers() == []
    with pytest.raises(ValueError, match="staleness"):
        make_driver("async_pipelined", staleness=-1)
    w = wrap_state({"m": 1}, {"g": 2}, base_ring=[{"a": 1}, {"b": 2}])
    assert unwrap_state(w) == ({"m": 1}, {"g": 2})
    assert w["base_ring"] == [{"a": 1}, {"b": 2}] and "population" not in w
    assert unwrap_state({"m": 1}) == ({"m": 1}, None)


@pytest.mark.parametrize("hetero", [False, True])
def test_staleness_zero_equals_sync_bit_for_bit(hetero):
    sync = tapi.Experiment(spec(tapi, driver="sync", hetero=hetero),
                           device="cpu").run()
    pipe = tapi.Experiment(spec(tapi, hetero=hetero), device="cpu").run()
    assert_bit_equal(pipe, sync)
    assert [set(p) for p in pipe.phase_seconds] == [
        {"join_batches", "train_clients", "join_fusion", "aggregate",
         "evaluate_round"}] * 3


@pytest.mark.parametrize("staleness", [1, 2])
def test_stale_runs_match_jax(staleness):
    import jax
    from repro import api as japi
    from test_torch_baselines import assert_tree_close
    from test_torch_slice import jax_index_stream
    jspec = spec(japi, staleness=staleness, rounds=3)
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=[convert.to_torch(init)],
        index_stream=jax_index_stream(POOL))
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        for k in ("round", "distill_steps", "bank", "n_participants",
                  "teacher_forwards"):
            assert getattr(tl, k) == getattr(jl, k), k
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / N_TEST + 1e-12
    assert_tree_close(tres.global_params[0], jres.global_params[0], 1e-4)


@pytest.mark.parametrize("staleness", [1, 2])
def test_resume_equals_uninterrupted(tmp_path, staleness):
    s = spec(tapi, staleness=staleness, rounds=4)
    base = tapi.Experiment(s, device="cpu").run()

    def bomb(event):
        if event.round == 3:
            raise _StopAfter

    d = str(tmp_path / "run")
    with pytest.raises(_StopAfter):
        tapi.Experiment(s, device="cpu").run(observers=[bomb],
                                             checkpoint_dir=d)
    state = ckpt.load_obj(os.path.join(d, "rounds", "00002", "state"))
    assert state["__async_pipeline__"]
    # staleness S keeps the bases of the S rounds in flight
    assert len(state.get("base_ring", [None])) == staleness
    resumed = tapi.Experiment.resume(d, device="cpu")
    assert_bit_equal(resumed, base)


class _TrainBases:
    """Records the globals each ``train_clients`` call trains from."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = RoundEngine.train_clients

        def recording(engine, t, globals_, batches):
            self.calls.append((t, [tree_flatten(g) for g in globals_]))
            return real(engine, t, globals_, batches)
        monkeypatch.setattr(RoundEngine, "train_clients", recording)


def _snapshot_base(d):
    """The stale base (one tree per prototype) a pipelined round-2
    snapshot stores, the first prototype's flattened."""
    state = ckpt.load_obj(os.path.join(d, "rounds", "00002", "state"))
    assert state["__async_pipeline__"]
    return {k: np.asarray(v) for k, v in tree_flatten(
        convert.to_torch(state["prev_globals"][0])).items()}


def test_each_package_resumes_the_others_checkpoint(tmp_path, monkeypatch):
    from repro import api as japi

    def bomb(event):
        if event.round == 3:
            raise _StopAfter

    # the JAX package's snapshot, resumed by the port
    jd = str(tmp_path / "jax")
    jspec = spec(japi, staleness=1, rounds=4)
    with pytest.raises(_StopAfter):
        japi.Experiment(jspec).run(observers=[bomb], checkpoint_dir=jd)
    want = _snapshot_base(jd)  # before the resume prunes the snapshot
    rec = _TrainBases(monkeypatch)
    res = tapi.Experiment.resume(jd, device="cpu")
    assert [l.round for l in res.result.logs] == [1, 2, 3, 4]
    t, bases = rec.calls[0]
    assert t == 3
    for k, v in bases[0].items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    monkeypatch.undo()

    # the port's snapshot, resumed by the JAX package
    td = str(tmp_path / "port")
    with pytest.raises(_StopAfter):
        tapi.Experiment(spec(tapi, staleness=1, rounds=4),
                        device="cpu").run(observers=[bomb],
                                          checkpoint_dir=td)
    jres = japi.Experiment.resume(td)
    assert [l.round for l in jres.result.logs] == [1, 2, 3, 4]
    for l in jres.result.logs:
        assert np.isfinite(l.test_acc) and l.distill_steps > 0


def test_observer_stop_under_the_pipeline():
    def stop(event):
        if event.round == 2:
            event.request_stop()
    for staleness in (0, 1, 2):
        res = tapi.Experiment(spec(tapi, staleness=staleness, rounds=5,
                                   strategy="fedavg"),
                              device="cpu").run(observers=[stop])
        assert [l.round for l in res.result.logs] == [1, 2]
        assert res.rounds_to_target is None
        assert len(res.phase_seconds) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 card (the kernels build for sm_90a)")
    from repro_torch.kernels import build
    try:
        build.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")


@pytest.mark.gpu
def test_k1_k2_on_a_side_stream_equal_the_default_stream_on_card():
    """The pipelined fusion's kernels on its own stream: K1 at the
    quickstart's (64, 4000, 3) and K2 at (8, 64, 3) launched on a side
    stream equal the default stream's launches bit for bit."""
    _needs_card()
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ensemble_kl_bank as k1
    gen = torch.Generator().manual_seed(0)
    s = torch.randn(64, 3, generator=gen).cuda()
    bank = torch.randn(4000, 3, generator=gen).cuda()
    idx = torch.randint(0, 4000, (64,), generator=gen).cuda()
    teachers = torch.randn(8, 64, 3, generator=gen).cuda()
    g = torch.ones((), device="cuda")

    def launch():
        f1 = k1.bank_kl_fwd(s, bank, None, idx, 2.0)
        b1 = k1.bank_kl_bwd(s, bank, None, idx, f1[1], f1[2], g, 2.0)
        f2 = k2.kl_fwd(s, teachers, 2.0)
        b2 = k2.kl_bwd(s, teachers, f2[1], f2[2], g, 2.0)
        return list(f1) + [b1] + list(f2) + [b2]

    before = {**k1.LAUNCHES, **k2.LAUNCHES}
    want = launch()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    after = {**k1.LAUNCHES, **k2.LAUNCHES}
    for name in ("ensemble_kl_bank_fwd", "ensemble_kl_bank_bwd",
                 "ensemble_kl_fwd", "ensemble_kl_bwd"):
        assert after[name] == before[name] + 2


@pytest.mark.gpu
def test_staleness_zero_equals_sync_on_card():
    _needs_card()
    sync = tapi.Experiment(spec(tapi, driver="sync", rounds=2)).run()
    pipe = tapi.Experiment(spec(tapi, rounds=2)).run()
    assert_bit_equal(pipe, sync)
    assert pipe.device.startswith("cuda")
    assert all(l.bank == "bank" for l in pipe.result.logs)


def test_phase_seconds_time_the_calling_threads_stream():
    """``Driver._timed`` returns ``fn``'s result and adds its seconds to
    the phase, accumulating over calls."""
    from repro_torch.drivers.base import Driver
    eng = dataclasses.make_dataclass("E", [("device", object)])(
        torch.device("cpu"))
    phases = {}
    assert Driver._timed(eng, phases, "x", lambda a: a + 1, 1) == 2
    Driver._timed(eng, phases, "x", lambda: None)
    assert set(phases) == {"x"} and phases["x"] >= 0.0
