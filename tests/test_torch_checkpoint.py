"""The port's checkpoints and ``Experiment.resume`` on the CPU.

- ``checkpoint/io.py``: the tree and object round trips (bfloat16
  included), a kill mid-write (``os.fsync`` / ``os.replace`` raising)
  leaving the previous checkpoint loadable, and the record log's torn
  tail.
- Each package reads the other's round snapshots: the port restores a
  snapshot the JAX package wrote (globals and ``fedavgm``'s momentum),
  and the JAX package's ``ckpt.restore`` / ``load_obj`` read one the port
  wrote.
- Resume continues to the uninterrupted run's result bit for bit: sync
  ``fedavgm`` (server state), a sync chaos run (fault draws keyed on the
  round), and ``buffered_async`` at staleness 0 and 1, the latter also
  under faults (the population snapshot: registry, pending uploads, the
  screen's window, the cohort rng's state).  Resuming a complete run is a
  no-op, a stop at the target is not retrained, superseded snapshots are
  pruned, resume without snapshots fails loudly and a partial snapshot
  is skipped.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import experiment as jexp
from repro.checkpoint import io as jckpt
from repro_torch import api as tapi
from repro_torch.api import experiment as texp
from repro_torch.checkpoint import io as ckpt
from repro_torch.common.pytree import tree_flatten


class _Bomb(Exception):
    pass


class _StopAfter(Exception):
    pass


def spec(pkg, strategy="fedavgm", rounds=4, **kw):
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=600),
        partition=pkg.PartitionSpec(n_clients=6, alpha=1.0),
        cohort=pkg.CohortSpec(prototypes=[pkg.ModelSpec(
            "mlp", {"hidden": [16, 16]})]),
        strategy=pkg.StrategySpec(name=strategy, fusion=pkg.FusionSpec(
            max_steps=40, patience=40, eval_every=20, batch_size=32)),
        source=(pkg.SourceSpec(name="unlabeled", params={"n": 300})
                if strategy == "feddf" else None),
        rounds=rounds, client_fraction=0.5, local_epochs=2,
        local_batch_size=32, local_lr=0.05, seed=0, **kw)


def buffered_spec(staleness, faults=None):
    return spec(tapi, strategy="feddf", rounds=5,
                driver=tapi.DriverSpec(kind="buffered_async",
                                       staleness=staleness),
                population=tapi.PopulationSpec(
                    size=18, sampler="prioritized", buffer_size=3,
                    max_staleness=4,
                    traffic=tapi.TrafficSpec(arrival="bernoulli", rate=0.9,
                                             latency=1.0, jitter=0.3,
                                             dropout=0.05)),
                faults=tapi.FaultSpec(**(faults or {})))


def assert_same_run(a, b):
    assert a.result.logs == b.result.logs
    assert a.rounds_to_target == b.rounds_to_target
    fa, fb = tree_flatten(a.global_params[0]), tree_flatten(
        b.global_params[0])
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def interrupted(s, ckpt_dir, at=3):
    """Run ``s`` with snapshots until an observer raises at round ``at``."""
    def bomb(event):
        if event.round == at:
            raise _StopAfter
    with pytest.raises(_StopAfter):
        tapi.Experiment(s, device="cpu").run(observers=[bomb],
                                             checkpoint_dir=ckpt_dir)


# ---------------------------------------------------------------------------
# checkpoint/io.py
# ---------------------------------------------------------------------------

def test_tree_round_trip_keeps_dtypes_and_jax_leaf_order(tmp_path):
    tree = {"w": torch.randn(3, 2), "b": torch.arange(4, dtype=torch.int32),
            "h": torch.randn(5).to(torch.bfloat16),
            "blocks": ({"z": torch.ones(2)}, {"a": torch.zeros(1, 2)})}
    path = str(tmp_path / "g")
    ckpt.save(path, tree, {"round": 3})
    like = {k: v for k, v in tree.items()}
    back = ckpt.restore(path, like=like)
    for k, v in tree_flatten(tree).items():
        got = tree_flatten(back)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert ckpt.metadata(path) == {"round": 3}
    # the npz numbers the leaves in jax.tree.flatten's order
    jback = jckpt.restore(path, like=jax.tree.map(
        lambda x: np.zeros(x.shape, np.float32), _np_tree(tree)))
    for (p, v), (_, jv) in zip(
            jax.tree_util.tree_flatten_with_path(_np_tree(tree))[0],
            jax.tree_util.tree_flatten_with_path(jback)[0]):
        np.testing.assert_array_equal(np.asarray(jv, np.float32),
                                      np.asarray(v, np.float32))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, like={**like, "w": torch.zeros(2, 2)})


def _np_tree(tree):
    from repro_torch.common.pytree import tree_map
    return tree_map(lambda x: x.float().numpy(), tree)


def test_obj_round_trip(tmp_path):
    obj = {"a": np.arange(3, dtype=np.float32), "b": None,
           "c": [torch.ones(2, 2), {"d": 5}], "e": (1.5, "x", True),
           "f": torch.randn(4).to(torch.bfloat16), "g": 2 ** 100}
    path = str(tmp_path / "state")
    ckpt.save_obj(path, obj)
    back = ckpt.load_obj(path)
    assert back["b"] is None and back["c"][1] == {"d": 5}
    assert back["e"] == (1.5, "x", True) and back["g"] == 2 ** 100
    np.testing.assert_array_equal(back["a"], obj["a"])
    np.testing.assert_array_equal(back["c"][0], np.ones((2, 2)))
    assert back["f"].dtype == torch.bfloat16
    assert torch.equal(back["f"], obj["f"])
    with pytest.raises(TypeError, match="string dict keys"):
        ckpt.save_obj(str(tmp_path / "bad"), {0: 1.0})


def test_save_survives_kill_mid_write(tmp_path, monkeypatch):
    path = str(tmp_path / "g")
    v1 = {"w": torch.ones(3, 2)}
    v2 = {"w": torch.full((3, 2), 9.0)}
    ckpt.save(path, v1, {"v": 1})
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(ckpt.os, "fsync",
                        lambda fd: (_ for _ in ()).throw(_Bomb()))
    with pytest.raises(_Bomb):
        ckpt.save(path, v2, {"v": 2})
    monkeypatch.setattr(ckpt.os, "fsync", real_fsync)
    assert torch.equal(ckpt.restore(path, like=v1)["w"], v1["w"])
    assert ckpt.metadata(path)["v"] == 1
    # a crash between the payload's replace and the manifest's: the
    # manifest still describes a loadable checkpoint
    calls = {"n": 0}

    def bomb_second(src, dst):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Bomb()
        return real_replace(src, dst)
    monkeypatch.setattr(ckpt.os, "replace", bomb_second)
    with pytest.raises(_Bomb):
        ckpt.save(path, v2, {"v": 2})
    monkeypatch.setattr(ckpt.os, "replace", real_replace)
    assert bool(torch.isfinite(ckpt.restore(path, like=v1)["w"]).all())
    ckpt.save(path, v2, {"v": 2})
    assert torch.equal(ckpt.restore(path, like=v1)["w"], v2["w"])
    assert ckpt.metadata(path)["v"] == 2


def test_save_obj_survives_kill_mid_write(tmp_path, monkeypatch):
    path = str(tmp_path / "s")
    ckpt.save_obj(path, {"state": [np.arange(3), 7]})
    for name in ("fsync", "replace"):
        real = getattr(os, name)
        monkeypatch.setattr(ckpt.os, name,
                            lambda *a: (_ for _ in ()).throw(_Bomb()))
        with pytest.raises(_Bomb):
            ckpt.save_obj(path, {"state": [np.arange(9), 8]})
        monkeypatch.setattr(ckpt.os, name, real)
        obj = ckpt.load_obj(path)
        np.testing.assert_array_equal(obj["state"][0], np.arange(3))
        assert obj["state"][1] == 7


def test_record_log_stops_at_a_torn_tail(tmp_path):
    path = str(tmp_path / "wire.log")
    for p in (b"one", b"two", b"three"):
        ckpt.append_record(path, p)
    with open(path, "ab") as f:
        f.write(b"\x09\x00\x00\x00\x00")             # a torn header
    assert ckpt.read_records(path) == [b"one", b"two", b"three"]
    assert ckpt.read_records(path) == jckpt.read_records(path)


# ---------------------------------------------------------------------------
# each package reads the other's round snapshots
# ---------------------------------------------------------------------------

def test_port_reads_a_jax_round_snapshot(tmp_path):
    jspec = spec(japi, rounds=2)
    d = str(tmp_path / "jax")
    jres = japi.Experiment(jspec).run(checkpoint_dir=d)
    nets = texp.build_cohort(tapi.ExperimentSpec.load(
        os.path.join(d, "spec.json")), texp.build_task_bundle(jspec))[0]
    t, globals_, state, logs, rtt = texp._load_latest_round(d, nets, "cpu")
    assert t == 2 and rtt is None
    assert [dataclasses.asdict(l) for l in logs[0]] == \
        [dataclasses.asdict(l) for l in jres.result.logs]
    flat = tree_flatten(globals_[0])
    jflat = jax.tree_util.tree_flatten_with_path(jres.global_params[0])[0]
    for path, v in jflat:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(flat[key].numpy(), np.asarray(v))
    # fedavgm's momentum buffer, one tree per group
    jbuf = jckpt.load_obj(os.path.join(d, "rounds", "00002", "state"))
    for key, v in tree_flatten(state[0]).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      tree_flatten(_np(jbuf[0]))[key])
    # a complete run resumes as a no-op in the port too
    again = tapi.Experiment.resume(d, device="cpu")
    assert [dataclasses.asdict(l) for l in again.result.logs] == \
        [dataclasses.asdict(l) for l in jres.result.logs]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_jax_reads_a_port_round_snapshot(tmp_path):
    tspec = spec(tapi, rounds=2)
    d = str(tmp_path / "port")
    tres = tapi.Experiment(tspec, device="cpu").run(checkpoint_dir=d)
    jspec = japi.ExperimentSpec.load(os.path.join(d, "spec.json"))
    jnets = japi.build_cohort(jspec, japi.build_task_bundle(jspec))[0]
    t, jglobals, jstate, jlogs, rtt = jexp._load_latest_round(d, jnets)
    assert t == 2 and rtt is None
    assert [dataclasses.asdict(l) for l in jlogs[0]] == \
        [dataclasses.asdict(l) for l in tres.result.logs]
    flat = tree_flatten(tres.global_params[0])
    for path, v in jax.tree_util.tree_flatten_with_path(jglobals[0])[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(np.asarray(v), flat[key].numpy())
    for path, v in jax.tree_util.tree_flatten_with_path(jstate[0])[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(
            np.asarray(v), tree_flatten(tres_state(d))[key])


def tres_state(d):
    return ckpt.load_obj(os.path.join(d, "rounds", "00002", "state"))[0]


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["fedavgm", "sync_chaos"])
def test_sync_resume_matches_uninterrupted(tmp_path, case):
    s = (spec(tapi) if case == "fedavgm" else spec(
        tapi, strategy="feddf", faults=tapi.FaultSpec(
            byzantine_frac=0.3, nan_rate=0.3, quorum=0.5)))
    baseline = tapi.Experiment(s, device="cpu").run()
    d = str(tmp_path / case)
    interrupted(s, d)
    assert os.path.isdir(os.path.join(d, "rounds", "00002"))
    assert_same_run(tapi.Experiment.resume(d, device="cpu"), baseline)


@pytest.mark.parametrize("staleness,faults", [
    (0, None), (1, None),
    (1, dict(byzantine_frac=0.25, nan_rate=0.2, quorum=0.5))],
    ids=["staleness0", "staleness1", "staleness1_faults"])
def test_buffered_resume_matches_uninterrupted(tmp_path, staleness, faults):
    s = buffered_spec(staleness, faults)
    baseline = tapi.Experiment(s, device="cpu").run()
    assert [l.round for l in baseline.result.logs] == [1, 2, 3, 4, 5]
    if faults:
        assert baseline.summary()["faults"]["quarantined_uploads"] > 0
    d = str(tmp_path / "buffered")
    interrupted(s, d)
    state = ckpt.load_obj(os.path.join(d, "rounds", "00002", "state"))
    assert ("screen" in state["population"]["manager"]) == bool(faults)
    assert_same_run(tapi.Experiment.resume(d, device="cpu"), baseline)


def test_resume_of_complete_run_is_a_noop(tmp_path):
    d = str(tmp_path / "run")
    first = tapi.Experiment(spec(tapi, "fedavg", rounds=2),
                            device="cpu").run(checkpoint_dir=d)
    assert_same_run(tapi.Experiment.resume(d, device="cpu"), first)


def test_resume_after_target_stop_does_not_retrain(tmp_path):
    s = dataclasses.replace(spec(tapi, "fedavg", rounds=6),
                            target_accuracy=0.4)
    d = str(tmp_path / "run")
    first = tapi.Experiment(s, device="cpu").run(checkpoint_dir=d)
    assert first.rounds_to_target is not None and first.rounds_to_target < 6
    resumed = tapi.Experiment.resume(d, device="cpu")
    assert resumed.rounds_to_target == first.rounds_to_target
    assert resumed.result.logs == first.result.logs


def test_superseded_snapshots_are_pruned(tmp_path):
    d = str(tmp_path / "run")
    tapi.Experiment(spec(tapi, "fedavg"), device="cpu").run(
        checkpoint_dir=d)
    assert sorted(os.listdir(os.path.join(d, "rounds"))) == \
        ["00003", "00004"]


def test_resume_without_snapshots_fails_loudly(tmp_path):
    spec(tapi).save(str(tmp_path / "spec.json"))
    with pytest.raises(FileNotFoundError, match="no complete round"):
        tapi.Experiment.resume(str(tmp_path), device="cpu")


def test_resume_falls_back_past_a_partial_snapshot(tmp_path):
    s = spec(tapi, "fedavg", rounds=3)
    baseline = tapi.Experiment(s, device="cpu").run()
    d = str(tmp_path / "run")
    interrupted(s, d)
    # a kill partway through writing round 2's snapshot
    os.remove(os.path.join(d, "rounds", "00002", "logs.json"))
    assert_same_run(tapi.Experiment.resume(d, device="cpu"), baseline)


def test_resume_refuses_a_missing_card(tmp_path, monkeypatch):
    d = str(tmp_path / "run")
    tapi.Experiment(spec(tapi, "fedavg", rounds=1), device="cpu").run(
        checkpoint_dir=d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.Experiment.resume(d)
