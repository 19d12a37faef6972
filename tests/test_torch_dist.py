"""The port's distributed runtime (``repro_torch.dist``) on the CPU,
against the port's ``sync`` driver and the JAX package's ``repro.dist``.

1. Wire format: for every codec a frame either package encodes decodes
   in the other, and the two encode the same arrays to the same bytes;
   CRC corruption, a version mismatch (checked before the CRC),
   truncation and garbage are rejected; blob packing.
2. The record log drops a torn tail; the wire log replays one round, in
   both packages.
3. ``shard_clients``.
4. The degenerate config (loopback, fp32, no faults) equals ``sync`` bit
   for bit (``feddf``, ``fedavg``, 3 prototypes), whatever the pod count,
   and matches JAX's ``distributed`` run within ``test_torch_slice.py``'s
   1e-4 with the JAX init and distillation indices injected.
5. The robustness ladder: a killed pod re-routes as soon as it falls
   silent, a CRC retry keeps the
   trajectory, a quorum shortfall freezes the globals, a restarted fusion
   pod replays the wire log, with the CRC off garbage is fused; a fusion
   longer than three heartbeats does not make the live pods look dead.
6. One TCP run with 2 subprocess pods (``--device cpu``) equals ``sync``
   bit for bit, under a timeout of its own; a pod told ``--device cuda``
   without a card raises.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.dist import frames as jfr
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import build_engine
from repro_torch.checkpoint import io as ckpt
from repro_torch.common.pytree import tree_flatten
from repro_torch.dist import frames as fr
from repro_torch.dist.pods import shard_clients
from repro_torch.drivers import make_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES, POOL = 600, 300
N_TEST = int(N_SAMPLES * 0.2)


def spec(pkg, strategy="fedavg", rounds=2, dist=None, driver="distributed",
         hetero=False, faults=None):
    protos = ([pkg.ModelSpec("mlp", {"hidden": [16]}),
               pkg.ModelSpec("mlp", {"hidden": [8, 8]}),
               pkg.ModelSpec("mlp", {"hidden": [12]})] if hetero
              else [pkg.ModelSpec("mlp", {"hidden": [16]})])
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=N_SAMPLES),
        partition=pkg.PartitionSpec(n_clients=6, alpha=1.0),
        cohort=pkg.CohortSpec(prototypes=protos),
        strategy=pkg.StrategySpec(name=strategy, fusion=pkg.FusionSpec(
            max_steps=40, patience=40, eval_every=20, batch_size=32)),
        source=(pkg.SourceSpec(name="unlabeled", params={"n": POOL})
                if strategy == "feddf" else None),
        driver=pkg.DriverSpec(kind=driver),
        dist=dist or pkg.DistSpec(n_pods=2),
        faults=pkg.FaultSpec(**(faults or {})),
        rounds=rounds, client_fraction=0.5, local_epochs=2,
        local_batch_size=32, local_lr=0.05, seed=0)


def run(s, **engine_dist):
    """``s`` through ``build_engine`` and its driver on the CPU, with
    engine-level ``DistConfig`` knobs the spec does not carry (the chaos
    hook).  Returns (results, globals)."""
    engine = build_engine(s, "cpu")
    for k, v in engine_dist.items():
        setattr(engine.cfg.dist, k, v)
    drv = make_driver(s.driver.kind)
    results, globals_, _ = drv.run(engine)
    return results, globals_


def accs(results):
    return [[l.test_acc for l in r.logs] for r in results]


def globals_equal(a, b) -> bool:
    for ga, gb in zip(a, b, strict=True):
        fa, fb = tree_flatten(ga), tree_flatten(gb)
        if not all(torch.equal(fa[k], fb[k]) for k in fa):
            return False
    return True


SYNC = {}


def sync_ref(strategy="fedavg", hetero=False, rounds=2):
    """The sync run of ``spec``'s problem (cached: several tests hold
    against it)."""
    key = (strategy, hetero, rounds)
    if key not in SYNC:
        SYNC[key] = run(spec(tapi, strategy, rounds, driver="sync",
                             hetero=hetero))
    return SYNC[key]


def _leaves():
    rng = np.random.default_rng(0)
    return [rng.normal(size=(8, 16)).astype(np.float32),
            rng.normal(size=(16,)).astype(np.float32),
            np.arange(5, dtype=np.int64)]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec_name", ["fp32", "binarize", "int8"])
def test_frames_byte_identical_across_packages(codec_name):
    leaves = _leaves()
    tc, jc = fr.get_codec(codec_name), jfr.get_codec(codec_name)
    assert tc.codec_id == jc.codec_id
    blob = tc.encode(leaves)
    assert blob == jc.encode(leaves)
    assert len(blob) == tc.nbytes(leaves) == jc.nbytes(leaves)
    meta = {"pod": 1, "req": 7, "attempt": 2, "codec": codec_name}
    tbytes = fr.encode_frame(fr.Frame(
        kind=fr.UPLOAD, round=3, wave=3, client_ids=[4, 0, 2],
        codec_id=tc.codec_id, meta=meta, payload=fr.pack_blobs([blob] * 3)))
    jbytes = jfr.encode_frame(jfr.Frame(
        kind=jfr.UPLOAD, round=3, wave=3, client_ids=[4, 0, 2],
        codec_id=jc.codec_id, meta=meta,
        payload=jfr.pack_blobs([blob] * 3)))
    assert tbytes == jbytes
    for dec, mod, data in ((fr.decode_frame, fr, jbytes),
                           (jfr.decode_frame, jfr, tbytes)):
        f = dec(data)
        assert (f.kind, f.round, f.wave, list(f.client_ids), f.meta) == \
            (mod.UPLOAD, 3, 3, [4, 0, 2], meta)
        for b in mod.unpack_blobs(f.payload, 3):
            for a, w in zip(mod.codec_by_id(f.codec_id).decode(b, leaves),
                            jc.decode(blob, leaves), strict=True):
                np.testing.assert_array_equal(a, w)
    if codec_name == "fp32":
        for a, w in zip(tc.decode(blob, leaves), leaves, strict=True):
            np.testing.assert_array_equal(a, w)


def test_corruption_version_truncation_and_garbage_rejected():
    data = fr.encode_frame(fr.Frame(kind=fr.TRAIN, round=1, client_ids=[1],
                                    payload=b"x" * 64))
    flipped = bytearray(data)
    flipped[40] ^= 0x10  # a payload byte
    for dec in (fr.decode_frame, jfr.decode_frame):
        with pytest.raises(fr.CRCError if dec is fr.decode_frame
                           else jfr.CRCError):
            dec(bytes(flipped))
    # the version is checked before the CRC: a foreign frame reports so
    foreign = bytearray(data)
    foreign[2] = fr.WIRE_VERSION + 1
    with pytest.raises(fr.VersionError):
        fr.decode_frame(bytes(foreign))
    for bad in (data[:10], data[:-8], b"XX" + data[2:], b"", b"\x00" * 40):
        with pytest.raises(fr.FrameError):
            fr.decode_frame(bad)
    # unchecked, a flipped payload byte is accepted as garbage
    assert fr.decode_frame(bytes(flipped), verify_crc=False).kind == \
        fr.TRAIN
    blobs = [b"a", b"", b"xyz"]
    assert fr.unpack_blobs(fr.pack_blobs(blobs), 3) == blobs
    for bad, n in ((fr.pack_blobs(blobs)[:-1], 3),
                   (fr.pack_blobs(blobs) + b"!", 3)):
        with pytest.raises(fr.FrameError):
            fr.unpack_blobs(bad, n)
    with pytest.raises(KeyError):
        fr.get_codec("fp64")
    assert fr.available_codecs() == jfr.available_codecs()


def test_record_log_torn_tail_and_wire_log_replay(tmp_path):
    path = str(tmp_path / "wire.log")
    frames = [fr.encode_frame(fr.Frame(kind=fr.UPLOAD, round=r,
                                       client_ids=[r], payload=b"p"))
              for r in (1, 2, 2)]
    log = fr.WireLog(path)
    for f in frames:
        log.append(f)
    log.append(fr.encode_frame(fr.Frame(kind=fr.HEARTBEAT, round=2)))
    with open(path, "ab") as f:
        f.write(b"\x10\x00\x00\x00torn")  # a crash mid-append
    assert len(ckpt.read_records(path)) == 4
    for wlog in (log, jfr.WireLog(path)):
        assert [f.client_ids for f in wlog.replay(2)] == [[2], [2]]
        assert len(wlog.replay(1)) == 1 and wlog.replay(3) == []


def test_shard_clients():
    assert shard_clients([0, 1, 2, 3, 4, 7], 3) == [[0, 3], [1, 4, 7], [2]]
    assert shard_clients([], 2) == [[], []]


# ---------------------------------------------------------------------------
# degenerate runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy,hetero", [("feddf", False),
                                             ("fedavg", False),
                                             ("feddf", True)])
def test_degenerate_loopback_equals_sync(strategy, hetero):
    ref = sync_ref(strategy, hetero)
    got = run(spec(tapi, strategy, hetero=hetero))
    assert accs(got[0]) == accs(ref[0])
    assert globals_equal(got[1], ref[1])
    for r in got[0]:
        assert all(l.wire_bytes_up > 0 and l.n_pods_alive == 2
                   for l in r.logs)


def test_trajectory_does_not_depend_on_pod_count():
    ref = sync_ref()
    for n in (1, 3):
        got = run(spec(tapi, dist=tapi.DistSpec(n_pods=n)))
        assert accs(got[0]) == accs(ref[0])
        assert globals_equal(got[1], ref[1])


def test_distributed_run_matches_jax():
    import jax
    from repro import api as japi
    from test_torch_baselines import assert_tree_close
    from test_torch_slice import jax_index_stream
    jspec = spec(japi, "feddf")
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    tres = tapi.Experiment(tapi.ExperimentSpec.from_json(jspec.to_json()),
                           device="cpu").run(
        init_globals=[convert.to_torch(init)],
        index_stream=jax_index_stream(POOL))
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        for k in ("distill_steps", "n_participants", "bank",
                  "wire_bytes_up", "wire_bytes_down", "n_wire_retries",
                  "n_pods_alive"):
            assert getattr(tl, k) == getattr(jl, k), k
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / N_TEST + 1e-12
    assert_tree_close(tres.global_params[0], jres.global_params[0], 1e-4)
    assert tres.summary()["dist"] == jres.summary()["dist"]
    assert "dist" not in tapi.Experiment(
        spec(tapi, driver="sync"), device="cpu").run().summary()


# ---------------------------------------------------------------------------
# robustness ladder
# ---------------------------------------------------------------------------

def test_killed_pod_reroutes_and_trajectory_holds():
    ref = sync_ref()
    got = run(spec(tapi, dist=tapi.DistSpec(n_pods=2, heartbeat_s=0.05,
                                            upload_deadline_s=30.0)),
              kill_pod=1, kill_after_round=1)
    assert accs(got[0]) == accs(ref[0])
    assert globals_equal(got[1], ref[1])
    logs = got[0][0].logs
    # the killed pod's request re-routes once it falls silent, before its
    # deadline
    assert sum(l.n_wire_retries for l in logs) >= 1
    assert sum(l.n_deadline_misses for l in logs) == 0
    assert logs[-1].n_pods_alive == 1


def test_crc_retry_keeps_trajectory():
    ref = sync_ref()
    got = run(spec(tapi, faults=dict(transport_corrupt=0.2, retries=6)))
    assert accs(got[0]) == accs(ref[0])
    assert globals_equal(got[1], ref[1])
    logs = got[0][0].logs
    assert sum(l.n_crc_failures for l in logs) > 0
    assert sum(l.n_wire_retries for l in logs) > 0


def test_quorum_shortfall_freezes_globals():
    s = spec(tapi, dist=tapi.DistSpec(n_pods=2, upload_deadline_s=0.2),
             faults=dict(transport_drop=1.0, quorum=0.5, retries=1,
                         backoff=1.0))
    engine = build_engine(s, "cpu")
    init = engine.init_globals()
    results, globals_, _ = make_driver("distributed").run(
        engine, init_globals=init)
    logs = results[0].logs
    assert all(l.fused is False and l.n_wire_lost > 0 for l in logs)
    assert globals_equal(globals_, init)


def test_fusion_pod_restart_replays_wire_log(tmp_path):
    s = spec(tapi, rounds=3, dist=tapi.DistSpec(
        n_pods=2, wire_log=str(tmp_path / "wire.log")))
    snap = {}

    def hook(t, globals_, state, logs, rtt):
        if t == 1:
            snap.update(globals_=list(globals_), state=state,
                        logs=[list(g) for g in logs])
    engine = build_engine(s, "cpu")
    full = make_driver("distributed").run(engine, round_end_hook=hook)
    resumed = make_driver("distributed").run(
        build_engine(s, "cpu"), init_globals=snap["globals_"],
        init_state=snap["state"], init_logs=snap["logs"], start_round=2)
    assert accs(resumed[0]) == accs(full[0])
    assert globals_equal(resumed[1], full[1])
    # the restarted round re-sent nothing: its uploads came off the log
    assert resumed[0][0].logs[1].wire_bytes_up == 0
    assert resumed[0][0].logs[2].wire_bytes_up > 0


def test_undefended_crc_off_accepts_garbage():
    got = run(spec(tapi, dist=tapi.DistSpec(n_pods=2, verify_crc=False),
                   faults=dict(transport_corrupt=0.9)))
    ref = sync_ref()
    assert accs(got[0]) != accs(ref[0]) or not all(
        bool(torch.isfinite(x).all()) for x in
        tree_flatten(got[1][0]).values())


def test_a_long_fusion_leaves_live_pods_alive(monkeypatch):
    """A fusion longer than three heartbeats: the dispatch drains the
    heartbeats queued meanwhile, so no live pod is taken for dead and
    the run equals sync."""
    from repro_torch.core.engine import RoundEngine
    real = RoundEngine.aggregate

    def slow(self, t, groups, state):
        time.sleep(0.4)
        return real(self, t, groups, state)
    monkeypatch.setattr(RoundEngine, "aggregate", slow)
    got = run(spec(tapi, dist=tapi.DistSpec(n_pods=2, heartbeat_s=0.05,
                                            upload_deadline_s=30.0)))
    monkeypatch.undo()
    ref = sync_ref()
    logs = got[0][0].logs
    assert [l.n_pods_alive for l in logs] == [2, 2]
    assert sum(l.n_wire_lost + l.n_deadline_misses for l in logs) == 0
    assert accs(got[0]) == accs(ref[0])
    assert globals_equal(got[1], ref[1])


# ---------------------------------------------------------------------------
# tcp pods
# ---------------------------------------------------------------------------

_TCP_SCRIPT = r"""
import sys
sys.path.insert(0, {tests!r})
import torch
from test_torch_dist import accs, globals_equal, run, spec
from repro_torch import api as tapi
ref = run(spec(tapi, driver="sync"))
got = run(spec(tapi, dist=tapi.DistSpec(transport="tcp", n_pods=2,
                                        upload_deadline_s=60.0)))
assert accs(got[0]) == accs(ref[0]), (accs(got[0]), accs(ref[0]))
assert globals_equal(got[1], ref[1])
assert all(l.n_pods_alive == 2 for l in got[0][0].logs)
print("TCP_OK")
"""


def test_tcp_pods_equal_sync():
    """Two subprocess pods over localhost TCP on the CPU, in a process of
    its own under a timeout of its own: bit for bit the sync run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c",
         _TCP_SCRIPT.format(tests=os.path.join(ROOT, "tests"))],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TCP_OK" in out.stdout


def test_pod_told_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.dist import pods
    path = str(tmp_path / "spec.json")
    spec(tapi).save(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pods.main(["--spec", path, "--pod", "0", "--port", "1",
                   "--device", "cuda"])
