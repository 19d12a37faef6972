"""The port's population modules against the JAX package's: the sum tree,
the client registry, the traffic model, the cohort samplers and the
upload manager are host-side numpy code, so the same seeds must give the
same arrays bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.strategies import GroupRound as JGroup
from repro.population import config as jcfg
from repro.population import manager as jman
from repro.population import registry as jreg
from repro.population import scheduler as jsch
from repro.population import sumtree as jst
from repro.population import traffic as jtr
from repro_torch.core.strategies import GroupRound as TGroup
from repro_torch.population import config as tcfg
from repro_torch.population import manager as tman
from repro_torch.population import registry as treg
from repro_torch.population import scheduler as tsch
from repro_torch.population import sumtree as tst
from repro_torch.population import traffic as ttr

TRAFFIC = dict(arrival="bernoulli", rate=0.8, latency=1.0, jitter=0.3,
               straggler_frac=0.2, straggler_mult=4.0, dropout=0.1)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_sumtree_bitwise():
    vals = np.random.default_rng(0).uniform(0, 3, 37)
    a, b = jst.SumTree.from_values(vals), tst.SumTree.from_values(vals)
    a.set_many([3, 9], [0.0, 5.0])
    b.set_many([3, 9], [0.0, 5.0])
    _eq(a.values(), b.values())
    assert a.total() == b.total()
    for u in np.linspace(0, a.total() * 0.999, 11):
        assert a.find(u) == b.find(u)
    for replace in (False, True):
        _eq(a.sample(np.random.default_rng(4), 9, replace),
            b.sample(np.random.default_rng(4), 9, replace))


def test_registry_bitwise():
    args = (23, [5, 7, 9, 11], [2, 3, 4, 5], [0, 0, 1, 1], [0, 1, 0, 1])
    a, b = jreg.ClientRegistry(*args), treg.ClientRegistry(*args)
    for r in (a, b):
        r.record_dispatch(np.array([1, 4, 7]), 3)
        r.record_upload(np.array([1, 4]), [0.5, 2.0], [0, 2])
        r.record_dropout([7])
        r.record_stale_drop([2])
        r.record_quarantine([4])
    da, db = a.state_dict(), b.state_dict()
    assert da.keys() == db.keys() and a.nbytes == b.nbytes
    for k in da:
        _eq(da[k], db[k])


@pytest.mark.parametrize("seed", [0, 5])
def test_traffic_bitwise(seed):
    a = jtr.TrafficModel(jcfg.TrafficConfig(**TRAFFIC), seed, 40)
    b = ttr.TrafficModel(tcfg.TrafficConfig(**TRAFFIC), seed, 40)
    _eq(a.base_latency, b.base_latency)
    _eq(a.straggler, b.straggler)
    for w in (1, 2, 9):
        _eq(a.online_mask(w), b.online_mask(w))
        for x, y in zip(a.upload_draws(w, np.arange(3, 17)),
                        b.upload_draws(w, np.arange(3, 17))):
            _eq(x, y)


def _ctx(mod):
    rng = np.random.default_rng(2)
    return mod.SamplerContext(
        n_clients=30, n_partitions=10, proto=np.zeros(30, np.int64),
        bucket=rng.integers(0, 3, 30), bucket_client_caps=[[4, 3, 2]])


@pytest.mark.parametrize("kind", ["uniform", "capacity_aware",
                                  "prioritized"])
def test_samplers_bitwise(kind):
    a = jsch.make_sampler(kind).bind(_ctx(jsch))
    b = tsch.make_sampler(kind).bind(_ctx(tsch))
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    avail = np.arange(3, 28)
    for _ in range(3):
        _eq(a.sample(ra, 8), b.sample(rb, 8))
        _eq(a.sample(ra, 5, available=avail), b.sample(rb, 5,
                                                       available=avail))
        a.observe([1, 2], [3, 1])
        b.observe([1, 2], [3, 1])
    assert tsch.available_samplers() == jsch.available_samplers()


def test_uniform_is_the_historic_engine_draw():
    s = tsch.make_sampler("uniform").bind(_ctx(tsch))
    _eq(s.sample(np.random.default_rng(3), 8),
        np.random.default_rng(3).choice(30, size=8, replace=False))


def _manager(mod, cfg_mod, sched):
    cfg = cfg_mod.PopulationConfig(
        size=30, sampler="prioritized", buffer_size=4, max_staleness=1,
        traffic=cfg_mod.TrafficConfig(**TRAFFIC))
    sampler = sched.make_sampler("prioritized").bind(sched.SamplerContext(
        n_clients=30, n_partitions=6, proto=np.zeros(30, np.int64),
        bucket=np.zeros(30, np.int64), bucket_client_caps=[[6]]))
    return mod.PopulationManager(
        cfg, seed=3, n_partitions=6, partition_sizes=[10, 20, 30, 40, 50,
                                                      60],
        client_steps=[1, 2, 3, 4, 5, 6], client_proto=[0] * 6,
        client_bucket=[0] * 6, n_active=4, sampler=sampler)


def test_manager_waves_buffer_and_telemetry_bitwise():
    a = _manager(jman, jcfg, jsch)
    b = _manager(tman, tcfg, tsch)
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    version = 0
    for t in range(1, 5):
        for _ in range(2):       # a few waves per round
            (wa, ca), (wb, cb) = a.next_wave(ra), b.next_wave(rb)
            assert wa == wb
            _eq(ca, cb)
            w = np.arange(len(ca), dtype=np.float32)[:, None] + 10 * wa
            ga = JGroup(None, {"w": jnp.zeros(2)}, {"w": jnp.asarray(w)},
                        np.arange(1.0, len(ca) + 1))
            gb = TGroup(None, {"w": torch.zeros(2)},
                        {"w": torch.from_numpy(w)},
                        np.arange(1.0, len(cb) + 1))
            assert a.push_wave(wa, ca, [ga], version) == \
                b.push_wave(wb, cb, [gb], version)
        assert a.usable_pending(t) == b.usable_pending(t)
        m = min(a.buffer_size, a.usable_pending(t))
        (ua, ta), (ub, tb) = a.pop(t, m), b.pop(t, m)
        assert ta == tb and a.clock == b.clock
        assert [(u.client, u.seq, u.weight, s) for u, s in ua] == \
            [(u.client, u.seq, u.weight, s) for u, s in ub]
        for (u, _), (v, _) in zip(ua, ub):
            _eq(np.asarray(u.params["w"]), v.params["w"].numpy())
        pa, pb = a.regroup(ua), b.regroup(ub)
        assert pa[0]["staleness"] == pb[0]["staleness"]
        version = t
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa["registry"]:
        _eq(sa["registry"][k], sb["registry"][k])
    assert [dataclasses.astuple(tman.Upload.from_dict(d))[:-2]
            for d in sb["pending"]] == \
        [dataclasses.astuple(jman.Upload.from_dict(d))[:-2]
         for d in sa["pending"]]


def test_manager_rejects_bad_uploads_and_faults():
    b = _manager(tman, tcfg, tsch)
    w, c = b.next_wave(np.random.default_rng(0))
    good = TGroup(None, {}, {"w": torch.zeros(len(c), 2)},
                  np.ones(len(c)))
    b.push_wave(w, c, [good], 0)
    bad = TGroup(None, {}, {"w": torch.zeros(len(c), 3)}, np.ones(len(c)))
    w, c = b.next_wave(np.random.default_rng(1))
    with pytest.raises(ValueError, match="shape"):
        b.push_wave(w, c, [bad], 0)
    with pytest.raises(ValueError, match="nan_rate"):
        tman.PopulationManager(
            tcfg.PopulationConfig(), seed=0, n_partitions=2,
            partition_sizes=[1, 1], client_steps=[1, 1],
            client_proto=[0, 0], client_bucket=[0, 0], n_active=1,
            sampler=tsch.make_sampler("uniform"),
            faults=tcfg.FaultConfig(nan_rate=1.5))
