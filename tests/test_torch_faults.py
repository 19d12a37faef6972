"""Fault injection, upload screening and robust aggregation of the port,
held against the JAX package on the CPU.

- ``population/faults.py``: ``FaultModel.corrupt`` gives bitwise-equal
  leaves and the same fault kinds for every fault class over many
  (wave, client, attempt); the transport draws and frame corruption are
  equal; ``NormScreen``, ``outlier_mask``, ``robust_z`` and
  ``delta_norm`` are equal (all float64 numpy in both packages).
- The JAX leaf order: ``tree_leaves_jax`` walks every port prototype's
  tree in ``jax.tree.flatten``'s order, so a draw that indexes the flat
  payload hits the same tensor.
- ``trimmed_mean`` / ``coordinate_median`` agree with JAX within 1e-6
  (float32 sums in another order); trim 0 is the port's FedAvg bit for
  bit, and a non-finite value in the trim region is masked.
- ``filter_teacher_stack`` keeps the same teachers, with poisoned teachers
  and with every teacher poisoned.
"""
import jax
import numpy as np
import pytest
import torch

from repro.common import pytree as jpt
from repro.core import feddf as jfeddf
from repro.core import nets as jnets
from repro.population import faults as jfaults
from repro.population.config import FaultConfig as JFaultConfig
from repro_torch import convert
from repro_torch.common import pytree as tpt
from repro_torch.core import feddf as tfeddf
from repro_torch.core import nets as tnets
from repro_torch.population import faults as tfaults
from repro_torch.population.config import FaultConfig as TFaultConfig

CHAOS = dict(byzantine_frac=0.3, byzantine_scale=10.0, nan_rate=0.4,
             crash_rate=0.4, bitflip_rate=0.4, bitflip_bits=4)


def _leaves(rng):
    return [rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(7,)).astype(np.float32),
            np.arange(5, dtype=np.int32),
            rng.normal(size=(2, 2, 3)).astype(np.float32)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("mode", ["sign_flip", "scale"])
def test_fault_model_corrupt_is_bitwise_jax(mode):
    rng = np.random.default_rng(0)
    base = _leaves(rng)
    cfg = dict(CHAOS, byzantine_mode=mode)
    jfm = jfaults.FaultModel(JFaultConfig(**cfg), seed=3, n=12)
    tfm = tfaults.FaultModel(TFaultConfig(**cfg), seed=3, n=12)
    np.testing.assert_array_equal(jfm.byzantine, tfm.byzantine)
    kinds_seen = set()
    for wave in range(1, 9):
        for client in range(12):
            for attempt in range(3):
                leaves = _leaves(rng)
                jout, jk = jfm.corrupt(wave, client, leaves, base, attempt)
                tout, tk = tfm.corrupt(wave, client, leaves, base, attempt)
                assert jk == tk
                kinds_seen.update(tk)
                for a, b in zip(jout, tout, strict=True):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert kinds_seen == {"byzantine", "crash", "bitflip", "nan"}


def test_transport_draws_are_jax_draws():
    cfg = dict(transport_drop=0.2, transport_corrupt=0.2,
               transport_delay=0.2, transport_disconnect=0.1)
    jfm = jfaults.FaultModel(JFaultConfig(**cfg), seed=1, n=4)
    tfm = tfaults.FaultModel(TFaultConfig(**cfg), seed=1, n=4)
    frame = bytes(range(64))
    for wave in range(1, 6):
        for pod in range(4):
            for attempt in range(2):
                assert jfm.transport_fault(wave, pod, attempt) == \
                    tfm.transport_fault(wave, pod, attempt)
                assert jfm.corrupt_frame(wave, pod, attempt, frame) == \
                    tfm.corrupt_frame(wave, pod, attempt, frame)


def test_screen_statistics_are_jax_statistics():
    rng = np.random.default_rng(1)
    norms = np.concatenate([rng.normal(5.0, 0.2, 9), [80.0, np.nan,
                                                       np.inf]])
    for sigma in (2.0, 6.0):
        np.testing.assert_array_equal(jfaults.outlier_mask(norms, sigma),
                                      tfaults.outlier_mask(norms, sigma))
    np.testing.assert_array_equal(jfaults.robust_z(norms, 5.0, 0.3),
                                  tfaults.robust_z(norms, 5.0, 0.3))
    a, b = _leaves(rng), _leaves(rng)
    assert jfaults.delta_norm(a, b) == tfaults.delta_norm(a, b)
    a[1][2] = np.nan
    assert jfaults.leaves_finite(a) == tfaults.leaves_finite(a) is False

    js, ts = jfaults.NormScreen(sigma=4.0), tfaults.NormScreen(sigma=4.0)
    for i, nrm in enumerate(np.concatenate([rng.normal(3.0, 0.1, 20),
                                            [40.0, np.nan, 3.05]])):
        assert js.check(i % 2, float(nrm)) == ts.check(i % 2, float(nrm))
    jd, td = js.state_dict(), ts.state_dict()
    assert jd.keys() == td.keys()
    for k in jd:
        np.testing.assert_array_equal(jd[k], td[k])
    back = tfaults.NormScreen(sigma=4.0)
    back.load_state(jd)
    assert back.history == ts.history


def _prototypes():
    """Every prototype the port has: (name, JAX net, port net)."""
    out = [(f"mlp-{norm}", jnets.mlp(3, 4, hidden=(8, 8), norm=norm,
                                     groups=2),
            tnets.mlp(3, 4, hidden=(8, 8), norm=norm, groups=2))
           for norm in ("none", "bn", "gn")]
    out.append(("tiny_transformer",
                jnets.tiny_transformer(11, 3, 5, d_model=8, n_layers=2,
                                       n_heads=2),
                tnets.tiny_transformer(11, 3, 5, d_model=8, n_layers=2,
                                       n_heads=2)))
    return out


def _jax_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@pytest.mark.parametrize("name,jnet,tnet", _prototypes(),
                         ids=[p[0] for p in _prototypes()])
def test_leaf_order_is_jax_order(name, jnet, tnet):
    jtree = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    jpaths = [_jax_key(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jtree)[0]]
    own = tnet.init(torch.Generator().manual_seed(0))
    assert tpt.tree_paths_jax(own) == jpaths
    # the port's insertion order is not JAX's: the walk must sort
    assert list(tpt.tree_flatten(own)) != jpaths or name == "mlp-none"
    ttree = convert.to_torch(jtree)
    for a, b in zip(tpt.tree_leaves_jax(ttree), jax.tree.leaves(jtree),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a crash cut at one flat position zeroes the same tensor entries
    leaves_j = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    leaves_t = [x.numpy() for x in tpt.tree_leaves_jax(ttree)]
    fm_j = jfaults.FaultModel(JFaultConfig(crash_rate=1.0), seed=0, n=2)
    fm_t = tfaults.FaultModel(TFaultConfig(crash_rate=1.0), seed=0, n=2)
    out_j, _ = fm_j.corrupt(1, 0, leaves_j, leaves_j)
    out_t, _ = fm_t.corrupt(1, 0, leaves_t, leaves_t)
    back = tpt.tree_unflatten_jax(ttree, [torch.from_numpy(x)
                                          for x in out_t])
    flat = tpt.tree_flatten(back)
    for path, x in zip(jpaths, out_j, strict=True):
        np.testing.assert_array_equal(flat[path].numpy(), x)


def _stack(rng, k=7, outliers=()):
    s = {"w": rng.normal(size=(k, 5, 3)).astype(np.float32),
         "b": rng.normal(size=(k, 3)).astype(np.float32)}
    for i, v in outliers:
        s["w"][i] = v
        s["b"][i] = v
    return s


def _weights(k):
    return np.arange(1, k + 1, dtype=np.float64) * 10.0


@pytest.mark.parametrize("trim", [1, 2, 3])
def test_trimmed_mean_matches_jax(trim):
    rng = np.random.default_rng(trim)
    s = _stack(rng, outliers=[(1, 1e3), (4, -50.0)])
    # ties between clients: argsort must keep client order in both
    s["b"][2] = s["b"][5]
    w = _weights(7)
    got = tpt.tree_trimmed_mean_stacked(convert.to_torch(s), w, trim)
    want = jpt.tree_trimmed_mean_stacked(s, w, trim)
    for k in s:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="needs K"):
        tpt.tree_trimmed_mean_stacked(convert.to_torch(s), w, 4)


def test_trimmed_mean_trim0_is_fedavg_bitwise():
    s = convert.to_torch(_stack(np.random.default_rng(0)))
    w = _weights(7)
    a = tpt.tree_trimmed_mean_stacked(s, w, 0)
    b = tpt.tree_weighted_mean_stacked(s, w)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_trimmed_mean_masks_nonfinite_in_trim_region():
    rng = np.random.default_rng(2)
    s = _stack(rng, k=5, outliers=[(3, np.nan), (0, -np.inf)])
    w = np.ones(5)
    got = tpt.tree_trimmed_mean_stacked(convert.to_torch(s), w, 1)
    want = jpt.tree_trimmed_mean_stacked(s, w, 1)
    for k in s:
        assert bool(torch.isfinite(got[k]).all())
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [5, 6, 7])
def test_coordinate_median_matches_jax(k):
    rng = np.random.default_rng(k)
    s = _stack(rng, k=k, outliers=[(0, 1e4), (k - 1, -1e4)])
    for w in (np.ones(k), _weights(k)):
        got = tpt.tree_coordinate_median_stacked(convert.to_torch(s), w)
        want = jpt.tree_coordinate_median_stacked(s, w)
        for key in s:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=0,
                                       atol=1e-6)


def _teacher_stack(poison):
    """Four mlp teachers from JAX inits; ``poison`` maps a teacher to
    ``nan`` (one weight), ``inf`` or ``diverged`` (``dense_0/w`` x 1e4)."""
    net = jnets.mlp(2, 3, hidden=(8,))
    params = [jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(k)))
              for k in range(4)]
    for i, kind in poison.items():
        w = np.array(params[i]["dense_0"]["w"])
        if kind == "nan":
            w.reshape(-1)[0] = np.nan
        elif kind == "inf":
            w.reshape(-1)[1] = np.inf
        else:
            w = w * 1e4
        params[i]["dense_0"]["w"] = w
    return net, jax.tree.map(lambda *xs: np.stack(xs), *params)


@pytest.mark.parametrize("poison,kept", [
    ({}, [0, 1, 2, 3]),
    ({1: "nan", 3: "diverged"}, [0, 2]),
    ({0: "inf"}, [1, 2, 3]),
    ({0: "nan", 1: "nan", 2: "inf", 3: "nan"}, []),
])
def test_filter_teacher_stack_matches_jax(poison, kept):
    jnet, stack = _teacher_stack(poison)
    tnet = tnets.mlp(2, 3, hidden=(8,))
    probe = np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32)
    jk, jd = jfeddf.filter_teacher_stack(jnet, stack, probe, sigma=6.0)
    tk, td = tfeddf.filter_teacher_stack(tnet, convert.to_torch(stack),
                                         torch.from_numpy(probe), sigma=6.0)
    assert list(tk) == list(jk) == kept
    assert td == jd == 4 - len(kept)
