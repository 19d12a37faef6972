"""The port's MoE MLPs (``repro_torch.models.moe``) against the JAX package's
``models/moe.py``, at the reduced widths of granite-moe-1b-a400m and
qwen3-moe-235b-a22b (4 experts, top 2), from the same numpy inputs and the
JAX package's init converted (``repro_torch.convert``).

* ``_route``: the expert choices equal JAX's, the weights and the Switch aux
  loss within rtol 1e-5 / atol 1e-6 (float32, the same operations in
  another order).
* ``moe_block`` on both dispatch paths: ``T * k < E`` takes
  ``_moe_gather`` (one token), ``T * k >= E`` takes ``_moe_capacity``; a
  capacity factor of 0.5 drops slots, and the port drops exactly the
  (token, slot) choices JAX's sort-based dispatch drops (the latest tokens
  of each overfull expert).  Block outputs within rtol 1e-5 plus 1e-6 of
  the largest output: the expert weights take their fan-in from the expert
  axis (JAX's ``ParamSpec``), so outputs reach ~1e2 and float32 sums that
  cancel to ~1 keep an absolute error set by that scale (~1e-4).
* The whole model (forward with its aux loss, prefill and two teacher-forced
  decode steps at batch 1, which decodes through gather, and at batch 2,
  which decodes through capacity) against JAX within rtol 2e-3 plus 1e-3
  of the largest logit (``tests/test_torch_serve.py``'s tolerance).
* ``moe_block`` on a mesh (JAX's expert-parallel shard_map and its
  partitioner path): ``tests/test_torch_model_axis.py`` and
  ``tests/test_torch_moe_mesh.py``.

JAX is imported inside the tests that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.models import moe
from repro_torch.models import transformer as T

EXACT = dict(rtol=1e-5, atol=1e-6)
CROSS_RTOL, CROSS_ATOL_REL = 2e-3, 1e-3
MOE_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")


def _close(got, want, tol=EXACT):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _block_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _cross_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=CROSS_RTOL,
                               atol=CROSS_ATOL_REL * np.abs(want).max())


def _cfgs(name, **over):
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    return (jreduced(jconfigs.get(name), **over),
            reduced(configs.get(name), **over))


def _moe_params(cfg_j, seed):
    import jax
    from repro.models import layers as jlayers
    from repro.models import moe as jmoe
    from repro_torch.convert import to_torch
    pj = jlayers.init_params(jmoe.moe_specs(cfg_j), jax.random.PRNGKey(seed))
    return pj, to_torch(jax.tree.map(np.asarray, pj))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_dropped(idx: np.ndarray, n_experts: int, cap: int) -> set:
    """The (token, slot) choices JAX's dispatch drops: within each expert,
    the choices in flat (token, slot) order past the first ``cap``."""
    seen = [0] * n_experts
    dropped = set()
    for tok, slots in enumerate(idx):
        for slot, e in enumerate(slots):
            seen[e] += 1
            if seen[e] > cap:
                dropped.add((tok, slot))
    return dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax(arch):
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg_j, cfg_t = _cfgs(arch)
    pj, pt = _moe_params(cfg_j, 0)
    x = _x((37, cfg_j.d_model), 1)
    wj, ij, aj = jmoe._route(pj, cfg_j, jnp.asarray(x))
    wt, it, at = moe._route(pt, cfg_t, torch.from_numpy(x))
    assert it.dtype == torch.int64 and tuple(it.shape) == (37, cfg_t.top_k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(wt, wj)
    _close(at, aj)
    assert wt.dtype == torch.float32 and at.dtype == torch.float32


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("b,s", [(1, 1), (2, 1), (1, 2), (3, 7)])
def test_moe_block_both_dispatch_paths_match_jax(arch, b, s):
    """One token (T k = 2 < E = 4) gathers; two or more take the capacity
    dispatch at the published capacity factor 1.25."""
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg_j, cfg_t = _cfgs(arch)
    assert (b * s * cfg_t.top_k < cfg_t.n_experts) == (b * s == 1)
    pj, pt = _moe_params(cfg_j, 2)
    x = _x((b, s, cfg_j.d_model), 3)
    oj, aj = jmoe.moe_block(pj, cfg_j, jnp.asarray(x))
    ot, at = moe.moe_block(pt, cfg_t, torch.from_numpy(x))
    assert tuple(ot.shape) == (b, s, cfg_t.d_model)
    _block_close(ot, oj)
    _close(at, aj)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_drops_the_slots_jax_drops(arch):
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    cfg_j, cfg_t = _cfgs(arch, capacity_factor=0.5)
    pj, pt = _moe_params(cfg_j, 4)
    x = _x((40, cfg_j.d_model), 5)
    wj, ij, _ = jmoe._route(pj, cfg_j, jnp.asarray(x))
    w, idx, _ = moe._route(pt, cfg_t, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    cap = moe.capacity(cfg_t, 40)
    assert cap == 10        # ceil(40 * 2 / 4 * 0.5)
    want = _jax_dropped(np.asarray(ij), cfg_t.n_experts, cap)
    assert 0 < len(want) < 40 * cfg_t.top_k
    dp = moe.dispatch(cfg_t, idx, 0, cfg_t.n_experts)
    flat = dp.order[~dp.valid]
    got = {(int(f) // cfg_t.top_k, int(f) % cfg_t.top_k) for f in flat}
    assert got == want
    # kept slots fill each expert's buffer from 0 in token order
    for e in range(cfg_t.n_experts):
        slots = dp.p_idx[dp.valid & (dp.e_idx == e)]
        assert slots.tolist() == list(range(len(slots)))
    _block_close(moe._moe_capacity(pt, cfg_t, torch.from_numpy(x), w, idx,
                                   0, cfg_t.n_experts),
                 jmoe._moe_capacity(pj, cfg_j, jnp.asarray(x), wj, ij, 0,
                                    cfg_j.n_experts))
    # a dropped choice contributes nothing: the tokens whose every slot
    # dropped come out as zeros
    all_dropped = [t for t in range(40)
                   if all((t, k) in want for k in range(cfg_t.top_k))]
    out = moe._moe_capacity(pt, cfg_t, torch.from_numpy(x), w, idx, 0,
                            cfg_t.n_experts)
    for t in all_dropped:
        assert not out[t].any()


def test_capacity_matches_jax_arithmetic():
    cfg = reduced(configs.get("granite-moe-1b-a400m"))
    full = configs.get("granite-moe-1b-a400m")
    assert moe.capacity(full, 4) == 2          # decode at batch 4
    assert moe.capacity(full, 8000) == 2500    # a 4 x 2000 prefill
    assert moe.capacity(cfg, 1) == 1
    no_drop = dataclasses.replace(full, capacity_factor=full.n_experts
                                  / full.top_k)
    assert moe.capacity(no_drop, 2002) == 2002


def _model_params(cfg_j, seed):
    import jax
    from repro.models import transformer as JT
    from repro_torch.convert import to_torch
    pj = JT.init(cfg_j, jax.random.PRNGKey(seed))
    return pj, to_torch(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("b", [1, 2])
def test_moe_model_matches_jax(arch, b):
    """forward (logits and aux), prefill and two teacher-forced decode
    steps; batch 1 decodes through gather, batch 2 through capacity."""
    import jax.numpy as jnp
    from repro.models import transformer as JT
    cfg_j, cfg_t = _cfgs(arch)
    T.check_supported(cfg_t)
    pj, pt = _model_params(cfg_j, 0)
    s = 24
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (b, s + 2))
    fj, aux_j = JT.forward(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    ft, aux_t = T.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)},
                          return_aux=True)
    _cross_close(ft, fj)
    _close(aux_t, aux_j, dict(rtol=1e-4, atol=1e-6))
    assert float(aux_t) > 0
    assert torch.equal(T.forward(pt, cfg_t,
                                 {"tokens": torch.from_numpy(toks)}), ft)
    lj, cj = JT.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks[:, :s])},
                        max_seq=s + 4)
    lt, ct = T.prefill(pt, cfg_t, {"tokens": torch.from_numpy(toks[:, :s])},
                       max_seq=s + 4)
    _cross_close(lt, lj)
    calls = []
    orig = moe._moe_gather
    moe._moe_gather = lambda *a: calls.append("gather") or orig(*a)
    try:
        for i in range(2):
            step = toks[:, s + i: s + i + 1]
            dj, cj = JT.decode_step(pj, cfg_j, {"tokens": jnp.asarray(step)},
                                    cj, jnp.int32(s + i))
            dt, ct = T.decode_step(pt, cfg_t,
                                   {"tokens": torch.from_numpy(step)}, ct,
                                   s + i)
            _cross_close(dt, dj)
    finally:
        moe._moe_gather = orig
    assert len(calls) == (2 * cfg_t.n_layers if b == 1 else 0)


def test_moe_param_specs_match_jax():
    import jax
    from repro.models import layers as jlayers
    from repro.models import transformer as JT
    for arch in MOE_ARCHS:
        cfg_j, cfg_t = _cfgs(arch)
        sj = jax.tree_util.tree_flatten_with_path(
            JT.param_specs(cfg_j), is_leaf=jlayers.is_spec)[0]
        st = T.param_specs(cfg_t)
        shapes_j = sorted((jax.tree_util.keystr(p), s.shape) for p, s in sj)
        leaves = []

        def walk(t, path):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k], path + f"[{k!r}]")
            elif isinstance(t, (tuple, list)):
                for i, v in enumerate(t):
                    walk(v, path + f"[{i}]")
            else:
                leaves.append((path, t.shape))
        walk(st, "")
        assert sorted(leaves) == shapes_j
