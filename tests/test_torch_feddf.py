"""The port's ``distill`` (logit-bank mode) against the JAX package's,
with the JAX key chain's distill indices injected into the port through
``UnlabeledDataset(indices=...)``.

Tolerance: float32 forwards, the KL and Adam run in another summation
order; over 60-80 Adam steps the student's weights agree to 2e-5
absolute, and the discrete early-stopping trace (validation accuracies,
best step, step count) must agree exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feddf as jfeddf
from repro.core import nets as jnets
from repro.data.distill_sources import UnlabeledDataset as JSource
from repro.data.synthetic import gaussian_mixture
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten, tree_stack
from repro_torch.core import feddf as tfeddf
from repro_torch.core import nets as tnets
from repro_torch.data.distill_sources import UnlabeledDataset as TSource

ATOL = 2e-5


def jax_index_stream(n_pool):
    """The indices JAX's distill chunk draws: ``key, k1 = split(key)``
    per step from ``PRNGKey(seed)``, then ``sample_indices(k1, b)``."""
    src = JSource(np.zeros((n_pool, 1), np.float32))

    def stream(seed, batch_size, chunk):
        key = jax.random.PRNGKey(seed)
        while True:
            block = []
            for _ in range(chunk):
                key, k1 = jax.random.split(key)
                block.append(np.asarray(src.sample_indices(k1, batch_size)))
            yield np.stack(block)
    return stream


def _setup():
    jn, tn = jnets.mlp(2, 3, (16, 16)), tnets.mlp(2, 3, (16, 16))
    jtrees = [jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(k)))
              for k in range(3)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jtrees)
    tstack = tree_stack([convert.to_torch(t) for t in jtrees])
    pool = np.random.default_rng(7).uniform(-3, 3, (300, 2)).astype(
        np.float32)
    val = gaussian_mixture(200, seed=8)
    return jn, tn, jstack, tstack, pool, val


@pytest.mark.parametrize("fused", ["auto", False])
def test_distill_matches_jax_with_injected_indices(fused):
    jn, tn, jstack, tstack, pool, val = _setup()
    weights = [3.0, 1.0, 2.0]
    fj = jfeddf.FusionConfig(max_steps=80, patience=40, eval_every=20,
                             batch_size=32, temperature=2.0)
    ft = tfeddf.FusionConfig(**{**dataclasses.asdict(fj),
                                "use_fused_kernel": fused})
    jp, jinfo = jfeddf.feddf_fuse_stacked(
        jn, jstack, weights, JSource(pool), fj, jnp.asarray(val.x), val.y,
        seed=5)
    tp, tinfo = tfeddf.feddf_fuse_stacked(
        tn, tstack, weights, TSource(pool, indices=jax_index_stream(300)),
        ft, torch.from_numpy(val.x), torch.from_numpy(val.y), seed=5)
    for k in ("steps", "best_step", "bank_decision", "bank_dtype",
              "bank_nbytes", "teacher_batch_forwards"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["bank_decision"] == "bank"
    assert [s for s, _ in tinfo["val_history"]] == \
        [s for s, _ in jinfo["val_history"]]
    np.testing.assert_allclose([a for _, a in tinfo["val_history"]],
                               [a for _, a in jinfo["val_history"]],
                               rtol=1e-7)
    tflat = tree_flatten(tp)
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(tflat[key].numpy(), np.asarray(v),
                                   rtol=0, atol=ATOL)


def test_default_index_stream_is_device_independent_and_gathers_pool():
    pool = np.arange(40, dtype=np.float32).reshape(20, 2)
    src = TSource(pool)
    a = next(src.index_stream(3, 5, 4))
    b = next(TSource(pool).index_stream(3, 5, 4))
    assert a.shape == (4, 5) and a.dtype == torch.int64
    assert torch.equal(a, b)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    assert torch.equal(src.sample(g1, 6), src.pool()[src.sample_indices(g2,
                                                                          6)])


def test_avg_logits_kl_matches_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(9, 5)).astype(np.float32)
    t = rng.normal(size=(4, 9, 5)).astype(np.float32) * 2
    want = float(jfeddf.avg_logits_kl(jnp.asarray(s), jnp.asarray(t), 1.5))
    got = float(tfeddf.avg_logits_kl(torch.from_numpy(s),
                                     torch.from_numpy(t), 1.5))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def _assert_params_close(tp, jp, atol=ATOL):
    tflat = tree_flatten(tp)
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(tflat[key].numpy(), np.asarray(v),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_paths_without_a_bank_raise(mode):
    """No bank (bank off, or auto skipping a run too short to amortize
    it) is the on-the-fly path: every step runs the teachers on the
    sampled pool rows (kernel K2's plain version on the CPU).  It no
    longer raises; it matches the JAX package's on-the-fly distill, step
    count, bank decision and teacher-forward count exactly."""
    jn, tn, jstack, tstack, pool, val = _setup()
    # batch 4 x (earliest stop 40 steps) < 300 pool rows: auto skips
    fj = jfeddf.FusionConfig(max_steps=40, patience=20, eval_every=20,
                             batch_size=4, temperature=2.0,
                             logit_bank=mode)
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    jp, jinfo = jfeddf.feddf_fuse_stacked(
        jn, jstack, [1.0, 2.0, 1.0], JSource(pool), fj, jnp.asarray(val.x),
        val.y, seed=3)
    tp, tinfo = tfeddf.feddf_fuse_stacked(
        tn, tstack, [1.0, 2.0, 1.0],
        TSource(pool, indices=jax_index_stream(300)), ft,
        torch.from_numpy(val.x), torch.from_numpy(val.y), seed=3)
    want = "on_the_fly" if mode == "off" else "skipped_small_run"
    assert tinfo["bank_decision"] == jinfo["bank_decision"] == want
    for k in ("steps", "best_step", "logit_bank", "bank_nbytes",
              "teacher_batch_forwards"):
        assert tinfo[k] == jinfo[k], k
    assert tinfo["teacher_batch_forwards"] == tinfo["steps"] * 3
    assert [s for s, _ in tinfo["val_history"]] == \
        [s for s, _ in jinfo["val_history"]]
    _assert_params_close(tp, jp)
