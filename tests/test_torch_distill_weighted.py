"""The port's weighted teacher consensus (kernel K3 on the on-the-fly path,
the weighted logit-bank fold on the bank path), its pool-less on-the-fly
distillation and its divergence guard, against the JAX package.

The JAX key chain's distill indices or noise samples are injected into
the port (``UnlabeledDataset(indices=)``, ``RandomNoiseSource(draws=)``).
Tolerance: float32 forwards, the KL and Adam in another summation order;
over 40-60 Adam steps the student's weights agree to 2e-5 absolute, and
the discrete facts (steps, best step, bank decision, teacher forwards,
the validation trace's steps) exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feddf as jfeddf
from repro.core import logit_bank as jbank
from repro.core import nets as jnets
from repro.data import distill_sources as jsrc
from repro.data.synthetic import gaussian_mixture
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten, tree_stack
from repro_torch.core import feddf as tfeddf
from repro_torch.core import logit_bank as tbank
from repro_torch.core import nets as tnets
from repro_torch.data import distill_sources as tsrc

ATOL = 2e-5
WEIGHTS = np.array([1.0, 0.5, 0.25 ** 0.5])   # (1+s)^-0.5 for s = 0, 3, 1


def jax_stream(draw):
    """Per step ``key, k1 = split(key)`` from ``PRNGKey(seed)``, then
    ``draw(k1, batch_size)``: what JAX's distill chunk samples."""
    def stream(seed, batch_size, chunk):
        key = jax.random.PRNGKey(seed)
        while True:
            block = []
            for _ in range(chunk):
                key, k1 = jax.random.split(key)
                block.append(np.asarray(draw(k1, batch_size)))
            yield np.stack(block)
    return stream


def _setup(poison=False):
    jn, tn = jnets.mlp(2, 3, (16, 16)), tnets.mlp(2, 3, (16, 16))
    jtrees = [jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(k)))
              for k in range(3)]
    student = jtrees[0]
    if poison:  # one teacher uploads NaN weights
        jtrees[2] = jax.tree.map(lambda x: np.full_like(x, np.nan),
                                 jtrees[2])
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jtrees)
    tstack = tree_stack([convert.to_torch(t) for t in jtrees])
    pool = np.random.default_rng(7).uniform(-3, 3, (300, 2)).astype(
        np.float32)
    val = gaussian_mixture(200, seed=8)
    return jn, tn, jstack, tstack, pool, val, student


def _assert_close(tp, jp, atol=ATOL):
    tflat = tree_flatten(tp)
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(tflat[key].numpy(), np.asarray(v),
                                   rtol=0, atol=atol, err_msg=key)


def _fuse(fj, jsource, tsource, weights, seed=5):
    jn, tn, jstack, tstack, pool, vds, _ = _setup()
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    jp, jinfo = jfeddf.feddf_fuse_stacked(
        jn, jstack, [3.0, 1.0, 2.0], jsource(pool), fj, jnp.asarray(vds.x),
        vds.y, seed=seed, teacher_weights=weights)
    tp, tinfo = tfeddf.feddf_fuse_stacked(
        tn, tstack, [3.0, 1.0, 2.0], tsource(pool), ft,
        torch.from_numpy(vds.x), torch.from_numpy(vds.y), seed=seed,
        teacher_weights=weights)
    for k in ("steps", "best_step", "bank_decision", "logit_bank",
              "bank_nbytes", "teacher_batch_forwards", "diverged"):
        assert tinfo[k] == jinfo[k], k
    assert [s for s, _ in tinfo["val_history"]] == \
        [s for s, _ in jinfo["val_history"]]
    _assert_close(tp, jp)
    return tinfo


def _pool_sources():
    idx = jax_stream(jsrc.UnlabeledDataset(
        np.zeros((300, 1), np.float32)).sample_indices)
    return (jsrc.UnlabeledDataset,
            lambda pool: tsrc.UnlabeledDataset(pool, indices=idx))


@pytest.mark.parametrize("fused", ["auto", False])
def test_weighted_on_the_fly_distill_matches_jax(fused):
    """Bank off: the consensus ``tensordot(w, t)`` in PyTorch, then K3's
    plain version on [B, V] rows (``auto``) or the unfused loss."""
    fj = jfeddf.FusionConfig(max_steps=60, patience=40, eval_every=20,
                             batch_size=16, temperature=2.0,
                             logit_bank="off", use_fused_kernel=fused)
    jsource, tsource = _pool_sources()
    info = _fuse(fj, jsource, tsource, WEIGHTS)
    assert info["bank_decision"] == "on_the_fly"
    assert info["teacher_batch_forwards"] == info["steps"] * 3


@pytest.mark.parametrize("weights", [None, WEIGHTS])
def test_poolless_noise_distill_matches_jax(weights):
    """A pool-less source: K2 (uniform) or K3 (weighted) every step, the
    JAX noise samples injected."""
    fj = jfeddf.FusionConfig(max_steps=40, patience=20, eval_every=20,
                             batch_size=16)
    jn = jsrc.RandomNoiseSource((2,))
    info = _fuse(fj, lambda pool: jn,
                 lambda pool: tsrc.RandomNoiseSource(
                     (2,), draws=jax_stream(jn.sample)), weights)
    assert info["bank_decision"] == "on_the_fly"


def test_weighted_bank_fold_matches_jax():
    """A pool source with a bank: the weights fold into the bank rows
    (K1 then gathers them unchanged)."""
    jn, tn, jstack, tstack, pool, _, _ = _setup()
    jfn = jfeddf.make_teacher_logits_fn(jn, jstack)
    tfn = tfeddf.make_teacher_logits_fn(tn, tstack)
    for dtype in ("float32", "int8"):
        jb = jbank.build_logit_bank([jfn], jnp.asarray(pool), chunk_size=128,
                                    dtype=dtype, teacher_weights=WEIGHTS)
        tb = tbank.build_logit_bank([tfn], torch.from_numpy(pool),
                                    chunk_size=128, dtype=dtype,
                                    teacher_weights=WEIGHTS)
        np.testing.assert_allclose(
            tbank.dequantize_rows(tb.logits, tb.scales).numpy(),
            np.asarray(jbank.dequantize_rows(jb.logits, jb.scales)),
            rtol=1e-5, atol=2e-5 if dtype == "float32" else 0.05)
        assert tb.n_teacher_batch_forwards == jb.n_teacher_batch_forwards
    with pytest.raises(ValueError, match="shape"):
        tbank.build_logit_bank([tfn], torch.from_numpy(pool),
                               teacher_weights=[1.0, 2.0])
    fj = jfeddf.FusionConfig(max_steps=60, patience=40, eval_every=20,
                             batch_size=16, temperature=2.0)
    jsource, tsource = _pool_sources()
    info = _fuse(fj, jsource, tsource, WEIGHTS)
    assert info["bank_decision"] == "bank"


def test_avg_logits_kl_and_weight_normalization_match_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(9, 5)).astype(np.float32)
    t = rng.normal(size=(3, 9, 5)).astype(np.float32) * 2
    jw = jfeddf.normalize_teacher_weights(WEIGHTS)
    tw = tfeddf.normalize_teacher_weights(WEIGHTS)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tfeddf.normalize_teacher_weights(None) is None
    with pytest.raises(ValueError, match="positive sum"):
        tfeddf.normalize_teacher_weights([0.0, 0.0])
    want = float(jfeddf.avg_logits_kl(jnp.asarray(s), jnp.asarray(t), 1.5,
                                      teacher_weights=jw))
    got = float(tfeddf.avg_logits_kl(torch.from_numpy(s),
                                     torch.from_numpy(t), 1.5,
                                     teacher_weights=tw))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_teacher_forwards_counter_matches_jax():
    """TEACHER_FORWARDS counts bank builds and on-the-fly chunks alike."""
    fj = jfeddf.FusionConfig(max_steps=40, patience=40, eval_every=20,
                             batch_size=16, logit_bank="off")
    jsource, tsource = _pool_sources()
    counts = []
    for mode in ("off", "on"):
        jbank.TEACHER_FORWARDS.reset()
        tbank.TEACHER_FORWARDS.reset()
        _fuse(dataclasses.replace(fj, logit_bank=mode), jsource, tsource,
              None)
        assert tbank.TEACHER_FORWARDS.count == \
            jbank.TEACHER_FORWARDS.count
        counts.append(tbank.TEACHER_FORWARDS.count)
    assert counts == [40 * 3, 3]   # 40 steps x 3; one 300-row chunk x 3


@pytest.mark.parametrize("have_val", [True, False])
def test_divergence_guard_rolls_back_like_jax(have_val):
    """A NaN teacher makes the student non-finite in the first chunk: with
    the guard on, both packages stop after that chunk and return the
    pre-distill student, flagged ``diverged``."""
    jn, tn, jstack, tstack, pool, vds, student = _setup(poison=True)
    fj = jfeddf.FusionConfig(max_steps=60, patience=40, eval_every=20,
                             batch_size=16, logit_bank="off",
                             divergence_guard=True)
    ft = tfeddf.FusionConfig(**dataclasses.asdict(fj))
    jsource, tsource = _pool_sources()
    vx = (jnp.asarray(vds.x), vds.y) if have_val else (None, None)
    tvx = ((torch.from_numpy(vds.x), torch.from_numpy(vds.y)) if have_val
           else (None, None))
    jp, jinfo = jfeddf.feddf_fuse_stacked(
        jn, jstack, [1.0, 1.0, 1.0], jsource(pool), fj, *vx, seed=1,
        student=student)
    tp, tinfo = tfeddf.feddf_fuse_stacked(
        tn, tstack, [1.0, 1.0, 1.0], tsource(pool), ft, *tvx, seed=1,
        student=convert.to_torch(student))
    assert tinfo["diverged"] is jinfo["diverged"] is True
    assert tinfo["steps"] == jinfo["steps"] == 20
    assert tinfo["val_history"] == jinfo["val_history"] == []
    _assert_close(tp, jp, atol=0)
    # without the guard the port distils on into NaN, as JAX does
    ft.divergence_guard = False
    tp2, tinfo2 = tfeddf.feddf_fuse_stacked(
        tn, tstack, [1.0, 1.0, 1.0], tsource(pool), ft, seed=1,
        student=convert.to_torch(student))
    assert not tinfo2["diverged"] and tinfo2["steps"] == 60
    assert not all(bool(torch.isfinite(v).all())
                   for v in tree_flatten(tp2).values())
