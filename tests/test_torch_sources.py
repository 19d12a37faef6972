"""The pool-less distillation sources (paper Fig. 5: generator and noise)
and the other registered sources, against the JAX package.

The JAX sources draw from ``jax.random``, which PyTorch cannot
reproduce, so the JAX decoder weights and the JAX key chain's latents /
uniform samples are injected into the port (``w1=``, ``w2=``,
``draws=``); the decoder then runs in both packages.  Tolerance: float32
matmuls, tanh and the batch std in another summation order, 1e-5
absolute on outputs of scale ~1.5."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.api import registries as jreg
from repro.data import distill_sources as jsrc
from repro.data.synthetic import gaussian_mixture
from repro_torch.api import registries as treg
from repro_torch.data import distill_sources as tsrc


def jax_sample_stream(source):
    """The samples (or, for the generator, the latents) JAX's distill
    chunk draws: ``key, k1 = split(key)`` per step from
    ``PRNGKey(seed)``."""
    def stream(seed, batch_size, chunk):
        key = jax.random.PRNGKey(seed)
        while True:
            block = []
            for _ in range(chunk):
                key, k1 = jax.random.split(key)
                if isinstance(source, jsrc.GeneratorSource):
                    block.append(np.asarray(jax.random.normal(
                        k1, (batch_size, source.latent_dim))))
                else:
                    block.append(np.asarray(source.sample(k1, batch_size)))
            yield np.stack(block)
    return stream


def jax_inputs(source, seed, batch_size, steps):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(source.sample(k1, batch_size)))
    return np.stack(out)


@pytest.mark.parametrize("shape,mean,std", [((2,), 0.0, 1.5),
                                            ((3, 4), 0.5, 1.0)])
def test_generator_matches_jax_with_injected_weights_and_latents(
        shape, mean, std):
    js = jsrc.GeneratorSource(shape, latent_dim=8, hidden=16, seed=3,
                              mean=mean, std=std)
    ts = tsrc.GeneratorSource(shape, latent_dim=8, hidden=16, seed=3,
                              mean=mean, std=std, w1=np.asarray(js._w1),
                              w2=np.asarray(js._w2),
                              draws=jax_sample_stream(js))
    want = jax_inputs(js, seed=9, batch_size=6, steps=4)
    got = next(ts.input_stream(9, 6, 4))
    assert got.shape == (4, 6) + shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the population std over each batch (ddof 0), as jnp.std
    z = np.std((got.numpy().reshape(4, 6, -1) - mean) / std, axis=(1, 2))
    np.testing.assert_allclose(z, 1.0, rtol=1e-5)
    assert ts.pool() is None


def test_noise_matches_jax_with_injected_draws():
    js = jsrc.RandomNoiseSource((2,), low=-2.0, high=4.0)
    ts = tsrc.RandomNoiseSource((2,), low=-2.0, high=4.0,
                                draws=jax_sample_stream(js))
    want = jax_inputs(js, seed=4, batch_size=5, steps=3)
    got = next(ts.input_stream(4, 5, 3))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ts.pool() is None


def test_own_draws_are_seeded_device_independent_and_in_range():
    ts = tsrc.RandomNoiseSource((2,), low=-3.0, high=3.0)
    a = next(ts.input_stream(1, 64, 5))
    b = next(tsrc.RandomNoiseSource((2,)).input_stream(1, 64, 5))
    assert torch.equal(a, b) and a.shape == (5, 64, 2)
    assert float(a.min()) >= -3.0 and float(a.max()) < 3.0
    g = tsrc.GeneratorSource((2,), seed=2)
    assert torch.equal(g.w1, tsrc.GeneratorSource((2,), seed=2).w1)
    x = next(g.input_stream(0, 64, 2))
    assert x.shape == (2, 64, 2) and bool(torch.isfinite(x).all())
    gen = torch.Generator().manual_seed(0)
    assert g.sample(gen, 7).shape == (7, 2)


def test_token_outputs_and_bad_weights_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tsrc.GeneratorSource((4,), discrete_vocab=10)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tsrc.RandomNoiseSource((4,), discrete_vocab=10)
    with pytest.raises(ValueError, match="decoder weights"):
        tsrc.GeneratorSource((2,), latent_dim=4, hidden=8,
                             w1=np.zeros((4, 9), np.float32))


def test_registries_build_the_same_sources_as_jax():
    jtask = jreg.get_task("blobs")(n_samples=300, seed=0)
    ttask = treg.get_task("blobs")(n_samples=300, seed=0)
    train = gaussian_mixture(120, seed=1)
    for name in ("in_domain", "unlabeled"):
        js = jreg.get_source(name)(jtask, train, seed=2)
        ts = treg.get_source(name)(ttask, train, seed=2, device="cpu")
        np.testing.assert_array_equal(ts.pool().numpy(),
                                      np.asarray(js.pool()))
    jg = jreg.get_source("generator")(jtask, train, seed=2)
    tg = treg.get_source("generator")(ttask, train, seed=2, device="cpu")
    assert isinstance(tg, tsrc.GeneratorSource) and tg.pool() is None
    assert (tg.out_shape, tg.latent_dim, tg.hidden, tg.mean, tg.std) == \
        (jg.out_shape, jg.latent_dim, jg.hidden, jg.mean, jg.std)
    jn = jreg.get_source("noise")(jtask, train, seed=2, low=-1.0)
    tn = treg.get_source("noise")(ttask, train, seed=2, device="cpu",
                                  low=-1.0)
    assert (tn.out_shape, tn.low, tn.high) == (jn.out_shape, jn.low, jn.high)


def test_logit_bank_on_warns_and_falls_back_for_a_poolless_source():
    from repro_torch.core import feddf as tfeddf
    from repro_torch.core import nets as tnets
    from repro_torch.common.pytree import tree_stack
    net = tnets.mlp(2, 3, (8,))
    stack = tree_stack([net.init(torch.Generator().manual_seed(k))
                        for k in range(2)])
    fusion = tfeddf.FusionConfig(max_steps=4, eval_every=2, batch_size=8,
                                 logit_bank="on")
    with pytest.warns(UserWarning, match="no indexable pool"):
        _, info = tfeddf.feddf_fuse_stacked(
            net, stack, [1.0, 1.0], tsrc.RandomNoiseSource((2,)), fusion)
    assert info["bank_decision"] == "on_the_fly"
    assert not info["logit_bank"] and info["steps"] == 4
    assert info["teacher_batch_forwards"] == 4 * 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # auto falls back silently
        fusion.logit_bank = "auto"
        tfeddf.feddf_fuse_stacked(net, stack, [1.0, 1.0],
                                  tsrc.RandomNoiseSource((2,)), fusion)
