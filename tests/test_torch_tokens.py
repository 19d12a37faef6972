"""The paper's token path (Fig. 3's DistilBERT / AG News stand-in) in the
port against the JAX package on the CPU: the ``tokens`` task, its
unlabeled token pool and prototype ladder (numpy, bitwise); the
``tiny_transformer`` forward and parameter gradient, unstacked and
stacked (one shared input, or one input per client), from JAX's init
converted; the token outputs of the ``generator`` and ``noise`` sources
from JAX's draws; and a shrunk ``examples/train_e2e.py`` spec through
both packages' ``Experiment`` on the bank and on the fly.

Tolerances: the transformer's float32 matmuls, softmax and tanh-GELU in
another summation order, 1e-5 absolute on logits and gradients of scale
~1; whole runs at ``test_torch_slice.py``'s bounds (globals within 1e-4,
accuracy within one test example, equal distill steps, bank decisions and
teacher forwards)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import registries as jreg
from repro.core import nets as jnets
from repro.data import distill_sources as jsrc
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import registries as treg
from repro_torch.common.pytree import (tree_flatten, tree_stack,
                                       tree_unflatten)
from repro_torch.core import nets as tnets
from repro_torch.data import distill_sources as tsrc

from test_torch_baselines import assert_tree_close
from test_torch_slice import jax_index_stream, jax_latent_stream
from test_torch_sources import jax_inputs, jax_sample_stream

VOCAB, CLASSES, SEQ = 24, 4, 8


def test_tokens_task_pool_and_ladder_match_jax_bitwise():
    jt = jreg.get_task("tokens")(n_samples=300, seed=1, vocab=VOCAB,
                                 seq_len=SEQ)
    tt = treg.get_task("tokens")(n_samples=300, seed=1, vocab=VOCAB,
                                 seq_len=SEQ)
    np.testing.assert_array_equal(tt.dataset.x, jt.dataset.x)
    np.testing.assert_array_equal(tt.dataset.y, jt.dataset.y)
    assert (tt.distill_shape, tt.vocab, tt.model_kwargs) == \
        (jt.distill_shape, jt.vocab, jt.model_kwargs)
    js = jreg.get_source("unlabeled")(jt, jt.dataset, seed=2, n=50)
    ts = treg.get_source("unlabeled")(tt, tt.dataset, seed=2, n=50,
                                      device="cpu")
    np.testing.assert_array_equal(ts.pool().numpy(), np.asarray(js.pool()))
    assert treg.default_prototype_ladder("tokens") == \
        jreg.default_prototype_ladder("tokens")
    for m in treg.default_prototype_ladder("tokens"):
        net = treg.get_model(m["name"])(tt, **m["params"])
        jnet = jreg.get_model(m["name"])(jt, **m["params"])
        assert net.name == jnet.name
    with pytest.raises(ValueError, match="token task"):
        treg.get_model("tiny_transformer")(
            treg.get_task("blobs")(n_samples=30))


def _nets(n_layers):
    kw = dict(d_model=16, n_layers=n_layers, n_heads=4)
    return (jnets.tiny_transformer(VOCAB, CLASSES, SEQ, **kw),
            tnets.tiny_transformer(VOCAB, CLASSES, SEQ, **kw))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_tiny_transformer_forward_and_grad_match_jax(n_layers):
    jn, tn = _nets(n_layers)
    trees = [jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(i)))
             for i in range(3)]
    rng = np.random.default_rng(n_layers)
    x = rng.integers(0, VOCAB, (5, SEQ)).astype(np.int32)
    xs = rng.integers(0, VOCAB, (3, 5, SEQ)).astype(np.int32)
    r = rng.normal(size=(5, CLASSES)).astype(np.float32)
    # tree names and shapes as JAX's
    tp = tn.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tree_flatten(tp).items()} == {
        k: tuple(v.shape) for k, v in tree_flatten(
            convert.to_torch(trees[0])).items()}

    def jloss(p, xi):      # a mean over the batch, as the training loss
        return jnp.mean(jn.apply(p, jnp.asarray(xi)) * r)

    # unstacked: logits and the gradient of every parameter
    p0 = convert.to_torch(trees[0])
    leaves = {k: v.requires_grad_(True) for k, v in tree_flatten(p0).items()}
    out = tn.apply(tree_unflatten(leaves), torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jn.apply(trees[0], x)), rtol=0,
                               atol=1e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).mean(),
                                list(leaves.values()))
    assert_tree_close(tree_unflatten(dict(zip(leaves, grads))),
                      jax.grad(jloss)(trees[0], x), 1e-5)
    # stacked, one shared input and one input per client
    stack = tree_stack([convert.to_torch(t) for t in trees])
    got = tn.apply(stack, torch.from_numpy(x)).numpy()
    got_k = tn.apply(stack, torch.from_numpy(xs)).numpy()
    for k, t in enumerate(trees):
        np.testing.assert_allclose(got[k], np.asarray(jn.apply(t, x)),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_k[k], np.asarray(jn.apply(t, xs[k])),
                                   rtol=0, atol=1e-5)
    # the stacked gradient: client k's parameters get client k's gradient
    sleaves = {k: v.requires_grad_(True)
               for k, v in tree_flatten(stack).items()}
    out = tn.apply(tree_unflatten(sleaves), torch.from_numpy(xs))
    sgrads = dict(zip(sleaves, torch.autograd.grad(
        (out * torch.from_numpy(r)).mean(dim=(1, 2)).sum(),
        list(sleaves.values()))))
    for k, t in enumerate(trees):
        assert_tree_close(tree_unflatten({p: g[k] for p, g in
                                          sgrads.items()}),
                          jax.grad(jloss)(t, xs[k]), 1e-5)


def test_token_sources_match_jax_with_injected_draws():
    jg = jsrc.GeneratorSource((SEQ,), latent_dim=8, hidden=16, seed=3,
                              std=1.5, discrete_vocab=VOCAB)
    tg = tsrc.GeneratorSource((SEQ,), latent_dim=8, hidden=16, seed=3,
                              std=1.5, discrete_vocab=VOCAB,
                              w1=np.asarray(jg._w1), w2=np.asarray(jg._w2),
                              draws=jax_sample_stream(jg))
    want = jax_inputs(jg, seed=9, batch_size=6, steps=4)
    got = next(tg.input_stream(9, 6, 4))
    assert got.dtype == torch.int64 and got.shape == (4, 6, SEQ)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < len(np.unique(want)) and want.min() >= 0 \
        and want.max() <= VOCAB - 1
    jn = jsrc.RandomNoiseSource((SEQ,), discrete_vocab=VOCAB)
    tn = tsrc.RandomNoiseSource((SEQ,), discrete_vocab=VOCAB,
                                draws=jax_sample_stream(jn))
    want = jax_inputs(jn, seed=4, batch_size=5, steps=3)
    got = next(tn.input_stream(4, 5, 3))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own token draws: seeded, in range, integer
    own = next(tsrc.RandomNoiseSource((SEQ,), discrete_vocab=VOCAB
                                      ).input_stream(1, 64, 2))
    assert own.dtype == torch.int64 and int(own.min()) >= 0 \
        and int(own.max()) < VOCAB
    gen = next(tsrc.GeneratorSource((SEQ,), discrete_vocab=VOCAB
                                    ).input_stream(1, 64, 2))
    assert gen.dtype == torch.int64 and int(gen.max()) < VOCAB


def e2e_spec(pkg, source: str):
    """``examples/train_e2e.py``'s FedDF spec, shrunk: 600 samples, 4
    clients, one layer, 2 rounds."""
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="tokens", n_samples=600,
                          params={"vocab": VOCAB, "seq_len": SEQ}),
        partition=pkg.PartitionSpec(n_clients=4, alpha=1.0),
        cohort=pkg.CohortSpec(prototypes=[pkg.ModelSpec(
            "tiny_transformer", {"d_model": 16, "n_layers": 1})]),
        strategy=pkg.StrategySpec(name="feddf", fusion=pkg.FusionSpec(
            max_steps=40, patience=20, eval_every=20, batch_size=32)),
        source=pkg.SourceSpec(
            name=source, params={"n": 300} if source == "unlabeled"
            else {"latent_dim": 8}),
        rounds=2, client_fraction=1.0, local_epochs=2, local_batch_size=32,
        local_lr=0.05, local_optimizer="adam", seed=3)


@pytest.mark.parametrize("source,want_bank", [("unlabeled", "bank"),
                                              ("generator", "on_the_fly")])
def test_tiny_train_e2e_matches_jax(source, want_bank, monkeypatch):
    from repro_torch.api import experiment as texp
    jspec = e2e_spec(japi, source)
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = convert.to_torch(jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(jspec.seed))))
    streams = {"index_stream": jax_index_stream(300)}
    if source == "generator":
        jsource = japi.build_source(jspec, bundle,
                                    japi.build_splits(jspec, bundle)[0])

        def source_with_jax_weights(spec, bundle, train, device):
            return tsrc.GeneratorSource(
                (SEQ,), latent_dim=8, hidden=jsource.hidden,
                mean=jsource.mean, std=jsource.std, discrete_vocab=VOCAB,
                device=device, w1=np.asarray(jsource._w1),
                w2=np.asarray(jsource._w2))
        monkeypatch.setattr(texp, "build_source", source_with_jax_weights)
        streams = {"draw_stream": jax_latent_stream(8)}
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(init_globals=[init],
                                                    **streams)
    n_test = int(600 * 0.2)
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        assert tl.bank == jl.bank == want_bank
        assert tl.distill_steps == jl.distill_steps
        assert tl.teacher_forwards == jl.teacher_forwards
        assert tl.n_participants == jl.n_participants == 4
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / n_test + 1e-12
    assert_tree_close(tres.global_params[0], jres.global_params[0], 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8",
                                        "fp8_e4m3"])
def test_k1_at_the_token_path_shape_matches_plain_on_card(dtype_name):
    """K1 at the token path's distill batch of 64 rows over a pool of 4000
    rows of 4 classes (``examples/train_e2e.py``), against its plain
    version, two launches equal bit for bit."""
    from test_torch_ablations import _card_with_nvcc
    from test_torch_kernels import check_k1_on_card
    why = _card_with_nvcc()
    if why:
        pytest.skip(why)
    check_k1_on_card(64, 4000, 4, dtype_name)
