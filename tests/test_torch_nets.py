"""The port's ``mlp`` against the JAX package's, from the JAX init
(``jax.random`` cannot be reproduced in PyTorch, so the tree is converted
with ``repro_torch.convert``): logits, gradients and BN statistics.

Tolerance: float32 matmuls summed in different orders by XLA and
PyTorch's CPU kernels; 1e-5 relative / 1e-6 absolute on O(1) logits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import nets as jnets
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten, tree_stack
from repro_torch.core import client as tclient
from repro_torch.core import nets as tnets

RTOL, ATOL = 1e-5, 1e-6


def _nets(norm):
    kw = dict(hidden=(16, 16), norm=norm, groups=4)
    jn, tn = jnets.mlp(2, 3, **kw), tnets.mlp(2, 3, **kw)
    jp = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(1)))
    return jn, tn, jp, convert.to_torch(jp)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("norm", ["none", "bn", "gn"])
def test_mlp_logits_grads_and_stats(norm):
    jn, tn, jp, tp = _nets(norm)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 2)).astype(np.float32)
    y = rng.integers(0, 3, 12)
    for train in (True, False):
        _close(tn.apply(tp, torch.from_numpy(x), train=train),
               jn.apply(jp, jnp.asarray(x), train=train))

    jg = jax.grad(lambda p: jclient.softmax_xent(
        jn.apply(p, jnp.asarray(x)), jnp.asarray(y)))(jp)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tree_flatten(tp).items()}
    from repro_torch.common.pytree import tree_unflatten
    loss = tclient.softmax_xent(tn.apply(tree_unflatten(leaves),
                                         torch.from_numpy(x)),
                                torch.from_numpy(y))
    mask = tn.trainable_mask(tp)
    names = [k for k in leaves if mask[k]]
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    jflat = {"/".join(str(p.key) for p in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    for k, g in zip(names, grads):
        _close(g, jflat[k])
    assert all(("running" in k) != mask[k] for k in mask)

    _, jstats = jn.apply_with_stats(jp, jnp.asarray(x))
    _, tstats = tn.apply_with_stats(tp, torch.from_numpy(x))
    tflat = tree_flatten(tstats)
    for path, v in jax.tree_util.tree_flatten_with_path(jstats)[0]:
        _close(tflat["/".join(str(p.key) for p in path)], v)


def test_stacked_apply_equals_per_client():
    _, tn, _, _ = _nets("bn")
    gen = torch.Generator().manual_seed(0)
    trees = [tn.init(gen) for _ in range(3)]
    stack = tree_stack(trees)
    x = torch.randn(3, 5, 2, generator=gen)
    got, stats = tn.apply_with_stats(stack, x)
    shared = tn.apply(stack, x[0], train=False)
    for k, p in enumerate(trees):
        want, st = tn.apply_with_stats(p, x[k])
        torch.testing.assert_close(got[k], want)
        torch.testing.assert_close(shared[k], tn.apply(p, x[0], train=False))
        torch.testing.assert_close(
            stats["norm_0"]["running_mean"][k], st["norm_0"]["running_mean"])


def test_convert_round_trip_is_exact():
    _, _, jp, tp = _nets("bn")
    back = convert.to_numpy(tp)
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = back
        for p in path:
            node = node[p.key]
        assert node.dtype == v.dtype and np.array_equal(node, v)
