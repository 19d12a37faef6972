"""The port's batched local SGD (all K clients in one program, padded
steps masked) against the JAX package's SEQUENTIAL ``make_local_update``
run client by client on its own unpadded batches.

The sequential path is the reference because the JAX package's batched
path disagrees with it for Adam (ROADMAP.md queue 3); the quickstart trains
with SGD.  Tolerance: float32 matmul sums in another order, compounded
over up to ~30 SGD steps: 2e-5 absolute on O(1) weights.  Under BN it is
2e-4: the dense bias feeding a BN layer has a zero true gradient (pure
rounding noise), and a client whose batch is nearly constant in a feature
divides that noise by sqrt(var + 1e-5), up to ~300x."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import nets as jnets
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import gaussian_mixture
from repro.optim.optimizers import sgd as jsgd
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten
from repro_torch.core import client as tclient
from repro_torch.core import nets as tnets
from repro_torch.optim.optimizers import sgd as tsgd

ATOL = {"none": 2e-5, "bn": 2e-4}


@pytest.mark.parametrize("norm,prox_mu", [("none", 0.0), ("bn", 0.0),
                                          ("none", 0.1)])
def test_batched_local_sgd_matches_sequential(norm, prox_mu):
    ds = gaussian_mixture(500, seed=2)
    parts = dirichlet_partition(ds.y, 5, 0.3, seed=2)[:4]
    seeds = [21, 22, 23, 24]
    xb, yb, mask = tclient.build_batched_batches(ds.x, ds.y, parts, 16, 2,
                                                 seeds)
    assert not mask.all()  # clients of different lengths: padding is hit
    jn, tn = jnets.mlp(2, 3, (16, 16), norm=norm), \
        tnets.mlp(2, 3, (16, 16), norm=norm)
    jp = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(3)))
    tp = convert.to_torch(jp)
    update = tclient.make_batched_local_update(tn, tsgd(0.05),
                                               prox_mu=prox_mu)
    stack = update(tp, torch.from_numpy(xb), torch.from_numpy(yb), tp,
                   torch.from_numpy(mask))
    flat = tree_flatten(stack)
    seq = jclient.make_local_update(jn, jsgd(0.05), prox_mu=prox_mu)
    for k, (idx, s) in enumerate(zip(parts, seeds)):
        bx, by = jclient.build_batches(ds.x[idx], ds.y[idx], 16, 2, seed=s)
        want = seq(jp, jnp.asarray(bx), jnp.asarray(by), jp)
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]:
            key = "/".join(str(p.key) for p in path)
            np.testing.assert_allclose(flat[key][k].numpy(), np.asarray(v),
                                       rtol=0, atol=ATOL[norm])


def test_evaluate_matches_jax():
    ds = gaussian_mixture(1100, seed=4)
    jn, tn = jnets.mlp(2, 3, (8,)), tnets.mlp(2, 3, (8,))
    jp = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(0)))
    got = tclient.evaluate(tn, convert.to_torch(jp), torch.from_numpy(ds.x),
                           torch.from_numpy(ds.y))
    assert got == jclient.evaluate(jn, jp, ds.x, ds.y)
