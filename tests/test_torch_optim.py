"""The port's functional optimizers and schedules against the JAX
package's, fed the same gradient sequence (made with numpy).

Tolerance: both run float32 with the same operation order; the schedule
and bias-correction scalars are computed on the host in the port and on
the device in JAX, which may round the last bit apart, so parameters may
drift by a few float32 ulps over the run (rtol 1e-6, atol 1e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsch
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsch


def test_cosine_and_constant_schedules():
    js, ts = jsch.cosine(1e-3, 500), tsch.cosine(1e-3, 500)
    for step in (0, 1, 7, 250, 499, 500, 600):
        assert ts(step) == pytest.approx(float(js(jnp.int32(step))),
                                         rel=1e-6, abs=1e-12)
    assert tsch.constant(0.05)(3) == float(jsch.constant(0.05)(3))


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_update_sequences_match(kind):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), (2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 10.0 ** rng.integers(
        -3, 1) for s in shapes] for _ in range(25)]
    if kind == "sgd":
        jo, to = jopt.sgd(0.05), topt.sgd(0.05)
    else:
        jo = jopt.adam(jsch.cosine(1e-3, 25))
        to = topt.adam(tsch.cosine(1e-3, 25))
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        jg = {str(i): jnp.asarray(x) for i, x in enumerate(g)}
        jd, js = jo.update(jg, js, jp, jnp.int32(step))
        jp = jopt.apply_updates(jp, jd)
        td, ts = to.update([torch.from_numpy(x) for x in g], ts, tp, step)
        tp = topt.apply_updates(tp, td)
    for i, t in enumerate(tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[str(i)]),
                                   rtol=1e-6, atol=1e-7)
