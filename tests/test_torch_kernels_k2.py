"""The port's AVGLOGITS KL against raw teachers (kernel K2) and against
pre-averaged rows (kernel K3), against the JAX package.

On the CPU the port runs the kernels' plain versions
(``repro_torch.kernels.ref``): they are held against the JAX Pallas
kernels in interpret mode (``ensemble_kl(s, t, T, 8, True)``, as
``tests/test_kernels.py`` runs them) and, for float32 teachers, against
the JAX plain reference, with K = 1, 3 and 8, odd B, V on and off the
128 tile and across two 2048-wide V tiles, T = 1 and 2.5, float32 and
bfloat16 teachers.  Tolerances are the JAX package's own
(``tests/test_kernels.py``): forward rtol 1e-5 / atol 1e-6, gradient
rtol 1e-4 / atol 1e-7.  The ``gpu`` test holds the CUDA kernels against
the plain versions on the card and skips without one.

JAX is imported inside the tests that use it, so the file also loads
where only PyTorch is installed (``pytest -m gpu`` on the card's machine).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
DTYPES = ("float32", "bfloat16")


def _case(k, b, v, dtype_name, seed=0):
    """numpy student, teachers stored in ``dtype_name`` (as float32), and
    the JAX teachers of the same stored values."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed + 31 * k + v)
    student = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    t32 = (rng.normal(size=(k, b, v)) * 3).astype(np.float32)
    t_j = jnp.asarray(t32).astype(jnp.dtype(dtype_name))
    stored = np.array(t_j.astype(jnp.float32))
    t_t = torch.from_numpy(stored).to(getattr(torch, dtype_name))
    return student, t_j, t_t


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("temp", [1.0, 2.5])
@pytest.mark.parametrize("k,b,v", [(1, 5, 3), (3, 7, 200), (8, 5, 2100),
                                   (8, 3, 3), (3, 5, 2100)])
def test_plain_k2_matches_jax_kernel(k, b, v, temp, dtype_name):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ensemble_kl import ensemble_kl as jkernel
    student, t_j, t_t = _case(k, b, v, dtype_name)
    s_j = jnp.asarray(student)
    want = float(jkernel(s_j, t_j, temp, 8, True))
    g_want = np.asarray(jax.grad(
        lambda x: jkernel(x, t_j, temp, 8, True))(s_j))

    s_t = torch.from_numpy(student).requires_grad_(True)
    loss = ops.ensemble_kl_loss(s_t, t_t, temp)
    (g,) = torch.autograd.grad(loss, s_t)
    _close(float(loss.detach()), want, FWD_RTOL, FWD_ATOL)
    _close(g.numpy(), g_want, GRAD_RTOL, GRAD_ATOL)
    _close(ref.ensemble_kl_grad(torch.from_numpy(student), t_t,
                                temp).numpy(), g_want, GRAD_RTOL, GRAD_ATOL)
    if dtype_name == "float32":  # the JAX plain reference divides later
        _close(float(loss.detach()),
               float(jref.ensemble_kl(s_j, t_j, temp)), FWD_RTOL, FWD_ATOL)
        _close(g.numpy(), np.asarray(jref.ensemble_kl_grad(s_j, t_j, temp)),
               GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("temp", [1.0, 2.5])
@pytest.mark.parametrize("b,v", [(5, 3), (7, 200), (3, 2100)])
def test_plain_k3_matches_jax_kernel(b, v, temp, dtype_name):
    import jax
    import jax.numpy as jnp
    from repro.kernels.ensemble_kl import ensemble_kl_pre as jkernel
    student, t_j, t_t = _case(1, b, v, dtype_name, seed=5)
    s_j = jnp.asarray(student)
    want = float(jkernel(s_j, t_j[0], temp, 8, True))
    g_want = np.asarray(jax.grad(
        lambda x: jkernel(x, t_j[0], temp, 8, True))(s_j))
    s_t = torch.from_numpy(student).requires_grad_(True)
    loss = ops.ensemble_kl_loss_pre(s_t, t_t[0], temp)
    (g,) = torch.autograd.grad(loss, s_t)
    _close(float(loss.detach()), want, FWD_RTOL, FWD_ATOL)
    _close(g.numpy(), g_want, GRAD_RTOL, GRAD_ATOL)
    # K3 is K2 with one teacher
    assert float(loss.detach()) == float(ref.ensemble_kl(
        torch.from_numpy(student), t_t[:1], temp))


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels import ensemble_kl as k2
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.normal(size=(6, 9)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(4, 6, 9)).astype(np.float32))
    before = dict(k2.LAUNCHES)
    assert float(ops.ensemble_kl_loss(s, t, 2.0)) == \
        float(ref.ensemble_kl(s, t, 2.0))
    assert float(ops.ensemble_kl_loss_pre(s, t[0], 2.0)) == \
        float(ref.ensemble_kl_pre(s, t[0], 2.0))
    assert k2.LAUNCHES == before
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA only
        k2.kl_fwd(s, t, 2.0)
    with pytest.raises(ValueError):
        k2.kl_fwd(s, t[0], 2.0, pre=True)


# each forward mode of kernels/ensemble_kl.py:plan: lane groups, a cluster
# of 8 (one of them ragged) and of 2 per row, one block per row; lane
# groups also with teacher slots left empty in the load template (K = 6
# of 8, heterogeneous FedDF's three nets' teachers; K = 3 of 4, ragged B)
MODE_SHAPES = ((8, 64, 3, 1.0), (5, 37, 5003, 2.5), (1, 7, 3000, 2.5),
               (8, 100, 700, 1.0), (1, 7, 300, 2.5), (2, 160, 1000, 1.0),
               (6, 64, 3, 1.0), (3, 37, 10, 2.5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_cuda_kernels_match_plain_on_card(dtype_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels import ensemble_kl as k2
    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype_name)
    modes = {k2.plan(k, b, v).mode for k, b, v, _ in MODE_SHAPES}
    assert modes == {"lanes", "cluster", "block"}
    for k, b, v, temp in MODE_SHAPES:
        s = torch.randn(b, v, generator=gen) * 3
        t = (torch.randn(k, b, v, generator=gen) * 3).to(dt).cuda()
        for pre in (False, True):
            tt = t[0].contiguous() if pre else t
            plain = ref.ensemble_kl_pre if pre else ref.ensemble_kl
            loss = ops.ensemble_kl_loss_pre if pre else ops.ensemble_kl_loss
            name = "ensemble_kl_pre_fwd" if pre else "ensemble_kl_fwd"
            s_p = s.cuda().requires_grad_(True)
            s_k = s.cuda().requires_grad_(True)
            want = plain(s_p, tt, temp)
            before = k2.LAUNCHES[name]
            got = loss(s_k, tt, temp)
            (g_want,) = torch.autograd.grad(want, s_p)
            (g_got,) = torch.autograd.grad(got, s_k)
            torch.cuda.synchronize()
            assert k2.LAUNCHES[name] == before + 1
            _close(float(got.detach()), float(want.detach()), FWD_RTOL,
                   FWD_ATOL)
            _close(g_got.cpu().numpy(), g_want.cpu().numpy(), GRAD_RTOL,
                   GRAD_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_cuda_kernels_repeat_bit_for_bit(dtype_name):
    """Every merge runs in a fixed order with no atomics: two launches on
    the same inputs give the same bits, in each forward mode and in the
    backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels import ensemble_kl as k2
    gen = torch.Generator().manual_seed(1)
    dt = getattr(torch, dtype_name)
    for k, b, v, temp in MODE_SHAPES:
        s = (torch.randn(b, v, generator=gen) * 3).cuda()
        t = (torch.randn(k, b, v, generator=gen) * 3).to(dt).cuda()
        g = torch.ones((), device="cuda")
        first = k2.kl_fwd(s, t, temp)
        second = k2.kl_fwd(s, t, temp)
        for x, y in zip(first, second):
            assert torch.equal(x, y), (k, b, v)
        ds1 = k2.kl_bwd(s, t, first[1], first[2], g, temp)
        ds2 = k2.kl_bwd(s, t, first[1], first[2], g, temp)
        assert torch.equal(ds1, ds2), (k, b, v)
