"""K2 over vocabulary shards (K2s and its combine, ``kernels/ref.py`` and
``kernels/ops.ensemble_kl_loss_split``) against whole K2 and the JAX
package, on the CPU.

A row set's columns are cut into 2, 3 and 4 chunks (ragged where the cut
does not divide); each chunk's plain statistics (``ref.kl_partial``) are
merged (``ref.kl_combine``: the max over chunks, the rescaled sums) and
finished, and held against the plain whole K2 (``ref.ensemble_kl``) and
JAX's (``repro.kernels.ref.ensemble_kl``, and the Pallas kernel in
interpret mode for bfloat16 teachers, whose quotient JAX's reference
does not round) at K2's tolerances, the JAX package's own
(``tests/test_kernels.py``): forward rtol 1e-5 / atol 1e-6, gradient
rtol 1e-4 / atol 1e-7.  The gradient is the plain K2b
(``ref.ensemble_kl_bwd``) on each chunk's columns fed the merged
log-sum-exps, concatenated.  On a one-rank world the autograd function
(``ops.ensemble_kl_loss_split``) gives the whole loss and its gradient,
scaled by the global row count it is given.  The ``gpu`` test holds the
CUDA K2s against its plain version on the card (skipping without one);
JAX is imported inside the tests that use it, so this file also loads
where only PyTorch is installed.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
DTYPES = ("float32", "bfloat16")


def _case(k, b, v, dtype_name, seed=0):
    rng = np.random.default_rng(seed + 31 * k + v)
    student = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    t = torch.from_numpy((rng.normal(size=(k, b, v)) * 3).astype(np.float32))
    return torch.from_numpy(student), t.to(getattr(torch, dtype_name))


def _split_loss_and_grad(s, t, temp, parts):
    """The loss and the gradient from ``parts`` column chunks' statistics,
    merged in one process."""
    cols = torch.tensor_split(torch.arange(s.shape[1]), parts)
    stats = [ref.kl_partial(s[:, c], t[:, :, c], temp) for c in cols]
    kl, lse_t, lse_s = ref.kl_combine(stats)
    g = torch.ones(())
    grad = torch.cat([ref.ensemble_kl_bwd(s[:, c], t[:, :, c], lse_t, lse_s,
                                          g, temp) for c in cols], dim=1)
    return float(kl.mean() * temp ** 2), grad


@functools.lru_cache(maxsize=None)
def _jax_ref(k, b, v, temp, dtype_name):
    """JAX's loss and gradient: its plain reference, or the Pallas kernel
    in interpret mode where a bfloat16 quotient by T rounds."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ensemble_kl import ensemble_kl as jkernel
    s, t = _case(k, b, v, dtype_name)
    s_j = jnp.asarray(s.numpy())
    t_j = jnp.asarray(t.float().numpy()).astype(jnp.dtype(dtype_name))
    if dtype_name == "float32" or temp == 1.0:
        fn = lambda x: jref.ensemble_kl(x, t_j, temp)
    else:
        fn = lambda x: jkernel(x, t_j, temp, 8, True)
    loss, grad = jax.value_and_grad(fn)(s_j)
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("temp", [1.0, 2.5])
@pytest.mark.parametrize("parts", [2, 3, 4])
@pytest.mark.parametrize("k,b,v", [(4, 5, 7), (2, 3, 2101)])
def test_split_k2_combines_to_whole_k2_and_jax(k, b, v, parts, temp,
                                               dtype_name):
    s, t = _case(k, b, v, dtype_name)
    loss, grad = _split_loss_and_grad(s, t, temp, parts)
    s_p = s.clone().requires_grad_()
    want = ref.ensemble_kl(s_p, t, temp)
    (g_want,) = torch.autograd.grad(want, s_p)
    np.testing.assert_allclose(loss, float(want.detach()), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(grad.numpy(), g_want.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    j_loss, j_grad = _jax_ref(k, b, v, temp, dtype_name)
    np.testing.assert_allclose(loss, j_loss, rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("n_rows", [None, 20])
def test_split_loss_on_one_rank_is_whole_k2_over_the_global_rows(n_rows):
    """On a one-rank world the autograd function's merge is the identity:
    the loss is whole K2 times B / n_rows, its gradient too, and no kernel
    launches for CPU tensors."""
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.launch import mesh as tmesh
    s, t = _case(3, 5, 40, "float32")
    before = dict(k2.LAUNCHES)
    with tmesh.one_rank_world("cpu"):
        mesh = tmesh.make_mesh((1, 1), ("data", "model"))
        s_k = s.clone().requires_grad_()
        got = ops.ensemble_kl_loss_split(s_k, t, mesh, "model", n_rows, 2.0)
        (g_got,) = torch.autograd.grad(got, s_k)
    assert k2.LAUNCHES == before
    scale = 1.0 if n_rows is None else 5 / n_rows
    s_p = s.clone().requires_grad_()
    want = ref.ensemble_kl(s_p, t, 2.0) * scale
    (g_want,) = torch.autograd.grad(want, s_p)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(g_got.numpy(), g_want.numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA only
        k2.kl_fwd_split(s, t, 2.0)


# path 17's vocabulary shards: zamba2's 32000 and qwen3-8b's 151936 over
# two ranks, a small odd V_loc, and a ragged cluster of 8
CARD_SHAPES = ((4, 64, 3), (4, 1024, 16000), (4, 256, 75968), (3, 7, 2501),
               (2, 1, 5003))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_cuda_split_k2_matches_plain_on_card(dtype_name):
    """K2s's planes finish to the plain version's rows; chunks of 2 and 4
    merged give whole K2f's loss and, through K2b, its gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    from repro_torch.kernels import ensemble_kl as k2
    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype_name)
    g1 = torch.ones((), device="cuda")
    for k, b, v in CARD_SHAPES:
        s = (torch.randn(b, v, generator=gen) * 3).cuda()
        t = (torch.randn(k, b, v, generator=gen) * 3).to(dt).cuda()
        before = k2.LAUNCHES["ensemble_kl_split_fwd"]
        got = ref.kl_combine([k2.kl_fwd_split(s, t)])
        want = ref.kl_combine([ref.kl_partial(s, t)])
        torch.cuda.synchronize()
        assert k2.LAUNCHES["ensemble_kl_split_fwd"] == before + 1
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                       rtol=FWD_RTOL, atol=FWD_ATOL)
        kl, lse_t, lse_s = k2.kl_fwd(s, t)
        ds = k2.kl_bwd(s, t, lse_t, lse_s, g1)
        for parts in (p for p in (2, 4) if p <= v):
            cols = torch.tensor_split(torch.arange(v, device="cuda"), parts)
            chunks = [(s[:, c].contiguous(), t[:, :, c].contiguous())
                      for c in cols]
            m_kl, m_lt, m_ls = ref.kl_combine([k2.kl_fwd_split(*c)
                                               for c in chunks])
            np.testing.assert_allclose(float(m_kl.mean()), float(kl.mean()),
                                       rtol=FWD_RTOL, atol=FWD_ATOL)
            m_ds = torch.cat([k2.kl_bwd(*c, m_lt, m_ls, g1)
                              for c in chunks], dim=1)
            np.testing.assert_allclose(m_ds.cpu().numpy(), ds.cpu().numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
