"""The port's fused logit-bank KL (kernel K1) against the JAX package.

On the CPU the port runs K1's plain version (``repro_torch.kernels.ref``):
it is held against the JAX Pallas kernel in interpret mode and against the
JAX plain reference, for every bank dtype, odd B, V off the 128 tile and
T != 1.  Both packages see the same stored bank rows, made with numpy and
the JAX package's quantizer.  The ``gpu`` tests hold the CUDA kernel
against the plain version on the card, in each forward mode of its launch
plan (lane groups, a cluster of 2, 4 or 8 blocks per row, one block per
row) with two launches equal bit for bit, and check that an index outside
the bank poisons exactly its row with NaN in every mode; they skip without
a card.

JAX is imported inside the tests that use it, so the file also loads where
only PyTorch is installed (``pytest -m gpu`` on the card's machine).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

# Forward: float32 sums over V taken in different orders (online logsumexp
# in the Pallas kernel, log_softmax in PyTorch): 5e-6 absolute as in the
# JAX package's kernel tests, plus 2e-6 of |loss| for the longer rows.
FWD_ATOL, FWD_RTOL = 5e-6, 2e-6
# Backward: one exp per element on each side; values are O(T / B).
BWD_ATOL = 3e-7
DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")
# every forward mode of the launch plan: (mode, blocks per row)
FWD_MODES = (("lanes", 1), ("block", 1), ("cluster", 2), ("cluster", 4),
             ("cluster", 8))


def _case(b, n, v, dtype_name, seed=0):
    """numpy (student, stored rows as float32, scales or None, idx) plus
    the JAX arrays of the same stored rows."""
    import jax.numpy as jnp
    from repro.core.logit_bank import bank_dtype, quantize_rows
    rng = np.random.default_rng(seed)
    student = rng.normal(size=(b, v)).astype(np.float32)
    bank32 = (rng.normal(size=(n, v)) * 3).astype(np.float32)
    idx = rng.integers(0, n, size=b).astype(np.int64)
    if dtype_name in ("int8", "fp8_e4m3"):
        rows_j, scales_j = quantize_rows(jnp.asarray(bank32), dtype_name)
        scales = np.asarray(scales_j)
    else:
        rows_j = jnp.asarray(bank32).astype(bank_dtype(dtype_name))
        scales = None
    rows = np.asarray(rows_j.astype(jnp.float32))
    return student, rows, scales, idx, rows_j


def _torch_rows(rows, dtype_name):
    from repro_torch.core.logit_bank import bank_dtype
    return torch.from_numpy(rows.copy()).to(bank_dtype(dtype_name))


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("b,n,v,temp", [(5, 40, 300, 1.0),
                                        (3, 17, 2100, 2.5),
                                        (7, 30, 3, 2.5)])
def test_plain_k1_matches_jax_kernel_and_ref(b, n, v, temp, dtype_name):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ensemble_kl import ensemble_kl_bank as jkernel
    student, rows, scales, idx, rows_j = _case(b, n, v, dtype_name)
    row_scale = np.ones(b, np.float32) if scales is None else scales[idx]

    s_j, rs_j, idx_j = (jnp.asarray(student), jnp.asarray(row_scale),
                        jnp.asarray(idx.astype(np.int32)))
    want_k = float(jkernel(s_j, rows_j, rs_j, idx_j, temp, True))
    want_r = float(jref.ensemble_kl_bank(s_j, rows_j, rs_j, idx_j, temp))
    g_k = np.asarray(jax.grad(
        lambda x: jkernel(x, rows_j, rs_j, idx_j, temp, True))(s_j))
    g_r = np.asarray(jax.grad(
        lambda x: jref.ensemble_kl_bank(x, rows_j, rs_j, idx_j, temp))(s_j))

    s_t = torch.from_numpy(student).requires_grad_(True)
    sc_t = None if scales is None else torch.from_numpy(scales.copy())
    loss = ops.ensemble_kl_loss_bank(s_t, _torch_rows(rows, dtype_name),
                                     sc_t, torch.from_numpy(idx), temp)
    (g,) = torch.autograd.grad(loss, s_t)
    got = float(loss.detach())
    for want in (want_k, want_r):
        assert abs(got - want) <= FWD_ATOL + FWD_RTOL * abs(want)
    for want in (g_k, g_r):
        assert np.abs(g.numpy() - want).max() <= BWD_ATOL


def test_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import ensemble_kl_bank as k1
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.normal(size=(6, 9)).astype(np.float32))
    bank = torch.from_numpy(rng.normal(size=(20, 9)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 20, 6))
    before = dict(k1.LAUNCHES)
    got = ops.ensemble_kl_loss_bank(s, bank, None, idx, 2.0)
    want = ref.ensemble_kl_bank(s, bank, torch.ones(6), idx, 2.0)
    assert float(got) == float(want)
    assert k1.LAUNCHES == before
    with pytest.raises(ValueError):  # the kernel wrapper takes CUDA only
        k1.bank_kl_fwd(s, bank, None, idx, 2.0)


def test_fused_flag_resolution():
    assert ops.use_fused_kernel("auto", "cpu") is True
    assert ops.use_fused_kernel(False, "cpu") is False
    with pytest.raises(NotImplementedError, match="CUDA tensors only"):
        ops.use_fused_kernel(True, "cpu")
    with pytest.raises(ValueError):
        ops.use_fused_kernel("off", "cpu")
    with pytest.raises(ValueError):
        ops.use_fused_kernel(1, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_cuda_kernel_matches_plain_on_card(dtype_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    from repro_torch.core.logit_bank import bank_dtype, quantize_rows
    from repro_torch.kernels import ensemble_kl_bank as k1
    gen = torch.Generator().manual_seed(0)
    for b, n, v, temp in ((64, 4000, 3, 1.0), (37, 1000, 5003, 2.5),
                          (5, 40, 300, 2.5)):
        s = torch.randn(b, v, generator=gen)
        bank32 = torch.randn(n, v, generator=gen) * 3
        idx = torch.randint(0, n, (b,), generator=gen)
        if dtype_name in ("int8", "fp8_e4m3"):
            rows, scales = quantize_rows(bank32, dtype_name)
        else:
            rows, scales = bank32.to(bank_dtype(dtype_name)), None
        row_scale = torch.ones(b) if scales is None else scales[idx]
        s_p = s.cuda().requires_grad_(True)
        s_k = s.cuda().requires_grad_(True)
        cuda = lambda t: None if t is None else t.cuda()
        want = ref.ensemble_kl_bank(s_p, cuda(rows), cuda(row_scale),
                                    cuda(idx), temp)
        before = dict(k1.LAUNCHES)
        got = ops.ensemble_kl_loss_bank(s_k, cuda(rows), cuda(scales),
                                        cuda(idx), temp)
        (g_want,) = torch.autograd.grad(want, s_p)
        (g_got,) = torch.autograd.grad(got, s_k)
        torch.cuda.synchronize()
        assert k1.LAUNCHES["ensemble_kl_bank_fwd"] == \
            before["ensemble_kl_bank_fwd"] + 1
        assert k1.LAUNCHES["ensemble_kl_bank_bwd"] == \
            before["ensemble_kl_bank_bwd"] + 1
        got, want = float(got.detach()), float(want.detach())
        assert abs(got - want) <= FWD_ATOL + FWD_RTOL * abs(want)
        assert float((g_got - g_want).abs().max()) <= BWD_ATOL


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")


def _card_case(b, n, v, dtype_name, gen):
    """(student, stored rows, scales or None, idx) on the card."""
    from repro_torch.core.logit_bank import bank_dtype, quantize_rows
    s = torch.randn(b, v, generator=gen)
    bank32 = torch.randn(n, v, generator=gen) * 3
    idx = torch.randint(0, n, (b,), generator=gen)
    if dtype_name in ("int8", "fp8_e4m3"):
        rows, scales = quantize_rows(bank32, dtype_name)
    else:
        rows, scales = bank32.to(bank_dtype(dtype_name)), None
    return (s.cuda(), rows.cuda(), None if scales is None else scales.cuda(),
            idx.cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_cuda_kernel_every_mode_matches_plain_on_card(dtype_name):
    """Each forward mode, forced through ``launch=``, against the plain
    version, the flat backward from its statistics too; two launches of
    each equal bit for bit."""
    _needs_card()
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ensemble_kl_bank as k1
    gen = torch.Generator().manual_seed(1)
    g1 = torch.ones((), device="cuda")
    for b, n, v, temp in ((64, 4000, 3, 1.0), (6, 50, 33, 2.5),
                          (3, 40, 300, 2.5), (37, 1000, 5003, 1.0)):
        s, rows, scales, idx = _card_case(b, n, v, dtype_name, gen)
        row_scale = (torch.ones(b, device="cuda") if scales is None
                     else scales[idx])
        s_p = s.clone().requires_grad_(True)
        want = ref.ensemble_kl_bank(s_p, rows, row_scale, idx, temp)
        (g_want,) = torch.autograd.grad(want, s_p)
        want = float(want.detach())
        for mode, c in FWD_MODES:
            p = k2.plan_in_mode(1, b, v, mode, c)
            f1 = k1.bank_kl_fwd(s, rows, scales, idx, temp, launch=p)
            f2 = k1.bank_kl_fwd(s, rows, scales, idx, temp, launch=p)
            d1 = k1.bank_kl_bwd(s, rows, scales, idx, f1[1], f1[2], g1, temp)
            d2 = k1.bank_kl_bwd(s, rows, scales, idx, f1[1], f1[2], g1, temp)
            torch.cuda.synchronize()
            got = float(f1[0].sum() / b * temp ** 2)
            where = (b, n, v, mode, c)
            assert abs(got - want) <= FWD_ATOL + FWD_RTOL * abs(want), where
            assert float((d1 - g_want).abs().max()) <= BWD_ATOL, where
            assert all(torch.equal(x, y) for x, y in zip(f1, f2)), where
            assert torch.equal(d1, d2), where


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("mode,v", [("lanes", 3), ("block", 300),
                                    ("cluster", 5003)])
def test_cuda_kernel_poisons_out_of_range_rows_on_card(mode, v, dtype_name):
    """Rows 2 (index N) and 5 (index -1) of 7 come out NaN in kl, lse_t,
    lse_s and all of ds; every other row keeps the bits of a run with valid
    indices, and the launch returns (a cluster or a warp whose row is
    poisoned still meets every barrier and shuffle)."""
    _needs_card()
    from repro_torch.kernels import ensemble_kl_bank as k1
    b, n, temp = 7, 50, 2.5
    s, rows, scales, idx = _card_case(b, n, v, dtype_name,
                                      torch.Generator().manual_seed(2))
    assert k1.plan(b, v).mode == mode
    bad = idx.clone()
    bad[2], bad[5] = n, -1
    g1 = torch.ones((), device="cuda")
    good = k1.bank_kl_fwd(s, rows, scales, idx, temp)
    got = k1.bank_kl_fwd(s, rows, scales, bad, temp)
    ds_good = k1.bank_kl_bwd(s, rows, scales, idx, good[1], good[2], g1, temp)
    ds = k1.bank_kl_bwd(s, rows, scales, bad, got[1], got[2], g1, temp)
    torch.cuda.synchronize()
    poisoned = torch.zeros(b, dtype=torch.bool, device="cuda")
    poisoned[[2, 5]] = True
    for x, y in zip(got, good):
        assert torch.equal(torch.isnan(x), poisoned)
        assert torch.equal(x[~poisoned], y[~poisoned])
    assert bool(torch.isnan(ds[poisoned]).all())
    assert torch.equal(ds[~poisoned], ds_good[~poisoned])


def check_k1_on_card(b, n, v, dtype_name, temps=(1.0, 2.5)):
    """K1 through ``ops`` against its plain version on the card at one
    shape, each launch counted once; two launches of each kernel equal bit
    for bit.  Shared by the shapes later paths give K1."""
    from repro_torch.kernels import ensemble_kl_bank as k1
    gen = torch.Generator().manual_seed(b + v)
    s, rows, scales, idx = _card_case(b, n, v, dtype_name, gen)
    row_scale = (torch.ones(b, device="cuda") if scales is None
                 else scales[idx])
    for temp in temps:
        s_p = s.clone().requires_grad_(True)
        s_k = s.clone().requires_grad_(True)
        want = ref.ensemble_kl_bank(s_p, rows, row_scale, idx, temp)
        before = dict(k1.LAUNCHES)
        got = ops.ensemble_kl_loss_bank(s_k, rows, scales, idx, temp)
        (g_want,) = torch.autograd.grad(want, s_p)
        (g_got,) = torch.autograd.grad(got, s_k)
        torch.cuda.synchronize()
        for name in ("ensemble_kl_bank_fwd", "ensemble_kl_bank_bwd"):
            assert k1.LAUNCHES[name] == before[name] + 1
        got, want = float(got.detach()), float(want.detach())
        assert abs(got - want) <= FWD_ATOL + FWD_RTOL * abs(want)
        assert float((g_got - g_want).abs().max()) <= BWD_ATOL
        g1 = torch.ones((), device="cuda")
        f1 = k1.bank_kl_fwd(s, rows, scales, idx, temp)
        f2 = k1.bank_kl_fwd(s, rows, scales, idx, temp)
        assert all(torch.equal(x, y) for x, y in zip(f1, f2))
        assert torch.equal(
            k1.bank_kl_bwd(s, rows, scales, idx, f1[1], f1[2], g1, temp),
            k1.bank_kl_bwd(s, rows, scales, idx, f1[1], f1[2], g1, temp))
