"""The port's attention (kernel K4) and SSD scan (kernel K5) against the JAX
package.

On the CPU the port runs the kernels' plain versions
(``repro_torch.kernels.ref``): they are held against the JAX package's
plain references (``repro.kernels.ref``) and against its Pallas kernels in
interpret mode (``swa_attn_pallas`` / ``ssd_scan_pallas``, as
``tests/test_kernels.py`` runs them), at that file's cases, from the same
numpy inputs.  Tolerances are the JAX package's own
(``tests/test_kernels.py``): rtol 1e-4 / atol 1e-5 in float32, 3e-2 in
bfloat16.  The ``gpu`` tests hold the CUDA kernels against the plain
versions on the card and skip without one.

JAX is imported inside the tests that use it, so the file also loads
where only PyTorch is installed (``pytest -m gpu`` on the card's machine).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 3e-2

# (b, h, s, d, window, pallas block): tests/test_kernels.py SWA_CASES
SWA_CASES = [
    (1, 2, 64, 16, 16, 16), (2, 2, 64, 16, None, 16), (1, 1, 100, 8, 24, 16),
    (2, 4, 128, 32, 32, 32), (1, 2, 48, 16, 200, 16), (1, 1, 16, 8, 4, 8),
]
# (b, s, h, p, n, chunk): tests/test_kernels.py SSD_CASES
SSD_CASES = [(2, 32, 4, 16, 8, 8), (1, 50, 3, 8, 16, 16),
             (2, 64, 8, 16, 8, 32), (1, 17, 2, 8, 4, 8)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _qkv(b, h, s, d, seed=0):
    rng = np.random.default_rng(seed + s + d)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _ssd_inputs(b, s, h, p, n, seed=0):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed + s + n)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(b, s, h)))) * 0.1).astype(
        np.float32)
    a_log = (rng.normal(size=(h,)) * 0.5).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    return x, dt, a_log, bm, cm


@pytest.mark.parametrize("b,h,s,d,w,blk", SWA_CASES)
def test_swa_plain_matches_jax_ref_and_pallas(b, h, s, d, w, blk):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.swa_attn import swa_attn_pallas
    q, k, v = _qkv(b, h, s, d)
    got = ref.swa_attn(*map(torch.from_numpy, (q, k, v)), w).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jref.swa_attn(jq, jk, jv, w))
    _close(got, swa_attn_pallas(jq, jk, jv, w, block=blk))
    # the dispatch takes the plain version for CPU tensors
    _close(ops.swa_attention(*map(torch.from_numpy, (q, k, v)), w), got,
           0, 0)


def test_swa_bf16_matches_jax():
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.swa_attn import swa_attn_pallas
    q, k, v = _qkv(1, 2, 32, 16)
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32))).to(
        torch.bfloat16) for t in (jq, jk, jv))
    got = ref.swa_attn(tq, tk, tv, 8)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    _close(got, jref.swa_attn(jq, jk, jv, 8).astype(jnp.float32), BF16_TOL,
           BF16_TOL)
    _close(got, swa_attn_pallas(jq, jk, jv, 8, block=8).astype(jnp.float32),
           BF16_TOL, BF16_TOL)


def test_swa_window_restricts_reads():
    """Windowed output differs from full causal once S > window; the first
    ``window`` queries see the same keys."""
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 64, 8))
    full, win = ref.swa_attn(q, k, v, None), ref.swa_attn(q, k, v, 8)
    assert not torch.allclose(full, win, atol=1e-3)
    _close(full[:, :, :8], win[:, :, :8], 0, 1e-6)


@pytest.mark.parametrize("b,s,h,p,n,q", SSD_CASES)
def test_ssd_plain_matches_jax_ref_and_pallas(b, s, h, p, n, q):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan_pallas
    from repro.models.ssm import ssd_chunked
    args = _ssd_inputs(b, s, h, p, n)
    y, final = ref.ssd_scan(*map(torch.from_numpy, args), q)
    assert final.shape == (b, h, n, p) and final.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in args]
    _close(y, jref.ssd_scan(*jargs, q))
    _, want_final = ssd_chunked(*jargs, q)
    _close(final, want_final)
    _close(y, ssd_scan_pallas(*jargs, chunk=q, block_h=2))
    _close(y, jref.ssd_scan_sequential(*jargs))
    seq = ref.ssd_scan_sequential(*map(torch.from_numpy, args))
    _close(seq, jref.ssd_scan_sequential(*jargs))
    _close(y, seq)
    # the dispatch takes the plain version for CPU tensors
    y2, final2 = ops.ssd_scan(*map(torch.from_numpy, args), q)
    assert torch.equal(y2, y) and torch.equal(final2, final)


def test_ssd_final_state_matches_sequential_state():
    """The final state is the recurrence's last state: continuing the
    sequential recurrence from it for one step gives the next output."""
    x, dt, a_log, bm, cm = map(torch.from_numpy, _ssd_inputs(1, 33, 3, 8, 4))
    _, state = ref.ssd_scan(x[:, :32], dt[:, :32], a_log, bm[:, :32],
                            cm[:, :32], 8)
    a = -torch.exp(a_log)
    nxt = state * torch.exp(dt[:, 32] * a)[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt[:, 32], bm[:, 32], x[:, 32])
    _close(torch.einsum("bn,bhnp->bhp", cm[:, 32], nxt),
           ref.ssd_scan_sequential(x, dt, a_log, bm, cm)[:, 32])


def test_ssd_chunk_invariance_at_the_kernels_chunk():
    """The CUDA kernel scans in chunks of 64 whatever the config's chunk
    (256 for zamba2 / mamba2): the plain version agrees across the two,
    y and final state, on a ragged length."""
    from repro_torch.kernels.ssd_scan import CHUNK
    args = map(torch.from_numpy, _ssd_inputs(1, 300, 2, 8, 4))
    args = list(args)
    y64, s64 = ref.ssd_scan(*args, CHUNK)
    y256, s256 = ref.ssd_scan(*args, 256)
    _close(y64, y256)
    _close(s64, s256)


def test_kernel_wrappers_take_cuda_tensors_only():
    from repro_torch.kernels import ssd_scan as k5
    from repro_torch.kernels import swa_attn as k4
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 16, 8))
    args = list(map(torch.from_numpy, _ssd_inputs(1, 17, 2, 8, 4)))
    before = (dict(k4.LAUNCHES), dict(k5.LAUNCHES))
    with pytest.raises(ValueError):
        k4.swa_attn(q, k, v, None)
    with pytest.raises(ValueError):
        k5.ssd_scan(*args)
    ops.swa_attention(q, k, v, 4)
    ops.ssd_scan(*args, 8)
    assert (k4.LAUNCHES, k5.LAUNCHES) == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ("float32", "bfloat16"))
def test_cuda_swa_matches_plain_on_card(dtype_name):
    _need_card()
    from repro_torch.kernels import swa_attn as k4
    dt = getattr(torch, dtype_name)
    tol = (RTOL, ATOL) if dtype_name == "float32" else (BF16_TOL, BF16_TOL)
    # ragged S and D; D = 80 and 128 (the 128 bucket, one zero-padded); a
    # single query; window 1 (each query sees only itself)
    for b, h, s, d, w in ((1, 2, 100, 8, 24), (2, 4, 128, 32, 32),
                          (1, 2, 300, 64, None), (1, 1, 130, 256, 64),
                          (1, 2, 300, 80, None), (1, 2, 200, 128, 64),
                          (2, 2, 1, 64, None), (1, 2, 150, 64, 1)):
        q, k, v = (torch.from_numpy(t).to(dt).cuda() for t in _qkv(b, h, s,
                                                                    d))
        before = k4.LAUNCHES["swa_attn"]
        got = ops.swa_attention(q, k, v, w)
        want = ref.swa_attn(q, k, v, w)
        torch.cuda.synchronize()
        assert k4.LAUNCHES["swa_attn"] == before + 1
        assert got.dtype == dt
        _close(got.float().cpu(), want.float().cpu(), *tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ("float32", "bfloat16"))
def test_cuda_ssd_matches_plain_on_card(dtype_name):
    _need_card()
    from repro_torch.kernels import ssd_scan as k5
    dt = getattr(torch, dtype_name)
    tol = (RTOL, ATOL) if dtype_name == "float32" else (BF16_TOL, BF16_TOL)
    for b, s, h, p, n in ((1, 17, 2, 8, 4), (1, 50, 3, 8, 16),
                          (2, 300, 4, 64, 64), (1, 200, 2, 64, 128)):
        args = [torch.from_numpy(a).cuda() for a in _ssd_inputs(b, s, h, p,
                                                               n)]
        for i in (0, 3, 4):         # x, B and C; dt and a_log stay float32
            args[i] = args[i].to(dt)
        before = k5.LAUNCHES["ssd_scan"]
        y, final = ops.ssd_scan(*args, 256)
        y_ref, final_ref = ref.ssd_scan(*args, 256)
        torch.cuda.synchronize()
        assert k5.LAUNCHES["ssd_scan"] == before + 1
        assert y.dtype == dt
        _close(y.float().cpu(), y_ref.float().cpu(), *tol)
        _close(final.cpu(), final_ref.cpu(), *tol)
        if dtype_name == "float32":
            _close(y.cpu(), ref.ssd_scan_sequential(*args).cpu())
