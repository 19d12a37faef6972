"""The two kernel modes of the port's model slice 14: K4 bidirectional
(hubert-xlarge's encoder) and K5 from a given state (``ssm_forward``'s
``init_cache``), against the JAX package.

* K4's plain version (``repro_torch.kernels.ref.swa_attn(causal=False)``),
  with and without a window, equal and grouped heads, against the JAX
  models' ``_sdpa`` under ``_make_mask``'s bidirectional mask and against
  ``_sdpa_chunked(causal=False)``: the window stays one-sided (``i - j <
  window``; every later key stays seen), as JAX masks it.  One attention
  layer of a bidirectional config against JAX's ``attention`` with either
  ``attn_impl``.
* K5's plain version from an initial state against the JAX model's
  ``ssd_chunked(init_state=)`` and the sequential recurrence; a scan split
  in two, the second half started from the first half's final state,
  against the whole scan.
* Tolerances: ``tests/test_kernels.py``'s rtol 1e-4 / atol 1e-5 in float32.
* The ``gpu`` tests hold the CUDA kernels in these modes against the plain
  versions on the card and skip without one.

JAX is imported inside the tests that use it, so the file also loads where
only PyTorch is installed (``pytest -m gpu`` on the card's machine).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import attention
from repro_torch.models.layers import init_params

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 3e-2

# (b, h, h_kv, s, d, window): hubert's equal heads without a window, a
# window shorter than the sequence, a grouped ragged case, one query
BIDIR_CASES = [(2, 4, 4, 48, 16, None), (1, 2, 2, 70, 32, 24),
               (1, 6, 2, 37, 80, 8), (2, 2, 1, 1, 16, None)]
# (b, s, h, p, n, chunk, split)
SSD_INIT_CASES = [(2, 32, 4, 16, 8, 8, 13), (1, 50, 3, 8, 16, 16, 32)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _qkv(b, h, h_kv, s, d, seed=0):
    rng = np.random.default_rng(seed + s + d)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h_kv, s, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _ssd_inputs(b, s, h, p, n, seed=0):
    """tests/test_kernels.py's distributions, drawn with numpy, and an
    initial state ~ N(0, 1)."""
    rng = np.random.default_rng(seed + s + n)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(size=(b, s, h)))) * 0.1).astype(
        np.float32)
    a_log = (rng.normal(size=(h,)) * 0.5).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    init = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return (x, dt, a_log, bm, cm), init


@pytest.mark.parametrize("b,h,h_kv,s,d,w", BIDIR_CASES)
def test_bidirectional_plain_matches_jax(b, h, h_kv, s, d, w):
    import jax.numpy as jnp
    from repro.models.attention import _sdpa, _sdpa_chunked
    q, k, v = _qkv(b, h, h_kv, s, d)
    got = ref.swa_attn(*map(torch.from_numpy, (q, k, v)), w,
                       causal=False).numpy()
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool) if w is None else (i - j < w)
    jq, jk, jv = (jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v))
    _close(got, np.asarray(_sdpa(jq, jk, jv, jnp.asarray(mask), d))
           .transpose(0, 2, 1, 3))
    _close(got, np.asarray(_sdpa_chunked(jq, jk, jv, d, causal=False,
                                         window=w, chunk=16))
           .transpose(0, 2, 1, 3))
    _close(ops.swa_attention(*map(torch.from_numpy, (q, k, v)), w,
                             causal=False), got, 0, 0)
    # every query sees the keys after it (beyond the window's reach only
    # backwards): moving the last key moves the first query's output
    if s > 1:
        k2 = k.copy()
        k2[:, :, -1] += 3.0
        moved = ref.swa_attn(*map(torch.from_numpy, (q, k2, v)), w,
                             causal=False).numpy()
        assert np.abs(moved[:, :, 0] - got[:, :, 0]).max() > 1e-4
        causal = ref.swa_attn(*map(torch.from_numpy, (q, k2, v)), w).numpy()
        assert np.array_equal(causal[:, :, 0], ref.swa_attn(
            *map(torch.from_numpy, (q, k, v)), w).numpy()[:, :, 0])


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_bidirectional_attention_layer_matches_jax(impl):
    """hubert's reduced attention layer (bidirectional, equal heads) and a
    windowed bidirectional one (gemma3's local width, causal off) against
    JAX's ``attention`` with either ``attn_impl``."""
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.models import attention as jattn
    for name, over, local in (("hubert-xlarge", {}, False),
                              ("gemma3-4b", {"causal": False}, True)):
        cfg_j = jreduced(jconfigs.get(name), attn_impl=impl, attn_chunk=16,
                         **over)
        cfg_t = dataclasses.replace(reduced(configs.get(name)), **over)
        assert not cfg_t.causal
        pt = init_params(attention.attn_specs(cfg_t),
                         torch.Generator().manual_seed(4))
        pj = {k: jnp.asarray(v.numpy()) for k, v in pt.items()}
        x = np.random.default_rng(5).normal(
            size=(2, 40, cfg_t.d_model)).astype(np.float32)
        assert 40 > cfg_t.window
        _close(attention.attention(pt, cfg_t, torch.from_numpy(x),
                                   local=local),
               jattn.attention(pj, cfg_j, jnp.asarray(x), local=local))


@pytest.mark.parametrize("b,s,h,p,n,chunk,split", SSD_INIT_CASES)
def test_ssd_from_a_state_matches_jax(b, s, h, p, n, chunk, split):
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked
    args, init = _ssd_inputs(b, s, h, p, n)
    targs = list(map(torch.from_numpy, args))
    y, final = ref.ssd_scan(*targs, chunk, torch.from_numpy(init))
    yj, fj = ssd_chunked(*map(jnp.asarray, args), chunk,
                         init_state=jnp.asarray(init))
    _close(y, yj)
    _close(final, fj)
    _close(y, ref.ssd_scan_sequential(*targs, torch.from_numpy(init)))
    y2, final2 = ops.ssd_scan(*targs, chunk, torch.from_numpy(init))
    _close(y2, y, 0, 0)
    _close(final2, final, 0, 0)
    # the state matters, and a zero state is the zero start
    y0, _ = ref.ssd_scan(*targs, chunk)
    assert np.abs(y0.numpy() - y.numpy()).max() > 1e-3
    _close(ref.ssd_scan(*targs, chunk, torch.zeros(b, h, n, p))[0], y0, 0, 0)
    # a split scan: the second half from the first half's final state
    first = [t[:, :split] if t.dim() > 1 else t for t in targs]
    second = [t[:, split:] if t.dim() > 1 else t for t in targs]
    _, mid = ref.ssd_scan(*first, chunk)
    y_b, final_b = ref.ssd_scan(*second, chunk, mid)
    _close(y_b, y0[:, split:])
    _close(final_b, ref.ssd_scan(*targs, chunk)[1])


def test_k5_wrapper_checks_the_state_before_launching():
    from repro_torch.kernels import ssd_scan as k5
    args, init = _ssd_inputs(1, 17, 2, 8, 4)
    targs = list(map(torch.from_numpy, args))
    before = dict(k5.LAUNCHES)
    with pytest.raises(ValueError):   # CPU tensors never reach the kernel
        k5.ssd_scan(*targs, torch.from_numpy(init))
    ops.ssd_scan(*targs, 8, torch.from_numpy(init))
    assert k5.LAUNCHES == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ("float32", "bfloat16"))
def test_cuda_swa_bidirectional_matches_plain_on_card(dtype_name):
    _need_card()
    from repro_torch.kernels import swa_attn as k4
    dt = getattr(torch, dtype_name)
    tol = (RTOL, ATOL) if dtype_name == "float32" else (BF16_TOL, BF16_TOL)
    # hubert's D = 80 (the 128 bucket), a window, grouped heads, D 64 / 256,
    # one query, a window of 1
    for b, h, h_kv, s, d, w in ((1, 4, 4, 300, 80, None),
                                (1, 4, 4, 260, 80, 64),
                                (1, 6, 2, 130, 64, None),
                                (1, 2, 2, 100, 256, 24),
                                (2, 2, 2, 1, 64, None),
                                (1, 2, 2, 150, 64, 1)):
        q, k, v = (torch.from_numpy(t).to(dt).cuda()
                   for t in _qkv(b, h, h_kv, s, d))
        before = k4.LAUNCHES["swa_attn"]
        got = ops.swa_attention(q, k, v, w, causal=False)
        want = ref.swa_attn(q, k, v, w, causal=False)
        torch.cuda.synchronize()
        assert k4.LAUNCHES["swa_attn"] == before + 1
        assert got.dtype == dt and got.shape == q.shape
        _close(got.float().cpu(), want.float().cpu(), *tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ("float32", "bfloat16"))
def test_cuda_ssd_from_a_state_matches_plain_on_card(dtype_name):
    _need_card()
    from repro_torch.kernels import ssd_scan as k5
    dt = getattr(torch, dtype_name)
    tol = (RTOL, ATOL) if dtype_name == "float32" else (BF16_TOL, BF16_TOL)
    for b, s, h, p, n in ((1, 17, 2, 8, 4), (2, 300, 4, 64, 64),
                          (1, 130, 2, 64, 128)):
        args, init = _ssd_inputs(b, s, h, p, n)
        args = [torch.from_numpy(a).cuda() for a in args]
        for i in (0, 3, 4):         # x, B and C; dt and a_log stay float32
            args[i] = args[i].to(dt)
        state = torch.from_numpy(init).cuda()
        before = k5.LAUNCHES["ssd_scan"]
        y, final = ops.ssd_scan(*args, 256, state)
        y_ref, final_ref = ref.ssd_scan(*args, 256, state)
        torch.cuda.synchronize()
        assert k5.LAUNCHES["ssd_scan"] == before + 1
        _close(y.float().cpu(), y_ref.float().cpu(), *tol)
        _close(final.cpu(), final_ref.cpu(), *tol)
