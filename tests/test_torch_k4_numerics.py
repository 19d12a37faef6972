"""The float32 arithmetic of the CUDA attention kernel (K4), modelled in
numpy and held to the plain version on the CPU.

The kernel (``src/repro_torch/kernels/csrc/swa_attn.cu``) runs on the
tensor cores, whose float32 products take TF32 operands (10 stored mantissa
bits).  It splits every operand x into big = x rounded to TF32 (to nearest,
ties away from zero, as ``cvt.rna.tf32.f32``) and small = x - big, which the
tensor core reads truncated to TF32, and accumulates small.big + big.small
before big.big (three passes).  The model repeats that arithmetic step for
step: the kernel's key tiles (64 keys; 32 at a head dimension above 128), k
steps of 8, each pass added to a float32 accumulator, the online softmax in
base 2 with masked scores at -inf and the running max from -1e30, each key
tile's P.V summed from zero and added to the output.  It leaves out the
tensor cores' own rounding inside a k step (exact here) and ex2.approx's
(exact here).

Held to the plain version (``repro_torch.kernels.ref.swa_attn``) at K4's
float32 tolerance (rtol 1e-4 / atol 1e-5, the JAX package's
``tests/test_kernels.py``), three passes pass and one TF32 pass does not:
that pins the three-pass design.  The CUDA kernel itself is held to the
same tolerance on the card (``tests/test_torch_kernels_k4k5.py``,
``chip_smoke.py``).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

RTOL, ATOL = 1e-4, 1e-5
LOG2E = np.float32(1.4426950408889634)
MASK = np.uint32(0xFFFFE000)


def _tf32_rna(x):
    """x rounded to TF32, to nearest with ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & MASK).view(np.float32)


def _tf32_trunc(x):
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) & MASK
            ).view(np.float32)


def _split(x):
    """The kernel's split(): big = rna(x); small = x - big, truncated to
    TF32 by the tensor core."""
    big = _tf32_rna(x)
    return big, _tf32_trunc(x - big)


def _mma(acc, a, b, passes):
    """acc [.., M, N] f32 += a [.., M, K] @ b [.., K, N] in k steps of 8,
    each pass's products summed exactly and added to the f32 accumulator."""
    for k0 in range(0, a.shape[-1], 8):
        ab, as_ = _split(a[..., k0:k0 + 8])
        bb, bs = _split(b[..., k0:k0 + 8, :])
        terms = ([(as_, bb), (ab, bs)] if passes == 3 else []) + [(ab, bb)]
        for x, y in terms:
            acc = (acc.astype(np.float64)
                   + x.astype(np.float64) @ y.astype(np.float64)
                   ).astype(np.float32)
    return acc


def swa_model(q, k, v, window, passes=3):
    """The kernel's f32 arithmetic on q, k, v [B, H, S, D] float32."""
    b, h, s, d = q.shape
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    bk = 64 if dp <= 128 else 32
    pad = ((0, 0), (0, 0), (0, (-s) % bk), (0, dp - d))
    qf = np.pad(q, pad)[:, :, :s].reshape(b * h, s, dp)
    kf = np.pad(k, pad).reshape(b * h, -1, dp)
    vf = np.pad(v, pad).reshape(b * h, -1, dp)
    sl2 = np.float32(np.float32(1.0 / math.sqrt(d)) * LOG2E)
    m = np.full((b * h, s, 1), -1e30, np.float32)
    l = np.zeros((b * h, s, 1), np.float32)
    acc = np.zeros((b * h, s, dp), np.float32)
    qp = np.arange(s)[:, None]
    for k0 in range(0, s, bk):
        sc = _mma(np.zeros((b * h, s, bk), np.float32), qf,
                  kf[:, k0:k0 + bk].transpose(0, 2, 1), passes)
        kp = k0 + np.arange(bk)[None, :]
        seen = (kp <= qp) & (kp < s)
        if window is not None:
            seen &= qp - kp < window
        sc = np.where(seen, sc, -np.inf).astype(np.float32)
        mx = np.maximum(m, sc.max(-1, keepdims=True))
        shift = (mx * sl2).astype(np.float32)
        p = np.exp2((sc.astype(np.float64) * sl2 - shift).astype(np.float32)
                    ).astype(np.float32)
        alpha = np.exp2(((m - mx) * sl2).astype(np.float32)
                        ).astype(np.float32)
        l = (l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
             ).astype(np.float32)
        part = _mma(np.zeros((b * h, s, dp), np.float32), p,
                    vf[:, k0:k0 + bk], passes)
        acc = (acc.astype(np.float64) * alpha + part).astype(np.float32)
        m = mx
    out = acc / np.maximum(l, np.float32(1e-30))
    return out[..., :d].reshape(b, h, s, d)


def _qkv(b, h, s, d, seed=0):
    rng = np.random.default_rng(seed + s + d)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _excess(got, want):
    """max of |got - want| - atol - rtol |want|: <= 0 within tolerance."""
    return float((np.abs(got - want) - ATOL - RTOL * np.abs(want)).max())


def _plain(q, k, v, w):
    return ref.swa_attn(*map(torch.from_numpy, (q, k, v)), w).numpy()


@pytest.mark.parametrize("b,h,s,d,w", [(1, 2, 300, 64, None),
                                       (1, 1, 512, 256, 128),
                                       (1, 2, 100, 8, 24)])
def test_three_tf32_passes_meet_the_f32_tolerance(b, h, s, d, w):
    q, k, v = _qkv(b, h, s, d)
    got = swa_model(q, k, v, w, passes=3)
    assert np.isfinite(got).all()
    assert _excess(got, _plain(q, k, v, w)) <= 0


@pytest.mark.parametrize("b,h,s,d,w", [(1, 2, 300, 64, None),
                                       (1, 1, 512, 256, 128)])
def test_one_tf32_pass_misses_the_f32_tolerance(b, h, s, d, w):
    q, k, v = _qkv(b, h, s, d)
    assert _excess(swa_model(q, k, v, w, passes=1), _plain(q, k, v, w)) > 0


def test_split_is_exact_and_keeps_nan():
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 10
    big, small = _split(x)
    assert np.array_equal(big.astype(np.float64) + (x - big), x)
    assert not (big.view(np.uint32) & ~MASK).any()
    # small, as the tensor core reads it, is within 2^-23 |x| of x - big
    assert (np.abs(x - big - small) <= np.abs(x) * 2.0 ** -23).all()
    # a NaN (the card's canonical 0x7fffffff too) reaches the product
    nan = np.array([np.nan, np.uint32(0x7FFFFFFF).view(np.float32)],
                   np.float32)
    big, small = _split(nan)
    assert np.isnan(big.astype(np.float64) + small).all()


def test_model_sees_no_key_as_zero_and_window_one_as_itself():
    """A query that sees no key is 0, not NaN (rows past a whole masked
    tile); with window 1 each query sees only itself."""
    q, k, v = _qkv(1, 1, 70, 16)
    got = swa_model(q, k, v, 1)
    np.testing.assert_allclose(got, v, rtol=RTOL, atol=ATOL)
