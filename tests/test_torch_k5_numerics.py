"""The float32 arithmetic of the CUDA SSD scan kernel (K5), modelled in
numpy and held to the plain version on the CPU.

The kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``) runs its four
chunk products on the tensor cores, whose float32 products take TF32
operands (10 stored mantissa bits).  It splits every operand x into big = x
rounded to TF32 (to nearest, ties away from zero, as ``cvt.rna.tf32.f32``)
and small = x - big, which the tensor core reads truncated to TF32, and
accumulates small.big + big.small before big.big (three passes).  The model
repeats that arithmetic step for step, per chunk of 64 steps:

* the cumulative sums of dt * a, and the segment sums
  seg_ij = sum_{k=j+1..i} dt_k a summed directly (not as cum_i - cum_j);
* CB = C.B^T on the tensor cores (k steps of 8 over N), from zero;
* kern = CB * exp(seg) * dt_j, zero above the diagonal (masked before the
  exp);
* y_intra = kern.x and y_inter = C.state, each from zero, then
  y = y_intra + exp(cum_i) y_inter in float32;
* delta = (w B)^T.x with w_j = exp(seg_last,j) dt_j, from zero, then
  state = exp(cum_last) state + delta in float32.

It leaves out the tensor cores' own rounding inside a k step (exact here)
and the order of the warp's scan (sequential here).

Held to the plain version (``repro_torch.kernels.ref.ssd_scan``) at K5's
float32 tolerance (rtol 1e-4 / atol 1e-5, the JAX package's
``tests/test_kernels.py``) on y and the final state at the serve path's
width (P = N = 64) and length (S = 2000): three passes pass and one TF32
pass does not, which pins the three-pass design.  At serve-like decay
(dt * A up to ~1e3 a step, zamba2's init at full width) the direct segment
sums keep the tolerance and cum_i - cum_j does not.  The CUDA kernel
itself is held to the same tolerance on the card
(``tests/test_torch_kernels_k4k5.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

RTOL, ATOL = 1e-4, 1e-5
CHUNK = 64          # the kernel's chunk
REF_CHUNK = 256     # the config's chunk, at which the plain version runs
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


def _mma(a, b, passes):
    """a [.., M, K] @ b [.., K, N] from a zero float32 accumulator, in k
    steps of 8, each pass's products summed exactly and added to it."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        ab, as_ = _split(a[..., k0:k0 + 8])
        bb, bs = _split(b[..., k0:k0 + 8, :])
        terms = ([(as_, bb), (ab, bs)] if passes == 3 else []) + [(ab, bb)]
        for x, y in terms:
            acc = (acc.astype(np.float64)
                   + x.astype(np.float64) @ y.astype(np.float64)
                   ).astype(np.float32)
    return acc


def ssd_model(x, dt, a_log, bm, cm, passes=3, direct=True):
    """The kernel's float32 arithmetic: x [B,S,H,P], dt [B,S,H], a_log [H],
    bm / cm [B,S,N] float32 -> (y [B,S,H,P], state [B,H,N,P]).  ``direct``
    False takes the segment sums as cum_i - cum_j instead."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    a = (-np.exp(a_log)).astype(np.float32)
    lower = np.tril(np.ones((CHUNK, CHUNK), bool))
    strict = np.tril(np.ones((CHUNK, CHUNK), bool), -1)
    state = np.zeros((b, h, n, p), np.float32)
    y = np.zeros((b, s + CHUNK, h, p), np.float32)
    pad = ((0, 0), (0, CHUNK), (0, 0))
    xp = np.pad(x, pad + ((0, 0),))
    dtp, bp, cp = np.pad(dt, pad), np.pad(bm, pad), np.pad(cm, pad)
    for c0 in range(0, s, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        xs = xp[:, sl].transpose(0, 2, 1, 3)              # [B,H,L,P]
        dts = dtp[:, sl].transpose(0, 2, 1)               # [B,H,L]
        bs, cs = bp[:, None, sl], cp[:, None, sl]         # [B,1,L,N]
        da = (dts * a[None, :, None]).astype(np.float32)
        cum = np.cumsum(da, axis=-1, dtype=np.float32)
        if direct:
            seg = np.cumsum(np.where(strict, da[..., :, None], 0), axis=-2,
                            dtype=np.float32)
        else:
            seg = (cum[..., :, None] - cum[..., None, :]).astype(np.float32)
        cb = _mma(cs, bs.swapaxes(-1, -2), passes)        # [B,1,L,L]
        decay = np.exp(np.where(lower, seg, -np.inf)).astype(np.float32)
        kern = (cb * decay * dts[..., None, :]).astype(np.float32)
        y_intra = _mma(kern, xs, passes)
        y_inter = _mma(np.broadcast_to(cs, (b, h, CHUNK, n)), state, passes)
        yc = (y_intra + np.exp(cum)[..., None] * y_inter).astype(np.float32)
        y[:, sl] = yc.transpose(0, 2, 1, 3)
        w = (np.exp(seg[..., -1, :]) * dts).astype(np.float32)  # [B,H,L]
        wb = (w[..., :, None] * bs).astype(np.float32)          # [B,H,L,N]
        delta = _mma(wb.swapaxes(-1, -2), xs, passes)
        state = (np.exp(cum[..., -1])[..., None, None] * state
                 + delta).astype(np.float32)
    return y[:, :s], state


def _inputs(b, s, h, p, n, seed=0, serve_like=False):
    """chip_smoke.py's distributions (x ~ N(0,1), dt = softplus(N(0,1)) /
    10, a_log ~ N(0,1) / 2, B and C ~ N(0,1) / 2).  ``serve_like``: dt =
    softplus(10 N(0,1)) / 10 and a_log ~ 6 + N(0,1) / 2 (A ~ -400), so
    dt * A reaches ~1e3 in a step while about half the steps decay by
    almost nothing, as the zoo's init gives at full width."""
    rng = np.random.default_rng(seed + s + n)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    spread, shift = (10.0, 6.0) if serve_like else (1.0, 0.0)
    dt = (np.logaddexp(0.0, spread * rng.normal(size=(b, s, h))) * 0.1
          ).astype(np.float32)
    a_log = (rng.normal(size=(h,)) * 0.5 + shift).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    return x, dt, a_log, bm, cm


def _excess(got, want):
    """max of |got - want| - atol - rtol |want|: <= 0 within tolerance."""
    return float((np.abs(got - want) - ATOL - RTOL * np.abs(want)).max())


def _plain(args):
    y, state = ref.ssd_scan(*map(torch.from_numpy, args), REF_CHUNK)
    return y.numpy(), state.numpy()


def _worst(got, want):
    return max(_excess(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("b,s,h,p,n", [(1, 2000, 3, 64, 64),
                                       (1, 300, 2, 8, 16),
                                       (1, 200, 1, 64, 128)])
def test_three_tf32_passes_meet_the_f32_tolerance(b, s, h, p, n):
    args = _inputs(b, s, h, p, n)
    got = ssd_model(*args, passes=3)
    assert all(np.isfinite(g).all() for g in got)
    assert _worst(got, _plain(args)) <= 0


def test_one_tf32_pass_misses_the_f32_tolerance():
    args = _inputs(1, 2000, 3, 64, 64)
    assert _worst(ssd_model(*args, passes=1), _plain(args)) > 0


def test_direct_segment_sums_hold_at_serve_like_decay():
    """dt * A up to ~1e3 a step: the cumulative sums reach ~1e4 within a
    chunk, so cum_i - cum_j loses ~eps * 1e4 in the exponent of segments
    that decay by almost nothing; the direct sums keep the tolerance."""
    args = _inputs(1, 2000, 3, 64, 64, serve_like=True)
    da = args[1] * np.exp(args[2])
    assert da.max() > 1e3
    want = _plain(args)
    assert _worst(ssd_model(*args, direct=True), want) <= 0
    assert _worst(ssd_model(*args, direct=False), want) > 0
