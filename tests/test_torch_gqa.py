"""Grouped-query attention in the port: K4 with KV at ``H_kv`` heads, and the
grouped-query decoders (qwen3-8b, gemma3-4b, phi3-medium-14b) against the
JAX package.

* K4's plain version (``repro_torch.kernels.ref.swa_attn``) with k / v at
  ``H_kv`` heads against the JAX models' ``_sdpa`` (query head h reads key
  head ``h // (H // H_kv)``) and against the JAX package's plain
  ``ref.swa_attn`` and Pallas kernel in interpret mode on k / v repeated to
  ``H`` heads, from the same numpy inputs, at GQA shapes with D = 256 with
  and without a window among them.  Tolerance: ``tests/test_kernels.py``'s
  rtol 1e-4 / atol 1e-5 in float32.
* The reduced configs of the three decoders, with the JAX package's init
  converted: ``forward``, and ``prefill`` plus 2 teacher-forced
  ``decode_step``s, against JAX within rtol 2e-3 plus 1e-3 of the largest
  logit (``tests/test_torch_serve.py``'s tolerance); gemma3's prompt (40)
  is longer than its reduced window (32), so its local layers' ring buffer
  rolls.  Within the port, prefill + decode reproduce forward to
  ``tests/test_decode.py``'s tolerances.
* The ``gpu`` test holds the CUDA kernel at GQA shapes against the plain
  version on the card and skips without one.

JAX is imported inside the tests that use it, so the file also loads where
only PyTorch is installed (``pytest -m gpu`` on the card's machine).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.models.layers import init_params

RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 3e-2
CROSS_RTOL, CROSS_ATOL_REL = 2e-3, 1e-3
PREFILL_RTOL, PREFILL_ATOL, DECODE_ATOL = 2e-3, 2e-4, 2e-3
GQA_ARCHS = ("qwen3-8b", "gemma3-4b", "phi3-medium-14b")

# (b, h, h_kv, s, d, window, pallas block): gemma3's grouping (2 query heads
# a key head) at D = 256 without and with a window, qwen3's (4), a ragged S
# and D = 80, and one key head for all (multi-query)
GQA_CASES = [
    (1, 4, 2, 64, 256, None, 16), (1, 4, 2, 72, 256, 16, 16),
    (2, 8, 2, 48, 32, None, 16), (1, 6, 2, 37, 80, 24, 8),
    (1, 4, 1, 40, 16, 8, 8),
]


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


@pytest.mark.parametrize("b,h,h_kv,s,d,w,blk", GQA_CASES)
def test_gqa_plain_matches_jax_sdpa_and_pallas(b, h, h_kv, s, d, w, blk):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.swa_attn import swa_attn_pallas
    from repro.models.attention import _sdpa
    q, k, v = _qkv(b, h, h_kv, s, d)
    got = ref.swa_attn(*map(torch.from_numpy, (q, k, v)), w).numpy()
    # the JAX models' grouped attention, [B, S, H, D] layout
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (j <= i) & ((i - j < w) if w is not None else True)
    sdpa = _sdpa(*(jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v)),
                 jnp.asarray(mask), d)
    _close(got, np.asarray(sdpa).transpose(0, 2, 1, 3))
    # the JAX kernel and its plain reference take equal heads: KV repeated
    rep = h // h_kv
    jq, jk, jv = (jnp.asarray(t) for t in (q, np.repeat(k, rep, axis=1),
                                           np.repeat(v, rep, axis=1)))
    _close(got, jref.swa_attn(jq, jk, jv, w))
    _close(got, swa_attn_pallas(jq, jk, jv, w, block=blk))
    # the dispatch takes the plain version for CPU tensors, KV at H_kv heads
    _close(ops.swa_attention(*map(torch.from_numpy, (q, k, v)), w), got,
           0, 0)


def test_gqa_plain_groups_query_heads_onto_their_key_head():
    """Query head h sees key head h // (H // H_kv): moving one key head
    changes exactly the query heads grouped onto it."""
    q, k, v = map(torch.from_numpy, _qkv(1, 6, 3, 20, 8))
    base = ref.swa_attn(q, k, v, None)
    k2 = k.clone()
    k2[:, 1] += torch.randn(k2[:, 1].shape,
                            generator=torch.Generator().manual_seed(0))
    moved = (ref.swa_attn(q, k2, v, None) - base).abs().amax(dim=(0, 2, 3))
    assert [bool(m > 1e-4) for m in moved] == [False, False, True, True,
                                               False, False]


def test_k4_wrapper_checks_gqa_shapes_before_launching():
    from repro_torch.kernels import swa_attn as k4
    q, k, v = map(torch.from_numpy, _qkv(1, 6, 3, 16, 8))
    before = dict(k4.LAUNCHES)
    with pytest.raises(ValueError):   # CPU tensors never reach the kernel
        k4.swa_attn(q, k, v, None)
    assert k4.LAUNCHES == before


def _cfgs(name):
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    return jreduced(jconfigs.get(name)), reduced(configs.get(name))


def _converted(cfg_j, seed):
    import jax
    from repro.models import transformer as JT
    from repro_torch.convert import to_torch
    pj = JT.init(cfg_j, jax.random.PRNGKey(seed))
    return pj, to_torch(jax.tree.map(np.asarray, pj))


def _cross_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=CROSS_RTOL,
                               atol=CROSS_ATOL_REL * np.abs(want).max())


def test_gqa_attention_layer_matches_jax():
    """One attention layer of gemma3's reduced config (2 query heads a key
    head), local and global: full sequence, prefill's cache (the ring
    buffer rolled past the window) and two decode steps."""
    import jax.numpy as jnp
    from repro.models import attention as jattn
    cfg_j, cfg_t = _cfgs("gemma3-4b")
    assert cfg_t.n_kv_heads < cfg_t.n_heads
    pt = init_params(attention.attn_specs(cfg_t),
                     torch.Generator().manual_seed(4))
    pj = {k: jnp.asarray(v.numpy()) for k, v in pt.items()}
    b, s, max_seq = 2, 40, 44
    x = np.random.default_rng(5).normal(
        size=(b, s + 2, cfg_j.d_model)).astype(np.float32)
    for local in (False, True):
        _close(attention.attention(pt, cfg_t, torch.from_numpy(x),
                                   local=local),
               jattn.attention(pj, cfg_j, jnp.asarray(x), local=local))
        out_t, cache_t = attention.prefill_cache(
            pt, cfg_t, torch.from_numpy(x[:, :s]), max_seq, local=local)
        out_j, cache_j = jattn.prefill_cache(pj, cfg_j, jnp.asarray(x[:, :s]),
                                             max_seq, local=local)
        _close(out_t, out_j)
        _close(cache_t.k, cache_j.k)
        _close(cache_t.v, cache_j.v)
        for i in range(2):
            xi = x[:, s + i: s + i + 1]
            dec_t, cache_t = attention.decode_step(
                pt, cfg_t, torch.from_numpy(xi), cache_t, s + i, local=local)
            dec_j, cache_j = jattn.decode_step(
                pj, cfg_j, jnp.asarray(xi), cache_j, jnp.int32(s + i),
                local=local)
            _close(dec_t, dec_j)
            _close(cache_t.k, cache_j.k)


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_gqa_decoder_matches_jax(arch):
    import jax.numpy as jnp
    from repro.models import transformer as JT
    cfg_j, cfg_t = _cfgs(arch)
    T.check_supported(cfg_t)
    pj, pt = _converted(cfg_j, 0)
    b, s = 2, 40
    assert s > cfg_t.window
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size,
                                             (b, s + 2))
    fj, _ = JT.forward(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    _cross_close(T.forward(pt, cfg_t, {"tokens": torch.from_numpy(toks)}),
                 fj)
    lj, cj = JT.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks[:, :s])},
                        max_seq=s + 4)
    lt, ct = T.prefill(pt, cfg_t, {"tokens": torch.from_numpy(toks[:, :s])},
                       max_seq=s + 4)
    _cross_close(lt, lj)
    for i in range(2):
        step = toks[:, s + i: s + i + 1]
        dj, cj = JT.decode_step(pj, cfg_j, {"tokens": jnp.asarray(step)}, cj,
                                jnp.int32(s + i))
        dt, ct = T.decode_step(pt, cfg_t, {"tokens": torch.from_numpy(step)},
                               ct, s + i)
        _cross_close(dt, dj)


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_gqa_prefill_decode_matches_forward(arch):
    """tests/test_decode.py for the port's grouped-query decoders."""
    cfg = reduced(configs.get(arch))
    params = T.init(cfg, torch.Generator().manual_seed(2))
    b, s = 2, 40
    toks = torch.randint(0, cfg.vocab_size, (b, s + 2),
                         generator=torch.Generator().manual_seed(3))
    full = T.forward(params, cfg, {"tokens": toks})
    pre, caches = T.prefill(params, cfg, {"tokens": toks[:, :s]},
                            max_seq=s + 4)
    np.testing.assert_allclose(pre, full[:, :s], rtol=PREFILL_RTOL,
                               atol=PREFILL_ATOL)
    for i in range(2):
        dec, caches = T.decode_step(params, cfg,
                                    {"tokens": toks[:, s + i: s + i + 1]},
                                    caches, s + i)
        err = float((dec[:, 0] - full[:, s + i]).abs().max())
        assert err < DECODE_ATOL, f"decode step {i}: err={err}"


def test_gqa_decoders_keep_their_key_heads_in_the_cache():
    """The decode caches hold KV at ``n_kv_heads``, as JAX's do."""
    for arch in GQA_ARCHS:
        cfg = reduced(configs.get(arch))
        caches = T.init_caches(cfg, 1, 8)
        k = caches["blocks"][0].k
        assert k.shape[-2:] == (cfg.n_kv_heads, cfg.head_dim), arch
        assert cfg.n_kv_heads < cfg.n_heads


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ("float32", "bfloat16"))
def test_cuda_swa_gqa_matches_plain_on_card(dtype_name):
    _need_card()
    from repro_torch.kernels import swa_attn as k4
    dt = getattr(torch, dtype_name)
    tol = (RTOL, ATOL) if dtype_name == "float32" else (BF16_TOL, BF16_TOL)
    # qwen3's and gemma3's groupings (D 128 and 256, windowed and not), a
    # ragged S at D = 80 with 3 query heads a key head, multi-query
    for b, h, h_kv, s, d, w in ((1, 8, 2, 300, 128, None),
                                (1, 4, 2, 260, 256, None),
                                (1, 4, 2, 260, 256, 64),
                                (1, 6, 2, 300, 80, None),
                                (2, 4, 1, 100, 64, 24)):
        q, k, v = (torch.from_numpy(t).to(dt).cuda()
                   for t in _qkv(b, h, h_kv, s, d))
        before = k4.LAUNCHES["swa_attn"]
        got = ops.swa_attention(q, k, v, w)
        want = ref.swa_attn(q, k, v, w)
        torch.cuda.synchronize()
        assert k4.LAUNCHES["swa_attn"] == before + 1
        assert got.dtype == dt and got.shape == q.shape
        _close(got.float().cpu(), want.float().cpu(), *tol)
    assert math.isfinite(float(got.float().abs().max()))
