"""The port's model modules against the JAX package's, at ``reduced``
widths, from the same numpy inputs and the JAX package's parameters
(``repro_torch.convert``; ``jax.random`` init cannot be reproduced).

rmsnorm, RoPE and the MLPs are held at rtol 1e-5 / atol 1e-6 (float32, the
same operations in another order).  Attention and the Mamba2 block
(``attention`` / ``prefill_cache`` / ``decode_step``, ``ssm_forward`` /
``ssm_decode_step``) at rtol 1e-4 / atol 1e-5, the JAX package's kernel
tolerance: their full-sequence paths go through the plain versions of K4
and K5, which JAX computes as ``_sdpa`` and ``ssd_chunked``.  The
deterministic inits (``ones``, ``zeros``, ``ssm_a``, ``ssm_dt_bias``) at
rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common.arch_config import reduced as jreduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.convert import to_torch
from repro_torch.models import attention, layers, ssm
from repro_torch.models import transformer as T

EXACT = dict(rtol=1e-5, atol=1e-6)
KERNEL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _cfgs(name, **over):
    return (jreduced(jconfigs.get(name), **over),
            reduced(configs.get(name), **over))


def _params(specs_j, seed):
    p = jlayers.init_params(specs_j, jax.random.PRNGKey(seed))
    return p, to_torch(jax.tree.map(np.asarray, p))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rmsnorm_rope_mlps_match_jax():
    x = _x((2, 7, 4, 32))
    w = _x((32,), 1) + 1.0
    _close(layers.rmsnorm(torch.from_numpy(w), torch.from_numpy(x), 1e-6),
           jlayers.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-6), EXACT)
    pos = np.arange(7)[None, :] + 3
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), EXACT)
    h = _x((2, 5, 16), 2)
    for specs, jfn, tfn in (
            (jlayers.swiglu_specs(16, 24), jlayers.swiglu, layers.swiglu),
            (jlayers.gelu_mlp_specs(16, 24), jlayers.gelu_mlp,
             layers.gelu_mlp)):
        pj, pt = _params(specs, 3)
        _close(tfn(pt, torch.from_numpy(h)), jfn(pj, jnp.asarray(h)), EXACT)


def test_param_specs_and_deterministic_init_match_jax():
    cfg_j, cfg_t = _cfgs("zamba2-1.2b", n_layers=10)
    spec_j = JT.param_specs(cfg_j)
    spec_t = T.param_specs(cfg_t)
    sj = jax.tree.leaves(spec_j, is_leaf=jlayers.is_spec)
    pj = JT.init(cfg_j, jax.random.PRNGKey(0))
    pt = T.init(cfg_t, torch.Generator().manual_seed(0))
    paths_j = [jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_flatten_with_path(pj)[0]]
    flat_t = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + f"[{k!r}]")
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, path + f"[{i}]")
        else:
            flat_t.append((path, t))
    walk(pt, "")
    assert [p for p, _ in flat_t] == paths_j
    leaves_j = jax.tree.leaves(pj)
    for spec, (path, got), want in zip(sj, flat_t, leaves_j):
        assert tuple(got.shape) == tuple(want.shape), path
        assert got.dtype == torch.float32
        if spec.init != "normal":
            _close(got, want, dict(rtol=1e-6, atol=0))
        else:
            fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
            assert abs(float(got.std()) * np.sqrt(fan_in) - 1) < 0.2, path
    assert jax.tree.structure(spec_j, is_leaf=jlayers.is_spec).num_leaves \
        == len(jax.tree.leaves(spec_t, is_leaf=layers.is_spec))
    # empty decode caches: the same tree of the same shapes
    cj, ct = JT.init_caches(cfg_j, 2, 24), T.init_caches(cfg_t, 2, 24)
    flat_cj = jax.tree_util.tree_flatten_with_path(cj)[0]
    flat_ct = jax.tree_util.tree_flatten_with_path(ct)[0]
    assert [p for p, _ in flat_ct] == [p for p, _ in flat_cj]
    for (_, got), (_, want) in zip(flat_ct, flat_cj):
        assert tuple(got.shape) == tuple(want.shape)
        assert not got.any()


def _attn_cfgs(local: bool):
    """Equal query and key heads: zamba2's shared attention block, or
    gemma3's local layers with its key heads raised to its query heads (the
    ring-buffer cache); grouped key heads: tests/test_torch_gqa.py."""
    if not local:
        return _cfgs("zamba2-1.2b")
    cj, ct = _cfgs("gemma3-4b")
    return (dataclasses.replace(cj, n_kv_heads=cj.n_heads),
            dataclasses.replace(ct, n_kv_heads=ct.n_heads))


@pytest.mark.parametrize("local", [False, True])
def test_attention_prefill_decode_match_jax(local):
    cfg_j, cfg_t = _attn_cfgs(local)
    pj, pt = _params(jattn.attn_specs(cfg_j), 4)
    b, s, max_seq = 2, 40, 44     # s > the smoke window (32): ring buffer
    x = _x((b, s + 2, cfg_j.d_model), 5)
    _close(attention.attention(pt, cfg_t, torch.from_numpy(x), local=local),
           jattn.attention(pj, cfg_j, jnp.asarray(x), local=local), KERNEL)
    out_t, cache_t = attention.prefill_cache(
        pt, cfg_t, torch.from_numpy(x[:, :s]), max_seq, local=local)
    out_j, cache_j = jattn.prefill_cache(pj, cfg_j, jnp.asarray(x[:, :s]),
                                         max_seq, local=local)
    _close(out_t, out_j, KERNEL)
    _close(cache_t.k, cache_j.k, KERNEL)
    _close(cache_t.v, cache_j.v, KERNEL)
    for i in range(2):
        xi = x[:, s + i: s + i + 1]
        dec_t, cache_t = attention.decode_step(
            pt, cfg_t, torch.from_numpy(xi), cache_t, s + i, local=local)
        dec_j, cache_j = jattn.decode_step(
            pj, cfg_j, jnp.asarray(xi), cache_j, jnp.int32(s + i),
            local=local)
        _close(dec_t, dec_j, KERNEL)
        _close(cache_t.k, cache_j.k, KERNEL)


def test_ssm_forward_and_decode_match_jax():
    cfg_j, cfg_t = _cfgs("zamba2-1.2b")
    pj, pt = _params(jssm.ssm_specs(cfg_j), 6)
    b, s = 2, 21                  # ragged against the smoke chunk (8)
    x = _x((b, s + 2, cfg_j.d_model), 7)
    _close(ssm.ssm_forward(pt, cfg_t, torch.from_numpy(x)),
           jssm.ssm_forward(pj, cfg_j, jnp.asarray(x)), KERNEL)
    out_t, cache_t = ssm.ssm_forward(pt, cfg_t, torch.from_numpy(x[:, :s]),
                                     return_cache=True)
    out_j, cache_j = jssm.ssm_forward(pj, cfg_j, jnp.asarray(x[:, :s]),
                                      return_cache=True)
    _close(out_t, out_j, KERNEL)
    _close(cache_t.conv, cache_j.conv, KERNEL)
    _close(cache_t.state, cache_j.state, KERNEL)
    for i in range(2):
        xi = x[:, s + i: s + i + 1]
        dec_t, cache_t = ssm.ssm_decode_step(pt, cfg_t, torch.from_numpy(xi),
                                             cache_t)
        dec_j, cache_j = jssm.ssm_decode_step(pj, cfg_j, jnp.asarray(xi),
                                              cache_j)
        _close(dec_t, dec_j, KERNEL)
        _close(cache_t.state, cache_j.state, KERNEL)
        _close(cache_t.conv, cache_j.conv, KERNEL)
    empty = ssm.init_ssm_cache(cfg_t, b)
    want = jssm.init_ssm_cache(cfg_j, b)
    assert empty.conv.shape == want.conv.shape
    assert empty.state.shape == want.state.shape
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssm.ssm_forward(pt, cfg_t, torch.from_numpy(x), init_cache=empty)


@pytest.mark.parametrize("name,over,what", [
    ("gemma3-4b", {"causal": False}, "bidirectional"),
    ("qwen3-8b", {"causal": False}, "bidirectional"),
    ("granite-moe-1b-a400m", {}, "MoE"),
    ("internvl2-1b", {}, "frontend"),
    ("hubert-xlarge", {"frontend": "none"}, "bidirectional"),
])
def test_unported_configs_raise(name, over, what):
    cfg = dataclasses.replace(reduced(configs.get(name)), **over)
    with pytest.raises(NotImplementedError, match=what):
        T.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.param_specs(cfg)
