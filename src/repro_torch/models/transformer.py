"""Unified model from one config (the JAX package's ``models/
transformer.py`` in PyTorch): dense / SSM / hybrid decoders with token
inputs.

Layers are grouped by *pattern position*: ``pattern[j]`` repeats
``n_layers // len(pattern)`` times (stacked params with a leading
``n_full`` axis, as in JAX, applied by a Python loop over repeats), plus an
unrolled remainder ``tail`` so exact layer counts are preserved.
``shared_attn`` positions (Zamba2) hold a single weight set (``shared``)
reused on every repeat.

Public surface:
  param_specs / init      — parameters
  forward(params, batch)  — full-sequence logits
  prefill(params, batch)  — logits + populated caches
  decode_step(params, …)  — one-token logits; caches updated in place
  init_caches             — decode-state construction

Not ported yet (``check_supported`` raises ``NotImplementedError``, ROADMAP
queue 1 item 11): MoE MLPs, the audio / vision frontends and bidirectional
attention.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.arch_config import ArchConfig, BlockSpec
from repro_torch.common.pytree import tree_map
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamSpec, gelu_mlp, gelu_mlp_specs, init_params, rmsnorm, rmsnorm_spec,
    stack_specs, swiglu, swiglu_specs)

ROADMAP_ITEM = "ROADMAP queue 1 item 11"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model path cannot
    run yet."""
    if cfg.has_moe:
        raise NotImplementedError(f"{cfg.name}: MoE MLPs are not ported "
                                  f"({ROADMAP_ITEM})")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"is not ported ({ROADMAP_ITEM})")
    if cfg.has_attention:
        attn.check_supported(cfg)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def _mixer_specs(cfg: ArchConfig, spec: BlockSpec) -> dict:
    if spec.mixer == "mamba":
        return ssm_mod.ssm_specs(cfg)
    return attn.attn_specs(cfg)


def _mlp_specs(cfg: ArchConfig, spec: BlockSpec) -> Optional[dict]:
    if spec.mlp == "swiglu":
        return swiglu_specs(cfg.d_model, cfg.d_ff)
    if spec.mlp == "gelu":
        return gelu_mlp_specs(cfg.d_model, cfg.d_ff)
    return None                 # "none" (MoE raised in check_supported)


def _block_specs(cfg: ArchConfig, spec: BlockSpec) -> dict:
    d = {"norm1": rmsnorm_spec(cfg.d_model), "mixer": _mixer_specs(cfg, spec)}
    mlp = _mlp_specs(cfg, spec)
    if mlp is not None:
        d["norm2"] = rmsnorm_spec(cfg.d_model)
        d["mlp"] = mlp
    return d


def _layout(cfg: ArchConfig) -> Tuple[int, int, int]:
    p = len(cfg.pattern)
    return p, cfg.n_layers // p, cfg.n_layers % p


def param_specs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    p, n_full, rem = _layout(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", None),
                           scale=1.0)}
    blocks = []
    for j in range(p):
        bs = cfg.pattern[j]
        if bs.mixer == "shared_attn":
            blocks.append({})  # weights live in specs["shared"]
        else:
            blocks.append(stack_specs(_block_specs(cfg, bs), n_full)
                          if n_full > 0 else {})
    specs["blocks"] = tuple(blocks)
    specs["tail"] = tuple(
        {} if cfg.pattern[j].mixer == "shared_attn"
        else _block_specs(cfg, cfg.pattern[j])
        for j in range(rem))
    if any(b.mixer == "shared_attn" for b in cfg.pattern):
        shared_spec = dataclasses.replace(cfg.pattern[
            next(j for j, b in enumerate(cfg.pattern)
                 if b.mixer == "shared_attn")], mixer="attn_global")
        specs["shared"] = _block_specs(cfg, shared_spec)
    specs["final_norm"] = rmsnorm_spec(cfg.d_model)
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                  (None, "vocab"))
    return specs


def init(cfg: ArchConfig, generator: torch.Generator, dtype=torch.float32,
         device="cpu"):
    """Parameters from ``generator`` (drawn where it lives, then moved to
    ``device``)."""
    return init_params(param_specs(cfg), generator, dtype, device)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _apply_mlp(bp: dict, cfg: ArchConfig, spec: BlockSpec, h: torch.Tensor):
    if spec.mlp == "none":
        return h
    x = rmsnorm(bp["norm2"], h, cfg.norm_eps)
    if spec.mlp == "swiglu":
        return h + swiglu(bp["mlp"], x)
    return h + gelu_mlp(bp["mlp"], x)


def _apply_block(bp: dict, cfg: ArchConfig, spec: BlockSpec,
                 h: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(bp["norm1"], h, cfg.norm_eps)
    if spec.mixer == "mamba":
        h = h + ssm_mod.ssm_forward(bp["mixer"], cfg, x)
    else:
        h = h + attn.attention(bp["mixer"], cfg, x,
                               local=spec.mixer == "attn_local")
    return _apply_mlp(bp, cfg, spec, h)


def _resolve(cfg: ArchConfig, j: int, bp: dict, shared: Optional[dict]):
    spec = cfg.pattern[j]
    if spec.mixer == "shared_attn":
        return dataclasses.replace(spec, mixer="attn_global"), shared
    return spec, bp


def _layers(params: dict, cfg: ArchConfig):
    """(block params, spec, (where, j, r)) for every layer in order: the
    ``n_full`` repeats of the pattern, then the tail.  ``where`` is
    ``"blocks"`` (repeat ``r`` of pattern position ``j``) or ``"tail"``."""
    p, n_full, rem = _layout(cfg)
    shared = params.get("shared")
    for r in range(n_full):
        for j in range(p):
            bp = tree_map(lambda x: x[r], params["blocks"][j])
            spec, bp = _resolve(cfg, j, bp, shared)
            yield bp, spec, ("blocks", j, r)
    for j in range(rem):
        spec, bp = _resolve(cfg, j, params["tail"][j], shared)
        yield bp, spec, ("tail", j, None)


# ---------------------------------------------------------------------------
# Forward (full-sequence eval)
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Input hidden states from tokens [B, S]."""
    return params["embed"][batch["tokens"]]


def unembed(params: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return h @ params["head"]
    return h @ params["embed"].T


def forward(params: dict, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Full-sequence logits [B, S, V] (JAX also returns the MoE aux loss,
    which is 0 without MoE)."""
    check_supported(cfg)
    h = embed_inputs(params, cfg, batch)
    for bp, spec, _ in _layers(params, cfg):
        h = _apply_block(bp, cfg, spec, h)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params, cfg, h)


# ---------------------------------------------------------------------------
# Decode: cache construction + prefill + one-token step
# ---------------------------------------------------------------------------

def _layer_cache_init(cfg: ArchConfig, spec: BlockSpec, batch: int,
                      max_seq: int, dtype, device):
    if spec.mixer == "mamba":
        return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
    local = spec.mixer == "attn_local"
    return attn.init_cache(cfg, local, batch, max_seq, dtype, device)


def _stack_caches(caches: list):
    return tree_map(lambda *xs: torch.stack(xs), *caches)


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.float32, device="cpu") -> dict:
    check_supported(cfg)
    p, n_full, rem = _layout(cfg)
    return {
        "blocks": tuple(
            _stack_caches([_layer_cache_init(cfg, cfg.pattern[j], batch,
                                             max_seq, dtype, device)
                           for _ in range(n_full)])
            for j in range(p)) if n_full > 0 else tuple({} for _ in range(p)),
        "tail": tuple(
            _layer_cache_init(cfg, cfg.pattern[j], batch, max_seq, dtype,
                              device)
            for j in range(rem)),
    }


def _layer_cache(caches: dict, where: Tuple):
    kind, j, r = where
    if kind == "tail":
        return caches["tail"][j]
    return tree_map(lambda x: x[r], caches["blocks"][j])


def decode_step(params: dict, cfg: ArchConfig, batch: dict, caches: dict,
                cur_len: int):
    """batch: one new token per sequence ({"tokens": [B, 1]}); ``cur_len``
    tokens are in the caches.  Returns (logits [B,1,V], caches); the
    caches are updated in place (JAX returns updated copies)."""
    check_supported(cfg)
    h = embed_inputs(params, cfg, batch)
    for bp, spec, where in _layers(params, cfg):
        cache = _layer_cache(caches, where)
        x = rmsnorm(bp["norm1"], h, cfg.norm_eps)
        if spec.mixer == "mamba":
            out, _ = ssm_mod.ssm_decode_step(bp["mixer"], cfg, x, cache)
        else:
            out, _ = attn.decode_step(bp["mixer"], cfg, x, cache, cur_len,
                                      local=spec.mixer == "attn_local")
        h = _apply_mlp(bp, cfg, spec, h + out)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return unembed(params, cfg, h), caches


def prefill(params: dict, cfg: ArchConfig, batch: dict, max_seq: int,
            last_only: bool = False):
    """Full-prompt forward that also populates the decode caches.  Returns
    (logits [B,S,V], or [B,1,V] with ``last_only``, and the caches)."""
    check_supported(cfg)
    p, n_full, rem = _layout(cfg)
    h = embed_inputs(params, cfg, batch)
    block_caches = [[] for _ in range(p)]
    tail_caches = []
    for bp, spec, (kind, j, _) in _layers(params, cfg):
        x = rmsnorm(bp["norm1"], h, cfg.norm_eps)
        if spec.mixer == "mamba":
            out, cache = ssm_mod.ssm_forward(bp["mixer"], cfg, x,
                                             return_cache=True)
        else:
            out, cache = attn.prefill_cache(bp["mixer"], cfg, x, max_seq,
                                            local=spec.mixer == "attn_local")
        h = _apply_mlp(bp, cfg, spec, h + out)
        (block_caches[j] if kind == "blocks" else tail_caches).append(cache)
    if last_only:
        h = h[:, -1:]
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    caches = {"blocks": tuple(_stack_caches(c) if c else {}
                              for c in block_caches),
              "tail": tuple(tail_caches)}
    return unembed(params, cfg, h), caches
