"""Attention: full-sequence (prefill) forward + one-token decode with a KV
cache (the JAX package's ``models/attention.py`` in PyTorch).

Full-sequence attention (``attention``, ``prefill_cache``) goes through
``kernels/ops.swa_attention``: K4 on CUDA tensors, its plain version on the
CPU.  JAX's ``attn_impl`` ``naive`` and ``chunked`` compute the same
function, so both take that route here.  The model keeps JAX's ``[B, S, H,
D]`` layout; the kernel takes contiguous ``[B, H, S, D]``, so q, k and v
are transposed into contiguous copies before the call and the output back.
Grouped-query attention hands K4 the keys and values at their own
``n_kv_heads`` (query head h reads key head ``h // (H // KV)``, as
``_sdpa`` groups them); K4 masks causally only, so bidirectional
full-sequence attention raises ``NotImplementedError`` (ROADMAP queue 1
item 11).  Decode attends over the cache in plain PyTorch (``_sdpa``), as
JAX does outside any Pallas kernel.

Local layers use a ring-buffer cache of size ``window``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.common.arch_config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, apply_rope, rmsnorm,
                                       rmsnorm_spec)

UNPORTED = ("ROADMAP queue 1 item 11: the port's full-sequence attention is "
            "K4, causal only")


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, cache_size, KV, D]
    v: torch.Tensor  # [B, cache_size, KV, D]


def attn_specs(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "qkv")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "qkv")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "qkv")),
        "wo": ParamSpec((h, hd, d), ("heads", "qkv", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = rmsnorm_spec(hd, "qkv")
        specs["k_norm"] = rmsnorm_spec(hd, "qkv")
    return specs


def check_supported(cfg: ArchConfig) -> None:
    """Raise for attention the port's full-sequence path cannot run."""
    if not cfg.causal:
        raise NotImplementedError(f"{cfg.name}: bidirectional attention "
                                  f"({UNPORTED})")


def _project_qkv(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, head_dim):
    """q:[B,S,H,D] k/v:[B,T,KV,D] mask: broadcastable to [B,KV,R,S,T]."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    q = q.reshape(b, s, kvh, rep, d)
    scores = torch.einsum("bskrd,btkd->bkrst", q, k) / math.sqrt(head_dim)
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v)
    return out.reshape(b, s, h, d)


def _full_attention(cfg: ArchConfig, q, k, v, local: bool) -> torch.Tensor:
    """Causal (optionally windowed) attention over the whole sequence
    through K4: q [B,S,H,D] and k / v [B,S,KV,D] in, [B,S,H,D] out."""
    check_supported(cfg)
    to_bhsd = lambda t: t.transpose(1, 2).contiguous()
    out = ops.swa_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                            cfg.window if local else None)
    return out.transpose(1, 2)


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor, *, local: bool
              ) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _full_attention(cfg, q, k, v, local)
    return torch.einsum("bshd,hdm->bsm", out, p["wo"])


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------

def cache_size(cfg: ArchConfig, local: bool, max_seq: int) -> int:
    return min(cfg.window, max_seq) if local else max_seq


def init_cache(cfg: ArchConfig, local: bool, batch: int, max_seq: int,
               dtype=torch.float32, device="cpu") -> KVCache:
    cs = cache_size(cfg, local, max_seq)
    shape = (batch, cs, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_step(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                cur_len: int, *, local: bool):
    """One-token decode.  x: [B, 1, d_model]; cur_len: tokens already in
    the cache.  Returns (out [B,1,d], cache); the new key and value are
    written into ``cache`` in place (JAX returns an updated copy)."""
    b = x.shape[0]
    cs = cache.k.shape[1]
    positions = torch.full((b, 1), cur_len, dtype=torch.int64,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)

    slot = cur_len % cs
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]

    idx = torch.arange(cs, device=x.device)
    if local:
        # ring buffer: slot occupied iff it holds one of the last `cs` tokens
        n_valid = min(cur_len + 1, cs)
        age = (slot - idx) % cs  # 0 = newest
        valid = age < n_valid
    else:
        valid = idx <= cur_len
    out = _sdpa(q, cache.k, cache.v, valid, cfg.head_dim)
    return torch.einsum("bshd,hdm->bsm", out, p["wo"]), cache


def prefill_cache(p: dict, cfg: ArchConfig, x: torch.Tensor, max_seq: int,
                  *, local: bool):
    """Run full attention over the prompt AND return the populated cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _full_attention(cfg, q, k, v, local)
    out = torch.einsum("bshd,hdm->bsm", out, p["wo"])
    cs = cache_size(cfg, local, max_seq)
    if cs >= s:
        ck = k.new_zeros((b, cs) + k.shape[2:])
        cv = v.new_zeros((b, cs) + v.shape[2:])
        ck[:, :s], cv[:, :s] = k, v
    else:  # keep the trailing window, aligned to ring slots
        start = s - cs
        # slot of token t is t % cs: k[:, start + i] lands at (start + i) % cs
        roll = start % cs
        ck = torch.roll(k[:, start:], roll, dims=1)
        cv = torch.roll(v[:, start:], roll, dims=1)
    return out, KVCache(ck, cv)
