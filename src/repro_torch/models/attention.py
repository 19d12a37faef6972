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
``_sdpa`` groups them); ``cfg.causal`` picks K4's mode, bidirectional for
the encoder-only hubert (a window stays one-sided, as ``_make_mask`` masks).
Decode attends over the cache in plain PyTorch (``_sdpa``), as JAX does
outside any Pallas kernel.

Local layers use a ring-buffer cache of size ``window``.

Tensor parallelism (``tp``, a ``common/sharding.TPLayout``): a rank holds
its block of the query heads (``wq``, ``wo``) and of the key / value
heads where their count divides the model axis; where it does not,
``fit_pspec`` leaves them whole and the rank takes the key / value heads
its query heads read (global query head ``g`` reads ``g // (H / KV)``),
so K4 runs at (H_local, KV_local).  The normed input, and every weight
left whole but used for this rank's heads only (the key / value
projections then, ``q_norm`` / ``k_norm``), enter through ``copy_to``;
the output projection's partial sums through ``reduce_from``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.common import sharding as shd
from repro_torch.common.arch_config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (ParamSpec, apply_rope, rmsnorm,
                                       rmsnorm_spec)


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


def kv_keep(cfg: ArchConfig, h_loc: int, model_index: int):
    """The key / value heads a rank holding query heads ``[model_index *
    h_loc, (model_index + 1) * h_loc)`` reads when the key / value heads
    are whole on every rank: a contiguous run where its query heads group
    evenly onto them (K4's grouped-query mode), else one per query
    head."""
    rep = cfg.n_heads // cfg.n_kv_heads
    g0 = model_index * h_loc
    need = torch.arange(g0, g0 + h_loc) // rep
    lo, n = int(need[0]), int(need[-1]) + 1 - int(need[0])
    if h_loc % n == 0 and torch.equal(
            need, lo + torch.arange(h_loc) // (h_loc // n)):
        return torch.arange(lo, lo + n)
    return need


def _tp_params(p: dict, cfg: ArchConfig, tp):
    """(params, tp) for this rank: ``tp`` None where the heads are whole
    here; else the whole weights used for this rank's heads only through
    ``copy_to``, and the key / value heads its query heads read."""
    h_loc = p["wq"].shape[1]
    if tp is None or h_loc == cfg.n_heads:
        return p, None
    p = dict(p)
    for k in ("q_norm", "k_norm"):
        if k in p:
            p[k] = tp.copy_to(p[k])
    if p["wk"].shape[1] == cfg.n_kv_heads:   # key / value heads whole
        keep = kv_keep(cfg, h_loc, tp.model_index)
        for k in ("wk", "wv"):
            p[k] = tp.copy_to(p[k])[:, keep.to(p[k].device)]
    return p, tp


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
    """Attention over the whole sequence through K4, causal or not as the
    config says, optionally windowed: q [B,S,H,D] and k / v [B,S,KV,D] in,
    [B,S,H,D] out."""
    to_bhsd = lambda t: t.transpose(1, 2).contiguous()
    out = ops.swa_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                            cfg.window if local else None, cfg.causal)
    return out.transpose(1, 2)


def attention(p: dict, cfg: ArchConfig, x: torch.Tensor, *, local: bool,
              tp=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill); ``tp`` a
    ``TPLayout`` (this rank's heads)."""
    p, tp = _tp_params(p, cfg, tp)
    if tp is not None:
        x = tp.copy_to(x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _full_attention(cfg, q, k, v, local)
    out = torch.einsum("bshd,hdm->bsm", out, p["wo"])
    return out if tp is None else tp.reduce_from(out)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------

def cache_size(cfg: ArchConfig, local: bool, max_seq: int) -> int:
    return min(cfg.window, max_seq) if local else max_seq


def init_cache(cfg: ArchConfig, local: bool, batch: int, max_seq: int,
               dtype=torch.float32, device="cpu", kv_heads=None) -> KVCache:
    """Zero caches at ``kv_heads`` heads (all of them by default)."""
    cs = cache_size(cfg, local, max_seq)
    shape = (batch, cs, kv_heads or cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def cache_logical_axes(local: bool) -> KVCache:
    """A cache leaf's logical axes (``common/sharding.tree_pspecs``)."""
    del local
    ax = ("batch", "cache_seq", "kv_heads", "qkv")
    return KVCache(ax, ax)


def _valid_slots(cs: int, idx: torch.Tensor, slot: int, cur_len: int,
                 local: bool) -> torch.Tensor:
    """Which cache slots ``idx`` (of ``cs``) hold a token once the new
    one is in ``slot``."""
    if local:
        # ring buffer: slot occupied iff it holds one of the last `cs` tokens
        n_valid = min(cur_len + 1, cs)
        age = (slot - idx) % cs  # 0 = newest
        return age < n_valid
    return idx <= cur_len


def decode_step(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                cur_len: int, *, local: bool, tp=None, seq_axes=()):
    """One-token decode.  x: [B, 1, d_model]; cur_len: tokens already in
    the cache.  Returns (out [B,1,d], cache); the new key and value are
    written into ``cache`` in place (JAX returns an updated copy).  With
    ``tp`` (a ``TPLayout``: this rank's heads) the cache is this rank's
    block of the sequence split over ``seq_axes``, every head whole."""
    if tp is not None:
        return _decode_split(p, cfg, x, cache, cur_len, local, tp, seq_axes)
    b = x.shape[0]
    cs = cache.k.shape[1]
    positions = torch.full((b, 1), cur_len, dtype=torch.int64,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)

    slot = cur_len % cs
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]

    valid = _valid_slots(cs, torch.arange(cs, device=x.device), slot,
                         cur_len, local)
    out = _sdpa(q, cache.k, cache.v, valid, cfg.head_dim)
    return torch.einsum("bshd,hdm->bsm", out, p["wo"]), cache


def _decode_split(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                  cur_len: int, local: bool, tp, seq_axes):
    """``decode_step`` on a sequence-split cache (the module docstring).
    The key / value weights are whole where their heads do not divide the
    model axis, so a rank then projects every key / value head itself."""
    b = x.shape[0]
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h_loc = p["wq"].shape[1]
    positions = torch.full((b, 1), cur_len, dtype=torch.int64,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    if h_loc != h:                 # gather the heads' projections
        kv_loc = k_new.shape[2] if k_new.shape[2] != kvh else 0
        parts = [q, k_new, v_new] if kv_loc else [q]
        new = shd.all_gather(torch.cat(parts, dim=2), tp.mesh,
                             (tp.model_axis,), dim=2)
        new = new.reshape(b, 1, tp.model_size, h_loc + 2 * kv_loc, d)
        q = new[:, :, :, :h_loc].reshape(b, 1, h, d)
        if kv_loc:
            k_new = new[:, :, :, h_loc:h_loc + kv_loc].reshape(b, 1, kvh, d)
            v_new = new[:, :, :, h_loc + kv_loc:].reshape(b, 1, kvh, d)

    cs_loc = cache.k.shape[1]
    i_seq, n_seq = shd.block_index(tp.mesh, seq_axes)
    cs = cs_loc * n_seq
    slot = cur_len % cs
    if slot // cs_loc == i_seq:    # this rank holds the new token's slot
        cache.k[:, slot % cs_loc] = k_new[:, 0]
        cache.v[:, slot % cs_loc] = v_new[:, 0]
    idx = i_seq * cs_loc + torch.arange(cs_loc, device=x.device)
    valid = _valid_slots(cs, idx, slot, cur_len, local)

    # this rank's slots: the softmax's running max m, sum l and output o
    rep = h // kvh
    qr = q.reshape(b, 1, kvh, rep, d)
    scores = torch.einsum("bskrd,btkd->bkrst", qr, cache.k) / math.sqrt(d)
    scores = torch.where(valid, scores, torch.finfo(scores.dtype).min)
    scores = scores.float()
    m = scores.amax(dim=-1, keepdim=True)                  # [B,KV,R,1,1]
    e = torch.exp(scores - m)
    o = torch.einsum("bkrst,btkd->bkrsd", e, cache.v.float())
    l = e.sum(dim=-1, keepdim=True)
    if seq_axes:
        top = shd.all_reduce_max(m, tp.mesh, seq_axes)
        c = torch.exp(m - top)
        lo = shd.all_reduce_sum(torch.cat([l * c, o * c], dim=-1), tp.mesh,
                                seq_axes)
        l, o = lo[..., :1], lo[..., 1:]
    out = (o / l).to(q.dtype)                              # [B,KV,R,1,D]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, d)
    if h_loc == h:
        return torch.einsum("bshd,hdm->bsm", out, p["wo"]), cache
    h0 = tp.model_index * h_loc
    out = torch.einsum("bshd,hdm->bsm", out[:, :, h0:h0 + h_loc], p["wo"])
    return tp.reduce_from(out), cache


def prefill_cache(p: dict, cfg: ArchConfig, x: torch.Tensor, max_seq: int,
                  *, local: bool, tp=None):
    """Run full attention over the prompt AND return the populated cache
    (with ``tp``, at the key / value heads this rank's heads read)."""
    p, tp = _tp_params(p, cfg, tp)
    if tp is not None:
        x = tp.copy_to(x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _full_attention(cfg, q, k, v, local)
    out = torch.einsum("bshd,hdm->bsm", out, p["wo"])
    if tp is not None:
        out = tp.reduce_from(out)
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
