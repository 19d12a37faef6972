"""Mamba2 block via State Space Duality (SSD) (the JAX package's
``models/ssm.py`` in PyTorch).

The full-sequence scan goes through ``kernels/ops.ssd_scan``: K5 on CUDA
tensors (which also returns the final state the prefill cache needs, and
starts from a cache's state when given one), the plain chunked SSD
(``kernels/ref.ssd_scan``) on the CPU.  The one-token decode step stays
plain PyTorch, as JAX computes it outside any Pallas kernel.

Layout: x:[B,S,H,P] heads H = d_inner/head_dim, state N = ssm_state,
B/C shared across heads (n_groups = 1).

Recurrence (per head): h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T,
y_t = C_t . h_t + D * x_t.

Tensor parallelism (``tp``, a ``common/sharding.TPLayout``): a rank holds
its block of the SSM heads (``wdt``, ``dt_bias``, ``A_log``, ``D``) and
of the inner channels they own (``wz``, ``wx``, ``norm``, ``out``); K5
runs at its heads.  ``conv_w`` / ``conv_b`` are logically ``"inner"``
over ``d_inner + 2 * ssm_state`` channels, whose contiguous blocks would
not line up with the ``[x | B | C]`` layout: the port splits them by
segment instead (``sharding.Segmented``), the x channels of this rank's
heads and B and C whole, a deviation from JAX's block split that
``transformer.param_pspecs`` states and ``shard_tree`` / ``gather_tree``
translate.  ``wB`` / ``wC`` (logical ``"state"``, never sharded) and the
conv's B / C channels are whole on every rank but serve its heads only,
so they enter through ``copy_to`` and their gradients are summed over the
model axis.  The gated RMSNorm takes its mean over the whole ``d_inner``:
the sum of squares is summed over the model axis (``sum_over``) and
divided by the full width.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.common.arch_config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, rmsnorm, rmsnorm_spec


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [B, conv_w - 1, conv_channels]
    state: torch.Tensor  # [B, H, N, P] float32


def ssm_specs(cfg: ArchConfig) -> dict:
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    w = cfg.ssm_conv
    return {
        "wz": ParamSpec((d, di), ("embed", "inner")),
        "wx": ParamSpec((d, di), ("embed", "inner")),
        "wB": ParamSpec((d, ns), ("embed", "state")),
        "wC": ParamSpec((d, ns), ("embed", "state")),
        "wdt": ParamSpec((d, nh), ("embed", "heads")),
        "conv_w": ParamSpec((w, di + 2 * ns), (None, "inner")),
        "conv_b": ParamSpec((di + 2 * ns,), ("inner",), init="zeros"),
        "dt_bias": ParamSpec((nh,), ("heads",), init="ssm_dt_bias"),
        "A_log": ParamSpec((nh,), ("heads",), init="ssm_a"),
        "D": ParamSpec((nh,), ("heads",), init="ones"),
        "norm": rmsnorm_spec(di, "inner"),
        "out": ParamSpec((di, d), ("inner", "embed")),
    }


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]; w: [W, C]."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):  # width is 4: unrolled adds, as in JAX
        out = out + xp[:, i: i + x.shape[1]] * w[i]
    return out + b


def _tp_params(p: dict, cfg: ArchConfig, tp):
    """(params, tp, local heads): ``tp`` None where the heads are whole
    here; else the whole weights that serve this rank's heads only
    through ``copy_to`` (the conv's B / C channels split off and
    rejoined)."""
    nh_loc = p["A_log"].shape[0]
    if tp is None or nh_loc == cfg.n_ssm_heads:
        return p, None, nh_loc
    di_loc = nh_loc * (cfg.d_inner // cfg.n_ssm_heads)
    p = dict(p, wB=tp.copy_to(p["wB"]), wC=tp.copy_to(p["wC"]))
    for k in ("conv_w", "conv_b"):
        w = p[k]
        p[k] = torch.cat([w[..., :di_loc], tp.copy_to(w[..., di_loc:])],
                         dim=-1)
    return p, tp, nh_loc


def _gated_norm(w: torch.Tensor, x: torch.Tensor, eps: float, width: int,
                tp) -> torch.Tensor:
    """``rmsnorm`` over the whole inner width when ``x`` holds this
    rank's channels of it."""
    if tp is None:
        return rmsnorm(w, x, eps)
    dt = x.dtype
    x = x.float()
    var = tp.sum_over(torch.sum(x * x, dim=-1, keepdim=True)) / width
    return (x * torch.rsqrt(var + eps) * w.float()).to(dt)


def ssm_forward(p: dict, cfg: ArchConfig, hidden: torch.Tensor,
                init_cache: SSMCache | None = None,
                return_cache: bool = False, tp=None):
    """Full-sequence Mamba2 block. hidden: [B,S,d_model].  With
    ``init_cache`` the block continues from a cache (its conv history ahead
    of the causal conv, its state as the scan's initial state).  ``tp`` a
    ``TPLayout``: this rank's heads, its cache at them."""
    b, s, _ = hidden.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    p, tp, nh = _tp_params(p, cfg, tp)
    hd = di // cfg.n_ssm_heads
    width, di = di, nh * hd
    if tp is not None:
        hidden = tp.copy_to(hidden)

    z = hidden @ p["wz"]
    xbc = torch.cat([hidden @ p["wx"], hidden @ p["wB"], hidden @ p["wC"]],
                    dim=-1)
    dt_raw = hidden @ p["wdt"]

    if init_cache is not None:
        xbc_in = torch.cat([init_cache.conv, xbc], dim=1)
        conv_out = _causal_conv(p["conv_w"], p["conv_b"], xbc_in)[:, -s:]
    else:
        conv_out = _causal_conv(p["conv_w"], p["conv_b"], xbc)
    conv_out = F.silu(conv_out)
    x = conv_out[..., :di].reshape(b, s, nh, hd)
    bmat = conv_out[..., di: di + ns]
    cmat = conv_out[..., di + ns:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    y, final_state = ops.ssd_scan(
        x, dt, p["A_log"], bmat, cmat, cfg.ssm_chunk,
        None if init_cache is None else init_cache.state)
    y = y + p["D"][None, None, :, None] * x
    y = y.reshape(b, s, di)
    y = _gated_norm(p["norm"], y * F.silu(z), cfg.norm_eps, width, tp)
    out = y @ p["out"]
    if tp is not None:
        out = tp.reduce_from(out)
    if return_cache:
        w = cfg.ssm_conv
        src = xbc_in if init_cache is not None else torch.cat(
            [xbc.new_zeros((b, w - 1, xbc.shape[-1])), xbc], dim=1)
        return out, SSMCache(src[:, -(w - 1):].clone(), final_state)
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cpu", heads=None) -> SSMCache:
    """Zero caches at ``heads`` SSM heads (all of them by default) and
    their conv channels."""
    ns, nh = cfg.ssm_state, heads or cfg.n_ssm_heads
    hd = cfg.d_inner // cfg.n_ssm_heads
    di = nh * hd
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * ns), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, nh, ns, hd), dtype=torch.float32,
                          device=device),
    )


def ssm_cache_logical_axes() -> SSMCache:
    """A cache's logical axes (JAX's; ``transformer.cache_pspecs`` lays
    the conv history out by segment, as the conv's weights)."""
    return SSMCache(conv=("batch", None, "inner"),
                    state=("batch", "heads", "state", None))


def ssm_decode_step(p: dict, cfg: ArchConfig, hidden: torch.Tensor,
                    cache: SSMCache, tp=None):
    """One-token decode. hidden: [B,1,d_model] -> (out [B,1,d], cache);
    the cache's conv history and state are updated in place (JAX returns
    an updated copy).  ``tp`` a ``TPLayout``: this rank's heads and inner
    channels, its cache at them (the conv history's x channels of its
    heads, B and C whole), the gated norm's sum of squares summed over
    the model axis and the output projection's partial sums too."""
    b = hidden.shape[0]
    ns = cfg.ssm_state
    hd = cfg.d_inner // cfg.n_ssm_heads
    p, tp, nh = _tp_params(p, cfg, tp)
    di = nh * hd
    h1 = hidden[:, 0]  # [B, d]

    z = h1 @ p["wz"]
    xbc_new = torch.cat([h1 @ p["wx"], h1 @ p["wB"], h1 @ p["wC"]],
                        dim=-1)  # [B, C]
    dt_raw = h1 @ p["wdt"]

    # conv over (stored w-1 inputs, new input)
    hist = torch.cat([cache.conv, xbc_new[:, None]], dim=1)  # [B,W,C]
    conv_out = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out)
    x = conv_out[:, :di].reshape(b, nh, hd)
    bmat = conv_out[:, di: di + ns]
    cmat = conv_out[:, di + ns:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,H]
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * a)  # [B,H]
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, bmat.float(), x.float())
    state = cache.state.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), state)
    y = y + p["D"][None, :, None] * x.float()
    y = y.reshape(b, di).to(hidden.dtype)
    y = _gated_norm(p["norm"], y * F.silu(z), cfg.norm_eps, cfg.d_inner, tp)
    out = (y @ p["out"])[:, None]
    if tp is not None:
        out = tp.reduce_from(out)
    cache.conv.copy_(hist[:, 1:])
    return out, cache
