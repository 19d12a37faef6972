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


def ssm_forward(p: dict, cfg: ArchConfig, hidden: torch.Tensor,
                init_cache: SSMCache | None = None,
                return_cache: bool = False):
    """Full-sequence Mamba2 block. hidden: [B,S,d_model].  With
    ``init_cache`` the block continues from a cache (its conv history ahead
    of the causal conv, its state as the scan's initial state)."""
    b, s, _ = hidden.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hd = di // nh

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
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out"]
    if return_cache:
        w = cfg.ssm_conv
        src = xbc_in if init_cache is not None else torch.cat(
            [xbc.new_zeros((b, w - 1, xbc.shape[-1])), xbc], dim=1)
        return out, SSMCache(src[:, -(w - 1):].clone(), final_state)
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cpu") -> SSMCache:
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hd = di // nh
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * ns), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, nh, ns, hd), dtype=torch.float32,
                          device=device),
    )


def ssm_decode_step(p: dict, cfg: ArchConfig, hidden: torch.Tensor,
                    cache: SSMCache):
    """One-token decode. hidden: [B,1,d_model] -> (out [B,1,d], cache);
    the cache's conv history and state are updated in place (JAX returns
    an updated copy)."""
    b = hidden.shape[0]
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    hd = di // nh
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
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = (y @ p["out"])[:, None]
    cache.conv.copy_(hist[:, 1:])
    return out, cache
