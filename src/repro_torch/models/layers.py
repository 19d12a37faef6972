"""Primitive layers + parameter-spec machinery (the JAX package's
``models/layers.py`` in PyTorch).

Parameters are described by :class:`ParamSpec` (shape + logical axes +
init); ``init_params`` walks a spec tree and materialises it.  ``normal``
leaves draw from an explicit ``torch.Generator`` (``jax.random`` cannot be
reproduced in PyTorch: parity tests convert the JAX package's init instead,
``repro_torch.convert``); the deterministic inits are computed as JAX
computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import tree_map

Logical = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Logical
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt_bias
    scale: float = 1.0

    def materialise(self, generator: torch.Generator,
                    dtype=torch.float32) -> torch.Tensor:
        n = max(int(math.prod(self.shape)), 1)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype)
        if self.init == "ssm_a":
            # A_log init: A in [1, 16) -> log
            a = torch.linspace(1.0, 16.0, n, dtype=torch.float32)
            return torch.log(a.reshape(self.shape)).to(dtype)
        if self.init == "ssm_dt_bias":
            # dt bias s.t. softplus(dt_bias) in [1e-3, 1e-1]
            u = torch.linspace(0.0, 1.0, n, dtype=torch.float32)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                           + math.log(1e-3))
            inv = dt + torch.log(-torch.expm1(-dt))
            return inv.reshape(self.shape).to(dtype)
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[-1],
                                                               1)
        std = self.scale / math.sqrt(max(fan_in, 1))
        return (torch.randn(self.shape, generator=generator,
                            device=generator.device) * std).to(dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_params(specs: Any, generator: torch.Generator,
                dtype=torch.float32, device="cpu", cut: Any = None) -> Any:
    """Materialise ``specs`` leaf by leaf from one generator, drawing in
    the order JAX flattens the tree (dict keys sorted); each leaf is drawn
    where the generator lives, then moved to ``device``.  ``cut``, a tree
    like ``specs`` of functions, maps each leaf as soon as it is drawn
    (a rank's block of it: the whole tree is never held at once)."""
    if is_spec(specs):
        x = specs.materialise(generator, dtype)
        return (x if cut is None else cut(x)).to(device)
    sub = (lambda k: None) if cut is None else (lambda k: cut[k])
    if isinstance(specs, dict):
        out = {k: init_params(specs[k], generator, dtype, device, sub(k))
               for k in sorted(specs)}
        return {k: out[k] for k in specs}
    return type(specs)(init_params(s, generator, dtype, device, sub(i))
                       for i, s in enumerate(specs))


def stack_specs(specs: Any, n: int, axis_name: str = "layers") -> Any:
    """Add a stacked leading dim (repeated layers) to every spec."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.logical, s.init,
                            s.scale), specs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(dim: int, logical: str = "embed") -> ParamSpec:
    return ParamSpec((dim,), (logical,), init="ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
    angles = angles[..., None, :]                             # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_specs(d_model: int, d_ff: int) -> dict:
    return {
        "wi_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wi_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def swiglu(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """With ``tp`` (a ``TPLayout``) the hidden columns are this rank's:
    ``x`` enters through ``copy_to`` and the partial outputs are summed
    over the model axis."""
    if tp is not None:
        x = tp.copy_to(x)
    g = F.silu(x @ p["wi_gate"])
    out = (g * (x @ p["wi_up"])) @ p["wo"]
    return out if tp is None else tp.reduce_from(out)


def gelu_mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def gelu_mlp(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``tp`` as :func:`swiglu`'s."""
    if tp is not None:
        x = tp.copy_to(x)
    # jax.nn.gelu defaults to the tanh approximation
    out = F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]
    return out if tp is None else tp.reduce_from(out)
