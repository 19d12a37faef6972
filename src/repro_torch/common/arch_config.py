"""Architecture configuration dataclasses.

Every assigned architecture (and the paper's own small nets) is described by
an :class:`ArchConfig`.  The model stack (`repro_torch.models.transformer`)
consumes this config to build parameters and forward functions.  A verbatim
copy of the JAX package's ``common/arch_config.py`` (the port imports
nothing of that package).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

LayerKind = Literal["attn_global", "attn_local", "mamba", "shared_attn"]
MlpKind = Literal["swiglu", "gelu", "moe", "none"]
Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer of the repeating block pattern."""

    mixer: LayerKind
    mlp: MlpKind


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Full description of one architecture.

    The repeating ``pattern`` is applied ``n_layers`` times by truncating /
    cycling: layer ``i`` uses ``pattern[i % len(pattern)]``.  This preserves
    exact layer counts for non-uniform stacks (gemma3's 5:1 local:global,
    zamba2's mamba+shared-attn interleave).
    """

    name: str
    family: Family
    source: str  # citation from the assignment table

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    pattern: Tuple[BlockSpec, ...]

    head_dim: Optional[int] = None  # default: d_model // n_heads
    qk_norm: bool = False
    causal: bool = True  # False for encoder-only (hubert)
    window: int = 1024  # sliding window size for attn_local layers
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 1e-2

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0  # number of SSD heads; default d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- modality frontend stubs ---
    frontend: Literal["none", "audio_frames", "vision_patches"] = "none"
    n_frontend_tokens: int = 0  # patch/frame tokens prepended by the stub

    # --- schedules / training quirks recorded with the arch ---
    lr_schedule: Literal["cosine", "wsd", "constant"] = "cosine"

    # --- execution variants (§Perf levers, not architecture identity) ---
    # naive: materialise [S,T] scores; chunked: flash-pattern online-softmax
    # scan over KV chunks (HLO analogue of kernels/swa_attn.py)
    attn_impl: Literal["naive", "chunked"] = "naive"
    attn_chunk: int = 1024

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.name}: n_heads must be a multiple of n_kv_heads"
        )
        assert len(self.pattern) >= 1

    # ------------------------------------------------------------------
    def layer_spec(self, i: int) -> BlockSpec:
        return self.pattern[i % len(self.pattern)]

    @property
    def layer_kinds(self) -> Tuple[BlockSpec, ...]:
        return tuple(self.layer_spec(i) for i in range(self.n_layers))

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def has_attention(self) -> bool:
        return any(b.mixer != "mamba" for b in self.pattern)

    @property
    def has_mamba(self) -> bool:
        return any(b.mixer == "mamba" for b in self.pattern)

    @property
    def has_moe(self) -> bool:
        return any(b.mlp == "moe" for b in self.pattern)

    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can serve a 500k-token context.

        SSM/hybrid archs carry O(1)/windowed state; dense archs qualify only
        if every attention layer is sliding-window or the global layers are a
        small minority (gemma3: decode cost is linear, local layers keep a
        window-sized cache).
        """
        if not self.has_attention:
            return True
        if self.family in ("ssm", "hybrid"):
            return True
        return all(b.mixer in ("attn_local", "mamba") for b in self.pattern) or (
            sum(b.mixer == "attn_global" for b in self.pattern)
            <= len(self.pattern) // 4
        )

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        hd = self.head_dim
        for spec in self.layer_kinds:
            if spec.mixer in ("attn_global", "attn_local", "shared_attn"):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o + d  # + norm
                if self.qk_norm:
                    total += 2 * hd
            elif spec.mixer == "mamba":
                di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
                in_proj = d * (2 * di + 2 * ns + nh)
                conv = self.ssm_conv * (di + 2 * ns)
                total += in_proj + conv + nh * 2 + di * d + d  # A,D + out + norm
            if spec.mlp in ("swiglu",):
                total += 3 * d * self.d_ff + d
            elif spec.mlp == "gelu":
                total += 2 * d * self.d_ff + d
            elif spec.mlp == "moe":
                total += self.n_experts * 3 * d * self.d_ff  # experts (swiglu)
                total += d * self.n_experts + d  # router + norm
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.has_moe:
            return self.param_count()
        d = self.d_model
        dense_every = self.param_count()
        moe_layers = sum(b.mlp == "moe" for b in self.layer_kinds)
        all_expert = moe_layers * self.n_experts * 3 * d * self.d_ff
        active_expert = moe_layers * self.top_k * 3 * d * self.d_ff
        return dense_every - all_expert + active_expert


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Smoke-test variant: same family/pattern, tiny dims."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.pattern) // 3)) if len(cfg.pattern) > 1 else 2,
        d_model=min(cfg.d_model, 128),
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 503),
        head_dim=32,
        window=32,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 8),
        name=cfg.name + "-smoke",
    )
    # keep at least one full pattern repetition
    if len(cfg.pattern) > 1:
        small["n_layers"] = len(cfg.pattern)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
