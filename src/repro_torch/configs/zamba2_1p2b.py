"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + SHARED-parameter attention blocks
(one attention weight set reused across the depth). [arXiv:2411.15242]

Layout: 38 layers = 5 x (6 mamba2 + 1 shared-attn) + 3 mamba2 (remainder).
"""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    pattern=tuple([BlockSpec("mamba", "none")] * 6
                  + [BlockSpec("shared_attn", "swiglu")]),
)
