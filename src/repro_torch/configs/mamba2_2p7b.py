"""mamba2-2.7b [ssm]: 64L d_model=2560 attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=8,      # unused (attention-free); kept for config uniformity
    n_kv_heads=8,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    pattern=(BlockSpec("mamba", "none"),),
)
