"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
MoE 32 experts top-8, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,         # per-expert intermediate size
    vocab_size=49155,
    head_dim=64,
    tie_embeddings=True,
    n_experts=32,
    top_k=8,
    pattern=(BlockSpec("attn_global", "moe"),),
)
