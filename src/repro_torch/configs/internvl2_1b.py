"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT (stub) + Qwen2-0.5B-style LM. [arXiv:2404.16821]"""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    tie_embeddings=True,
    frontend="vision_patches",
    n_frontend_tokens=256,   # projected ViT patch embeddings (stub)
    pattern=(BlockSpec("attn_global", "swiglu"),),
)
