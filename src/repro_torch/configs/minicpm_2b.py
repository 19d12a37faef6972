"""minicpm-2b [dense]: 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753 —
llama-like arch, WSD (warmup-stable-decay) schedule. [arXiv:2404.06395]"""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    tie_embeddings=True,
    lr_schedule="wsd",
    pattern=(BlockSpec("attn_global", "swiglu"),),
)
