"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    qk_norm=True,
    window=1024,
    tie_embeddings=True,
    # 5 sliding-window (local) layers per 1 full (global) layer
    pattern=tuple([BlockSpec("attn_local", "swiglu")] * 5
                  + [BlockSpec("attn_global", "swiglu")]),
)
