"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 —
encoder-only (bidirectional), conv feature-extractor frontend is a stub
delivering frame embeddings. [arXiv:2106.07447]"""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,   # HuBERT cluster-unit targets
    head_dim=80,
    causal=False,     # encoder-only
    frontend="audio_frames",
    pattern=(BlockSpec("attn_global", "gelu"),),
)
