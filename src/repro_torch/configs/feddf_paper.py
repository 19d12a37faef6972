"""The paper's own model scale: a small transformer standing in for the
ResNet-8 / DistilBERT client models used in the FedDF experiments
(Lin et al., NeurIPS 2020). Used by the paper-validation benchmarks and as
an 11th selectable config."""
from repro_torch.common.arch_config import ArchConfig, BlockSpec

CONFIG = ArchConfig(
    name="feddf-paper",
    family="dense",
    source="arXiv:2006.07242 (FedDF)",
    n_layers=4,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    pattern=(BlockSpec("attn_global", "swiglu"),),
)

# Heterogeneous prototypes for Algorithm 3 (Fig. 4: ResNet-20/32/ShuffleNetV2
# analogue = same family, different depth/width)
import dataclasses as _dc
PROTO_SMALL = _dc.replace(CONFIG, name="feddf-paper-s", n_layers=2, d_model=96,
                          n_heads=4, d_ff=192, head_dim=24)
PROTO_LARGE = _dc.replace(CONFIG, name="feddf-paper-l", n_layers=6,
                          d_model=160, n_heads=4, d_ff=320, head_dim=40)
