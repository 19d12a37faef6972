"""Config registry: ``get(name)`` resolves ``--arch <id>``."""
from __future__ import annotations

from repro_torch.common.arch_config import ArchConfig, reduced
from repro_torch.configs.shapes import SHAPES, InputShape

from repro_torch.configs import (  # noqa: F401
    feddf_paper,
    gemma3_4b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    internvl2_1b,
    mamba2_2p7b,
    minicpm_2b,
    phi3_medium_14b,
    qwen3_8b,
    qwen3_moe_235b_a22b,
    zamba2_1p2b,
)

_MODULES = [
    gemma3_4b, mamba2_2p7b, qwen3_8b, hubert_xlarge, qwen3_moe_235b_a22b,
    minicpm_2b, internvl2_1b, phi3_medium_14b, granite_moe_1b_a400m,
    zamba2_1p2b, feddf_paper,
]

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ASSIGNED = [m.CONFIG.name for m in _MODULES[:10]]


def get(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduced(get(name[: -len("-smoke")]))
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def applicable(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) lowers, and the skip reason if not."""
    if shape.kind == "decode":
        if not cfg.is_decoder:
            return False, "encoder-only architecture: no decode step"
        if shape.seq_len > 100_000 and not cfg.sub_quadratic:
            return False, ("pure full-attention arch: 500k context requires "
                           "sub-quadratic attention (see DESIGN.md)")
    return True, ""
