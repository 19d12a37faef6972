"""Modality frontend stubs (the JAX package's ``models/frontends.py`` in
PyTorch).

[audio]/[vlm] architectures specify the transformer backbone only; the
mel-spectrogram + conv feature extractor (HuBERT) and the ViT/projector
(InternVL2) are represented by precomputed embeddings of the right shape.
This module documents the expected shapes and draws random embeddings for
smoke runs from an explicit ``torch.Generator`` (on the generator's
device, then moved to ``device``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.common.arch_config import ArchConfig


class EmbedSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def audio_frames_spec(cfg: ArchConfig, batch: int, seq: int) -> EmbedSpec:
    """HuBERT-style: conv feature extractor output, one embedding per frame."""
    return EmbedSpec((batch, seq, cfg.d_model), torch.bfloat16)


def vision_patches_spec(cfg: ArchConfig, batch: int) -> EmbedSpec:
    """InternVL2-style: projected ViT patch embeddings prepended to text."""
    return EmbedSpec((batch, cfg.n_frontend_tokens, cfg.d_model),
                     torch.bfloat16)


def _normal(generator: torch.Generator, shape, dtype, device):
    return (torch.randn(shape, generator=generator, device=generator.device)
            * 0.02).to(dtype=dtype, device=device)


def fake_audio_frames(generator: torch.Generator, cfg: ArchConfig,
                      batch: int, seq: int, dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
    return _normal(generator, (batch, seq, cfg.d_model), dtype, device)


def fake_vision_patches(generator: torch.Generator, cfg: ArchConfig,
                        batch: int, dtype=torch.float32,
                        device="cpu") -> torch.Tensor:
    return _normal(generator, (batch, cfg.n_frontend_tokens, cfg.d_model),
                   dtype, device)
