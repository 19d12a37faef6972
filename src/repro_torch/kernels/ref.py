"""Plain PyTorch versions of the port's kernels (the allclose ground truth
on the card, and what CPU tensors run)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ensemble_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """KL( softmax(mean_k teachers / T), softmax(student / T) ) * T^2,
    mean over batch rows.  student: [B, V]; teachers: [K, B, V]."""
    t = teacher_logits.float().mean(dim=0) / temperature
    s = student_logits.float() / temperature
    logp_t = F.log_softmax(t, dim=-1)
    logp_s = F.log_softmax(s, dim=-1)
    kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_s), dim=-1)
    return kl.mean() * temperature ** 2


def ensemble_kl_bank(student_logits: torch.Tensor, bank_rows: torch.Tensor,
                     row_scale: torch.Tensor, idx: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """Plain version of the fused bank kernel pair (K1): gather the sampled
    bank rows, dequantize with their per-row scales, then the AVGLOGITS KL;
    autograd gives its gradient.  bank_rows: [N, V] any storage dtype;
    row_scale / idx: [B]."""
    t = bank_rows[idx].float() * row_scale[:, None]
    return ensemble_kl(student_logits, t[None], temperature)
