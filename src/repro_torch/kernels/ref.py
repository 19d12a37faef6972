"""Plain PyTorch versions of the port's kernels (the allclose ground truth
on the card, and what CPU tensors run)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _mean_teacher(teacher_logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """``mean_k(t_k / T)`` in float32, in the Pallas kernel's order: the
    division happens in the teachers' own dtype (a bf16 quotient is
    rounded to bf16), then the mean over K in float32."""
    return (teacher_logits / temperature).float().mean(dim=0)


def ensemble_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """KL( softmax(mean_k teachers / T), softmax(student / T) ) * T^2,
    mean over batch rows.  student: [B, V]; teachers: [K, B, V].  Plain
    version of K2 (its gradient is autograd's)."""
    t = _mean_teacher(teacher_logits, temperature)
    s = (student_logits / temperature).float()
    logp_t = F.log_softmax(t, dim=-1)
    logp_s = F.log_softmax(s, dim=-1)
    kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_s), dim=-1)
    return kl.mean() * temperature ** 2


def ensemble_kl_grad(student_logits: torch.Tensor,
                     teacher_logits: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """d loss / d student = (softmax(s/T) - softmax(t̄/T)) * T / B, the
    plain version of K2b for a unit cotangent."""
    b = student_logits.shape[0]
    t = _mean_teacher(teacher_logits, temperature)
    s = (student_logits / temperature).float()
    g = (torch.softmax(s, -1) - torch.softmax(t, -1)) * temperature / b
    return g.to(student_logits.dtype)


def ensemble_kl_pre(student_logits: torch.Tensor,
                    teacher_avg_logits: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Plain version of K3: the K2 loss against pre-averaged teacher rows
    [B, V] (the weighted consensus)."""
    return ensemble_kl(student_logits, teacher_avg_logits[None], temperature)


def ensemble_kl_bank(student_logits: torch.Tensor, bank_rows: torch.Tensor,
                     row_scale: torch.Tensor, idx: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """Plain version of the fused bank kernel pair (K1): gather the sampled
    bank rows, dequantize with their per-row scales, then the AVGLOGITS KL;
    autograd gives its gradient.  bank_rows: [N, V] any storage dtype;
    row_scale / idx: [B]."""
    t = bank_rows[idx].float() * row_scale[:, None]
    return ensemble_kl(student_logits, t[None], temperature)
