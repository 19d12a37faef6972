"""Dispatch of the port's kernels by the tensors' device.

A CPU tensor takes the kernel's plain version (``kernels/ref.py``); a CUDA
tensor takes the CUDA kernel, and a failed build or launch raises.  There
is no path on which a CUDA tensor silently reaches the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.common.options import FUSED_KERNEL_MODES
from repro_torch.kernels import ref


def use_fused_kernel(flag, device) -> bool:
    """Resolve ``FusionConfig.use_fused_kernel`` for tensors on ``device``.

    ``"auto"`` and ``True`` take the fused loss (the kernel on a CUDA
    device, its plain version on the CPU); ``True`` on the CPU raises,
    since the CUDA kernel has no CPU mode (the JAX package's interpret
    mode has no counterpart here).  ``False`` is the explicit unfused route.
    Any other value raises (``bool("off")`` would silently enable it)."""
    if flag == "auto":
        return True
    if not isinstance(flag, bool):
        raise ValueError(f"use_fused_kernel must be one of "
                         f"{FUSED_KERNEL_MODES}, got {flag!r}")
    if flag and torch.device(device).type != "cuda":
        raise NotImplementedError(
            "use_fused_kernel=True asks for the CUDA kernel, which runs on "
            "CUDA tensors only; use 'auto' (plain version on the CPU) or "
            "False.")
    return flag


def _check_on_cpu(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.is_cuda:
            raise ValueError(f"{name} is on {t.device} while the first "
                             f"operand is on the CPU")


def ensemble_kl_loss(student_logits: torch.Tensor,
                     teacher_logits: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """AVGLOGITS loss against the raw teachers (K2, the on-the-fly path).

    student: [..., V]; teachers: [K, ..., V] float32 or bfloat16; leading
    dims are flattened into rows."""
    v = student_logits.shape[-1]
    s2 = student_logits.reshape(-1, v)
    t2 = teacher_logits.reshape(teacher_logits.shape[0], -1, v)
    if s2.is_cuda:
        from repro_torch.kernels.ensemble_kl import ensemble_kl
        return ensemble_kl(s2, t2.contiguous(), temperature)
    _check_on_cpu(teacher_logits=t2)
    return ref.ensemble_kl(s2, t2, temperature)


def ensemble_kl_loss_pre(student_logits: torch.Tensor,
                         teacher_avg_logits: torch.Tensor,
                         temperature: float = 1.0) -> torch.Tensor:
    """AVGLOGITS loss against pre-averaged teacher rows (K3, the weighted
    teacher consensus).  student, teacher_avg: [..., V]."""
    v = student_logits.shape[-1]
    s2 = student_logits.reshape(-1, v)
    t2 = teacher_avg_logits.reshape(-1, v)
    if s2.is_cuda:
        from repro_torch.kernels.ensemble_kl import ensemble_kl_pre
        return ensemble_kl_pre(s2, t2.contiguous(), temperature)
    _check_on_cpu(teacher_avg_logits=t2)
    return ref.ensemble_kl_pre(s2, t2, temperature)


def ensemble_kl_loss_bank(student_logits: torch.Tensor,
                          bank_rows: torch.Tensor, scales, idx: torch.Tensor,
                          temperature: float = 1.0) -> torch.Tensor:
    """AVGLOGITS loss fused with the bank gather + dequantize (K1).

    student: [..., V]; bank_rows: [N, V] in the bank's storage dtype;
    scales: per-row [N] float32 dequant scales, or None for unquantized
    banks; idx: [...] int64 sampled bank rows."""
    v = student_logits.shape[-1]
    s2 = student_logits.reshape(-1, v)
    idx2 = idx.reshape(-1)
    if s2.is_cuda:
        from repro_torch.kernels.ensemble_kl_bank import ensemble_kl_bank
        return ensemble_kl_bank(s2, bank_rows, scales, idx2, temperature)
    _check_on_cpu(bank_rows=bank_rows, idx=idx2, scales=scales)
    row_scale = (torch.ones(idx2.shape, dtype=torch.float32)
                 if scales is None else scales[idx2].float())
    return ref.ensemble_kl_bank(s2, bank_rows, row_scale, idx2, temperature)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int] = None) -> torch.Tensor:
    """Causal attention, optionally windowed (K4): q [B,H,S,D], k/v
    [B,H_kv,S,D] with H_kv dividing H (grouped-query attention); the output
    is in q's dtype."""
    if q.is_cuda:
        from repro_torch.kernels.swa_attn import swa_attn
        return swa_attn(q, k, v, window)
    _check_on_cpu(k=k, v=v)
    return ref.swa_attn(q, k, v, window)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan from a zero state (K5): x [B,S,H,P], dt [B,S,H],
    a_log [H], bmat / cmat [B,S,N] -> (y [B,S,H,P] in x's dtype, final
    state [B,H,N,P] float32).  The plain version scans in chunks of
    ``chunk``; the kernel in its own (``ssd_scan.CHUNK``)."""
    if x.is_cuda:
        from repro_torch.kernels.ssd_scan import ssd_scan as kernel
        return kernel(x.contiguous(), dt.float().contiguous(),
                      a_log.float().contiguous(), bmat.contiguous(),
                      cmat.contiguous())
    _check_on_cpu(dt=dt, a_log=a_log, bmat=bmat, cmat=cmat)
    return ref.ssd_scan(x, dt, a_log, bmat, cmat, chunk)
