"""The fused logit-bank KL kernel pair on the card (K1f / K1b).

CUDA source: ``kernels/csrc/ensemble_kl_bank.cu``; it replaces the Pallas
TPU kernels ``_bank_fwd_kernel`` / ``_bank_bwd_kernel`` of the JAX
package's ``kernels/ensemble_kl.py``.  :func:`ensemble_kl_bank` binds the
pair as one ``torch.autograd.Function``: the loss ``T^2 * mean_b KL(
softmax(bank[idx_b] * scale_b / T) || softmax(s_b / T))`` is
differentiable in the student logits only (no gradient for the bank,
scales or indices).

These wrappers take CUDA tensors only; ``kernels/ops.py`` routes CPU
tensors to the plain version in ``kernels/ref.py``.  Every launch adds one
to ``LAUNCHES[<kernel>]``, so a run can show it went through the kernels.

Each launch takes its shape from K2/K3's host-side plan at one teacher
with K1's own cluster threshold, :func:`card_plan` (:func:`plan` on the
CPU): the forward's mode (lane groups, a thread-block cluster per row or
one block per row), lanes per row, cluster size, threads and grid, and the
backward's flat grid, which :func:`bwd_grid` caps at one wave of resident
blocks.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ensemble_kl
from repro_torch.kernels.ensemble_kl import MODES, Plan, card_sms

SOURCE = "ensemble_kl_bank"
LAUNCHES: Dict[str, int] = {"ensemble_kl_bank_fwd": 0,
                            "ensemble_kl_bank_bwd": 0}
# bank storage dtype -> the C interface's bank_kind
BANK_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}

# K1's own cluster threshold.  A row's element costs K1 one student and one
# bank load, so on an H100 one block per row beats every cluster up to
# V ~ 2000 at B = 16, ~ 4000 at B = 64 and ~ 5000 at B = 128, where K2's
# threshold (V > 512) sends V = 513 to a cluster 30-50% slower than a block
# (chip_smoke.py's K1 mode timings; PERF.md).
CLUSTER_MIN_V = 4096
# The flat backward's grid stops at one wave, BWD_BLOCKS_PER_SM blocks of
# the plan's threads on each SM (the kernel's __launch_bounds__), and walks
# grid-stride past it: at a vocabulary-sized V the plan's grid of one
# element a thread is ~20% slower on an H100 (chip_smoke.py times both at
# (B, V) = (1024, 32000); PERF.md).  Smaller grids stay under the cap.
BWD_BLOCKS_PER_SM = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # student, bank, scales, idx, kl, lse_t, lse_s, B, N, V, inv_t, kind,
    # mode, lanes, cluster, threads, grid, device, stream
    "ensemble_kl_bank_fwd": [_P] * 7 + [_I, _I, _I, _F] + [_I] * 7 + [_P],
    # student, bank, scales, idx, lse_t, lse_s, g, ds, B, N, V, inv_t, T,
    # kind, threads, grid, device, stream
    "ensemble_kl_bank_bwd": [_P] * 8 + [_I] * 3 + [_F] * 2 + [_I] * 4 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_FNS: Dict[str, Callable] = {}


def _fn(name: str):
    """The C entry point, built and typed on first use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.library(SOURCE), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_inputs(student, bank, scales, idx) -> Tuple[int, int, int]:
    if student.device.type != "cuda":
        raise ValueError(f"the CUDA bank kernel takes CUDA tensors, got the "
                         f"student on {student.device}")
    for name, t in (("bank", bank), ("idx", idx), ("scales", scales)):
        if t is not None and t.device != student.device:
            raise ValueError(f"{name} is on {t.device}, the student on "
                             f"{student.device}")
    if student.dtype != torch.float32:
        raise TypeError(f"student logits must be float32, got "
                        f"{student.dtype}")
    if bank.dtype not in BANK_KINDS:
        raise TypeError(f"bank dtype {bank.dtype} is not one of "
                        f"{list(BANK_KINDS)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if student.dim() != 2 or bank.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected student [B, V], bank [N, V], idx [B]; "
                         f"got {tuple(student.shape)}, {tuple(bank.shape)}, "
                         f"{tuple(idx.shape)}")
    b, v = student.shape
    n = bank.shape[0]
    if bank.shape[1] != v or idx.shape[0] != b:
        raise ValueError(f"shape mismatch: student {tuple(student.shape)}, "
                         f"bank {tuple(bank.shape)}, idx {tuple(idx.shape)}")
    if scales is not None:
        if scales.dtype != torch.float32 or scales.shape != (n,):
            raise ValueError(f"scales must be float32 [{n}], got "
                             f"{scales.dtype} {tuple(scales.shape)}")
    if b == 0 or v == 0:
        raise ValueError("empty student batch")
    if max(b * v, n * v) >= 2 ** 62 or max(b, n, v) >= 2 ** 31:
        raise ValueError("shape exceeds the kernel's index range")
    for name, t in (("student", student), ("bank", bank), ("idx", idx),
                    ("scales", scales)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, n, v


def plan(b: int, v: int, sms: int = ensemble_kl.SMS) -> Plan:
    """K1's launch plan for ``b`` rows of ``v`` classes: K2/K3's
    ``ensemble_kl.plan`` at one teacher with K1's cluster threshold."""
    return ensemble_kl.plan(1, b, v, sms, CLUSTER_MIN_V)


def card_plan(device: torch.device, b: int, v: int) -> Plan:
    """:func:`plan` for the CUDA card ``device``, with its SM count."""
    return ensemble_kl.card_plan(device, 1, b, v, CLUSTER_MIN_V)


def bwd_grid(p: Plan, sms: int) -> int:
    """The backward's blocks: the plan's flat grid, at most one wave."""
    return min(p.bwd_grid, BWD_BLOCKS_PER_SM * sms)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def bank_kl_fwd(student, bank, scales, idx, temperature: float = 1.0,
                launch: Plan | None = None):
    """K1f: per-row ``(kl, lse_t, lse_s)``, each float32 [B].  ``launch``
    overrides :func:`card_plan` (to time the modes against each other)."""
    b, n, v = _check_inputs(student, bank, scales, idx)
    kl, lse_t, lse_s = (torch.empty(b, device=student.device,
                                    dtype=torch.float32) for _ in range(3))
    stream = torch.cuda.current_stream(student.device).cuda_stream
    p = launch or card_plan(student.device, b, v)
    err = _fn("ensemble_kl_bank_fwd")(
        _ptr(student), _ptr(bank), _ptr(scales), _ptr(idx), _ptr(kl),
        _ptr(lse_t), _ptr(lse_s), b, n, v, 1.0 / temperature,
        BANK_KINDS[bank.dtype], MODES[p.mode], p.lanes, p.cluster,
        p.threads, p.grid, student.device.index, stream)
    _raise_on(err, "ensemble_kl_bank_fwd")
    LAUNCHES["ensemble_kl_bank_fwd"] += 1
    return kl, lse_t, lse_s


def bank_kl_bwd(student, bank, scales, idx, lse_t, lse_s, g,
                temperature: float = 1.0, blocks: int | None = None):
    """K1b: ``d loss / d student`` [B, V] float32 for the cotangent ``g``
    (a 0-dim float32 CUDA tensor, read by the kernel: no host sync).
    ``blocks`` overrides :func:`bwd_grid` (to time the grids)."""
    b, n, v = _check_inputs(student, bank, scales, idx)
    for name, t, shape in (("lse_t", lse_t, (b,)), ("lse_s", lse_s, (b,)),
                           ("g", g, ())):
        if (t.device != student.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{shape} tensor on {student.device}")
    ds = torch.empty_like(student)
    stream = torch.cuda.current_stream(student.device).cuda_stream
    p = card_plan(student.device, b, v)
    err = _fn("ensemble_kl_bank_bwd")(
        _ptr(student), _ptr(bank), _ptr(scales), _ptr(idx), _ptr(lse_t),
        _ptr(lse_s), _ptr(g), _ptr(ds), b, n, v, 1.0 / temperature,
        float(temperature), BANK_KINDS[bank.dtype], p.bwd_threads,
        blocks or bwd_grid(p, card_sms(student.device)),
        student.device.index, stream)
    _raise_on(err, "ensemble_kl_bank_bwd")
    LAUNCHES["ensemble_kl_bank_bwd"] += 1
    return ds


class _EnsembleKLBank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, student, bank, scales, idx, temperature):
        kl, lse_t, lse_s = bank_kl_fwd(student, bank, scales, idx,
                                       temperature)
        ctx.save_for_backward(student, bank, scales, idx, lse_t, lse_s)
        ctx.temperature = temperature
        # a fixed-order device reduction (no atomics): repeatable bit for bit
        return kl.sum() / student.shape[0] * temperature ** 2

    @staticmethod
    def backward(ctx, g):
        student, bank, scales, idx, lse_t, lse_s = ctx.saved_tensors
        ds = bank_kl_bwd(student, bank, scales, idx, lse_t, lse_s,
                         g.float().contiguous(), ctx.temperature)
        return ds, None, None, None, None


def ensemble_kl_bank(student, bank, scales, idx, temperature: float = 1.0):
    """AVGLOGITS loss straight off a resident logit bank, on the card.

    student: [B, V] float32 CUDA (differentiable); bank: [N, V] in a bank
    storage dtype; scales: [N] float32 per-row dequant scales, or None for
    unquantized banks; idx: [B] int64 rows into the bank."""
    return _EnsembleKLBank.apply(student, bank, scales, idx,
                                 float(temperature))
