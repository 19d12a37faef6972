"""Teacher-logit bank: FedDF's precomputed, device-resident fast path.

The teachers are frozen during fusion and AVGLOGITS only consumes
``mean_k f(x_k, d)``, so for a source with a finite pool the averaged
teacher logits are computed once per round (one chunked batched forward
of the stacked teachers over the pool, reduced to the fp32 mean) and the
distillation steps gather bank rows by the sampled indices instead of
re-running the teachers: ``K x steps`` forwards become ``K x ceil(N /
chunk)``.

Rows are stored as float32, bfloat16, int8 or fp8 e4m3; the quantized
dtypes carry one fp32 scale per row, and the fused distillation kernel
dequantizes rows in registers (``kernels/ensemble_kl_bank.py``).

Teacher weights (the buffered-async driver's staleness importance) fold
into the stored rows at build time: the bank holds the weighted consensus
instead of the uniform mean, and the distillation steps stay the same.
The persistent cross-round cache waits for ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.common.options import (BANK_DTYPES, LOGIT_BANK_MODES,
                                        QUANTIZED_BANK_DTYPES)
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import REGISTRY

DEFAULT_CHUNK = 512

# symmetric per-row quantization: q = round/cast(row / scale) with
# scale = amax(|row|) / QUANT_MAX[dtype]
_INT8_MAX = 127.0
_FP8_E4M3_MAX = 448.0  # largest finite float8_e4m3fn value
_QUANT_MAX = {"int8": _INT8_MAX, "fp8_e4m3": _FP8_E4M3_MAX}
_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


# Teacher *batch* forwards (one teacher, one batch of rows), from bank
# builds and on-the-fly distillation chunks alike: the evidence that the
# bank removes the K x steps redundancy.
TEACHER_FORWARDS = REGISTRY.counter("core.logit_bank.teacher_forwards")


@dataclasses.dataclass
class LogitBank:
    """Per-round bank of averaged teacher logits over a distillation pool:
    ``pool`` [N, ...] and ``logits`` [N, C] in ``dtype_name``, on one
    device; ``scales`` [N] fp32 for the quantized dtypes, else None."""

    pool: torch.Tensor
    logits: torch.Tensor
    n_teachers: int
    n_teacher_batch_forwards: int
    build_time_s: float
    scales: Optional[torch.Tensor] = None
    dtype_name: str = "float32"
    reused: bool = False

    @property
    def n(self) -> int:
        return int(self.pool.shape[0])

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def nbytes(self) -> int:
        """Bank row bytes, scales included."""
        total = self.logits.numel() * self.logits.element_size()
        if self.scales is not None:
            total += self.scales.numel() * self.scales.element_size()
        return int(total)


def bank_dtype(name: str) -> torch.dtype:
    """Storage dtype for a ``FusionConfig.bank_dtype`` literal."""
    if name not in BANK_DTYPES:
        raise ValueError(f"bank_dtype must be one of {sorted(BANK_DTYPES)}, "
                         f"got {name!r}")
    return _STORAGE[name]


def quantize_rows(rows: torch.Tensor, dtype_name: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization of fp32 logit rows ``[M, C]`` ->
    ``(q [M, C] storage dtype, scales [M] fp32)``.  int8 rounds half to
    even (as ``jnp.round``); fp8 rounds in the cast.  All-zero rows get
    scale 1, so dequantization is exact for them."""
    qmax = _QUANT_MAX[dtype_name]
    storage = bank_dtype(dtype_name)
    rows = rows.float()
    amax = rows.abs().amax(dim=-1)
    scales = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = rows / scales[:, None]
    if dtype_name == "int8":
        q = torch.clamp(torch.round(scaled), -_INT8_MAX, _INT8_MAX)
    else:
        q = torch.clamp(scaled, -qmax, qmax)
    return q.to(storage), scales


def dequantize_rows(rows: torch.Tensor,
                    scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 logit rows from stored bank rows (+ their per-row scales)."""
    out = rows.float()
    if scales is not None:
        out = out * scales[..., None]
    return out


def _normalized_weights(teacher_weights, k_total: int,
                        device) -> torch.Tensor:
    w = torch.as_tensor(teacher_weights, dtype=torch.float32).reshape(-1)
    if tuple(w.shape) != (k_total,):
        raise ValueError(
            f"teacher_weights must have shape ({k_total},) to match the "
            f"concatenated teacher axis, got {tuple(w.shape)}")
    return (w / w.sum()).to(device)


def build_logit_bank(teacher_logit_fns: Sequence[Callable], pool, *,
                     chunk_size: int = DEFAULT_CHUNK,
                     dtype: str = "float32",
                     teacher_weights=None) -> LogitBank:
    """One chunked pass of every teacher group over ``pool`` -> LogitBank.

    Each chunk evaluates all groups' stacked teachers ([K_g, c, C] each),
    concatenates them along the teacher axis and reduces to the fp32 mean,
    or to the ``teacher_weights`` consensus (``[K]`` in concat order, any
    positive scale: renormalized here); the full [K, N, C] tensor never
    exists.  The quantized dtypes quantize each chunk's rows in the same
    pass."""
    t0 = time.perf_counter()
    bank_dtype(dtype)
    n = int(pool.shape[0])
    c = max(1, min(int(chunk_size), n))
    rows, scales, k_total, n_chunks = [], [], 0, 0
    w_norm = None
    with torch.no_grad():
        for s in range(0, n, c):
            t = torch.cat([f(pool[s:s + c]) for f in teacher_logit_fns],
                          dim=0).float()
            k_total = int(t.shape[0])
            if teacher_weights is not None and w_norm is None:
                w_norm = _normalized_weights(teacher_weights, k_total,
                                             t.device)
            mean = (t.mean(dim=0) if w_norm is None
                    else torch.tensordot(w_norm, t, dims=([0], [0])))
            if dtype in QUANTIZED_BANK_DTYPES:
                q, sc = quantize_rows(mean, dtype)
                rows.append(q)
                scales.append(sc)
            else:
                rows.append(mean.to(_STORAGE[dtype]))
            n_chunks += 1
            TEACHER_FORWARDS.add(k_total)
    return LogitBank(pool=pool, logits=torch.cat(rows),
                     n_teachers=k_total,
                     n_teacher_batch_forwards=n_chunks * k_total,
                     build_time_s=time.perf_counter() - t0,
                     scales=torch.cat(scales) if scales else None,
                     dtype_name=dtype)


def resolve_bank(teacher_logit_fns: Sequence[Callable], source, fusion, *,
                 expected_steps: Optional[int] = None,
                 teacher_weights=None
                 ) -> Tuple[Optional[LogitBank], str]:
    """Resolve ``FusionConfig.logit_bank`` against the source.

    Returns ``(bank_or_None, reason)``, reason one of ``built`` / ``off``
    / ``no_teachers`` / ``no_pool`` / ``skipped_small_run``.  ``auto``
    builds whenever the source has a pool and the run is expected to
    touch at least ``N`` pool rows (``expected_steps x batch_size >= N``);
    a shorter run keeps the on-the-fly path.  ``teacher_weights`` fold
    into the bank rows (:func:`build_logit_bank`)."""
    mode = getattr(fusion, "logit_bank", "off")
    if mode not in LOGIT_BANK_MODES:
        raise ValueError(f"logit_bank must be one of {LOGIT_BANK_MODES}, "
                         f"got {mode!r}")
    if mode == "off":
        return None, "off"
    if not teacher_logit_fns:
        return None, "no_teachers"
    pool = source.pool()
    if pool is None:
        if mode == "on":
            warnings.warn(
                f"logit_bank='on' but source {type(source).__name__} has "
                f"no indexable pool(); falling back to on-the-fly teacher "
                f"forwards", UserWarning, stacklevel=2)
        return None, "no_pool"
    bank_dtype(fusion.bank_dtype)
    if (mode == "auto" and expected_steps is not None
            and expected_steps * fusion.batch_size < len(pool)):
        return None, "skipped_small_run"
    with _trace.span("bank_build", pool_n=len(pool),
                     n_teachers=len(teacher_logit_fns)):
        bank = build_logit_bank(teacher_logit_fns, pool,
                                dtype=fusion.bank_dtype,
                                teacher_weights=teacher_weights)
    return bank, "built"
