"""Dispatch of the port's kernels by the tensors' device.

A CPU tensor takes the kernel's plain version (``kernels/ref.py``); a CUDA
tensor takes the CUDA kernel, and a failed build or launch raises.  There
is no path on which a CUDA tensor silently reaches the plain version.

K4 and K5 are forward kernels, as their Pallas counterparts are: the JAX
package differentiates attention and the SSD scan by autodiff of jnp code
outside any kernel.  On CUDA tensors each runs inside an
``autograd.Function`` whose forward is the kernel and whose backward
recomputes the plain version from the saved inputs (not the S x S scores,
so one layer's recompute is live at a time) and returns its gradient.
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


class _VocabSplitKL(torch.autograd.Function):
    """K2 over vocabulary shards: the forward takes each row's statistics
    over this rank's columns (K2s, or ``ref.kl_partial`` on the CPU),
    merges them over ``axis`` (the max, then the rescaled sums) and
    finishes the rows; the backward is K2b (``ref.ensemble_kl_bwd`` on
    the CPU) on this rank's columns with the merged log-sum-exps and
    ``n_rows`` in place of the local row count."""

    @staticmethod
    def forward(ctx, student, teachers, mesh, axis, n_rows, temperature):
        from repro_torch.common.sharding import all_reduce_max, all_reduce_sum
        if student.is_cuda:
            from repro_torch.kernels.ensemble_kl import kl_fwd_split
            stats = kl_fwd_split(student, teachers, temperature)
        else:
            _check_on_cpu(teachers=teachers)
            stats = ref.kl_partial(student, teachers, temperature)
        maxes = all_reduce_max(stats[list(ref.MAX_PLANES)], mesh, (axis,))
        sums = all_reduce_sum(ref.kl_rescale(stats, maxes), mesh, (axis,))
        kl, lse_t, lse_s = ref.kl_finish(maxes, sums)
        ctx.save_for_backward(student, teachers, lse_t.contiguous(),
                              lse_s.contiguous())
        ctx.n_rows, ctx.temperature = n_rows, temperature
        return kl.sum() / n_rows * temperature ** 2

    @staticmethod
    def backward(ctx, g):
        student, teachers, lse_t, lse_s = ctx.saved_tensors
        g = g.float()
        if student.is_cuda:
            from repro_torch.kernels.ensemble_kl import kl_bwd
            # K2b divides by its own rows: g scaled by B_local / n_rows
            g = (g * (student.shape[0] / ctx.n_rows)).contiguous()
            ds = kl_bwd(student, teachers, lse_t, lse_s, g, ctx.temperature)
        else:
            ds = ref.ensemble_kl_bwd(student, teachers, lse_t, lse_s, g,
                                     ctx.temperature, ctx.n_rows)
        return ds, None, None, None, None, None


def ensemble_kl_loss_split(student_logits: torch.Tensor,
                           teacher_logits: torch.Tensor, mesh,
                           axis: str = "model", n_rows: Optional[int] = None,
                           temperature: float = 1.0) -> torch.Tensor:
    """The AVGLOGITS loss (K2) when the vocabulary is split over the mesh
    axis ``axis``: student [..., V_loc] float32 and teachers [K, ..., V_loc]
    are this rank's columns of its rows (leading dims flattened).  Returns
    ``T^2 * sum_rows KL / n_rows`` over this rank's rows (``n_rows``: the
    rows of every data shard, this rank's by default), equal on every rank
    of ``axis``: summed over the data axes it is the loss.  Differentiable
    in the student's columns."""
    v = student_logits.shape[-1]
    s2 = student_logits.reshape(-1, v)
    t2 = teacher_logits.reshape(teacher_logits.shape[0], -1, v)
    if s2.is_cuda:
        t2 = t2.contiguous()
    return _VocabSplitKL.apply(s2, t2, mesh, axis,
                               s2.shape[0] if n_rows is None else n_rows,
                               float(temperature))


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


def _plain_grads(fn, inputs, needs, outputs_grad):
    """Gradients of the plain version ``fn(*inputs)`` for the cotangents
    ``outputs_grad`` (one per output, None where an output has none),
    recomputed from detached copies of ``inputs``, with respect to those
    whose ``needs`` (``ctx.needs_input_grad``) is set; None elsewhere."""
    with torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, outputs_grad) if g is not None]
        wrt = [x for x in xs if x is not None and x.requires_grad]
        if not pairs or not wrt:
            return [None] * len(inputs)
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                         [g for _, g in pairs],
                                         allow_unused=True))
        return [next(grads) if x is not None and x.requires_grad else None
                for x in xs]


class _SwaAttn(torch.autograd.Function):
    """K4 forward; the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        from repro_torch.kernels.swa_attn import swa_attn
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal = window, causal
        return swa_attn(q, k, v, window, causal)

    @staticmethod
    def backward(ctx, go):
        window, causal = ctx.window, ctx.causal
        grads = _plain_grads(
            lambda q, k, v: ref.swa_attn(q, k, v, window, causal),
            ctx.saved_tensors, ctx.needs_input_grad[:3], [go])
        return (*grads, None, None)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int] = None,
                  causal: bool = True) -> torch.Tensor:
    """Attention, causal or bidirectional, optionally windowed (K4): q
    [B,H,S,D], k/v [B,H_kv,S,D] with H_kv dividing H (grouped-query
    attention); the output is in q's dtype.  Differentiable: on CUDA
    tensors the gradient is the plain version's, recomputed."""
    if q.is_cuda:
        return _SwaAttn.apply(q, k, v, window, causal)
    _check_on_cpu(k=k, v=v)
    return ref.swa_attn(q, k, v, window, causal)


class _SsdScan(torch.autograd.Function):
    """K5 forward; the plain version's gradient backward (``chunk`` is the
    plain version's, as the CPU runs it)."""

    @staticmethod
    def forward(ctx, x, dt, a_log, bmat, cmat, init_state, chunk):
        from repro_torch.kernels.ssd_scan import ssd_scan as kernel
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, bmat, cmat, init_state)
        ctx.chunk = chunk
        return kernel(x, dt, a_log, bmat, cmat, init_state)

    @staticmethod
    def backward(ctx, gy, g_state):
        chunk = ctx.chunk
        grads = _plain_grads(
            lambda x, dt, a, b, c, s0: ref.ssd_scan(x, dt, a, b, c, chunk,
                                                    s0),
            ctx.saved_tensors, ctx.needs_input_grad[:6], [gy, g_state])
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan (K5) from ``init_state`` [B,H,N,P] (zero when
    None): x [B,S,H,P], dt [B,S,H], a_log [H], bmat / cmat [B,S,N] -> (y
    [B,S,H,P] in x's dtype, final state [B,H,N,P] float32).  The plain
    version scans in chunks of ``chunk``; the kernel in its own
    (``ssd_scan.CHUNK``).  Differentiable: on CUDA tensors the gradient
    is the plain version's, recomputed."""
    if x.is_cuda:
        return _SsdScan.apply(x.contiguous(), dt.float().contiguous(),
                              a_log.float().contiguous(), bmat.contiguous(),
                              cmat.contiguous(),
                              None if init_state is None
                              else init_state.float().contiguous(), chunk)
    _check_on_cpu(dt=dt, a_log=a_log, bmat=bmat, cmat=cmat,
                  init_state=init_state)
    return ref.ssd_scan(x, dt, a_log, bmat, cmat, chunk, init_state)
