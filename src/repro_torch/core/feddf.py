"""FedDF ensemble-distillation model fusion (the paper's Algorithm 1).

AVGLOGITS (paper §3):

    x_{t,j} = x_{t,j-1} - eta * d/dx KL( sigma(mean_k f(x_k, d)),
                                         sigma(f(x_{t,j-1}, d)) )

The teachers are frozen during fusion, so the round's averaged teacher
logits are precomputed once into a device-resident logit bank
(``core/logit_bank.py``) and each distillation step gathers bank rows by
the sampled indices.  With ``use_fused_kernel`` ``"auto"`` or ``True`` the
loss is the fused bank kernel pair (``kernels/ops.ensemble_kl_loss_bank``:
the CUDA kernel on the card, its plain version on the CPU); ``False`` is
the explicit unfused route (gather, ``dequantize_rows``,
:func:`avg_logits_kl_pre`).

The student trains with Adam + cosine in chunks of ``eval_every`` steps.
The host reads nothing inside a chunk: the chunk's indices are moved to
the device once, and the validation accuracy (the early-stopping signal)
is read once per chunk.

The on-the-fly path (no bank: bank off, skipped, or a pool-less source,
which needs kernel K2), teacher weighting (K3), SWAG teachers and
heterogeneous fusion wait for ROADMAP.md queue 1 item 9 and queue 2.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.pytree import (tree_flatten, tree_map,
                                       tree_unflatten,
                                       tree_weighted_mean_stacked)
from repro_torch.core.logit_bank import (LogitBank, dequantize_rows,
                                         resolve_bank)
from repro_torch.core.nets import Net
from repro_torch.data.distill_sources import DistillSource
from repro_torch.kernels.ops import ensemble_kl_loss_bank, use_fused_kernel
from repro_torch.optim.optimizers import adam, apply_updates, sgd
from repro_torch.optim.schedules import cosine


def avg_logits_kl_pre(student_logits: torch.Tensor,
                      teacher_avg_logits: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """KL( softmax(teacher_avg), softmax(student) ), mean over batch.
    teacher_avg_logits: [B, C] already averaged over teachers."""
    t = teacher_avg_logits.float() / temperature
    s = student_logits.float() / temperature
    logp_t = F.log_softmax(t, dim=-1)
    logp_s = F.log_softmax(s, dim=-1)
    p_t = torch.exp(logp_t)
    kl = torch.sum(p_t * (logp_t - logp_s), dim=-1)
    return kl.mean() * temperature ** 2


def avg_logits_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """KL( softmax(mean_k teacher), softmax(student) ), mean over batch.
    teacher_logits: [K, B, C] (raw, un-averaged); student_logits: [B, C]."""
    return avg_logits_kl_pre(student_logits,
                             teacher_logits.float().mean(dim=0), temperature)


@dataclasses.dataclass
class FusionConfig:
    """Paper defaults (§4.1): Adam 1e-3 + cosine, 1e4 step cap, 1e3
    patience.  Same fields as the JAX package's ``FusionConfig``."""

    max_steps: int = 10_000
    patience: int = 1_000
    eval_every: int = 100
    batch_size: int = 128
    lr: float = 1e-3
    temperature: float = 1.0
    use_fused_kernel: Union[bool, str] = "auto"  # True | False | "auto"
    optimizer: str = "adam"  # adam | sgd   (Table 7)
    swag_samples: int = 0
    swag_scale: float = 0.5
    logit_bank: str = "auto"       # auto | on | off
    bank_dtype: str = "float32"    # float32 | bfloat16 | int8 | fp8_e4m3
    batch_sizes: Optional[Tuple[int, ...]] = None
    distill_bucket: str = "none"   # none | pow2 | quantile
    distill_max_buckets: int = 4
    batch_capacity: Optional[int] = None
    divergence_guard: bool = False


def make_teacher_logits_fn(net: Net, teacher_stack):
    """Stacked homogeneous teachers -> fn(x) -> [K, B, C]."""

    def fn(x):
        return net.apply(teacher_stack, x, train=False)

    fn.n_teachers = int(next(iter(tree_flatten(teacher_stack).values())
                             ).shape[0])
    return fn


def expected_distill_steps(fusion: FusionConfig, have_val: bool) -> int:
    """A-priori estimate of a fusion's step count, the logit bank's
    ``auto`` break-even input: ``max_steps`` without validation, else the
    earliest plateau stop (one patience window past the first eval,
    rounded up to the ``eval_every`` grid)."""
    if not have_val:
        return fusion.max_steps
    ee = max(1, int(fusion.eval_every))
    earliest_stop = ee * -(-(ee + int(fusion.patience)) // ee)
    return min(int(fusion.max_steps), earliest_stop)


# info["bank_decision"] / RoundLog.bank values per resolve_bank reason
_BANK_DECISIONS = {"built": "bank", "reused": "bank_reused",
                   "skipped_small_run": "skipped_small_run"}


def _bank_decision(reason: str) -> str:
    return _BANK_DECISIONS.get(reason, "on_the_fly")


def _make_distill_opt(fusion: FusionConfig):
    if fusion.optimizer == "sgd":  # Table 7: same cosine schedule, SGD rule
        return sgd(cosine(fusion.lr, fusion.max_steps))
    return adam(cosine(fusion.lr, fusion.max_steps))


def _accuracy(net: Net, params, x: torch.Tensor, y: torch.Tensor,
              batch_size: int = 512) -> float:
    """Top-1 accuracy as the JAX package computes it (float32 count / n);
    one host read."""
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    with torch.no_grad():
        for s in range(0, len(y), batch_size):
            pred = net.apply(params, x[s:s + batch_size],
                             train=False).argmax(dim=-1)
            correct += (pred == y[s:s + batch_size]).sum()
    return float(np.float32(correct.item()) / np.float32(len(y)))


def distill(
    student_net: Net,
    student_params,
    teacher_logit_fns: Sequence[Callable],
    source: DistillSource,
    fusion: FusionConfig,
    val_x: Optional[torch.Tensor] = None,
    val_y: Optional[torch.Tensor] = None,
    seed: int = 0,
    bank: Optional[LogitBank] = None,
) -> Tuple[dict, dict]:
    """Server-side ensemble distillation on the logit bank; returns
    ``(params, info)``.  The best-validation params are returned (strict
    ``acc > best_acc`` from an initial -1.0), and the loop stops once
    ``step - best_step >= patience``."""
    if fusion.batch_capacity is not None or fusion.batch_sizes is not None:
        raise NotImplementedError("distill-axis bucketing (heterogeneous "
                                  "fusion) waits for ROADMAP.md queue 1 "
                                  "item 9")
    decision = "bank" if bank is not None else "on_the_fly"
    built_here = False
    if bank is None and fusion.logit_bank != "off" and teacher_logit_fns:
        bank, reason = resolve_bank(
            teacher_logit_fns, source, fusion,
            expected_steps=expected_distill_steps(fusion, val_x is not None))
        decision = _bank_decision(reason)
        built_here = bank is not None
    if bank is None:
        raise NotImplementedError(
            f"on-the-fly distillation (bank decision {decision!r}) needs "
            f"the raw-teacher kernel K2, ROADMAP.md queue 2")
    device = bank.logits.device
    fused = use_fused_kernel(fusion.use_fused_kernel, device)
    opt = _make_distill_opt(fusion)

    flat = {p: v.detach().clone() for p, v in
            tree_flatten(student_params).items()}
    trainable = student_net.trainable_mask(student_params)
    names = [p for p in flat if trainable[p]]
    opt_state = opt.init([flat[p] for p in names])
    pool, bank_rows, scales = bank.pool, bank.logits, bank.scales
    temp = float(fusion.temperature)

    def step_fn(idx, step):
        nonlocal opt_state
        with torch.enable_grad():
            leaves = dict(flat)
            for p in names:
                leaves[p] = flat[p].detach().requires_grad_(True)
            s_logits = student_net.apply(tree_unflatten(leaves), pool[idx],
                                         train=True)
            if fused:
                loss = ensemble_kl_loss_bank(s_logits, bank_rows, scales,
                                             idx, temp)
            else:
                t_avg = dequantize_rows(
                    bank_rows[idx], None if scales is None else scales[idx])
                loss = avg_logits_kl_pre(s_logits, t_avg, temp)
            grads = torch.autograd.grad(loss, [leaves[p] for p in names])
        with torch.no_grad():
            cur = [flat[p] for p in names]
            deltas, opt_state = opt.update(list(grads), opt_state, cur, step)
            for p, v in zip(names, apply_updates(cur, deltas)):
                flat[p] = v

    have_val = val_x is not None
    best = (student_params, -1.0, 0)
    history = []
    stream = source.index_stream(seed, fusion.batch_size, fusion.eval_every)
    step = 0
    while step < fusion.max_steps:
        idx_chunk = next(stream).to(device)
        for j in range(fusion.eval_every):
            step_fn(idx_chunk[j], step)
            step += 1
        if have_val:
            params = tree_unflatten(flat)
            acc = _accuracy(student_net, params, val_x, val_y)
            history.append((step, acc))
            if acc > best[1]:
                best = (tree_map(torch.clone, params), acc, step)
            if step - best[2] >= fusion.patience:
                break  # early stopping: validation plateau (paper §4.1)

    if have_val:
        best_params, best_acc, best_step = best
    else:
        best_params, best_acc, best_step = tree_unflatten(flat), -1.0, 0
    info = {"steps": step, "best_val_acc": best_acc,
            "best_step": best_step, "val_history": history,
            "diverged": False,
            "logit_bank": True,
            "bank_decision": decision,
            "bank_dtype": bank.dtype_name,
            "bank_nbytes": bank.nbytes,
            "bank_build_s": bank.build_time_s if built_here else 0.0,
            "teacher_batch_forwards": (bank.n_teacher_batch_forwards
                                       if built_here else 0),
            "batch_capacity": int(fusion.batch_size),
            "padded_rows_per_step": 0}
    return best_params, info


def feddf_fuse_stacked(
    net: Net,
    teacher_stack,
    weights: Sequence[float],
    source: DistillSource,
    fusion: FusionConfig,
    val_x=None,
    val_y=None,
    seed: int = 0,
    student: Optional[dict] = None,
    teacher_weights=None,
) -> Tuple[dict, dict]:
    """Algorithm 1 on an already-stacked [K, ...] teacher tree.
    ``student=None`` initialises from the weighted average (line 6)."""
    if fusion.swag_samples > 0:
        raise NotImplementedError("SWAG teachers wait for ROADMAP.md queue "
                                  "1 item 9")
    if teacher_weights is not None:
        raise NotImplementedError("weighted teacher consensus (kernel K3) "
                                  "waits for ROADMAP.md queue 2")
    if student is None:
        student = tree_weighted_mean_stacked(teacher_stack, weights)
    tfn = make_teacher_logits_fn(net, teacher_stack)
    return distill(net, student, [tfn], source, fusion, val_x, val_y, seed)
