"""FedDF ensemble-distillation model fusion (the paper's Algorithm 1).

AVGLOGITS (paper §3):

    x_{t,j} = x_{t,j-1} - eta * d/dx KL( sigma(mean_k f(x_k, d)),
                                         sigma(f(x_{t,j-1}, d)) )

The teachers are frozen during fusion, so for a source with a pool the
round's averaged teacher logits are precomputed once into a
device-resident logit bank (``core/logit_bank.py``) and each distillation
step gathers bank rows by the sampled indices (kernel K1).  Without a
bank (``logit_bank="off"``, ``auto`` skipping a run too short to amortize
it, or a pool-less source: ``generator``, ``noise``) every step runs the
K teachers on its batch under ``torch.no_grad()`` and the loss takes the
stacked ``[K, B, V]`` logits (kernel K2).  Teacher weights (the
buffered-async driver's staleness importance) replace the uniform mean
with a weighted consensus: folded into the bank rows, or on the
on-the-fly path computed in PyTorch and handed to kernel K3 as ``[B, V]``
rows.  With ``use_fused_kernel`` ``"auto"`` or ``True`` the loss is the
fused kernel pair (``kernels/ops.py``: the CUDA kernel on the card, its
plain version on the CPU); ``False`` is the explicit unfused route.

The student trains with Adam + cosine in chunks of ``eval_every`` steps.
The host reads nothing inside a chunk: the chunk's indices or random
draws are moved to the device once, and the validation accuracy (the
early-stopping signal) is read once per chunk, as is the divergence
guard's finiteness check when it is on.

Heterogeneous cohorts (Algorithm 3) fuse every prototype group's student
against the ALL-groups teacher ensemble: one bank over every group's
teachers serves all the students (K1), or without a bank every step runs
the concatenated teachers (K2).  Table 7's SWAG row appends
``swag_samples`` models drawn from a diagonal Gaussian over the received
models to a homogeneous fusion's teachers (``core/swag.py``), after the
student is initialised from their average; the bank, or K2 on the fly,
then averages over all of them.  As in the JAX package, the heterogeneous
fusion takes no SWAG teachers.

Distill-axis bucketing: ``fusion.batch_sizes`` gives each prototype group
of a heterogeneous fusion its own distill batch, and ``distill_bucket``
groups those sizes into run-fixed capacities (``core/client.
bucket_capacities``).  ``distill`` pads a student's sampled batch from
``batch_size`` up to ``batch_capacity`` (bank mode gathers pool row 0 for
the padding, the other modes zero rows), and slices the student's and the
teachers' logits back to ``batch_size`` before the loss, so the kernels
always see the true batch.  As in the JAX package, the padded rows do
enter a ``bn`` student's batch statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.pytree import (tree_flatten, tree_isfinite,
                                       tree_leading_dim, tree_map,
                                       tree_stack, tree_unflatten,
                                       tree_weighted_mean_stacked)
from repro_torch.core.client import assign_buckets, bucket_capacities
from repro_torch.core.logit_bank import (TEACHER_FORWARDS, LogitBank,
                                         dequantize_rows, resolve_bank)
from repro_torch.core.nets import Net
from repro_torch.core.swag import swag_teachers_stacked
from repro_torch.data.distill_sources import DistillSource
from repro_torch.kernels.ops import (ensemble_kl_loss, ensemble_kl_loss_bank,
                                     ensemble_kl_loss_pre, use_fused_kernel)
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
                  temperature: float = 1.0,
                  teacher_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """KL( softmax(mean_k teacher), softmax(student) ), mean over batch.
    teacher_logits: [K, B, C] (raw, un-averaged); student_logits: [B, C].
    ``teacher_weights`` ([K], normalized) replaces the uniform mean with a
    weighted consensus; None keeps the uniform mean."""
    t = teacher_logits.float()
    t_avg = (t.mean(dim=0) if teacher_weights is None
             else _consensus(teacher_weights, t))
    return avg_logits_kl_pre(student_logits, t_avg, temperature)


def _consensus(teacher_weights: torch.Tensor,
               teacher_logits: torch.Tensor) -> torch.Tensor:
    """``tensordot(w, t)`` over the teacher axis, in float32."""
    w = teacher_weights.to(device=teacher_logits.device, dtype=torch.float32)
    return torch.tensordot(w, teacher_logits.float(), dims=([0], [0]))


def normalize_teacher_weights(weights) -> Optional[torch.Tensor]:
    """Importance weights -> normalized [K] float32 CPU tensor (None passes
    through); normalized in float64, as the JAX package does."""
    if weights is None:
        return None
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if total <= 0:
        raise ValueError(f"teacher weights must have a positive sum, got {w}")
    return torch.from_numpy((w / total).astype(np.float32))


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
    fn.stack = teacher_stack  # the persistent bank cache keys on it
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


def _params_device(params) -> torch.device:
    return next(iter(tree_flatten(params).values())).device


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
    teacher_weights=None,
) -> Tuple[dict, dict]:
    """Server-side ensemble distillation; returns ``(params, info)``.

    ``teacher_logit_fns``: callables x -> [K_g, B, C], concatenated over
    the teacher axis.  The best-validation params are returned (strict
    ``acc > best_acc`` from an initial -1.0), and the loop stops once
    ``step - best_step >= patience``.  ``teacher_weights`` ([K] in concat
    order, any positive scale; None = uniform) biases the teacher
    consensus.  With ``fusion.divergence_guard`` the params are checked
    for non-finite values after every chunk; on a hit the loop stops and
    returns the best-validation params (or, without validation, the
    pre-distill student) with ``info["diverged"] = True``.
    ``fusion.batch_capacity`` pads each sampled batch of ``batch_size``
    rows up to that capacity; the padded rows are sliced off before the
    loss."""
    bsz = int(fusion.batch_size)
    cap = int(fusion.batch_capacity or bsz)
    if cap < bsz:
        raise ValueError(f"batch_capacity {cap} < batch_size {bsz}")
    teacher_weights = normalize_teacher_weights(teacher_weights)
    decision = "bank" if bank is not None else "on_the_fly"
    built_here = False
    if bank is None and fusion.logit_bank != "off" and teacher_logit_fns:
        bank, reason = resolve_bank(
            teacher_logit_fns, source, fusion,
            expected_steps=expected_distill_steps(fusion, val_x is not None),
            teacher_weights=teacher_weights)
        decision = _bank_decision(reason)
        built_here = bank is not None and not bank.reused
    n_teachers = sum(int(getattr(f, "n_teachers", 1))
                     for f in teacher_logit_fns)
    device = (bank.logits.device if bank is not None
              else _params_device(student_params))
    fused = use_fused_kernel(fusion.use_fused_kernel, device)
    opt = _make_distill_opt(fusion)
    # a bank already folded the weights into its rows
    weights = (teacher_weights.to(device)
               if teacher_weights is not None and bank is None else None)

    flat = {p: v.detach().clone() for p, v in
            tree_flatten(student_params).items()}
    trainable = student_net.trainable_mask(student_params)
    names = [p for p in flat if trainable[p]]
    opt_state = opt.init([flat[p] for p in names])
    temp = float(fusion.temperature)

    def loss_fn(s_logits, x, idx):
        if bank is not None:
            if fused:
                return ensemble_kl_loss_bank(s_logits, bank.logits,
                                             bank.scales, idx, temp)
            t_avg = dequantize_rows(
                bank.logits[idx],
                None if bank.scales is None else bank.scales[idx])
            return avg_logits_kl_pre(s_logits, t_avg, temp)
        with torch.no_grad():
            t_logits = torch.cat([f(x) for f in teacher_logit_fns], dim=0)
        if cap > bsz:
            t_logits = t_logits[:, :bsz]
        if not fused:
            return avg_logits_kl(s_logits, t_logits, temp, weights)
        if weights is None:
            return ensemble_kl_loss(s_logits, t_logits, temp)
        # the weighted consensus outside the kernel, as JAX computes it
        # outside the Pallas call; the kernel takes its [B, V] rows
        return ensemble_kl_loss_pre(s_logits, _consensus(weights, t_logits),
                                    temp)

    def step_fn(x, idx, step):
        nonlocal opt_state
        with torch.enable_grad():
            leaves = dict(flat)
            for p in names:
                leaves[p] = flat[p].detach().requires_grad_(True)
            s_logits = student_net.apply(tree_unflatten(leaves), x,
                                         train=True)
            if cap > bsz:
                s_logits = s_logits[:bsz]
            loss = loss_fn(s_logits, x, idx)
            grads = torch.autograd.grad(loss, [leaves[p] for p in names])
        with torch.no_grad():
            cur = [flat[p] for p in names]
            deltas, opt_state = opt.update(list(grads), opt_state, cur, step)
            for p, v in zip(names, apply_updates(cur, deltas)):
                flat[p] = v

    have_val = val_x is not None
    best = (student_params, -1.0, 0)
    history = []
    ee = fusion.eval_every
    if bank is not None:
        stream = source.index_stream(seed, bsz, ee)
    else:
        stream = source.input_stream(seed, bsz, ee)
    guard = bool(fusion.divergence_guard)
    diverged = False
    step = 0
    while step < fusion.max_steps:
        block = next(stream).to(device)
        if cap > bsz:
            # bank mode pads the gathered indices with row 0, the other
            # modes the inputs with zero rows
            block = torch.cat([block, block.new_zeros(
                (ee, cap - bsz) + tuple(block.shape[2:]))], dim=1)
        for j in range(ee):
            if bank is not None:
                step_fn(bank.pool[block[j]], block[j, :bsz], step)
            else:
                step_fn(block[j], None, step)
            step += 1
        if bank is None and n_teachers:
            TEACHER_FORWARDS.add(ee * n_teachers)
        if guard and not bool(tree_isfinite(flat)):
            # a non-finite distill state can only get worse: stop and
            # roll back to the last-good params
            diverged = True
            break
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
        best_params = student_params if diverged else tree_unflatten(flat)
        best_acc, best_step = -1.0, 0
    info = {"steps": step, "best_val_acc": best_acc,
            "best_step": best_step, "val_history": history,
            "diverged": diverged,
            "logit_bank": bank is not None,
            "bank_decision": decision,
            "bank_dtype": bank.dtype_name if bank is not None else "",
            "bank_nbytes": bank.nbytes if bank is not None else 0,
            "bank_build_s": bank.build_time_s if built_here else 0.0,
            "teacher_batch_forwards": (
                bank.n_teacher_batch_forwards if built_here
                else (0 if bank is not None else step * n_teachers)),
            # rows computed but sliced off before the loss, per step
            "batch_capacity": cap,
            "padded_rows_per_step": cap - bsz}
    return best_params, info


def filter_teacher_stack(net: Net, stack, probe_x,
                         sigma: float = 6.0) -> Tuple[np.ndarray, int]:
    """Teacher-consensus filter (docs/robustness.md): which teachers of a
    stacked [K, ...] ensemble may vote?

    Each teacher's logits on one probe batch are compared against the
    element-wise median over finite teachers; a teacher is dropped when
    its logits are non-finite anywhere, or when its mean absolute
    deviation from the median robust-z-scores beyond ``sigma`` among its
    peers.  Runs before the logit-bank rows are built, so a poisoned
    teacher never reaches the distillation targets.  The probe forward
    runs batched over the stack on the stack's device; the median, MAD
    and robust z run in float64 on the host, as in the JAX package.

    Returns ``(kept_indices, n_dropped)``; ``kept_indices`` may be empty
    when every teacher is non-finite (callers then skip fusion).
    """
    with torch.no_grad():
        logits = net.apply(stack, probe_x, train=False)        # [K, B, C]
    logits = logits.float().cpu().numpy().astype(np.float64)
    k = logits.shape[0]
    finite = np.isfinite(logits).all(axis=(1, 2))
    if not finite.any():
        return np.empty(0, np.int64), k
    med = np.median(logits[finite], axis=0)           # [B, C]
    dist = np.full(k, np.inf)
    dist[finite] = np.mean(np.abs(logits[finite] - med), axis=(1, 2))
    fd = dist[finite]
    center = float(np.median(fd))
    mad = float(np.median(np.abs(fd - center)))
    # the upload screen's robust-z floor: a collapsed MAD must not flag
    # honest teachers over sub-percent logit jitter
    denom = 1.4826 * mad + 0.05 * abs(center) + 1e-12
    ok = finite & (np.abs(dist - center) / denom <= sigma)
    if not ok.any():  # degenerate: keep the single most central teacher
        ok[int(np.argmin(dist))] = True
    kept = np.flatnonzero(ok)
    return kept.astype(np.int64), int(k - kept.size)


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
    swag_draws=None,
) -> Tuple[dict, dict]:
    """Algorithm 1 on an already-stacked [K, ...] teacher tree.
    ``student=None`` initialises from the weighted average (line 6).
    ``teacher_weights`` (per-teacher importance, e.g. the buffered-async
    ``(1+s)^-a`` staleness weights) biases the teacher consensus; None
    keeps the paper's uniform AVGLOGITS.  With ``fusion.swag_samples``,
    SWAG teachers drawn from the fusion seed (or by ``swag_draws``,
    ``core/swag.SwagDraws``) join the received ones, each with the
    received teachers' mean importance."""
    if student is None:
        student = tree_weighted_mean_stacked(teacher_stack, weights)
    if fusion.swag_samples > 0:  # Table 7: the FedDistill / SWAG teachers
        teacher_stack = swag_teachers_stacked(
            teacher_stack, fusion.swag_samples, scale=fusion.swag_scale,
            seed=seed, draws=swag_draws)
        if teacher_weights is not None:
            tw = np.asarray(teacher_weights, np.float64)
            teacher_weights = np.concatenate(
                [tw, np.full(fusion.swag_samples, tw.mean())])
    tfn = make_teacher_logits_fn(net, teacher_stack)
    return distill(net, student, [tfn], source, fusion, val_x, val_y, seed,
                   teacher_weights=teacher_weights)


def feddf_fuse_homogeneous(
    net: Net,
    client_params: List[dict],
    client_weights: Sequence[float],
    source: DistillSource,
    fusion: FusionConfig,
    val_x=None,
    val_y=None,
    seed: int = 0,
    init_from: str = "average",
    prev_global: Optional[dict] = None,
    swag_draws=None,
) -> Tuple[dict, dict]:
    """List-of-trees wrapper over :func:`feddf_fuse_stacked`.
    ``init_from='previous'`` is the Table 5 ablation: the student starts
    from last round's fused model instead of the weighted average."""
    student = (None if init_from == "average" or prev_global is None
               else prev_global)
    return feddf_fuse_stacked(net, tree_stack(client_params), client_weights,
                              source, fusion, val_x, val_y, seed,
                              student=student, swag_draws=swag_draws)


def feddf_fuse_heterogeneous_stacked(
    prototypes: List[Tuple[Net, Optional[dict], Sequence[float]]],
    source: DistillSource,
    fusion: FusionConfig,
    val_x=None,
    val_y=None,
    seed: int = 0,
    importances: Optional[List[Optional[np.ndarray]]] = None,
) -> Tuple[List[Optional[dict]], List[dict]]:
    """Algorithm 3 on stacked per-group teacher trees: every group's
    student distils against the ALL-groups teacher ensemble.

    ``prototypes``: per group ``(net, stacked params [K_g, ...] or None,
    data weights)``.  ``importances`` (one optional [K_g] array per group)
    weights each teacher's vote in the shared consensus; groups without
    one vote uniformly, and all-None keeps the uniform mean.  Returns
    ``(fused params per group or None, info per group)``.

    One logit bank is built over every group's teachers and shared by
    all the students, so its break-even input is the students' total
    expected steps.  After a refused bank every group distils on the fly
    (``logit_bank`` forced to ``off``: the decision is not retried per
    group).  The build is charged to the first fused group.  Group ``gi``
    distils with seed ``seed + gi`` from its own weighted average.

    ``fusion.batch_sizes`` (one per group) gives each group its own
    distill batch, padded to its bucket's capacity
    (``fusion.distill_bucket`` / ``distill_max_buckets``: ``none`` pads
    every group to the largest size)."""
    caps_of = None
    if fusion.batch_sizes is not None:
        if len(fusion.batch_sizes) != len(prototypes):
            raise ValueError(
                f"fusion.batch_sizes has {len(fusion.batch_sizes)} entries "
                f"for {len(prototypes)} prototype groups")
        bsizes = [int(b) for b in fusion.batch_sizes]
        caps = bucket_capacities(bsizes, fusion.distill_bucket,
                                 fusion.distill_max_buckets)
        caps_of = [int(caps[w]) for w in assign_buckets(bsizes, caps)]
    teacher_fns = [make_teacher_logits_fn(net, stack)
                   for net, stack, _ in prototypes if stack is not None]
    teacher_weights = None
    if importances is not None and any(i is not None for i in importances):
        pieces = []
        for (_, stack, _), imp in zip(prototypes, importances):
            if stack is None:
                continue
            k_g = tree_leading_dim(stack)
            pieces.append(np.ones(k_g, np.float64) if imp is None
                          else np.asarray(imp, np.float64))
        teacher_weights = normalize_teacher_weights(np.concatenate(pieces))
    n_students = len(teacher_fns)
    bank, reason = resolve_bank(
        teacher_fns, source, fusion,
        expected_steps=(expected_distill_steps(fusion, val_x is not None)
                        * max(1, n_students)),
        teacher_weights=teacher_weights)
    decision = _bank_decision(reason)
    if bank is None and fusion.logit_bank != "off":
        fusion = dataclasses.replace(fusion, logit_bank="off")

    fused, infos = [], []
    build_attributed = bank is not None and bank.reused
    for gi, (net, stack, weights) in enumerate(prototypes):
        if stack is None:
            fused.append(None)
            infos.append({"skipped": True})
            continue
        student = tree_weighted_mean_stacked(stack, weights)  # Alg. 3 l. 11
        fusion_g = fusion
        if caps_of is not None:
            fusion_g = dataclasses.replace(
                fusion, batch_size=bsizes[gi], batch_capacity=caps_of[gi],
                batch_sizes=None)
        p, info = distill(net, student, teacher_fns, source, fusion_g,
                          val_x, val_y, seed + gi, bank=bank,
                          teacher_weights=teacher_weights)
        info["bank_decision"] = decision
        if bank is not None and not build_attributed:
            info = dict(info, bank_build_s=bank.build_time_s,
                        teacher_batch_forwards=bank.n_teacher_batch_forwards)
            build_attributed = True
        fused.append(p)
        infos.append(info)
    return fused, infos


def feddf_fuse_heterogeneous(
    prototypes: List[Tuple[Net, List[dict], Sequence[float]]],
    source: DistillSource,
    fusion: FusionConfig,
    val_x=None,
    val_y=None,
    seed: int = 0,
) -> Tuple[List[Optional[dict]], List[dict]]:
    """List-of-trees wrapper over :func:`feddf_fuse_heterogeneous_stacked`."""
    stacked = [(net, tree_stack(plist) if plist else None, weights)
               for net, plist, weights in prototypes]
    return feddf_fuse_heterogeneous_stacked(stacked, source, fusion,
                                            val_x, val_y, seed)
