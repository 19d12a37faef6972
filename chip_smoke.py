#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port (``src/repro_torch``) and nothing of the JAX package,
and in order:

1. prints the card's name and power limit (``nvidia-smi``) and the torch
   and CUDA versions;
2. builds every kernel from the sources in the checkout (one nvcc per
   source, in parallel, ``sm_90a``) and prints the build time and ptxas's
   register and shared-memory lines;
3. holds each kernel against its plain PyTorch version on the card, and
   times kernel, plain version and bound: K1 (logit bank) at the main
   path's shape and two wider ones, for every bank dtype and two
   temperatures; K2 (raw teachers) and K3 (pre-averaged rows) at their
   paths' shape and two wider ones, K = 1 too, float32 and bfloat16
   teachers, two temperatures;
4. drives three paths through ``Experiment(spec).run()`` on the card at
   the quickstart's published widths, 3 rounds each, with every launch
   count set to 0 just before a path and read just after it:
   - path 1, the FedDF quickstart (``unlabeled`` pool, logit bank): every
     round uses the bank and K1 launches once per distill step;
   - path 2, the paper's Fig. 5 ``generator`` source (no pool): every
     round distils on the fly and K2 launches once per distill step;
   - path 3, the ``buffered_async`` driver with staleness 1 and the
     ``noise`` source under traffic latency: stale uploads reach fusion,
     which takes the weighted consensus, so K2 + K3 launch once per
     distill step with K3 launching;
   and checks that the globals are finite; then reruns the first rounds
   of each path on the card and on the CPU (plain versions) from the same
   seed and compares them;
5. prints one ``{"kernels": [...]}`` line, the card line, and as its last
   line ``{"ok": true, "device": {...}}``.

It exits non-zero, without the last line, when there is no CUDA device,
when it does not find the port next to it, or when any phase fails.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# (B, N, V): the main path's distill batch over its pool of 3-class rows;
# the repo's roofline records' shape (experiments/dryrun/distill_kl_*
# __b256c64_*); a ragged shape spanning several 2048-wide V tiles
SHAPES = [(64, 4000, 3), (256, 4096, 64), (37, 1000, 5003)]
TEMPERATURES = (1.0, 2.5)
BANK_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")

# K2 (K, B, V): the on-the-fly path's 8 teachers x distill batch 64 x 3
# classes; the roofline records' shape; a ragged shape over several V tiles;
# one teacher.  K3 (B, V): the weighted-consensus rows of the same batches.
K2_SHAPES = [(8, 64, 3), (8, 256, 64), (5, 37, 5003), (1, 64, 3)]
K3_SHAPES = [(64, 3), (256, 64), (37, 5003)]
TEACHER_DTYPES = ("float32", "bfloat16")
# K2 / K3 against their plain versions: both take t / T in the teachers' type
# and sum the same values, in another order (the kernel sums over K in
# registers and merges online per-thread statistics; the plain version runs
# mean and log_softmax).  The JAX package's kernel tolerances apply
# (tests/test_kernels.py): forward rtol 1e-5 / atol 1e-6, gradient
# elementwise rtol 1e-4 / atol 1e-7.
K2_FWD_RTOL, K2_FWD_ATOL = 1e-5, 1e-6
K2_GRAD_RTOL, K2_GRAD_ATOL = 1e-4, 1e-7

# Kernel vs plain version on identical stored rows (both dequantize the same
# bf16 / int8 / fp8 values), so one tolerance serves every bank dtype.
#  forward: the loss is a float32 sum over B rows of per-row sums over V, taken
#   in another order by the kernel (per-thread online sums merged by rescale)
#   than by log_softmax; the error grows with |loss| and V, hence the relative
#   part on top of the absolute 5e-6 of the JAX package's kernel tests.
#  backward: one exp per element against log_softmax's exp; values are
#   O(T / B), the JAX package's 3e-7 absolute applies.
FWD_ATOL, FWD_RTOL = 5e-6, 2e-6
BWD_ATOL = 3e-7

# The quickstart main path (examples/quickstart.py at its published widths),
# and each later path, 3 rounds each.
MAIN_ROUNDS = 3
# Path 3 is compared with the CPU after round 1 and after rounds 1-2: round 2
# is the first with stale uploads (the weighted consensus).
BUFFERED_CPU_ROUNDS = 2
# The first rounds on the card against the same rounds on the CPU (plain
# versions), from the same seed, batches and index or draw stream.  The two differ only by float32
# summation order (cuBLAS vs CPU matmuls, kernel vs log_softmax), compounded
# over ~600 SGD client steps and a few hundred Adam distill steps; Adam
# normalises each step by sqrt(v), so ~1e-7 differences in tiny gradients can
# move a weight by up to lr per step.  The bound is set at a small fraction of
# the weights' scale (the mlp's weights are O(0.1 - 1)), and the accuracy may
# move by at most one test example in a hundred.
ROUND1_PARAM_ATOL = 1e-3
ROUND1_ACC_ATOL = 0.01
# Path 3 after rounds 1-2.  Its second fusion distils on a trajectory where
# a coordinate's gradient is near zero: Adam divides it by sqrt(v), so one
# distill step with the kernels already moves that coordinate ~0.2 lr away
# from the CPU's step, although kernel and plain gradients agree to ~1e-7;
# after 500 steps the globals sit ~5e-3 apart on an H100, with the same
# accuracy (chip_probe_path3.py isolates this; PERF.md).  A second round is
# held to ten Adam steps' worth of movement (10 x lr) and the same accuracy
# bound.
ROUND2_PARAM_ATOL = 1e-2


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Per-call time of an eager loop (CUDA events): what a caller pays,
    host-side launch overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 50, iters: int = 20) -> float:
    """Per-call device time: ``reps`` calls captured into one CUDA graph
    and replayed, so no host launch overhead sits between the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def make_case(b, n, v, dtype_name, seed, device):
    import torch
    from repro_torch.core.logit_bank import bank_dtype, quantize_rows
    g = torch.Generator().manual_seed(seed)
    student = torch.randn(b, v, generator=g)
    bank32 = torch.randn(n, v, generator=g) * 3
    idx = torch.randint(0, n, (b,), generator=g)
    if dtype_name in ("int8", "fp8_e4m3"):
        bank, scales = quantize_rows(bank32, dtype_name)
    else:
        bank, scales = bank32.to(bank_dtype(dtype_name)), None
    to = lambda t: None if t is None else t.to(device).contiguous()
    return to(student), to(bank), to(scales), to(idx)


def kernel_bytes(b, v, bank, scales, idx, backward: bool) -> int:
    """Bytes the function must move: each input read once (the bank: the
    distinct rows this batch gathers), each output written once."""
    rows = int(idx.unique().numel())
    total = b * v * 4 + rows * v * bank.element_size() + b * 8
    if scales is not None:
        total += rows * 4
    if backward:
        return total + 2 * b * 4 + 4 + b * v * 4      # lse_t, lse_s, g; ds
    return total + 3 * b * 4                           # kl, lse_t, lse_s


def kernel_phase(device):
    """Kernel vs plain version at every shape / dtype / T; timings at T=1."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ensemble_kl_bank import (bank_kl_bwd,
                                                      bank_kl_fwd,
                                                      ensemble_kl_bank)
    rows, errors = [], []
    for (b, n, v) in SHAPES:
        for dtype_name in BANK_DTYPES:
            for temp in TEMPERATURES:
                s, bank, scales, idx = make_case(b, n, v, dtype_name,
                                                 seed=b + v, device=device)
                row_scale = (torch.ones(b, device=device) if scales is None
                             else scales[idx])
                s_k = s.clone().requires_grad_(True)
                s_p = s.clone().requires_grad_(True)
                loss_k = ensemble_kl_bank(s_k, bank, scales, idx, temp)
                loss_p = ref.ensemble_kl_bank(s_p, bank, row_scale, idx, temp)
                (g_k,) = torch.autograd.grad(loss_k, s_k)
                (g_p,) = torch.autograd.grad(loss_p, s_p)
                torch.cuda.synchronize()
                fwd_err = abs(float(loss_k.detach()) - float(loss_p.detach()))
                bwd_err = float((g_k - g_p).abs().max())
                fwd_tol = FWD_ATOL + FWD_RTOL * abs(float(loss_p.detach()))
                ok = (fwd_err <= fwd_tol and bwd_err <= BWD_ATOL
                      and bool(torch.isfinite(g_k).all()))
                rec = {"B": b, "N": n, "V": v, "bank": dtype_name, "T": temp,
                       "loss": float(loss_p.detach()), "fwd_err": fwd_err,
                       "fwd_tol": fwd_tol, "bwd_err": bwd_err,
                       "bwd_tol": BWD_ATOL, "ok": ok}
                errors.append(rec)
                if temp != 1.0:
                    continue
                # timings, T = 1: device time (CUDA graph replay) and the
                # eager per-call time; the plain backward is autograd of the
                # plain forward, timed as (forward + grad) - forward
                kl, lse_t, lse_s = bank_kl_fwd(s, bank, scales, idx, temp)
                g1 = torch.ones((), device=device)
                fwd = lambda: bank_kl_fwd(s, bank, scales, idx, temp)
                bwd = lambda: bank_kl_bwd(s, bank, scales, idx, lse_t, lse_s,
                                          g1, temp)
                s_g = s.clone().requires_grad_(True)

                def plain_fwd():
                    with torch.no_grad():
                        ref.ensemble_kl_bank(s, bank, row_scale, idx, temp)

                def plain_both():
                    torch.autograd.grad(ref.ensemble_kl_bank(
                        s_g, bank, row_scale, idx, temp), s_g)
                ms_f, ms_b = device_ms(fwd), device_ms(bwd)
                plain_f = device_ms(plain_fwd)
                plain_b = device_ms(plain_both) - plain_f
                call_f, call_b = call_ms(fwd), call_ms(bwd)
                plain_call_f = call_ms(plain_fwd)
                plain_call_b = call_ms(plain_both) - plain_call_f
                byt_f = kernel_bytes(b, v, bank, scales, idx, False)
                byt_b = kernel_bytes(b, v, bank, scales, idx, True)
                # ~14 float ops per element forward (two scalings, max and
                # rescale, three exp-weighted sums), ~6 backward
                ops_f, ops_b = 14 * b * v, 6 * b * v
                rows.append({
                    "B": b, "N": n, "V": v, "bank": dtype_name,
                    "fwd_ms": ms_f, "bwd_ms": ms_b,
                    "plain_fwd_ms": plain_f, "plain_bwd_ms": plain_b,
                    "fwd_call_ms": call_f, "bwd_call_ms": call_b,
                    "plain_fwd_call_ms": plain_call_f,
                    "plain_bwd_call_ms": plain_call_b,
                    "fwd_bytes": byt_f, "bwd_bytes": byt_b,
                    "fwd_bound_ms": max(byt_f / HBM_BYTES_PER_S,
                                        ops_f / FP32_FLOPS_PER_S) * 1e3,
                    "bwd_bound_ms": max(byt_b / HBM_BYTES_PER_S,
                                        ops_b / FP32_FLOPS_PER_S) * 1e3,
                    "fwd_bound_by": ("bytes" if byt_f / HBM_BYTES_PER_S
                                     >= ops_f / FP32_FLOPS_PER_S
                                     else "operations"),
                    "bwd_bound_by": ("bytes" if byt_b / HBM_BYTES_PER_S
                                     >= ops_b / FP32_FLOPS_PER_S
                                     else "operations")})
    return rows, errors


def k2_bytes(k, b, v, elem, backward: bool) -> int:
    """Bytes K2 / K3 must move: teachers and student read once, the row
    statistics written (forward) or read with g and ds written
    (backward)."""
    total = k * b * v * elem + 4 * b * v
    if backward:
        return total + 2 * 4 * b + 4 + 4 * b * v
    return total + 3 * 4 * b


def k2_case(k, b, v, dtype_name, seed, device):
    import torch
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(b, v, generator=g) * 3
    t = (torch.randn(k, b, v, generator=g) * 3).to(getattr(torch,
                                                           dtype_name))
    return s.to(device), t.to(device).contiguous()


def k2_phase(device):
    """K2 and K3 vs their plain versions at every shape / dtype / T;
    timings at T=1."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ensemble_kl as k2
    cases = [(k, b, v, False) for k, b, v in K2_SHAPES] + \
        [(1, b, v, True) for b, v in K3_SHAPES]
    rows, errors = [], []
    for (k, b, v, pre) in cases:
        name = "ensemble_kl_pre" if pre else "ensemble_kl"
        for dtype_name in TEACHER_DTYPES:
            for temp in TEMPERATURES:
                s, t = k2_case(k, b, v, dtype_name, seed=k + b + v,
                               device=device)
                t_in = t[0] if pre else t
                plain = ref.ensemble_kl_pre if pre else ref.ensemble_kl
                fused = k2.ensemble_kl_pre if pre else k2.ensemble_kl
                s_k = s.clone().requires_grad_(True)
                s_p = s.clone().requires_grad_(True)
                loss_k, loss_p = fused(s_k, t_in, temp), plain(s_p, t_in,
                                                               temp)
                (g_k,) = torch.autograd.grad(loss_k, s_k)
                (g_p,) = torch.autograd.grad(loss_p, s_p)
                torch.cuda.synchronize()
                want = float(loss_p.detach())
                fwd_err = abs(float(loss_k.detach()) - want)
                bwd_err = float((g_k - g_p).abs().max())
                bwd_excess = float(((g_k - g_p).abs() - K2_GRAD_ATOL
                                    - K2_GRAD_RTOL * g_p.abs()).max())
                ok = (fwd_err <= K2_FWD_ATOL + K2_FWD_RTOL * abs(want)
                      and bwd_excess <= 0
                      and bool(torch.isfinite(g_k).all()))
                errors.append({"kernel": name, "K": k, "B": b, "V": v,
                               "teachers": dtype_name, "T": temp,
                               "loss": want, "fwd_err": fwd_err,
                               "bwd_err": bwd_err, "ok": ok})
                if temp != 1.0:
                    continue
                kl, lse_t, lse_s = k2.kl_fwd(s, t_in, temp, pre)
                g1 = torch.ones((), device=device)
                fwd = lambda: k2.kl_fwd(s, t_in, temp, pre)
                bwd = lambda: k2.kl_bwd(s, t_in, lse_t, lse_s, g1, temp, pre)
                s_g = s.clone().requires_grad_(True)

                def plain_fwd():
                    with torch.no_grad():
                        plain(s, t_in, temp)

                def plain_both():
                    torch.autograd.grad(plain(s_g, t_in, temp), s_g)
                ms_f, ms_b = device_ms(fwd), device_ms(bwd)
                plain_f = device_ms(plain_fwd)
                plain_b = device_ms(plain_both) - plain_f
                call_f, call_b = call_ms(fwd), call_ms(bwd)
                plain_call_f = call_ms(plain_fwd)
                plain_call_b = call_ms(plain_both) - plain_call_f
                elem = t.element_size()
                row = {"kernel": name, "K": k, "B": b, "V": v,
                       "teachers": dtype_name,
                       "fwd_ms": ms_f, "bwd_ms": ms_b,
                       "plain_fwd_ms": plain_f, "plain_bwd_ms": plain_b,
                       "fwd_call_ms": call_f, "bwd_call_ms": call_b,
                       "plain_fwd_call_ms": plain_call_f,
                       "plain_bwd_call_ms": plain_call_b}
                # ~K adds + one scaling per teacher element, then ~14 float
                # ops per element forward, ~8 backward
                for kind, ops in (("fwd", 2 * k * b * v + 14 * b * v),
                                  ("bwd", 2 * k * b * v + 8 * b * v)):
                    byt = k2_bytes(k, b, v, elem, kind == "bwd")
                    by_bytes = byt / HBM_BYTES_PER_S
                    by_ops = ops / FP32_FLOPS_PER_S
                    row[f"{kind}_bytes"] = byt
                    row[f"{kind}_bound_ms"] = max(by_bytes, by_ops) * 1e3
                    row[f"{kind}_bound_by"] = ("bytes" if by_bytes >= by_ops
                                               else "operations")
                rows.append(row)
    return rows, errors


def quickstart_spec(rounds: int):
    """examples/quickstart.py's FedDF spec at its published widths."""
    from repro_torch.api import (CohortSpec, ExperimentSpec, FusionSpec,
                                 ModelSpec, PartitionSpec, SourceSpec,
                                 StrategySpec, TaskSpec)
    return ExperimentSpec(
        task=TaskSpec(name="blobs", n_samples=6000),
        partition=PartitionSpec(n_clients=20, alpha=0.1),
        cohort=CohortSpec(prototypes=[ModelSpec("mlp",
                                                {"hidden": [64, 64, 64]})]),
        strategy=StrategySpec(name="feddf",
                              fusion=FusionSpec(max_steps=500, patience=250,
                                                eval_every=50,
                                                batch_size=64)),
        source=SourceSpec(name="unlabeled", params={"n": 4000}),
        rounds=rounds, client_fraction=0.4, local_epochs=20,
        local_batch_size=32, local_lr=0.05, seed=0)


def generator_spec(rounds: int):
    """Path 2: the quickstart with the paper's Fig. 5 generator source."""
    from repro_torch.api import SourceSpec
    return dataclasses.replace(quickstart_spec(rounds),
                               source=SourceSpec(name="generator"))


def buffered_spec(rounds: int):
    """Path 3: the quickstart on the buffered-async driver (staleness 1),
    the noise source, a buffer of the 8 active clients and upload latency
    1.0 with jitter 0.2 (virtual seconds): every round after the first
    fuses uploads one fusion stale, with importance (1+1)^-0.5."""
    from repro_torch.api import (DriverSpec, PopulationSpec, SourceSpec,
                                 TrafficSpec)
    return dataclasses.replace(
        quickstart_spec(rounds), source=SourceSpec(name="noise"),
        driver=DriverSpec(kind="buffered_async", staleness=1),
        population=PopulationSpec(buffer_size=8, max_staleness=4,
                                  traffic=TrafficSpec(latency=1.0,
                                                      jitter=0.2)))


def max_abs_diff(a, b) -> float:
    from repro_torch.common.pytree import tree_flatten
    fa, fb = tree_flatten(a), tree_flatten(b)
    return max(float((fa[k].cpu() - fb[k].cpu()).abs().max()) for k in fa)


def device_time(prof, round_wall_s: float) -> dict:
    """Kernel time on the card from a profiler trace, by kernel name.
    Reported only: a trace without device events reads 'not measured'."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (e.self_device_time_total * 1e-6, e.count)
    total = sum(t for t, _ in by_name.values())
    if total == 0:
        return {"device_s": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"device_s": total, "round_wall_s": round_wall_s,
            "busy_share": total / round_wall_s,
            "n_kernels": sum(c for _, c in by_name.values()),
            "bank_kernels_s": sum(t for k, (t, _) in by_name.items()
                                  if "bank_kl" in k),
            "top": [(k[:80], t, c) for k, (t, c) in top]}


def reset_all_launches():
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ensemble_kl_bank as k1
    k1.reset_launches()
    k2.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ensemble_kl_bank as k1
    return {**k1.LAUNCHES, **k2.LAUNCHES}


def run_path(spec):
    """One path's rounds on the card with every launch count set to 0 just
    before and read just after."""
    from repro_torch.api import Experiment
    from repro_torch.common.pytree import tree_isfinite
    reset_all_launches()
    t0 = time.perf_counter()
    res = Experiment(spec, device="cuda").run()
    wall = time.perf_counter() - t0
    launches = all_launches()
    logs = res.result.logs
    rounds = [{**{k: getattr(l, k) for k in
                  ("round", "test_acc", "val_acc", "pre_distill_acc",
                   "distill_steps", "bank", "bank_dtype", "bank_nbytes",
                   "teacher_forwards", "n_participants", "staleness_hist",
                   "buffer_fill", "n_straggling", "eff_participants")},
               "phase_s": ph} for l, ph in zip(logs, res.phase_seconds)]
    problems = []
    if len(logs) != spec.rounds:
        problems.append(f"ran {len(logs)} rounds, expected {spec.rounds}")
    if not bool(tree_isfinite(res.global_params[0])):
        problems.append("non-finite globals")
    steps = sum(l.distill_steps for l in logs)
    return res, {"wall_s": wall, "rounds": rounds, "launches": launches,
                 "distill_steps": steps}, problems


def card_vs_cpu(spec, rounds: int, profile_ref=None,
                param_tol: float = ROUND1_PARAM_ATOL):
    """The first ``rounds`` rounds on the card and on the CPU (plain
    versions) from the same seed; with ``profile_ref`` (the first run's
    RunResult) the card's rerun is profiled and must repeat it."""
    from repro_torch.api import Experiment
    short = dataclasses.replace(spec, rounds=rounds)
    busy = None
    if profile_ref is not None:
        # the card's rerun is profiled: its device time against round 1's
        # unprofiled wall time is the device's busy share on the path
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gpu = Experiment(short, device="cuda").run()
        busy = device_time(prof, sum(profile_ref.phase_seconds[0].values()))
    else:
        gpu = Experiment(short, device="cuda").run()
    cpu = Experiment(short, device="cpu").run()
    problems = []
    if profile_ref is not None and \
            gpu.result.logs != profile_ref.result.logs[:rounds]:
        problems.append("the first rounds differ between two runs on the "
                        "card")
    d_param = max_abs_diff(gpu.global_params[0], cpu.global_params[0])
    d_acc = max(abs(g.test_acc - c.test_acc) for g, c in
                zip(gpu.result.logs, cpu.result.logs))
    steps = [[l.distill_steps for l in r.result.logs] for r in (gpu, cpu)]
    check = {"rounds": rounds, "max_abs_param_diff": d_param,
             "param_tol": param_tol,
             "test_acc_cuda": [l.test_acc for l in gpu.result.logs],
             "test_acc_cpu": [l.test_acc for l in cpu.result.logs],
             "test_acc_diff": d_acc, "acc_tol": ROUND1_ACC_ATOL,
             "distill_steps_cuda": steps[0], "distill_steps_cpu": steps[1]}
    if d_param > param_tol or d_acc > ROUND1_ACC_ATOL or steps[0] != steps[1]:
        problems.append(f"card vs CPU: {check}")
    return check, busy, problems


def main_path():
    """Path 1: the quickstart on the logit bank (K1)."""
    spec = quickstart_spec(MAIN_ROUNDS)
    res, report, problems = run_path(spec)
    logs, launches = res.result.logs, report["launches"]
    if any(l.bank != "bank" for l in logs):
        problems.append(f"bank decisions {[l.bank for l in logs]}")
    steps = report["distill_steps"]
    for name in ("ensemble_kl_bank_fwd", "ensemble_kl_bank_bwd"):
        if launches[name] != steps or steps == 0:
            problems.append(f"{name} launched {launches[name]} times for "
                            f"{steps} distill steps")
    check, busy, more = card_vs_cpu(spec, 1, profile_ref=res)
    report.update(cpu_check=check, round1_device=busy)
    return report, problems + more


def generator_path():
    """Path 2: the Fig. 5 generator source, on the fly (K2)."""
    spec = generator_spec(MAIN_ROUNDS)
    res, report, problems = run_path(spec)
    logs, launches = res.result.logs, report["launches"]
    steps = report["distill_steps"]
    if any(l.bank != "on_the_fly" for l in logs):
        problems.append(f"bank decisions {[l.bank for l in logs]}")
    for name in ("ensemble_kl_fwd", "ensemble_kl_bwd"):
        if launches[name] != steps or steps == 0:
            problems.append(f"{name} launched {launches[name]} times for "
                            f"{steps} distill steps")
    others = {k: n for k, n in launches.items() if n and k not in
              ("ensemble_kl_fwd", "ensemble_kl_bwd")}
    if others:
        problems.append(f"other kernels launched on path 2: {others}")
    for l in logs:
        if l.teacher_forwards != l.distill_steps * l.n_participants:
            problems.append(f"round {l.round}: {l.teacher_forwards} "
                            f"teacher forwards for {l.distill_steps} steps "
                            f"x {l.n_participants} teachers")
    check, _, more = card_vs_cpu(spec, 1)
    report.update(cpu_check=check)
    return report, problems + more


def buffered_path():
    """Path 3: buffered_async with stale uploads (K2, then K3)."""
    spec = buffered_spec(MAIN_ROUNDS)
    res, report, problems = run_path(spec)
    logs, launches = res.result.logs, report["launches"]
    steps = report["distill_steps"]
    k2_k3 = launches["ensemble_kl_fwd"] + launches["ensemble_kl_pre_fwd"]
    if k2_k3 != steps or launches["ensemble_kl_pre_fwd"] == 0:
        problems.append(f"K2 + K3 launched {k2_k3} times (K3 "
                        f"{launches['ensemble_kl_pre_fwd']}) for {steps} "
                        f"distill steps")
    for fwd, bwd in (("ensemble_kl_fwd", "ensemble_kl_bwd"),
                     ("ensemble_kl_pre_fwd", "ensemble_kl_pre_bwd")):
        if launches[fwd] != launches[bwd]:
            problems.append(f"{fwd} {launches[fwd]} != {bwd} "
                            f"{launches[bwd]}")
    m = spec.population.buffer_size
    for l in logs:
        if (l.staleness_hist is None or sum(l.staleness_hist) != m
                or not 0 < l.eff_participants <= m):
            problems.append(f"round {l.round}: telemetry "
                            f"{l.staleness_hist} {l.eff_participants}")
    check1, _, more1 = card_vs_cpu(spec, 1)
    check, _, more = card_vs_cpu(spec, BUFFERED_CPU_ROUNDS,
                                 param_tol=ROUND2_PARAM_ATOL)
    report.update(cpu_check=check, cpu_check_round1=check1)
    return report, problems + more1 + more


def print_path(name, rep) -> None:
    for r in rep["rounds"]:
        ph = " ".join(f"{k}={v:.3f}s" for k, v in r["phase_s"].items())
        pre = r["pre_distill_acc"]
        print(f"  {name} round {r['round']}: test_acc={r['test_acc']:.4f} "
              f"pre_distill={'-' if pre is None else f'{pre:.4f}'} "
              f"distill_steps={r['distill_steps']} bank={r['bank']} "
              f"teacher_forwards={r['teacher_forwards']} "
              f"staleness={r['staleness_hist']} {ph}")
    used = {k: n for k, n in rep["launches"].items() if n}
    print(f"  {name}: wall {rep['wall_s']:.1f} s; launches {used} for "
          f"{rep['distill_steps']} distill steps; card vs CPU: "
          f"{rep['cpu_check']}", flush=True)


def main() -> int:
    start_s = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"the port (src/repro_torch) is not next to "
                    f"{Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    report = {}

    # 1. device
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    report["card"] = card

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build(["ensemble_kl_bank", "ensemble_kl"])
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.2f} s (both sources in parallel)",
          flush=True)
    for lib in libs.values():
        for line in lib.log.splitlines():
            if "registers" in line or "smem" in line or "Compiling" in line:
                print(f"  ptxas {lib.name}: {line.strip()}")

    # 3. kernels vs plain versions
    timings, errors = kernel_phase(device)
    report["kernel_errors"], report["kernel_timings"] = errors, timings
    for e in errors:
        print(f"  check K1 B={e['B']} N={e['N']} V={e['V']} {e['bank']:9s} "
              f"T={e['T']}: fwd {e['fwd_err']:.2e} (tol {e['fwd_tol']:.1e}) "
              f"bwd {e['bwd_err']:.2e} (tol {e['bwd_tol']:.1e}) "
              f"{'ok' if e['ok'] else 'FAIL'}")
    k2_timings, k2_errors = k2_phase(device)
    report["k2_errors"], report["k2_timings"] = k2_errors, k2_timings
    for e in k2_errors:
        print(f"  check {e['kernel']} K={e['K']} B={e['B']} V={e['V']} "
              f"{e['teachers']:8s} T={e['T']}: fwd {e['fwd_err']:.2e} "
              f"bwd {e['bwd_err']:.2e} {'ok' if e['ok'] else 'FAIL'}")
    for r in timings + k2_timings:
        parts = []
        for k in ("fwd", "bwd"):
            parts.append(
                f"{k} {r[f'{k}_ms'] * 1e3:.2f} us device / "
                f"{r[f'{k}_call_ms'] * 1e3:.2f} us per call (plain "
                f"{r[f'plain_{k}_ms'] * 1e3:.2f} / "
                f"{r[f'plain_{k}_call_ms'] * 1e3:.2f}, bound "
                f"{r[f'{k}_bound_ms'] * 1e3:.4f})")
        what = (f"{r['kernel']} K={r['K']} B={r['B']} V={r['V']} "
                f"{r['teachers']}" if "kernel" in r else
                f"K1 B={r['B']} N={r['N']} V={r['V']} {r['bank']}")
        print(f"  time {what}: " + "; ".join(parts))
    problems = [f"kernel check failed: {e}" for e in errors + k2_errors
                if not e["ok"]]

    # 4. the paths, each with its own launch counts
    paths = {}
    for name, fn in (("path1_quickstart", main_path),
                     ("path2_generator", generator_path),
                     ("path3_buffered", buffered_path)):
        t0 = time.perf_counter()
        rep, path_problems = fn()
        rep["total_s"] = time.perf_counter() - t0
        paths[name] = rep
        problems += [f"{name}: {p}" for p in path_problems]
        print_path(name, rep)
    report["paths"] = paths
    print(f"  path 1 round 1 on the card, from a profiler trace: "
          f"{paths['path1_quickstart']['round1_device']}")

    # 5. output
    def timing(rows, **key):
        return next(r for r in rows
                    if all(r.get(k) == v for k, v in key.items()))
    src = "src/repro_torch/kernels/csrc/"
    pallas = "src/repro/kernels/ensemble_kl.py:"
    entries = [
        ("ensemble_kl_bank", "path1_quickstart", "ensemble_kl_bank.cu",
         ("155", "180"), timing(timings, B=64, N=4000, V=3, bank="float32"),
         [(e["fwd_err"], e["bwd_err"]) for e in errors]),
        ("ensemble_kl", "path2_generator", "ensemble_kl.cu",
         ("107", "130"), timing(k2_timings, kernel="ensemble_kl", K=8, B=64,
                                V=3, teachers="float32"),
         [(e["fwd_err"], e["bwd_err"]) for e in k2_errors
          if e["kernel"] == "ensemble_kl"]),
        ("ensemble_kl_pre", "path3_buffered", "ensemble_kl.cu",
         ("107", "130"), timing(k2_timings, kernel="ensemble_kl_pre", B=64,
                                V=3, teachers="float32"),
         [(e["fwd_err"], e["bwd_err"]) for e in k2_errors
          if e["kernel"] == "ensemble_kl_pre"]),
    ]
    kernels = []
    for base, path, source, lines, t, errs in entries:
        for i, kind in enumerate(("fwd", "bwd")):
            name = f"{base}_{kind}"
            kernels.append({
                "name": name, "route": "cuda", "source": src + source,
                "replaces": pallas + lines[i],
                "launches": paths[path]["launches"][name],
                "max_abs_err": max(e[i] for e in errs),
                "ms": t[f"{kind}_ms"], "plain_ms": t[f"plain_{kind}_ms"],
                "call_ms": t[f"{kind}_call_ms"],
                "plain_call_ms": t[f"plain_{kind}_call_ms"],
                "bound_ms": t[f"{kind}_bound_ms"],
                "bound_by": t[f"{kind}_bound_by"], "library_ms": None})
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - start_s
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if problems:
        for p in problems:
            print(f"chip_smoke: {p}", file=sys.stderr)
        return fail(f"{len(problems)} problem(s)")
    print(f"total {report['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
