#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port (``src/repro_torch``) and nothing of the JAX package,
and in order:

1. prints the card's name and power limit (``nvidia-smi``) and the torch
   and CUDA versions;
2. builds every kernel of the main path from the sources in the checkout
   (nvcc, ``sm_90a``) and prints the build time and ptxas's register and
   shared-memory lines;
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shape and two wider ones, for every bank dtype and two
   temperatures, and times kernel, plain version and bound;
4. drives the main path, the FedDF quickstart spec at its published
   widths, for three rounds on the card through ``Experiment(spec).run()``
   with the launch counts set to 0 just before, and checks that every
   round used the logit bank, that each kernel launched once per distill
   step, and that the globals are finite; then reruns round 1 on the card
   and on the CPU (plain versions) from the same seed and compares them;
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

# The quickstart main path (examples/quickstart.py at its published widths).
MAIN_ROUNDS = 3
# Round 1 on the card against round 1 on the CPU (plain versions), from the
# same seed, batches and index stream.  The two differ only by float32
# summation order (cuBLAS vs CPU matmuls, kernel vs log_softmax), compounded
# over ~600 SGD client steps and a few hundred Adam distill steps; Adam
# normalises each step by sqrt(v), so ~1e-7 differences in tiny gradients can
# move a weight by up to lr per step.  The bound is set at a small fraction of
# the weights' scale (the mlp's weights are O(0.1 - 1)), and the accuracy may
# move by at most one test example in a hundred.
ROUND1_PARAM_ATOL = 1e-3
ROUND1_ACC_ATOL = 0.01


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


def main_path():
    from repro_torch.api import Experiment
    from repro_torch.kernels import ensemble_kl_bank as k1
    spec = quickstart_spec(MAIN_ROUNDS)
    k1.reset_launches()
    t0 = time.perf_counter()
    res = Experiment(spec, device="cuda").run()
    wall = time.perf_counter() - t0
    launches = dict(k1.LAUNCHES)
    logs = res.result.logs
    rounds = [{**{k: getattr(l, k) for k in
                  ("round", "test_acc", "val_acc", "pre_distill_acc",
                   "distill_steps", "bank", "bank_dtype", "bank_nbytes",
                   "n_participants")},
               "phase_s": ph} for l, ph in zip(logs, res.phase_seconds)]
    problems = []
    if len(logs) != MAIN_ROUNDS:
        problems.append(f"ran {len(logs)} rounds, expected {MAIN_ROUNDS}")
    if any(l.bank != "bank" for l in logs):
        problems.append(f"bank decisions {[l.bank for l in logs]}")
    steps = sum(l.distill_steps for l in logs)
    for name, n in launches.items():
        if n != steps or n == 0:
            problems.append(f"{name} launched {n} times for {steps} "
                            f"distill steps")
    from repro_torch.common.pytree import tree_isfinite
    if not bool(tree_isfinite(res.global_params[0])):
        problems.append("non-finite globals")

    # round 1 again, on the card and on the CPU, from the same seed
    one = dataclasses.replace(spec, rounds=1)
    # the card's rerun is profiled: its device time against round 1's
    # unprofiled wall time is the device's busy share on the main path
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gpu1 = Experiment(one, device="cuda").run()
    busy = device_time(prof, sum(res.phase_seconds[0].values()))
    cpu1 = Experiment(one, device="cpu").run()
    if gpu1.result.logs[0] != logs[0]:
        problems.append("round 1 differs between two runs on the card")
    d_param = max_abs_diff(gpu1.global_params[0], cpu1.global_params[0])
    d_acc = abs(gpu1.result.logs[0].test_acc - cpu1.result.logs[0].test_acc)
    check = {"max_abs_param_diff": d_param, "param_tol": ROUND1_PARAM_ATOL,
             "test_acc_cuda": gpu1.result.logs[0].test_acc,
             "test_acc_cpu": cpu1.result.logs[0].test_acc,
             "test_acc_diff": d_acc, "acc_tol": ROUND1_ACC_ATOL,
             "distill_steps_cuda": gpu1.result.logs[0].distill_steps,
             "distill_steps_cpu": cpu1.result.logs[0].distill_steps}
    if d_param > ROUND1_PARAM_ATOL or d_acc > ROUND1_ACC_ATOL:
        problems.append(f"round 1 card vs CPU: {check}")
    return {"wall_s": wall, "rounds": rounds, "launches": launches,
            "distill_steps": steps, "cpu_check": check,
            "round1_device": busy}, problems


def main() -> int:
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
    libs = build.build(["ensemble_kl_bank"])
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.2f} s", flush=True)
    for lib in libs.values():
        for line in lib.log.splitlines():
            if "registers" in line or "smem" in line or "Compiling" in line:
                print(f"  ptxas {lib.name}: {line.strip()}")

    # 3. kernels vs plain versions
    timings, errors = kernel_phase(device)
    report["kernel_errors"], report["kernel_timings"] = errors, timings
    for e in errors:
        print(f"  check B={e['B']} N={e['N']} V={e['V']} {e['bank']:9s} "
              f"T={e['T']}: fwd {e['fwd_err']:.2e} (tol {e['fwd_tol']:.1e}) "
              f"bwd {e['bwd_err']:.2e} (tol {e['bwd_tol']:.1e}) "
              f"{'ok' if e['ok'] else 'FAIL'}")
    for r in timings:
        parts = []
        for k in ("fwd", "bwd"):
            parts.append(
                f"{k} {r[f'{k}_ms'] * 1e3:.2f} us device / "
                f"{r[f'{k}_call_ms'] * 1e3:.2f} us per call (plain "
                f"{r[f'plain_{k}_ms'] * 1e3:.2f} / "
                f"{r[f'plain_{k}_call_ms'] * 1e3:.2f}, bound "
                f"{r[f'{k}_bound_ms'] * 1e3:.4f})")
        print(f"  time B={r['B']} N={r['N']} V={r['V']} {r['bank']:9s}: "
              + "; ".join(parts))
    problems = [f"kernel check failed: {e}" for e in errors if not e["ok"]]

    # 4. main path
    main_report, main_problems = main_path()
    report["main_path"] = main_report
    problems += main_problems
    for r in main_report["rounds"]:
        ph = " ".join(f"{k}={v:.3f}s" for k, v in r["phase_s"].items())
        print(f"  round {r['round']}: test_acc={r['test_acc']:.4f} "
              f"pre_distill={r['pre_distill_acc']:.4f} "
              f"distill_steps={r['distill_steps']} bank={r['bank']} {ph}")
    print(f"  round 1 on the card, from a profiler trace: "
          f"{main_report['round1_device']}")
    print(f"  launches {main_report['launches']} for "
          f"{main_report['distill_steps']} distill steps; card vs CPU round 1:"
          f" {main_report['cpu_check']}")

    # 5. output
    main_t = next(r for r in timings if (r["B"], r["N"], r["V"]) == SHAPES[0]
                  and r["bank"] == "float32")
    kernels = []
    for kind, replaces in (("fwd", "src/repro/kernels/ensemble_kl.py:155"),
                           ("bwd", "src/repro/kernels/ensemble_kl.py:180")):
        name = f"ensemble_kl_bank_{kind}"
        key = "fwd_err" if kind == "fwd" else "bwd_err"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ensemble_kl_bank.cu",
            "replaces": replaces,
            "launches": main_report["launches"][name],
            "max_abs_err": max(e[key] for e in errors),
            "ms": main_t[f"{kind}_ms"], "plain_ms": main_t[f"plain_{kind}_ms"],
            "call_ms": main_t[f"{kind}_call_ms"],
            "plain_call_ms": main_t[f"plain_{kind}_call_ms"],
            "bound_ms": main_t[f"{kind}_bound_ms"],
            "bound_by": main_t[f"{kind}_bound_by"], "library_ms": None})
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if problems:
        for p in problems:
            print(f"chip_smoke: {p}", file=sys.stderr)
        return fail(f"{len(problems)} problem(s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
