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
   paths' shape and wider ones (ImageNet's 1000 classes, zamba2's 32000
   vocabulary over 1024 rows, one row on a cluster of 8), K = 1 too,
   float32 and bfloat16 teachers, two temperatures, each shape's launch
   plan printed, two launches of each kernel held to equal bits and every
   instantiation to zero spills; K4 (causal / sliding-window attention) at
   the serve path's shape, gemma3's local width, D = 80, D = 128 with a
   window and two ragged shapes, float32 and bfloat16, beside
   ``scaled_dot_product_attention`` (timed only), after checking that its
   library holds tensor-core (HMMA) instructions and that its serve-path
   instantiations spill no registers; K5 (Mamba2 SSD scan, y and final
   state) at the serve path's shape, mamba2-2.7b's width and two ragged
   shapes in float32, and at the serve path's shape and one ragged shape in
   bfloat16, after checking that its library holds tensor-core (HMMA)
   instructions and that its float32 N = P = 64 instantiation (the serve
   path's) spills no registers;
4. drives four paths on the card, with every launch count set to 0 just
   before a path and read just after it.  Paths 1-3 go through
   ``Experiment(spec).run()`` at the quickstart's published widths, 3
   rounds each:
   - path 1, the FedDF quickstart (``unlabeled`` pool, logit bank): every
     round uses the bank and K1 launches once per distill step;
   - path 2, the paper's Fig. 5 ``generator`` source (no pool): every
     round distils on the fly and K2 launches once per distill step;
   - path 3, the ``buffered_async`` driver with staleness 1 and the
     ``noise`` source under traffic latency: stale uploads reach fusion,
     which takes the weighted consensus, so K2 + K3 launch once per
     distill step with K3 launching;
   and each checks that the globals are finite, then reruns its first
   rounds on the card and on the CPU (plain versions) from the same seed
   and compares them.  Path 4 serves zamba2-1.2b at full width and depth
   through ``repro_torch.launch.serve.serve`` (batch 4, a 2000-token
   prompt, 32 tokens): K4 launches 5 and K5 33 times in the prefill and
   neither in decode; it profiles one prefill, checks forward against
   prefill + 2 forced decode steps at full depth on the card, and 10
   layers at full width on the card against the CPU;
5. prints one ``{"kernels": [...]}`` line, the card line, and as its last
   line ``{"ok": true, "device": {...}}``.

It exits non-zero, without the last line, when there is no CUDA device,
when it does not find the port next to it, or when any phase fails.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 494.7e12       # tensor cores
BF16_FLOPS_PER_S = 989e12         # tensor cores
# exponentials: 16 ex2 per SM and clock (the special-function units), 132
# SMs at the 1.98 GHz maximum SM clock
EXP_PER_S = 16 * 132 * 1.98e9

# (B, N, V): the main path's distill batch over its pool of 3-class rows;
# the repo's roofline records' shape (experiments/dryrun/distill_kl_*
# __b256c64_*); a ragged shape spanning several 2048-wide V tiles
SHAPES = [(64, 4000, 3), (256, 4096, 64), (37, 1000, 5003)]
TEMPERATURES = (1.0, 2.5)
BANK_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")

# K2 (K, B, V): the on-the-fly path's 8 teachers x distill batch 64 x 3
# classes; the roofline records' shape; a ragged shape over several V tiles;
# one teacher; eight teachers over ImageNet's 1000 classes; the JAX distill
# step's 4 teachers over 1024 token rows at zamba2-1.2b's vocabulary (524 MB
# of f32 teachers: L2 is cold by construction); one row on a cluster of 8
# with ragged slices.  K3 (B, V): the weighted-consensus rows of the first
# three batches.  Lane groups run V = 3, a cluster per row the large V with
# few rows, one block per row V = 64 and (4, 1024, 32000)
# (kernels/ensemble_kl.py plan); every mode is checked for equal bits over
# two launches.
K2_SHAPES = [(8, 64, 3), (8, 256, 64), (5, 37, 5003), (1, 64, 3),
             (8, 64, 1000), (4, 1024, 32000), (3, 1, 5003)]
K3_SHAPES = [(64, 3), (256, 64), (37, 5003)]
K2_MODES = ("lanes", "cluster", "block")
K2_KERNELS = 30   # instantiations in ensemble_kl.cu, each checked for spills
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

# K4 (B, H, S, D, window): the serve path's shared attention block
# (zamba2-1.2b: 32 heads x 64, prompt 2000, causal; first: it feeds the
# kernels line); gemma3's local-layer width with equal heads (D 256, window
# 1024); D = 80 (zero-padded in the kernel's 128 bucket) and D = 128 with
# a window; two ragged cases of tests/test_kernels.py.  Against the plain
# version, the JAX package's tolerances (tests/test_kernels.py): rtol 1e-4
# / atol 1e-5 in float32, 3e-2 in bfloat16.
K4_SHAPES = [(4, 32, 2000, 64, None), (1, 8, 4096, 256, 1024),
             (1, 4, 300, 80, None), (2, 8, 1000, 128, 256),
             (1, 2, 100, 8, 24), (2, 4, 128, 32, 32)]
K4_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (3e-2, 3e-2)}
# K5 (B, S, H, P, N): the serve path's Mamba2 layers (zamba2-1.2b, prompt
# 2000; first: it feeds the kernels line); mamba2-2.7b's width; two ragged
# cases of tests/test_kernels.py.  Against the plain version at the
# config's chunk (256; the kernel scans in chunks of 64), y and final
# state, rtol 1e-4 / atol 1e-5 in float32 (tests/test_kernels.py); the
# small cases also against the sequential recurrence.  bfloat16 x, B and C
# at K5_BF16_SHAPES, held at K4's bfloat16 tolerance (3e-2).
K5_SHAPES = [(4, 2000, 64, 64, 64), (1, 4096, 80, 64, 128),
             (1, 17, 2, 8, 4), (1, 50, 3, 8, 16)]
K5_BF16_SHAPES = [(4, 2000, 64, 64, 64), (1, 50, 3, 8, 16)]
K5_CHUNK = 256
K5_RTOL, K5_ATOL = 1e-4, 1e-5
# Path 4: zamba2-1.2b served at full width and depth.
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "zamba2-1.2b", 4, 2000, 32
SERVE_K4, SERVE_K5 = 5, 33          # launches per prefill (38 layers)
# Check (a): forward(prompt + 2) against prefill(prompt) + 2 forced decode
# steps on the card, tests/test_decode.py's tolerances.
PREFILL_RTOL, PREFILL_ATOL, DECODE_ATOL = 2e-3, 2e-4, 2e-3
# Check (b): 10 layers (one pattern repeat + a 3-mamba tail) at full width,
# batch 1, prompt 300, 4 forced decode steps, card (kernels) against CPU
# (plain versions) from the same weights drawn once on the CPU, held to
# 1e-3 of the largest logit.  Beside it every run measures the CPU's own
# sensitivity: the same run with the weights moved by about one unit in the
# last place.
CPU_LAYERS, CPU_PROMPT, CPU_STEPS, CPU_REL_ATOL = 10, 300, 4, 1e-3

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
    """K2 and K3 vs their plain versions at every shape / dtype / T, and
    two launches of each kernel against each other (equal bits);
    timings at T=1."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ensemble_kl as k2
    cases = [(k, b, v, False) for k, b, v in K2_SHAPES] + \
        [(1, b, v, True) for b, v in K3_SHAPES]
    rows, errors = [], []
    for (k, b, v, pre) in cases:
        name = "ensemble_kl_pre" if pre else "ensemble_kl"
        mode = k2.card_plan(device, k, b, v).mode
        for dtype_name in TEACHER_DTYPES:
            s, t = k2_case(k, b, v, dtype_name, seed=k + b + v,
                           device=device)
            t_in = t[0] if pre else t
            for temp in TEMPERATURES:
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
                # two launches of each kernel on the same inputs: equal bits
                g1 = torch.ones((), device=device)
                f1 = k2.kl_fwd(s, t_in, temp, pre)
                f2 = k2.kl_fwd(s, t_in, temp, pre)
                d1 = k2.kl_bwd(s, t_in, f1[1], f1[2], g1, temp, pre)
                d2 = k2.kl_bwd(s, t_in, f1[1], f1[2], g1, temp, pre)
                repeat = (all(torch.equal(x, y) for x, y in zip(f1, f2))
                          and torch.equal(d1, d2))
                ok = (fwd_err <= K2_FWD_ATOL + K2_FWD_RTOL * abs(want)
                      and bwd_excess <= 0 and repeat
                      and bool(torch.isfinite(g_k).all()))
                errors.append({"kernel": name, "K": k, "B": b, "V": v,
                               "teachers": dtype_name, "T": temp,
                               "mode": mode, "loss": want,
                               "fwd_err": fwd_err, "bwd_err": bwd_err,
                               "repeat_equal": repeat, "ok": ok})
                if temp != 1.0:
                    continue
                kl, lse_t, lse_s = f1
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
                       "teachers": dtype_name, "mode": mode,
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


def excess(got, want, rtol: float, atol: float):
    """(max |got - want|, max of |got - want| - atol - rtol |want|): the
    check passes when the second is <= 0."""
    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d - atol - rtol * want.float().abs()).max()))


def bound(byt: float, ops: float) -> dict:
    by_bytes, by_ops = byt / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return {"bytes": byt, "ops": ops,
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def k4_bound(b, h, s, d, window, elem) -> dict:
    """The tensor-core bound: q, k, v read and o written once; 4 D flops
    (q.k and p.v) and one exponential for every (query, key) pair the mask
    lets through.  float32 runs three TF32 passes on the tensor cores,
    bfloat16 one bf16 pass.  The bound is the largest of the three times,
    ``bound_detail`` names it."""
    w = s if window is None else window
    pairs = b * h * sum(min(i + 1, w) for i in range(s))
    byt, ops = 4 * b * h * s * d * elem, 4 * d * pairs
    times = {"bytes": byt / HBM_BYTES_PER_S,
             "tensor cores": (3 * ops / TF32_FLOPS_PER_S if elem == 4
                              else ops / BF16_FLOPS_PER_S),
             "exponentials": pairs / EXP_PER_S}
    detail = max(times, key=times.get)
    return {"bytes": byt, "ops": ops, "exps": pairs,
            "bound_ms": times[detail] * 1e3,
            "bound_by": "bytes" if detail == "bytes" else "operations",
            "bound_detail": detail}


def ptxas_usage(log: str) -> dict:
    """{kernel's mangled name: {"spill_stores", "spill_loads" (bytes),
    "registers"}} from nvcc's -Xptxas -v output."""
    usage, name = {}, None
    for line in log.splitlines():
        words = line.replace(",", " ").split()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            usage[name] = {}
        elif "spill stores" in line and name:
            at = [i for i, w in enumerate(words) if w == "spill"]
            usage[name].update(spill_stores=int(words[at[0] - 2]),
                               spill_loads=int(words[at[-1] - 2]))
        elif "Used" in words and "registers" in words and name:
            usage[name]["registers"] = int(words[words.index("Used") + 1])
    return usage


def hmma_count(lib_path) -> int:
    """Tensor-core instructions (HMMA) in a built library's SASS."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found beside nvcc nor on PATH")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return sum(1 for line in sass.splitlines() if " HMMA" in line)


def k5_bound(b, s, h, p, n, elem) -> dict:
    """The tensor-core bound: x, dt, a_log, B, C read and y, the final
    state written once; per (batch, head) and kernel chunk of l valid steps
    4 l N P (inter-chunk output and state update) + l (l + 1) (N + P) (C.B
    and the intra-chunk product, lower triangles) + l (l - 1) / 2 (segment
    sums) flops, as three TF32 passes on the tensor cores for float32
    inputs and one bf16 pass for bfloat16.  The bound is the larger of the
    two times, ``bound_detail`` names it."""
    from repro_torch.kernels.ssd_scan import CHUNK
    ops = 0
    for c0 in range(0, s, CHUNK):
        ln = min(CHUNK, s - c0)
        ops += 4 * ln * n * p + ln * (ln + 1) * (n + p) + ln * (ln - 1) // 2
    ops *= b * h
    byt = (2 * b * s * h * p * elem + 4 * b * s * h + 4 * h
           + 2 * b * s * n * elem + 4 * b * h * n * p)
    times = {"bytes": byt / HBM_BYTES_PER_S,
             "tensor cores": (3 * ops / TF32_FLOPS_PER_S if elem == 4
                              else ops / BF16_FLOPS_PER_S)}
    detail = max(times, key=times.get)
    return {"bytes": byt, "ops": ops, "bound_ms": times[detail] * 1e3,
            "bound_by": "bytes" if detail == "bytes" else "operations",
            "bound_detail": detail}


def timed(fn) -> dict:
    """Device time (CUDA-graph replay) and eager per-call time of ``fn``,
    with few repeats: these calls take up to milliseconds."""
    return {"ms": device_ms(fn, reps=10, iters=5),
            "call_ms": call_ms(fn, iters=20, warmup=3)}


def k4_phase(device):
    """K4 against its plain version in float32 and bfloat16 at every shape;
    timings of kernel, plain version and the library call
    (scaled_dot_product_attention, timed only) at each shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_attn import swa_attn
    rows, errors = [], []
    for (b, h, s, d, w) in K4_SHAPES:
        gen = torch.Generator().manual_seed(b + h + s + d)
        qkv32 = [torch.randn(b, h, s, d, generator=gen).to(device)
                 for _ in range(3)]
        for dtype_name, (rtol, atol) in K4_TOL.items():
            q, k, v = (t.to(getattr(torch, dtype_name)) for t in qkv32)
            got = swa_attn(q, k, v, w)
            want = ref.swa_attn(q, k, v, w)
            torch.cuda.synchronize()
            err, over = excess(got, want, rtol, atol)
            ok = over <= 0 and got.dtype == q.dtype and bool(
                torch.isfinite(got.float()).all())
            errors.append({"B": b, "H": h, "S": s, "D": d, "window": w,
                           "dtype": dtype_name, "max_abs_err": err,
                           "rtol": rtol, "atol": atol, "ok": ok})
            del got, want
            if s < 1000 and dtype_name != "float32":
                continue
            if w is None:
                lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                             is_causal=True)
            else:
                i = torch.arange(s, device=device)
                mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                                     < w)
                lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                             attn_mask=mask)
            with torch.no_grad():
                t_k = timed(lambda: swa_attn(q, k, v, w))
                t_p = timed(lambda: ref.swa_attn(q, k, v, w))
                t_l = timed(lib)
            rows.append({"B": b, "H": h, "S": s, "D": d, "window": w,
                         "dtype": dtype_name, **t_k,
                         "plain_ms": t_p["ms"], "plain_call_ms":
                         t_p["call_ms"], "library_ms": t_l["ms"],
                         "library_call_ms": t_l["call_ms"],
                         **k4_bound(b, h, s, d, w, q.element_size())})
        del qkv32, q, k, v
        torch.cuda.empty_cache()
    return rows, errors


def k5_inputs(b, s, h, p, n, device):
    """tests/test_kernels.py's distributions: x ~ N(0,1), dt =
    softplus(N(0,1)) / 10, a_log ~ N(0,1) / 2, B and C ~ N(0,1) / 2."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(b + s + h + n)
    x = torch.randn(b, s, h, p, generator=gen)
    dt = F.softplus(torch.randn(b, s, h, generator=gen)) * 0.1
    a_log = torch.randn(h, generator=gen) * 0.5
    bm = torch.randn(b, s, n, generator=gen) * 0.5
    cm = torch.randn(b, s, n, generator=gen) * 0.5
    return [t.to(device) for t in (x, dt, a_log, bm, cm)]


def k5_phase(device):
    """K5 against its plain version (y and final state) at every shape in
    float32, against the sequential recurrence at the small ones, and in
    bfloat16 (x, B and C) at K5_BF16_SHAPES; timings of every float32
    shape and of the serve path's shape in bfloat16."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    cases = ([(shape, "float32") for shape in K5_SHAPES]
             + [(shape, "bfloat16") for shape in K5_BF16_SHAPES])
    rows, errors = [], []
    for (b, s, h, p, n), dtype_name in cases:
        args = k5_inputs(b, s, h, p, n, device)
        if dtype_name == "bfloat16":
            for i in (0, 3, 4):     # x, B and C; dt and a_log stay float32
                args[i] = args[i].to(torch.bfloat16)
        rtol, atol = ((K5_RTOL, K5_ATOL) if dtype_name == "float32"
                      else K4_TOL["bfloat16"])
        y, final = ssd_scan(*args)
        y_ref, final_ref = ref.ssd_scan(*args, K5_CHUNK)
        torch.cuda.synchronize()
        err_y, over_y = excess(y, y_ref, rtol, atol)
        err_s, over_s = excess(final, final_ref, rtol, atol)
        rec = {"B": b, "S": s, "H": h, "P": p, "N": n, "dtype": dtype_name,
               "max_abs_err": max(err_y, err_s), "y_err": err_y,
               "state_err": err_s, "rtol": rtol, "atol": atol}
        ok = (max(over_y, over_s) <= 0 and y.dtype == args[0].dtype
              and bool(torch.isfinite(y.float()).all()))
        if s < 1000 and dtype_name == "float32":
            err_q, over_q = excess(y, ref.ssd_scan_sequential(*args),
                                   rtol, atol)
            rec["sequential_err"] = err_q
            ok = ok and over_q <= 0
        rec["ok"] = ok
        errors.append(rec)
        del y, final, y_ref, final_ref
        if dtype_name == "float32" or s >= 1000:
            with torch.no_grad():
                t_k = timed(lambda: ssd_scan(*args))
                t_p = timed(lambda: ref.ssd_scan(*args, K5_CHUNK))
            rows.append({"B": b, "S": s, "H": h, "P": p, "N": n,
                         "dtype": dtype_name, **t_k,
                         "plain_ms": t_p["ms"],
                         "plain_call_ms": t_p["call_ms"], "library_ms": None,
                         **k5_bound(b, s, h, p, n, args[0].element_size())})
        del args
        torch.cuda.empty_cache()
    return rows, errors


def serve_path(device):
    """Path 4: zamba2-1.2b served at full width and depth on the card
    (``repro_torch.launch.serve.serve``): batch 4, a 2000-token prompt, 32
    tokens, seed 0; then checks (a) and (b)."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get(SERVE_ARCH)
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    params = T.init(cfg, gen, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    toks = torch.randint(0, cfg.vocab_size,
                         (SERVE_BATCH, SERVE_PROMPT + 2), generator=gen)
    prompts = toks[:, :SERVE_PROMPT]
    report = {"arch": cfg.name, "batch": SERVE_BATCH,
              "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
              "params_stored": n_params,
              "init_s": time.perf_counter() - t0}
    problems = []

    # one prefill alone: its launches
    torch.cuda.synchronize()
    reset_all_launches()
    with torch.no_grad():
        T.prefill(params, cfg, {"tokens": prompts.to(device)},
                  max_seq=SERVE_PROMPT + SERVE_GEN, last_only=True)
    torch.cuda.synchronize()
    prefill_launches = {k: n for k, n in all_launches().items() if n}

    # the path: serve(), every count set to 0 just before and read after
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    res = serve(cfg, params, prompts, SERVE_GEN, device=device,
                generator=torch.Generator().manual_seed(0))
    launches = all_launches()
    report.update(
        launches=launches, prefill_launches=prefill_launches,
        prefill_s=res.prefill_s, decode_s=res.decode_s,
        decode_tokens_per_s=res.decode_tokens_per_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        tokens=res.tokens[:, :8].tolist())
    decode_launches = {k: launches[k] - prefill_launches.get(k, 0)
                       for k in launches}
    report["decode_launches"] = decode_launches
    if prefill_launches != {"swa_attn": SERVE_K4, "ssd_scan": SERVE_K5}:
        problems.append(f"prefill launched {prefill_launches}, expected "
                        f"swa_attn {SERVE_K4} and ssd_scan {SERVE_K5}")
    if any(decode_launches.values()):
        problems.append(f"decode launched kernels: {decode_launches}")
    if tuple(res.tokens.shape) != (SERVE_BATCH, SERVE_GEN) or not (
            0 <= int(res.tokens.min())
            and int(res.tokens.max()) < cfg.vocab_size):
        problems.append(f"tokens {tuple(res.tokens.shape)} out of range")
    if not all(bool(torch.isfinite(t).all())
               for t in [res.prefill_logits, *res.step_logits]):
        problems.append("non-finite logits")

    # the prefill's busy share and device time by kernel, from a trace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            T.prefill(params, cfg, {"tokens": prompts.to(device)},
                      max_seq=SERVE_PROMPT + SERVE_GEN, last_only=True)
        torch.cuda.synchronize()
    report["prefill_device"] = device_time(prof, res.prefill_s,
                                           ("swa_attn", "ssd_scan", "gemm"))
    # and of one decode step, continued from a fresh prefill: step 0 timed
    # unprofiled, step 1 traced
    with torch.no_grad():
        lg, caches = T.prefill(params, cfg, {"tokens": prompts.to(device)},
                               max_seq=SERVE_PROMPT + SERVE_GEN,
                               last_only=True)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        step_s = []
        for i in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         ) if i else contextlib.nullcontext() as prof:
                T.decode_step(params, cfg, {"tokens": tok}, caches,
                              SERVE_PROMPT + i)
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
        del caches
    report["decode_step_s"] = step_s
    report["decode_device"] = device_time(prof, step_s[0], ("gemm", "gemv"))

    # (a) full depth on the card: forward(prompt + 2) against prefill +
    # two teacher-forced decode steps
    with torch.no_grad():
        dev_toks = toks.to(device)
        full = T.forward(params, cfg, {"tokens": dev_toks})
        pre, caches = T.prefill(params, cfg,
                                {"tokens": dev_toks[:, :SERVE_PROMPT]},
                                max_seq=SERVE_PROMPT + 2)
        err_p, over_p = excess(pre, full[:, :SERVE_PROMPT], PREFILL_RTOL,
                               PREFILL_ATOL)
        del pre
        err_d = []
        for i in range(2):
            dec, caches = T.decode_step(
                params, cfg,
                {"tokens": dev_toks[:, SERVE_PROMPT + i: SERVE_PROMPT + i
                                    + 1]}, caches, SERVE_PROMPT + i)
            err_d.append(float((dec[:, 0] - full[:, SERVE_PROMPT + i])
                               .abs().max()))
        max_logit = float(full.abs().max())
        del full, caches
    check_a = {"prefill_err": err_p, "prefill_rtol": PREFILL_RTOL,
               "prefill_atol": PREFILL_ATOL, "decode_err": err_d,
               "decode_atol": DECODE_ATOL, "max_abs_logit": max_logit}
    report["check_a"] = check_a
    if over_p > 0 or max(err_d) >= DECODE_ATOL:
        problems.append(f"check (a) full depth: {check_a}")
    del params
    torch.cuda.empty_cache()

    # (b) 10 layers at full width: the card (kernels) against the CPU
    # (plain versions) from the same weights drawn once on the CPU; beside
    # it, the CPU's own sensitivity (weights moved by about one unit in the
    # last place)
    small = dataclasses.replace(cfg, n_layers=CPU_LAYERS)
    cpu_params = T.init(small, torch.Generator().manual_seed(1))
    gen_ulp = torch.Generator().manual_seed(3)
    nudged = tree_map(lambda x: x * (1 + 2.0 ** -23 * torch.randn(
        x.shape, generator=gen_ulp)), cpu_params)
    stoks = torch.randint(0, cfg.vocab_size, (1, CPU_PROMPT + CPU_STEPS),
                          generator=torch.Generator().manual_seed(2))
    cpu = torch.device("cpu")
    runs = {}
    for name, c, dev, p in (
            ("cuda", small, device, tree_map(lambda x: x.to(device),
                                             cpu_params)),
            ("cpu", small, cpu, cpu_params),
            ("cpu_nudged", small, cpu, nudged)):
        reset_all_launches()
        with torch.no_grad():
            t = stoks.to(dev)
            lg, caches = T.prefill(p, c, {"tokens": t[:, :CPU_PROMPT]},
                                   max_seq=CPU_PROMPT + CPU_STEPS)
            steps = []
            for i in range(CPU_STEPS):
                d, caches = T.decode_step(
                    p, c, {"tokens": t[:, CPU_PROMPT + i:
                                       CPU_PROMPT + i + 1]},
                    caches, CPU_PROMPT + i)
                steps.append(d.cpu())
        runs[name] = (lg.cpu(), torch.cat(steps, dim=1),
                      {k: n for k, n in all_launches().items() if n})
        del p, caches
    lg_c, st_c, l_c = runs["cpu"]
    scale = float(lg_c.abs().max())

    def diff(name):
        lg, st, _ = runs[name]
        return (float((lg - lg_c).abs().max()),
                float((st - st_c).abs().max()))
    check_b = {"layers": CPU_LAYERS, "prompt": CPU_PROMPT,
               "steps": CPU_STEPS, "max_abs_logit": scale,
               "atol": CPU_REL_ATOL * scale,
               "prefill_err": diff("cuda")[0], "decode_err": diff("cuda")[1],
               "cpu_one_ulp_prefill_decode": diff("cpu_nudged"),
               "launches_cuda": runs["cuda"][2], "launches_cpu": l_c}
    report["check_b"] = check_b
    if (max(check_b["prefill_err"], check_b["decode_err"]) > check_b["atol"]
            or runs["cuda"][2] != {"swa_attn": 1, "ssd_scan": CPU_LAYERS - 1}
            or l_c):
        problems.append(f"check (b) card vs CPU: {check_b}")
    return report, problems


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


def device_time(prof, round_wall_s: float, kernels=("bank_kl",)) -> dict:
    """Kernel time on the card from a profiler trace, by kernel name, with
    the sum over the names that contain each of ``kernels``.  Reported
    only: a trace without device events reads 'not measured'."""
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
            **{f"{name}_s": sum(t for k, (t, _) in by_name.items()
                                if name in k) for name in kernels},
            "top": [(k[:80], t, c) for k, (t, c) in top]}


def _kernel_modules():
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ensemble_kl_bank as k1
    from repro_torch.kernels import ssd_scan as k5
    from repro_torch.kernels import swa_attn as k4
    return k1, k2, k4, k5


def reset_all_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def all_launches() -> dict:
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


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
    libs = build.build(["ensemble_kl_bank", "ensemble_kl", "swa_attn",
                        "ssd_scan"])
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.2f} s (all sources in parallel)",
          flush=True)
    for lib in libs.values():
        for line in lib.log.splitlines():
            if ("registers" in line or "smem" in line or "Compiling" in line
                    or (lib.name in ("swa_attn", "ssd_scan")
                        and "spill" in line)):
                print(f"  ptxas {lib.name}: {line.strip()}")
    # K4 runs on the tensor cores, and its serve-path instantiations (head
    # dimension bucket 64, f32 and bf16) spill nothing
    k4_lib = libs["swa_attn"]
    report["k4_hmma"] = hmma_count(k4_lib.path)
    report["k4_ptxas"] = ptxas_usage(k4_lib.log)
    print(f"  swa_attn: {report['k4_hmma']} HMMA instructions "
          f"(cuobjdump -sass)", flush=True)
    build_problems = []
    # K2 / K3: every instantiation spills nothing: lane groups, cluster and
    # block per row forward, and the backward at both index widths, each for
    # 1, 4 and 8 teachers in flight and f32 and bf16 teachers (30)
    report["k2_ptxas"] = ptxas_usage(libs["ensemble_kl"].log)
    k2_spills = {n: u for n, u in report["k2_ptxas"].items()
                 if u.get("spill_stores") != 0 or u.get("spill_loads") != 0}
    spill_bytes = sum(u.get("spill_stores", 0) + u.get("spill_loads", 0)
                      for u in report["k2_ptxas"].values())
    print(f"  ensemble_kl: {len(report['k2_ptxas'])} kernels, registers "
          f"{sorted(u.get('registers') for u in report['k2_ptxas'].values())}"
          f", spill bytes {spill_bytes}", flush=True)
    if len(report["k2_ptxas"]) != K2_KERNELS or k2_spills:
        build_problems.append(f"ensemble_kl's {K2_KERNELS} kernels spill or "
                              f"are missing: {report['k2_ptxas']}")
    if report["k4_hmma"] == 0:
        build_problems.append("swa_attn has no HMMA instruction")
    d64 = {n: u for n, u in report["k4_ptxas"].items()
           if "IfLi64E" in n or "bfloat16Li64E" in n}
    if len(d64) != 2 or any(u.get("spill_stores") != 0
                            or u.get("spill_loads") != 0
                            for u in d64.values()):
        build_problems.append(f"swa_attn's D <= 64 instantiations spill or "
                              f"are missing: {d64}")
    # K5's chunk products run on the tensor cores too, and its serve-path
    # instantiation (float32, N and P buckets 64) spills nothing
    k5_lib = libs["ssd_scan"]
    report["k5_hmma"] = hmma_count(k5_lib.path)
    report["k5_ptxas"] = ptxas_usage(k5_lib.log)
    print(f"  ssd_scan: {report['k5_hmma']} HMMA instructions "
          f"(cuobjdump -sass)", flush=True)
    if report["k5_hmma"] == 0:
        build_problems.append("ssd_scan has no HMMA instruction")
    n64 = {n: u for n, u in report["k5_ptxas"].items()
           if "IfLi64ELi64EE" in n}
    if len(n64) != 1 or any(u.get("spill_stores") != 0
                            or u.get("spill_loads") != 0
                            for u in n64.values()):
        build_problems.append(f"ssd_scan's float32 N = P = 64 instantiation "
                              f"spills or is missing: {n64}")

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
              f"{e['teachers']:8s} T={e['T']} mode {e['mode']}: fwd "
              f"{e['fwd_err']:.2e} bwd {e['bwd_err']:.2e} two launches "
              f"{'equal' if e['repeat_equal'] else 'DIFFER'} "
              f"{'ok' if e['ok'] else 'FAIL'}")
    # each forward mode and the backward ran, and repeated bit for bit
    missing = set(K2_MODES) - {e["mode"] for e in k2_errors}
    if missing:
        build_problems.append(f"K2 phase ran no shape in mode(s) {missing}")
    for r in timings + k2_timings:
        parts = []
        for k in ("fwd", "bwd"):
            parts.append(
                f"{k} {r[f'{k}_ms'] * 1e3:.2f} us device / "
                f"{r[f'{k}_call_ms'] * 1e3:.2f} us per call (plain "
                f"{r[f'plain_{k}_ms'] * 1e3:.2f} / "
                f"{r[f'plain_{k}_call_ms'] * 1e3:.2f}, bound "
                f"{r[f'{k}_bound_ms'] * 1e3:.4f}, "
                f"{100 * r[f'{k}_bound_ms'] / r[f'{k}_ms']:.1f}% of it)")
        what = (f"{r['kernel']} K={r['K']} B={r['B']} V={r['V']} "
                f"{r['teachers']} mode {r['mode']}" if "kernel" in r else
                f"K1 B={r['B']} N={r['N']} V={r['V']} {r['bank']}")
        print(f"  time {what}: " + "; ".join(parts))
    k4_timings, k4_errors = k4_phase(device)
    k5_timings, k5_errors = k5_phase(device)
    report.update(k4_errors=k4_errors, k4_timings=k4_timings,
                  k5_errors=k5_errors, k5_timings=k5_timings)
    for e in k4_errors:
        print(f"  check swa_attn B={e['B']} H={e['H']} S={e['S']} D={e['D']} "
              f"window={e['window']} {e['dtype']:8s}: max abs err "
              f"{e['max_abs_err']:.2e} (rtol {e['rtol']:.0e} atol "
              f"{e['atol']:.0e}) {'ok' if e['ok'] else 'FAIL'}")
    for e in k5_errors:
        print(f"  check ssd_scan B={e['B']} S={e['S']} H={e['H']} P={e['P']} "
              f"N={e['N']} {e['dtype']:8s}: y {e['y_err']:.2e} state "
              f"{e['state_err']:.2e} sequential "
              f"{e.get('sequential_err', '-')} (rtol {e['rtol']:.0e} atol "
              f"{e['atol']:.0e}) {'ok' if e['ok'] else 'FAIL'}")
    for name, rows in (("swa_attn", k4_timings), ("ssd_scan", k5_timings)):
        for r in rows:
            shape = " ".join(f"{k}={r[k]}" for k in
                             ("B", "H", "S", "D", "window", "dtype", "P",
                              "N") if k in r)
            lib = ("-" if r["library_ms"] is None else
                   f"{r['library_ms'] * 1e3:.1f} / "
                   f"{r['library_call_ms'] * 1e3:.1f}")
            print(f"  time {name} {shape}: {r['ms'] * 1e3:.1f} us device / "
                  f"{r['call_ms'] * 1e3:.1f} us per call; plain "
                  f"{r['plain_ms'] * 1e3:.1f} / "
                  f"{r['plain_call_ms'] * 1e3:.1f}; library {lib}; bound "
                  f"{r['bound_ms'] * 1e3:.1f} us by "
                  f"{r.get('bound_detail', r['bound_by'])}", flush=True)
    problems = build_problems + [
        f"kernel check failed: {e}" for e in
        errors + k2_errors + k4_errors + k5_errors if not e["ok"]]

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
    t0 = time.perf_counter()
    rep, path_problems = serve_path(device)
    rep["total_s"] = time.perf_counter() - t0
    paths["path4_serve"] = rep
    problems += [f"path4_serve: {p}" for p in path_problems]
    report["paths"] = paths
    print(f"  path 1 round 1 on the card, from a profiler trace: "
          f"{paths['path1_quickstart']['round1_device']}")
    print(f"  path4_serve {rep['arch']} batch {rep['batch']} prompt "
          f"{rep['prompt']} gen {rep['gen']}: init {rep['init_s']:.1f} s, "
          f"prefill {rep['prefill_s']:.3f} s, decode {rep['decode_s']:.3f} s "
          f"({rep['decode_tokens_per_s']:.1f} tok/s), peak "
          f"{rep['peak_mem_bytes'] / 2**30:.2f} GiB; launches prefill "
          f"{rep['prefill_launches']} decode {rep['decode_launches']}; "
          f"whole path {rep['total_s']:.1f} s")
    print(f"  path4_serve prefill on the card, from a profiler trace: "
          f"{rep['prefill_device']}")
    print(f"  path4_serve decode step on the card, from a profiler trace: "
          f"{rep['decode_device']}")
    print(f"  path4_serve check (a) full depth: {rep['check_a']}")
    print(f"  path4_serve check (b) card vs CPU: {rep['check_b']}",
          flush=True)

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
    for name, rows, errs, line, lib in (
            ("swa_attn", k4_timings, k4_errors, "src/repro/kernels/"
             "swa_attn.py:32", True),
            ("ssd_scan", k5_timings, k5_errors, "src/repro/kernels/"
             "ssd_scan.py:28", False)):
        t = rows[0]                 # the serve path's shape, float32
        kernels.append({
            "name": name, "route": "cuda", "source": src + name + ".cu",
            "replaces": line,
            "launches": paths["path4_serve"]["launches"][name],
            "max_abs_err": max(e["max_abs_err"] for e in errs
                               if e.get("dtype", "float32") == "float32"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "call_ms": t["call_ms"], "plain_call_ms": t["plain_call_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"] if lib else None,
            "bound_detail": t["bound_detail"]})
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
