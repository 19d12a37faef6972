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
   path's shape, three wider ones (zamba2's 32000 vocabulary over 1024
   rows the widest) and path 8's (distill batches of 32 and 48, the token
   path's 4 classes), for every bank dtype and two temperatures, each
   shape's launch plan printed, two launches held to equal bits, every
   instantiation to zero spills, each forward mode timed against the
   others where the plan switches, the backward's grid capped at one wave
   timed against the plan's full grid, and an index outside the bank shown
   to poison exactly its row in every mode; K2 (raw teachers) and K3
   (pre-averaged rows) at their paths' shape and wider ones (ImageNet's
   1000 classes, zamba2's 32000 vocabulary over 1024 rows, one row on a
   cluster of 8), path 5b's K = 6 of 8 teacher slots, path 7e's K = 13
   (the 8-teacher load template twice) and K = 1 too,
   float32 and bfloat16 teachers, two temperatures, each shape's launch
   plan printed, two launches of each kernel held to equal bits and every
   instantiation to zero spills; K4 (causal / sliding-window attention) at
   the serve path's shape, gemma3's local width, D = 80, D = 128 with a
   window, two ragged shapes and, with key / value heads grouped under the
   query heads, D = 256 without a window over 4096 keys, path 12's qwen3-8b
   and gemma3-4b layers and a ragged grouped shape, float32 and bfloat16,
   beside ``scaled_dot_product_attention`` (timed only), after checking
   that its library holds tensor-core (HMMA) instructions and that its
   serve-path instantiations spill no registers; K5 (Mamba2 SSD scan, y
   and final
   state) at the serve path's shape, mamba2-2.7b's width and two ragged
   shapes in float32, and at the serve path's shape and one ragged shape in
   bfloat16, after checking that its library holds tensor-core (HMMA)
   instructions and that its float32 N = P = 64 instantiation (the serve
   path's) spills no registers;
4. drives twelve paths on the card, with every launch count set to 0 just
   before a path and read just after it.  Paths 1-3 go through
   ``Experiment(spec).run()`` at the quickstart's published widths, 2
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
   layers at full width on the card against the CPU.  Paths 5-6 go
   through ``Experiment(spec).run()`` too, and compare every prototype
   group with a CPU run at paths 1-2's bounds:
   - path 5a, heterogeneous FedDF (the paper's Algorithm 3) on
     ``examples/heterogeneous_fusion.py``'s spec at its published widths
     (three mlp prototypes, 9 clients), 2 rounds: every fused group uses
     the one bank over all groups' teachers, and K1 launches once per
     distill step of every group (K2 and K3 never); a profiled card rerun
     of round 1 must repeat it;
   - path 5b, the same spec on the fly, 1 round: K2 launches once per
     distill step of every group over the three nets' teachers, K1
     never; then FedAvg within each group, 1 round, which launches no
     kernel;
   - path 6, the paper's baselines on the quickstart spec: ``fedavgm``
     for 2 rounds, ``fedprox`` for 1 (no kernel), and FedDF with local
     Adam for 1 (K1 once per distill step); ``fedavgm``'s server rule is
     also held on its own, the CPU's against the card's on the card
     run's uploads and momentum buffer of each round;
   - path 7, the paper's remaining ablations, 1 round each, each held
     against the CPU with every discrete fact equal (distill steps,
     drops, bank decision, teacher forwards): 7a drop-worst at Table 3's
     instability settings (it must drop some uploads and keep some, its
     drops printed; its fusion amplifies float32 rounding, so the whole
     round's distance is reported beside the CPU's own spread under a
     1-ulp nudge of the init, and on the card's own uploads the
     aggregation's facts and accuracy are held against the CPU, K1
     against its plain version at every distill step of a rerun of the
     fusion, and the fusion's first 50 steps card against CPU within
     1e-3), 7b 1-bit clients at
     ``examples/lowbit_fl.py``'s spec (its uplink bytes printed), 7c DP
     uploads, 7d SWAG teachers on the bank (K1 once per distill step over
     8 + 5 teachers; a profiled card rerun must repeat it) and 7e on the
     fly (K2 once per distill step at K = 13, K1 never);
   - path 8, the port's last training axes, each held against the CPU
     with every discrete fact equal: 8a buffered heterogeneous fusion
     (path 5's spec on path 3's driver, 2 rounds: fresh rounds on K2,
     round 1 at K = 6, stale rounds on K3; it must fuse a stale upload,
     each group's staleness histograms printed), compared after round 1
     and after rounds 1-2; 8b(i) step-count bucketing (``pow2``) on the
     quickstart, 1 round on K1: its uploads against the unbucketed
     round's on the card within 1e-5, its globals within 1e-3 with equal
     distill steps, ``real_steps``, ``padded_slots`` and ``train_clients``
     seconds printed bucketed and not; 8b(ii) distill batches of 32, 64
     and 48 on path 5a's spec, 1 round: K1 at those B on one bank; 8c the
     token path (``examples/train_e2e.py``'s spec, tiny_transformer), 1
     round on K1 at (64, 4000, 4), a profiled card rerun of it;
   - path 9, fault injection, robust fusion and resume on the quickstart
     under docs/robustness.md's fault mix: 9a the defended FedDF on the
     bank (K1), 2 rounds, its fault decisions, kept teachers, distill
     steps and bank decisions equal card vs CPU and the screen's and
     teacher filter's smallest |z - sigma| printed; 9b undefended, a NaN
     upload in the bank, K1 on non-finite rows, the divergence guard's
     chunk and the rollback equal card vs CPU; 9c ``trimmed_mean`` and
     ``coordinate_median``, no kernel, globals within 1e-5; 9d path 3's
     buffered driver with a quorum (K2 then K3); 9e path 1's spec stopped
     by an observer at round 3 and resumed from its round-2 snapshot on
     the card, against an uninterrupted run (cohorts, steps, accuracy
     equal, globals within 1e-6, bit equality printed);
   - path 10, the runtime around the round engine on the quickstart
     spec: 10a ``async_pipelined`` at staleness 0 against ``sync`` bit
     for bit (K1); 10b staleness 1 on the bank (K1) and 2 on the
     generator source (K2), 3 rounds each, against the CPU over rounds
     1-2, with each round's overlap share (1 - join_fusion / wall) from
     the flight recorder's spans, and 10b(i) rerun with the profiler
     over round 2's fusion beside round 3's training: K1 on a stream of
     its own, the device time K1 overlaps the training and the busy
     share, the two card runs bit for bit; 10c the ``distributed``
     driver over 2 loopback pods and 10d over 2 tcp subprocess pods on
     the card (their start-up seconds printed), fp32 uploads, 2 rounds,
     bit for bit against 10a's sync run; 10e int8 uploads under the
     chaos mix (5% corrupted frames, quorum 0.5, pod 1 killed in round
     1), every wire decision card against CPU over rounds 1-2; 10f a
     fusion-pod restart replaying 10c's wire log, bit for bit; 10g 10a's
     run with the flight recorder armed, bit for bit, every engine phase
     spanned in every round;
   - path 11, the train CLI and the persistent logit bank: 11a
     ``python -m repro_torch.launch.train`` in subprocesses on the
     quickstart's flags, 2 rounds with ``--dump-config`` (its
     ``spec.json`` equal to the same flags compiled here), then side by
     side a ``--config`` replay and a ``--resume`` of the run stopped after
     round 1, each with the first run's per-round log, and K1 once per
     distill step of each from the launch counts the CLI prints; 11b one
     card round's uploads fused twice through ``feddf_fuse_stacked`` (the
     quickstart) and through the heterogeneous fuse (path 5a's spec): the
     second fuse ``bank_reused`` with no teacher forward and no build time,
     its globals equal to the first's bit for bit, K1 once per distill step
     both times, and the cache empty once the uploads are freed;
   - path 12, after path 4: the grouped-query decoders qwen3-8b and then
     gemma3-4b served at full width and depth at path 4's batch, prompt
     and tokens (random fp32 weights drawn on the card from seed 0): K4
     36 and 34 times per prefill and none in decode, a profiled prefill,
     forward against prefill + 2 forced decode steps at full depth (batch
     1; gemma3's prompt outgrows its 1024 window, so its local caches roll
     and decode on the ring) and 2 layers at full width card against CPU,
     both within 1e-3 of the largest logit;
   and, in step 3, K1 (every bank dtype) and K2 / K3 in each launch mode
   on rows holding a NaN, a +Inf and a -Inf teacher logit: non-finite
   exactly where the plain versions are, within tolerance elsewhere, two
   launches equal bit for bit;
5. prints one ``{"kernels": [...]}`` line (each kernel's launches on its
   path and, under ``path7_launches`` to ``path12_launches``, on each of
   paths 7's to 12's sub-paths), the card line, and as its last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero, without the last line, when there is no CUDA device,
when it does not find the port next to it, or when any phase fails.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
# __b256c64_*); a ragged shape spanning several 2048-wide V tiles; 1024
# token rows at zamba2-1.2b's vocabulary, K2's widest shape (the bank's
# gathered rows and the student 250 MB in f32: L2 is cold by
# construction); path 8's distill batches of 32 and 48 over path 5a's pool
# (8b(ii)) and the token path's 4 classes (8c).  K1 runs the launch plan of
# K2/K3 at K = 1, with its own cluster threshold (V > 4096): lane groups at
# V <= 32, one block per row at V = 64 and 32000, a cluster of 8 per row at
# (37, 5003).
SHAPES = [(64, 4000, 3), (256, 4096, 64), (37, 1000, 5003),
          (1024, 4096, 32000), (32, 4000, 3), (48, 4000, 3), (64, 4000, 4)]
TEMPERATURES = (1.0, 2.5)
BANK_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")
K1_KERNELS = 20   # ensemble_kl_bank.cu's instantiations, each held to 0 spills
# K1's forward modes, each forced through ``launch=`` and timed against the
# others (float32 bank of K1_MODE_N rows, T = 1) where the plan switches:
# V = 32 / 33 (lane groups / block); at B = 16, 64, 128, V = 512 / 513
# (K2's switch to a cluster), V = 2000 and V = 4096 / 4097 (K1's) and
# V = 5003, where K1 takes clusters of 8, 4, 2.
K1_FWD_MODES = (("lanes", 1), ("block", 1), ("cluster", 2), ("cluster", 4),
                ("cluster", 8))
K1_MODE_SHAPES = [(64, 32), (64, 33)] + [
    (b, v) for b in (16, 64, 128) for v in (512, 513, 2000, 4096, 4097, 5003)]
K1_MODE_N = 4000
# K1's flat backward, its grid capped at one wave (the wrapper's bwd_grid)
# against the plan's grid of one element a thread, where they differ:
# zamba2's vocabulary over 1024 and 64 rows
K1_BWD_GRID_SHAPES = [(1024, 32000), (64, 32000)]
# an index outside the bank, in each mode's own shape (B = 7: the lane
# groups' last warp holds a row past B): rows 2 (index N) and 5 (index -1)
K1_POISON_SHAPES = {"lanes": 3, "block": 300, "cluster": 5003}

# K2 (K, B, V): the on-the-fly path's 8 teachers x distill batch 64 x 3
# classes; path 5b's and path 8a's round-1 6 teachers of three nets (2 of
# the 8-teacher load template's slots left empty); path 7e's 8 uploads + 5 SWAG teachers (the
# 8-teacher load template run twice, 3 live slots the second time); the
# roofline records' shape; a ragged
# shape over several V tiles; one teacher; eight teachers over ImageNet's
# 1000 classes; the JAX distill step's 4 teachers over 1024 token rows at
# zamba2-1.2b's vocabulary (524 MB of f32 teachers: L2 is cold by
# construction); one row on a cluster of 8 with ragged slices.  K3 (B, V):
# the weighted-consensus rows of the first three batches.  Lane groups run V = 3, a cluster per row the large V with
# few rows, one block per row V = 64 and (4, 1024, 32000)
# (kernels/ensemble_kl.py plan); every mode is checked for equal bits over
# two launches.
K2_SHAPES = [(8, 64, 3), (6, 64, 3), (13, 64, 3), (8, 256, 64),
             (5, 37, 5003), (1, 64, 3), (8, 64, 1000), (4, 1024, 32000),
             (3, 1, 5003)]
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

# K4 (B, H, H_kv, S, D, window): the serve path's shared attention block
# (zamba2-1.2b: 32 heads x 64, prompt 2000, causal; first: it feeds the
# kernels line); gemma3's local-layer width with equal heads (D 256, window
# 1024); D = 80 (zero-padded in the kernel's 128 bucket) and D = 128 with
# a window; two ragged cases of tests/test_kernels.py; then the
# grouped-query shapes of path 12: D = 256 with no window over 4096 keys
# (each tile's P.V goes straight into the running O there), qwen3-8b's
# layers (32 query over 8 key heads, D 128), gemma3-4b's local and global
# layers (8 over 4, D 256, window 1024 or none) at path 12's batch and
# prompt, and a ragged grouped shape (3 query heads a key head, D 80).
# Against the plain version, the JAX package's tolerances
# (tests/test_kernels.py): rtol 1e-4 / atol 1e-5 in float32, 3e-2 in
# bfloat16.
K4_SHAPES = [(4, 32, 32, 2000, 64, None), (1, 8, 8, 4096, 256, 1024),
             (1, 4, 4, 300, 80, None), (2, 8, 8, 1000, 128, 256),
             (1, 2, 2, 100, 8, 24), (2, 4, 4, 128, 32, 32),
             (1, 8, 8, 4096, 256, None), (4, 32, 8, 2000, 128, None),
             (4, 8, 4, 2000, 256, 1024), (4, 8, 4, 2000, 256, None),
             (1, 6, 2, 300, 80, None)]
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
# and paths 2, 3 and 9d, 2 rounds each (cut from 3 to keep the script inside
# its time limit).
MAIN_ROUNDS = 2
# Path 3 is compared with the CPU after round 1 and after rounds 1-2 (the
# main run itself): round 2 is the first with stale uploads (the weighted
# consensus).
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
# path 7a: the fusion's first steps from the card's uploads, card against
# CPU within ROUND1_PARAM_ATOL, before Adam amplifies float32 rounding
# (chip_probe_ablations.py)
FUSION_PREFIX_STEPS = 50
# Path 3 after rounds 1-2.  Its second fusion distils on a trajectory where
# a coordinate's gradient is near zero: Adam divides it by sqrt(v), so one
# distill step with the kernels already moves that coordinate ~0.2 lr away
# from the CPU's step, although kernel and plain gradients agree to ~1e-7;
# after 500 steps the globals sit ~5e-3 apart on an H100, with the same
# accuracy (chip_probe_path3.py isolates this; PERF.md).  A second round is
# held to ten Adam steps' worth of movement (10 x lr) and the same accuracy
# bound.
ROUND2_PARAM_ATOL = 1e-2
# Paths 5a / 5b: examples/heterogeneous_fusion.py's spec (Algorithm 3) at its
# published widths, on the shared logit bank (K1) for HETERO_ROUNDS rounds
# (cut from 6 to 3, then to 2) and on the fly (K2) for 1; path 6: the
# baselines on the quickstart spec.  Every one is held card against CPU at
# paths 1-2's bounds, every group checked.
HETERO_ROUNDS = 2
# Path 6's fedavgm server rule on its own: the CPU's rule on the card run's
# uploads and momentum buffer of each round, against the card's new globals
# and buffer.  The rule is a weighted mean over the clients and two
# elementwise updates of O(0.1 - 1) weights, so the two differ only by the
# mean's float32 summation order, a few units in the last place.
SERVER_RULE_ATOL = 1e-6
# Path 7: the paper's remaining ablations, 1 round each on the card against
# the same round on the CPU at paths 1-2's bounds, every discrete fact equal
# (distill steps, drops, bank decision, teacher forwards): 7a drop-worst at
# Table 3's instability settings, 7b 1-bit clients at Table 4's published
# spec, 7c DP uploads (section 3), 7d / 7e SWAG teachers (Table 7) on the
# bank (K1 over 8 + 5 teachers) and on the fly (K2 at K = 13).  The DP and
# SWAG draws come from CPU generators, so the card and the CPU draw alike.
ABLATION_ROUNDS = 1
SWAG_SAMPLES, SWAG_SCALE = 5, 0.5
# Path 8: 8a buffered heterogeneous fusion (path 5's spec on path 3's
# driver), 2 rounds (cut from 3), held against the CPU after round 1 and
# after rounds 1-2 (the main run itself) at ROUND1_PARAM_ATOL; 8b
# step-count bucketing on the quickstart (1 round: the uploads, bucketed
# against unbucketed on the card, are the same per-client arithmetic over
# fewer clients, held to 1e-5) and one distill batch per prototype on path
# 5a's spec (1 round); 8c the token path (examples/train_e2e.py), 1 round,
# only the rounds cut (6 -> 2 -> 1).
BUFFERED_HETERO_ROUNDS = 2
BUCKET_UPLOAD_ATOL = 1e-5
DISTILL_BATCHES = (32, 64, 48)
TOKENS_ROUNDS = 1
# Path 9: fault injection, robust fusion and checkpoint/resume on the
# quickstart spec at its published widths, only the rounds cut.  The fault
# mix is docs/robustness.md's and benchmarks/robustness_bench.py's CHAOS
# (20% sign-flipping byzantine clients at scale 10, 5% NaN / +-Inf
# uploads) plus the payload's transport kinds (5% crashed, 1% bit-flipped
# uploads), 2 retries and a 0.6 quorum.  9a: the defended FedDF on the
# bank, 2 rounds; 9b: undefended (no screen, no teacher filter) at a NaN
# rate of 0.25, so that a non-finite upload reaches the bank in round 1,
# 1 round; 9c: trimmed_mean and coordinate_median, screen off, 1 round
# each, held card against CPU at 1e-5 (no distillation: only local SGD's
# float32 order); 9d: path 3's buffered driver under the mix, 2 rounds,
# compared over rounds 1-2 at path 3's bound; 9e: path 1's spec stopped by
# an observer at round 3, resumed from the round-2 snapshot, against an
# uninterrupted run at 1e-6.
CHAOS = dict(byzantine_frac=0.2, byzantine_scale=10.0,
             byzantine_mode="sign_flip", nan_rate=0.05, crash_rate=0.05,
             bitflip_rate=0.01, retries=2, quorum=0.6)
DEFENDED_ROUNDS = 2
UNDEFENDED_NAN_RATE = 0.25
ROBUST_PARAM_ATOL = 1e-5
RESUME_ROUNDS = 3
RESUME_PARAM_ATOL = 1e-6
# Kernels on non-finite teacher rows: B = 7 rows of which row 1 holds a
# NaN, row 3 a +Inf and row 5 a -Inf teacher logit (in K2 / K3, in teacher
# r % K), at one V per launch mode: lane groups (3), a block per row (300)
# and a cluster per row (5003), for K1 (every bank dtype) and K2 / K3 (3
# teachers, f32 and bf16).  The kernel's per-row loss and gradient must be
# non-finite exactly where the plain version's are, within the kernel
# tolerances elsewhere, and two launches equal bit for bit.
NONFINITE_ROWS = {1: float("nan"), 3: float("inf"), 5: float("-inf")}
NONFINITE_B, NONFINITE_K = 7, 3
NONFINITE_V = {"lanes": 3, "block": 300, "cluster": 5003}

# Path 10: the runtime around the round engine on the quickstart spec at its
# published widths, only the rounds cut.  10a the pipelined driver at
# staleness 0, 2 rounds, against a sync run bit for bit (a miss is a
# cross-stream race); 10b staleness 1 on the bank (K1) and staleness 2 on
# the generator source (K2), 3 rounds each (cut from 4 to hold path 10
# near its time), held against the CPU over rounds 1-2 at path 3's bounds
# (1e-3 after round 1, 1e-2 after round 2: Adam amplifies float32
# rounding from round to round, to 1.5e-2 - 5e-2 after round 4 with equal
# accuracy and steps), and (i)'s round 2 under the profiler; 10c the
# distributed driver over loopback pods, fp32 uploads, bit for bit against
# 10a's sync run; 10d the same over tcp with 2 subprocess pods on the card;
# 10e loopback with int8 uploads and docs/distributed.md's chaos mix (5%
# corrupted frames, quorum 0.5, pod 1 killed in round 1), 2 rounds, its
# wire decisions and steps equal card vs CPU over rounds 1-2 (the
# corruption draws are keyed by (wave, pod, attempt)), its globals at path
# 3's bounds; 10f 10c's run interrupted after round 2's uploads and resumed
# from its wire log, bit for bit; 10g 10a's run with the flight recorder
# armed, bit for bit.  10a, 10c-10g run 2 rounds (10a, 10e, 10g cut from
# 3, 10c from 3).
PIPE_ROUNDS = 2
STALE_ROUNDS = 3
DIST_ROUNDS = 2
CPU_ROUNDS = 2
# 10e: heartbeats every 1 s, so the killed pod's clients re-route once it
# has been silent for 3 s, and the upload deadline of the spec's default
# (30 s), far above a pod's two requests in a row on a loaded CPU (each
# 2.5-5 s), so that no deadline fires and the retries do not depend on
# time.
CHAOS_WIRE = dict(transport_corrupt=0.05, quorum=0.5)
CHAOS_HEARTBEAT_S, CHAOS_DEADLINE_S = 1.0, 30.0
# Path 11a: the train CLI (``python -m repro_torch.launch.train``) in
# subprocesses on the card, each with its own time limit, on the
# quickstart's flags for CLI_ROUNDS rounds; its replay from the dumped
# spec and its resume from the round-1 snapshot run side by side.
CLI_ROUNDS, CLI_TIMEOUT_S = 2, 300
CLI_FLAGS = ("--strategy", "feddf", "--clients", "20", "-C", "0.4",
             "--alpha", "0.1", "--local-epochs", "20", "--n-samples",
             "6000", "--distill-steps", "500", "--seed", "0")
# Path 12: the grouped-query decoders served at full width and depth
# (random fp32 weights drawn on the card from seed 0) at path 4's batch,
# prompt and generated tokens, K4 launches per prefill (qwen3-8b: 36
# global layers; gemma3-4b: 29 local + 5 global); forward against prefill
# + 2 forced decode steps at full depth at batch 1 (gemma3's [B, S, V]
# logits at V = 262144), and GQA_CPU_LAYERS layers at full width card
# against CPU on a GQA_CPU_PROMPT-token prompt and GQA_CPU_STEPS forced
# steps, both within 1e-3 of the largest logit.
GQA_SERVE = (("qwen3-8b", 36), ("gemma3-4b", 34))
GQA_CHECK_BATCH, GQA_CPU_LAYERS, GQA_CPU_PROMPT, GQA_CPU_STEPS = 1, 2, 256, 2
GQA_REL_ATOL = 1e-3

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
    """Kernel vs plain version at every shape / dtype / T, two launches of
    each kernel against each other (equal bits); timings at T=1."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ensemble_kl_bank import (bank_kl_bwd,
                                                      bank_kl_fwd, card_plan,
                                                      ensemble_kl_bank)
    rows, errors = [], []
    for (b, n, v) in SHAPES:
        mode = card_plan(device, b, v).mode
        for dtype_name in BANK_DTYPES:
            s, bank, scales, idx = make_case(b, n, v, dtype_name, seed=b + v,
                                             device=device)
            row_scale = (torch.ones(b, device=device) if scales is None
                         else scales[idx])
            for temp in TEMPERATURES:
                s_k = s.clone().requires_grad_(True)
                s_p = s.clone().requires_grad_(True)
                loss_k = ensemble_kl_bank(s_k, bank, scales, idx, temp)
                loss_p = ref.ensemble_kl_bank(s_p, bank, row_scale, idx, temp)
                (g_k,) = torch.autograd.grad(loss_k, s_k)
                (g_p,) = torch.autograd.grad(loss_p, s_p)
                # two launches of each kernel on the same inputs: equal bits
                g1 = torch.ones((), device=device)
                f1 = bank_kl_fwd(s, bank, scales, idx, temp)
                f2 = bank_kl_fwd(s, bank, scales, idx, temp)
                d1 = bank_kl_bwd(s, bank, scales, idx, f1[1], f1[2], g1, temp)
                d2 = bank_kl_bwd(s, bank, scales, idx, f1[1], f1[2], g1, temp)
                torch.cuda.synchronize()
                repeat = (all(torch.equal(x, y) for x, y in zip(f1, f2))
                          and torch.equal(d1, d2))
                fwd_err = abs(float(loss_k.detach()) - float(loss_p.detach()))
                bwd_err = float((g_k - g_p).abs().max())
                fwd_tol = FWD_ATOL + FWD_RTOL * abs(float(loss_p.detach()))
                ok = (fwd_err <= fwd_tol and bwd_err <= BWD_ATOL and repeat
                      and bool(torch.isfinite(g_k).all()))
                rec = {"B": b, "N": n, "V": v, "bank": dtype_name, "T": temp,
                       "mode": mode, "loss": float(loss_p.detach()),
                       "fwd_err": fwd_err, "fwd_tol": fwd_tol,
                       "bwd_err": bwd_err, "bwd_tol": BWD_ATOL,
                       "repeat_equal": repeat, "ok": ok}
                errors.append(rec)
                if temp != 1.0:
                    continue
                # timings, T = 1: device time (CUDA graph replay) and the
                # eager per-call time; the plain backward is autograd of the
                # plain forward, timed as (forward + grad) - forward
                kl, lse_t, lse_s = f1
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

                def measure(fn):
                    """(device ms, per-call ms); the widest shape's
                    launches take ~0.3 ms, so fewer repeats there."""
                    if b * v < 10 ** 7:
                        return device_ms(fn), call_ms(fn)
                    t = timed(fn)
                    return t["ms"], t["call_ms"]
                (ms_f, call_f), (ms_b, call_b) = measure(fwd), measure(bwd)
                plain_f, plain_call_f = measure(plain_fwd)
                both, both_call = measure(plain_both)
                plain_b = both - plain_f
                plain_call_b = both_call - plain_call_f
                byt_f = kernel_bytes(b, v, bank, scales, idx, False)
                byt_b = kernel_bytes(b, v, bank, scales, idx, True)
                # ~14 float ops per element forward (two scalings, max and
                # rescale, three exp-weighted sums), ~6 backward
                ops_f, ops_b = 14 * b * v, 6 * b * v
                rows.append({
                    "B": b, "N": n, "V": v, "bank": dtype_name, "mode": mode,
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


def k1_mode_phase(device):
    """K1's forward in every mode at the shapes where the plan switches:
    each against the plain version, and its device time (float32 bank,
    T = 1).  Returns one row per shape, ``{mode name: us}``, the plan's own
    mode named."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ensemble_kl import plan_in_mode
    from repro_torch.kernels.ensemble_kl_bank import bank_kl_fwd, card_plan
    rows = []
    for b, v in K1_MODE_SHAPES:
        s, bank, scales, idx = make_case(b, K1_MODE_N, v, "float32",
                                         seed=b + v, device=device)
        ones = torch.ones(b, device=device)
        want = float(ref.ensemble_kl_bank(s, bank, ones, idx))
        own = card_plan(device, b, v)
        row = {"B": b, "N": K1_MODE_N, "V": v, "us": {}, "ok": True}
        for mode, c in K1_FWD_MODES:
            p = plan_in_mode(1, b, v, mode, c)
            name = (f"lanes G={p.lanes}" if mode == "lanes" else
                    f"cluster C={c}" if mode == "cluster" else "block")
            if (p.mode, p.cluster) == (own.mode, own.cluster):
                row["plan"] = name
            got = float(bank_kl_fwd(s, bank, scales, idx, launch=p)[0].sum()
                        / b)
            row["ok"] &= abs(got - want) <= FWD_ATOL + FWD_RTOL * abs(want)
            row["us"][name] = device_ms(
                lambda p=p: bank_kl_fwd(s, bank, scales, idx, launch=p)) * 1e3
        rows.append(row)
    return rows


def k1_bwd_grid_phase(device):
    """K1's backward on the capped grid (``bwd_grid``) and on the plan's
    full grid, each against the plain gradient; device us (float32 bank,
    T = 1)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ensemble_kl import card_sms
    from repro_torch.kernels.ensemble_kl_bank import (bank_kl_bwd,
                                                      bank_kl_fwd, bwd_grid,
                                                      card_plan)
    rows = []
    for b, v in K1_BWD_GRID_SHAPES:
        s, bank, scales, idx = make_case(b, K1_MODE_N, v, "float32",
                                         seed=b + v, device=device)
        s_p = s.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(ref.ensemble_kl_bank(
            s_p, bank, torch.ones(b, device=device), idx), s_p)
        _, lse_t, lse_s = bank_kl_fwd(s, bank, scales, idx)
        g1 = torch.ones((), device=device)
        p = card_plan(device, b, v)
        row = {"B": b, "N": K1_MODE_N, "V": v, "us": {}, "ok": True}
        for name, blocks in (("capped", bwd_grid(p, card_sms(device))),
                             ("full", p.bwd_grid)):
            got = bank_kl_bwd(s, bank, scales, idx, lse_t, lse_s, g1,
                              blocks=blocks)
            row["ok"] &= float((got - want).abs().max()) <= BWD_ATOL
            row["us"][f"{name} {blocks} blocks"] = device_ms(
                lambda: bank_kl_bwd(s, bank, scales, idx, lse_t, lse_s, g1,
                                    blocks=blocks), reps=10, iters=5) * 1e3
        rows.append(row)
    return rows


def k1_poison_phase(device):
    """An index outside the bank, in each forward mode and bank dtype: rows
    2 (index N) and 5 (index -1) of 7 come out NaN in kl, lse_t, lse_s and
    all of ds, every other row with the bits of a run on valid indices, and
    the launches return."""
    import torch
    from repro_torch.kernels.ensemble_kl_bank import (bank_kl_bwd,
                                                      bank_kl_fwd, card_plan)
    out = []
    b, n, temp = 7, 50, 2.5
    for mode, v in K1_POISON_SHAPES.items():
        for dtype_name in BANK_DTYPES:
            s, bank, scales, idx = make_case(b, n, v, dtype_name, seed=v,
                                             device=device)
            bad = idx.clone()
            bad[2], bad[5] = n, -1
            g1 = torch.ones((), device=device)
            good = bank_kl_fwd(s, bank, scales, idx, temp)
            got = bank_kl_fwd(s, bank, scales, bad, temp)
            ds_good = bank_kl_bwd(s, bank, scales, idx, good[1], good[2], g1,
                                  temp)
            ds = bank_kl_bwd(s, bank, scales, bad, got[1], got[2], g1, temp)
            torch.cuda.synchronize()
            hit = torch.zeros(b, dtype=torch.bool, device=device)
            hit[[2, 5]] = True
            ok = (card_plan(device, b, v).mode == mode
                  and all(torch.equal(torch.isnan(x), hit)
                          and torch.equal(x[~hit], y[~hit])
                          for x, y in zip(got, good))
                  and bool(torch.isnan(ds[hit]).all())
                  and torch.equal(ds[~hit], ds_good[~hit]))
            out.append({"mode": mode, "B": b, "N": n, "V": v,
                        "bank": dtype_name, "ok": ok})
    return out


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


def k4_bound(b, h, s, d, window, elem, h_kv=None) -> dict:
    """The tensor-core bound: q, k, v read and o written once (k and v at
    their ``h_kv`` heads); 4 D flops (q.k and p.v) and one exponential for
    every (query, key) pair the mask lets through.  float32 runs three TF32
    passes on the tensor cores, bfloat16 one bf16 pass.  The bound is the
    largest of the three times, ``bound_detail`` names it."""
    h_kv = h if h_kv is None else h_kv
    w = s if window is None else window
    pairs = b * h * sum(min(i + 1, w) for i in range(s))
    byt, ops = 2 * b * (h + h_kv) * s * d * elem, 4 * d * pairs
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
    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_attn import swa_attn
    rows, errors = [], []
    for (b, h, h_kv, s, d, w) in K4_SHAPES:
        gen = torch.Generator().manual_seed(b + h + s + d)
        qkv32 = [torch.randn(b, n, s, d, generator=gen).to(device)
                 for n in (h, h_kv, h_kv)]
        for dtype_name, (rtol, atol) in K4_TOL.items():
            q, k, v = (t.to(getattr(torch, dtype_name)) for t in qkv32)
            got = swa_attn(q, k, v, w)
            want = ref.swa_attn(q, k, v, w)
            torch.cuda.synchronize()
            err, over = excess(got, want, rtol, atol)
            ok = over <= 0 and got.dtype == q.dtype and bool(
                torch.isfinite(got.float()).all())
            errors.append({"B": b, "H": h, "H_kv": h_kv, "S": s, "D": d,
                           "window": w, "dtype": dtype_name,
                           "max_abs_err": err, "excess": over,
                           "rtol": rtol, "atol": atol, "ok": ok})
            del got, want
            if s < 1000 and dtype_name != "float32":
                continue
            with torch.no_grad():
                t_k = timed(lambda: swa_attn(q, k, v, w))
                t_p = timed(lambda: ref.swa_attn(q, k, v, w))
                t_l = timed(k4_library(q, k, v, w))
            rows.append({"B": b, "H": h, "H_kv": h_kv, "S": s, "D": d,
                         "window": w, "dtype": dtype_name, **t_k,
                         "plain_ms": t_p["ms"], "plain_call_ms":
                         t_p["call_ms"], "library_ms": t_l["ms"],
                         "library_call_ms": t_l["call_ms"],
                         **k4_bound(b, h, s, d, w, q.element_size(), h_kv)})
        del qkv32, q, k, v
        torch.cuda.empty_cache()
    return rows, errors


def k4_library(q, k, v, w):
    """One ``scaled_dot_product_attention`` call computing K4's function
    (timed only, never used by the port): causal or windowed through a
    mask, grouped heads by ``enable_gqa`` or, on a torch without it, by
    key / value heads repeated beforehand (outside the timed call)."""
    import torch
    import torch.nn.functional as F
    s = q.shape[2]
    kw = {"is_causal": True}
    if w is not None:
        i = torch.arange(s, device=q.device)
        kw = {"attn_mask": (i[None, :] <= i[:, None])
              & (i[:, None] - i[None, :] < w)}
    if k.shape[1] != q.shape[1]:
        try:
            F.scaled_dot_product_attention(q[:, :, :1], k[:, :, :1],
                                           v[:, :, :1], enable_gqa=True)
            kw["enable_gqa"] = True
        except TypeError:
            rep = q.shape[1] // k.shape[1]
            k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


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
    """Largest absolute difference between two runs' globals, over every
    prototype group's tree (``a`` and ``b`` are lists of trees)."""
    from repro_torch.common.pytree import tree_flatten
    out = 0.0
    for ga, gb in zip(a, b, strict=True):
        fa, fb = tree_flatten(ga), tree_flatten(gb)
        out = max([out] + [float((fa[k].cpu() - fb[k].cpu()).abs().max())
                           for k in fa])
    return out


def group_diffs(a, b) -> list:
    """:func:`max_abs_diff` of two runs, one entry per prototype group."""
    return [max_abs_diff([x], [y])
            for x, y in zip(a.global_params, b.global_params, strict=True)]


def group_logs(res):
    """Every prototype group's round logs, in group order."""
    return [r.logs for r in res.results]


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


LOG_KEYS = ("test_acc", "val_acc", "ensemble_acc", "pre_distill_acc",
            "distill_steps", "bank", "bank_dtype", "bank_nbytes",
            "teacher_forwards", "n_participants", "n_dropped",
            "staleness_hist",
            "buffer_fill", "n_straggling", "eff_participants",
            "n_corrupted", "n_quarantined", "n_retries",
            "n_teachers_filtered", "fused", "rolled_back")


def round_rows(logs, phase_seconds) -> list:
    """Per round: its phase seconds and every group's log fields."""
    return [{"round": t + 1, "phase_s": ph,
             "groups": [{k: getattr(g[t], k) for k in LOG_KEYS}
                        for g in logs]}
            for t, ph in enumerate(phase_seconds)]


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
    logs = group_logs(res)
    rounds = round_rows(logs, res.phase_seconds)
    problems = []
    for g, (glogs, params) in enumerate(zip(logs, res.global_params)):
        if len(glogs) != spec.rounds:
            problems.append(f"group {g} ran {len(glogs)} rounds, expected "
                            f"{spec.rounds}")
        if not bool(tree_isfinite(params)):
            problems.append(f"group {g}: non-finite globals")
    steps = [sum(l.distill_steps for l in glogs) for glogs in logs]
    return res, {"wall_s": wall, "rounds": rounds, "launches": launches,
                 "distill_steps": sum(steps),
                 "distill_steps_per_group": steps}, problems


def card_vs_cpu(spec, rounds: int, profile_ref=None,
                param_tol: Optional[float] = ROUND1_PARAM_ATOL, gpu=None):
    """The first ``rounds`` rounds on the card and on the CPU (plain
    versions) from the same seed, every prototype group compared; with
    ``profile_ref`` (the first run's RunResult) the card's rerun is
    profiled and must repeat it.  ``gpu``: a card run of exactly these
    rounds to compare instead of a rerun.  ``param_tol=None`` reports the
    globals' distance without holding it to a bound."""
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
    elif gpu is None:
        gpu = Experiment(short, device="cuda").run()
    cpu = Experiment(short, device="cpu").run()
    problems = []
    if profile_ref is not None and group_logs(gpu) != [
            g[:rounds] for g in group_logs(profile_ref)]:
        problems.append("the first rounds differ between two runs on the "
                        "card")
    d_param = max_abs_diff(gpu.global_params, cpu.global_params)
    acc = [[[l.test_acc for l in g] for g in group_logs(r)]
           for r in (gpu, cpu)]
    d_acc = max(abs(a - b) for ga, gb in zip(*acc, strict=True)
                for a, b in zip(ga, gb, strict=True))
    steps = [[[l.distill_steps for l in g] for g in group_logs(r)]
             for r in (gpu, cpu)]
    # the other discrete facts of every round: drops, bank decision,
    # teacher forwards and the fault decisions (corrupted, quarantined,
    # retried, filtered, fused, rolled back)
    facts = [[[(l.n_dropped, l.bank, l.teacher_forwards, l.n_corrupted,
                l.n_quarantined, l.n_retries, l.n_teachers_filtered,
                l.fused, l.rolled_back) for l in g]
              for g in group_logs(r)] for r in (gpu, cpu)]
    one = len(gpu.results) == 1     # paths 1-4 keep their flat lists
    check = {"rounds": rounds, "max_abs_param_diff": d_param,
             "param_tol": param_tol,
             "test_acc_cuda": acc[0][0] if one else acc[0],
             "test_acc_cpu": acc[1][0] if one else acc[1],
             "test_acc_diff": d_acc, "acc_tol": ROUND1_ACC_ATOL,
             "distill_steps_cuda": steps[0][0] if one else steps[0],
             "distill_steps_cpu": steps[1][0] if one else steps[1],
             "facts_equal": facts[0] == facts[1]}
    if not one:
        check["max_abs_param_diff_per_group"] = group_diffs(gpu, cpu)
    if ((param_tol is not None and d_param > param_tol)
            or d_acc > ROUND1_ACC_ATOL or steps[0] != steps[1]
            or facts[0] != facts[1]):
        problems.append(f"card vs CPU: {check}; (drops, bank, teacher "
                        f"forwards, corrupted, quarantined, retries, "
                        f"filtered, fused, rolled back) card {facts[0]} "
                        f"CPU {facts[1]}")
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
                                 param_tol=ROUND2_PARAM_ATOL, gpu=res)
    report.update(cpu_check=check, cpu_check_round1=check1)
    return report, problems + more1 + more


def hetero_spec(rounds: int, bank: str = "auto", strategy: str = "feddf"):
    """examples/heterogeneous_fusion.py's spec at its published widths:
    blobs, 9 clients round-robin over three mlp prototypes, Dirichlet
    alpha 1.0, C = 0.67 (6 active), E = 20, FedDF max 400 steps, patience
    200, distill batch 64, an unlabeled pool of 4000, seed 1."""
    from repro_torch.api import (CohortSpec, ExperimentSpec, FusionSpec,
                                 ModelSpec, PartitionSpec, SourceSpec,
                                 StrategySpec, TaskSpec)
    return ExperimentSpec(
        task=TaskSpec(name="blobs", n_samples=6000),
        partition=PartitionSpec(n_clients=9, alpha=1.0),
        cohort=CohortSpec(prototypes=[
            ModelSpec("mlp", {"hidden": [32, 32], "name": "proto-small"}),
            ModelSpec("mlp", {"hidden": [64, 64], "name": "proto-medium"}),
            ModelSpec("mlp", {"hidden": [48, 48, 48],
                              "name": "proto-deep"})]),
        strategy=StrategySpec(name=strategy,
                              fusion=FusionSpec(max_steps=400, patience=200,
                                                eval_every=50, batch_size=64,
                                                logit_bank=bank)),
        source=(SourceSpec(name="unlabeled", params={"n": 4000})
                if strategy == "feddf" else None),
        rounds=rounds, client_fraction=0.67, local_epochs=20,
        local_batch_size=32, local_lr=0.05, seed=1)


def check_launches(launches, want: dict, what: str) -> list:
    """Every kernel launched exactly ``want[name]`` times (0 where absent);
    a wanted count of 0 (a path that distilled nothing) fails too."""
    problems = [f"{what}: no distill step for {name}"
                for name, n in want.items() if n == 0]
    for name, n in launches.items():
        if n != want.get(name, 0):
            problems.append(f"{what}: {name} launched {n} times, expected "
                            f"{want.get(name, 0)}")
    return problems


def fused_logs(res):
    """The logs of every (group, round) whose group drew a client."""
    return [l for g in group_logs(res) for l in g if l.n_participants]


def hetero_bank_path():
    """Path 5a: heterogeneous FedDF on the shared logit bank (K1)."""
    spec = hetero_spec(HETERO_ROUNDS)
    res, report, problems = run_path(spec)
    steps = report["distill_steps"]
    problems += check_launches(
        report["launches"], {"ensemble_kl_bank_fwd": steps,
                             "ensemble_kl_bank_bwd": steps}, "path 5a")
    logs = fused_logs(res)
    if not logs or any(l.bank != "bank" for l in logs):
        problems.append(f"bank decisions {[l.bank for l in logs]}")
    if any(l.ensemble_acc is None for g in group_logs(res) for l in g):
        problems.append("a round without ensemble_acc")
    check, busy, more = card_vs_cpu(spec, 1, profile_ref=res)
    report.update(cpu_check=check, round1_device=busy)
    return report, problems + more


def hetero_fly_path():
    """Path 5b: the same spec on the fly (K2 over the three nets'
    concatenated teachers), 1 round; then FedAvg within each group, the
    Fig. 4 baseline, which launches no kernel, 1 round."""
    spec = hetero_spec(1, bank="off")
    res, report, problems = run_path(spec)
    steps = report["distill_steps"]
    problems += check_launches(
        report["launches"], {"ensemble_kl_fwd": steps,
                             "ensemble_kl_bwd": steps}, "path 5b")
    if any(l.bank != "on_the_fly" for l in fused_logs(res)):
        problems.append(f"bank decisions "
                        f"{[l.bank for l in fused_logs(res)]}")
    check, _, more = card_vs_cpu(spec, 1, gpu=res)
    report.update(cpu_check=check)
    fed = hetero_spec(1, strategy="fedavg")
    fres, frep, fprob = run_path(fed)
    fprob += check_launches(frep["launches"], {}, "path 5b fedavg")
    fcheck, _, fmore = card_vs_cpu(fed, 1, gpu=fres)
    frep.update(cpu_check=fcheck)
    report["fedavg"] = frep
    return report, problems + more + [f"fedavg: {p}" for p in fprob + fmore]


def baseline_specs():
    """Path 6: the baselines on the quickstart spec: fedavgm for 2 rounds
    (round 1 equals FedAvg), fedprox for 1, FedDF with local Adam for 1."""
    from repro_torch.api import StrategySpec
    q = quickstart_spec
    return {
        "fedavgm": dataclasses.replace(
            q(2), strategy=StrategySpec(name="fedavgm"), source=None),
        "fedprox": dataclasses.replace(
            q(1), strategy=StrategySpec(name="fedprox"), source=None),
        "local_adam": dataclasses.replace(q(1), local_optimizer="adam"),
    }


@contextlib.contextmanager
def recording_aggregate(cls, calls: list):
    """While open, every ``cls.aggregate`` call appends ``(strategy,
    groups, state, ctx, result)`` to ``calls``."""
    orig = cls.aggregate

    def recording(self, groups, state, ctx):
        out = orig(self, groups, state, ctx)
        calls.append((self, groups, state, ctx, out))
        return out
    cls.aggregate = recording
    try:
        yield calls
    finally:
        cls.aggregate = orig


def server_rule_check(calls) -> tuple:
    """Each recorded card aggregation rerun on the CPU from the same
    uploads and state: the largest difference of the new globals and of
    the new state (the momentum buffer) per round, held to
    SERVER_RULE_ATOL."""
    from repro_torch.common.pytree import tree_to
    cpu = lambda t: None if t is None else tree_to(t, "cpu")
    rounds, problems = [], []
    for t, (strat, groups, state, ctx, (new, bufs, _)) in enumerate(calls):
        cpu_groups = [dataclasses.replace(g, prev_global=cpu(g.prev_global),
                                          stack=cpu(g.stack))
                      for g in groups]
        want, want_bufs, _ = strat.aggregate(cpu_groups,
                                             [cpu(b) for b in state], ctx)
        d = {"round": t + 1, "globals": max_abs_diff(want, new),
             "buffer": max_abs_diff([b for b in want_bufs if b is not None],
                                    [b for b in bufs if b is not None])}
        rounds.append(d)
        if max(d["globals"], d["buffer"]) > SERVER_RULE_ATOL:
            problems.append(f"server rule, card vs CPU on the same uploads: "
                            f"{d} (atol {SERVER_RULE_ATOL})")
    return {"rounds": rounds, "atol": SERVER_RULE_ATOL}, problems


def baselines_path():
    """Path 6: each baseline on the card against the CPU; fedavgm's
    server rule also on its own."""
    from repro_torch.core.strategies import FedAvgM
    report, problems = {}, []
    for name, spec in baseline_specs().items():
        calls = []
        with (recording_aggregate(FedAvgM, calls) if name == "fedavgm"
              else contextlib.nullcontext()):
            res, rep, probs = run_path(spec)
        if name == "fedavgm":
            rep["server_rule"], more = server_rule_check(calls)
            if len(calls) != spec.rounds:
                more.append(f"{len(calls)} fedavgm aggregations recorded "
                            f"for {spec.rounds} rounds")
            probs += more
        steps = rep["distill_steps"]
        want = ({"ensemble_kl_bank_fwd": steps,
                 "ensemble_kl_bank_bwd": steps}
                if name == "local_adam" else {})
        probs += check_launches(rep["launches"], want, "launches")
        if name == "local_adam" and any(l.bank != "bank" for l in
                                        fused_logs(res)):
            probs.append("local Adam FedDF did not use the bank")
        check, _, more = card_vs_cpu(spec, spec.rounds, gpu=res)
        rep.update(cpu_check=check)
        report[name] = rep
        problems += [f"{name}: {p}" for p in probs + more]
    return report, problems


def ablation_specs() -> dict:
    """Path 7's specs, 1 round each.  7a: the quickstart at Table 3's
    instability settings (benchmarks/table3_dropworst.py: a norm-free mlp
    [64, 64, 64, 64], alpha 0.3, local lr 0.2) with drop-worst; 7b:
    examples/lowbit_fl.py's spec as published (blobs 5000, 10 clients,
    alpha 1.0, mlp [64, 64], C 0.4, E 20, lr 0.1, an unlabeled pool of
    3000, FedDF max 400, patience 200, seed 2) with binarized clients; 7c:
    the quickstart with DP uploads at the JAX package's test values (clip
    5.0, noise multiplier 0.01); 7d: the quickstart with Table 7's SWAG
    row (5 samples at scale 0.5, benchmarks/table7_distill_optimizer.py)
    on the bank; 7e: the same with the generator source, on the fly."""
    from repro_torch.api import (CohortSpec, ExperimentSpec, FusionSpec,
                                 ModelSpec, PartitionSpec, PrivacySpec,
                                 SourceSpec, StrategySpec, TaskSpec)
    q = quickstart_spec(ABLATION_ROUNDS)
    swag = dataclasses.replace(q.strategy, fusion=dataclasses.replace(
        q.strategy.fusion, swag_samples=SWAG_SAMPLES,
        swag_scale=SWAG_SCALE))
    return {
        "7a_dropworst": dataclasses.replace(
            q, cohort=CohortSpec(prototypes=[ModelSpec(
                "mlp", {"hidden": [64, 64, 64, 64], "norm": "none"})]),
            partition=dataclasses.replace(q.partition, alpha=0.3),
            local_lr=0.2,
            strategy=dataclasses.replace(q.strategy, drop_worst=True)),
        "7b_lowbit": ExperimentSpec(
            task=TaskSpec(name="blobs", n_samples=5000),
            partition=PartitionSpec(n_clients=10, alpha=1.0),
            cohort=CohortSpec(prototypes=[ModelSpec("mlp",
                                                    {"hidden": [64, 64]})]),
            strategy=StrategySpec(name="feddf", fusion=FusionSpec(
                max_steps=400, patience=200, eval_every=50, batch_size=64)),
            source=SourceSpec(name="unlabeled", params={"n": 3000}),
            privacy=PrivacySpec(quantizer="binarize"),
            rounds=ABLATION_ROUNDS, client_fraction=0.4, local_epochs=20,
            local_batch_size=32, local_lr=0.1, seed=2),
        "7c_dp": dataclasses.replace(
            q, privacy=PrivacySpec(clip=5.0, noise_multiplier=0.01)),
        "7d_swag_bank": dataclasses.replace(q, strategy=swag),
        "7e_swag_fly": dataclasses.replace(
            q, strategy=swag, source=SourceSpec(name="generator")),
    }


@contextlib.contextmanager
def recording_engine_aggregate(calls: list):
    """While open, every ``RoundEngine.aggregate`` call appends ``(t,
    the groups as they came in, with their stacks copied, state, result,
    the kept uploads' data weights per group)`` to ``calls`` (drop-worst
    replaces a group's stack and weights)."""
    import torch
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.engine import RoundEngine
    orig = RoundEngine.aggregate

    def recording(self, t, groups, state):
        before = [dataclasses.replace(
            g, stack=None if g.stack is None else tree_map(torch.clone,
                                                           g.stack))
            for g in groups]
        out = orig(self, t, groups, state)
        calls.append((t, before, state, out,
                      [[float(w) for w in g.weights] for g in groups]))
        return out
    RoundEngine.aggregate = recording
    try:
        yield calls
    finally:
        RoundEngine.aggregate = orig


@contextlib.contextmanager
def checking_k1(rows: list):
    """While open, every K1 call (the fused bank loss of a distill step)
    also runs its plain version on the same inputs, and K1's gradient on
    the student logits, caught by a hook in the step's backward, is held
    against the plain version's: one row a call, ``[loss diff, its excess
    over K1's forward tolerance, gradient diff, its excess over K1's
    backward tolerance]`` (an excess <= 0 passes).  The plain version
    launches no kernel, so the launch counts stay the path's own."""
    import torch
    from repro_torch.core import feddf
    from repro_torch.kernels import ref
    orig = feddf.ensemble_kl_loss_bank

    def checking(s_logits, logits, scales, idx, temp):
        loss = orig(s_logits, logits, scales, idx, temp)
        with torch.enable_grad():
            s_p = s_logits.detach().requires_grad_(True)
            scale = (torch.ones(idx.shape, device=idx.device)
                     if scales is None else scales[idx].float())
            want = ref.ensemble_kl_bank(s_p, logits, scale, idx, temp)
            (g_p,) = torch.autograd.grad(want, s_p)
        want = float(want.detach())
        d = abs(float(loss.detach()) - want)
        row = [d, d - FWD_ATOL - FWD_RTOL * abs(want), None, None]
        rows.append(row)

        def hook(g):
            dg = float((g - g_p).abs().max())
            row[2:] = [dg, dg - BWD_ATOL]
        s_logits.register_hook(hook)
        return loss
    feddf.ensemble_kl_loss_bank = checking
    try:
        yield rows
    finally:
        feddf.ensemble_kl_loss_bank = orig


def k1_steps_summary(rows) -> dict:
    return {"calls": len(rows),
            "max_loss_diff": max(r[0] for r in rows),
            "max_grad_diff": max(r[2] for r in rows if r[2] is not None),
            "ok": bool(rows) and all(r[2] is not None and r[1] <= 0
                                     and r[3] <= 0 for r in rows)}


def engine_on(spec, device="cpu"):
    """The round engine ``Experiment(spec, device=device)`` runs."""
    from repro_torch.api import experiment as X
    from repro_torch.core.engine import RoundEngine
    bundle = X.build_task_bundle(spec)
    train, val, test, parts = X.build_splits(spec, bundle)
    nets, proto = X.build_cohort(spec, bundle)
    return RoundEngine(nets, proto, train, parts, val, test,
                       X.to_fl_config(spec),
                       source=X.build_source(spec, bundle, train, device),
                       heterogeneous=len(nets) > 1, device=device)


@contextlib.contextmanager
def recording_fusions(recs: list):
    """While open, every ``feddf_fuse_stacked`` call appends its inputs,
    its fused params and its info to ``recs``."""
    from repro_torch.core import feddf
    fuse = feddf.feddf_fuse_stacked

    def recording(net, stack, weights, source, fusion, val_x=None,
                  val_y=None, seed=0, **kw):
        out = fuse(net, stack, weights, source, fusion, val_x, val_y, seed,
                   **kw)
        recs.append(dict(net=net, stack=stack, weights=weights,
                         fusion=fusion, val_x=val_x, val_y=val_y, seed=seed,
                         kw=kw, params=out[0], info=out[1]))
        return out
    feddf.feddf_fuse_stacked = recording
    try:
        yield recs
    finally:
        feddf.feddf_fuse_stacked = fuse


def rerun_fusion(rec, spec, device, fused="auto", steps=None):
    """A recorded fusion rerun on ``device`` from the same inputs (K1, or
    its plain version with ``fused=False``); ``steps`` (not None) stops it
    there without validation.  Returns ``(the fused params flat on the
    CPU, info)``."""
    from repro_torch.api import build_splits, build_task_bundle
    from repro_torch.api.experiment import build_source
    from repro_torch.common.pytree import tree_flatten, tree_to
    from repro_torch.core import feddf
    bundle = build_task_bundle(spec)
    train = build_splits(spec, bundle)[0]
    fusion = dataclasses.replace(rec["fusion"], use_fused_kernel=fused)
    if steps is not None:
        fusion = dataclasses.replace(fusion, max_steps=steps)
    val = ((rec["val_x"].to(device), rec["val_y"].to(device))
           if steps is None else (None, None))
    kw = dict(rec["kw"])
    if kw.get("student") is not None:
        kw["student"] = tree_to(kw["student"], device)
    p, info = feddf.feddf_fuse_stacked(
        rec["net"], tree_to(rec["stack"], device), rec["weights"],
        build_source(spec, bundle, train, device), fusion, *val,
        rec["seed"], **kw)
    return {k: v.cpu() for k, v in tree_flatten(p).items()}, info


def flat_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def same_uploads_check(spec, calls, fusions) -> tuple:
    """Path 7a's aggregations held on the card run's own uploads.  Each
    recorded aggregation (drop-worst, then FedDF on K1) rerun on the CPU
    (plain versions): equal drops, kept uploads, distill steps and bank
    decisions, the new globals' test accuracy within ROUND1_ACC_ATOL, the
    globals' distance reported.  Each recorded fusion: rerun on the card
    with K1 held against its plain version at every distill step, and its
    first FUSION_PREFIX_STEPS steps on the card against the CPU within
    ROUND1_PARAM_ATOL.  The whole fusion's distance is not bounded: 500
    Adam steps amplify float32 rounding on these uploads until the card's
    plain versions too part from the CPU by ~7e-3
    (chip_probe_ablations.py)."""
    from repro_torch.common.pytree import tree_flatten, tree_to
    from repro_torch.core.client import evaluate
    engine = engine_on(spec)
    cpu = lambda t: None if t is None else tree_to(t, "cpu")
    rounds, fused, problems = [], [], []
    for t, groups, state, (new, _, infos), kept in calls:
        cpu_groups = [dataclasses.replace(g, prev_global=cpu(g.prev_global),
                                          stack=cpu(g.stack))
                      for g in groups]
        want, _, want_infos = engine.aggregate(t, cpu_groups, state)
        acc = [[evaluate(net, cpu(g), engine.test_x, engine.test_y)
                for net, g in zip(engine.nets, glob)] for glob in (new, want)]
        keys = ("n_dropped", "distill_steps", "bank")
        facts = [[[i.get(k) for k in keys] for i in inf]
                 for inf in (infos, want_infos)]
        d = {"round": t, "globals": max_abs_diff(want, new),
             "test_acc_card": acc[0], "test_acc_cpu": acc[1],
             "facts": list(keys), "card": facts[0], "cpu": facts[1],
             "kept_card": kept,
             "kept_cpu": [[float(w) for w in g.weights] for g in cpu_groups]}
        rounds.append(d)
        if (d["card"] != d["cpu"] or d["kept_card"] != d["kept_cpu"]
                or max(abs(x - y) for x, y in zip(*acc)) > ROUND1_ACC_ATOL):
            problems.append(f"aggregate, card vs CPU on the same uploads: "
                            f"{d} (acc tol {ROUND1_ACC_ATOL})")
    for rec in fusions:
        rows = []
        with checking_k1(rows):
            again, info = rerun_fusion(rec, spec, "cuda")
        k1 = k1_steps_summary(rows)
        card, _ = rerun_fusion(rec, spec, "cuda", steps=FUSION_PREFIX_STEPS)
        host, _ = rerun_fusion(rec, spec, "cpu", steps=FUSION_PREFIX_STEPS)
        d = {"k1_every_step": k1, "steps": info["steps"],
             "rerun_vs_recorded": flat_diff(
                 again, {k: v.cpu() for k, v in
                         tree_flatten(rec["params"]).items()}),
             "prefix_steps": FUSION_PREFIX_STEPS,
             "prefix_card_vs_cpu": flat_diff(card, host),
             "prefix_atol": ROUND1_PARAM_ATOL}
        fused.append(d)
        if not k1["ok"] or k1["calls"] != info["steps"]:
            problems.append(f"K1 against its plain version at every distill "
                            f"step: {d}")
        if d["prefix_card_vs_cpu"] > ROUND1_PARAM_ATOL:
            problems.append(f"the fusion's first {FUSION_PREFIX_STEPS} "
                            f"steps from the card's uploads, card vs CPU: "
                            f"{d}")
    return ({"rounds": rounds, "acc_tol": ROUND1_ACC_ATOL,
             "fusions": fused}, problems)


def cpu_self_spread(spec) -> float:
    """How far the CPU's own run moves when its init moves by one unit in
    the last place: the end-to-end spread no device can beat."""
    import torch
    from repro_torch.api import Experiment, build_cohort, build_task_bundle
    from repro_torch.common.pytree import tree_map
    net = build_cohort(spec, build_task_bundle(spec))[0][0]
    init = net.init(torch.Generator().manual_seed(spec.seed))
    nudged = tree_map(lambda x: torch.nextafter(
        x, torch.full_like(x, float("inf"))), init)
    runs = [Experiment(spec, device="cpu").run(init_globals=[i])
            for i in (init, nudged)]
    return max_abs_diff(runs[0].global_params, runs[1].global_params)


def ablations_path():
    """Path 7: each ablation's round on the card, its launches (K1 once per
    distill step on 7a-7d, K2 once per distill step at K = 13 on 7e and no
    K1 there), and card against CPU; 7d's round profiled for the busy
    share."""
    from repro_torch.core.logit_bank import DEFAULT_CHUNK
    from repro_torch.core.quantize import comm_bytes
    report, problems = {}, []
    for name, spec in ablation_specs().items():
        calls, fusions = [], []
        dropworst = name == "7a_dropworst"
        with contextlib.ExitStack() as recording:
            if dropworst:
                recording.enter_context(recording_engine_aggregate(calls))
                recording.enter_context(recording_fusions(fusions))
            res, rep, probs = run_path(spec)
        steps = rep["distill_steps"]
        fly = name == "7e_swag_fly"
        kernel = "ensemble_kl" if fly else "ensemble_kl_bank"
        probs += check_launches(rep["launches"], {f"{kernel}_fwd": steps,
                                                  f"{kernel}_bwd": steps},
                                "launches")
        logs = fused_logs(res)
        if not logs or any(l.bank != ("on_the_fly" if fly else "bank")
                           for l in logs):
            probs.append(f"bank decisions {[l.bank for l in logs]}")
        rep["n_dropped"] = [l.n_dropped for l in res.result.logs]
        if name.startswith("7d") or fly:
            # 8 uploads + 5 SWAG teachers: on the fly every step runs all
            # 13, the bank runs them once over the pool's chunks
            chunks = -(-spec.source.params.get("n", 4000) // DEFAULT_CHUNK)
            for l in logs:
                k = l.n_participants + SWAG_SAMPLES
                want = l.distill_steps * k if fly else chunks * k
                if l.teacher_forwards != want:
                    probs.append(f"{l.teacher_forwards} teacher forwards, "
                                 f"expected {want} ({k} teachers)")
        if name == "7b_lowbit":
            p = res.global_params[0]
            rep["comm_bytes"] = {"fp32": comm_bytes(p),
                                 "1bit": comm_bytes(p, binarized=True)}
        # Table 3's settings: the CPU alone moves 7a's round by far more
        # than ROUND1_PARAM_ATOL when its init moves one ulp, and the
        # fusion on these uploads parts card from CPU by ~1e-2 with the
        # plain versions too (chip_probe_ablations.py).  So 7a's globals
        # distance is reported beside the CPU's own spread; its steps,
        # drops, bank, teacher forwards and accuracy are held as on every
        # sub-path, and its aggregations on the card's own uploads by
        # same_uploads_check
        check, busy, more = (
            card_vs_cpu(spec, 1, profile_ref=res) if name.startswith("7d")
            else card_vs_cpu(spec, 1, gpu=res,
                             param_tol=None if dropworst
                             else ROUND1_PARAM_ATOL))
        if dropworst:
            check["cpu_self_spread"] = cpu_self_spread(spec)
            rep["same_uploads"], held = same_uploads_check(spec, calls,
                                                           fusions)
            more += held
            if len(calls) != spec.rounds or len(fusions) != spec.rounds:
                more.append(f"{len(calls)} aggregations and {len(fusions)} "
                            f"fusions recorded for {spec.rounds} rounds")
            for l in res.result.logs:
                # the filter must act: some uploads dropped, some kept
                if not 0 < l.n_dropped < l.n_dropped + l.n_participants:
                    more.append(f"round {l.round}: {l.n_dropped} dropped, "
                                f"{l.n_participants} kept")
        rep.update(cpu_check=check)
        if busy is not None:
            rep["round1_device"] = busy
        report[name] = rep
        problems += [f"{name}: {p}" for p in probs + more]
    return report, problems


def buffered_hetero_spec(rounds: int):
    """Path 8a: path 5's spec (examples/heterogeneous_fusion.py) on the
    buffered-async driver as path 3 runs it: staleness 1, the noise source,
    a buffer of the 6 active clients' uploads, upload latency 1.0 with
    jitter 0.2 (virtual seconds)."""
    from repro_torch.api import (DriverSpec, PopulationSpec, SourceSpec,
                                 TrafficSpec)
    return dataclasses.replace(
        hetero_spec(rounds), source=SourceSpec(name="noise"),
        driver=DriverSpec(kind="buffered_async", staleness=1),
        population=PopulationSpec(buffer_size=6, max_staleness=4,
                                  traffic=TrafficSpec(latency=1.0,
                                                      jitter=0.2)))


def bucketed_spec(rounds: int):
    """Path 8b(i): the quickstart (path 1) with power-of-two step
    buckets."""
    from repro_torch.api import BucketSpec
    return dataclasses.replace(quickstart_spec(rounds),
                               bucket=BucketSpec(kind="pow2", max_buckets=4))


def distill_bucket_spec(rounds: int):
    """Path 8b(ii): path 5a's spec with one distill batch per prototype,
    bucketed by powers of two: capacities 32, 64 and 64."""
    spec = hetero_spec(rounds)
    fusion = dataclasses.replace(spec.strategy.fusion,
                                 batch_sizes=list(DISTILL_BATCHES),
                                 distill_bucket="pow2")
    return dataclasses.replace(spec, strategy=dataclasses.replace(
        spec.strategy, fusion=fusion))


def tokens_spec(rounds: int):
    """Path 8c: examples/train_e2e.py's FedDF spec at its published widths
    (the paper's DistilBERT / AG News stand-in, Fig. 3): tokens 6000
    (vocabulary 64, sequences of 16, 4 classes), 10 clients, alpha 1.0,
    C = 1.0, E = 5, local Adam, tiny_transformer d_model 64 with 2
    layers, an unlabeled token pool of 4000, FedDF max 400 steps, patience
    200, batch 64, seed 3."""
    from repro_torch.api import (CohortSpec, ExperimentSpec, FusionSpec,
                                 ModelSpec, PartitionSpec, SourceSpec,
                                 StrategySpec, TaskSpec)
    return ExperimentSpec(
        task=TaskSpec(name="tokens", n_samples=6000),
        partition=PartitionSpec(n_clients=10, alpha=1.0),
        cohort=CohortSpec(prototypes=[ModelSpec(
            "tiny_transformer", {"d_model": 64, "n_layers": 2})]),
        strategy=StrategySpec(name="feddf",
                              fusion=FusionSpec(max_steps=400, patience=200,
                                                eval_every=50,
                                                batch_size=64)),
        source=SourceSpec(name="unlabeled", params={"n": 4000}),
        rounds=rounds, client_fraction=1.0, local_epochs=5,
        local_batch_size=32, local_lr=0.05, local_optimizer="adam", seed=3)


@contextlib.contextmanager
def recording_k1_rows(rows: list):
    """While open, every K1 call appends its student batch (the rows the
    loss sees) to ``rows``; it launches nothing of its own."""
    from repro_torch.core import feddf
    orig = feddf.ensemble_kl_loss_bank

    def recording(s_logits, logits, scales, idx, temp):
        rows.append((int(s_logits.shape[0]), int(logits.shape[1])))
        return orig(s_logits, logits, scales, idx, temp)
    feddf.ensemble_kl_loss_bank = recording
    try:
        yield rows
    finally:
        feddf.ensemble_kl_loss_bank = orig


def buffered_hetero_path():
    """Path 8a: buffered heterogeneous fusion.  Rounds whose consumed
    uploads are all fresh fuse on K2 over every group's teachers (round 1:
    K = 6); a round with a stale upload fuses the weighted consensus on
    K3.  At least one upload must fuse stale."""
    spec = buffered_hetero_spec(BUFFERED_HETERO_ROUNDS)
    res, report, problems = run_path(spec)
    logs = group_logs(res)
    k2 = k3 = 0
    for t in range(spec.rounds):
        steps = sum(g[t].distill_steps for g in logs)
        if sum(logs[0][t].staleness_hist[1:]):
            k3 += steps
        else:
            k2 += steps
    problems += check_launches(
        report["launches"], {"ensemble_kl_fwd": k2, "ensemble_kl_bwd": k2,
                             "ensemble_kl_pre_fwd": k3,
                             "ensemble_kl_pre_bwd": k3}, "path 8a")
    m = spec.population.buffer_size
    hists = [[l.staleness_hist for l in g] for g in logs]
    report["staleness_hist_per_group"] = hists
    for g in logs:
        for l in g:
            if (l.staleness_hist is None or sum(l.staleness_hist) != m
                    or not 0 < l.eff_participants <= m):
                problems.append(f"round {l.round}: telemetry "
                                f"{l.staleness_hist} {l.eff_participants}")
    if not any(sum(h[1:]) for g in hists for h in g):
        problems.append("no upload fused stale")
    if any(l.bank != "on_the_fly" for l in fused_logs(res)):
        problems.append(f"bank decisions "
                        f"{[l.bank for l in fused_logs(res)]}")
    check1, _, more1 = card_vs_cpu(spec, 1)
    check, _, more = card_vs_cpu(spec, BUFFERED_CPU_ROUNDS, gpu=res)
    report.update(cpu_check=check, cpu_check_round1=check1)
    return report, problems + more1 + more


def train_clients_s(engine, active) -> tuple:
    """One round's ``train_clients`` on ``engine`` from its init, timed to
    the card's end; returns (groups, seconds, batches)."""
    import torch
    batches = engine.build_round_batches(1, active)
    globals_ = engine.init_globals()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = engine.train_clients(1, globals_, batches)
    torch.cuda.synchronize()
    return groups, time.perf_counter() - t0, batches


def bucketing_path():
    """Path 8b: (i) step-count bucketing on the quickstart, 1 round on K1:
    its uploads against the unbucketed round's on the card (1e-5), its
    globals against the unbucketed round's (1e-3, equal distill steps),
    ``train_clients`` timed bucketed and not; (ii) one distill batch per
    prototype on path 5a's spec (K1 at B = 32, 64 and 48 on one bank)."""
    report, problems = {}, []
    spec = bucketed_spec(1)
    res, rep, probs = run_path(spec)
    steps = rep["distill_steps"]
    probs += check_launches(rep["launches"], {
        "ensemble_kl_bank_fwd": steps, "ensemble_kl_bank_bwd": steps},
        "launches")
    if any(l.bank != "bank" for l in res.result.logs):
        probs.append(f"bank decisions {[l.bank for l in res.result.logs]}")
    plain = quickstart_spec(1)
    from repro_torch.api import Experiment
    unb = Experiment(plain, device="cuda").run()
    d_glob = max_abs_diff(res.global_params, unb.global_params)
    steps_b = [l.distill_steps for l in res.result.logs]
    steps_u = [l.distill_steps for l in unb.result.logs]
    # the uploads, engine by engine, on the same cohort; each timed twice
    eb, eu = engine_on(spec, "cuda"), engine_on(plain, "cuda")
    active = eb.sample_cohort(eb.make_rng())
    times = {"unbucketed": [], "bucketed": []}
    for _ in range(2):
        gu, su, bu = train_clients_s(eu, active)
        gb, sb, bb = train_clients_s(eb, active)
        times["unbucketed"].append(su)
        times["bucketed"].append(sb)
    d_up = max_abs_diff([gb[0].stack], [gu[0].stack])
    rb, ru = bb[0], bu[0]
    buck = {"bucket_caps": eb.bucket_caps[0],
            "buckets": [(b.cap_steps, b.k_real, b.cap_clients)
                        for b in rb.buckets],
            "real_steps": rb.real_steps,
            "padded_slots": {"bucketed": rb.padded_slots,
                             "unbucketed": ru.padded_slots},
            "host_steps": {"bucketed": sum(b.cap_steps for b in rb.buckets),
                           "unbucketed": sum(b.cap_steps
                                             for b in ru.buckets)},
            "train_clients_s": times,
            "train_clients_phase_s": {
                "bucketed": res.phase_seconds[0]["train_clients"],
                "unbucketed": unb.phase_seconds[0]["train_clients"]},
            "uploads_max_abs_diff": d_up, "uploads_tol": BUCKET_UPLOAD_ATOL,
            "globals_max_abs_diff": d_glob, "globals_tol": ROUND1_PARAM_ATOL,
            "distill_steps": {"bucketed": steps_b, "unbucketed": steps_u}}
    if len(rb.buckets) < 2:
        probs.append(f"the cohort fell into {len(rb.buckets)} bucket(s)")
    if rb.real_steps != ru.real_steps:
        probs.append(f"real steps {rb.real_steps} != {ru.real_steps}")
    if d_up > BUCKET_UPLOAD_ATOL:
        probs.append(f"uploads bucketed vs not {d_up:.3e}")
    if d_glob > ROUND1_PARAM_ATOL or steps_b != steps_u:
        probs.append(f"globals bucketed vs not {d_glob:.3e}, steps "
                     f"{steps_b} vs {steps_u}")
    check, _, more = card_vs_cpu(spec, 1, gpu=res)
    rep.update(cpu_check=check, bucketing=buck)
    report["8bi_step_buckets"] = rep
    problems += [f"8b(i): {p}" for p in probs + more]

    spec = distill_bucket_spec(1)
    rows = []
    with recording_k1_rows(rows):
        res, rep, probs = run_path(spec)
    steps = rep["distill_steps"]
    probs += check_launches(rep["launches"], {
        "ensemble_kl_bank_fwd": steps, "ensemble_kl_bank_bwd": steps},
        "launches")
    if not fused_logs(res) or any(l.bank != "bank" for l in fused_logs(res)):
        probs.append(f"bank decisions {[l.bank for l in fused_logs(res)]}")
    shapes = sorted(set(rows))
    fused = [g for g, glogs in enumerate(group_logs(res))
             if glogs[0].n_participants]
    want = sorted({(DISTILL_BATCHES[g], 3) for g in fused})
    if shapes != want:
        probs.append(f"K1 saw (B, V) {shapes}, expected {want}")
    check, _, more = card_vs_cpu(spec, 1, gpu=res)
    rep.update(cpu_check=check, k1_shapes=shapes)
    report["8bii_distill_buckets"] = rep
    problems += [f"8b(ii): {p}" for p in probs + more]
    return report, problems


def tokens_path():
    """Path 8c: the paper's token path, tiny_transformer on the tokens task
    over the unlabeled token pool (K1 at B = 64, V = 4), 1 round; its
    round 1 rerun profiled on the card and against the CPU."""
    spec = tokens_spec(TOKENS_ROUNDS)
    rows = []
    with recording_k1_rows(rows):
        res, report, problems = run_path(spec)
    steps = report["distill_steps"]
    problems += check_launches(report["launches"], {
        "ensemble_kl_bank_fwd": steps, "ensemble_kl_bank_bwd": steps},
        "path 8c")
    if any(l.bank != "bank" for l in res.result.logs):
        problems.append(f"bank decisions "
                        f"{[l.bank for l in res.result.logs]}")
    if sorted(set(rows)) != [(64, 4)]:
        problems.append(f"K1 saw (B, V) {sorted(set(rows))}")
    check, busy, more = card_vs_cpu(spec, 1, profile_ref=res)
    report.update(cpu_check=check, round1_device=busy)
    return report, problems + more


def poison_rows(t, rows_dim: int):
    """NONFINITE_ROWS into ``t`` in place: row r's element r % V (of
    teacher r % K when ``rows_dim`` is 1)."""
    for r, val in NONFINITE_ROWS.items():
        sub = t.select(rows_dim, r) if rows_dim == 0 else \
            t[r % t.shape[0], r]
        sub[r % t.shape[-1]] = val
    return t


def plain_kl_rows(s, teachers, temp):
    """Per-row KL(softmax(mean_k t_k / T) || softmax(s / T)) as the plain
    versions compute it (kernels/ref.py), before the batch mean: the
    kernels' per-row ``kl`` output, in T-scaled units."""
    import torch
    from repro_torch.kernels import ref
    logp_t = torch.log_softmax(ref._mean_teacher(teachers, temp), -1)
    logp_s = torch.log_softmax(s.float() / temp, -1)
    return (logp_t.exp() * (logp_t - logp_s)).sum(-1)


def rows_check(got, want, rtol: float, atol: float) -> tuple:
    """(non-finite in exactly the same places, max |got - want| over the
    finite places, that max within atol + rtol |want|)."""
    import torch
    fin = torch.isfinite(want)
    same = torch.equal(torch.isfinite(got), fin)
    d = (got[fin].float() - want[fin].float()).abs()
    err = float(d.max()) if d.numel() else 0.0
    ok = bool((d <= atol + rtol * want[fin].float().abs()).all())
    return same, err, ok


def bits_equal(a, b) -> bool:
    """Equal bits, NaN included (``torch.equal`` calls NaN != NaN)."""
    import torch
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def nonfinite_phase(device):
    """K1 (every bank dtype) and K2 / K3 (f32 and bf16 teachers) in each
    launch mode on rows holding a NaN, a +Inf and a -Inf teacher logit:
    the per-row loss and the gradient against the plain versions', two
    launches against each other."""
    import torch
    from repro_torch.core.logit_bank import bank_dtype, quantize_rows
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ref
    from repro_torch.kernels.ensemble_kl_bank import (bank_kl_bwd,
                                                      bank_kl_fwd, card_plan)
    b, temp = NONFINITE_B, 2.5
    gen = torch.Generator().manual_seed(7)
    g1 = torch.ones((), device=device)
    out = []

    def record(kernel, mode, plan_mode, v, kind, f1, f2, d1, d2, want,
               g_want, fwd_tol, bwd_tol):
        fin_f, fwd_err, fwd_ok = rows_check(f1[0], want, *fwd_tol)
        fin_b, bwd_err, bwd_ok = rows_check(d1, g_want, *bwd_tol)
        repeat = (all(bits_equal(x, y) for x, y in zip(f1, f2))
                  and bits_equal(d1, d2))
        bad = lambda x: sorted(set(torch.nonzero(~torch.isfinite(x))[:, 0]
                                   .tolist()))
        out.append({
            "kernel": kernel, "mode": plan_mode, "B": b, "V": v,
            "dtype": kind, "nonfinite_rows": bad(f1[0]),
            "plain_nonfinite_rows": bad(want),
            "grad_nonfinite_rows": bad(d1),
            "plain_grad_nonfinite_rows": bad(g_want),
            "fwd_err": fwd_err, "bwd_err": bwd_err, "repeat_equal": repeat,
            "ok": (plan_mode == mode and fin_f and fin_b and fwd_ok
                   and bwd_ok and repeat)})

    for mode, v in NONFINITE_V.items():
        s = torch.randn(b, v, generator=gen).to(device)
        for dtype_name in BANK_DTYPES:
            bank32 = poison_rows(torch.randn(b, v, generator=gen) * 3, 0)
            idx = torch.randperm(b, generator=gen)
            if dtype_name in ("int8", "fp8_e4m3"):
                rows, scales = quantize_rows(bank32, dtype_name)
            else:
                rows, scales = bank32.to(bank_dtype(dtype_name)), None
            row_scale = (torch.ones(b) if scales is None else scales[idx])
            rows, idx = rows.to(device), idx.to(device)
            row_scale = row_scale.to(device)
            scales = None if scales is None else scales.to(device)
            f1 = bank_kl_fwd(s, rows, scales, idx, temp)
            f2 = bank_kl_fwd(s, rows, scales, idx, temp)
            d1 = bank_kl_bwd(s, rows, scales, idx, f1[1], f1[2], g1, temp)
            d2 = bank_kl_bwd(s, rows, scales, idx, f1[1], f1[2], g1, temp)
            want = plain_kl_rows(
                s, (rows[idx].float() * row_scale[:, None])[None], temp)
            sp = s.clone().requires_grad_(True)
            (g_want,) = torch.autograd.grad(ref.ensemble_kl_bank(
                sp, rows, row_scale, idx, temp), sp)
            torch.cuda.synchronize()
            record("ensemble_kl_bank", mode, card_plan(device, b, v).mode,
                   v, dtype_name, f1, f2, d1, d2, want, g_want,
                   (FWD_RTOL, FWD_ATOL), (0.0, BWD_ATOL))
        for tdt in TEACHER_DTYPES:
            for pre in (False, True):
                shape = (b, v) if pre else (NONFINITE_K, b, v)
                t = poison_rows(torch.randn(shape, generator=gen) * 3,
                                0 if pre else 1)
                t = t.to(getattr(torch, tdt)).to(device)
                f1 = k2.kl_fwd(s, t, temp, pre)
                f2 = k2.kl_fwd(s, t, temp, pre)
                d1 = k2.kl_bwd(s, t, f1[1], f1[2], g1, temp, pre)
                d2 = k2.kl_bwd(s, t, f1[1], f1[2], g1, temp, pre)
                want = plain_kl_rows(s, t[None] if pre else t, temp)
                plain = ref.ensemble_kl_pre if pre else ref.ensemble_kl
                sp = s.clone().requires_grad_(True)
                (g_want,) = torch.autograd.grad(plain(sp, t, temp), sp)
                torch.cuda.synchronize()
                k = 1 if pre else NONFINITE_K
                record("ensemble_kl_pre" if pre else "ensemble_kl", mode,
                       k2.card_plan(device, k, b, v).mode, v, tdt, f1, f2,
                       d1, d2, want, g_want, (K2_FWD_RTOL, K2_FWD_ATOL),
                       (K2_GRAD_RTOL, K2_GRAD_ATOL))
    return out


def fault_spec(rounds: int, **faults):
    """Path 9: the quickstart under the CHAOS mix (``faults`` overrides)."""
    from repro_torch.api import FaultSpec
    return dataclasses.replace(quickstart_spec(rounds),
                               faults=FaultSpec(**{**CHAOS, **faults}))


def _filter_margin(net, stack, probe_x, sigma) -> Optional[float]:
    """The teacher filter's smallest |z - sigma| over its finite teachers
    (core/feddf.filter_teacher_stack's statistics, recomputed)."""
    import numpy as np
    import torch
    with torch.no_grad():
        logits = net.apply(stack, probe_x, train=False)
    logits = logits.float().cpu().numpy().astype(np.float64)
    finite = np.isfinite(logits).all(axis=(1, 2))
    if not finite.any():
        return None
    med = np.median(logits[finite], axis=0)
    dist = np.mean(np.abs(logits[finite] - med), axis=(1, 2))
    center = float(np.median(dist))
    mad = float(np.median(np.abs(dist - center)))
    z = np.abs(dist - center) / (1.4826 * mad + 0.05 * abs(center) + 1e-12)
    return float(np.min(np.abs(z - sigma)))


@contextlib.contextmanager
def recording_defenses(rec: dict):
    """While open: the sync screen's and the teacher filter's smallest
    margins |z - sigma| per call, the filter's kept teachers, and every
    upload's fault kinds at its first attempt, into ``rec``."""
    import numpy as np
    from repro_torch.core import feddf
    from repro_torch.population import faults as F
    for key in ("screen_margin", "screen_z", "filter_margin", "kept",
                "kinds"):
        rec.setdefault(key, [])
    orig = (F.outlier_mask, feddf.filter_teacher_stack,
            F.FaultModel.corrupt)

    def mask(norms, sigma):
        n = np.asarray(norms, np.float64)
        fin = n[np.isfinite(n)]
        if fin.size:
            med = float(np.median(fin))
            mad = float(np.median(np.abs(fin - med)))
            z = F.robust_z(fin, med, mad)
            near = int(np.argmin(np.abs(z - sigma)))
            rec["screen_margin"].append(float(abs(z[near] - sigma)))
            # the z nearest sigma, and the z of the largest delta norm
            # (a byzantine upload's, when one is in the cohort)
            rec["screen_z"].append((float(z[near]), float(z[np.argmax(fin)])))
        return orig[0](norms, sigma)

    def filt(net, stack, probe_x, sigma=6.0):
        kept, n_drop = orig[1](net, stack, probe_x, sigma)
        rec["filter_margin"].append(_filter_margin(net, stack, probe_x,
                                                   sigma))
        rec["kept"].append([int(i) for i in kept])
        return kept, n_drop

    def corrupt(self, wave, client, leaves, base, attempt=0):
        out, kinds = orig[2](self, wave, client, leaves, base, attempt)
        if attempt == 0 and kinds:
            rec["kinds"].append((int(wave), int(client), list(kinds)))
        return out, kinds
    F.outlier_mask, feddf.filter_teacher_stack = mask, filt
    F.FaultModel.corrupt = corrupt
    try:
        yield rec
    finally:
        F.outlier_mask, feddf.filter_teacher_stack, F.FaultModel.corrupt = \
            orig


@contextlib.contextmanager
def recording_banks(banks: list):
    """While open, each new logit bank K1 is called on appends ``(rows,
    non-finite rows)`` to ``banks`` (one host read per bank)."""
    import torch
    from repro_torch.core import feddf
    orig = feddf.ensemble_kl_loss_bank
    seen = set()

    def recording(s_logits, logits, scales, idx, temp):
        if id(logits) not in seen:
            seen.add(id(logits))
            rows = logits.float()
            if scales is not None:
                rows = rows * scales[:, None]
            banks.append((int(logits.shape[0]), int(
                (~torch.isfinite(rows)).any(dim=1).sum())))
        return orig(s_logits, logits, scales, idx, temp)
    feddf.ensemble_kl_loss_bank = recording
    try:
        yield banks
    finally:
        feddf.ensemble_kl_loss_bank = orig


@contextlib.contextmanager
def recording_cohorts(cohorts: list):
    """While open, every cohort draw appends its clients to ``cohorts``."""
    from repro_torch.core.engine import RoundEngine
    orig = RoundEngine.sample_cohort

    def recording(self, rng):
        out = orig(self, rng)
        cohorts.append([int(c) for c in out])
        return out
    RoundEngine.sample_cohort = recording
    try:
        yield cohorts
    finally:
        RoundEngine.sample_cohort = orig


def fault_facts(res) -> list:
    """Each round's fault decisions."""
    return [(l.round, l.n_corrupted, l.n_quarantined, l.n_retries,
             l.n_teachers_filtered, l.fused, l.rolled_back)
            for l in res.result.logs]


def defended_path():
    """9a: the defended FedDF on the bank (K1) under the mix: upload
    screen, retries, quarantine and the teacher filter, card against
    CPU."""
    spec = fault_spec(DEFENDED_ROUNDS)
    card, cpu = {}, {}
    with recording_defenses(card):
        res, report, problems = run_path(spec)
    with recording_defenses(cpu):
        check, _, more = card_vs_cpu(spec, spec.rounds, gpu=res)
    logs, steps = res.result.logs, report["distill_steps"]
    problems += more + check_launches(
        report["launches"], {"ensemble_kl_bank_fwd": steps,
                             "ensemble_kl_bank_bwd": steps}, "launches")
    if any(l.bank != "bank" for l in logs if l.fused):
        problems.append(f"bank decisions {[l.bank for l in logs]}")
    if not sum(l.n_corrupted for l in logs) or not card["screen_margin"]:
        problems.append("the mix corrupted no upload, or no screen ran")
    for key in ("kept", "kinds"):
        if card[key] != cpu[key]:
            problems.append(f"{key} card {card[key]} CPU {cpu[key]}")
    report.update(cpu_check=check, faults=fault_facts(res),
                  kinds=card["kinds"], kept=card["kept"],
                  screen_z_cuda=card["screen_z"],
                  screen_margin_cuda=card["screen_margin"],
                  screen_margin_cpu=cpu["screen_margin"],
                  filter_margin_cuda=card["filter_margin"],
                  filter_margin_cpu=cpu["filter_margin"])
    return report, problems


def undefended_path():
    """9b: no screen, no teacher filter, NaN rate 0.25: a non-finite
    upload reaches the bank in round 1, K1 runs on non-finite rows, the
    fusion's divergence guard stops it after its first chunk and
    ``guard_globals`` rolls the round back, card as CPU."""
    spec = fault_spec(1, nan_rate=UNDEFENDED_NAN_RATE, screen="off",
                      teacher_filter="off")
    rec, banks = {}, []
    with recording_defenses(rec), recording_banks(banks):
        res, report, problems = run_path(spec)
    check, _, more = card_vs_cpu(spec, 1, gpu=res)
    log, launches = res.result.logs[0], report["launches"]
    problems += more
    if not any("nan" in kinds for _, _, kinds in rec["kinds"]):
        problems.append(f"no NaN / Inf upload fired: {rec['kinds']}")
    if not any(bad for _, bad in banks) or \
            launches["ensemble_kl_bank_fwd"] == 0:
        problems.append(f"K1 ran on no bank with non-finite rows: banks "
                        f"{banks}, launches {launches}")
    if not log.rolled_back:
        problems.append("the round was not rolled back")
    report.update(cpu_check=check, faults=fault_facts(res),
                  kinds=rec["kinds"], banks_rows_nonfinite=banks,
                  guard_chunk_steps=log.distill_steps)
    return report, problems


def robust_rule_check(calls) -> dict:
    """Each recorded card aggregation rerun on the CPU on the same
    uploads: the largest difference of the new globals."""
    from repro_torch.common.pytree import tree_to
    cpu = lambda t: None if t is None else tree_to(t, "cpu")
    diffs = []
    for strat, groups, state, ctx, (new, _, _) in calls:
        want, _, _ = strat.aggregate(
            [dataclasses.replace(g, prev_global=cpu(g.prev_global),
                                 stack=cpu(g.stack)) for g in groups],
            state, ctx)
        diffs.append(max_abs_diff(want, new))
    return {"globals": diffs, "atol": ROBUST_PARAM_ATOL}


def robust_rules_path():
    """9c: trimmed_mean (trim_frac 0.2) and coordinate_median under the
    mix with the screen off, 1 round each: no kernel."""
    from repro_torch.api import StrategySpec
    from repro_torch.core.strategies import CoordinateMedian, TrimmedMean
    report, problems = {}, []
    for name, cls in (("trimmed_mean", TrimmedMean),
                      ("coordinate_median", CoordinateMedian)):
        spec = dataclasses.replace(
            fault_spec(1, screen="off"), source=None,
            strategy=StrategySpec(name=name, trim_frac=0.2))
        calls = []
        with recording_aggregate(cls, calls):
            res, rep, probs = run_path(spec)
        probs += check_launches(rep["launches"], {}, "launches")
        rep["rule_alone"] = robust_rule_check(calls)
        if len(calls) != 1 or max(rep["rule_alone"]["globals"]) > \
                ROBUST_PARAM_ATOL:
            probs.append(f"the rule alone, card vs CPU: {rep['rule_alone']}")
        check, _, more = card_vs_cpu(spec, 1, gpu=res,
                                     param_tol=ROBUST_PARAM_ATOL)
        rep.update(cpu_check=check, faults=fault_facts(res))
        report[name] = rep
        problems += [f"{name}: {p}" for p in probs + more]
    return report, problems


def buffered_faults_path():
    """9d: path 3's buffered driver under the mix, with the quorum:
    NormScreen on each upload, K2 in the fresh round, K3 in the stale
    ones, and a partial fuse or a skipped round where the mix forces
    one."""
    from repro_torch.api import FaultSpec
    spec = dataclasses.replace(buffered_spec(MAIN_ROUNDS),
                               faults=FaultSpec(**CHAOS))
    res, report, problems = run_path(spec)
    logs, launches = res.result.logs, report["launches"]
    steps = report["distill_steps"]
    k2_k3 = launches["ensemble_kl_fwd"] + launches["ensemble_kl_pre_fwd"]
    if (k2_k3 != steps or launches["ensemble_kl_fwd"] == 0
            or launches["ensemble_kl_pre_fwd"] == 0):
        problems.append(f"K2 {launches['ensemble_kl_fwd']} + K3 "
                        f"{launches['ensemble_kl_pre_fwd']} launches for "
                        f"{steps} distill steps")
    for fwd, bwd in (("ensemble_kl_fwd", "ensemble_kl_bwd"),
                     ("ensemble_kl_pre_fwd", "ensemble_kl_pre_bwd")):
        if launches[fwd] != launches[bwd]:
            problems.append(f"{fwd} {launches[fwd]} != {bwd} "
                            f"{launches[bwd]}")
    if not sum(l.n_corrupted for l in logs):
        problems.append("the mix corrupted no upload")
    check, _, more = card_vs_cpu(spec, BUFFERED_CPU_ROUNDS,
                                 param_tol=ROUND2_PARAM_ATOL, gpu=res)
    m = spec.population.buffer_size
    report.update(cpu_check=check, faults=fault_facts(res),
                  partial_fuses=[l.round for l in logs if l.fused
                                 and sum(l.staleness_hist or [m]) < m],
                  skipped_rounds=[l.round for l in logs if not l.fused])
    return report, problems + more


class _StopAtRound(Exception):
    pass


def resume_path():
    """9e: path 1's spec with round snapshots, interrupted by an observer
    that raises at round 3, resumed on the card from the round-2 snapshot,
    against an uninterrupted run: cohorts, distill steps and accuracy
    equal, globals within RESUME_PARAM_ATOL (and whether bit for bit)."""
    import tempfile
    import torch
    from repro_torch.api import Experiment
    from repro_torch.common.pytree import tree_flatten
    spec = quickstart_spec(RESUME_ROUNDS)
    base_cohorts, cut_cohorts, res_cohorts = [], [], []
    with recording_cohorts(base_cohorts):
        base = Experiment(spec, device="cuda").run()

    def bomb(event):
        if event.round == RESUME_ROUNDS:
            raise _StopAtRound

    problems = []
    with tempfile.TemporaryDirectory() as d:
        reset_all_launches()
        t0 = time.perf_counter()
        with recording_cohorts(cut_cohorts):
            try:
                Experiment(spec, device="cuda").run(observers=[bomb],
                                                    checkpoint_dir=d)
                problems.append("the observer did not interrupt the run")
            except _StopAtRound:
                pass
        snapshots = sorted(os.listdir(os.path.join(d, "rounds")))
        with recording_cohorts(res_cohorts):
            resumed = Experiment.resume(d, device="cuda")
        wall = time.perf_counter() - t0
        launches = all_launches()
    a, b = tree_flatten(resumed.global_params[0]), tree_flatten(
        base.global_params[0])
    bit_equal = all(torch.equal(a[k], b[k]) for k in a)
    steps = [[l.distill_steps for l in r.result.logs]
             for r in (resumed, base)]
    acc = [[l.test_acc for l in r.result.logs] for r in (resumed, base)]
    check = {"snapshots": snapshots, "cohorts_equal":
             res_cohorts == base_cohorts, "distill_steps": steps,
             "test_acc": acc,
             "max_abs_param_diff": max_abs_diff(resumed.global_params,
                                                base.global_params),
             "param_tol": RESUME_PARAM_ATOL, "bit_equal": bit_equal,
             "logs_equal": resumed.result.logs == base.result.logs}
    if (not check["cohorts_equal"] or steps[0] != steps[1]
            or acc[0] != acc[1]
            or check["max_abs_param_diff"] > RESUME_PARAM_ATOL
            or snapshots[-1] != f"{RESUME_ROUNDS - 1:05d}"):
        problems.append(f"resume against uninterrupted: {check}")
    resumed_steps = resumed.result.logs[-1].distill_steps
    problems += check_launches(
        launches, {"ensemble_kl_bank_fwd": sum(steps[1]) + resumed_steps,
                   "ensemble_kl_bank_bwd": sum(steps[1]) + resumed_steps},
        "launches (interrupted run + resume)")
    return {"wall_s": wall, "rounds": [], "launches": launches,
            "distill_steps": sum(steps[1]) + resumed_steps,
            "cpu_check": check}, problems


# ---------------------------------------------------------------------------
# path 10: the pipelined and distributed drivers and the flight recorder
# ---------------------------------------------------------------------------

WIRE_KEYS = ("wire_bytes_up", "wire_bytes_down", "n_wire_retries",
             "n_crc_failures", "n_deadline_misses", "n_wire_lost",
             "n_pods_alive")


def pipelined_spec(spec, staleness: int):
    from repro_torch.api import DriverSpec
    return dataclasses.replace(spec, driver=DriverSpec(
        kind="async_pipelined", staleness=staleness))


def dist_spec(spec, **dist):
    from repro_torch.api import DistSpec, DriverSpec
    return dataclasses.replace(spec, driver=DriverSpec(kind="distributed"),
                               dist=DistSpec(**dist))


def driver_run(spec, device="cuda", configure=None) -> dict:
    """What ``Experiment(spec).run()`` does (``build_engine`` and the
    spec's driver), called directly so that the path keeps each round's
    globals (cloned in the round-end hook) and the driver itself;
    ``configure(engine)`` sets engine-level knobs the spec does not carry
    (the chaos hook)."""
    from repro_torch.api import build_engine
    from repro_torch.common.pytree import tree_map
    from repro_torch.drivers import make_driver
    t0 = time.perf_counter()
    engine = build_engine(spec, device)
    if configure is not None:
        configure(engine)
    drv = make_driver(spec.driver.kind, staleness=spec.driver.staleness,
                      prefetch=spec.driver.prefetch)
    per_round = []

    def hook(t, globals_, state, logs, rounds_to_target):
        per_round.append([tree_map(lambda x: x.detach().clone(), g)
                          for g in globals_])
    results, globals_, _ = drv.run(engine, round_end_hook=hook)
    return {"logs": [r.logs for r in results], "globals": globals_,
            "per_round": per_round, "driver": drv,
            "wall_s": time.perf_counter() - t0}


def logs_no_wire(logs):
    """Round logs as dicts without the wire telemetry, which only the
    distributed driver sets."""
    return [{k: v for k, v in dataclasses.asdict(l).items()
             if k not in WIRE_KEYS} for l in logs]


def trees_bit_equal(a, b) -> bool:
    import torch
    from repro_torch.common.pytree import tree_flatten
    for ga, gb in zip(a, b, strict=True):
        fa, fb = tree_flatten(ga), tree_flatten(gb)
        if list(fa) != list(fb) or not all(
                torch.equal(fa[k].cpu(), fb[k].cpu()) for k in fa):
            return False
    return True


def same_run(logs_a, globals_a, logs_b, globals_b) -> dict:
    """Two runs' round logs (every group; wire telemetry aside) and final
    globals: equal, and bit for bit."""
    return {"logs_equal": [logs_no_wire(g) for g in logs_a]
            == [logs_no_wire(g) for g in logs_b],
            "globals_bit_equal": trees_bit_equal(globals_a, globals_b),
            "max_abs_param_diff": max_abs_diff(globals_a, globals_b)}


def against_sync(logs, globals_, sync) -> dict:
    """A run of the first ``n`` rounds (``logs`` per group, final globals)
    against the same rounds of 10a's sync run (``driver_run``'s result,
    which keeps every round's globals)."""
    n = len(logs[0])
    ref = sync["per_round"][n - 1]
    return {"rounds": n,
            "logs_equal": [logs_no_wire(g) for g in logs]
            == [logs_no_wire(g[:n]) for g in sync["logs"]],
            "globals_bit_equal": trees_bit_equal(globals_, ref),
            "max_abs_param_diff": max_abs_diff(globals_, ref)}


def k_launches(kernel: str, steps: int) -> dict:
    """``check_launches``'s want: ``kernel``'s forward and backward once per
    distill step, every other kernel never."""
    return {f"{kernel}_fwd": steps, f"{kernel}_bwd": steps}


def round_walls(spans) -> list:
    """Per round of a pipelined run, from the flight recorder's spans:
    the round's host wall (the end of its ``evaluate_round`` minus the end
    of the previous round's, the first from the run's first span), the
    driver thread's ``join_fusion`` wait, and the overlap share 1 -
    join_fusion / wall."""
    ends = {s["round"]: s["t1"] for s in spans
            if s["name"] == "evaluate_round"}
    joins = {s["round"]: s["dur_s"] for s in spans
             if s["name"] == "join_fusion"}
    prev = min(s["t0"] for s in spans)
    rows = []
    for t in sorted(ends):
        wall = ends[t] - prev
        prev = ends[t]
        rows.append({"round": t, "wall_s": wall,
                     "join_fusion_s": joins.get(t, 0.0),
                     "overlap_share": 1.0 - joins.get(t, 0.0) / wall})
    return rows


def _union(intervals) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _measure(intervals) -> float:
    return sum(hi - lo for lo, hi in intervals)


def _intersect(a, b) -> list:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def stream_overlap(trace_path: str) -> dict:
    """From a profiler trace (Chrome JSON) of a staleness-1 run that holds
    one round's fusion and the next round's client training, over the
    device window of the training (from its ``train_clients`` span's start
    to the end of the last kernel launched inside it, matched by
    correlation id): the streams the training kernels and the K1 kernels
    in the window ran on, the device time in which a K1 kernel overlaps a
    training kernel, and the card's busy share.  The fusion's own
    ``aggregate`` span, where the profiler records the worker thread,
    names every stream the fusion launched on."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ann = sorted((e for e in events if e.get("cat") == "user_annotation"),
                 key=lambda e: e["ts"])
    trains = [e for e in ann if e["name"] == "train_clients"]
    aggs = [e for e in ann if e["name"] == "aggregate"]
    if not trains:
        return {"error": "no train_clients span in the trace"}

    def launched_in(a):
        lo, hi = a["ts"], a["ts"] + a["dur"]
        out = []
        for k in kernels:
            ln = launches.get(k["args"].get("correlation"))
            if (ln is not None and ln["tid"] == a["tid"]
                    and lo <= ln["ts"] <= hi):
                out.append(k)
        return out

    def spans(ks):
        return [[k["ts"], k["ts"] + k["dur"]] for k in ks]

    train_k = launched_in(trains[0])
    if not train_k:
        return {"error": "no kernel launched inside train_clients"}
    lo = trains[0]["ts"]
    hi = max(b for _, b in spans(train_k))
    inside = [k for k in kernels
              if k["ts"] < hi and k["ts"] + k["dur"] > lo]
    k1 = [k for k in inside if "bank_kl" in k["name"]]
    k1_u, train_u = _union(spans(k1)), _union(spans(train_k))
    busy = _measure(_union([[max(a, lo), min(b, hi)]
                            for a, b in spans(inside)]))
    out = {"window_s": (hi - lo) * 1e-6, "train_kernels": len(train_k),
           "k1_launches_in_window": len(k1),
           "train_streams": sorted({k["args"].get("stream")
                                    for k in train_k}),
           "k1_streams": sorted({k["args"].get("stream") for k in k1}),
           "train_device_s": _measure(train_u) * 1e-6,
           "k1_device_s": _measure(k1_u) * 1e-6,
           "k1_overlapping_train_s": _measure(_intersect(k1_u, train_u))
           * 1e-6,
           "busy_share": busy / (hi - lo)}
    if aggs:
        fusion_k = launched_in(aggs[0])
        out.update(fusion_kernels=len(fusion_k), fusion_streams=sorted(
            {k["args"].get("stream") for k in fusion_k}))
    return out


def pipelined_sync_path():
    """10a: the pipelined driver at staleness 0 against a sync run of the
    same spec, bit for bit (globals, logs, steps); K1 once per distill
    step.  Returns the sync run (10c's and 10d's reference) and the
    pipelined one (10g's) too."""
    spec = quickstart_spec(PIPE_ROUNDS)
    sync = driver_run(spec)
    res, report, problems = run_path(pipelined_spec(spec, 0))
    eq = same_run(group_logs(res), res.global_params, sync["logs"],
                  sync["globals"])
    report.update(cpu_check=eq, sync_wall_s=sync["wall_s"],
                  sync_phase_s=sync["driver"].phase_seconds)
    if not (eq["logs_equal"] and eq["globals_bit_equal"]):
        problems.append(f"staleness 0 against sync: {eq}")
    problems += check_launches(
        report["launches"],
        k_launches("ensemble_kl_bank", report["distill_steps"]), "10a")
    return report, problems, sync, res


def stale_path(spec, staleness: int, kernel: str):
    """10b: one staleness run on the card with the flight recorder armed
    (per-round walls and overlap from its spans), held against the CPU's
    rounds 1-2 (:func:`held_rounds`).  Returns the card run too."""
    from repro_torch.obs import trace
    pspec = pipelined_spec(spec, staleness)
    reset_all_launches()
    rec = trace.arm()
    try:
        gpu = driver_run(pspec)
    finally:
        trace.disarm()
    launches = all_launches()
    cpu = driver_run(dataclasses.replace(pspec, rounds=CPU_ROUNDS), "cpu")
    logs = gpu["logs"]
    steps = sum(l.distill_steps for l in logs[0])
    check, problems = held_rounds(gpu, cpu)
    problems += check_launches(launches, k_launches(kernel, steps),
                               f"staleness {staleness}")
    return {"wall_s": gpu["wall_s"], "cpu_wall_s": cpu["wall_s"],
            "launches": launches, "distill_steps": steps,
            "rounds": round_rows(logs, gpu["driver"].phase_seconds),
            "overlap": round_walls(rec.spans), "cpu_check": check}, \
        problems, gpu


def held_rounds(gpu, cpu) -> tuple:
    """A card run against the CPU's run of its first ``CPU_ROUNDS`` rounds
    (``driver_run`` results): accuracy and the discrete facts equal in
    each, the globals within ROUND1_PARAM_ATOL after round 1 and
    ROUND2_PARAM_ATOL after round 2."""
    n = CPU_ROUNDS
    diffs = [max_abs_diff(a, b) for a, b in zip(gpu["per_round"][:n],
                                                cpu["per_round"],
                                                strict=True)]
    acc = [[l.test_acc for l in r["logs"][0][:n]] for r in (gpu, cpu)]
    d_acc = max(abs(a - b) for a, b in zip(*acc, strict=True))
    facts = [[(l.distill_steps, l.n_participants, l.bank,
               l.teacher_forwards, l.n_crc_failures, l.n_wire_retries,
               l.n_wire_lost, l.fused) for l in r["logs"][0][:n]]
             for r in (gpu, cpu)]
    check = {"rounds": n, "max_abs_param_diff_per_round": diffs,
             "param_tol_rounds_1_2": [ROUND1_PARAM_ATOL, ROUND2_PARAM_ATOL],
             "test_acc_cuda": acc[0], "test_acc_cpu": acc[1],
             "test_acc_diff": d_acc, "facts_equal": facts[0] == facts[1],
             "facts_cuda": facts[0], "facts_cpu": facts[1]}
    problems = []
    if (diffs[0] > ROUND1_PARAM_ATOL or diffs[1] > ROUND2_PARAM_ATOL
            or d_acc > ROUND1_ACC_ATOL or facts[0] != facts[1]):
        problems.append(f"card vs CPU: {check}; (steps, clients, bank, "
                        f"teacher forwards, crc failures, retries, lost, "
                        f"fused) card {facts[0]} CPU {facts[1]}")
    return check, problems


def stale_profile_path(ref):
    """10b(i) once more on the card, the flight recorder armed with its
    profiler from round 1's end to round 2's (round 2's fusion beside
    round 3's client training), then stopped: its rounds 1-2 must equal
    ``ref``'s (10b(i)'s run) bit for bit, and K1 must run on a stream of
    its own."""
    import tempfile
    from repro_torch.api import Experiment
    from repro_torch.obs import trace

    with tempfile.TemporaryDirectory() as d:
        def window(event):
            if event.round == 1:
                trace.arm(profile_dir=d)
            elif event.round == 2:
                trace.disarm()
                event.request_stop()
        spec = pipelined_spec(quickstart_spec(STALE_ROUNDS), 1)
        reset_all_launches()
        t0 = time.perf_counter()
        try:
            res = Experiment(spec, device="cuda").run(observers=[window])
        finally:
            trace.disarm()
        wall = time.perf_counter() - t0
        launches = all_launches()
        prof = stream_overlap(os.path.join(d, "trace.json"))
    problems = []
    if "error" in prof:
        problems.append(f"profile: {prof['error']}")
    elif (not prof["k1_streams"]
          or set(prof["k1_streams"]) & set(prof["train_streams"])
          or set(prof.get("fusion_streams", [])) & set(
              prof["train_streams"])):
        problems.append(f"K1 did not run beside the training on a stream "
                        f"of its own: {prof}")
    eq = {"logs_equal": logs_no_wire(res.result.logs)
          == logs_no_wire(ref["logs"][0][:2]),
          "globals_bit_equal": trees_bit_equal(res.global_params,
                                               ref["per_round"][1])}
    if not all(eq.values()):
        problems.append(f"two card runs differ over rounds 1-2: {eq}")
    steps = sum(l.distill_steps for l in res.result.logs)
    problems += check_launches(launches,
                               k_launches("ensemble_kl_bank", steps),
                               "profiled rerun")
    return {"wall_s": wall, "rounds": round_rows(group_logs(res),
                                                 res.phase_seconds),
            "launches": launches, "distill_steps": steps, "cpu_check": eq,
            "profile": prof}, problems


def staleness_path():
    """10b(i) staleness 1 on the bank (K1), 10b(ii) staleness 2 on the
    generator source (K2), and (i) again with its round 2 profiled."""
    out, problems = {}, []
    for key, spec, staleness, kernel in (
            ("10b_i", quickstart_spec(STALE_ROUNDS), 1, "ensemble_kl_bank"),
            ("10b_ii", generator_spec(STALE_ROUNDS), 2, "ensemble_kl")):
        out[key], more, run = stale_path(spec, staleness, kernel)
        problems += [f"{key}: {p}" for p in more]
        if key == "10b_i":
            ref = run
    out["10b_profile"], more = stale_profile_path(ref)
    problems += [f"10b profile: {p}" for p in more]
    return out, problems


def dist_loopback_path(sync):
    """10c: the distributed driver over 2 loopback pods, fp32 uploads, bit
    for bit against 10a's sync run."""
    spec = dist_spec(quickstart_spec(DIST_ROUNDS), n_pods=2)
    res, report, problems = run_path(spec)
    eq = against_sync(group_logs(res), res.global_params, sync)
    report.update(cpu_check=eq, dist=res.summary()["dist"])
    if not (eq["logs_equal"] and eq["globals_bit_equal"]):
        problems.append(f"loopback against sync: {eq}")
    problems += check_launches(
        report["launches"],
        k_launches("ensemble_kl_bank", report["distill_steps"]), "10c")
    return report, problems, res


def dist_tcp_path(sync):
    """10d: 2 tcp pods, subprocesses on the card, against the first rounds
    of 10a's sync run bit for bit; the pods' start-up seconds."""
    spec = dist_spec(quickstart_spec(DIST_ROUNDS), transport="tcp",
                     n_pods=2, upload_deadline_s=300.0)
    reset_all_launches()
    run = driver_run(spec)
    launches = all_launches()
    logs = run["logs"]
    eq = against_sync(logs, run["globals"], sync)
    steps = sum(l.distill_steps for l in logs[0])
    problems = check_launches(launches,
                              k_launches("ensemble_kl_bank", steps), "10d")
    if not (eq["logs_equal"] and eq["globals_bit_equal"]):
        problems.append(f"tcp against sync: {eq}")
    return {"wall_s": run["wall_s"], "launches": launches,
            "distill_steps": steps, "cpu_check": eq,
            "pod_startup_s": run["driver"].pod_startup_s,
            "rounds": round_rows(logs, run["driver"].phase_seconds)}, problems


def dist_chaos_path(fp32_bytes_up: int):
    """10e: int8 uploads under the chaos mix (corrupted frames, a quorum,
    pod 1 killed in round 1), 2 rounds on the card and on the
    CPU (:func:`held_rounds`: every wire decision equal, the re-routes
    too); the int8 uplink bytes of rounds 1-2 against 10c's fp32 ones
    (``fp32_bytes_up``)."""
    from repro_torch.api import FaultSpec
    from repro_torch.obs import trace
    spec = dataclasses.replace(
        dist_spec(quickstart_spec(PIPE_ROUNDS), wire_codec="int8",
                  n_pods=2, heartbeat_s=CHAOS_HEARTBEAT_S,
                  upload_deadline_s=CHAOS_DEADLINE_S),
        faults=FaultSpec(**CHAOS_WIRE))

    def kill_pod_1(engine):
        engine.cfg.dist.kill_pod, engine.cfg.dist.kill_after_round = 1, 1

    runs = {}
    for dev, rounds in (("cuda", spec.rounds), ("cpu", CPU_ROUNDS)):
        reset_all_launches()
        rec = trace.arm()
        try:
            runs[dev] = driver_run(dataclasses.replace(spec, rounds=rounds),
                                   dev, configure=kill_pod_1)
        finally:
            trace.disarm()
        runs[dev]["launches"] = all_launches()
        runs[dev]["rerouted"] = [s["rerouted"] for s in rec.spans
                                 if s["name"] == "wire_collect"]

    gpu, cpu = runs["cuda"], runs["cpu"]
    check, problems = held_rounds(gpu, cpu)
    rerouted = [r["rerouted"][:CPU_ROUNDS] for r in (gpu, cpu)]
    if rerouted[0] != rerouted[1] or not any(rerouted[0]):
        problems.append(f"re-routed clients per round, card {rerouted[0]} "
                        f"CPU {rerouted[1]}: the killed pod's clients must "
                        f"re-route alike")
    up = sum(l.wire_bytes_up for l in gpu["logs"][0][:CPU_ROUNDS])
    check.update(
        rerouted=rerouted,
        deadline_misses=[[l.n_deadline_misses for l in r["logs"][0]]
                         for r in (gpu, cpu)],
        pods_alive=[[l.n_pods_alive for l in r["logs"][0]]
                    for r in (gpu, cpu)],
        bytes_up_int8=up, bytes_up_fp32=fp32_bytes_up,
        uplink_reduction=fp32_bytes_up / up if up else None)
    steps = sum(l.distill_steps for l in gpu["logs"][0])
    problems += check_launches(gpu["launches"],
                               k_launches("ensemble_kl_bank", steps), "10e")
    return {"wall_s": gpu["wall_s"], "cpu_wall_s": cpu["wall_s"],
            "launches": gpu["launches"], "distill_steps": steps,
            "cpu_check": check,
            "rounds": round_rows(gpu["logs"],
                                 gpu["driver"].phase_seconds)}, problems


def dist_restart_path(ref):
    """10f: 10c's run with a wire log, interrupted by an observer after
    round 2's uploads were logged (before its snapshot), resumed from the
    round-1 snapshot: round 2 re-sends no upload, and the run equals 10c's
    bit for bit."""
    import tempfile
    from repro_torch.api import Experiment
    from repro_torch.obs.metrics import REGISTRY

    def bomb(event):
        if event.round == 2:
            raise _StopAtRound

    problems = []
    replayed = REGISTRY.counter("dist.wirelog_replayed")
    with tempfile.TemporaryDirectory() as d:
        spec = dist_spec(quickstart_spec(DIST_ROUNDS), n_pods=2,
                         wire_log=os.path.join(d, "wire.log"))
        ck = os.path.join(d, "run")
        reset_all_launches()
        t0 = time.perf_counter()
        try:
            Experiment(spec, device="cuda").run(observers=[bomb],
                                                checkpoint_dir=ck)
            problems.append("the observer did not interrupt the run")
        except _StopAtRound:
            pass
        replayed.reset()
        resumed = Experiment.resume(ck, device="cuda")
        wall = time.perf_counter() - t0
        launches = all_launches()
    logs = resumed.result.logs
    eq = same_run(group_logs(resumed), resumed.global_params,
                  group_logs(ref), ref.global_params)
    eq.update(replayed=replayed.count,
              bytes_up=[l.wire_bytes_up for l in logs])
    if not (eq["logs_equal"] and eq["globals_bit_equal"]
            and logs[0].wire_bytes_up > 0 and logs[1].wire_bytes_up == 0
            and replayed.count > 0):
        problems.append(f"restart from the wire log: {eq}")
    steps = ref.result.logs
    want = steps[0].distill_steps + 2 * steps[1].distill_steps
    problems += check_launches(launches, k_launches("ensemble_kl_bank", want),
                               "10f (interrupted run + resume)")
    return {"wall_s": wall, "launches": launches, "distill_steps": want,
            "cpu_check": eq, "rounds": []}, problems


def armed_path(ref):
    """10g: 10a's pipelined run with the flight recorder armed (spans to a
    JSONL file, metrics to a directory): bit for bit the disarmed run,
    every engine phase spanned in every round, and the registry's teacher
    forwards equal to the round logs'."""
    import tempfile
    from repro_torch.api import ObsSpec
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import load_spans
    forwards = REGISTRY.counter("core.logit_bank.teacher_forwards")
    with tempfile.TemporaryDirectory() as d:
        spec = dataclasses.replace(
            pipelined_spec(quickstart_spec(PIPE_ROUNDS), 0),
            obs=ObsSpec(trace=True, trace_path=os.path.join(d, "s.jsonl"),
                        metrics_dir=os.path.join(d, "m")))
        forwards.reset()
        res, report, problems = run_path(spec)
        spans = load_spans(os.path.join(d, "s.jsonl"))
        with open(os.path.join(d, "m", "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    eq = same_run(group_logs(res), res.global_params, group_logs(ref),
                  ref.global_params)
    logs = res.result.logs
    missing = [(name, t) for t in range(1, PIPE_ROUNDS + 1)
               for name in ("join_batches", "build_round_batches",
                            "train_clients", "aggregate", "join_fusion",
                            "evaluate_round")
               if not any(s["name"] == name and s.get("round") == t
                          for s in spans)]
    # sample_cohort and bank_build carry no round: one of each per round
    counts = {name: sum(s["name"] == name for s in spans)
              for name in ("sample_cohort", "bank_build")}
    eq.update(n_spans=len(spans), missing_spans=missing,
              unstamped_spans=counts,
              teacher_forwards_registry=forwards.count,
              teacher_forwards_logs=sum(l.teacher_forwards for l in logs),
              metrics_rounds=[m["round"] for m in metrics])
    report.update(cpu_check=eq, phase_totals=res.obs["phase_totals_s"],
                  idle_gap_s=res.obs["idle_gap_s"])
    if (not (eq["logs_equal"] and eq["globals_bit_equal"]) or missing
            or set(counts.values()) != {PIPE_ROUNDS}
            or forwards.count != eq["teacher_forwards_logs"]
            or eq["metrics_rounds"] != list(range(1, PIPE_ROUNDS + 1))):
        problems.append(f"armed against disarmed: {eq}")
    problems += check_launches(
        report["launches"],
        k_launches("ensemble_kl_bank", report["distill_steps"]), "10g")
    return report, problems


def runtime_path():
    """Path 10's sub-paths in order, each with its own launch counts."""
    out, problems = {}, []
    t0 = time.perf_counter()
    out["10a"], more, sync, pipe = pipelined_sync_path()
    problems += [f"10a: {p}" for p in more]
    sub, more = staleness_path()
    out.update(sub)
    problems += more
    out["10c"], more, loop = dist_loopback_path(sync)
    problems += [f"10c: {p}" for p in more]
    out["10d"], more = dist_tcp_path(sync)
    problems += [f"10d: {p}" for p in more]
    out["10e"], more = dist_chaos_path(out["10c"]["dist"]["bytes_up"])
    problems += [f"10e: {p}" for p in more]
    out["10f"], more = dist_restart_path(loop)
    problems += [f"10f: {p}" for p in more]
    out["10g"], more = armed_path(pipe)
    problems += [f"10g: {p}" for p in more]
    out["total_s"] = time.perf_counter() - t0
    return out, problems

def print_runtime(rep) -> None:
    """Path 10's own lines: walls, overlap, the profile, the wire."""
    a = rep["10a"]
    print(f"  path 10a pipelined (staleness 0) against sync: "
          f"{a['cpu_check']}; walls {a['wall_s']:.2f} s against "
          f"{a['sync_wall_s']:.2f} s ({PIPE_ROUNDS} rounds, engine built)")
    sync_round = sum(sum(ph.values()) for ph in a["sync_phase_s"]) / len(
        a["sync_phase_s"])
    for key in ("10b_i", "10b_ii"):
        rows = rep[key]["overlap"]
        for r in rows:
            print(f"  path {key} round {r['round']}: wall "
                  f"{r['wall_s']:.3f} s, join_fusion "
                  f"{r['join_fusion_s']:.3f} s, overlap share "
                  f"{r['overlap_share']:.3f}")
        mean = sum(r["wall_s"] for r in rows) / len(rows)
        print(f"  path {key}: {mean:.3f} s a round against sync's "
              f"{sync_round:.3f} s (10a): x{mean / sync_round:.2f}; card "
              f"vs CPU {rep[key]['cpu_check']}")
    print(f"  path 10b(i) round 2 under the profiler: "
          f"{rep['10b_profile']['profile']}")
    print(f"  path 10c wire: {rep['10c']['dist']}")
    d = rep["10d"]
    print(f"  path 10d tcp pods' start-up {d['pod_startup_s']:.2f} s; "
          f"round walls " + ", ".join(
              f"{sum(r['phase_s'].values()):.3f} s" for r in d["rounds"]))
    e = rep["10e"]["cpu_check"]
    print(f"  path 10e rounds 1-2 (steps, clients, bank, teacher forwards, "
          f"crc failures, retries, lost, fused): card {e['facts_cuda']} CPU "
          f"{e['facts_cpu']}; re-routed (card, CPU) {e['rerouted']}; "
          f"deadline misses {e['deadline_misses']}, pods alive "
          f"{e['pods_alive']} (card, CPU); globals card vs CPU per round "
          f"{e['max_abs_param_diff_per_round']}; int8 uplink of rounds 1-2 "
          f"{e['bytes_up_int8']} B against fp32 {e['bytes_up_fp32']} B: "
          f"x{e['uplink_reduction']:.2f}")
    print(f"  path 10f restart: {rep['10f']['cpu_check']}")
    g = rep["10g"]
    print(f"  path 10g phase totals (s): {g['phase_totals']}; idle gap "
          f"{g['idle_gap_s']:.3f} s", flush=True)


def cli_run(args, out_dir, env):
    """``python -m repro_torch.launch.train ARGS --out OUT_DIR`` in a
    subprocess on the card: (returncode, its summary.json or None, the
    per-round distill steps it printed, its kernel launches, its output's
    tail)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--out",
         str(out_dir)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    summary = None
    if (out_dir / "summary.json").exists():
        summary = json.loads((out_dir / "summary.json").read_text())
    steps = [int(w.split("=")[1]) for line in proc.stdout.splitlines()
             if line.startswith("[round") for w in line.split()
             if w.startswith("distill_steps=")]
    launches = next((json.loads(line.split(":", 1)[1])
                     for line in reversed(proc.stderr.splitlines())
                     if line.startswith("kernel launches:")), None)
    return {"rc": proc.returncode, "wall_s": wall, "summary": summary,
            "distill_steps": steps, "launches": launches,
            "tail": (proc.stdout[-1500:], proc.stderr[-1500:])}


def cli_path():
    """Path 11a: the train CLI on the card.  A run of the quickstart's
    flags with ``--dump-config``; its ``spec.json`` against the same flags
    compiled in this process; then, side by side, a ``--config`` replay of
    the dumped spec and a ``--resume`` of a copy of the run stopped after
    round 1 (its round-2 snapshot removed), each with a per-round log equal
    to the first run's."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch import train
    base = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = [*CLI_FLAGS, "--rounds", str(CLI_ROUNDS)]
    t0 = time.perf_counter()
    first = cli_run([*argv, "--dump-config", str(base / "dumped.json")],
                    base / "run", env)
    problems = []
    report = {"argv": argv, "first": first}
    if first["rc"] != 0 or first["summary"] is None:
        return report, [f"the CLI run failed: {first['tail']}"]
    want = train.spec_from_args(train.build_parser().parse_args(argv))
    spec_json = json.loads((base / "run" / "spec.json").read_text())
    dumped = json.loads((base / "dumped.json").read_text())
    report["spec_equal"] = spec_json == want.to_dict() == dumped
    if not report["spec_equal"]:
        problems.append("spec.json differs from the in-process spec")
    # the run stopped after round 1: its snapshots without round 2's
    shutil.copytree(base / "run" / "ckpt", base / "stopped" / "ckpt")
    shutil.rmtree(base / "stopped" / "ckpt" / "rounds" / f"{CLI_ROUNDS:05d}")
    with ThreadPoolExecutor(max_workers=2) as pool:
        replay = pool.submit(cli_run, ["--config", str(base / "dumped.json")],
                             base / "replay", env)
        resumed = pool.submit(cli_run, ["--resume", str(base / "stopped")],
                              base / "stopped", env)
        replay, resumed = replay.result(), resumed.result()
    report.update(replay=replay, resumed=resumed,
                  total_s=time.perf_counter() - t0)
    per_round = first["summary"]["per_round"]
    for name, r in (("replay", replay), ("resume", resumed)):
        if r["rc"] != 0 or r["summary"] is None:
            problems.append(f"the {name} failed: {r['tail']}")
        elif r["summary"]["per_round"] != per_round:
            problems.append(f"the {name}'s per-round log "
                            f"{r['summary']['per_round']} differs from "
                            f"{per_round}")
    # K1 once per distill step of each run (the resume runs round 2 only)
    for name, r, steps in (("first", first, sum(first["distill_steps"])),
                           ("replay", replay, sum(replay["distill_steps"])),
                           ("resume", resumed,
                            first["distill_steps"][-1])):
        got = r["launches"] or {}
        if (r["distill_steps"] and name == "resume"
                and r["distill_steps"] != first["distill_steps"][-1:]):
            problems.append(f"the resume distilled {r['distill_steps']}")
        if not steps or any(got.get(k) != steps for k in
                            ("ensemble_kl_bank_fwd", "ensemble_kl_bank_bwd")):
            problems.append(f"{name}: K1 launched {got} for {steps} distill "
                            f"steps")
    report["launches"] = first["launches"] or {}
    return report, problems


@contextlib.contextmanager
def recording_calls(name: str, recs: list):
    """While open, every call of ``core.feddf.<name>`` appends its
    arguments to ``recs``."""
    from repro_torch.core import feddf
    fn = getattr(feddf, name)

    def recording(*args, **kw):
        recs.append((args, kw))
        return fn(*args, **kw)
    setattr(feddf, name, recording)
    try:
        yield recs
    finally:
        setattr(feddf, name, fn)


def refuse_twice(fn, args, kw, groups_of) -> tuple:
    """``fn(*args, **kw)`` twice on the card after the persistent bank is
    cleared, each with its launch counts and teacher forwards from 0:
    (per fuse: decisions, teacher batch forwards, bank build seconds,
    counted forwards, distill steps, K1 launches; the two outputs)."""
    import torch
    from repro_torch.core.logit_bank import PERSISTENT_BANK, TEACHER_FORWARDS
    PERSISTENT_BANK.clear()
    facts, outs = [], []
    for _ in range(2):
        reset_all_launches()
        TEACHER_FORWARDS.reset()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        infos = [i for i in groups_of(out) if not i.get("skipped")]
        facts.append({
            "decisions": [i["bank_decision"] for i in infos],
            "teacher_batch_forwards": [i["teacher_batch_forwards"]
                                       for i in infos],
            "bank_build_s": [i["bank_build_s"] for i in infos],
            "forwards_counted": TEACHER_FORWARDS.count,
            "steps": sum(i["steps"] for i in infos),
            "launches": {k: n for k, n in all_launches().items() if n}})
        outs.append(out[0])
    return facts, outs


def reuse_problems(what, facts, outs, flat) -> list:
    first, second = facts
    problems = []
    if set(first["decisions"]) != {"bank"} or set(
            second["decisions"]) != {"bank_reused"}:
        problems.append(f"{what}: decisions {first['decisions']} then "
                        f"{second['decisions']}")
    if (second["forwards_counted"] or any(second["teacher_batch_forwards"])
            or any(second["bank_build_s"])
            or not first["forwards_counted"]):
        problems.append(f"{what}: the re-fuse forwarded teachers: {facts}")
    for f in facts:
        want = {"ensemble_kl_bank_fwd": f["steps"],
                "ensemble_kl_bank_bwd": f["steps"]}
        if not f["steps"] or f["launches"] != want:
            problems.append(f"{what}: launches {f['launches']} for "
                            f"{f['steps']} distill steps")
    if not trees_bit_equal(flat(outs[0]), flat(outs[1])):
        problems.append(f"{what}: the re-fuse's globals differ from the "
                        f"first fuse's")
    return problems


def bank_reuse_path():
    """Path 11b: one card round's uploads fused twice, through
    ``feddf_fuse_stacked`` (the quickstart) and through the heterogeneous
    fuse (path 5a's spec): the second fuse reuses the persistent bank
    (``bank_reused``, no teacher forward, no build time), its globals equal
    the first's bit for bit and K1 launches once per distill step both
    times; once the uploads are freed the cache is empty."""
    import gc
    from repro_torch.api import Experiment
    from repro_torch.core import feddf
    from repro_torch.core.logit_bank import PERSISTENT_BANK
    report, problems = {}, []
    t0 = time.perf_counter()
    for name, spec, fn_name in (
            ("homogeneous", quickstart_spec(1), "feddf_fuse_stacked"),
            ("heterogeneous", hetero_spec(1),
             "feddf_fuse_heterogeneous_stacked")):
        recs = []
        with recording_calls(fn_name, recs):
            Experiment(spec, device="cuda").run()
        if len(recs) != 1:
            problems.append(f"{name}: {len(recs)} fusions recorded")
            continue
        args, kw = recs.pop()
        hetero = fn_name != "feddf_fuse_stacked"
        facts, outs = refuse_twice(
            getattr(feddf, fn_name), args, kw,
            (lambda out: out[1]) if hetero else (lambda out: [out[1]]))
        flat = ((lambda ps: [p for p in ps if p is not None]) if hetero
                else (lambda p: [p]))
        problems += reuse_problems(name, facts, outs, flat)
        del args, kw, outs
        gc.collect()
        report[name] = {"fuses": facts,
                        "cache_empty_after_free":
                            PERSISTENT_BANK._bank is None}
        if PERSISTENT_BANK._bank is not None:
            problems.append(f"{name}: the cache outlived the uploads")
    launches = {}
    for r in report.values():
        for f in r["fuses"]:
            for k, n in f["launches"].items():
                launches[k] = launches.get(k, 0) + n
    report.update(launches=launches, total_s=time.perf_counter() - t0)
    return report, problems


def gqa_serve_path(device, arch: str, k4_per_prefill: int):
    """Path 12: ``arch`` served at full width and depth on the card
    (``repro_torch.launch.serve.serve``) at path 4's batch, prompt and
    generated tokens from random fp32 weights drawn on the card from seed
    0; K4 per prefill and none in decode; a profiled prefill; forward
    against prefill + 2 forced decode steps at full depth (batch 1), and
    GQA_CPU_LAYERS layers at full width card against CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                    device=device)
    torch.cuda.synchronize()
    toks = torch.randint(0, cfg.vocab_size,
                         (SERVE_BATCH, SERVE_PROMPT + 2),
                         generator=torch.Generator().manual_seed(0))
    prompts = toks[:, :SERVE_PROMPT]
    report = {"arch": cfg.name, "batch": SERVE_BATCH,
              "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
              "params_stored": sum(x.numel() for x in tree_leaves(params)),
              "weights_bytes": sum(x.numel() * x.element_size()
                                   for x in tree_leaves(params)),
              "init_s": time.perf_counter() - t0}
    problems = []
    want = {"swa_attn": k4_per_prefill}

    # one prefill alone: its launches
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
    decode_launches = {k: launches[k] - prefill_launches.get(k, 0)
                       for k in launches}
    report.update(
        launches=launches, prefill_launches=prefill_launches,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        decode_launches=decode_launches, prefill_s=res.prefill_s,
        decode_s=res.decode_s, decode_tokens_per_s=res.decode_tokens_per_s,
        tokens=res.tokens[:, :8].tolist())
    if prefill_launches != want or {k: n for k, n in launches.items()
                                    if n} != want:
        problems.append(f"prefill launched {prefill_launches} and serve "
                        f"{launches}, expected {want} per prefill")
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
                                           ("swa_attn", "gemm"))
    del prof

    # (a) full depth: forward(prompt + 2) against prefill + two forced
    # decode steps, batch 1; gemma3's prompt outgrows its 1024 window, so
    # its local caches roll and decode on the ring
    with torch.no_grad():
        dev_toks = toks[:GQA_CHECK_BATCH].to(device)
        full = T.forward(params, cfg, {"tokens": dev_toks})
        pre, caches = T.prefill(params, cfg,
                                {"tokens": dev_toks[:, :SERVE_PROMPT]},
                                max_seq=SERVE_PROMPT + 2)
        scale = float(full.abs().max())
        err_p = float((pre - full[:, :SERVE_PROMPT]).abs().max())
        del pre
        err_d = []
        for i in range(2):
            dec, caches = T.decode_step(
                params, cfg,
                {"tokens": dev_toks[:, SERVE_PROMPT + i:
                                    SERVE_PROMPT + i + 1]},
                caches, SERVE_PROMPT + i)
            err_d.append(float((dec[:, 0] - full[:, SERVE_PROMPT + i])
                               .abs().max()))
        del full, caches
    check_a = {"batch": GQA_CHECK_BATCH, "max_abs_logit": scale,
               "atol": GQA_REL_ATOL * scale, "prefill_err": err_p,
               "decode_err": err_d}
    report["check_a"] = check_a
    if max(err_p, *err_d) > check_a["atol"]:
        problems.append(f"check (a) full depth: {check_a}")
    del params
    torch.cuda.empty_cache()

    # (b) GQA_CPU_LAYERS layers at full width: the card (kernels) against
    # the CPU (plain versions) from the same weights, drawn on the card
    small = dataclasses.replace(cfg, n_layers=GQA_CPU_LAYERS)
    p_dev = T.init(small, torch.Generator(device=device).manual_seed(1),
                   device=device)
    p_cpu = tree_map(lambda x: x.cpu(), p_dev)
    stoks = torch.randint(0, cfg.vocab_size,
                          (1, GQA_CPU_PROMPT + GQA_CPU_STEPS),
                          generator=torch.Generator().manual_seed(2))
    runs = {}
    for name, dev, p in (("cuda", device, p_dev),
                         ("cpu", torch.device("cpu"), p_cpu)):
        reset_all_launches()
        with torch.no_grad():
            t = stoks.to(dev)
            lg, caches = T.prefill(p, small,
                                   {"tokens": t[:, :GQA_CPU_PROMPT]},
                                   max_seq=GQA_CPU_PROMPT + GQA_CPU_STEPS,
                                   last_only=True)
            steps = [lg.cpu()]
            for i in range(GQA_CPU_STEPS):
                d, caches = T.decode_step(
                    p, small, {"tokens": t[:, GQA_CPU_PROMPT + i:
                                           GQA_CPU_PROMPT + i + 1]},
                    caches, GQA_CPU_PROMPT + i)
                steps.append(d.cpu())
        runs[name] = (torch.cat(steps, dim=1),
                      {k: n for k, n in all_launches().items() if n})
        del caches
    del p_dev, p_cpu
    torch.cuda.empty_cache()
    scale_b = float(runs["cpu"][0].abs().max())
    check_b = {"layers": GQA_CPU_LAYERS, "prompt": GQA_CPU_PROMPT,
               "steps": GQA_CPU_STEPS, "max_abs_logit": scale_b,
               "atol": GQA_REL_ATOL * scale_b,
               "err": float((runs["cuda"][0] - runs["cpu"][0]).abs().max()),
               "launches_cuda": runs["cuda"][1],
               "launches_cpu": runs["cpu"][1]}
    report["check_b"] = check_b
    if (check_b["err"] > check_b["atol"]
            or runs["cuda"][1] != {"swa_attn": GQA_CPU_LAYERS}
            or runs["cpu"][1]):
        problems.append(f"check (b) card vs CPU: {check_b}")
    return report, problems


def print_path11(name, rep) -> None:
    if name == "path11a_cli":
        for run in ("first", "replay", "resumed"):
            r = rep.get(run)
            if r is None:
                continue
            print(f"  {name} {run}: rc {r['rc']}, {r['wall_s']:.1f} s, "
                  f"per-round test_acc "
                  f"{(r['summary'] or {}).get('per_round')}, distill steps "
                  f"{r['distill_steps']}, launches "
                  f"{ {k: n for k, n in (r['launches'] or {}).items() if n} }")
        print(f"  {name}: spec.json equals the in-process spec: "
              f"{rep.get('spec_equal')}; whole path {rep['total_s']:.1f} s",
              flush=True)
        return
    for what in ("homogeneous", "heterogeneous"):
        if what in rep:
            print(f"  {name} {what}: {rep[what]}")
    print(f"  {name}: launches {rep['launches']}; whole path "
          f"{rep['total_s']:.1f} s", flush=True)


def print_path12(name, rep) -> None:
    print(f"  {name} {rep['arch']} batch {rep['batch']} prompt "
          f"{rep['prompt']} gen {rep['gen']}: {rep['params_stored']} "
          f"parameters ({rep['weights_bytes'] / 1e9:.1f} GB), init "
          f"{rep['init_s']:.1f} s, prefill {rep['prefill_s']:.3f} s, decode "
          f"{rep['decode_s']:.3f} s ({rep['decode_tokens_per_s']:.1f} "
          f"tok/s), peak {rep['peak_mem_bytes'] / 2**30:.2f} GiB; launches "
          f"prefill {rep['prefill_launches']} decode "
          f"{ {k: n for k, n in rep['decode_launches'].items() if n} }; "
          f"whole path {rep['total_s']:.1f} s")
    print(f"  {name} prefill on the card, from a profiler trace: "
          f"{rep['prefill_device']}")
    print(f"  {name} check (a) full depth: {rep['check_a']}")
    print(f"  {name} check (b) card vs CPU: {rep['check_b']}", flush=True)


def print_path(name, rep) -> None:
    for r in rep["rounds"]:
        ph = " ".join(f"{k}={v:.3f}s" for k, v in r["phase_s"].items())
        for g, l in enumerate(r["groups"]):
            pre, ens = l["pre_distill_acc"], l["ensemble_acc"]
            grp = f" group {g}" if len(r["groups"]) > 1 else ""
            print(f"  {name} round {r['round']}{grp}: "
                  f"test_acc={l['test_acc']:.4f} "
                  f"pre_distill={'-' if pre is None else f'{pre:.4f}'} "
                  f"ensemble={'-' if ens is None else f'{ens:.4f}'} "
                  f"clients={l['n_participants']} "
                  f"dropped={l['n_dropped']} "
                  f"distill_steps={l['distill_steps']} bank={l['bank']} "
                  f"teacher_forwards={l['teacher_forwards']} "
                  f"staleness={l['staleness_hist']}" + (
                      f" faults=(corrupted {l['n_corrupted']}, quarantined "
                      f"{l['n_quarantined']}, retries {l['n_retries']}, "
                      f"filtered {l['n_teachers_filtered']}, fused "
                      f"{l['fused']}, rolled back {l['rolled_back']})"
                      if l["n_corrupted"] or l["n_quarantined"]
                      or not l["fused"] or l["rolled_back"] else ""))
        # a pipelined round's aggregate overlaps the driver thread's
        # phases, of which the round's wall is the sum
        wall = sum(v for k, v in r["phase_s"].items()
                   if k != "aggregate" or "join_fusion" not in r["phase_s"])
        print(f"  {name} round {r['round']}: wall {wall:.3f} s: {ph}")
    used = {k: n for k, n in rep["launches"].items() if n}
    print(f"  {name}: wall {rep['wall_s']:.1f} s; launches {used} for "
          f"{rep['distill_steps']} distill steps; card vs CPU: "
          f"{rep['cpu_check']}", flush=True)
    if "server_rule" in rep:
        print(f"  {name}: server rule, card vs CPU on the same uploads: "
              f"{rep['server_rule']}", flush=True)
    if "same_uploads" in rep:
        print(f"  {name}: card vs CPU on the card's uploads: "
              f"{rep['same_uploads']}", flush=True)


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
    # K1: the lane-group, block and cluster forward and the backward at both
    # index widths, for each of the four bank dtypes (20), spill nothing
    report["k1_ptxas"] = ptxas_usage(libs["ensemble_kl_bank"].log)
    k1_spills = {n: u for n, u in report["k1_ptxas"].items()
                 if u.get("spill_stores") != 0 or u.get("spill_loads") != 0}
    spill_bytes = sum(u.get("spill_stores", 0) + u.get("spill_loads", 0)
                      for u in report["k1_ptxas"].values())
    print(f"  ensemble_kl_bank: {len(report['k1_ptxas'])} kernels, registers "
          f"{sorted(u.get('registers') for u in report['k1_ptxas'].values())}"
          f", spill bytes {spill_bytes}", flush=True)
    if len(report["k1_ptxas"]) != K1_KERNELS or k1_spills:
        build_problems.append(f"ensemble_kl_bank's {K1_KERNELS} kernels spill "
                              f"or are missing: {report['k1_ptxas']}")
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
              f"T={e['T']} mode {e['mode']}: fwd {e['fwd_err']:.2e} (tol "
              f"{e['fwd_tol']:.1e}) bwd {e['bwd_err']:.2e} (tol "
              f"{e['bwd_tol']:.1e}) two launches "
              f"{'equal' if e['repeat_equal'] else 'DIFFER'} "
              f"{'ok' if e['ok'] else 'FAIL'}")
    k1_modes = k1_mode_phase(device)
    k1_grids = k1_bwd_grid_phase(device)
    k1_poison = k1_poison_phase(device)
    report.update(k1_modes=k1_modes, k1_bwd_grids=k1_grids,
                  k1_poison=k1_poison)
    for r in k1_modes:
        print(f"  modes K1 B={r['B']} N={r['N']} V={r['V']} (f32, device us, "
              f"plan *): " + "  ".join(
                  f"{name}{'*' if name == r['plan'] else ''} {us:.2f}"
                  for name, us in r["us"].items())
              + ("" if r["ok"] else "  FAIL: a mode differs from plain"))
    for r in k1_grids:
        print(f"  backward grids K1 B={r['B']} N={r['N']} V={r['V']} (f32, "
              f"device us): " + "  ".join(
                  f"{name} {us:.2f}" for name, us in r["us"].items())
              + ("" if r["ok"] else "  FAIL: a grid differs from plain"))
    for e in k1_poison:
        print(f"  poison K1 B={e['B']} N={e['N']} V={e['V']} {e['bank']:9s} "
              f"mode {e['mode']}: rows 2, 5 NaN, the rest unchanged "
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
                f"K1 B={r['B']} N={r['N']} V={r['V']} {r['bank']} mode "
                f"{r['mode']}")
        print(f"  time {what}: " + "; ".join(parts))
    nonfinite = nonfinite_phase(device)
    report["nonfinite_rows"] = nonfinite
    for e in nonfinite:
        print(f"  non-finite rows {e['kernel']} B={e['B']} V={e['V']} "
              f"{e['dtype']:9s} mode {e['mode']}: loss non-finite in rows "
              f"{e['nonfinite_rows']} (plain {e['plain_nonfinite_rows']}), "
              f"gradient in rows {e['grad_nonfinite_rows']} (plain "
              f"{e['plain_grad_nonfinite_rows']}); elsewhere fwd "
              f"{e['fwd_err']:.2e} bwd {e['bwd_err']:.2e}; two launches "
              f"{'equal' if e['repeat_equal'] else 'DIFFER'} "
              f"{'ok' if e['ok'] else 'FAIL'}")
    k4_timings, k4_errors = k4_phase(device)
    k5_timings, k5_errors = k5_phase(device)
    report.update(k4_errors=k4_errors, k4_timings=k4_timings,
                  k5_errors=k5_errors, k5_timings=k5_timings)
    for e in k4_errors:
        print(f"  check swa_attn B={e['B']} H={e['H']} H_kv={e['H_kv']} "
              f"S={e['S']} D={e['D']} window={e['window']} {e['dtype']:8s}: "
              f"max abs err {e['max_abs_err']:.2e}, excess over the bound "
              f"{e['excess']:.2e} (rtol {e['rtol']:.0e} atol "
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
                             ("B", "H", "H_kv", "S", "D", "window", "dtype",
                              "P", "N") if k in r)
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
        errors + k1_modes + k1_grids + k1_poison + k2_errors + nonfinite
        + k4_errors + k5_errors if not e["ok"]]

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
    for name, fn in (("path5a_hetero_bank", hetero_bank_path),
                     ("path5b_hetero_fly", hetero_fly_path),
                     ("path6_baselines", baselines_path),
                     ("path7_ablations", ablations_path)):
        t0 = time.perf_counter()
        rep, path_problems = fn()
        rep["total_s"] = time.perf_counter() - t0
        paths[name] = rep
        problems += [f"{name}: {p}" for p in path_problems]
        subs = ({name: rep} if name in ("path5a_hetero_bank",
                                        "path5b_hetero_fly") else
                {f"{name} {k}": v for k, v in rep.items() if k != "total_s"})
        if "fedavg" in rep:
            subs[f"{name} fedavg"] = rep["fedavg"]
        for sub, r in subs.items():
            print_path(sub, r)
        print(f"  {name}: whole path {rep['total_s']:.1f} s", flush=True)
    for name, fn in (("path8a_buffered_hetero", buffered_hetero_path),
                     ("path8b_bucketing", bucketing_path),
                     ("path8c_tokens", tokens_path)):
        t0 = time.perf_counter()
        rep, path_problems = fn()
        rep["total_s"] = time.perf_counter() - t0
        paths[name] = rep
        problems += [f"{name}: {p}" for p in path_problems]
        subs = ({f"{name} {k}": v for k, v in rep.items() if k != "total_s"}
                if name == "path8b_bucketing" else {name: rep})
        for sub, r in subs.items():
            print_path(sub, r)
        print(f"  {name}: whole path {rep['total_s']:.1f} s", flush=True)
    for name, fn in (("path9a_defended", defended_path),
                     ("path9b_undefended", undefended_path),
                     ("path9c_robust_rules", robust_rules_path),
                     ("path9d_buffered_faults", buffered_faults_path),
                     ("path9e_resume", resume_path)):
        t0 = time.perf_counter()
        rep, path_problems = fn()
        rep["total_s"] = time.perf_counter() - t0
        paths[name] = rep
        problems += [f"{name}: {p}" for p in path_problems]
        subs = ({f"{name} {k}": v for k, v in rep.items() if k != "total_s"}
                if name == "path9c_robust_rules" else {name: rep})
        for sub, r in subs.items():
            print_path(sub, r)
        print(f"  {name}: whole path {rep['total_s']:.1f} s", flush=True)
    t0 = time.perf_counter()
    rep, path_problems = runtime_path()
    paths["path10_runtime"] = rep
    problems += [f"path10_runtime: {p}" for p in path_problems]
    for sub, r in rep.items():
        if sub != "total_s":
            print_path(f"path10 {sub}", r)
    print_runtime(rep)
    print(f"  path10_runtime: whole path {rep['total_s']:.1f} s", flush=True)
    for name, fn in (("path11a_cli", cli_path),
                     ("path11b_bank_reuse", bank_reuse_path)):
        t0 = time.perf_counter()
        rep, path_problems = fn()
        rep["total_s"] = time.perf_counter() - t0
        paths[name] = rep
        problems += [f"{name}: {p}" for p in path_problems]
        print_path11(name, rep)
    print(f"  path 9a fault kinds (wave, client, kinds): "
          f"{paths['path9a_defended']['kinds']}; kept teachers "
          f"{paths['path9a_defended']['kept']}")
    print(f"  path 9a screen per call, (z nearest sigma, z of the largest "
          f"delta norm): {paths['path9a_defended']['screen_z_cuda']}")
    for what in ("screen", "filter"):
        print(f"  path 9a smallest |z - sigma| of the {what} per call: card "
              f"{paths['path9a_defended'][f'{what}_margin_cuda']} CPU "
              f"{paths['path9a_defended'][f'{what}_margin_cpu']}")
    print(f"  path 9b fault kinds {paths['path9b_undefended']['kinds']}; banks "
          f"(rows, non-finite rows) {paths['path9b_undefended']['banks_rows_nonfinite']}"
          f"; guard stopped the fusion after "
          f"{paths['path9b_undefended']['guard_chunk_steps']} steps")
    for name in ("trimmed_mean", "coordinate_median"):
        print(f"  path 9c {name} rule alone, card vs CPU on the card's "
              f"uploads: {paths['path9c_robust_rules'][name]['rule_alone']}")
    print(f"  path 9d faults per round {paths['path9d_buffered_faults']['faults']}"
          f"; partial fuses {paths['path9d_buffered_faults']['partial_fuses']}, "
          f"skipped rounds {paths['path9d_buffered_faults']['skipped_rounds']}")
    print(f"  path 9e resumed bit for bit: "
          f"{paths['path9e_resume']['cpu_check']['bit_equal']}", flush=True)
    print(f"  path 8a staleness per group and round: "
          f"{paths['path8a_buffered_hetero']['staleness_hist_per_group']}")
    print(f"  path 8b(i) step buckets: "
          f"{paths['path8b_bucketing']['8bi_step_buckets']['bucketing']}")
    print(f"  path 8b(ii) K1 (B, V): "
          f"{paths['path8b_bucketing']['8bii_distill_buckets']['k1_shapes']}")
    print(f"  path 8c round 1 on the card, from a profiler trace: "
          f"{paths['path8c_tokens']['round1_device']}", flush=True)
    print(f"  path 5a round 1 on the card, from a profiler trace: "
          f"{paths['path5a_hetero_bank']['round1_device']}")
    abl = paths["path7_ablations"]
    print(f"  path 7a drops per round: {abl['7a_dropworst']['n_dropped']}; "
          f"path 7b uplink bytes per client: "
          f"{abl['7b_lowbit']['comm_bytes']}")
    print(f"  path 7d round 1 on the card, from a profiler trace: "
          f"{abl['7d_swag_bank']['round1_device']}", flush=True)
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
    for arch, k4_per_prefill in GQA_SERVE:
        name = f"path12_{arch}"
        t0 = time.perf_counter()
        rep, path_problems = gqa_serve_path(device, arch, k4_per_prefill)
        rep["total_s"] = time.perf_counter() - t0
        paths[name] = rep
        problems += [f"{name}: {p}" for p in path_problems]
        print_path12(name, rep)

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
    def path7_launches(name):
        """Each path 7 sub-path's launches of ``name``."""
        return {sub[:2]: r["launches"].get(name, 0)
                for sub, r in paths["path7_ablations"].items()
                if sub != "total_s"}

    def path9_launches(name):
        """Each path 9 sub-path's launches of ``name``."""
        c = paths["path9c_robust_rules"]
        return {"9a": paths["path9a_defended"]["launches"].get(name, 0),
                "9b": paths["path9b_undefended"]["launches"].get(name, 0),
                "9c": sum(c[k]["launches"].get(name, 0)
                          for k in ("trimmed_mean", "coordinate_median")),
                "9d": paths["path9d_buffered_faults"]["launches"].get(
                    name, 0),
                "9e": paths["path9e_resume"]["launches"].get(name, 0)}

    def path10_launches(name):
        """Each path 10 sub-path's launches of ``name``."""
        return {sub: r["launches"].get(name, 0)
                for sub, r in paths["path10_runtime"].items()
                if sub != "total_s"}

    def path11_launches(name):
        """Path 11's launches of ``name``: the CLI's first run (its own
        count, printed on its standard error) and the two re-fuses."""
        return {"11a": paths["path11a_cli"]["launches"].get(name, 0),
                "11b": paths["path11b_bank_reuse"]["launches"].get(name, 0)}

    def path12_launches(name):
        """Each path 12 model's launches of ``name`` while serving."""
        return {arch: paths[f"path12_{arch}"]["launches"].get(name, 0)
                for arch, _ in GQA_SERVE}

    def path8_launches(name):
        """Each path 8 sub-path's launches of ``name``."""
        b = paths["path8b_bucketing"]
        return {"8a": paths["path8a_buffered_hetero"]["launches"].get(name,
                                                                        0),
                "8bi": b["8bi_step_buckets"]["launches"].get(name, 0),
                "8bii": b["8bii_distill_buckets"]["launches"].get(name, 0),
                "8c": paths["path8c_tokens"]["launches"].get(name, 0)}
    kernels = []
    for base, path, source, lines, t, errs in entries:
        for i, kind in enumerate(("fwd", "bwd")):
            name = f"{base}_{kind}"
            kernels.append({
                "name": name, "route": "cuda", "source": src + source,
                "replaces": pallas + lines[i],
                "launches": paths[path]["launches"][name],
                "path7_launches": path7_launches(name),
                "path8_launches": path8_launches(name),
                "path9_launches": path9_launches(name),
                "path10_launches": path10_launches(name),
                "path11_launches": path11_launches(name),
                "path12_launches": path12_launches(name),
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
            "path7_launches": path7_launches(name),
            "path8_launches": path8_launches(name),
            "path9_launches": path9_launches(name),
            "path10_launches": path10_launches(name),
            "path11_launches": path11_launches(name),
            "path12_launches": path12_launches(name),
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
