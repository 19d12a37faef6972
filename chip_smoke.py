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
   instantiation to zero spills; K2 over one vocabulary shard (K2s, its
   rows' statistics unfinished) at path 17's shards (zamba2's and
   qwen3-8b's vocabularies over two ranks, and 3 of 6 classes), f32 and
   bf16 teachers: the rows it finishes to against its plain version, a
   row set split into 2 and 4 column chunks, merged, against whole K2f
   and K2b, two launches equal bit for bit, each shard timed against its
   byte bound; K4 (causal / sliding-window attention) at
   the serve path's shape, gemma3's local width, D = 80, D = 128 with a
   window, two ragged shapes and, with key / value heads grouped under the
   query heads, D = 256 without a window over 4096 keys, path 12's qwen3-8b
   and gemma3-4b layers and a ragged grouped shape, and bidirectional at
   hubert-xlarge's layer, a ragged grouped shape and a one-sided window,
   float32 and bfloat16, beside ``scaled_dot_product_attention`` (timed
   only), after checking that its library holds tensor-core (HMMA)
   instructions and that none of its 12 instantiations spills registers;
   K5 (Mamba2 SSD scan, y and final state) at the serve path's shape,
   mamba2-2.7b's width and two ragged shapes in float32, at the serve
   path's shape and one ragged shape in bfloat16, and from a nonzero
   initial state at the serve path's shape and a ragged one, after
   checking that its library holds tensor-core (HMMA) instructions and
   that its float32 N = P = 64 instantiation (the serve path's) spills no
   registers; then one zamba2-1.2b mamba layer at full width, a 2000-token
   prompt split 1000 + 1000 through ``init_cache`` against the whole;
4. drives eighteen paths on the card, with every launch count set to 0 just
   before a path and read just after it.  Paths 1-3 go through
   ``Experiment(spec).run()`` at the quickstart's published widths, 1
   round each for paths 1 and 2, 2 for path 3:
   - path 1, the FedDF quickstart (``unlabeled`` pool, logit bank): every
     round uses the bank and K1 launches once per distill step;
   - path 2, the paper's Fig. 5 ``generator`` source (no pool): every
     round distils on the fly and K2 launches once per distill step;
   - path 3, the ``buffered_async`` driver with staleness 1 and the
     ``noise`` source under traffic latency: stale uploads reach fusion,
     which takes the weighted consensus, so K2 + K3 launch once per
     distill step with K3 launching;
   and each checks that the globals are finite, then runs its first
   rounds on the CPU (plain versions) from the same seed and compares
   them with the card's (path 1 with a profiled card rerun, which must
   repeat the first run).  Path 4 serves zamba2-1.2b at full width and depth
   through ``repro_torch.launch.serve.serve`` (batch 4, a 2000-token
   prompt, 32 tokens): K4 launches 5 and K5 33 times in the prefill and
   neither in decode; it profiles one prefill, checks forward against
   prefill + 2 forced decode steps at full depth on the card, and 10
   layers at full width on the card against the CPU.  Paths 5-6 go
   through ``Experiment(spec).run()`` too, and compare every prototype
   group with a CPU run at paths 1-2's bounds:
   - path 5a, heterogeneous FedDF (the paper's Algorithm 3) on
     ``examples/heterogeneous_fusion.py``'s spec at its published widths
     (three mlp prototypes, 9 clients), 1 round: every fused group uses
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
     and decode on the ring) and the served model's first 2 layers card
     against CPU (the CPU's 1-ulp spread beside), both within 1e-3 of the
     largest logit;
   - path 13, after path 12, the MoE and frontend models at full width and
     depth (random fp32 weights drawn on the card from seed 0): 13a
     granite-moe-1b-a400m served at path 12's traffic (K4 24 per prefill,
     none in decode), the slots each ``_moe_capacity`` call drops
     recorded and printed, check (a) on its first 2 layers at batch 1
     (decode through ``_moe_gather``) and batch 4 (through
     ``_moe_capacity``), each at the published capacity factor (held only
     where no slot dropped: the drop order differs between forward's 2002
     tokens and prefill's 2000 in the reference itself) and at E / k = 4
     (no slot can drop; always held), and at full depth reported beside
     the model's own 1-ulp spread (chaotic under the reference init:
     ``chip_probe_conditioning.py``), check (b) with the differing expert
     choices counted; 13b internvl2-1b served with 256 patch embeddings
     ahead of each prompt (K4 24), path 12's checks; 13c hubert-xlarge,
     encoder-only: one forward over 4 x 2000 frames (K4 48,
     bidirectional), timed, profiled, its peak memory, and its first 2
     layers card against CPU within 1e-3 of the largest logit;
   - path 14, after path 13, the step builders (``repro_torch.launch.steps``)
     on zamba2-1.2b at full width and depth with bf16 parameters: 14a
     ``make_train_step`` at batch 4 x 4096, 2 microbatches, remat, 3 steps
     (K4 20 and K5 132 a step, in bf16; every parameter leaf's gradient
     finite and non-zero; each step's loss, wall and device time, peak
     memory and ``train_step_mfu``); 14b ``make_distill_step`` with 4
     teachers at batch 8 x 512 (K2 forward and backward at (4, 4096,
     32000) with bf16 teachers, held against its plain version on the card
     and timed against its byte bound); 14c ``make_fed_round_step`` at
     JAX's defaults (8 clients, 4 local steps); 14d ``make_prefill_step``
     + ``make_serve_step`` in bf16 with bf16 caches at path 4's traffic
     (K4 5 and K5 33 per prefill, none in decode), its logits against the
     port's own f32 prefill; 14e the analytic dry run over every (arch,
     shape) pair; 14a-14c each hold one float32 step of the served model's
     first 7 layers card against CPU (the loss within 1e-5, the gradients
     within 4x the CPU's 1-ulp spread; 14c the updates of a 1-client,
     2-step round within 4x 14a's spread plus one float32 rounding a
     step);
   - path 15, after path 14, the client axis over a ``torch.distributed``
     mesh (``repro_torch.launch.mesh``): 15a the quickstart spec with
     ``sharding.shard_clients`` through the ``multihost`` driver on 4
     ranks sharing the card (gloo, the collectives staged through host
     memory; NCCL, one rank per card, where there are 4 cards) and on 1
     rank over NCCL, against the same spec through ``sync`` in this
     process (1 rank bit for bit; 4 ranks the same cohorts, steps, bank,
     teacher forwards and accuracy, uploads within 1e-5 of the largest,
     globals within 1e-3, the ranks' globals bit for bit, K1 on every
     rank); 15b path 5a's heterogeneous spec on 4 ranks, its client caps
     padded to 4, the padded lanes returned untouched; 15c
     ``drive_fed_rounds`` on zamba2-1.2b at full width and depth in bf16
     (8 clients x 4 steps of 8 x 512, 1 round) on 2 ranks, every upload
     bit for bit (digests) and the mean within one bf16 ulp of the
     unsharded round's, K4 and K5 on every rank; each rank is a process
     of its own (``launch_ranks``), its launches counted in it;
   - path 16, after path 15, the model axis of a mesh: tensor parallelism
     over ``"model"`` (K4 and K5 at each rank's heads), FSDP over
     ``"data"``, the expert-parallel MoE.  16a the train step on a 1 x 2
     mesh (zamba2-1.2b's first 7 layers in float32 against the unsharded
     step, the loss within 1e-5 and the gradients gathered within 4x its
     1-ulp spread; one bf16 step at full depth, 2 x 4096 tokens in 2
     microbatches, every gradient block finite and non-zero, in a world
     of its own after 16b's); 16b the 7-layer check on a 2 x 2 mesh,
     its world beside 16a's; 16c prefills on 1 x 2 at path 4's
     traffic (zamba2-1.2b timed at
     full depth, its first 2 layers' logits within 1e-3 of the largest
     against the unsharded; granite-moe-1b-a400m expert-parallel, each
     layer's dropped slots equal to one device's on the same choices);
     16d ``drive_fed_rounds`` on ``make_host_mesh(1, 2)`` (the 7-layer
     round's uploads and mean within 14c's bound of the unsharded round's;
     a bf16 round at full depth, the ranks' gathered globals equal by
     digest); each rank's collectives (calls, bytes, seconds per axis) and
     launches printed;
   - path 17, after path 16, the distill and serve steps on a mesh, 2
     ranks sharing the card as 16a's: 17k the distill loss at each K2s
     shard two ways over the model axis (K2s and the merged statistics,
     which the port runs; the logits all-gathered and whole K2f), timed;
     17a ``make_distill_step`` on 1 x 2 with 4 teachers (zamba2-1.2b's
     first 7 layers in f32 at 2 x 512 against the unsharded
     ``distill_grads``: the loss within 1e-6, the gathered gradients
     within 4x its 1-ulp spread, Adam on the blocks equal to Adam on
     the gathered gradients; one bf16 step at full depth, K2s and K2b
     once a rank); 17b a sharded f32 prefill at path 4's batch and
     prompt, ``T.serve_caches`` into JAX's ``kv_cache_rules`` layout and
     8 decode tokens through ``make_serve_step`` across the sequence
     shards' boundary, zamba2-1.2b's and qwen3-8b's first 2 layers each
     token within 1e-3 of the largest logit against the unsharded
     ``prefill`` + ``decode_step``; zamba2-1.2b at full depth in bf16, 16
     tokens, its tokens/s and cache bytes a rank; 17c the zamba2 check on
     a 2 x 1 mesh at batch 1 (the batch released, the sequence over both
     axes);
   - path 18, after path 17, JAX's other step-builder layouts, 2 ranks
     sharing the card as 16a's: 18a zamba2-1.2b's first 7 layers in f32,
     a train step of 2 x 512 on 1 x 2 under ``dp_heavy`` and
     ``dp_heavy_z3`` (every leaf gathered whole where it runs, the batch
     over both axes; the gradients gathered within 4x the unsharded
     step's 1-ulp spread, the loss within 1e-6), under ``tp`` with
     ``constrain_acts`` (bit for bit the step without it) and with
     ``naive_xent`` (the loss within 1e-6 of ``token_xent``'s, the
     gradients within the same bound), and 17a's held distill step with
     ``constrain_acts`` bit for bit the one without it; 18b one bf16
     ``dp_heavy_z3`` train step at full depth, 2 x 4096 (K4 and K5 at
     every head, every gradient block finite and non-zero; its seconds,
     peak memory and collectives); 18c 17b's held serve check with the
     prefill under ``dp_heavy``;
   - path 19, its worlds beside paths 17 and 18, JAX's MoE partitioner
     path and the MoE under ``dp_heavy*`` on granite-moe-1b-a400m: 19a
     its first 2 layers at full width in f32 on a 2 x 2 world of 4 ranks
     sharing the card, at the config's capacity factor 1.25, on batches
     from two halves of the vocabulary and weights scaled to their
     fan-in and leaned so that each half's tokens take their own 8
     experts, 12 logits above the rest, which overflow (the same slots
     drop under any rounding): a train
     step of 4 x 512 under ``dp_heavy`` and ``dp_heavy_z3`` (the rows
     gathered over ``"model"``, expert-parallel per data shard) and of 2
     x 512 under ``dp_heavy`` (the model axis's ranks sharing their rows),
     a ``tp`` step with ``use_moe_shard_map=False`` (the global tokens
     and capacity), the distill step with 4 teachers at 2 x 512 (K2 over
     the whole vocabulary), a prefill at 2 x 512 and 8 tokens through
     ``make_serve_step`` (the gather route over split experts), each
     against the unsharded run of the same weights (the data shards' own
     where they route alone): losses and aux losses within 1e-6 relative
     (or 4x their 1-ulp spread where that is larger; the distill loss in
     absolute terms within 1e-6 x ln V or 4x its spread, which a bf16
     student's must miss), every leaf's gradient within 4x its own 1-ulp
     spread, logits within 1e-3 of the largest, each layer's drops (the
     teachers' too) equal up to the expert choices the last bits moved;
     19b one bf16 ``dp_heavy`` step at full depth, 2 x 4096 on 1 x 2 (16
     experts a rank, capacity 2560; every gradient block finite and
     non-zero, K4 48 a rank);
   paths 1-3 and 5-11 run in six worker processes beside each other
   (``PATH_GROUPS``; each path's launch counts in its own process), after
   step 3 and before path 4, so that the kernel and served-model timings
   are the card's alone;
   and, in step 3, K1 (every bank dtype) and K2 / K3 in each launch mode
   on rows holding a NaN, a +Inf and a -Inf teacher logit: non-finite
   exactly where the plain versions are, within tolerance elsewhere, two
   launches equal bit for bit;
5. prints one ``{"kernels": [...]}`` line (each kernel's launches on its
   path and, under ``path7_launches`` to ``path19_launches``, on each of
   paths 7's to 19's sub-paths and ranks), the card line, and as its last
   line ``{"ok": true, "device": {...}}``.

It exits non-zero, without the last line, when there is no CUDA device,
when it does not find the port next to it, or when any phase fails.
Details go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --path18    # the kernels built, path 18 alone
    python3 chip_smoke.py --path19    # the kernels built, path 19 alone
    python3 chip_smoke.py --four      # paths 18, 19 on four cards (2 x 2)

``--four`` runs 18a's held checks on a 2 x 2 mesh and one full-depth bf16
train step of phi3-medium-14b under ``dp_heavy_z3`` (its weights and
Adam moments fit no one card) and of minicpm-2b under ``dp_heavy``, 4 x
4096 tokens, then 19a's checks on 2 x 2 and 19b's step at 4 x 4096, one
NCCL rank a card; it needs four cards and prints no kernels line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
K2_KERNELS = 48   # instantiations in ensemble_kl.cu, each checked for spills
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
# prompt, and a ragged grouped shape (3 query heads a key head, D 80);
# then path 14's zamba2-1.2b attention, which runs in bfloat16 there: a
# microbatch of the train step (2 x 4096) and the distill / fed-round
# batch (8 x 512); then path 16's, at one rank's heads of a model axis of
# 2: zamba2-1.2b's train microbatch (16 heads) and granite-moe-1b-a400m's
# prefill (8 query over 4 key heads).  Against the plain version, the JAX
# package's tolerances (tests/test_kernels.py): rtol 1e-4 / atol 1e-5 in
# float32, 3e-2 in bfloat16.
K4_SHAPES = [(4, 32, 32, 2000, 64, None), (1, 8, 8, 4096, 256, 1024),
             (1, 4, 4, 300, 80, None), (2, 8, 8, 1000, 128, 256),
             (1, 2, 2, 100, 8, 24), (2, 4, 4, 128, 32, 32),
             (1, 8, 8, 4096, 256, None), (4, 32, 8, 2000, 128, None),
             (4, 8, 4, 2000, 256, 1024), (4, 8, 4, 2000, 256, None),
             (1, 6, 2, 300, 80, None), (2, 32, 32, 4096, 64, None),
             (8, 32, 32, 512, 64, None), (2, 16, 16, 4096, 64, None),
             (4, 8, 4, 2000, 64, None)]
# K4 bidirectional (the encoder's mode, path 13c), (B, H, H_kv, S, D,
# window): hubert-xlarge's layer (16 heads of D 80, the kernel's 128
# bucket, 4 x 2000 frames; first: it feeds the path-13 rows); a ragged
# grouped shape; a one-sided window (i - j < window, later keys all seen)
# over a sequence longer than it.
K4_BIDIR_SHAPES = [(4, 16, 16, 2000, 80, None), (1, 6, 2, 300, 80, None),
                   (2, 8, 8, 1000, 128, 256)]
K4_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (3e-2, 3e-2)}
K4_KERNELS = 12   # swa_attn.cu's instantiations, each held to 0 spills
# K5 (B, S, H, P, N): the serve path's Mamba2 layers (zamba2-1.2b, prompt
# 2000; first: it feeds the kernels line); mamba2-2.7b's width; two ragged
# cases of tests/test_kernels.py.  Against the plain version at the
# config's chunk (256; the kernel scans in chunks of 64), y and final
# state, rtol 1e-4 / atol 1e-5 in float32 (tests/test_kernels.py); the
# small cases also against the sequential recurrence.  bfloat16 x, B and C
# at K5_BF16_SHAPES, held at K4's bfloat16 tolerance (3e-2): the serve
# path's, a ragged one and path 14's (a train microbatch of 2 x 4096, the
# distill / fed-round batch of 8 x 512), and path 16's at one rank's 32
# heads of a model axis of 2 (the train microbatch; its float32 prefill
# in K5_SHAPES).
K5_SHAPES = [(4, 2000, 64, 64, 64), (1, 4096, 80, 64, 128),
             (1, 17, 2, 8, 4), (1, 50, 3, 8, 16), (4, 2000, 32, 64, 64)]
K5_BF16_SHAPES = [(4, 2000, 64, 64, 64), (1, 50, 3, 8, 16),
                  (2, 4096, 64, 64, 64), (8, 512, 64, 64, 64),
                  (2, 4096, 32, 64, 64)]
# K5 from a nonzero initial state (``ssm_forward(init_cache=)``), float32,
# y and final state at K5's tolerance: the serve path's shape and a ragged
# one (also against the sequential recurrence).  Then one zamba2-1.2b
# mamba layer at full width (unstacked weights from seed 0): a
# K5_SPLIT_PROMPT-token prompt of batch 4 split in two halves, the second
# through ``init_cache``, against the whole prompt at K5's tolerance.
K5_INIT_SHAPES = [(4, 2000, 64, 64, 64), (1, 50, 3, 8, 16)]
K5_SPLIT_PROMPT = 2000
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

# The quickstart main path (examples/quickstart.py at its published widths)
# and path 2, 1 round each (cut from 3 to 2, then to 1 to keep the script
# inside its time limit); paths 3 and 9d, whose second round is the first
# with stale uploads, 2 rounds (cut from 3).
QUICK_ROUNDS = 1
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
# (cut from 6 to 3, then to 2, then to 1) and on the fly (K2) for 1; path 6: the
# baselines on the quickstart spec.  Every one is held card against CPU at
# paths 1-2's bounds, every group checked.
HETERO_ROUNDS = 1
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
# logits at V = 262144), and the served model's first GQA_CPU_LAYERS
# layers card against CPU on a GQA_CPU_PROMPT-token prompt and
# GQA_CPU_STEPS forced steps, both within 1e-3 of the largest logit.
GQA_SERVE = (("qwen3-8b", 36), ("gemma3-4b", 34))
GQA_CHECK_BATCH, GQA_CPU_LAYERS, GQA_CPU_PROMPT, GQA_CPU_STEPS = 1, 2, 256, 2
GQA_REL_ATOL = 1e-3
# Path 13: the MoE and frontend configurations at full width and depth,
# path 12's traffic and checks.  13a granite-moe-1b-a400m (K4 24 per
# prefill) also records the slots each _moe_capacity call drops, holds
# check (a) at batch 1 (decode through _moe_gather) and at path 4's batch
# (decode through _moe_capacity, 2 slots an expert), at the published
# capacity factor only where no slot dropped and always at E / k (no slot
# can drop), and counts the expert choices that differ card vs CPU in
# check (b).  13b internvl2-1b (K4 24) serves 256 patch embeddings ahead of
# each prompt.  13c hubert-xlarge (K4 48, bidirectional) is encoder-only:
# one forward over 4 x 2000 frames, timed, and 2 layers card vs CPU.
# Check (b) of paths 12 and 13 takes the served model's own first layers,
# not a 2-layer init, whose stacked weights take their fan-in from a
# repeat axis of 2 (std 0.71 against the served hubert's 0.14): another,
# far worse conditioned model.  13a's check (a) is gated at the served
# model's first MOE_CHECK_LAYERS layers: under the reference init the
# served granite-moe is chaotic at depth (a 1-ulp nudge of its weights
# moves its last logits by a tenth of their scale past 8 layers and by
# more than half at 24: chip_probe_conditioning.py), so full depth is run
# and reported beside its own 1-ulp spread, not gated.
MOE_SERVE = ("granite-moe-1b-a400m", 24)
VLM_SERVE = ("internvl2-1b", 24)
AUDIO_FORWARD = ("hubert-xlarge", 48)
MOE_CHECK_BATCHES, MOE_CHECK_LAYERS = (1, SERVE_BATCH), 2
# Path 14: the step builders (repro_torch.launch.steps) on zamba2-1.2b at
# full width and depth with bf16 parameters, as the builders draw them.
# 14a make_train_step at batch 4 x 4096 (train_4k's sequence at a one-card
# batch), 2 microbatches, remat, 3 steps: per step K4 2 x (5 + 5) and K5
# 2 x (33 + 33) (forward plus the recompute); 14b make_distill_step, 4
# teachers and a student each from its own seed at batch 8 x 512 (JAX's
# 128 is a pod's global batch): K2 forward + backward at (4, 4096,
# 32000) with bf16 teachers; 14c make_fed_round_step at JAX's defaults (8
# clients, 4 local steps, batch 8 x 512, lr 3e-4); 14d make_prefill_step +
# make_serve_step with bf16 caches at path 4's traffic; 14e the analytic
# dry run over every (arch, shape) pair on the meta device.  14a-14c hold
# one float32 step of the served model's first STEP_HELD_LAYERS layers
# (one pattern repeat, the shared attention block in it) at batch 1 x
# STEP_HELD_SEQ, card (kernels) against CPU (plain versions): the loss
# within STEP_LOSS_RTOL, the gradients within STEP_SPREAD_FACTOR times the
# CPU's own 1-ulp spread (the largest per-leaf gap as a share of the
# leaf's largest gradient, as tests/test_torch_steps.py bounds the port
# against JAX; the card's own spread is reported beside it); 14b's held
# step takes STEP_DISTILL_HELD_TEACHERS teachers (the CPU runs every
# teacher forward twice); 14c holds STEP_FED_HELD's round, its updates
# (parameters after minus before) per leaf within STEP_SPREAD_FACTOR
# times 14a's CPU spread (plain SGD: an update is lr times a gradient of
# the same loss on the same layers).  14d holds bf16 against the float32
# model of the same weights, the whole prompt's logits and one decode step
# after a prefill (bf16 caches against float32 ones), within
# STEP_SPREAD_FACTOR times the float32 model's own gap under a bf16-sized
# nudge of its weights (x (1 + 2^-8 N(0, 1))), and the prompt's top-1
# disagreement within STEP_SPREAD_FACTOR times the nudged model's.  The
# random init is chaotic at depth (at 7 layers the nudge alone moves the
# logits by ~0.5 of the largest), so the gate runs where that spread is
# small: the served model's first layer (Mamba2, K5) and one shared
# attention block drawn alone (K4); a gate whose bound reaches
# STEP_SERVE_GATE_MAX of the largest logit could not fail and fails.  Full
# depth and STEP_HELD_LAYERS layers are reported, not gated.
STEP_TRAIN_BATCH, STEP_TRAIN_SEQ, STEP_MICROBATCH, STEP_TRAIN_STEPS = \
    4, 4096, 2, 3
STEP_K4, STEP_K5 = SERVE_K4, SERVE_K5      # launches per forward
STEP_HELD_LAYERS, STEP_HELD_SEQ = 7, 512
STEP_LOSS_RTOL, STEP_SPREAD_FACTOR = 1e-5, 4.0
STEP_DISTILL = dict(n_teachers=4, batch_size=8, seq_len=512)
STEP_FED = dict(n_clients=8, local_steps=4, batch_size=8, seq_len=512,
                lr=3e-4)
STEP_DISTILL_HELD_TEACHERS = 2
STEP_FED_HELD = dict(n_clients=1, local_steps=2, batch_size=1, seq_len=512)
STEP_SERVE_GATE_MAX = 0.5
# Paths 1-3 and 5-11 drive quickstart-sized specs whose rounds are bound by
# the host (the card busy 3-10%, PERF.md section 5): they run in one
# worker process per group below (``chip_smoke.py --paths INDEX OUT``),
# the groups beside each other, each path's launch counts set to 0 and
# read in its own process, as in a run alone.  The workers start after
# the kernel phases and end before the served models, whose device times
# stay the card's alone; each worker's torch takes WORKER_THREADS host
# thread (on a one-card machine's 8 cores the groups' CPU runs would
# otherwise oversubscribe them, and those small CPU runs are no faster on
# more threads).  The groups hold about equal seconds; path 10's 10b,
# which needs no other sub-path, runs in a group of its own and rejoins
# path 10's report.
PATH_GROUPS = (
    (("path1_quickstart", "main_path"), ("path2_generator", "generator_path"),
     ("path3_buffered", "buffered_path"),
     ("path5a_hetero_bank", "hetero_bank_path")),
    (("path7_ablations", "ablations_path"),
     ("path9b_undefended", "undefended_path"),
     ("path9c_robust_rules", "robust_rules_path")),
    (("path8a_buffered_hetero", "buffered_hetero_path"),
     ("path8b_bucketing", "bucketing_path"), ("path8c_tokens", "tokens_path")),
    (("path9a_defended", "defended_path"),
     ("path9d_buffered_faults", "buffered_faults_path"),
     ("path9e_resume", "resume_path"), ("path11a_cli", "cli_path"),
     ("path11b_bank_reuse", "bank_reuse_path")),
    (("path10_runtime", "runtime_path"),),
    (("path10b_staleness", "staleness_path"),
     ("path5b_hetero_fly", "hetero_fly_path"),
     ("path6_baselines", "baselines_path")),
)
WORKER_THREADS, WORKER_TIMEOUT_S = 1, 900


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


def k4_bound(b, h, s, d, window, elem, h_kv=None, causal=True) -> dict:
    """The tensor-core bound: q, k, v read and o written once (k and v at
    their ``h_kv`` heads); 4 D flops (q.k and p.v) and one exponential for
    every (query, key) pair the mask lets through (causal: keys j <= i;
    bidirectional: every key j < S; a window keeps i - j < window).
    float32 runs three TF32 passes on the tensor cores, bfloat16 one bf16
    pass.  The bound is the largest of the three times, ``bound_detail``
    names it."""
    h_kv = h if h_kv is None else h_kv
    w = s if window is None else window
    if causal:
        pairs = b * h * sum(min(i + 1, w) for i in range(s))
    else:   # query i sees keys max(0, i - w + 1) .. S - 1
        pairs = b * h * sum(s - max(0, i - w + 1) for i in range(s))
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


def k5_bound(b, s, h, p, n, elem, init_state=False) -> dict:
    """The tensor-core bound: x, dt, a_log, B, C (and the initial state)
    read and y, the final state written once; per (batch, head) and kernel
    chunk of l valid steps 4 l N P (inter-chunk output and state update) +
    l (l + 1) (N + P) (C.B
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
           + 2 * b * s * n * elem + 4 * b * h * n * p * (2 if init_state
                                                         else 1))
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
    """K4 against its plain version in float32 and bfloat16 at every shape,
    causal (K4_SHAPES) and bidirectional (K4_BIDIR_SHAPES); timings of
    kernel, plain version and the library call
    (scaled_dot_product_attention, timed only) at each shape."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_attn import swa_attn
    rows, errors = [], []
    cases = ([(shape, True) for shape in K4_SHAPES]
             + [(shape, False) for shape in K4_BIDIR_SHAPES])
    for (b, h, h_kv, s, d, w), causal in cases:
        gen = torch.Generator().manual_seed(b + h + s + d)
        qkv32 = [torch.randn(b, n, s, d, generator=gen).to(device)
                 for n in (h, h_kv, h_kv)]
        key = {"B": b, "H": h, "H_kv": h_kv, "S": s, "D": d, "window": w,
               "causal": causal}
        for dtype_name, (rtol, atol) in K4_TOL.items():
            q, k, v = (t.to(getattr(torch, dtype_name)) for t in qkv32)
            got = swa_attn(q, k, v, w, causal)
            want = ref.swa_attn(q, k, v, w, causal)
            torch.cuda.synchronize()
            err, over = excess(got, want, rtol, atol)
            ok = over <= 0 and got.dtype == q.dtype and bool(
                torch.isfinite(got.float()).all())
            errors.append({**key, "dtype": dtype_name,
                           "max_abs_err": err, "excess": over,
                           "rtol": rtol, "atol": atol, "ok": ok})
            del got, want
            if s < 1000 and dtype_name != "float32":
                continue
            with torch.no_grad():
                t_k = timed(lambda: swa_attn(q, k, v, w, causal))
                t_p = timed(lambda: ref.swa_attn(q, k, v, w, causal))
                t_l = timed(k4_library(q, k, v, w, causal))
            rows.append({**key, "dtype": dtype_name, **t_k,
                         "plain_ms": t_p["ms"], "plain_call_ms":
                         t_p["call_ms"], "library_ms": t_l["ms"],
                         "library_call_ms": t_l["call_ms"],
                         **k4_bound(b, h, s, d, w, q.element_size(), h_kv,
                                    causal)})
        del qkv32, q, k, v
        torch.cuda.empty_cache()
    return rows, errors


def k4_library(q, k, v, w, causal=True):
    """One ``scaled_dot_product_attention`` call computing K4's function
    (timed only, never used by the port): causal, bidirectional or
    windowed (through a mask), grouped heads by ``enable_gqa`` or, on a
    torch without it, by key / value heads repeated beforehand (outside the
    timed call)."""
    import torch
    import torch.nn.functional as F
    s = q.shape[2]
    kw = {"is_causal": causal}
    if w is not None:
        i = torch.arange(s, device=q.device)
        mask = i[:, None] - i[None, :] < w
        kw = {"attn_mask": (i[None, :] <= i[:, None]) & mask if causal
              else mask}
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
    float32, against the sequential recurrence at the small ones, in
    bfloat16 (x, B and C) at K5_BF16_SHAPES, and from a nonzero initial
    state at K5_INIT_SHAPES; timings of every float32 shape, of the serve
    path's shape in bfloat16 and from a state."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    cases = ([(shape, "float32", False) for shape in K5_SHAPES]
             + [(shape, "bfloat16", False) for shape in K5_BF16_SHAPES]
             + [(shape, "float32", True) for shape in K5_INIT_SHAPES])
    rows, errors = [], []
    for (b, s, h, p, n), dtype_name, from_state in cases:
        args = k5_inputs(b, s, h, p, n, device)
        if dtype_name == "bfloat16":
            for i in (0, 3, 4):     # x, B and C; dt and a_log stay float32
                args[i] = args[i].to(torch.bfloat16)
        if from_state:
            args.append(torch.randn(
                b, h, n, p, generator=torch.Generator().manual_seed(s + n)
            ).to(device))
        rtol, atol = ((K5_RTOL, K5_ATOL) if dtype_name == "float32"
                      else K4_TOL["bfloat16"])
        y, final = ssd_scan(*args)
        y_ref, final_ref = ref.ssd_scan(*args[:5], K5_CHUNK, *args[5:])
        torch.cuda.synchronize()
        err_y, over_y = excess(y, y_ref, rtol, atol)
        err_s, over_s = excess(final, final_ref, rtol, atol)
        rec = {"B": b, "S": s, "H": h, "P": p, "N": n, "dtype": dtype_name,
               "init_state": from_state,
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
                t_p = timed(lambda: ref.ssd_scan(*args[:5], K5_CHUNK,
                                                 *args[5:]))
            rows.append({"B": b, "S": s, "H": h, "P": p, "N": n,
                         "dtype": dtype_name, "init_state": from_state,
                         **t_k, "plain_ms": t_p["ms"],
                         "plain_call_ms": t_p["call_ms"], "library_ms": None,
                         **k5_bound(b, s, h, p, n, args[0].element_size(),
                                    from_state)})
        del args
        torch.cuda.empty_cache()
    return rows, errors


def ssm_split_check(device) -> dict:
    """One zamba2-1.2b mamba layer at full width on the card (unstacked
    weights from seed 0, batch 4): a K5_SPLIT_PROMPT-token prompt as two
    halves, the second through ``ssm_forward(init_cache=)`` from the first
    half's cache, against the whole prompt, at K5's tolerance; K5 launches
    once per call."""
    import torch
    from repro_torch import configs
    from repro_torch.models import ssm
    from repro_torch.models.layers import init_params
    cfg = configs.get(SERVE_ARCH)
    p = init_params(ssm.ssm_specs(cfg),
                    torch.Generator(device=device).manual_seed(0),
                    device=device)
    x = torch.randn(SERVE_BATCH, K5_SPLIT_PROMPT, cfg.d_model,
                    generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    half = K5_SPLIT_PROMPT // 2
    reset_all_launches()
    with torch.no_grad():
        whole, whole_cache = ssm.ssm_forward(p, cfg, x, return_cache=True)
        _, first = ssm.ssm_forward(p, cfg, x[:, :half], return_cache=True)
        second, cache = ssm.ssm_forward(p, cfg, x[:, half:],
                                        init_cache=first, return_cache=True)
    torch.cuda.synchronize()
    launches = {k: n for k, n in all_launches().items() if n}
    out_err, out_over = excess(second, whole[:, half:], K5_RTOL, K5_ATOL)
    st_err, st_over = excess(cache.state, whole_cache.state, K5_RTOL,
                             K5_ATOL)
    conv_err, conv_over = excess(cache.conv, whole_cache.conv, K5_RTOL,
                                 K5_ATOL)
    rec = {"arch": cfg.name, "B": SERVE_BATCH, "S": K5_SPLIT_PROMPT,
           "split": [half, K5_SPLIT_PROMPT - half], "out_err": out_err,
           "state_err": st_err, "conv_err": conv_err,
           "max_abs_out": float(whole.abs().max()),
           "rtol": K5_RTOL, "atol": K5_ATOL, "launches": launches}
    rec["ok"] = (max(out_over, st_over, conv_over) <= 0
                 and launches == {"ssd_scan": 3}
                 and bool(torch.isfinite(second).all()))
    return rec


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
        # unprofiled wall time is the device's busy share on the path.
        # Device activity only: that is all device_time reads, and host
        # ops go unrecorded
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    spec = quickstart_spec(QUICK_ROUNDS)
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
    spec = generator_spec(QUICK_ROUNDS)
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
    check, _, more = card_vs_cpu(spec, QUICK_ROUNDS, gpu=res)
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
    """Path 10's sub-paths but 10b (:func:`staleness_path`, which needs
    none of them) in order, each with its own launch counts."""
    out, problems = {}, []
    t0 = time.perf_counter()
    out["10a"], more, sync, pipe = pipelined_sync_path()
    problems += [f"10a: {p}" for p in more]
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


def frontend_inputs(cfg, batch: int, device) -> dict:
    """The patch embeddings a vision model serves ahead of its prompts
    (``fake_vision_patches`` from a CUDA generator seeded 0), else none."""
    import torch
    from repro_torch.models.frontends import fake_vision_patches
    if cfg.frontend != "vision_patches":
        return {}
    gen = torch.Generator(device=device).manual_seed(0)
    return {"patches": fake_vision_patches(gen, cfg, batch, device=device)}


@contextlib.contextmanager
def recording_moe(drops: list, routes: Optional[list] = None):
    """While open, the dispatch of every ``models.moe._moe_capacity`` call
    (``moe.dispatch``, which each makes once) appends (tokens, slots
    dropped) to ``drops``: the choices of this rank's experts that got no
    slot (every choice on one device, its experts' share under the
    expert-parallel block); with ``routes``, every ``_route`` call appends
    (expert choices, softmax gates).  All stay tensors where they were
    computed (read after the run: no synchronisation inside it)."""
    from repro_torch.models import moe
    orig_dispatch, orig_route = moe.dispatch, moe._route

    def dispatch(cfg, idx, e_start, e_local):
        dp = orig_dispatch(cfg, idx, e_start, e_local)
        mine = ((idx >= e_start) & (idx < e_start + e_local)).sum()
        drops.append((idx.shape[0], mine - dp.valid.sum()))
        return dp

    def route(p, cfg, x):
        out = orig_route(p, cfg, x)
        routes.append((out[1], (x @ p["router"]).float().softmax(-1)))
        return out
    moe.dispatch = dispatch
    if routes is not None:
        moe._route = route
    try:
        yield drops, routes
    finally:
        moe.dispatch, moe._route = orig_dispatch, orig_route


def drop_counts(drops) -> dict:
    """{"calls", "dropped", "slots"} of the recorded capacity calls."""
    return {"calls": len(drops), "dropped": sum(int(n) for _, n in drops),
            "tokens_per_call": sorted({t for t, _ in drops})}


def served_layers(params, cfg, n: int):
    """(config, parameters) of the first ``n`` layers of a served model:
    views of its own weights (layer i is repeat i // P, position i % P of
    its pattern of P blocks), laid out as ``T.param_specs`` lays out an
    ``n``-layer model (full repeats stacked, the rest in the tail)."""
    from repro_torch.common.pytree import tree_map
    p, n_full, _ = len(cfg.pattern), *divmod(cfg.n_layers, len(cfg.pattern))
    reps, rem = divmod(n, p)
    sub = dict(params)
    sub["blocks"] = tuple(tree_map(lambda x: x[:reps], b) if reps else {}
                          for b in params["blocks"])
    sub["tail"] = tuple(
        tree_map(lambda x: x[reps], params["blocks"][j]) if reps < n_full
        else params["tail"][j] for j in range(rem))
    return dataclasses.replace(cfg, n_layers=n), sub


def ulp_nudged(params, seed: int):
    """``params`` with every weight moved by about one unit in the last
    place (x (1 + 2^-23 N(0, 1)), drawn where each weight lives)."""
    import torch
    from repro_torch.common.pytree import tree_map
    gens = {}

    def nudge(x):
        g = gens.setdefault(x.device, torch.Generator(
            device=x.device).manual_seed(seed))
        return x * (1 + 2.0 ** -23 * torch.randn(x.shape, generator=g,
                                                 device=x.device))
    return tree_map(nudge, params)


def full_depth_check(params, cfg, toks, extra: dict, batch: int) -> dict:
    """Check (a): forward(prompt + 2) against prefill(prompt) + two forced
    decode steps at full depth, the first ``batch`` sequences (after the
    patches, where the model has them: decode starts at position P + S)."""
    import torch
    from repro_torch.models import transformer as T
    n_front = cfg.n_frontend_tokens if "patches" in extra else 0
    sub = {k: v[:batch] for k, v in extra.items()}
    with torch.no_grad():
        dev_toks = toks[:batch].to(params["embed"].device)
        full = T.forward(params, cfg, {**sub, "tokens": dev_toks})
        pre, caches = T.prefill(params, cfg,
                                {**sub, "tokens": dev_toks[:, :SERVE_PROMPT]},
                                max_seq=n_front + SERVE_PROMPT + 2)
        scale = float(full.abs().max())
        err_p = float((pre - full[:, :n_front + SERVE_PROMPT]).abs().max())
        del pre
        err_d = []
        for i in range(2):
            dec, caches = T.decode_step(
                params, cfg,
                {"tokens": dev_toks[:, SERVE_PROMPT + i:
                                    SERVE_PROMPT + i + 1]},
                caches, n_front + SERVE_PROMPT + i)
            err_d.append(float((dec[:, 0] - full[:, n_front + SERVE_PROMPT
                                                 + i]).abs().max()))
        del full, caches
    return {"batch": batch, "max_abs_logit": scale,
            "atol": GQA_REL_ATOL * scale, "prefill_err": err_p,
            "decode_err": err_d,
            "held": max(err_p, *err_d) <= GQA_REL_ATOL * scale}


def decoder_serve_path(device, arch: str, k4_per_prefill: int):
    """Paths 12 and 13a-b: ``arch`` served at full width and depth on the
    card (``repro_torch.launch.serve.serve``) at path 4's batch, prompt and
    generated tokens (a vision model with its patches ahead of the prompt)
    from random fp32 weights drawn on the card from seed 0; K4 per prefill
    and none in decode; a profiled prefill; check (a), forward against
    prefill + 2 forced decode steps at full depth (batch 1; an MoE model
    at its first MOE_CHECK_LAYERS layers, at batch 1 and path 4's batch,
    each at the published capacity factor and at E / k, with the slots
    each capacity call dropped, and at full depth reported beside its own
    1-ulp spread), and check (b), the served model's first GQA_CPU_LAYERS
    layers card against CPU, the CPU's 1-ulp spread beside (an MoE model's
    differing expert choices counted)."""
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
    extra = frontend_inputs(cfg, SERVE_BATCH, device)
    n_front = cfg.n_frontend_tokens if extra else 0
    torch.cuda.synchronize()
    toks = torch.randint(0, cfg.vocab_size,
                         (SERVE_BATCH, SERVE_PROMPT + 2),
                         generator=torch.Generator().manual_seed(0))
    prompts = toks[:, :SERVE_PROMPT]
    report = {"arch": cfg.name, "batch": SERVE_BATCH,
              "prompt": SERVE_PROMPT, "frontend_tokens": n_front,
              "gen": SERVE_GEN,
              "params_stored": sum(x.numel() for x in tree_leaves(params)),
              "weights_bytes": sum(x.numel() * x.element_size()
                                   for x in tree_leaves(params)),
              "init_s": time.perf_counter() - t0}
    problems = []
    want = {"swa_attn": k4_per_prefill}
    max_seq = n_front + SERVE_PROMPT + SERVE_GEN

    # one prefill alone: its launches
    reset_all_launches()
    with torch.no_grad():
        T.prefill(params, cfg, {**extra, "tokens": prompts.to(device)},
                  max_seq=max_seq, last_only=True)
    torch.cuda.synchronize()
    prefill_launches = {k: n for k, n in all_launches().items() if n}

    # the path: serve(), every count set to 0 just before and read after;
    # an MoE model's capacity calls record their drops (tensors, read after)
    drops = []
    torch.cuda.reset_peak_memory_stats()
    with (recording_moe(drops) if cfg.has_moe
          else contextlib.nullcontext()):
        reset_all_launches()
        res = serve(cfg, params, prompts, SERVE_GEN, device=device,
                    generator=torch.Generator().manual_seed(0),
                    patches=extra.get("patches"))
        launches = all_launches()
    decode_launches = {k: launches[k] - prefill_launches.get(k, 0)
                       for k in launches}
    report.update(
        launches=launches, prefill_launches=prefill_launches,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        decode_launches=decode_launches, prefill_s=res.prefill_s,
        decode_s=res.decode_s, decode_tokens_per_s=res.decode_tokens_per_s,
        tokens=res.tokens[:, :8].tolist())
    if cfg.has_moe:
        n_pre = SERVE_BATCH * (n_front + SERVE_PROMPT)
        report["serve_drops"] = {
            "prefill": drop_counts([d for d in drops if d[0] == n_pre]),
            "decode": drop_counts([d for d in drops if d[0] != n_pre])}
        del drops[:]
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
            T.prefill(params, cfg, {**extra, "tokens": prompts.to(device)},
                      max_seq=max_seq, last_only=True)
        torch.cuda.synchronize()
    report["prefill_device"] = device_time(prof, res.prefill_s,
                                           ("swa_attn", "gemm"))
    del prof

    # (a) full depth: forward(prompt + 2) against prefill + two forced
    # decode steps; gemma3's prompt outgrows its 1024 window, so its local
    # caches roll and decode on the ring.  An MoE model at batch 1 (decode
    # through _moe_gather) and at path 4's batch (through _moe_capacity),
    # at the published capacity factor, held only where no slot dropped in
    # either run (the drop order differs between forward's 2002 tokens and
    # prefill's 2000 in the reference itself), and at E / k, where no slot
    # can drop, always held
    if not cfg.has_moe:
        check_a = full_depth_check(params, cfg, toks, extra, GQA_CHECK_BATCH)
        report["check_a"] = check_a
        if not check_a["held"]:
            problems.append(f"check (a) full depth: {check_a}")
    else:
        report["check_a"] = []
        no_drop = cfg.n_experts / cfg.top_k
        for depth, cf, b in (
                [(MOE_CHECK_LAYERS, cf, b) for cf in (cfg.capacity_factor,
                                                      no_drop)
                 for b in MOE_CHECK_BATCHES]
                + [(cfg.n_layers, no_drop, 1)]):
            c, p = served_layers(params, dataclasses.replace(
                cfg, capacity_factor=cf), depth)
            with recording_moe(drops):
                rec = full_depth_check(p, c, toks, extra, b)
            rec.update(layers=depth, capacity_factor=cf,
                       drops=drop_counts(drops))
            del drops[:]
            rec["gated"] = depth == MOE_CHECK_LAYERS and (
                cf == no_drop or rec["drops"]["dropped"] == 0)
            if depth == cfg.n_layers:
                # the model's own sensitivity at full depth: forward's last
                # two positions with every weight moved by about 1 ulp
                with torch.no_grad():
                    t = toks[:b].to(device)
                    rec["ulp_spread_last2"] = float((
                        T.forward(ulp_nudged(p, 5), c, {"tokens": t})[:, -2:]
                        - T.forward(p, c, {"tokens": t})[:, -2:]
                    ).abs().max())
            report["check_a"].append(rec)
            if rec["gated"] and not rec["held"]:
                problems.append(f"check (a): {rec}")

    # (b) the served model's first GQA_CPU_LAYERS layers at full width: the
    # card (kernels) against the CPU (plain versions), the CPU's own 1-ulp
    # spread beside, at the published capacity factor; an MoE model's
    # expert choices compared
    small, p_dev = served_layers(params, cfg, GQA_CPU_LAYERS)
    p_cpu = tree_map(lambda x: x.cpu(), p_dev)
    x_dev = {k: v[:1] for k, v in extra.items()}
    stoks = torch.randint(0, cfg.vocab_size,
                          (1, GQA_CPU_PROMPT + GQA_CPU_STEPS),
                          generator=torch.Generator().manual_seed(2))
    runs = {}
    cpu = torch.device("cpu")
    for name, dev, p in (("cuda", device, p_dev), ("cpu", cpu, p_cpu),
                         ("cpu_nudged", cpu, ulp_nudged(p_cpu, 3))):
        reset_all_launches()
        drops, routes = [], []
        with torch.no_grad(), (recording_moe(drops, routes) if cfg.has_moe
                               else contextlib.nullcontext()):
            t = stoks.to(dev)
            lg, caches = T.prefill(p, small,
                                   {**{k: v.to(dev) for k, v in
                                       x_dev.items()},
                                    "tokens": t[:, :GQA_CPU_PROMPT]},
                                   max_seq=(n_front + GQA_CPU_PROMPT
                                            + GQA_CPU_STEPS),
                                   last_only=True)
            steps = [lg.cpu()]
            for i in range(GQA_CPU_STEPS):
                d, caches = T.decode_step(
                    p, small, {"tokens": t[:, GQA_CPU_PROMPT + i:
                                           GQA_CPU_PROMPT + i + 1]},
                    caches, n_front + GQA_CPU_PROMPT + i)
                steps.append(d.cpu())
        runs[name] = (torch.cat(steps, dim=1),
                      {k: n for k, n in all_launches().items() if n},
                      [(i.cpu(), g.cpu()) for i, g in routes])
        del caches
    del params, p_dev, p_cpu
    torch.cuda.empty_cache()
    scale_b = float(runs["cpu"][0].abs().max())
    check_b = {"layers": GQA_CPU_LAYERS, "prompt": GQA_CPU_PROMPT,
               "steps": GQA_CPU_STEPS, "max_abs_logit": scale_b,
               "atol": GQA_REL_ATOL * scale_b,
               "err": float((runs["cuda"][0] - runs["cpu"][0]).abs().max()),
               "launches_cuda": runs["cuda"][1],
               "launches_cpu": runs["cpu"][1]}
    check_b["cpu_one_ulp"] = float(
        (runs["cpu_nudged"][0] - runs["cpu"][0]).abs().max())
    if cfg.has_moe:
        check_b.update(expert_choices(runs["cuda"][2], runs["cpu"][2]))
    report["check_b"] = check_b
    if (check_b["err"] > check_b["atol"]
            or runs["cuda"][1] != {"swa_attn": GQA_CPU_LAYERS}
            or runs["cpu"][1]):
        problems.append(f"check (b) card vs CPU: {check_b}")
    return report, problems


def expert_choices(card, cpu) -> dict:
    """The (token, slot) expert choices that differ between two runs'
    recorded routes, and for each (up to 20) the gap between the CPU's
    gates of the two experts."""
    n, differ, gaps = 0, 0, []
    for (ia, _), (ib, gb) in zip(card, cpu):
        n += ib.numel()
        diff = ia != ib
        differ += int(diff.sum())
        for t, k in diff.nonzero().tolist()[:20 - len(gaps)]:
            gaps.append(float(gb[t, ib[t, k]] - gb[t, ia[t, k]]))
    return {"expert_choices": n, "choices_differ": differ,
            "gate_gaps": gaps, "route_calls": [len(card), len(cpu)]}


def encoder_forward_path(device, arch: str, k4_per_forward: int):
    """Path 13c: the encoder-only ``arch`` at full width and depth on the
    card, random fp32 weights drawn on the card from seed 0: one forward
    over path 4's batch of ``fake_audio_frames`` (SERVE_PROMPT frames each),
    K4 (bidirectional) ``k4_per_forward`` times, timed and profiled, its
    peak memory; and GQA_CPU_LAYERS layers at full width card against CPU
    within 1e-3 of the largest logit, the served model's own first layers
    (the CPU's 1-ulp spread beside)."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import fake_audio_frames
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                    device=device)
    frames = fake_audio_frames(torch.Generator(device=device).manual_seed(0),
                               cfg, SERVE_BATCH, SERVE_PROMPT, device=device)
    torch.cuda.synchronize()
    report = {"arch": cfg.name, "batch": SERVE_BATCH,
              "frames": SERVE_PROMPT, "causal": cfg.causal,
              "params_stored": sum(x.numel() for x in tree_leaves(params)),
              "weights_bytes": sum(x.numel() * x.element_size()
                                   for x in tree_leaves(params)),
              "init_s": time.perf_counter() - t0}
    problems = []
    # the path: one forward, the counts set to 0 just before, read after
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = T.forward(params, cfg, {"frames": frames})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = all_launches()
    report.update(launches=launches, first_forward_s=first_s,
                  peak_mem_bytes=torch.cuda.max_memory_allocated())
    if {k: n for k, n in launches.items() if n} != {"swa_attn":
                                                     k4_per_forward}:
        problems.append(f"forward launched {launches}, expected swa_attn "
                        f"{k4_per_forward}")
    if (tuple(logits.shape) != (SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        problems.append(f"logits {tuple(logits.shape)} or non-finite")
    del logits
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.forward(params, cfg, {"frames": frames})
        torch.cuda.synchronize()
        report["forward_s"] = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            T.forward(params, cfg, {"frames": frames})
            torch.cuda.synchronize()
    report["forward_device"] = device_time(prof, report["forward_s"],
                                           ("swa_attn", "gemm"))
    del prof

    # (b) the served model's first GQA_CPU_LAYERS layers, card against CPU,
    # the CPU's 1-ulp spread beside
    small, p_dev = served_layers(params, cfg, GQA_CPU_LAYERS)
    del params
    torch.cuda.empty_cache()
    f_dev = frames[:1, :GQA_CPU_PROMPT]
    p_cpu = tree_map(lambda x: x.cpu(), p_dev)
    runs = {}
    for name, dev, p in (("cuda", device, p_dev),
                         ("cpu", torch.device("cpu"), p_cpu),
                         ("cpu_nudged", torch.device("cpu"),
                          ulp_nudged(p_cpu, 3))):
        reset_all_launches()
        with torch.no_grad():
            lg = T.forward(p, small, {"frames": f_dev.to(dev)})
        runs[name] = (lg.cpu(), {k: n for k, n in all_launches().items()
                                 if n})
    del p_dev, p_cpu, frames
    torch.cuda.empty_cache()
    scale_b = float(runs["cpu"][0].abs().max())
    check_b = {"layers": GQA_CPU_LAYERS, "frames": GQA_CPU_PROMPT,
               "max_abs_logit": scale_b, "atol": GQA_REL_ATOL * scale_b,
               "err": float((runs["cuda"][0] - runs["cpu"][0]).abs().max()),
               "cpu_one_ulp": float((runs["cpu_nudged"][0]
                                     - runs["cpu"][0]).abs().max()),
               "launches_cuda": runs["cuda"][1],
               "launches_cpu": runs["cpu"][1]}
    report["check_b"] = check_b
    if (check_b["err"] > check_b["atol"]
            or runs["cuda"][1] != {"swa_attn": GQA_CPU_LAYERS}
            or runs["cpu"][1]):
        problems.append(f"check (b) card vs CPU: {check_b}")
    return report, problems


def kernel_dtypes() -> dict:
    """{kernel: sorted dtypes} of the K4 / K5 launches since the last
    ``reset_all_launches``, as the wrappers tally them at each launch."""
    from repro_torch.kernels import ssd_scan, swa_attn
    return {m.SOURCE: sorted(m.LAUNCH_DTYPES) for m in (swa_attn, ssd_scan)
            if m.LAUNCH_DTYPES}


def flat32(tree) -> dict:
    """{path: float32 CPU copy} of a tree's leaves."""
    from repro_torch.common.pytree import tree_flatten
    return {k: v.detach().float().cpu() for k, v in tree_flatten(tree).items()}


def leaf_gaps(a: dict, b: dict) -> dict:
    """{path: max |a - b| / max |b|} per leaf."""
    return {k: float((a[k] - b[k]).abs().max()
                     / max(float(b[k].abs().max()), 1e-30)) for k in b}


def held_grads(grad_fn, p_card, batch, device) -> dict:
    """Card (kernels) against CPU (plain versions) for one float32 step's
    gradients: ``grad_fn(params, batch) -> (grads tree, loss)``; the loss
    within STEP_LOSS_RTOL, the largest per-leaf gap within
    STEP_SPREAD_FACTOR times the CPU's own 1-ulp spread; the card's own
    spread is reported beside it."""
    from repro_torch.common.pytree import tree_to
    p_cpu = tree_to(p_card, "cpu")
    b_cpu = tree_to(batch, "cpu")
    b_card = tree_to(batch, device)
    g_card, l_card = grad_fn(p_card, b_card)
    card = flat32(g_card)
    g_card, _ = grad_fn(ulp_nudged(p_card, 5), b_card)
    card_spread = max(leaf_gaps(flat32(g_card), card).values())
    del g_card
    g_cpu, l_cpu = grad_fn(p_cpu, b_cpu)
    cpu = flat32(g_cpu)
    g_nud, _ = grad_fn(ulp_nudged(p_cpu, 5), b_cpu)
    nud = flat32(g_nud)
    gaps, spreads = leaf_gaps(card, cpu), leaf_gaps(nud, cpu)
    gap, spread = max(gaps.values()), max(spreads.values())
    l_card, l_cpu = float(l_card), float(l_cpu)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    return {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": loss_rel,
            "grad_gap": gap, "cpu_ulp_spread": spread,
            "card_ulp_spread": card_spread,
            "bound": STEP_SPREAD_FACTOR * spread,
            "worst_leaves": {k: (gaps[k], spreads[k]) for k in worst},
            "finite": all(bool(torch_isfinite(v)) for v in card.values()),
            "held": loss_rel <= STEP_LOSS_RTOL
            and gap <= STEP_SPREAD_FACTOR * spread}


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def served_f32(cfg, device, seed: int = 0):
    """(config, params) of the served model's first STEP_HELD_LAYERS
    layers, float32, drawn on the card from ``seed`` (contiguous copies;
    the full draw is freed)."""
    import torch
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import transformer as T
    full = T.init(cfg, torch.Generator(device=device).manual_seed(seed),
                  torch.float32, device)
    c, sub = served_layers(full, cfg, STEP_HELD_LAYERS)
    sub = tree_map(lambda x: x.clone(), sub)
    del full
    return c, sub


def step_tokens(cfg, shape, seed: int) -> dict:
    """Uniform token (and label) batch of ``shape`` on the CPU."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, shape, generator=g)
            for k in ("tokens", "labels")}


def train_step_path(device):
    """14a: make_train_step on zamba2-1.2b, bf16, batch 4 x 4096, 2
    microbatches, remat, 3 steps; every leaf's gradient finite and non-zero;
    one float32 step of the first 7 layers card vs CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_flatten, tree_map
    from repro_torch.launch import dryrun, steps
    from torch.profiler import ProfilerActivity, profile
    cfg = configs.get(SERVE_ARCH)
    t_start = time.perf_counter()
    shape = configs.InputShape("train_4k_card", STEP_TRAIN_SEQ,
                               STEP_TRAIN_BATCH, "train")
    bundle = steps.make_train_step(cfg, shape, microbatch=STEP_MICROBATCH)
    rep = {"arch": cfg.name, "batch": STEP_TRAIN_BATCH,
           "seq": STEP_TRAIN_SEQ, "microbatch": STEP_MICROBATCH,
           "param_dtype": "bfloat16", "predicted": dryrun.bundle_bytes(bundle)}
    problems = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = bundle.init_args(torch.Generator(device=device).manual_seed(0),
                            device)
    rep["init_s"] = time.perf_counter() - t0
    per_fwd = {"swa_attn": STEP_K4, "ssd_scan": STEP_K5}
    want = {k: 2 * STEP_MICROBATCH * n for k, n in per_fwd.items()}

    # the gate: every leaf's gradient finite and non-zero
    reset_all_launches()
    grads, m = steps.train_grads(args[0], cfg, args[3],
                                 microbatch=STEP_MICROBATCH)
    torch.cuda.synchronize()
    rep["grad_launches"] = {k: n for k, n in all_launches().items() if n}
    flat = tree_flatten(grads)
    bad = [k for k, g in flat.items()
           if not (torch_isfinite(g) and bool(g.abs().max() > 0))]
    rep["grad_leaves"], rep["grad_bad_leaves"] = len(flat), bad
    rep["kernel_dtypes"] = kernel_dtypes()
    if bad:
        problems.append(f"leaves without a finite non-zero gradient: {bad}")
    if rep["kernel_dtypes"] != {"swa_attn": ["bfloat16"],
                                "ssd_scan": ["bfloat16"]}:
        problems.append(f"kernels ran in {rep['kernel_dtypes']}")
    del grads, flat, m

    # the path: 3 steps, each with its launches counted; the last profiled
    steps_rep = []
    for i in range(STEP_TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_all_launches()
        # device activity only: all device_time reads (host ops unrecorded)
        ctx = (profile(activities=[ProfilerActivity.CUDA])
               if i == STEP_TRAIN_STEPS - 1 else contextlib.nullcontext())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with ctx as prof:
            start.record()
            _, _, step, metrics = bundle.fn(*args)
            end.record()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        args = (args[0], args[1], step, args[3])
        launches = {k: n for k, n in all_launches().items() if n}
        r = {"step": i, "loss": float(metrics["loss"]), "wall_s": wall,
             "event_s": start.elapsed_time(end) / 1e3, "launches": launches,
             "profiled": prof is not None}
        if prof is not None:
            r["device"] = device_time(prof, wall, ("swa_attn", "ssd_scan",
                                                   "gemm"))
        steps_rep.append(r)
        if launches != want:
            problems.append(f"step {i} launched {launches}, expected {want}")
        if not math.isfinite(r["loss"]):
            problems.append(f"step {i} loss {r['loss']}")
    rep["steps"] = steps_rep
    rep["steps_s"] = time.perf_counter() - t_start
    rep["launches"] = {k: sum(r["launches"].get(k, 0) for r in steps_rep)
                       for k in want}
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    # the MFU of the second step: warm, and not profiled
    tokens = STEP_TRAIN_BATCH * STEP_TRAIN_SEQ
    rep["train_step_mfu"] = (6 * cfg.param_count() * tokens
                             / (steps_rep[1]["wall_s"] * BF16_FLOPS_PER_S))
    if not all(r["loss"] < steps_rep[0]["loss"] + 1 for r in steps_rep):
        problems.append(f"losses {[r['loss'] for r in steps_rep]}")
    del args, bundle
    torch.cuda.empty_cache()

    # one float32 step of the first 7 layers, card vs CPU
    t0 = time.perf_counter()
    c7, p7 = served_f32(cfg, device)
    batch = step_tokens(c7, (1, STEP_HELD_SEQ), 1)

    def grad_fn(p, b):          # remat changes no value: off for speed
        g, mm = steps.train_grads(p, c7, b, remat=False)
        return g, mm["loss"]
    rep["held"] = held_grads(grad_fn, p7, batch, device)
    if not rep["held"]["held"]:
        problems.append(f"first {STEP_HELD_LAYERS} layers card vs CPU: "
                        f"{rep['held']}")
    # the bf16 step's loss against the f32 step's on the same weights
    p16 = tree_map(lambda x: x.to(torch.bfloat16), p7)
    _, m16 = steps.train_grads(p16, c7, {k: v.to(device)
                                         for k, v in batch.items()},
                               remat=False)
    rep["held"]["loss_bf16"] = float(m16["loss"])
    rep["held"]["held_s"] = time.perf_counter() - t0
    del p7, p16
    torch.cuda.empty_cache()
    return rep, problems


def distill_step_path(device):
    """14b: make_distill_step on zamba2-1.2b, bf16, 4 teachers and a
    student each from its own seed, batch 8 x 512: K2 forward + backward
    at (4, 4096, 32000) with bf16 teachers, held against its plain version
    on the card; one float32 step of the first 7 layers card vs CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_map
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = configs.get(SERVE_ARCH)
    bundle = steps.make_distill_step(cfg, **STEP_DISTILL)
    k = STEP_DISTILL["n_teachers"]
    rep = {"arch": cfg.name, **STEP_DISTILL, "param_dtype": "bfloat16"}
    problems = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    draw = lambda seed: T.init(cfg, torch.Generator(
        device=device).manual_seed(seed), torch.bfloat16, device)
    student = draw(0)
    teachers = tree_map(lambda *xs: torch.stack(xs),
                        *[draw(1 + i) for i in range(k)])
    opt_state = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                               device=device), bundle.args[2])
    batch = {"tokens": step_tokens(cfg, (STEP_DISTILL["batch_size"],
                                         STEP_DISTILL["seq_len"]), 2)
             ["tokens"].to(device)}

    # K2 at the step's own shape against its plain version on the card
    with torch.no_grad():
        t_logits = steps.teacher_logits(teachers, cfg, batch)
        s_logits = T.forward(student, cfg, batch)
    v = cfg.vocab_size
    s2 = s_logits.reshape(-1, v).float()
    t3 = t_logits.reshape(k, -1, v)
    rep["k2_shape"] = [k, s2.shape[0], v, str(t3.dtype).split(".")[-1]]
    xs, xr = s2.clone().requires_grad_(), s2.clone().requires_grad_()
    lk = ops.ensemble_kl_loss(xs, t3)
    lk.backward()
    lr = ref.ensemble_kl(xr, t3)
    lr.backward()
    lk, lr = lk.detach(), lr.detach()
    fwd_err = abs(float(lk) - float(lr))
    bwd_err, bwd_ex = excess(xs.grad, xr.grad, 1e-4, 1e-7)
    rep["k2_check"] = {"loss": float(lk), "plain_loss": float(lr),
                       "fwd_err": fwd_err, "bwd_err": bwd_err,
                       "ok": fwd_err <= 1e-5 * abs(float(lr)) + 1e-6
                       and bwd_ex <= 0}
    if not rep["k2_check"]["ok"]:
        problems.append(f"K2 at the step's shape: {rep['k2_check']}")
    rep["k2_time"] = k2_step_timing(s2, t3)
    del xs, xr, lk, lr, s_logits, t_logits, s2, t3
    torch.cuda.empty_cache()

    # the path: one distill step
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    _, _, _, loss = bundle.fn(student, teachers, opt_state,
                              torch.zeros((), dtype=torch.int32), batch)
    torch.cuda.synchronize()
    rep["step_s"] = time.perf_counter() - t0
    rep["loss"] = float(loss)
    rep["launches"] = {kk: n for kk, n in all_launches().items() if n}
    rep["kernel_dtypes"] = kernel_dtypes()
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    want = {"swa_attn": (k + 2) * STEP_K4, "ssd_scan": (k + 2) * STEP_K5,
            "ensemble_kl_fwd": 1, "ensemble_kl_bwd": 1}
    if rep["launches"] != want:
        problems.append(f"launched {rep['launches']}, expected {want}")
    if not math.isfinite(rep["loss"]):
        problems.append(f"loss {rep['loss']}")
    del student, teachers, opt_state, bundle
    torch.cuda.empty_cache()

    # one float32 step of the first 7 layers, card vs CPU
    c7, p7 = served_f32(cfg, device, 0)
    t7 = tree_map(lambda *xs: torch.stack(xs), *[
        served_f32(cfg, device, 1 + i)[1]
        for i in range(STEP_DISTILL_HELD_TEACHERS)])
    tb = step_tokens(c7, (1, STEP_HELD_SEQ), 3)
    tb.pop("labels")

    def grad_fn(p, b):
        tt = t7 if p["embed"].is_cuda else t7_cpu
        return steps.distill_grads(p, tt, c7, b, remat=False)
    from repro_torch.common.pytree import tree_to
    t7_cpu = tree_to(t7, "cpu")
    rep["held"] = held_grads(grad_fn, p7, tb, device)
    if not rep["held"]["held"]:
        problems.append(f"first {STEP_HELD_LAYERS} layers card vs CPU: "
                        f"{rep['held']}")
    del p7, t7, t7_cpu
    torch.cuda.empty_cache()
    return rep, problems


def k2_step_timing(s2, t3) -> dict:
    """K2 forward and backward at the distill step's shape: device time
    (CUDA-graph replay), the plain version's, and the byte bound."""
    from repro_torch.kernels import ensemble_kl as k2mod
    from repro_torch.kernels import ref
    k, b, v = t3.shape
    elem = t3.element_size()
    _, lse_t, lse_s = k2mod.kl_fwd(s2, t3)
    import torch
    g = torch.ones((), dtype=torch.float32, device=s2.device)
    fwd = device_ms(lambda: k2mod.kl_fwd(s2, t3), reps=5, iters=5)
    bwd = device_ms(lambda: k2mod.kl_bwd(s2, t3, lse_t, lse_s, g),
                    reps=2, iters=5)
    plain = call_ms(lambda: ref.ensemble_kl(s2, t3), iters=3, warmup=1)
    fb = k2_bytes(k, b, v, elem, False) / HBM_BYTES_PER_S * 1e3
    bb = k2_bytes(k, b, v, elem, True) / HBM_BYTES_PER_S * 1e3
    return {"fwd_ms": fwd, "bwd_ms": bwd, "plain_fwd_call_ms": plain,
            "fwd_bound_ms": fb, "bwd_bound_ms": bb, "bound_by": "bytes",
            "plan": str(k2mod.card_plan(s2.device, k, b, v))}


def fed_round_path(device, grad_spread: float):
    """14c: make_fed_round_step at JAX's defaults on zamba2-1.2b, bf16;
    then STEP_FED_HELD's round of the first 7 layers in float32 card vs
    CPU: each leaf's update within STEP_SPREAD_FACTOR x ``grad_spread``
    (14a's CPU 1-ulp spread of the same layers' gradients)."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_flatten, tree_map, tree_to
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = configs.get(SERVE_ARCH)
    bundle = steps.make_fed_round_step(cfg, **STEP_FED)
    n, ls = STEP_FED["n_clients"], STEP_FED["local_steps"]
    rep = {"arch": cfg.name, **STEP_FED, "param_dtype": "bfloat16"}
    problems = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stacked = tree_map(lambda *xs: torch.stack(xs), *[
        T.init(cfg, torch.Generator(device=device).manual_seed(i),
               torch.bfloat16, device) for i in range(n)])
    shape4 = (n, ls, STEP_FED["batch_size"], STEP_FED["seq_len"])
    batch = {kk: v.to(device) for kk, v in step_tokens(cfg, shape4,
                                                       4).items()}
    before = tree_map(lambda x: x[0].clone(), stacked)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = bundle.fn(stacked, batch)
    torch.cuda.synchronize()
    rep["round_s"] = time.perf_counter() - t0
    rep["launches"] = {kk: c for kk, c in all_launches().items() if c}
    rep["kernel_dtypes"] = kernel_dtypes()
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    want = {"swa_attn": n * ls * 2 * STEP_K4,
            "ssd_scan": n * ls * 2 * STEP_K5}
    if rep["launches"] != want:
        problems.append(f"launched {rep['launches']}, expected {want}")
    moved = sum(not torch.equal(a[0], b) for a, b in zip(
        tree_flatten(out).values(), tree_flatten(before).values()))
    finite = all(torch_isfinite(x) for x in tree_flatten(out).values())
    rep["leaves_moved"], rep["finite"] = moved, finite
    if not finite or moved == 0:
        problems.append(f"after the round: finite {finite}, {moved} leaves "
                        f"moved")
    del stacked, out, before, bundle, batch
    torch.cuda.empty_cache()

    # the first 7 layers in float32, STEP_FED_HELD's round, card vs CPU:
    # each element within STEP_SPREAD_FACTOR x grad_spread of its leaf's
    # largest update (after - before) plus one float32 rounding of the
    # parameter per local step
    k = STEP_FED_HELD["n_clients"]
    subs = [served_f32(cfg, device, i) for i in range(k)]
    c7 = subs[0][0]
    held = steps.make_fed_round_step(c7, param_dtype=torch.float32,
                                     lr=STEP_FED["lr"], remat=False,
                                     **STEP_FED_HELD)
    s7 = tree_map(lambda *xs: torch.stack(xs), *[p for _, p in subs])
    del subs
    start = flat32(s7)
    s7_cpu = tree_to(s7, "cpu")
    hb = step_tokens(c7, (k, STEP_FED_HELD["local_steps"],
                          STEP_FED_HELD["batch_size"],
                          STEP_FED_HELD["seq_len"]), 5)
    card = flat32(held.fn(s7, tree_to(hb, device)))
    cpu = flat32(held.fn(s7_cpu, hb))
    worst, rel = None, {}
    for kk in cpu:
        upd = (cpu[kk] - start[kk]).abs().max()
        ulps = STEP_FED_HELD["local_steps"] * 2.0 ** -23 * torch.maximum(
            start[kk].abs(), cpu[kk].abs())
        tol = STEP_SPREAD_FACTOR * grad_spread * upd + ulps
        rel[kk] = float(((card[kk] - cpu[kk]).abs() / tol).max())
    worst = max(rel, key=rel.get)
    rep["held"] = {"worst_gap_over_tol": rel[worst], "worst_leaf": worst,
                   "grad_spread_14a": grad_spread,
                   "held": rel[worst] <= 1.0}
    if not rep["held"]["held"]:
        problems.append(f"first {STEP_HELD_LAYERS} layers' round card vs "
                        f"CPU: {rep['held']}")
    del s7, s7_cpu
    torch.cuda.empty_cache()
    return rep, problems


def grow_caches(small, big):
    """Copy ``small`` (a prefill's caches) into the zeros of ``big`` (the
    same tree with room for more tokens), in place; returns ``big``."""
    import torch
    from repro_torch.common.pytree import tree_flatten
    for (_, s), (_, b) in zip(tree_flatten(small).items(),
                              tree_flatten(big).items()):
        with torch.no_grad():
            b[tuple(slice(0, n) for n in s.shape)].copy_(s)
    return big


def step_serve_path(device):
    """14d: make_prefill_step + make_serve_step on zamba2-1.2b in bf16 with
    bf16 caches at path 4's traffic; the logits held against the port's
    own float32 prefill of the same weights."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = configs.get(SERVE_ARCH)
    pre = steps.make_prefill_step(cfg, configs.InputShape(
        "prefill_2k", SERVE_PROMPT, SERVE_BATCH, "prefill"))
    srv = steps.make_serve_step(cfg, configs.InputShape(
        "decode_2k", SERVE_PROMPT + SERVE_GEN, SERVE_BATCH, "decode"))
    rep = {"arch": cfg.name, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
           "gen": SERVE_GEN, "param_dtype": "bfloat16",
           "cache_dtype": "bfloat16"}
    problems = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                    torch.bfloat16, device)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=torch.Generator().manual_seed(0)
                            ).to(device)
    pre.fn(params, {"tokens": prompts})     # warm: the bf16 GEMM plans
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    logits, caches = pre.fn(params, {"tokens": prompts})
    torch.cuda.synchronize()
    rep["prefill_s"] = time.perf_counter() - t0
    rep["prefill_launches"] = {k: n for k, n in all_launches().items() if n}
    rep["kernel_dtypes"] = kernel_dtypes()
    want = {"swa_attn": SERVE_K4, "ssd_scan": SERVE_K5}
    if rep["prefill_launches"] != want:
        problems.append(f"prefill launched {rep['prefill_launches']}, "
                        f"expected {want}")
    if rep["kernel_dtypes"] != {"swa_attn": ["bfloat16"],
                                "ssd_scan": ["bfloat16"]}:
        problems.append(f"kernels ran in {rep['kernel_dtypes']}")
    big = grow_caches(caches, tree_map(
        lambda m: torch.zeros(m.shape, dtype=m.dtype, device=device),
        srv.args[2]))
    del caches
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    first = logits[:, -1].float()
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SERVE_GEN):
        lg, big = srv.fn(params, {"tokens": tok}, big, SERVE_PROMPT + i)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
    torch.cuda.synchronize()
    rep["decode_s"] = time.perf_counter() - t0
    rep["decode_launches"] = {k: n for k, n in all_launches().items() if n}
    if rep["decode_launches"]:
        problems.append(f"decode launched {rep['decode_launches']}")
    rep["prefill_tokens_per_s"] = SERVE_BATCH * SERVE_PROMPT / rep[
        "prefill_s"]
    rep["decode_tokens_per_s"] = SERVE_BATCH * SERVE_GEN / rep["decode_s"]
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if not (torch_isfinite(first) and torch_isfinite(lg)):
        problems.append("non-finite logits")
    del big

    # against the port's own float32 of the same weights: gated at the
    # first layer and at one shared attention block, reported at 7 layers
    # and at full depth
    attn = dataclasses.replace(cfg, n_layers=1, pattern=tuple(
        b for b in cfg.pattern if b.mixer == "shared_attn"))
    cuts = {"attn_block": (attn, T.init(attn, torch.Generator(
        device=device).manual_seed(1), torch.bfloat16, device)),
        "1_layers": served_layers(params, cfg, 1),
        f"{STEP_HELD_LAYERS}_layers": served_layers(params, cfg,
                                                     STEP_HELD_LAYERS),
        f"{cfg.n_layers}_layers": (cfg, params)}
    rep["vs_f32"] = {}
    for name, (c, p16) in cuts.items():
        r, last32 = serve_vs_f32(c, p16, prompts)
        rep["vs_f32"][name] = r
        if name in ("attn_block", "1_layers") and not r["held"]:
            problems.append(f"bf16 vs f32 at {name}: {r}")
        if c is cfg:                    # the prefill step's own logits
            r["prompt"]["step_last_gap_share"] = float(
                (first - last32).abs().max()) / r["prompt"]["max_abs_logit"]
    del cuts, params
    torch.cuda.empty_cache()
    return rep, problems


def serve_vs_f32(c, p16, prompts):
    """bf16 weights ``p16`` of config ``c`` against the same weights in
    float32, and the float32 model against itself under a bf16-sized nudge
    of its weights: the whole prompt's logits (``T.forward``) and one
    decode step after a prefill (bf16 caches against float32 ones), each
    gap as a share of the float32 model's largest logit, with top-1
    agreement.  ``held``: both gaps within STEP_SPREAD_FACTOR times the
    nudge's, both bounds under STEP_SERVE_GATE_MAX, and the prompt's top-1
    disagreement within STEP_SPREAD_FACTOR times the nudge's (at least one
    position's).  Returns (that record, the float32 prefill's last
    logits)."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    b, s = prompts.shape
    p32 = tree_map(lambda x: x.float(), p16)
    runs = {}
    for name, p, dt in (("bf16", p16, torch.bfloat16),
                        ("f32", p32, torch.float32),
                        ("nudged", bf16_nudged(p32, 7), torch.float32)):
        pre = steps.make_prefill_step(c, configs.InputShape(
            "prefill", s, b, "prefill"), param_dtype=dt)
        srv = steps.make_serve_step(c, configs.InputShape(
            "decode", s + 1, b, "decode"), param_dtype=dt, cache_dtype=dt)
        with torch.no_grad():
            full = T.forward(p, c, {"tokens": prompts}).float()
        last, caches = pre.fn(p, {"tokens": prompts})
        big = grow_caches(caches, tree_map(
            lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                  device=prompts.device), srv.args[2]))
        del caches
        dec, _ = srv.fn(p, {"tokens": prompts[:, -1:]}, big, s)
        runs[name] = (full, dec[:, -1].float(), last[:, -1].float())
        del big, p
    del p32
    rep = {}
    for part, i in (("prompt", 0), ("decode", 1)):
        f32 = runs["f32"][i]
        scale = float(f32.abs().max())
        gap = {k: float((runs[k][i] - f32).abs().max()) / scale
               for k in ("bf16", "nudged")}
        flips = {k: float((runs[k][i].argmax(-1) != f32.argmax(-1))
                          .float().mean()) for k in ("bf16", "nudged")}
        rep[part] = {"max_abs_logit": scale, "gap_share": gap["bf16"],
                     "bf16_nudge_spread_share": gap["nudged"],
                     "bound": STEP_SPREAD_FACTOR * gap["nudged"],
                     "top1_agree": 1 - flips["bf16"],
                     "nudged_top1_agree": 1 - flips["nudged"]}
        if part == "prompt":
            rep[part]["top1_flip_bound"] = STEP_SPREAD_FACTOR * max(
                flips["nudged"], 1 / (f32.numel() // f32.shape[-1]))
            rep[part]["top1_held"] = (flips["bf16"]
                                      <= rep[part]["top1_flip_bound"])
    rep["held"] = (all(rep[k]["gap_share"] <= rep[k]["bound"]
                       < STEP_SERVE_GATE_MAX for k in ("prompt", "decode"))
                   and rep["prompt"]["top1_held"])
    return rep, runs["f32"][2]


def bf16_nudged(params, seed: int):
    """``params`` with every weight moved by about one bf16 unit in the
    last place (x (1 + 2^-8 N(0, 1)), drawn where each weight lives)."""
    import torch
    from repro_torch.common.pytree import tree_map
    gens = {}

    def nudge(x):
        g = gens.setdefault(x.device, torch.Generator(
            device=x.device).manual_seed(seed))
        return x * (1 + 2.0 ** -8 * torch.randn(x.shape, generator=g,
                                                device=x.device))
    return tree_map(nudge, params)


def step_dryrun_path(predicted: dict, measured_peak: int):
    """14e: the analytic dry run over every (arch, shape) pair and every
    arch's distill step on the meta device, and 14a's predicted argument
    bytes beside its measured peak."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        recs = dryrun.run_all(out_dir=str(ROOT / "chiprun_out"
                                          / "dryrun_torch"))
    rep = {"dryrun_s": time.perf_counter() - t0, "records": len(recs),
           "ok": sum(r["ok"] for r in recs),
           "skipped": sum("skipped" in r for r in recs),
           "fits": sum(r.get("memory", {}).get("fits", False)
                       for r in recs),
           "train_4k_card_predicted": predicted,
           "train_4k_card_peak_bytes": measured_peak}
    problems = [] if rep["ok"] == rep["records"] else [
        f"dry run failed: {[r for r in recs if not r['ok']]}"]
    return rep, problems


def step_builders_path(device):
    """Path 14: 14a-14e, each with its own launch counts."""
    rep, problems = {"card": card_line()}, []
    for name, fn in (("14a_train", train_step_path),
                     ("14b_distill", distill_step_path),
                     ("14c_fed_round", lambda d: fed_round_path(
                         d, rep["14a_train"]["held"]["cpu_ulp_spread"])),
                     ("14d_serve", step_serve_path)):
        t0 = time.perf_counter()
        r, p = fn(device)
        r["total_s"] = time.perf_counter() - t0
        rep[name] = r
        problems += [f"{name}: {x}" for x in p]
    r, p = step_dryrun_path(rep["14a_train"]["predicted"],
                            rep["14a_train"]["peak_mem_bytes"])
    rep["14e_dryrun"] = r
    problems += [f"14e_dryrun: {x}" for x in p]
    return rep, problems


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
    front = (f" after {rep['frontend_tokens']} patches"
             if rep.get("frontend_tokens") else "")
    print(f"  {name} {rep['arch']} batch {rep['batch']} prompt "
          f"{rep['prompt']}{front} gen {rep['gen']}: {rep['params_stored']} "
          f"parameters ({rep['weights_bytes'] / 1e9:.1f} GB), init "
          f"{rep['init_s']:.1f} s, prefill {rep['prefill_s']:.3f} s, decode "
          f"{rep['decode_s']:.3f} s ({rep['decode_tokens_per_s']:.1f} "
          f"tok/s), peak {rep['peak_mem_bytes'] / 2**30:.2f} GiB; launches "
          f"prefill {rep['prefill_launches']} decode "
          f"{ {k: n for k, n in rep['decode_launches'].items() if n} }; "
          f"whole path {rep['total_s']:.1f} s")
    print(f"  {name} prefill on the card, from a profiler trace: "
          f"{rep['prefill_device']}")
    if "serve_drops" in rep:
        print(f"  {name} slots dropped while serving: {rep['serve_drops']}")
    for c in (rep["check_a"] if isinstance(rep["check_a"], list)
              else [rep["check_a"]]):
        depth = (f"{c['layers']} layers" if "layers" in c
                 else "full depth")
        print(f"  {name} check (a) {depth}: {c}")
    print(f"  {name} check (b) card vs CPU: {rep['check_b']}", flush=True)


def print_path13c(name, rep) -> None:
    print(f"  {name} {rep['arch']} (causal {rep['causal']}) batch "
          f"{rep['batch']} x {rep['frames']} frames: {rep['params_stored']} "
          f"parameters ({rep['weights_bytes'] / 1e9:.1f} GB), init "
          f"{rep['init_s']:.1f} s, forward {rep['forward_s']:.3f} s (first "
          f"{rep['first_forward_s']:.3f} s), peak "
          f"{rep['peak_mem_bytes'] / 2**30:.2f} GiB; launches "
          f"{ {k: n for k, n in rep['launches'].items() if n} }; whole path "
          f"{rep['total_s']:.1f} s")
    print(f"  {name} forward on the card, from a profiler trace: "
          f"{rep['forward_device']}")
    print(f"  {name} check (b) card vs CPU: {rep['check_b']}", flush=True)


def print_path14(rep) -> None:
    a, b, c, d, e = (rep[k] for k in ("14a_train", "14b_distill",
                                      "14c_fed_round", "14d_serve",
                                      "14e_dryrun"))
    gib = 2 ** 30
    print(f"  path14 on {rep['card']}:")
    print(f"  path14 14a train {a['arch']} bf16 batch {a['batch']} x "
          f"{a['seq']}, microbatch {a['microbatch']}: losses "
          f"{[round(r['loss'], 6) for r in a['steps']]}, walls "
          f"{[round(r['wall_s'], 3) for r in a['steps']]} s (event "
          f"{[round(r['event_s'], 3) for r in a['steps']]}; the last "
          f"profiled: {a['steps'][-1].get('device')}), launches per step "
          f"{a['steps'][0]['launches']}, train_step_mfu "
          f"{a['train_step_mfu']:.4f}, peak "
          f"{a['peak_mem_bytes'] / gib:.2f} GiB (predicted arguments "
          f"{a['predicted']['argument_bytes'] / gib:.2f} GiB); gradients of "
          f"{a['grad_leaves']} leaves finite and non-zero: "
          f"{not a['grad_bad_leaves']}; kernels {a['kernel_dtypes']}")
    for name, r in (("14a", a), ("14b", b)):
        print(f"  path14 {name} first {STEP_HELD_LAYERS} layers f32 card "
              f"vs CPU: {r['held']}")
    print(f"  path14 14b distill K={b['n_teachers']} batch "
          f"{b['batch_size']} x {b['seq_len']}: step {b['step_s']:.3f} s, "
          f"loss {b['loss']:.6f}, launches {b['launches']}, peak "
          f"{b['peak_mem_bytes'] / gib:.2f} GiB; K2 at {b['k2_shape']}: "
          f"{b['k2_check']}; {b['k2_time']}")
    print(f"  path14 14c fed round {c['n_clients']} clients x "
          f"{c['local_steps']} steps, batch {c['batch_size']} x "
          f"{c['seq_len']}: {c['round_s']:.3f} s, launches {c['launches']}, "
          f"peak {c['peak_mem_bytes'] / gib:.2f} GiB; first "
          f"{STEP_HELD_LAYERS} layers card vs CPU {c['held']}")
    print(f"  path14 14d bf16 serve: prefill {d['prefill_s']:.3f} s "
          f"({d['prefill_tokens_per_s']:.0f} tokens/s), decode "
          f"{d['decode_tokens_per_s']:.1f} tokens/s, peak "
          f"{d['peak_mem_bytes'] / gib:.2f} GiB, launches prefill "
          f"{d['prefill_launches']} decode {d['decode_launches']}; against "
          f"the f32 prefill {d['vs_f32']}")
    print(f"  path14 14e dry run: {e['records']} records in "
          f"{e['dryrun_s']:.2f} s ({e['skipped']} skipped, {e['fits']} fit "
          f"one card); 14a predicted argument bytes "
          f"{e['train_4k_card_predicted']['argument_bytes']} against a "
          f"measured peak of {e['train_4k_card_peak_bytes']}; path 14 "
          f"{rep['total_s']:.1f} s", flush=True)


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


# ---------------------------------------------------------------------------
# Path 15: the client axis over a device mesh (ROADMAP item 11.7)
# ---------------------------------------------------------------------------

# 15a and 15b: 4 ranks, sharing the one card (gloo, the collectives staged
# through host memory) or one per card where there are 4 (nccl); 15a(ii) 1
# rank over nccl.  15c: drive_fed_rounds over 2 ranks at JAX's
# make_fed_round_step defaults (STEP_FED), 1 round.  The uploads of a
# sharded run against the one-process sync run's, within
# PATH15_UPLOAD_REL of the largest upload: the sharded ranks train a
# block of the client axis, so the card's batched products run at
# another shape (cuBLAS picks its algorithm by shape).
PATH15_RANKS, PATH15_FED_RANKS, PATH15_FED_ROUNDS = 4, 2, 1
PATH15_UPLOAD_REL = 1e-5
PATH15_RANK_THREADS, PATH15_TIMEOUT_S = 2, 600


@contextlib.contextmanager
def recording_uploads(recs: list):
    """Each round's cohort per group and the group's trained stack (on the
    host), as ``train_clients`` hands them to aggregation."""
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.core.engine import RoundEngine
    orig = RoundEngine.train_clients

    def recorded(self, t, globals_, batches):
        groups = orig(self, t, globals_, batches)
        recs.append({
            "round": int(t),
            "cohort": [None if rb is None else [int(k) for k in rb.ks]
                       for rb in batches],
            "stacks": [None if g.stack is None else
                       {k: v.detach().cpu() for k, v in
                        tree_flatten(g.stack).items()} for g in groups]})
        return groups
    RoundEngine.train_clients = recorded
    try:
        yield
    finally:
        RoundEngine.train_clients = orig


@contextlib.contextmanager
def recording_padding(pads: list):
    """Each batched update's lanes: how many took no step (the padded
    clients) and whether those came back as the global, bit for bit."""
    import torch
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.core import engine as eng
    orig = eng.make_batched_local_update

    def make(*args, **kw):
        fn = orig(*args, **kw)

        def run(params, xb, yb, anchor, step_mask, dp_seeds=None):
            stack = fn(params, xb, yb, anchor, step_mask, dp_seeds)
            idle = [i for i in range(int(step_mask.shape[0]))
                    if not bool(step_mask[i].any())]
            got, want = tree_flatten(stack), tree_flatten(params)
            pads.append({"lanes": int(step_mask.shape[0]),
                         "idle": len(idle),
                         "untouched": all(torch.equal(got[k][i], want[k])
                                          for i in idle for k in got)})
            return stack
        return run
    eng.make_batched_local_update = make
    try:
        yield
    finally:
        eng.make_batched_local_update = orig


def timed_ranks(fn, n: int, device, **kw) -> tuple:
    """``launch_ranks(fn, n, device, **kw)``'s reports and its seconds (a
    world run beside others from a thread pool)."""
    from repro_torch.launch import mesh as tmesh
    t0 = time.perf_counter()
    return (tmesh.launch_ranks(fn, n, device, **kw),
            time.perf_counter() - t0)


def mesh_run(spec, device="cuda") -> dict:
    """One run of ``spec`` on this process's card, its launch counts and
    collectives counted from 0: logs, cohorts, uploads, globals (on the
    host), the padded lanes and the globals' digest."""
    from repro_torch.api import Experiment
    from repro_torch.common import sharding
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.launch import mesh as tmesh
    recs, pads = [], []
    reset_all_launches()
    sharding.reset_collectives()
    with recording_uploads(recs), recording_padding(pads):
        t0 = time.perf_counter()
        res = Experiment(spec, device=device).run()
        wall = time.perf_counter() - t0
    return {"rank": tmesh.world_rank(), "backend": tmesh._WORLD["backend"],
            "logs": [[{k: getattr(l, k) for k in LOG_KEYS} for l in g]
                     for g in group_logs(res)],
            "uploads": recs, "pads": pads, "wall_s": wall,
            "phase_s": res.phase_seconds,
            "globals": [{k: v.detach().cpu() for k, v in
                         tree_flatten(g).items()}
                        for g in res.global_params],
            "digests": [sharding.tree_digest(g) for g in res.global_params],
            "launches": {k: c for k, c in all_launches().items() if c},
            "collectives": {k: dict(v)
                            for k, v in sharding.COLLECTIVES.items()}}


def path15_rank(specs: dict, device="cuda") -> dict:
    """One rank of 15a / 15b: each spec (JSON) through ``mesh_run``."""
    import torch
    from repro_torch.api import ExperimentSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {name: mesh_run(ExperimentSpec.from_json(text), device)
            for name, text in specs.items()}


def _flat_gap(a: dict, b: dict) -> tuple:
    """(largest |a - b|, largest |b|) over two flat trees."""
    gap = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    top = max(float(b[k].float().abs().max()) for k in b)
    return gap, top


def mesh_vs_sync(run: dict, ref: dict, exact: bool) -> tuple:
    """A sharded run against the one-process sync run of the same spec:
    (the gaps, problems).  ``exact``: every upload, global and log bit for
    bit; else the same cohorts, discrete facts and accuracy, each round's
    uploads within PATH15_UPLOAD_REL of their largest and the globals
    within ROUND1_PARAM_ATOL."""
    import torch
    problems = []
    facts = lambda r: [[(l["distill_steps"], l["bank"],
                         l["teacher_forwards"], l["n_participants"],
                         l["test_acc"]) for l in g] for g in r["logs"]]
    cohorts = lambda r: [u["cohort"] for u in r["uploads"]]
    if cohorts(run) != cohorts(ref):
        problems.append(f"cohorts {cohorts(run)} against {cohorts(ref)}")
    if facts(run) != facts(ref):
        problems.append(f"(steps, bank, teacher forwards, participants, "
                        f"test acc) {facts(run)} against {facts(ref)}")
    up_gaps, rows_ok = [], True
    for ur, uf in zip(run["uploads"], ref["uploads"], strict=True):
        for g, (sr, sf) in enumerate(zip(ur["stacks"], uf["stacks"],
                                         strict=True)):
            if sr is None or sf is None:
                rows_ok = rows_ok and sr is None and sf is None
                continue
            n = len(ur["cohort"][g])
            rows_ok = rows_ok and all(int(v.shape[0]) == n
                                      for v in sr.values())
            gap, top = _flat_gap(sr, sf)
            up_gaps.append(gap / top)
    g_gaps = [_flat_gap(a, b)[0] for a, b in zip(run["globals"],
                                                ref["globals"], strict=True)]
    rep = {"upload_rel_gap": max(up_gaps or [0.0]),
           "global_abs_gap": max(g_gaps), "uploads_rows_sliced": rows_ok,
           "wall_s": run["wall_s"]}
    if not rows_ok:
        problems.append("a stack kept padded rows past the cohort")
    if exact:
        same = (run["logs"] == ref["logs"] and all(
            torch.equal(a[k], b[k]) for a, b in
            zip(run["globals"], ref["globals"]) for k in b) and all(
            torch.equal(sr[k], sf[k])
            for ur, uf in zip(run["uploads"], ref["uploads"])
            for sr, sf in zip(ur["stacks"], uf["stacks"])
            if sf is not None for k in sf))
        rep["bit_equal"] = same
        if not same:
            problems.append(f"not bit for bit: {rep}")
    elif (rep["upload_rel_gap"] > PATH15_UPLOAD_REL
          or rep["global_abs_gap"] > ROUND1_PARAM_ATOL):
        problems.append(f"gaps {rep} against bounds {PATH15_UPLOAD_REL} "
                        f"(uploads, of the largest) and {ROUND1_PARAM_ATOL}")
    return rep, problems


def ranks_report(runs: list, ref: dict, what: str, exact: bool) -> tuple:
    """Every rank of one sharded spec against the sync run: the ranks'
    digests equal, K1 on every rank once per distill step, each rank's
    gaps, its collectives and their share of the run's wall."""
    problems, per_rank = [], []
    steps = sum(l["distill_steps"] for g in ref["logs"] for l in g)
    for r in runs:
        rep, more = mesh_vs_sync(r, ref, exact)
        problems += [f"{what} rank {r['rank']}: {p}" for p in more]
        coll = r["collectives"]
        rep.update(rank=r["rank"], backend=r["backend"],
                   launches=r["launches"], collectives=coll,
                   collective_share=sum(c["seconds"] for c in coll.values())
                   / r["wall_s"], phase_s=r["phase_s"])
        per_rank.append(rep)
        for name in ("ensemble_kl_bank_fwd", "ensemble_kl_bank_bwd"):
            if r["launches"].get(name, 0) != steps or steps == 0:
                problems.append(f"{what} rank {r['rank']}: {name} launched "
                                f"{r['launches'].get(name, 0)} times for "
                                f"{steps} distill steps")
    if any(r["digests"] != runs[0]["digests"] for r in runs):
        problems.append(f"{what}: the ranks' globals differ "
                        f"{[r['digests'] for r in runs]}")
    return per_rank, problems


def mesh_spec(spec):
    """``spec`` with the client axis sharded, through ``multihost``."""
    from repro_torch.api import DriverSpec, ShardingSpec
    return dataclasses.replace(spec, sharding=ShardingSpec(
        shard_clients=True), driver=DriverSpec(kind="multihost"))


def mesh_engine_path(device):
    """15a: the quickstart spec (path 1's) with ``sharding.shard_clients``
    through ``multihost``, (i) over PATH15_RANKS ranks, (ii) over 1 rank
    (nccl), (iii) through ``sync`` in this process; 15b: path 5a's
    heterogeneous spec over PATH15_RANKS ranks against ``sync``, its
    per-prototype client caps padded to the axis.  The two worlds and the
    ``sync`` runs go side by side (each world's launches are counted in
    its own processes)."""
    import concurrent.futures
    import torch
    device = torch.device(device).type
    quick, hetero = quickstart_spec(QUICK_ROUNDS), hetero_spec(HETERO_ROUNDS)
    rep, problems = {}, []
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        many = pool.submit(
            timed_ranks, path15_rank, PATH15_RANKS, device,
            args=({"15a": mesh_spec(quick).to_json(),
                   "15b": mesh_spec(hetero).to_json()}, device),
            threads=PATH15_RANK_THREADS, timeout_s=PATH15_TIMEOUT_S)
        one = pool.submit(timed_ranks, path15_rank, 1, device,
                          args=({"15a": mesh_spec(quick).to_json()}, device),
                          timeout_s=PATH15_TIMEOUT_S)
        t0 = time.perf_counter()
        sync_q, sync_h = mesh_run(quick, device), mesh_run(hetero, device)
        rep["sync_s"] = time.perf_counter() - t0
        many, rep["ranks_s"] = many.result()
        one, rep["one_rank_s"] = one.result()
    one = one[0]["15a"]
    rep["cards"] = torch.cuda.device_count() if device == "cuda" else 0
    rep["15a_i"], more = ranks_report([r["15a"] for r in many], sync_q,
                                      "15a(i)", exact=False)
    problems += more
    rep["15a_ii"], more = ranks_report([one], sync_q, "15a(ii)", exact=True)
    problems += more
    if one["backend"] != ("nccl" if device == "cuda" else "gloo"):
        problems.append(f"15a(ii) ran on {one['backend']}, not nccl")
    rep["15b"], more = ranks_report([r["15b"] for r in many], sync_h, "15b",
                                    exact=False)
    problems += more
    pads = [p for r in many for p in r["15b"]["pads"]]
    rep["15b_padded_lanes"] = sum(p["idle"] for p in pads)
    rep["15b_lanes"] = sum(p["lanes"] for p in pads)
    if not pads or rep["15b_padded_lanes"] == 0 or not all(
            p["untouched"] for p in pads):
        problems.append(f"15b padded lanes: {pads}")
    rep["15a_iii_launches"] = sync_q["launches"]
    rep["15b_sync_launches"] = sync_h["launches"]
    rep["15a_test_acc"] = [[l["test_acc"] for l in g]
                           for g in sync_q["logs"]]
    return rep, problems


def path15_fed_rank(kw: dict, device="cuda", arch=SERVE_ARCH) -> dict:
    """One rank of 15c: ``drive_fed_rounds`` on ``arch`` over
    ``make_host_mesh``, each upload's digest, the mean (rank 0, on the
    host) and its digest."""
    import torch
    from repro_torch.launch import mesh as tmesh
    torch.backends.cuda.matmul.allow_tf32 = False
    rep = fed_rounds_run(tmesh.make_host_mesh(), kw, device, arch)
    if tmesh.world_rank() != 0:
        rep.pop("mean")
    return rep


def fed_rounds_run(mesh, kw: dict, device="cuda", arch=SERVE_ARCH) -> dict:
    """``drive_fed_rounds`` from the seed-0 bf16 init drawn on ``device``
    (this rank's card)."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_flatten, tree_map
    from repro_torch.common.sharding import tree_digest
    from repro_torch.drivers import drive_fed_rounds
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer as T
    device = (torch.device("cuda", torch.cuda.current_device())
              if device == "cuda" else torch.device(device))
    cfg = configs.get(arch)
    digests = {}

    def hook(t, clients, stack):
        for i, c in enumerate(clients):
            digests[c] = tree_digest(tree_map(lambda x: x[i], stack))
    init = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                  torch.bfloat16, device)
    reset_all_launches()
    params, stats = drive_fed_rounds(
        cfg, mesh, rounds=PATH15_FED_ROUNDS, seed=0,
        param_dtype=torch.bfloat16, device=device, init_params=init,
        upload_hook=hook, **kw)
    return {"rank": tmesh.world_rank(), "backend": tmesh._WORLD["backend"],
            "digests": digests, "stats": stats,
            "launches": {k: c for k, c in all_launches().items() if c},
            "mean_digest": tree_digest(params),
            "mean": {k: v.cpu() for k, v in tree_flatten(params).items()}}


def bf16_ulp_excess(a: dict, b: dict) -> dict:
    """Elements of ``a`` more than one bfloat16 unit in the last place
    (at the larger magnitude) from ``b``, and the largest gap."""
    import torch
    over, gap, n = 0, 0.0, 0
    for k in b:
        x, y = a[k].float(), b[k].float()
        big = torch.maximum(x.abs(), y.abs()).to(torch.bfloat16)
        ulp = (torch.nextafter(big, torch.full_like(big, float("inf")))
               .float() - big.float())
        d = (x - y).abs()
        over += int((d > ulp).sum())
        gap = max(gap, float(d.max()))
        n += d.numel()
    return {"elements": n, "over_one_ulp": over, "max_abs_gap": gap}


def mesh_fed_path(device, arch=SERVE_ARCH):
    """15c: ``drive_fed_rounds`` on zamba2-1.2b at full width and depth in
    bf16 (JAX's make_fed_round_step defaults), one round over
    PATH15_FED_RANKS ranks against the same round unsharded in this
    process, side by side: every client's upload bit for bit (digests),
    the mean within one bf16 ulp per element, K4 and K5 launched on every
    rank."""
    import concurrent.futures
    import torch
    kw = dict(STEP_FED)
    problems = []
    device = torch.device(device).type
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(timed_ranks, path15_fed_rank, PATH15_FED_RANKS,
                            device, args=(kw, device, arch), threads=4,
                            timeout_s=PATH15_TIMEOUT_S)
        t0 = time.perf_counter()
        ref = fed_rounds_run(None, kw, device, arch)
        rep = {"unsharded_s": time.perf_counter() - t0,
               "unsharded": ref["stats"],
               "unsharded_launches": ref["launches"]}
        runs, rep["ranks_s"] = ranks.result()
    digests = {c: d for r in runs for c, d in r["digests"].items()}
    rep["uploads_bit_equal"] = digests == ref["digests"]
    if not rep["uploads_bit_equal"]:
        problems.append(f"15c uploads' digests {digests} against the "
                        f"unsharded {ref['digests']}")
    rep["mean"] = bf16_ulp_excess(runs[0]["mean"], ref["mean"])
    if rep["mean"]["over_one_ulp"]:
        problems.append(f"15c mean against the unsharded: {rep['mean']}")
    if any(r["mean_digest"] != runs[0]["mean_digest"] for r in runs):
        problems.append("15c: the ranks' means differ")
    per = kw["n_clients"] // PATH15_FED_RANKS * kw["local_steps"] * 2
    want = {"swa_attn": per * STEP_K4, "ssd_scan": per * STEP_K5}
    rep["ranks"] = [{"rank": r["rank"], "backend": r["backend"],
                     "launches": r["launches"], "stats": r["stats"]}
                    for r in runs]
    for r in runs:
        if r["launches"] != want:
            problems.append(f"15c rank {r['rank']} launched "
                            f"{r['launches']}, expected {want}")
    return rep, problems


def mesh_path(device):
    """Path 15: 15a and 15b (``mesh_engine_path``), then 15c."""
    t0 = time.perf_counter()
    rep, problems = mesh_engine_path(device)
    rep["15ab_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["15c"], more = mesh_fed_path(device)
    rep["15c_s"] = time.perf_counter() - t0
    return rep, problems + more


def print_path15(rep) -> None:
    gib = 2 ** 30
    for what in ("15a_i", "15a_ii", "15b"):
        for r in rep[what]:
            coll = ", ".join(
                f"{k} {v['calls']} calls {v['bytes']} B {v['seconds']:.3f} s"
                for k, v in r["collectives"].items())
            print(f"  path15 {what} rank {r['rank']} ({r['backend']}): "
                  f"uploads {r['upload_rel_gap']:.2e} of the largest, "
                  f"globals {r['global_abs_gap']:.2e}"
                  + (f", bit for bit {r['bit_equal']}"
                     if "bit_equal" in r else "")
                  + f"; run {r['wall_s']:.2f} s, collectives {coll} "
                  f"({100 * r['collective_share']:.1f}% of the run); "
                  f"launches {r['launches']}")
    print(f"  path15 15a sync launches {rep['15a_iii_launches']}, test acc "
          f"{rep['15a_test_acc']}; 15b sync launches "
          f"{rep['15b_sync_launches']}, padded lanes "
          f"{rep['15b_padded_lanes']} of {rep['15b_lanes']}; sync "
          f"{rep['sync_s']:.1f} s, {PATH15_RANKS} ranks "
          f"{rep['ranks_s']:.1f} s, 1 rank {rep['one_rank_s']:.1f} s on "
          f"{rep['cards']} card(s)")
    c = rep["15c"]
    u = c["unsharded"][0]
    print(f"  path15 15c {SERVE_ARCH} bf16 {STEP_FED}: unsharded round "
          f"{u['round_s']:.3f} s, peak {u['peak_mem_bytes'] / gib:.2f} GiB, "
          f"launches {c['unsharded_launches']}; uploads bit for bit "
          f"{c['uploads_bit_equal']}; mean {c['mean']}")
    for r in c["ranks"]:
        s = r["stats"][0]
        print(f"  path15 15c rank {r['rank']} ({r['backend']}): round "
              f"{s['round_s']:.3f} s, all_reduce {s['all_reduce_bytes']} B "
              f"in {s['all_reduce_s']:.3f} s, peak "
              f"{s['peak_mem_bytes'] / gib:.2f} GiB, launches "
              f"{r['launches']}")
    print(f"  path15: 15a/15b {rep['15ab_s']:.1f} s, 15c {rep['15c_s']:.1f} "
          f"s (unsharded {c['unsharded_s']:.1f} s, ranks "
          f"{c['ranks_s']:.1f} s), whole path {rep['total_s']:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# Path 16: the model axis of a mesh (ROADMAP items 11.8.1, 11.8.3, 11.8.5)
# ---------------------------------------------------------------------------

# Tensor parallelism over "model" (and FSDP over "data" in 16b), each rank
# a process of its own (launch_ranks), the ranks sharing the one card over
# gloo (NCCL, one rank per card, where there are as many cards).  The held
# checks run at zamba2-1.2b's first STEP_HELD_LAYERS served layers in
# float32, rank 0 computing the unsharded reference in its own process;
# full width and depth run in bf16 from seed 0 for time, memory, the
# collectives' counts and finiteness.
# 16a: a 1 x 2 mesh.  The 7-layer train step at batch 1 x STEP_HELD_SEQ:
#   the loss within STEP_LOSS_RTOL of the unsharded step's, the gathered
#   gradients within STEP_SPREAD_FACTOR times the unsharded step's own
#   1-ulp spread (measured as 14a measures it, here on the card).  Full
#   depth: PATH16_TRAIN_STEPS make_train_step at PATH16_TRAIN_BATCH x
#   4096 tokens, 2 microbatches, remat (cut from 14a's 3 steps of 4 x
#   4096), every leaf's gradient block finite and non-zero on every rank,
#   on a 1 x 2 mesh of its own once 16b's world has ended.
# 16b: the same 7-layer check on a 2 x 2 mesh (4 ranks: FSDP over "data",
#   tensor parallelism over "model"), at batch PATH16_HELD_BATCH_2X2 (the
#   data axis splits it).
# 16c: make_prefill_step on a 1 x 2 mesh at path 4's traffic (4 x 2000,
#   float32), zamba2-1.2b and granite-moe-1b-a400m (the expert-parallel
#   block, 16 experts a rank): the next-token logits at the first
#   PATH16_PREFILL_LAYERS served layers, gathered, within GQA_REL_ATOL of
#   the largest against the unsharded prefill's (paths 12-13's check
#   (b)); granite-moe's there at PATH16_MOE_CAPACITY (Switch's 1.0, not
#   its 1.25, at which no expert overflows at this traffic), each layer's
#   dropped slots summed over the ranks equal to one device's dispatch of
#   the same choices and to the unsharded prefill's (one data rank: the
#   capacity is the unsharded one) up to the expert choices that differ,
#   and some slots dropped.  Both timed at full depth, granite-moe's drops
#   there equal to one device's dispatch of the same choices (the init is
#   chaotic at depth, so the unsharded choices are not the reference).
# 16d: drive_fed_rounds on make_host_mesh(1, 2): the 7-layer round
#   (PATH16_FED_HELD, float32) against the unsharded round, every upload
#   and the mean gathered and held as 14c holds its round (within
#   STEP_SPREAD_FACTOR x 14a's CPU spread of each leaf's largest update
#   plus one float32 rounding a step; 2 steps, where 1 step sits at the
#   bound's edge: 2-ulp flips of weights near 1); full depth in bf16,
#   PATH16_FED (cut from JAX's 8 clients x 4 steps to 1 x 1, 1 round), the
#   ranks' gathered
#   globals equal by digest.  16c times one prefill each, not warmed (the
#   held check before it has loaded the kernels and built the groups).
PATH16_TRAIN_STEPS, PATH16_TRAIN_BATCH = 1, 2
PATH16_HELD_BATCH_2X2, PATH16_PREFILL_LAYERS = 2, 2
PATH16_FED = dict(n_clients=1, local_steps=1, batch_size=8, seq_len=512,
                  lr=3e-4)
PATH16_FED_HELD = dict(n_clients=2, local_steps=2, batch_size=1,
                       seq_len=512, lr=3e-4)
PATH16_MOE_CAPACITY = 1.0
PATH16_TIMEOUT_S = 900


def _p16_counts() -> dict:
    """This rank's collectives and K4 / K5 launches since the last reset."""
    from repro_torch.common import sharding
    return {"collectives": {k: dict(v) for k, v in
                            sharding.COLLECTIVES.items()},
            "by_axes": {a: {k: dict(v) for k, v in kinds.items()}
                        for a, kinds in sharding.COLLECTIVE_AXES.items()},
            "launches": {k: c for k, c in all_launches().items() if c}}


def _p16_reset() -> None:
    import torch
    from repro_torch.common import sharding
    torch.cuda.synchronize()
    sharding.reset_collectives()
    reset_all_launches()


def p16_held_train(device, mesh, batch_rows: int) -> tuple:
    """A float32 train step of zamba2-1.2b's first STEP_HELD_LAYERS served
    layers on ``mesh`` (FSDP over "data", tensor parallelism over
    "model"): rank 0 also runs it unsharded and at a 1-ulp nudge; the
    sharded gradients, gathered, against the unsharded ones."""
    import torch
    from repro_torch import configs
    from repro_torch.common import sharding as shd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cfg = configs.get(SERVE_ARCH)
    c7, p7 = served_f32(cfg, device)
    batch = {k: v.to(device) for k, v in step_tokens(
        c7, (batch_rows, STEP_HELD_SEQ), 1).items()}
    rep, problems = {"mesh": list(shd.axis_size(mesh, a)
                                  for a in shd.axis_names(mesh))}, []
    ref = None
    if tmesh.world_rank() == 0:
        g, m = steps.train_grads(p7, c7, batch, remat=False)
        ref = (flat32(g), float(m["loss"]))
        g_n, _ = steps.train_grads(ulp_nudged(p7, 5), c7, batch, remat=False)
        rep["ulp_spread"] = max(leaf_gaps(flat32(g_n), ref[0]).values())
        del g, g_n
    tp = T.tp_layout(c7, mesh, shd.make_rules(fsdp=True), ("data",))
    local = shd.shard_tree(p7, tp.pspecs, mesh)
    _p16_reset()
    t0 = time.perf_counter()
    g, m = steps.train_grads(local, c7, steps.batch_block(batch, tp),
                             remat=True, layout=tp, mesh=mesh)
    torch.cuda.synchronize()
    rep["step_s"] = time.perf_counter() - t0
    rep.update(_p16_counts())
    whole = shd.gather_tree(g, tp.pspecs, mesh)
    rep["loss"] = float(m["loss"])
    if ref is not None:
        gaps = leaf_gaps(flat32(whole), ref[0])
        rep["grad_gap"] = max(gaps.values())
        rep["worst_leaves"] = sorted(gaps, key=gaps.get, reverse=True)[:3]
        rep["loss_rel"] = abs(rep["loss"] - ref[1]) / abs(ref[1])
        rep["bound"] = STEP_SPREAD_FACTOR * rep["ulp_spread"]
        rep["held"] = (rep["loss_rel"] <= STEP_LOSS_RTOL
                       and rep["grad_gap"] <= rep["bound"])
        if not rep["held"]:
            problems.append(f"held train step on {rep['mesh']}: {rep}")
    del p7, local, g, whole
    torch.cuda.empty_cache()
    return rep, problems


def p16_full_train(device, mesh, batch: int = PATH16_TRAIN_BATCH) -> tuple:
    """make_train_step on zamba2-1.2b at full width and depth, bf16,
    ``batch`` x 4096 tokens in 2 microbatches: PATH16_TRAIN_STEPS steps on
    ``mesh``, every leaf's gradient block finite and non-zero on this
    rank, K4 / K5 at this rank's heads."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.launch import steps
    cfg = configs.get(SERVE_ARCH)
    shape = configs.InputShape("train_4k_card", STEP_TRAIN_SEQ, batch,
                               "train")
    bundle = steps.make_train_step(cfg, shape, mesh,
                                   microbatch=STEP_MICROBATCH)
    problems, rep = [], {"batch": batch, "seq": STEP_TRAIN_SEQ,
                         "microbatch": STEP_MICROBATCH}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = bundle.init_args(torch.Generator(device=device).manual_seed(0),
                            device)
    rep["init_s"] = time.perf_counter() - t0
    flags = []
    orig = steps._adam_step

    def adam_step(opt, params, opt_state, grads, step):
        flags.append({k: torch.stack([torch.isfinite(g).all(),
                                      g.abs().max() > 0])
                      for k, g in tree_flatten(grads).items()})
        return orig(opt, params, opt_state, grads, step)
    per_fwd = {"swa_attn": STEP_K4, "ssd_scan": STEP_K5}
    want = {k: 2 * STEP_MICROBATCH * n for k, n in per_fwd.items()}
    rep["steps"] = []
    steps._adam_step = adam_step
    try:
        for i in range(PATH16_TRAIN_STEPS):
            _p16_reset()
            t0 = time.perf_counter()
            _, _, step, metrics = bundle.fn(*args)
            torch.cuda.synchronize()
            r = {"step": i, "wall_s": time.perf_counter() - t0,
                 "loss": float(metrics["loss"]), **_p16_counts()}
            rep["steps"].append(r)
            args = (args[0], args[1], step, args[3])
            if r["launches"] != want:
                problems.append(f"step {i} launched {r['launches']}, "
                                f"expected {want}")
            if not math.isfinite(r["loss"]):
                problems.append(f"step {i} loss {r['loss']}")
    finally:
        steps._adam_step = orig
    bad = [k for k, f in flags[0].items() if not bool(f.all())]
    rep["grad_leaves"], rep["grad_bad_leaves"] = len(flags[0]), bad
    if bad:
        problems.append(f"leaves without a finite non-zero gradient: {bad}")
    rep["kernel_dtypes"] = kernel_dtypes()
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del args, bundle
    torch.cuda.empty_cache()
    return rep, problems


def p16_held_prefill(mesh, cfg, whole, toks, shape) -> dict:
    """make_prefill_step of ``cfg``'s first PATH16_PREFILL_LAYERS served
    layers on ``mesh`` against the unsharded prefill (rank 0): the
    next-token logits, gathered, within GQA_REL_ATOL of the largest; with
    MoE, each layer's dropped slots summed over the ranks against the
    unsharded prefill's (apart by no more than the expert choices that
    differ: one moved choice changes an expert's overflow by at most
    one), and the sharded side must drop slots."""
    import torch
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    cn, pn = served_layers(whole, cfg, PATH16_PREFILL_LAYERS)
    pn = tree_map(lambda x: x.clone(), pn)
    bundle = steps.make_prefill_step(cn, shape, mesh,
                                     param_dtype=torch.float32)
    tp = bundle.layout
    drops, routes = [], []
    with recording_moe(drops, routes):
        lg, _ = bundle.fn(shd.shard_tree(pn, tp.pspecs, mesh),
                          steps.batch_block({"tokens": toks}, tp))
    split = "model" if lg.shape[-1] != cn.vocab_size else None
    lg = shd.gather_tensor(lg, shd.P(tp.dp_axes, None, split), mesh)
    rep = {"layers": PATH16_PREFILL_LAYERS}
    if cn.has_moe:
        rep.update(ep_drops(cn, drops, routes, mesh))
    if tmesh.world_rank() == 0:
        one, one_routes = [], []
        with recording_moe(one, one_routes), torch.no_grad():
            want, _ = T.prefill(pn, cn, {"tokens": toks}, SERVE_PROMPT,
                                last_only=True)
        scale = float(want.abs().max())
        rep.update(max_abs_logit=scale, err=float((lg - want).abs().max()),
                   atol=GQA_REL_ATOL * scale)
        rep["held"] = rep["err"] <= rep["atol"]
        if cn.has_moe:
            rep["capacity_factor"] = cn.capacity_factor
            rep["unsharded_drops"] = [int(n) for _, n in one]
            rep["choices_differing"] = [
                int((a.sort(-1).values != b.sort(-1).values).sum())
                for (a, _), (b, _) in zip(routes, one_routes)]
            apart = zip(rep["layer_drops"], rep["unsharded_drops"],
                        rep["choices_differing"], strict=True)
            rep["held"] = (rep["held"] and rep["drops_held"]
                           and rep["dropped"] > 0
                           and all(abs(g - u) <= n for g, u, n in apart))
    return rep


def p16_prefill(device, mesh) -> tuple:
    """16c: make_prefill_step on ``mesh`` at path 4's traffic, float32:
    zamba2-1.2b and granite-moe-1b-a400m expert-parallel, each held at
    its first PATH16_PREFILL_LAYERS layers (granite-moe at
    PATH16_MOE_CAPACITY, where its experts overflow) and timed at full
    depth."""
    import torch
    from repro_torch import configs
    from repro_torch.common import sharding as shd
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    rep, problems = {}, []
    shape = configs.InputShape("prefill_card", SERVE_PROMPT, SERVE_BATCH,
                               "prefill")
    for arch, k4, k5 in ((SERVE_ARCH, SERVE_K4, SERVE_K5),
                         (MOE_SERVE[0], MOE_SERVE[1], 0)):
        c = configs.get(arch)
        gen = torch.Generator(device=device).manual_seed(0)
        whole = T.init(c, gen, torch.float32, device)
        t = step_tokens(c, (SERVE_BATCH, SERVE_PROMPT), 2)["tokens"].to(
            device)
        # the first layers, gathered, against the unsharded prefill
        held_cfg = (dataclasses.replace(
            c, capacity_factor=PATH16_MOE_CAPACITY) if c.has_moe else c)
        held = p16_held_prefill(mesh, held_cfg, whole, t, shape)
        if tmesh.world_rank() == 0:
            rep[f"{arch}_held"] = held
            if not held["held"]:
                problems.append(f"16c {arch} first layers: {held}")
        torch.cuda.empty_cache()
        # full depth, timed
        bundle = steps.make_prefill_step(c, shape, mesh,
                                         param_dtype=torch.float32)
        tp = bundle.layout
        params = shd.shard_tree(whole, tp.pspecs, mesh)
        batch = steps.batch_block({"tokens": t}, tp)
        drops, routes = [], []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _p16_reset()
        with recording_moe(drops, routes):
            t0 = time.perf_counter()
            lg, caches = bundle.fn(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        r = {"prefill_s": wall, "logits_shape": list(lg.shape),
             "finite": torch_isfinite(lg), **_p16_counts(),
             "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        want = {"swa_attn": k4, **({"ssd_scan": k5} if k5 else {})}
        if r["launches"] != want or not r["finite"]:
            problems.append(f"16c {arch}: launches {r['launches']} "
                            f"(expected {want}), finite {r['finite']}")
        if c.has_moe:
            r.update(ep_drops(c, drops, routes, mesh))
            if not r["drops_held"]:
                problems.append(f"16c {arch} drops: {r}")
        rep[arch] = r
        del whole, params, lg, caches, bundle
        torch.cuda.empty_cache()
    return rep, problems


def ep_drops(cfg, drops, routes, mesh) -> dict:
    """Each layer's dropped slots (``recording_moe``'s, this rank's)
    summed over the model axis against one device's dispatch of the same
    expert choices (all experts local, the same capacity)."""
    import torch
    from repro_torch.common import sharding as shd
    from repro_torch.models import moe
    mine = torch.stack([n for _, n in drops])
    total = shd.all_reduce_sum(mine, mesh, ("model",))
    one = [int(idx.numel() - moe.dispatch(cfg, idx, 0, cfg.n_experts)
               .valid.sum()) for idx, _ in routes]
    got = [int(n) for n in total]
    return {"layer_drops": got, "one_device_drops": one,
            "drops_held": got == one and len(got) == cfg.n_layers,
            "dropped": sum(got)}


def p16_fed(device, mesh, spread: float,
            fed: Optional[dict] = None) -> tuple:
    """16d: drive_fed_rounds on ``mesh``: the 7-layer float32 round held
    against the unsharded round (rank 0), and one bf16 round at full
    depth at ``fed`` (PATH16_FED by default)."""
    import torch
    from repro_torch import configs
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten, tree_map
    from repro_torch.drivers import drive_fed_rounds
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer as T
    rep, problems = {}, []
    cfg = configs.get(SERVE_ARCH)
    rank0 = tmesh.world_rank() == 0
    c7, p7 = served_f32(cfg, device)
    kw = dict(PATH16_FED_HELD)
    got, want = {}, {}

    def hook(into):
        def keep(t, clients, stack):
            for i, c in enumerate(clients):
                into[c] = flat32(tree_map(lambda x: x[i], stack))
        return keep
    start = flat32(p7)
    ref_mean = None
    if rank0:
        ref_mean, _ = drive_fed_rounds(
            c7, None, rounds=1, seed=0, param_dtype=torch.float32,
            device=device, init_params=p7, upload_hook=hook(want), **kw)
        ref_mean = flat32(ref_mean)
    mean, stats = drive_fed_rounds(
        c7, mesh, rounds=1, seed=0, param_dtype=torch.float32,
        device=device, init_params=p7, upload_hook=hook(got), **kw)
    if rank0:
        worst = {}
        pairs = [(f"client {c}", got[c], want[c]) for c in got] + [
            ("mean", flat32(mean), ref_mean)]
        for what, a, b in pairs:
            rel = {}
            for k in b:
                upd = (b[k] - start[k]).abs().max()
                ulps = kw["local_steps"] * 2.0 ** -23 * torch.maximum(
                    start[k].abs(), b[k].abs())
                tol = STEP_SPREAD_FACTOR * spread * upd + ulps
                rel[k] = float(((a[k] - b[k]).abs() / tol).max())
            k = max(rel, key=rel.get)
            worst[what] = (rel[k], k)
        rep["held"] = {"worst_gap_over_tol": worst,
                       "grad_spread_14a": spread,
                       "clients": sorted(got),
                       "held": bool(got) and set(got) <= set(want) and all(
                           w <= 1.0 for w, _ in worst.values())}
        if not rep["held"]["held"]:
            problems.append(f"16d 7-layer round: {rep['held']}")
    del p7, mean
    torch.cuda.empty_cache()
    # full depth, bf16
    fed = dict(PATH16_FED if fed is None else fed)
    init = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                  torch.bfloat16, device)
    _p16_reset()
    t0 = time.perf_counter()
    params, stats = drive_fed_rounds(cfg, mesh, rounds=1, seed=0,
                                     param_dtype=torch.bfloat16,
                                     device=device, init_params=init, **fed)
    torch.cuda.synchronize()
    per = (fed["n_clients"] // shd.axis_size(mesh, "data")
           * fed["local_steps"] * 2)
    want = {"swa_attn": per * STEP_K4, "ssd_scan": per * STEP_K5}
    rep["full"] = {**fed, "run_s": time.perf_counter() - t0,
                   "stats": stats, **_p16_counts(),
                   "digest": shd.tree_digest(params),
                   "finite": all(torch_isfinite(v) for v in
                                 tree_flatten(params).values())}
    if rep["full"]["launches"] != want or not rep["full"]["finite"]:
        problems.append(f"16d full depth: launches "
                        f"{rep['full']['launches']} (expected {want}), "
                        f"finite {rep['full']['finite']}")
    del init, params
    torch.cuda.empty_cache()
    return rep, problems


def path16_rank(device, spread: float, shape=(1, 2),
                parts=("16a", "16c", "16d"), fed=None) -> dict:
    """One rank of path 16's ``shape`` mesh: the parts in order, each
    with its own counts; a part that raises ends the rank (and the
    launch)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device())
              if device == "cuda" else torch.device(device))
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_mesh(shape, ("data", "model"))
    out, problems = {"rank": tmesh.world_rank(),
                     "backend": tmesh._WORLD["backend"]}, []
    for part in parts:
        t0 = time.perf_counter()
        if part == "16a":
            out["16a_held"], p = p16_held_train(device, mesh, 1)
        elif part == "16a_full":
            out["16a_full"], p = p16_full_train(device, mesh)
        elif part == "16b":
            out["16b_held"], p = p16_held_train(device, mesh,
                                                PATH16_HELD_BATCH_2X2)
        elif part == "16b_full":             # 14a's traffic, 4 cards
            out["16b_full"], p = p16_full_train(device, mesh,
                                                STEP_TRAIN_BATCH)
        elif part == "16c":
            out["16c"], p = p16_prefill(device, mesh)
        else:
            out["16d"], p = p16_fed(device, mesh, spread, fed)
        problems += [f"{part}: {x}" for x in p]
        out[f"{part}_s"] = time.perf_counter() - t0
    out["problems"] = problems
    return out


def model_axis_path(device, spread: float):
    """Path 16: 16a's held step, 16c, 16d on a 1 x 2 mesh (2 ranks) and,
    side by side with it (the ranks mostly wait on host-staged
    collectives), 16b on a 2 x 2 mesh (4 ranks), then 16a's full-depth
    step on a 1 x 2 mesh of its own."""
    import concurrent.futures
    import torch
    device = torch.device(device).type
    rep, problems = {"card": card_line()}, []

    def world(n, args, threads):
        return timed_ranks(path16_rank, n, device, args=args,
                           threads=threads, timeout_s=PATH16_TIMEOUT_S)

    def b_then_full():
        return (world(4, (device, spread, (2, 2), ("16b",)), 2),
                world(2, (device, spread, (1, 2), ("16a_full",)), 4))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(world, 2, (device, spread), 4)
        rest = pool.submit(b_then_full)
        rep["two"], rep["two_s"] = two.result()
        ((rep["four"], rep["four_s"]),
         (rep["full"], rep["full_s"])) = rest.result()
    for world, runs in (("1 x 2", rep["two"] + rep["full"]),
                        ("2 x 2", rep["four"])):
        problems += [f"{world} rank {r['rank']}: {p}" for r in runs
                     for p in r["problems"]]
    digests = {r["16d"]["full"]["digest"] for r in rep["two"]}
    if len(digests) != 1:
        problems.append(f"16d: the ranks' gathered globals differ {digests}")
    return rep, problems


def coll_line(r) -> str:
    """A part's collectives by mesh axes: calls, bytes, seconds."""
    return "; ".join(
        f"{axes}: " + ", ".join(
            f"{k} {v['calls']} x {v['bytes'] / 1e6:.1f} MB "
            f"{v['seconds']:.2f} s" for k, v in kinds.items()
            if v["calls"])
        for axes, kinds in r["by_axes"].items())


def print_p16a_full(r) -> None:
    """16a's full-depth step on one rank."""
    f = r["16a_full"]
    for s in f["steps"]:
        print(f"  path16 16a rank {r['rank']} ({r['backend']}) full depth "
              f"bf16 batch {f['batch']} x {f['seq']} microbatch "
              f"{f['microbatch']}: step {s['step']} {s['wall_s']:.3f} s, "
              f"loss {s['loss']:.6f}, launches {s['launches']}; "
              f"{coll_line(s)}")
    print(f"  path16 16a rank {r['rank']}: init {f['init_s']:.1f} s, "
          f"peak {f['peak_mem_bytes'] / 2 ** 30:.2f} GiB, "
          f"{f['grad_leaves']} gradient blocks finite and non-zero: "
          f"{not f['grad_bad_leaves']}; kernels {f['kernel_dtypes']}")


def print_path16(rep) -> None:
    gib = 2 ** 30
    print(f"  path16 on {rep['card']}:")
    for r in rep["two"]:
        h = r["16a_held"]
        print(f"  path16 16a rank {r['rank']} ({r['backend']}) held "
              f"{STEP_HELD_LAYERS} layers f32 on 1 x 2: loss {h['loss']:.6f}"
              + (f", rel {h['loss_rel']:.2e}, gradient gap "
                 f"{h['grad_gap']:.3g} against 4 x the unsharded 1-ulp "
                 f"spread {h['ulp_spread']:.3g} (worst {h['worst_leaves']})"
                 if "held" in h else "")
              + f"; {h['step_s']:.2f} s, launches {h['launches']}; "
              f"{coll_line(h)}")
        c = r["16c"]
        for arch in (SERVE_ARCH, MOE_SERVE[0]):
            if f"{arch}_held" in c:
                print(f"  path16 16c {arch} first {PATH16_PREFILL_LAYERS} "
                      f"layers sharded vs unsharded: {c[f'{arch}_held']}")
            a = c[arch]
            extra = ("" if "layer_drops" not in a else
                     f"; dropped slots per layer {a['layer_drops']} (one "
                     f"device on the same choices "
                     f"{a['one_device_drops']}, held {a['drops_held']})")
            print(f"  path16 16c rank {r['rank']} {arch} prefill "
                  f"{SERVE_BATCH} x {SERVE_PROMPT} f32: "
                  f"{a['prefill_s']:.3f} s, peak "
                  f"{a['peak_mem_bytes'] / gib:.2f} GiB, launches "
                  f"{a['launches']}; {coll_line(a)}{extra}")
        d = r["16d"]
        if "held" in d:
            print(f"  path16 16d 7-layer round vs unsharded: {d['held']}")
        fd = d["full"]
        print(f"  path16 16d rank {r['rank']} full depth bf16 "
              f"{fd['n_clients']} clients x {fd['local_steps']} steps of "
              f"{fd['batch_size']} x {fd['seq_len']}: run "
              f"{fd['run_s']:.2f} s (round "
              f"{fd['stats'][0]['round_s']:.2f} s), peak "
              f"{fd['stats'][0]['peak_mem_bytes'] / gib:.2f} GiB, launches "
              f"{fd['launches']}, digest {fd['digest']}; {coll_line(fd)}")
        print(f"  path16 rank {r['rank']}: 16a {r['16a_s']:.1f} s, 16c "
              f"{r['16c_s']:.1f} s, 16d {r['16d_s']:.1f} s")
    for r in rep["four"]:
        h = r["16b_held"]
        print(f"  path16 16b rank {r['rank']} ({r['backend']}) held "
              f"{STEP_HELD_LAYERS} layers f32 on 2 x 2: loss {h['loss']:.6f}"
              + (f", rel {h['loss_rel']:.2e}, gradient gap "
                 f"{h['grad_gap']:.3g} against 4 x {h['ulp_spread']:.3g}"
                 if "held" in h else "")
              + f"; {h['step_s']:.2f} s, launches {h['launches']}; {coll_line(h)}")
    for r in rep["full"]:
        print_p16a_full(r)
    print(f"  path16: 1 x 2 world {rep['two_s']:.1f} s, 2 x 2 world "
          f"{rep['four_s']:.1f} s, then 16a's full step's 1 x 2 world "
          f"{rep['full_s']:.1f} s, whole path {rep['total_s']:.1f} s",
          flush=True)


# Path 17 (after path 16): the distill and serve steps on a mesh (items
# 11.8.1's rest and 11.8.2), on 2 gloo ranks sharing the card as path 16's
# 1 x 2 world does, zamba2-1.2b at full width.  17k first times K2 over
# vocabulary shards (K2s, the statistics merged over "model") against the
# logits all-gathered over "model" and whole K2f, at K2S_SHAPES.  17a
# make_distill_step on 1 x 2 with 4 teachers: the first STEP_HELD_LAYERS
# served layers in float32 at PATH17_HELD_BATCH x STEP_HELD_SEQ tokens
# against the unsharded distill_grads on rank 0 (the loss within
# PATH17_LOSS_RTOL, the gathered gradients within STEP_SPREAD_FACTOR x the
# unsharded 1-ulp spread, as 16a holds its step; the step's Adam on the
# blocks equal to Adam on the gathered gradients, bit for bit), then one
# bf16 step at full depth at PATH17_DISTILL (K2s and K2b once a rank, K4 /
# K5 (K + 2) x 14b's per forward).  17b make_prefill_step in float32 at
# path 4's batch and prompt, T.serve_caches into JAX's kv_cache_rules
# layout (the sequence of a PATH17_MAX_SEQ cache over "model", every head
# on each rank) and PATH17_TOKENS tokens through make_serve_step on the
# mesh, whose cur_len crosses the shards' boundary at PATH17_MAX_SEQ / 2:
# zamba2-1.2b's and qwen3-8b's first PATH17_HELD_LAYERS layers (qwen3-8b's
# drawn as a 2-layer model at full width: 32 / 8 heads of D 128, the
# grouped-query case that made JAX split the sequence), each token's
# logits gathered within GQA_REL_ATOL of the largest against the unsharded
# prefill + decode_step on rank 0 (the gap beside PATH17_REPORT_REL
# printed); then zamba2-1.2b at full depth in bf16 (PATH17_FULL_TOKENS
# tokens): tokens/s, cache bytes a rank against the unsharded cache's, the
# reshard's bytes and seconds.  17c repeats 17b's zamba2 held check once on
# a 2 x 1 mesh at batch 1 (the batch released, the sequence over ("data",
# "model"), FSDP over "data"); qwen3-8b's check stays on the CPU there
# (tests/test_torch_mesh_serve.py): at batch 1 each decoded token would
# all-gather its 2.5 GB f32 embedding and head over "data" through host
# memory.
K2S_SHAPES = [(4, 64, 3), (4, 1024, 16000), (4, 256, 75968)]
K2S_PARTS = (2, 4)
PATH17_HELD_BATCH, PATH17_LOSS_RTOL = 2, 1e-6
PATH17_DISTILL = dict(n_teachers=4, batch_size=2, seq_len=512)
PATH17_HELD_LAYERS, PATH17_TOKENS, PATH17_FULL_TOKENS = 2, 8, 16
PATH17_MAX_SEQ = 2 * (SERVE_PROMPT + 2)
PATH17_REPORT_REL = 1e-5
PATH17_GQA = "qwen3-8b"
PATH17_TIMEOUT_S = 600


def k2s_bytes(k, b, v, elem) -> int:
    """Bytes K2s must move: teachers and student read once, six float32
    statistics a row written."""
    return k * b * v * elem + 4 * b * v + 6 * 4 * b


def k2s_phase(device):
    """K2s against its plain version at K2S_SHAPES, f32 and bf16
    teachers: the rows it finishes to (kl, lse_t, lse_s) at K2f's bounds;
    one row set split into 2 and 4 column chunks, merged, against whole
    K2f (the loss) and K2b (each chunk's gradient from the merged
    log-sum-exps); two launches equal bit for bit; timed at T = 1."""
    import torch
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ref
    rows, errors = [], []
    g1 = torch.ones((), device=device)
    for k, b, v in K2S_SHAPES:
        mode = k2.card_plan(device, k, b, v).mode
        for dtype_name in TEACHER_DTYPES:
            s, t = k2_case(k, b, v, dtype_name, seed=k + b + v + 1,
                           device=device)
            first = k2.kl_fwd_split(s, t)
            again = k2.kl_fwd_split(s, t)
            got = ref.kl_combine([first])
            want = ref.kl_combine([ref.kl_partial(s, t)])
            fwd = [excess(x, y, K2_FWD_RTOL, K2_FWD_ATOL)
                   for x, y in zip(got, want)]
            kl, lse_t, lse_s = k2.kl_fwd(s, t)
            ds = k2.kl_bwd(s, t, lse_t, lse_s, g1)
            merged = {}
            for parts in (p for p in K2S_PARTS if p <= v):
                cols = torch.tensor_split(torch.arange(v, device=device),
                                          parts)
                chunks = [(s[:, c].contiguous(), t[:, :, c].contiguous())
                          for c in cols]
                m_kl, m_lt, m_ls = ref.kl_combine(
                    [k2.kl_fwd_split(*c) for c in chunks])
                m_ds = torch.cat([k2.kl_bwd(*c, m_lt, m_ls, g1)
                                  for c in chunks], dim=1)
                loss, whole = float(m_kl.mean()), float(kl.mean())
                merged[parts] = {
                    "loss_err": abs(loss - whole),
                    "loss_ok": abs(loss - whole)
                    <= K2_FWD_ATOL + K2_FWD_RTOL * abs(whole),
                    "grad": excess(m_ds, ds, K2_GRAD_RTOL, K2_GRAD_ATOL)}
            torch.cuda.synchronize()
            ok = (all(e <= 0 for _, e in fwd) and torch.equal(first, again)
                  and all(m["loss_ok"] and m["grad"][1] <= 0
                          for m in merged.values()))
            errors.append({"K": k, "B": b, "V_loc": v,
                           "teachers": dtype_name, "mode": mode,
                           "fwd_err": max(e for e, _ in fwd),
                           "merged": merged,
                           "repeat_equal": torch.equal(first, again),
                           "ok": ok})
            ms = device_ms(lambda: k2.kl_fwd_split(s, t))
            plain = device_ms(lambda: ref.kl_partial(s, t))
            row = {"K": k, "B": b, "V_loc": v, "teachers": dtype_name,
                   "mode": mode, "ms": ms, "plain_ms": plain,
                   "call_ms": call_ms(lambda: k2.kl_fwd_split(s, t)),
                   **{kk: vv for kk, vv in bound(
                       k2s_bytes(k, b, v, t.element_size()),
                       2 * k * b * v + 14 * b * v).items()}}
            rows.append(row)
            del s, t, ds
    return rows, errors


def _p17_sync_s(fn, reps: int = 3) -> float:
    """The least of ``reps`` host-clock runs of ``fn`` between card
    synchronisations (a collective's wall, both ranks in it)."""
    import torch
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _p17_barrier(mesh, device) -> None:
    """Every rank of ``mesh`` here before a timed part (rank 0's
    unsharded references would otherwise count in the others' walls)."""
    import torch
    from repro_torch.common import sharding as shd
    shd.all_reduce_sum(torch.zeros(1, device=device), mesh)


def p17_gather_alternative(device, mesh) -> dict:
    """17k: the distill loss at each K2S_SHAPES shard (bf16 teachers) two
    ways over the model axis of ``mesh``: K2s and the merge over the
    ranks (what the port runs), and the logits all-gathered over "model"
    then whole K2f (what the ROADMAP weighed against it)."""
    import torch
    from repro_torch.common import sharding as shd
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ops
    out = []
    for k, b, v in K2S_SHAPES:
        s, t = k2_case(k, b, v, "bfloat16",
                       seed=k + b + v + shd.axis_index(mesh, "model"),
                       device=device)
        with torch.no_grad():
            split = _p17_sync_s(lambda: ops.ensemble_kl_loss_split(
                s, t, mesh, "model"))

            def gathered():
                sg = shd.all_gather(s, mesh, ("model",), dim=1)
                tg = shd.all_gather(t, mesh, ("model",), dim=2)
                k2.kl_fwd(sg, tg)
            whole = _p17_sync_s(gathered)
        out.append({"K": k, "B": b, "V_loc": v, "split_s": split,
                    "gathered_s": whole})
        del s, t
    torch.cuda.empty_cache()
    return {"shapes": out}


def p17_distill_held(device, mesh) -> tuple:
    """17a's held check: a float32 distill step of zamba2-1.2b's first
    STEP_HELD_LAYERS served layers with 4 teachers on ``mesh``, against
    the unsharded distill_grads (and its 1-ulp nudge) on rank 0."""
    import torch
    from repro_torch import configs
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers as topt
    cfg = configs.get(SERVE_ARCH)
    k = PATH17_DISTILL["n_teachers"]
    c7, p7 = served_f32(cfg, device)
    t7 = tree_map(lambda *xs: torch.stack(xs), *[
        served_f32(cfg, device, 1 + i)[1] for i in range(k)])
    batch = {"tokens": step_tokens(c7, (PATH17_HELD_BATCH, STEP_HELD_SEQ),
                                   3)["tokens"].to(device)}
    rep, problems = {"mesh": [shd.axis_size(mesh, a)
                              for a in shd.axis_names(mesh)]}, []
    ref = None
    if tmesh.world_rank() == 0:
        g, loss = steps.distill_grads(p7, t7, c7, batch, remat=False)
        ref = (flat32(g), float(loss))
        g_n, _ = steps.distill_grads(ulp_nudged(p7, 5), t7, c7, batch,
                                     remat=False)
        rep["ulp_spread"] = max(leaf_gaps(flat32(g_n), ref[0]).values())
        del g, g_n
    bundle = steps.make_distill_step(
        c7, mesh, n_teachers=k, batch_size=PATH17_HELD_BATCH,
        seq_len=STEP_HELD_SEQ, param_dtype=torch.float32)
    tp = bundle.layout
    student = shd.shard_tree(p7, tp.pspecs, mesh)
    teachers = shd.shard_tree(t7, shd.stacked_specs(tp.pspecs), mesh)
    opt = topt.AdamState(*(tree_map(torch.zeros_like, student)
                           for _ in range(2)))
    used = []
    orig = steps._adam_step

    def adam_step(o, params, opt_state, grads, step):
        used.append(tree_map(lambda x: x.clone(), grads))
        return orig(o, params, opt_state, grads, step)
    _p16_reset()
    steps._adam_step = adam_step
    try:
        t0 = time.perf_counter()
        _, _, _, loss = bundle.fn(student, teachers, opt,
                                  torch.zeros((), dtype=torch.int32),
                                  steps.batch_block(batch, tp))
        torch.cuda.synchronize()
        rep["step_s"] = time.perf_counter() - t0
    finally:
        steps._adam_step = orig
    rep.update(_p16_counts())
    rep["loss"] = float(loss)
    g_whole = shd.gather_tree(used[0], tp.pspecs, mesh)
    stepped = tree_leaves(shd.gather_tree(student, tp.pspecs, mesh))
    if ref is not None:
        w = tree_leaves(p7)
        o = topt.adam(1e-3)
        deltas, _ = o.update(tree_leaves(g_whole), o.init(w), w, 0)
        rep["adam_equal"] = all(torch.equal(a, b) for a, b in zip(
            stepped, topt.apply_updates(w, deltas)))
        gaps = leaf_gaps(flat32(g_whole), ref[0])
        rep["grad_gap"] = max(gaps.values())
        rep["worst_leaves"] = sorted(gaps, key=gaps.get, reverse=True)[:3]
        rep["loss_rel"] = abs(rep["loss"] - ref[1]) / abs(ref[1])
        rep["bound"] = STEP_SPREAD_FACTOR * rep["ulp_spread"]
        rep["held"] = (rep["loss_rel"] <= PATH17_LOSS_RTOL
                       and rep["grad_gap"] <= rep["bound"]
                       and rep["adam_equal"])
        if not rep["held"]:
            problems.append(f"held distill step on {rep['mesh']}: {rep}")
    del p7, t7, student, teachers, opt, used, g_whole, stepped
    torch.cuda.empty_cache()
    return rep, problems


def p17_distill_full(device, mesh) -> tuple:
    """17a at full depth: make_distill_step on zamba2-1.2b in bf16 at
    PATH17_DISTILL on ``mesh``: one step, its seconds, peak memory a rank,
    collectives by axis, launches (K2s and K2b once, K4 / K5 (K + 2)
    forwards' worth)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import steps
    cfg = configs.get(SERVE_ARCH)
    bundle = steps.make_distill_step(cfg, mesh, **PATH17_DISTILL)
    k = PATH17_DISTILL["n_teachers"]
    rep, problems = dict(PATH17_DISTILL), []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = bundle.init_args(torch.Generator(device=device).manual_seed(0),
                            device)
    rep["init_s"] = time.perf_counter() - t0
    _p17_barrier(mesh, device)
    _p16_reset()
    t0 = time.perf_counter()
    _, _, _, loss = bundle.fn(*args)
    torch.cuda.synchronize()
    rep["step_s"] = time.perf_counter() - t0
    rep.update(_p16_counts())
    rep["loss"] = float(loss)
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    rep["vocab_local"] = int(args[0]["embed"].shape[0])
    want = {"swa_attn": (k + 2) * STEP_K4, "ssd_scan": (k + 2) * STEP_K5,
            "ensemble_kl_split_fwd": 1, "ensemble_kl_bwd": 1}
    if rep["launches"] != want or not math.isfinite(rep["loss"]):
        problems.append(f"17a full depth: launches {rep['launches']} "
                        f"(expected {want}), loss {rep['loss']}")
    del args, bundle
    torch.cuda.empty_cache()
    return rep, problems


def p17_serve(mesh, cfg, params, toks, dtype, n_tokens, max_seq,
              held: bool, ref=None, layout: str = "tp",
              prompt: int = SERVE_PROMPT) -> dict:
    """make_prefill_step (under ``layout``'s rules) of the first
    ``prompt`` tokens, T.serve_caches and ``n_tokens`` decode steps of
    make_serve_step on ``mesh`` from the whole ``params``: the seconds of
    each part, the caches' bytes a rank, the reshard's collectives, the
    launches.  With ``held`` (on every rank) each token's logits are
    gathered, and held against ``ref`` (rank 0's unsharded logits per
    token) where it is given; else the last token's."""
    import torch
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.configs import InputShape
    b = toks.shape[0]
    pre = steps.make_prefill_step(
        cfg, InputShape("prefill_card", max_seq, b, "prefill"), mesh,
        layout=layout, param_dtype=dtype)
    serve = steps.make_serve_step(
        cfg, InputShape("decode_card", max_seq, b, "decode"), mesh,
        param_dtype=dtype, cache_dtype=dtype)
    local = shd.shard_tree(params, pre.layout.pspecs, mesh)
    rep = {"batch": b, "prompt": prompt, "tokens": n_tokens,
           "max_seq": max_seq}
    _p17_barrier(mesh, toks.device)
    _p16_reset()
    t0 = time.perf_counter()
    _, caches = pre.fn(local, steps.batch_block(
        {"tokens": toks[:, :prompt]}, pre.layout))
    torch.cuda.synchronize()
    rep["prefill_s"] = time.perf_counter() - t0
    rep["prefill"] = _p16_counts()
    rep["heads_cache_bytes"] = sum(x.numel() * x.element_size()
                                   for x in tree_leaves(caches))
    _p16_reset()
    t0 = time.perf_counter()
    caches = T.serve_caches(caches, cfg, pre.layout, serve.layout)
    torch.cuda.synchronize()
    rep["reshard_s"] = time.perf_counter() - t0
    rep["reshard"] = _p16_counts()
    rep["cache_bytes"] = sum(x.numel() * x.element_size()
                             for x in tree_leaves(caches))
    rep["unsharded_cache_bytes"] = sum(
        x.numel() * x.element_size() for x in tree_leaves(
            T.init_caches(cfg, b, max_seq, dtype, "meta")))
    tp, errs, scale = serve.layout, [], 0.0
    if layout != "tp":       # the serve step's blocks are the tp layout's
        local = shd.shard_tree(params, tp.pspecs, mesh)
    _p16_reset()
    t0 = time.perf_counter()
    for i in range(n_tokens):
        tok = steps.batch_block(
            {"tokens": toks[:, prompt + i:prompt + i + 1]}, tp)
        logits, caches = serve.fn(local, tok, caches, prompt + i)
        if held or i == n_tokens - 1:
            whole = shd.gather_tensor(logits, shd.P(
                tp.batch_entry, None,
                "model" if logits.shape[-1] != cfg.vocab_size else None),
                mesh)
            rep["finite"] = torch_isfinite(whole)
            if ref is not None:
                scale = max(scale, float(ref[i].abs().max()))
                errs.append(float((whole.float() - ref[i]).abs().max()))
    torch.cuda.synchronize()
    rep["decode_s"] = time.perf_counter() - t0
    rep["decode"] = _p16_counts()
    rep["tokens_per_s"] = b * n_tokens / rep["decode_s"]
    if errs:
        rep.update(err=max(errs), errs=errs, max_abs_logit=scale,
                   atol=GQA_REL_ATOL * scale,
                   held=max(errs) <= GQA_REL_ATOL * scale)
    del local, caches
    return rep


def p17_unsharded(cfg, params, toks, n_tokens, max_seq) -> list:
    """Rank 0's unsharded prefill + decode_step logits per token."""
    import torch
    from repro_torch.models import transformer as T
    with torch.no_grad():
        _, caches = T.prefill(params, cfg,
                              {"tokens": toks[:, :SERVE_PROMPT]}, max_seq)
        out = []
        for i in range(n_tokens):
            lg, caches = T.decode_step(
                params, cfg,
                {"tokens": toks[:, SERVE_PROMPT + i:SERVE_PROMPT + i + 1]},
                caches, SERVE_PROMPT + i)
            out.append(lg.float())
    return out


def p17_serve_held(device, mesh, arch: str, batch: int,
                   layout: str = "tp") -> tuple:
    """17b / 17c's held check: ``arch``'s first PATH17_HELD_LAYERS layers
    in float32 (zamba2-1.2b's served layers; qwen3-8b drawn as a model of
    that many layers at full width), ``batch`` sequences, the prefill
    under ``layout``'s rules (18c: ``dp_heavy``)."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer as T
    c = configs.get(arch)
    gen = torch.Generator(device=device).manual_seed(0)
    if arch == SERVE_ARCH:
        whole = T.init(c, gen, torch.float32, device)
        cn, pn = served_layers(whole, c, PATH17_HELD_LAYERS)
        pn = tree_map(lambda x: x.clone(), pn)
        del whole
    else:
        cn = dataclasses.replace(c, n_layers=PATH17_HELD_LAYERS)
        pn = T.init(cn, gen, torch.float32, device)
    toks = step_tokens(cn, (SERVE_BATCH, SERVE_PROMPT + PATH17_TOKENS),
                       2)["tokens"][:batch].to(device)
    ref = (p17_unsharded(cn, pn, toks, PATH17_TOKENS, PATH17_MAX_SEQ)
           if tmesh.world_rank() == 0 else None)
    rep = p17_serve(mesh, cn, pn, toks, torch.float32, PATH17_TOKENS,
                    PATH17_MAX_SEQ, True, ref, layout)
    rep.update(arch=arch, layers=PATH17_HELD_LAYERS, layout=layout)
    problems = []
    if ref is not None and not rep["held"]:
        problems.append(f"{arch} first {PATH17_HELD_LAYERS} layers: {rep}")
    del pn, ref
    torch.cuda.empty_cache()
    return rep, problems


def p17_serve_full(device, mesh) -> tuple:
    """17b at full depth: zamba2-1.2b in bf16 at path 4's batch and
    prompt, PATH17_FULL_TOKENS tokens (K4 and K5 only in the prefill)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = configs.get(SERVE_ARCH)
    params = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                    torch.bfloat16, device)
    toks = step_tokens(cfg, (SERVE_BATCH, SERVE_PROMPT + PATH17_FULL_TOKENS),
                       2)["tokens"].to(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rep = p17_serve(mesh, cfg, params, toks, torch.bfloat16,
                    PATH17_FULL_TOKENS, SERVE_PROMPT + PATH17_FULL_TOKENS,
                    False)
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    problems = []
    want = {"swa_attn": SERVE_K4, "ssd_scan": SERVE_K5}
    if (rep["prefill"]["launches"] != want or rep["decode"]["launches"]
            or not rep["finite"]):
        problems.append(f"17b full depth: prefill launches "
                        f"{rep['prefill']['launches']} (expected {want}), "
                        f"decode {rep['decode']['launches']} (expected "
                        f"none), finite {rep['finite']}")
    del params
    torch.cuda.empty_cache()
    return rep, problems


def path17_rank(device, parts=("17k", "17a", "17b", "17c")) -> dict:
    """One rank of path 17's 2-rank world: the 1 x 2 mesh's parts, then
    17c's 2 x 1 mesh, each part with its own counts; a part that raises
    ends the rank (and the launch)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device())
              if device == "cuda" else torch.device(device))
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_debug_mesh(1, 2)
    out, problems = {"rank": tmesh.world_rank(),
                     "backend": tmesh._WORLD["backend"]}, []
    for part in parts:
        t0 = time.perf_counter()
        p = []
        if part == "17k":
            out["17k"] = p17_gather_alternative(device, mesh)
        elif part == "17a":
            out["17a_held"], p = p17_distill_held(device, mesh)
            out["17a_full"], more = p17_distill_full(device, mesh)
            p += more
        elif part == "17b":
            out["17b_held"], p = p17_serve_held(device, mesh, SERVE_ARCH,
                                                SERVE_BATCH)
            out["17b_gqa"], more = p17_serve_held(device, mesh, PATH17_GQA,
                                                  SERVE_BATCH)
            out["17b_full"], more2 = p17_serve_full(device, mesh)
            p += more + more2
        else:
            out["17c_held"], p = p17_serve_held(
                device, tmesh.make_debug_mesh(2, 1), SERVE_ARCH, 1)
        problems += [f"{part}: {x}" for x in p]
        out[f"{part}_s"] = time.perf_counter() - t0
    out["problems"] = problems
    return out


def mesh_serve_path(device, k2s_rows=()):
    """Path 17 on 2 ranks sharing the card (``launch_ranks``)."""
    import torch
    from repro_torch.launch import mesh as tmesh
    device = torch.device(device).type
    rep, problems = {"card": card_line()}, []
    rep["ranks"] = tmesh.launch_ranks(path17_rank, 2, device,
                                      args=(device,), threads=4,
                                      timeout_s=PATH17_TIMEOUT_S)
    problems += [f"rank {r['rank']}: {p}" for r in rep["ranks"]
                 for p in r["problems"]]
    rep["k2s_rows"] = list(k2s_rows)
    return rep, problems


def print_path17(rep) -> None:
    gib = 2 ** 30
    print(f"  path17 on {rep['card']}:")
    alt = {(a["K"], a["B"], a["V_loc"]): a
           for a in rep["ranks"][0]["17k"]["shapes"]}
    for r in rep["k2s_rows"]:
        a = alt.get((r["K"], r["B"], r["V_loc"]), {})
        print(f"  path17 K2s K={r['K']} B={r['B']} V_loc={r['V_loc']} "
              f"{r['teachers']} mode {r['mode']}: {r['ms'] * 1e3:.2f} us "
              f"device / {r['call_ms'] * 1e3:.2f} us per call, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} at 3.35 "
              f"TB/s, plain {r['plain_ms'] * 1e3:.2f} us"
              + (f"; over 2 gloo ranks (bf16): split + merge "
                 f"{a['split_s'] * 1e3:.2f} ms, logits all-gathered + "
                 f"whole K2f {a['gathered_s'] * 1e3:.2f} ms"
                 if a and r["teachers"] == "bfloat16" else ""))
    for r in rep["ranks"]:
        h, f = r["17a_held"], r["17a_full"]
        print(f"  path17 17a rank {r['rank']} ({r['backend']}) held "
              f"{STEP_HELD_LAYERS} layers f32, 4 teachers on 1 x 2: loss "
              f"{h['loss']:.7f}"
              + (f", rel {h['loss_rel']:.2e}, gradient gap "
                 f"{h['grad_gap']:.3g} against 4 x the unsharded 1-ulp "
                 f"spread {h['ulp_spread']:.3g} (worst "
                 f"{h['worst_leaves']}), Adam on the blocks equal "
                 f"{h['adam_equal']}" if "held" in h else "")
              + f"; {h['step_s']:.2f} s, launches {h['launches']}; "
              f"{coll_line(h)}")
        print(f"  path17 17a rank {r['rank']} full depth bf16 "
              f"{f['batch_size']} x {f['seq_len']}, {f['n_teachers']} "
              f"teachers: step {f['step_s']:.2f} s (init {f['init_s']:.1f}"
              f" s), loss {f['loss']:.6f}, peak "
              f"{f['peak_mem_bytes'] / gib:.2f} GiB, vocabulary "
              f"{f['vocab_local']} a rank, launches {f['launches']}; "
              f"{coll_line(f)}")
        for key in ("17b_held", "17b_gqa", "17c_held"):
            s = r[key]
            held = (f", gap {s['err']:.3g} of a {s['max_abs_logit']:.4g} "
                    f"largest ({s['err'] / s['max_abs_logit']:.2e} of it; "
                    f"reported against {PATH17_REPORT_REL:.0e}, gate "
                    f"{GQA_REL_ATOL:.0e}) held {s['held']}"
                    if "held" in s else "")
            print(f"  path17 {key} rank {r['rank']} {s['arch']} first "
                  f"{s['layers']} layers f32 batch {s['batch']}: prefill "
                  f"{s['prefill_s']:.3f} s, reshard {s['reshard_s']:.3f} s "
                  f"({coll_line(s['reshard'])}), {s['tokens']} tokens "
                  f"{s['decode_s']:.3f} s{held}")
        s = r["17b_full"]
        print(f"  path17 17b rank {r['rank']} full depth bf16 batch "
              f"{s['batch']} prompt {s['prompt']}: prefill "
              f"{s['prefill_s']:.3f} s ({coll_line(s['prefill'])}), reshard "
              f"{s['reshard_s']:.3f} s ({coll_line(s['reshard'])}), "
              f"{s['tokens']} tokens {s['decode_s']:.3f} s = "
              f"{s['tokens_per_s']:.1f} tokens/s ({coll_line(s['decode'])}); "
              f"cache {s['cache_bytes'] / 1e6:.1f} MB a rank against "
              f"{s['unsharded_cache_bytes'] / 1e6:.1f} MB unsharded "
              f"(at its heads after prefill "
              f"{s['heads_cache_bytes'] / 1e6:.1f} MB); peak "
              f"{s['peak_mem_bytes'] / gib:.2f} GiB; launches prefill "
              f"{s['prefill']['launches']} decode {s['decode']['launches']}")
        print(f"  path17 rank {r['rank']}: " + ", ".join(
            f"{p} {r[f'{p}_s']:.1f} s" for p in ("17k", "17a", "17b",
                                                  "17c")))
    print(f"  path17: whole path {rep['total_s']:.1f} s", flush=True)


# Path 18 (after path 17): JAX's other step-builder layouts on a mesh
# (items 11.8.4 (a)-(b)), on 2 gloo ranks sharing the card as paths 16-17
# do, zamba2-1.2b at full width.  18a holds the first STEP_HELD_LAYERS
# served layers in float32, one make_train_step at PATH18_HELD_BATCH x
# STEP_HELD_SEQ tokens (one row a rank under dp_heavy) from zero Adam
# moments, the gradients its Adam takes against the unsharded step's as
# 16a holds its step: under dp_heavy and
# dp_heavy_z3 (every leaf gathered whole where it runs, the batch over
# both axes) the gathered gradients within STEP_SPREAD_FACTOR x the
# unsharded 1-ulp spread and the loss within PATH18_LOSS_RTOL; under tp
# with constrain_acts (JAX's activation sharding, checked and changing
# nothing) equal bit for bit to the step without it (the gradients, the
# updated blocks and moments, the loss); under tp with
# naive_xent (the logits all-gathered over "model") the loss within
# PATH18_LOSS_RTOL of token_xent's and the gradients within the spread
# bound; and 17a's held distill step with constrain_acts equal bit for bit
# to the one without it.  18b: make_train_step at full depth in bf16 under
# dp_heavy_z3, one step at PATH18_TRAIN_BATCH x STEP_TRAIN_SEQ (one row a
# rank: no microbatches, which would split a row): seconds, peak memory a
# rank, collectives by axis, K4 / K5 at every head (two forwards' worth:
# the forward and remat's recompute), every leaf's gradient block finite
# and non-zero.  18c: 17b's held serve check (the first PATH17_HELD_LAYERS
# layers, path 4's batch and prompt, PATH17_TOKENS tokens) with the
# prefill under dp_heavy (every head, the batch over both axes) and
# T.serve_caches into the tp serve layout.
# Four cards (``chip_smoke.py --four``: NCCL, one rank a card, 2 x 2; not
# part of the run with no arguments): 18a's held checks at
# PATH18_HELD_BATCH_2X2 rows, then PATH18_FOUR's full-depth bf16 steps at
# PATH18_FOUR_BATCH x STEP_TRAIN_SEQ (one row a rank): phi3-medium-14b
# (arXiv:2404.14219) under dp_heavy_z3, whose bf16 weights and f32 Adam
# moments (~147 GB) fit no one card, and minicpm-2b (arXiv:2404.06395)
# under dp_heavy, its odd vocabulary whole on "model" as JAX's fitted spec
# leaves it; each a finite loss equal on every rank and every leaf's
# gradient block finite and non-zero; seconds, MFU over the four cards,
# peak memory a card, collectives.
PATH18_HELD_BATCH, PATH18_HELD_BATCH_2X2 = 2, 4
PATH18_LOSS_RTOL = 1e-6
PATH18_TRAIN_BATCH, PATH18_FOUR_BATCH = 2, 4
PATH18_FULL_LAYOUT = "dp_heavy_z3"
PATH18_FOUR = (("phi3-medium-14b", "dp_heavy_z3"), ("minicpm-2b", "dp_heavy"))
PATH18_TIMEOUT_S, PATH18_FOUR_TIMEOUT_S = 600, 1500


def layer_mixers(cfg) -> dict:
    """{"attention": layers, "mamba": layers} of ``cfg`` (K4 and K5
    launches per forward)."""
    from repro_torch.models import transformer as T
    p, n_full, rem = T._layout(cfg)
    kinds = [cfg.pattern[j].mixer for j in range(p)] * n_full + [
        cfg.pattern[j].mixer for j in range(rem)]
    mamba = sum(k == "mamba" for k in kinds)
    return {"attention": len(kinds) - mamba, "mamba": mamba}


def p18_held(device, mesh, rows: int) -> tuple:
    """18a: a float32 make_train_step of zamba2-1.2b's first
    STEP_HELD_LAYERS served layers on ``mesh`` under each layout and knob,
    from the unsharded blocks and zero Adam moments: the gradients its Adam
    takes against the unsharded step's, or (with its updated blocks and
    moments) against the same step without the knob.  Every rank takes
    the unsharded step (so every rank's first backward comes before the
    timed steps) and holds its blocks against the same blocks of it; the
    per-leaf largest gaps are merged over the ranks (the gathered
    gradients' gaps, without gathering them); rank 0 also takes it at a
    1-ulp nudge for the spread and gates."""
    import torch
    from repro_torch import configs
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_map
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers as topt
    cfg = configs.get(SERVE_ARCH)
    c7, p7 = served_f32(cfg, device)
    batch = {k: v.to(device) for k, v in step_tokens(
        c7, (rows, STEP_HELD_SEQ), 1).items()}
    rep, problems = {"mesh": [shd.axis_size(mesh, a)
                              for a in shd.axis_names(mesh)],
                     "rows": rows}, []
    rank0 = tmesh.world_rank() == 0
    ref, m = steps.train_grads(p7, c7, batch, remat=False)
    ref_loss, flat_ref = float(m["loss"]), tree_flatten(ref)
    keys = sorted(flat_ref)
    ref_max = torch.tensor([max(float(flat_ref[k].abs().max()), 1e-30)
                            for k in keys], dtype=torch.float64)
    if rank0:
        g_n, _ = steps.train_grads(ulp_nudged(p7, 5), c7, batch, remat=False)
        rep["ulp_spread"] = max(leaf_gaps(flat32(g_n),
                                          flat32(ref)).values())
        rep["bound"] = STEP_SPREAD_FACTOR * rep["ulp_spread"]
        del g_n
    shape = configs.InputShape("held_card", STEP_HELD_SEQ, rows, "train")
    blocks, took, orig = {}, [], steps._adam_step

    def adam_step(opt, params, opt_state, grads, step):
        took.append(grads)
        return orig(opt, params, opt_state, grads, step)
    steps._adam_step = adam_step
    try:
        for name, layout, acts, naive in (
                ("dp_heavy", "dp_heavy", False, False),
                ("dp_heavy_z3", "dp_heavy_z3", False, False),
                ("tp", "tp", False, False), ("tp_acts", "tp", True, False),
                ("tp_naive", "tp", False, True)):
            bundle = steps.make_train_step(
                c7, shape, mesh, layout=layout, constrain_acts=acts,
                naive_xent=naive, param_dtype=torch.float32)
            tp = bundle.layout
            local = shd.shard_tree(p7, tp.pspecs, mesh)
            opt = topt.AdamState(*(tree_map(torch.zeros_like, local)
                                   for _ in range(2)))
            _p17_barrier(mesh, device)
            _p16_reset()
            t0 = time.perf_counter()
            local, opt, _, m = bundle.fn(local, opt,
                                         torch.zeros((), dtype=torch.int32),
                                         steps.batch_block(batch, tp))
            torch.cuda.synchronize()
            r = {"step_s": time.perf_counter() - t0, **_p16_counts(),
                 "loss": float(m["loss"]), "batch_axes": list(tp.batch_axes)}
            g = took.pop()
            if name in ("tp", "tp_acts"):         # 16a holds tp's gradients
                blocks[name] = (tree_leaves((g, local, opt)), r["loss"])
            else:
                got = tree_flatten(g)
                want = tree_flatten(shd.shard_tree(ref, tp.pspecs, mesh))
                gap = torch.stack([(got[k] - want[k]).abs().max().double()
                                   for k in keys])   # where the blocks live
                gap = shd.all_reduce_max(gap, mesh,
                                         shd.axis_names(mesh)).cpu()
                if rank0:
                    gaps = dict(zip(keys, (gap / ref_max).tolist()))
                    r["grad_gap"] = max(gaps.values())
                    r["worst_leaves"] = sorted(gaps, key=gaps.get,
                                               reverse=True)[:3]
                    r["loss_rel"] = abs(r["loss"] - ref_loss) / abs(ref_loss)
                del want
            rep[name] = r
            del local, opt, g
    finally:
        steps._adam_step = orig
    for name, base in (("tp_acts", "tp"),):
        (a, la), (b, lb) = blocks[name], blocks[base]
        rep[name]["bit_equal"] = la == lb and all(
            torch.equal(x, y) for x, y in zip(a, b))
        if not rep[name]["bit_equal"]:
            problems.append(f"{name} differs from {base} in its bits")
    if rank0:
        for name in ("dp_heavy", "dp_heavy_z3", "tp_naive"):
            r = rep[name]
            r["held"] = (r["loss_rel"] <= PATH18_LOSS_RTOL
                         and r["grad_gap"] <= rep["bound"])
            if not r["held"]:
                problems.append(f"held {name} step on {rep['mesh']}: {r}")
        rep["tp_naive"]["loss_vs_token_xent"] = abs(
            rep["tp_naive"]["loss"] - rep["tp"]["loss"]) / abs(
                rep["tp"]["loss"])
        if rep["tp_naive"]["loss_vs_token_xent"] > PATH18_LOSS_RTOL:
            problems.append(f"naive_xent's loss off token_xent's: "
                            f"{rep['tp_naive']}")
    del p7, ref, blocks
    torch.cuda.empty_cache()
    return rep, problems


def p18_distill_acts(device, mesh) -> tuple:
    """18a: 17a's held distill step (STEP_HELD_LAYERS float32 layers, 4
    teachers, PATH17_HELD_BATCH x STEP_HELD_SEQ) with constrain_acts,
    equal bit for bit to the same step without it."""
    import torch
    from repro_torch import configs
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers as topt
    cfg = configs.get(SERVE_ARCH)
    k = PATH17_DISTILL["n_teachers"]
    c7, p7 = served_f32(cfg, device)
    t7 = tree_map(lambda *xs: torch.stack(xs), *[
        served_f32(cfg, device, 1 + i)[1] for i in range(k)])
    batch = {"tokens": step_tokens(c7, (PATH17_HELD_BATCH, STEP_HELD_SEQ),
                                   3)["tokens"].to(device)}
    out, rep = {}, {}
    for acts in (True, False):
        bundle = steps.make_distill_step(
            c7, mesh, n_teachers=k, batch_size=PATH17_HELD_BATCH,
            seq_len=STEP_HELD_SEQ, constrain_acts=acts,
            param_dtype=torch.float32)
        tp = bundle.layout
        student = shd.shard_tree(p7, tp.pspecs, mesh)
        teachers = shd.shard_tree(t7, shd.stacked_specs(tp.pspecs), mesh)
        opt = topt.AdamState(*(tree_map(torch.zeros_like, student)
                               for _ in range(2)))
        _p17_barrier(mesh, device)
        _p16_reset()
        t0 = time.perf_counter()
        _, opt, _, loss = bundle.fn(student, teachers, opt,
                                    torch.zeros((), dtype=torch.int32),
                                    steps.batch_block(batch, tp))
        torch.cuda.synchronize()
        rep[f"acts_{acts}"] = {"step_s": time.perf_counter() - t0,
                               **_p16_counts(), "loss": float(loss)}
        out[acts] = (tree_leaves((student, opt)), float(loss))
        del teachers
    rep["bit_equal"] = out[True][1] == out[False][1] and all(
        torch.equal(x, y) for x, y in zip(out[True][0], out[False][0]))
    problems = [] if rep["bit_equal"] else [
        f"the distill step with constrain_acts differs in its bits: {rep}"]
    del p7, t7, out
    torch.cuda.empty_cache()
    return rep, problems


def p18_full_train(device, mesh, arch: str, layout: str, batch: int,
                   cards: int) -> tuple:
    """make_train_step on ``arch`` at full width and depth in bf16 under
    ``layout`` on ``mesh``, one step of ``batch`` x STEP_TRAIN_SEQ: its
    seconds (after every rank has arrived), MFU over ``cards`` cards,
    peak memory, collectives, launches (K4 / K5 at every head, two
    forwards' worth), every leaf's gradient block finite and non-zero."""
    import torch
    from repro_torch import configs
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.launch import steps
    cfg = configs.get(arch)
    shape = configs.InputShape("train_4k_card", STEP_TRAIN_SEQ, batch,
                               "train")
    bundle = steps.make_train_step(cfg, shape, mesh, layout=layout)
    problems = []
    rep = {"arch": arch, "layout": layout, "batch": batch,
           "seq": STEP_TRAIN_SEQ, "batch_axes": list(bundle.layout.batch_axes),
           "param_bytes_rank": sum(m.numel() * m.element_size()
                                   for m in tree_flatten(
                                       bundle.args[0]).values())}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = bundle.init_args(torch.Generator(device=device).manual_seed(0),
                            device)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    rep["init_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    flags = []
    orig = steps._adam_step

    def adam_step(opt, params, opt_state, grads, step):
        flags.append({k: torch.stack([torch.isfinite(g).all(),
                                      g.abs().max() > 0])
                      for k, g in tree_flatten(grads).items()})
        return orig(opt, params, opt_state, grads, step)
    steps._adam_step = adam_step
    try:
        _p17_barrier(mesh, device)
        _p16_reset()
        t0 = time.perf_counter()
        _, _, _, metrics = bundle.fn(*args)
        torch.cuda.synchronize()
        rep["step_s"] = time.perf_counter() - t0
    finally:
        steps._adam_step = orig
    rep.update(_p16_counts())
    rep["loss"] = float(metrics["loss"])
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    tokens = batch * STEP_TRAIN_SEQ
    rep["mfu"] = (6 * cfg.active_param_count() * tokens
                  / (rep["step_s"] * cards * BF16_FLOPS_PER_S))
    mixers = layer_mixers(cfg)
    want = {k: 2 * n for k, n in (("swa_attn", mixers["attention"]),
                                  ("ssd_scan", mixers["mamba"])) if n}
    if rep["launches"] != want:
        problems.append(f"{arch} launched {rep['launches']}, expected "
                        f"{want}")
    if not math.isfinite(rep["loss"]):
        problems.append(f"{arch} loss {rep['loss']}")
    bad = [k for k, f in flags[0].items() if not bool(f.all())]
    rep["grad_leaves"], rep["grad_bad_leaves"] = len(flags[0]), bad
    if bad:
        problems.append(f"{arch}: leaves without a finite non-zero gradient "
                        f"block: {bad}")
    rep["kernel_dtypes"] = kernel_dtypes()
    del args, bundle, flags
    torch.cuda.empty_cache()
    return rep, problems


def path18_rank(device, shape=(1, 2), parts=("18a", "18b", "18c"),
                cards: int = 1) -> dict:
    """One rank of path 18's ``shape`` mesh: the parts in order, each
    with its own counts; a part that raises ends the rank (and the
    launch)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device())
              if device == "cuda" else torch.device(device))
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_mesh(shape, ("data", "model"))
    out, problems = {"rank": tmesh.world_rank(),
                     "backend": tmesh._WORLD["backend"]}, []
    rows = PATH18_HELD_BATCH if shape == (1, 2) else PATH18_HELD_BATCH_2X2
    for part in parts:
        t0 = time.perf_counter()
        p = []
        if part == "18a":
            out["18a_train"], p = p18_held(device, mesh, rows)
            out["18a_distill"], more = p18_distill_acts(device, mesh)
            p += more
        elif part == "18b":
            out["18b"], p = p18_full_train(
                device, mesh, SERVE_ARCH, PATH18_FULL_LAYOUT,
                PATH18_TRAIN_BATCH, cards)
        elif part == "18c":
            out["18c"], p = p17_serve_held(device, mesh, SERVE_ARCH,
                                           SERVE_BATCH, "dp_heavy")
        else:                          # a PATH18_FOUR model
            out[part], p = p18_full_train(device, mesh, part,
                                          dict(PATH18_FOUR)[part],
                                          PATH18_FOUR_BATCH, cards)
        problems += [f"{part}: {x}" for x in p]
        out[f"{part}_s"] = time.perf_counter() - t0
    out["problems"] = problems
    return out


def layouts_path(device):
    """Path 18 on 2 ranks sharing the card (``launch_ranks``).  Its parts
    run in turn: 18b beside 18a's ranks overflows the card's 80 GB."""
    import torch
    from repro_torch.launch import mesh as tmesh
    device = torch.device(device).type
    rep, problems = {"card": card_line()}, []
    rep["ranks"] = tmesh.launch_ranks(path18_rank, 2, device,
                                      args=(device,), threads=4,
                                      timeout_s=PATH18_TIMEOUT_S)
    problems += [f"rank {r['rank']}: {p}" for r in rep["ranks"]
                 for p in r["problems"]]
    losses = {r["18b"]["loss"] for r in rep["ranks"]}
    if len(losses) != 1:
        problems.append(f"18b: the ranks' losses differ {losses}")
    return rep, problems


def layouts_four_path():
    """Path 18's four-card part: 18a on 2 x 2, then PATH18_FOUR's steps,
    one NCCL rank a card."""
    from repro_torch.launch import mesh as tmesh
    rep, problems = {"card": card_line()}, []
    parts = ("18a",) + tuple(a for a, _ in PATH18_FOUR)
    rep["ranks"] = tmesh.launch_ranks(
        path18_rank, 4, "cuda", args=("cuda", (2, 2), parts, 4), threads=4,
        timeout_s=PATH18_FOUR_TIMEOUT_S)
    problems += [f"rank {r['rank']}: {p}" for r in rep["ranks"]
                 for p in r["problems"]]
    for arch, _ in PATH18_FOUR:
        losses = {r[arch]["loss"] for r in rep["ranks"]}
        if len(losses) != 1:
            problems.append(f"{arch}: the ranks' losses differ {losses}")
    return rep, problems


def print_path18(rep) -> None:
    gib = 2 ** 30
    print(f"  path18 on {rep['card']}:")
    for r in rep["ranks"]:
        if "18a_train" in r:
            h = r["18a_train"]
            for name in ("dp_heavy", "dp_heavy_z3", "tp", "tp_acts",
                         "tp_naive"):
                s = h[name]
                print(f"  path18 18a rank {r['rank']} ({r['backend']}) "
                      f"{name} held {STEP_HELD_LAYERS} layers f32 batch "
                      f"{h['rows']} x {STEP_HELD_SEQ} on {h['mesh']} (rows "
                      f"over {s['batch_axes']}): loss {s['loss']:.7f}"
                      + (f", rel {s['loss_rel']:.2e}, gradient gap "
                         f"{s['grad_gap']:.3g} against 4 x the unsharded "
                         f"1-ulp spread {h['ulp_spread']:.3g} (worst "
                         f"{s['worst_leaves']})" if "grad_gap" in s else "")
                      + (f", bit for bit {s['bit_equal']}"
                         if "bit_equal" in s else "")
                      + (f", loss against token_xent's "
                         f"{s['loss_vs_token_xent']:.2e}"
                         if "loss_vs_token_xent" in s else "")
                      + f"; {s['step_s']:.2f} s, launches {s['launches']}; "
                      f"{coll_line(s)}")
            d = r["18a_distill"]
            print(f"  path18 18a rank {r['rank']} distill held with "
                  f"constrain_acts bit for bit {d['bit_equal']}: loss "
                  f"{d['acts_True']['loss']:.7f}, "
                  f"{d['acts_True']['step_s']:.2f} s, launches "
                  f"{d['acts_True']['launches']}")
        for key in ["18b"] + [a for a, _ in PATH18_FOUR]:
            if key not in r:
                continue
            f = r[key]
            print(f"  path18 {key} rank {r['rank']} {f['arch']} "
                  f"{f['layout']} full depth bf16 batch {f['batch']} x "
                  f"{f['seq']} (rows over {f['batch_axes']}): step "
                  f"{f['step_s']:.3f} s (init {f['init_s']:.1f} s, peak "
                  f"{f['init_peak_bytes'] / gib:.2f} GiB), loss "
                  f"{f['loss']:.6f}, MFU {f['mfu']:.4f}, peak "
                  f"{f['peak_mem_bytes'] / gib:.2f} GiB, parameters "
                  f"{f['param_bytes_rank'] / 1e9:.2f} GB a rank, "
                  f"{f['grad_leaves']} gradient blocks finite and non-zero "
                  f"{not f['grad_bad_leaves']}, launches {f['launches']} "
                  f"{f['kernel_dtypes']}; {coll_line(f)}")
        if "18c" in r:
            s = r["18c"]
            held = (f", gap {s['err']:.3g} of a {s['max_abs_logit']:.4g} "
                    f"largest (gate {GQA_REL_ATOL:.0e}) held {s['held']}"
                    if "held" in s else "")
            print(f"  path18 18c rank {r['rank']} {s['arch']} first "
                  f"{s['layers']} layers f32 batch {s['batch']}, prefill "
                  f"{s['layout']}: prefill {s['prefill_s']:.3f} s "
                  f"({coll_line(s['prefill'])}), reshard {s['reshard_s']:.3f} s "
                  f"({coll_line(s['reshard'])}), {s['tokens']} tokens "
                  f"{s['decode_s']:.3f} s{held}")
        print(f"  path18 rank {r['rank']}: " + ", ".join(
            f"{k[:-2]} {v:.1f} s" for k, v in r.items()
            if k.endswith("_s") and isinstance(v, float)))
    print(f"  path18: whole path {rep.get('total_s', 0.0):.1f} s",
          flush=True)


# Path 19: JAX's MoE partitioner path and the MoE under the
# dp_heavy layouts on a mesh (ROADMAP 11.8.4(c)), on granite-moe-1b-a400m
# (hf:ibm-granite/granite-3.0-1b-a400m-base: 24 layers, d_model 1024, 16 /
# 8 heads, 32 experts top 8 of d_ff 512, vocabulary 49155), weights drawn
# from seed 0 on the card.
# 19a: its first MOE_CHECK_LAYERS layers at full width in float32 on one
#   2 x 2 world of 4 gloo ranks sharing the card, at the config's capacity
#   factor 1.25, its stacked weights scaled to their fan-in
#   (p19_conditioned: drawn as the zoo draws them, 2 layers' gradients
#   are mostly rounding, 1-5% 1-ulp spreads a leaf).  Under random
#   weights no expert overflows at 1.25 (13a, 16c), and at 1.0, where
#   some do, a choice that the last bits move into a full expert bumps
#   another token's slot.  So 19a's batches come from two halves of the
#   vocabulary (the first half of a batch's rows from the lower, the
#   rest from the upper: two clients' domains), and p19_lean leans the
#   weights: the embedding rows of the two halves apart along one
#   direction (PATH19_LEAN_EMBED times their mean norm), every router
#   column made orthogonal to the direction that separates the two
#   domains' MoE inputs and to the inputs' mean, then experts 0..k-1's
#   columns moved along it and k..2k-1's against it, by the least gains
#   that put every token's own k experts PATH19_LEAN_MARGIN logits above
#   all others.  Each domain's tokens then take their own k experts, at
#   weights of 0.03-0.35 each, which overflow, and no expert choice lies
#   near a tie: the same slots drop under any rounding (each layer's
#   least margin is reported).  (i) make_train_step at PATH19_BATCH x
#   STEP_HELD_SEQ under dp_heavy and dp_heavy_z3 (a row a rank; each data
#   shard's rows gathered over "model", expert-parallel per data shard),
#   and under dp_heavy at 2 rows (a batch the axes do not divide: the
#   model axis's ranks share their rows' loss); (ii) the tp train step
#   with use_moe_shard_map=False (JAX's partitioner path: the global tokens
#   and capacity); (iii) make_distill_step, PATH19_DISTILL (the
#   partitioner path, teachers drawn from seeds 1.., conditioned and
#   leaned on its batch as the student is; K2 over the whole vocabulary,
#   which the model axis does not divide);
#   (iv) make_prefill_step at PATH19_SERVE_BATCH x STEP_HELD_SEQ
#   (expert-parallel, a row a data shard), then PATH19_TOKENS tokens
#   through make_serve_step (the partitioner path's gather route: T * k =
#   16 < 32).  Rank 0 runs the unsharded step of the same weights (the
#   expert-parallel route's: each data shard's rows alone, the gradients,
#   losses and aux losses averaged, as JAX's pmean averages them) and
#   sends it to every rank, which holds its blocks against it: every
#   leaf's gradient within STEP_SPREAD_FACTOR times that leaf's own
#   unsharded 1-ulp spread (the larger of PATH19_NUDGES' two nudges; a
#   leaf's gap and spread both as shares of its
#   largest gradient; the random init leaves some attention leaves with
#   gradients that are mostly rounding, whose spread must not set the
#   bound of the others), the loss and the aux loss within
#   PATH19_LOSS_RTOL / PATH19_AUX_RTOL relative, or 4 x their own 1-ulp
#   spread where that is larger; the distill loss, a KL of ~1e-2 that is
#   the difference of a cross-entropy and an entropy of ~ln V each, in
#   absolute terms against the unsharded rows' losses summed shard by
#   shard as the ranks sum them, within 4 x its 1-ulp spread or
#   PATH19_LOSS_RTOL x ln V (eight units in the last place of ln V in
#   float32, the rounding of those two terms), and the same loss of a
#   bfloat16 student must miss that bound; each layer's dropped slots
#   (summed over "model"), the student's and the teachers', equal but for
#   expert choices the last bits moved (16c's rule); the logits within
#   GQA_REL_ATOL of the largest.  (ii)'s drops must differ from what the
#   expert-parallel route drops on the same world (each data shard's
#   own), or the check could not tell the routes apart.
#   chip_probe_moe_gate.py plants faults in the MoE's gradient and shows
#   that these gates fail.
# 19b: one bf16 dp_heavy make_train_step at full depth and the config's
#   capacity factor (uniform tokens, no lean), PATH19_FULL_BATCH x
#   STEP_TRAIN_SEQ on 1 x 2 (a row a rank; each MoE layer gathers both
#   rows' 8192 tokens over "model", 16 experts a rank, capacity 2560):
#   every leaf's gradient block finite and non-zero, K4 2 x 24 a rank;
#   seconds, peak memory, the collectives by axes.  19b's world runs
#   beside path 17's (2 x 12.6 GiB beside 17a's 2 x 11.5) and 19a's
#   beside path 18's (18b 2 x 14.4 GiB); path 18 beside both of path 19's
#   worlds in turn ran out of the card's 80 GB.  19a draws the teachers
#   one at a time (rank 0 keeps them whole, for the reference; the others
#   their blocks) and frees its cache after each part.
# Four cards (``chip_smoke.py --four``, NCCL, 2 x 2): 19a at PATH19_BATCH
#   rows, then 19b's step at PATH19_FOUR_BATCH x STEP_TRAIN_SEQ (a row a
#   rank, each data shard's two rows gathered over "model").
PATH19_BATCH, PATH19_SERVE_BATCH, PATH19_TOKENS = 4, 2, 8
PATH19_DISTILL = dict(n_teachers=4, batch_size=2, seq_len=512)
PATH19_LOSS_RTOL, PATH19_AUX_RTOL = 1e-6, 1e-6
PATH19_LEAN_EMBED, PATH19_LEAN_MARGIN, PATH19_LEAN_SEED = 3.0, 12.0, 19
PATH19_NUDGES = (5, 6)          # the 1-ulp spreads: the larger of two
PATH19_FULL_BATCH, PATH19_FOUR_BATCH = 2, 4
PATH19_TIMEOUT_S = 600


def p19_model(device):
    """(config, float32 parameters) of granite-moe's first
    MOE_CHECK_LAYERS layers at full width, drawn on the card from seed 0
    and conditioned (p19_conditioned), at the config's capacity factor."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(configs.get(MOE_SERVE[0]),
                              n_layers=MOE_CHECK_LAYERS)
    params = T.init(cfg, torch.Generator(device=device).manual_seed(0),
                    torch.float32, device)
    p19_conditioned(cfg, params)
    return cfg, params


def p19_conditioned(cfg, params) -> None:
    """Scale in place each stacked weight of T.init's ``params`` (whole or
    a rank's blocks: [layers, ..., fan-in, fan-out], drawn at 1 /
    sqrt(layers), its fan-in read from the layers axis) to 1 / sqrt(its
    fan-in).  Drawn so at 2 layers, its weights ~20x wide, the model's
    gradients are mostly rounding (1-5% 1-ulp spreads a leaf on the card,
    chip_probe_conditioning.py), and a bound of 4x the spread could not
    tell a fault from it."""
    import torch
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.models import transformer as T
    specs = tree_flatten(T.param_specs(cfg))
    with torch.no_grad():
        for k, x in tree_flatten(params).items():
            spec = specs[k]
            if spec.init == "normal" and len(spec.shape) >= 3:
                x.mul_(math.sqrt(spec.shape[0] / spec.shape[-2]))


def p19_tokens(cfg, shape, seed: int) -> dict:
    """step_tokens' batch with the tokens of the first half of the rows
    from the lower half of the vocabulary and the rest's from the upper
    (two domains; the labels uniform)."""
    batch = step_tokens(cfg, shape, seed)
    half = cfg.vocab_size // 2
    toks = batch["tokens"] % half
    toks[shape[0] // 2:] += half
    return {**batch, "tokens": toks}


def p19_inputs(cfg, params, tokens) -> list:
    """Each MoE layer's input [T, d], as its router takes it, in one
    device's forward of ``tokens``."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    orig, xs = moe._route, []

    def route(p, cfg, x):
        xs.append(x.detach())
        return orig(p, cfg, x)
    moe._route = route
    try:
        with torch.no_grad():
            T.forward(params, cfg, {"tokens": tokens})
    finally:
        moe._route = orig
    return xs


def p19_lean(cfg, params, tokens) -> dict:
    """Lean ``params`` (whole, one block pattern of stacked layers, as
    granite-moe's) in place, layer after layer, so that each token of
    ``tokens`` (p19_tokens') takes its domain's k experts, 0..k-1 for the
    upper vocabulary half and k..2k-1 for the lower, each of them more
    than PATH19_LEAN_MARGIN logits above every other expert: the
    embedding rows of the two halves moved apart by PATH19_LEAN_EMBED
    times their mean norm along a direction drawn from PATH19_LEAN_SEED;
    in each layer every router column made orthogonal to the direction
    that separates the two domains' mean inputs and to the inputs' mean
    (no expert favoured by them), then the upper set's columns moved
    along that direction and the lower set's against it, by the least
    gains (one a set) that part every token's own k experts from the
    rest by the margin.  Returns, per layer, the other logits' spread and
    the least and largest margin over the tokens (in logits)."""
    import torch
    emb, half = params["embed"], cfg.vocab_size // 2
    gen = torch.Generator(device=emb.device).manual_seed(PATH19_LEAN_SEED)
    u = torch.randn(cfg.d_model, generator=gen, device=emb.device)
    u = u / u.norm()
    rows, k, e = tokens.shape[0], cfg.top_k, cfg.n_experts
    upper = torch.zeros(tokens.shape, dtype=torch.bool, device=emb.device)
    upper[rows // 2:] = True
    upper = upper.reshape(-1)
    mine = torch.zeros((upper.shape[0], e), dtype=torch.bool,
                       device=emb.device)
    mine[upper, :k] = True
    mine[~upper, k:2 * k] = True
    routers = params["blocks"][0]["mlp"]["router"]        # [L, d, E]
    grid = torch.linspace(0.0, 1.0, 61, device=emb.device)
    rest = torch.zeros(e - 2 * k, device=emb.device)

    def margins(logits):
        """Each token's least own logit over its largest other one."""
        return (logits.masked_fill(~mine, math.inf).min(1).values
                - logits.masked_fill(mine, -math.inf).max(1).values)
    rep = {"layers": []}
    with torch.no_grad():
        beta = PATH19_LEAN_EMBED * emb.norm(dim=1).mean()
        rep["beta"] = float(beta)
        emb[:half] -= beta * u
        emb[half:] += beta * u
        for layer in range(cfg.n_layers):
            x = p19_inputs(cfg, params, tokens)[layer].float()
            m = x[upper].mean(0) - x[~upper].mean(0)
            m = m / m.norm()
            c = x.mean(0)
            c = c - (c @ m) * m
            c = c / c.norm()
            r = routers[layer]
            for v in (m, c):
                r -= torch.outer(v, v @ r)
            base, proj = x @ r, x @ m
            spread = float(base.std())
            # gains (g_up, g_low) on a grid up to the size that moves a
            # token PATH19_LEAN_MARGIN plus the logits' range past the rest
            top = ((PATH19_LEAN_MARGIN + base.max() - base.min())
                   / proj.abs().median())
            gs = grid * top
            least = torch.stack([torch.stack([margins(
                base + proj[:, None] * torch.cat([
                    gu.expand(k), -gl.expand(k), rest])).min()
                for gl in gs]) for gu in gs])
            ok = least >= PATH19_LEAN_MARGIN
            cost = (torch.where(ok, gs[:, None] + gs[None, :], math.inf)
                    if ok.any() else -least)
            i, j = divmod(int(cost.argmin()), len(gs))
            gain = torch.cat([gs[i].expand(k), -gs[j].expand(k), rest])
            r += torch.outer(m, gain)
            got = margins(x @ r)
            rep["layers"].append({"sigma": spread,
                                  "least_margin": float(got.min()),
                                  "most_margin": float(got.max())})
    return rep


def p19_shared_lean(cfg, params, tokens) -> dict:
    """p19_lean on rank 0, the same lean on every rank (its direction,
    size and routers sent from rank 0; every rank draws the same seed-0
    weights): the report."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    routers = params["blocks"][0]["mlp"]["router"]
    box = [None]
    if tmesh.world_rank() == 0:
        rep = p19_lean(cfg, params, tokens)
        box = [(rep, routers.cpu())]
    dist.broadcast_object_list(box, src=0)
    rep, lean_routers = box[0]
    if tmesh.world_rank() != 0:
        emb, half = params["embed"], cfg.vocab_size // 2
        gen = torch.Generator(device=emb.device).manual_seed(
            PATH19_LEAN_SEED)
        u = torch.randn(cfg.d_model, generator=gen, device=emb.device)
        u = u / u.norm()
        with torch.no_grad():
            beta = torch.tensor(rep["beta"], device=emb.device)
            emb[:half] -= beta * u
            emb[half:] += beta * u
            routers.copy_(lean_routers)
    return rep


def p19_drops(cfg, params, tokens) -> tuple:
    """(each layer's dropped slots, each layer's expert choices [T, k] on
    the CPU) in one device's forward of ``tokens``."""
    import torch
    from repro_torch.models import transformer as T
    with torch.no_grad(), recording_moe([], []) as (drops, routes):
        T.forward(params, cfg, {"tokens": tokens})
    return [int(n) for _, n in drops], [i.cpu() for i, _ in routes]


def p19_layer_drops(drops, first: int, n: int, mesh) -> list:
    """Layers ``first`` to ``first + n``'s dropped slots of this rank's
    experts (``recording_moe``'s), summed over "model"."""
    import torch
    from repro_torch.common import sharding as shd
    mine = torch.stack([d for _, d in drops[first:first + n]]).float()
    return [int(v) for v in shd.all_reduce_sum(mine, mesh, ("model",))]


def p19_moved(routes, ref) -> list:
    """Each layer's expert choices of one run that the other's token did
    not choose; -1 where the two routed different token counts."""
    return [int((~(a.cpu()[:, :, None] == b[:, None, :]).any(-1)).sum())
            if a.shape == b.shape else -1 for a, b in zip(routes, ref)]


def p19_drops_held(drops, ref_drops, moved) -> bool:
    """Each layer's drops equal the reference's, or, where expert choices
    moved (the last bits of a gate near a tie), within one slot a moved
    choice (16c's rule: moving a choice changes one expert's overflow by
    at most one and another's by at most one the other way); never where
    the two runs routed different token counts."""
    return (len(drops) == len(ref_drops) and min(moved, default=0) >= 0
            and all(abs(a - b) <= m for a, b, m in zip(drops, ref_drops,
                                                        moved)))


def p19_shared(ref: Optional[dict], like) -> dict:
    """Rank 0's reference on every rank: its gradient tree (shaped like
    ``like``) broadcast leaf by leaf (through host memory under gloo),
    the rest as objects.  One reference for every rank: each computing
    its own could differ from the others in its last bits."""
    import torch
    import torch.distributed as dist
    from repro_torch.common.pytree import tree_leaves, tree_map
    rank0 = dist.get_rank() == 0
    box = [{k: v for k, v in ref.items() if k != "grads"} if rank0
           else None]
    dist.broadcast_object_list(box, src=0)
    grads = ref["grads"] if rank0 else tree_map(torch.empty_like, like)
    on_card = dist.get_backend() == "nccl"
    for x in tree_leaves(grads):
        buf = x if on_card else x.detach().cpu().contiguous()
        dist.broadcast(buf, src=0)
        if not rank0 and buf is not x:
            x.copy_(buf)
    return {**box[0], "grads": grads}


def p19_reference(cfg, params, batch, shards: int) -> dict:
    """The unsharded train step's gradient, loss and aux loss, each
    leaf's 1-ulp spread (the larger of PATH19_NUDGES' nudges), the
    loss's and aux loss's, and each layer's
    drops and choices per data shard: the batch whole (``shards`` 1, the
    partitioner path) or each data shard's rows alone with the gradients,
    losses and aux losses averaged (the expert-parallel route's
    mathematics)."""
    import torch
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import steps
    rows = batch["tokens"].shape[0] // shards
    parts = [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
             for i in range(shards)]

    def grads(p):
        g, loss, aux = None, 0.0, 0.0
        for mb in parts:
            gi, m = steps.train_grads(p, cfg, mb, remat=False)
            g = gi if g is None else tree_map(torch.add, g, gi)
            loss, aux = loss + float(m["loss"]), aux + float(m["moe_aux"])
        return tree_map(lambda x: x / shards, g), loss / shards, aux / shards
    out = dict(zip(("grads", "loss", "aux"), grads(params)))
    runs = [p19_drops(cfg, params, mb["tokens"]) for mb in parts]
    out["drops"], out["routes"] = [d for d, _ in runs], [r for _, r in runs]
    base, spreads = flat32(out["grads"]), []
    for seed in PATH19_NUDGES:
        g_n, loss_n, aux_n = grads(ulp_nudged(params, seed))
        spreads.append((leaf_gaps(flat32(g_n), base),
                        abs(loss_n - out["loss"]) / abs(out["loss"]),
                        abs(aux_n - out["aux"]) / abs(out["aux"])))
        del g_n
    out["leaf_spreads"] = {k: max(g[k] for g, _, _ in spreads)
                           for k in base}
    out["ulp_spread"] = max(out["leaf_spreads"].values())
    out["loss_spread"] = max(x for _, x, _ in spreads)
    out["aux_spread"] = max(x for _, _, x in spreads)
    return out


def p19_bounds(ref: dict) -> dict:
    """The loss's and aux loss's bounds, relative: STEP_SPREAD_FACTOR
    times the unsharded step's own 1-ulp spread, no looser than
    PATH19_LOSS_RTOL / PATH19_AUX_RTOL unless that spread is (the aux
    loss is a float32 sum over the layers of each layer's mean)."""
    return {"loss": max(PATH19_LOSS_RTOL,
                        STEP_SPREAD_FACTOR * ref["loss_spread"]),
            "aux": max(PATH19_AUX_RTOL,
                       STEP_SPREAD_FACTOR * ref.get("aux_spread", 0.0))}


def p19_gap(grads, ref, pspecs, mesh) -> dict:
    """{leaf: the largest gap of this step's blocks against the same
    blocks of the reference tree, merged over every rank, as a share of
    the reference leaf's largest}."""
    import torch
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_flatten
    want = tree_flatten(shd.shard_tree(ref, pspecs, mesh))
    got, ref = tree_flatten(grads), tree_flatten(ref)
    keys = sorted(ref)
    gap = torch.stack([(got[k].double() - want[k].double()).abs().max()
                       for k in keys])
    gap = shd.all_reduce_max(gap, mesh, shd.axis_names(mesh)).cpu()
    top = torch.tensor([max(float(ref[k].abs().max()), 1e-30)
                        for k in keys], dtype=torch.float64)
    return dict(zip(keys, (gap / top).tolist()))


def p19_grad_gate(gaps: dict, spreads: dict) -> dict:
    """Every leaf's gap against STEP_SPREAD_FACTOR times its own 1-ulp
    spread: the largest ratio (held where it is at most 1) and the three
    leaves nearest their bounds, each (gap, spread)."""
    def ratio(k):
        bound = STEP_SPREAD_FACTOR * spreads[k]
        return gaps[k] / bound if bound > 0 else (
            math.inf if gaps[k] > 0 else 0.0)
    ratios = {k: ratio(k) for k in gaps}
    worst = sorted(ratios, key=ratios.get, reverse=True)[:3]
    return {"grad_ratio": max(ratios.values()),
            "grad_gap": max(gaps.values()),
            "worst_leaves": {k: (gaps[k], spreads[k]) for k in worst}}


def p19_step(bundle, args, device, first: int, n_layers: int,
             mesh, teachers: int = 0) -> tuple:
    """(the gradients a step's Adam takes, its results, a report of its
    seconds, collectives, launches and each layer's drops and choices
    from the ``first``-th MoE call on, the drops summed over "model"; and
    of the ``teachers`` calls before it), timed after every rank has
    arrived."""
    import torch
    from repro_torch.launch import steps
    took, orig = [], steps._adam_step

    def adam_step(opt, params, opt_state, grads, step):
        took.append(grads)
        return orig(opt, params, opt_state, grads, step)
    _p17_barrier(mesh, device)
    _p16_reset()
    steps._adam_step = adam_step
    try:
        with recording_moe([], []) as (drops, routes):
            t0 = time.perf_counter()
            out = bundle.fn(*args)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
    finally:
        steps._adam_step = orig
    rep = {"step_s": step_s, **_p16_counts(),
           "drops": p19_layer_drops(drops, first, n_layers, mesh)}
    rep["routes"] = [i for i, _ in routes[first:first + n_layers]]
    if teachers:
        rep["teacher_drops"] = p19_layer_drops(drops, 0, teachers, mesh)
        rep["teacher_routes"] = [i for i, _ in routes[:teachers]]
    return took[0], out, rep


def p19_train(mesh, cfg, params, batch, ref: dict, kw: dict) -> dict:
    """One float32 make_train_step with ``kw`` on ``mesh`` from the
    unsharded blocks and zero moments, held against ``ref``
    (p19_reference's, shared): its seconds, collectives and launches,
    the loss, the aux loss, every leaf's gradient gap, each layer's drops
    of this rank's data shard."""
    import torch
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import InputShape
    from repro_torch.launch import steps
    from repro_torch.optim import optimizers as topt
    bundle = steps.make_train_step(
        cfg, InputShape("held_card", STEP_HELD_SEQ, batch["tokens"].shape[0],
                        "train"), mesh, param_dtype=torch.float32, **kw)
    tp = bundle.layout
    local = shd.shard_tree(params, tp.pspecs, mesh)
    opt = topt.AdamState(*(tree_map(torch.zeros_like, local)
                           for _ in range(2)))
    grads, (_, _, _, m), r = p19_step(
        bundle, (local, opt, torch.zeros((), dtype=torch.int32),
                 steps.batch_block(batch, tp)),
        batch["tokens"].device, 0, cfg.n_layers, mesh)
    r.update(rows=list(tp.batch_axes), loss=float(m["loss"]),
             aux=float(m["moe_aux"]), data=shd.axis_index(mesh, "data"),
             ulp_spread=ref["ulp_spread"])
    r.update(p19_grad_gate(p19_gap(grads, ref["grads"], tp.pspecs, mesh),
                           ref["leaf_spreads"]))
    shard = min(r["data"], len(ref["drops"]) - 1)
    r["ref_drops"] = ref["drops"][shard]
    r["moved"] = p19_moved(r.pop("routes"), ref["routes"][shard])
    r["loss_rel"] = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
    r["aux_err"] = abs(r["aux"] - ref["aux"]) / abs(ref["aux"])
    r["bounds"] = p19_bounds(ref)
    r["held"] = (r["loss_rel"] <= r["bounds"]["loss"]
                 and r["aux_err"] <= r["bounds"]["aux"]
                 and r["grad_ratio"] <= 1.0
                 and p19_drops_held(r["drops"], r["ref_drops"], r["moved"]))
    del local, opt, grads
    return r


def p19_distill(mesh, cfg, params, device) -> dict:
    """19a (iii): make_distill_step on ``mesh`` (the partitioner path),
    PATH19_DISTILL, from the unsharded blocks, against rank 0's unsharded
    distill step: the loss in absolute terms (the control, a bfloat16
    student's, beside), every leaf's gradient within 4 x its 1-ulp
    spread, the student's and the teachers' drops and choices per layer
    (the teachers drawn from seeds 1.., conditioned and leaned as the
    student is); whether K2 runs over the whole vocabulary
    (``steps._vocab_out``)."""
    import torch
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as topt
    k, b, s = (PATH19_DISTILL[x] for x in ("n_teachers", "batch_size",
                                            "seq_len"))
    bundle = steps.make_distill_step(cfg, mesh, param_dtype=torch.float32,
                                     **PATH19_DISTILL)
    tp = bundle.layout
    rank0 = tmesh.world_rank() == 0
    batch = {"tokens": p19_tokens(cfg, (b, s), 3)["tokens"].to(device)}

    def into(stack, tree, i):
        """``tree`` as row ``i`` of ``stack`` (made at the first)."""
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((k,) + x.shape), tree)
        tree_map(lambda dst, src: dst[i].copy_(src), stack, tree)
        return stack
    # the K teachers (seeds 1..K), each drawn whole, conditioned and
    # leaned on this batch as the student is, one at a time: rank 0 keeps
    # them whole for the reference, every rank its blocks
    teachers, local_t, rep_lean = None, None, []
    for i in range(k):
        t = T.init(cfg, torch.Generator(device=device).manual_seed(1 + i),
                   torch.float32, device)
        p19_conditioned(cfg, t)
        rep_lean.append(p19_shared_lean(cfg, t, batch["tokens"]))
        local_t = into(local_t, shd.shard_tree(t, tp.pspecs, mesh), i)
        if rank0:
            teachers = into(teachers, t, i)
        del t
    ref = None
    if rank0:
        g, loss = steps.distill_grads(params, teachers, cfg, batch,
                                      remat=False)
        base, spreads, loss_spread = flat32(g), [], 0.0
        for seed in PATH19_NUDGES:
            g_n, loss_n = steps.distill_grads(ulp_nudged(params, seed),
                                              teachers, cfg, batch,
                                              remat=False)
            spreads.append(leaf_gaps(flat32(g_n), base))
            loss_spread = max(loss_spread, abs(float(loss_n) - float(loss)))
            del g_n
        drops, routes = p19_drops(cfg, params, batch["tokens"])
        t_runs = [p19_drops(cfg, tree_map(lambda x: x[i], teachers),
                            batch["tokens"]) for i in range(k)]
        split, bf16 = p19_split_losses(
            cfg, [params, tree_map(lambda x: x.bfloat16(), params)],
            teachers, batch, shd.axis_size(mesh, "data"))
        ref = {"grads": g, "loss": float(loss), "split_loss": split,
               "bf16_split_loss": bf16,
               "leaf_spreads": {k: max(x[k] for x in spreads)
                                for k in base},
               "loss_spread": loss_spread,
               "drops": drops, "routes": routes,
               "teacher_drops": [n for d, _ in t_runs for n in d],
               "teacher_routes": [i for _, r in t_runs for i in r]}
    ref = p19_shared(ref, params)
    del teachers
    torch.cuda.empty_cache()
    student = shd.shard_tree(params, tp.pspecs, mesh)
    opt = topt.AdamState(*(tree_map(torch.zeros_like, student)
                           for _ in range(2)))
    # the student's forward follows the K teachers' (remat's recompute
    # after it)
    grads, (_, _, _, loss), r = p19_step(
        bundle, (student, local_t, opt, torch.zeros((), dtype=torch.int32),
                 steps.batch_block(batch, tp)), device, k * cfg.n_layers,
        cfg.n_layers, mesh, teachers=k * cfg.n_layers)
    r.update(loss=float(loss), rows=list(tp.batch_axes),
             vocab_out=steps._vocab_out(cfg, student, tp),
             ref_drops=ref["drops"],
             ulp_spread=max(ref["leaf_spreads"].values()),
             moved=p19_moved(r.pop("routes"), ref["routes"]),
             ref_teacher_drops=ref["teacher_drops"],
             teacher_moved=p19_moved(r.pop("teacher_routes"),
                                     ref["teacher_routes"]),
             teacher_margins=[min(x["least_margin"] for x in t["layers"])
                              for t in rep_lean])
    r["k2_whole_vocab"] = r["vocab_out"] == cfg.vocab_size
    r.update(p19_grad_gate(p19_gap(grads, ref["grads"], tp.pspecs, mesh),
                           ref["leaf_spreads"]))
    # absolute: the loss, a KL of ~1e-2, is the difference of a
    # cross-entropy and an entropy of ~ln V each, rounded at ln V's scale
    r["loss_gap"] = abs(r["loss"] - ref["split_loss"])
    r["whole_loss_gap"] = abs(r["loss"] - ref["loss"])
    r["loss_bound"] = max(PATH19_LOSS_RTOL * math.log(cfg.vocab_size),
                          STEP_SPREAD_FACTOR * ref["loss_spread"])
    r["bf16_loss_gap"] = abs(ref["bf16_split_loss"] - ref["split_loss"])
    r["loss_spread"] = ref["loss_spread"]
    r["held"] = (r["loss_gap"] <= r["loss_bound"]
                 and r["bf16_loss_gap"] > r["loss_bound"]
                 and r["grad_ratio"] <= 1.0
                 and p19_drops_held(r["drops"], ref["drops"], r["moved"])
                 and p19_drops_held(r["teacher_drops"],
                                    ref["teacher_drops"],
                                    r["teacher_moved"])
                 and r["k2_whole_vocab"])
    del local_t, student, opt, grads, ref
    torch.cuda.empty_cache()
    return r


def p19_split_losses(cfg, students: list, teachers, batch,
                     shards: int) -> list:
    """Each of ``students``' unsharded distill loss as ``shards`` data
    ranks sum it: each shard's rows' AVGLOGITS loss at its share of the
    rows, summed in rank order (the whole batch's is one float32 sum over
    every row)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    out = []
    with torch.no_grad():
        t_logits = steps.teacher_logits(teachers, cfg, batch)
        for params in students:
            s_logits = T.forward(params, cfg, batch)
            v, b = s_logits.shape[-1], s_logits.shape[0]
            per = b // shards
            total = None
            for d in range(shards):
                rows = slice(d * per, (d + 1) * per)
                s2 = s_logits[rows].reshape(-1, v).float()
                t3 = t_logits[:, rows].reshape(t_logits.shape[0], -1, v)
                part = ops.ensemble_kl_loss(s2, t3) * (per / b)
                total = part if total is None else total + part
            out.append(float(total))
            del s_logits
    return out


def p19_serve(mesh, cfg, params, device) -> dict:
    """19a (iv): a tp prefill at PATH19_SERVE_BATCH x STEP_HELD_SEQ
    (expert-parallel: each data shard's row routes alone), then
    PATH19_TOKENS tokens through make_serve_step (the partitioner path),
    against rank 0's unsharded prefill of each row alone and decode_step
    of the batch; the prefill's drops per layer against each row's own,
    and no capacity dispatch in the decode where ``T * top_k <
    n_experts`` (the gather route)."""
    import torch
    import torch.distributed as dist
    from repro_torch.common import sharding as shd
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer as T
    b, prompt, n = PATH19_SERVE_BATCH, STEP_HELD_SEQ, PATH19_TOKENS
    max_seq = prompt + n
    toks = p19_tokens(cfg, (b, prompt + n), 4)["tokens"].to(device)
    ref, box = None, [None]
    if tmesh.world_rank() == 0:
        with torch.no_grad():
            runs = [T.prefill(params, cfg, {"tokens": toks[i:i + 1,
                                                           :prompt]},
                              max_seq) for i in range(b)]
            caches = tree_map(lambda *xs: torch.cat(xs, xs[0].dim() - 4),
                              *[c for _, c in runs])
            ref = []
            for i in range(n):
                lg, caches = T.decode_step(
                    params, cfg,
                    {"tokens": toks[:, prompt + i:prompt + i + 1]}, caches,
                    prompt + i)
                ref.append(lg.float())
        del runs, caches
        box = [[p19_drops(cfg, params, toks[i:i + 1, :prompt])
                for i in range(b)]]
    dist.broadcast_object_list(box, src=0)
    with recording_moe([], []) as (drops, routes):
        rep = p17_serve(mesh, cfg, params, toks, torch.float32, n, max_seq,
                        True, ref, prompt=prompt)
    gather = b * cfg.top_k < cfg.n_experts
    rep["drops"] = p19_layer_drops(drops, 0, cfg.n_layers, mesh)
    rep["capacity_calls"] = len(drops)
    rep["decode_route"] = "gather" if gather else "capacity"
    ref_drops, ref_routes = box[0][shd.axis_index(mesh, "data")]
    rep["ref_drops"] = ref_drops
    rep["moved"] = p19_moved([i for i, _ in routes[:cfg.n_layers]],
                             ref_routes)
    rep["drops_held"] = (p19_drops_held(rep["drops"], ref_drops,
                                        rep["moved"])
                         and rep["capacity_calls"] == cfg.n_layers * (
                             1 if gather else 1 + n))
    return rep


# 19a (i)-(ii): (name, make_train_step's knobs, the batch's rows, the
# reference: "per_shard" each data shard's rows alone, "whole" the batch)
P19_TRAIN = (("dp_heavy", dict(layout="dp_heavy"), slice(0, PATH19_BATCH),
              "per_shard"),
             ("dp_heavy_z3", dict(layout="dp_heavy_z3"),
              slice(0, PATH19_BATCH), "per_shard"),
             ("dp_heavy_shares", dict(layout="dp_heavy"), slice(1, 3),
              "per_shard"),
             ("tp_noep", dict(use_moe_shard_map=False),
              slice(0, PATH19_BATCH), "whole"))


def p19_references(mesh, cfg, params, batch) -> dict:
    """Rank 0's references of P19_TRAIN's batches, on every rank:
    {(rows, kind): p19_reference's}."""
    from repro_torch.common import sharding as shd
    from repro_torch.launch import mesh as tmesh
    refs = {}
    for _, _, rows, kind in P19_TRAIN:
        key = (rows.start, rows.stop, kind)
        if key not in refs:
            part = {k: v[rows] for k, v in batch.items()}
            shards = shd.axis_size(mesh, "data") if kind == "per_shard" \
                else 1
            refs[key] = p19_shared(
                p19_reference(cfg, params, part, shards)
                if tmesh.world_rank() == 0 else None, params)
    return refs


def p19_held(device, mesh, rows: int) -> tuple:
    """19a on ``mesh``: the lean, then (i)-(iv), each with its own
    counts."""
    import torch
    from repro_torch.launch import mesh as tmesh
    cfg, params = p19_model(device)
    batch = {k: v.to(device) for k, v in p19_tokens(
        cfg, (rows, STEP_HELD_SEQ), 1).items()}
    rank0 = tmesh.world_rank() == 0
    rep, problems = {"rows": rows, "layers": cfg.n_layers,
                     "capacity_factor": cfg.capacity_factor, "peaks": {}}, []

    def peak(part: str) -> None:
        """This part's peak allocated and reserved bytes (path 18's ranks
        share the card), the cache freed after it."""
        rep["peaks"][part] = (torch.cuda.max_memory_allocated(),
                              torch.cuda.max_memory_reserved())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_peak_memory_stats()
    rep["lean"] = p19_shared_lean(cfg, params, batch["tokens"])
    refs = p19_references(mesh, cfg, params, batch)
    rep["ref"] = {f"{a}:{b} {kind}": {k: r[k] for k in (
        "loss", "aux", "drops", "ulp_spread", "loss_spread", "aux_spread")}
        for (a, b, kind), r in refs.items()}
    peak("references")
    for name, kw, part, kind in P19_TRAIN:
        ref = refs[(part.start, part.stop, kind)]
        rep[name] = p19_train(mesh, cfg, params,
                              {k: v[part] for k, v in batch.items()}, ref,
                              kw)
        rep[name]["batch"] = part.stop - part.start
        peak(name)
        if not rep[name]["held"]:
            problems.append(f"19a {name}: {rep[name]}")
    # the partitioner path drops the global batch's slots, the
    # expert-parallel route on this world each data shard's: a check that
    # could not tell the two apart would hold either way
    ep = [sum(x) for x in zip(*refs[(0, rows, "per_shard")]["drops"])]
    rep["tp_noep"]["expert_parallel_drops"] = ep
    if rep["tp_noep"]["drops"] == ep:
        problems.append(f"19a tp_noep: the partitioner path's drops "
                        f"{rep['tp_noep']['drops']} equal the expert-"
                        f"parallel route's {ep}")
    del refs
    rep["distill"] = p19_distill(mesh, cfg, params, device)
    peak("distill")
    if not rep["distill"]["held"]:
        problems.append(f"19a distill: {rep['distill']}")
    rep["serve"] = p19_serve(mesh, cfg, params, device)
    peak("serve")
    s = rep["serve"]
    if not s["drops_held"] or (rank0 and not s["held"]):
        problems.append(f"19a serve: {s}")
    rep["peak_mem_bytes"] = max(a for a, _ in rep["peaks"].values())
    del params
    torch.cuda.empty_cache()
    return rep, problems


def p19_full(device, mesh, batch: int, cards: int) -> tuple:
    """19b: p18_full_train's bf16 dp_heavy step of granite-moe-1b-a400m at
    full depth, ``batch`` x STEP_TRAIN_SEQ, with each MoE call's tokens
    and the capacity they take."""
    from repro_torch import configs
    from repro_torch.models import moe
    with recording_moe([]) as (drops, _):
        rep, problems = p18_full_train(device, mesh, MOE_SERVE[0],
                                       "dp_heavy", batch, cards)
    tokens = sorted({int(t) for t, _ in drops})
    rep["moe_tokens_per_call"] = tokens
    rep["capacity"] = [moe.capacity(configs.get(MOE_SERVE[0]), t)
                       for t in tokens]
    rep["dropped_forward"] = int(sum(
        int(n) for _, n in drops[:configs.get(MOE_SERVE[0]).n_layers]))
    return rep, problems


def path19_rank(device, shape=(2, 2), parts=("19a",), cards: int = 1,
                full_batch: int = PATH19_FULL_BATCH) -> dict:
    """One rank of path 19's ``shape`` mesh: the parts in order."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device("cuda", torch.cuda.current_device())
              if device == "cuda" else torch.device(device))
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_mesh(shape, ("data", "model"))
    out, problems = {"rank": tmesh.world_rank(),
                     "backend": tmesh._WORLD["backend"],
                     "mesh": list(shape)}, []
    for part in parts:
        t0 = time.perf_counter()
        if part == "19a":
            out["19a"], p = p19_held(device, mesh, PATH19_BATCH)
        else:
            out["19b"], p = p19_full(device, mesh, full_batch, cards)
        problems += [f"{part}: {x}" for x in p]
        out[f"{part}_s"] = time.perf_counter() - t0
    out["problems"] = problems
    return out


def path19_world(device, part: str) -> tuple:
    """One of path 19's worlds, on ranks sharing the card: "19a" the
    2 x 2 world of 4 ranks, "19b" the 1 x 2 world; (its ranks' reports,
    its seconds)."""
    shape, threads = ((2, 2), 2) if part == "19a" else ((1, 2), 4)
    return timed_ranks(path19_rank, math.prod(shape), device,
                       args=(device, shape, (part,)), threads=threads,
                       timeout_s=PATH19_TIMEOUT_S)


def path19_report(a: tuple, b: tuple) -> tuple:
    """Path 19's report and problems from its two worlds' (ranks,
    seconds)."""
    rep = {"card": card_line(), "a": a[0], "a_s": a[1], "b": b[0],
           "b_s": b[1]}
    problems = [f"rank {r['rank']} of {r['mesh']}: {p}"
                for r in rep["a"] + rep["b"] for p in r["problems"]]
    losses = {r["19b"]["loss"] for r in rep["b"]}
    if len(losses) != 1:
        problems.append(f"19b: the ranks' losses differ {losses}")
    return rep, problems


def moe_mesh_path(device):
    """Path 19 alone: 19a's 2 x 2 world of 4 ranks sharing the card, then
    19b's 1 x 2 world (in the default run 19b's world runs beside path
    17's and 19a's beside path 18's)."""
    import torch
    device = torch.device(device).type
    return path19_report(path19_world(device, "19a"),
                         path19_world(device, "19b"))


@contextlib.contextmanager
def least_free(out: dict, key: str, period_s: float = 0.25):
    """While open, the card's free bytes (``torch.cuda.mem_get_info``,
    every process's use counted) sampled every ``period_s``; the least
    goes to ``out[key]``."""
    import threading
    import torch
    least, stop = [torch.cuda.mem_get_info()[0]], threading.Event()

    def sample():
        while not stop.wait(period_s):
            least[0] = min(least[0], torch.cuda.mem_get_info()[0])
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()
        out[key] = least[0]


def paths_17_to_19(device, k2s_rows, paths: dict, start_s: float) -> list:
    """Paths 17, 18 and 19 into ``paths`` (printed; their problems
    returned): path 17 beside path 19's 1 x 2 world (19b), then path 18
    beside its 2 x 2 world (19a).  Their ranks mostly wait on host-staged
    collectives; the least free memory on the card during each pair is
    recorded (path 18 beside 19a's and 19b's worlds in turn ran out of
    the card's 80 GB)."""
    import concurrent.futures
    import gc
    import torch
    problems, worlds, free = [], {}, {}
    # this process's cache from the served models and the kernel phases
    # goes back to the card first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before paths 17-19 this process holds "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} reserved), the "
          f"card {torch.cuda.mem_get_info()[0] / 2 ** 30:.2f} GiB free",
          flush=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        for part, name, fn, args, show in (
                ("19b", "path17_mesh_serve", mesh_serve_path,
                 (device, k2s_rows), print_path17),
                ("19a", "path18_layouts", layouts_path, (device,),
                 print_path18)):
            with least_free(free, part):
                job = pool.submit(path19_world, torch.device(device).type,
                                  part)
                t0 = time.perf_counter()
                rep, more = fn(*args)
                rep["total_s"] = time.perf_counter() - t0
                worlds[part] = job.result()
            paths[name] = rep
            problems += [f"{name}: {p}" for p in more]
            show(rep)
            print(f"{name} and path 19's {part} done at "
                  f"{time.perf_counter() - start_s:.1f} s, the card's "
                  f"least free memory {free[part] / 2 ** 30:.2f} GiB",
                  flush=True)
    rep, more = path19_report(worlds["19a"], worlds["19b"])
    rep["total_s"] = worlds["19a"][1] + worlds["19b"][1]
    rep["least_free_bytes"] = free
    paths["path19_moe_mesh"] = rep
    problems += [f"path19_moe_mesh: {p}" for p in more]
    print_path19(rep)
    return problems


def moe_mesh_four_path():
    """Path 19's four-card part: 19a on 2 x 2, then 19b's step at
    PATH19_FOUR_BATCH rows, one NCCL rank a card."""
    rep, problems = {"card": card_line()}, []
    rep["a"], rep["a_s"] = timed_ranks(
        path19_rank, 4, "cuda",
        args=("cuda", (2, 2), ("19a", "19b"), 4, PATH19_FOUR_BATCH),
        threads=4, timeout_s=PATH18_FOUR_TIMEOUT_S)
    rep["b"] = []
    problems += [f"rank {r['rank']} of {r['mesh']}: {p}"
                 for r in rep["a"] for p in r["problems"]]
    losses = {r["19b"]["loss"] for r in rep["a"]}
    if len(losses) != 1:
        problems.append(f"19b: the ranks' losses differ {losses}")
    return rep, problems


def print_path19(rep) -> None:
    gib = 2 ** 30
    print(f"  path19 on {rep['card']}:")
    for r in rep["a"] + rep["b"]:
        if "19a" in r:
            a = r["19a"]
            print(f"  path19 19a rank {r['rank']} lean (embedding rows "
                  f"moved {a['lean']['beta']:.4g}; per layer: the logits'"
                  f" spread before it, the least / largest margin of a "
                  f"token's own experts over the rest) " +
                  "; ".join(f"{x['sigma']:.4g}, {x['least_margin']:.4g} / "
                            f"{x['most_margin']:.4g}"
                            for x in a["lean"]["layers"]))
            for name, _, _, _ in P19_TRAIN:
                s = a[name]
                print(f"  path19 19a rank {r['rank']} ({r['backend']}) "
                      f"{name} {a['layers']} layers f32 capacity factor "
                      f"{a['capacity_factor']} batch {s['batch']} x "
                      f"{STEP_HELD_SEQ} on {r['mesh']} (rows over "
                      f"{s['rows']}): loss {s['loss']:.7f} rel "
                      f"{s['loss_rel']:.2e} (bound "
                      f"{s['bounds']['loss']:.1e}), aux {s['aux']:.7f} rel "
                      f"{s['aux_err']:.2e} (bound {s['bounds']['aux']:.1e}),"
                      f" gradient: largest gap {s['grad_gap']:.3g}, largest"
                      f" share of its leaf's bound (4 x the leaf's unsharded"
                      f" 1-ulp spread) {s['grad_ratio']:.3g} (nearest "
                      f"{s['worst_leaves']}; the largest spread "
                      f"{s['ulp_spread']:.3g}), drops per layer "
                      f"{s['drops']} (unsharded {s['ref_drops']}, expert "
                      f"choices moved {s['moved']}"
                      + (f"; expert-parallel on this world "
                         f"{s['expert_parallel_drops']}"
                         if "expert_parallel_drops" in s else "")
                      + f") held {s['held']}; {s['step_s']:.2f} s, launches "
                      f"{s['launches']}; {coll_line(s)}")
            d = a["distill"]
            print(f"  path19 19a rank {r['rank']} distill "
                  f"{PATH19_DISTILL} (rows over {d['rows']}, vocab out "
                  f"{d['vocab_out']}: K2 whole {d['k2_whole_vocab']}): loss "
                  f"{d['loss']:.7f} off by {d['loss_gap']:.3g} against the "
                  f"rows summed shard by shard (bound "
                  f"{d['loss_bound']:.3g}, 4 x its 1-ulp spread "
                  f"{d['loss_spread']:.3g}; a bf16 student off by "
                  f"{d['bf16_loss_gap']:.3g}; against the whole batch's "
                  f"{d['whole_loss_gap']:.3g}), gradient: largest gap "
                  f"{d['grad_gap']:.3g}, largest share of its bound "
                  f"{d['grad_ratio']:.3g} (nearest {d['worst_leaves']}), "
                  f"student drops {d['drops']} (unsharded "
                  f"{d['ref_drops']}, choices moved {d['moved']}), teacher "
                  f"drops {d['teacher_drops']} (unsharded "
                  f"{d['ref_teacher_drops']}, choices moved "
                  f"{d['teacher_moved']}, least lean margins "
                  f"{[round(x, 2) for x in d['teacher_margins']]}) held "
                  f"{d['held']}; "
                  f"{d['step_s']:.2f} s, launches {d['launches']}; "
                  f"{coll_line(d)}")
            s = a["serve"]
            held = (f", gap {s['err']:.3g} of a {s['max_abs_logit']:.4g} "
                    f"largest (gate {GQA_REL_ATOL:.0e}) held {s['held']}"
                    if "held" in s else "")
            print(f"  path19 19a rank {r['rank']} prefill {s['batch']} x "
                  f"{s['prompt']} + {s['tokens']} tokens: prefill "
                  f"{s['prefill_s']:.3f} s ({coll_line(s['prefill'])}), "
                  f"drops {s['drops']} (each row alone {s['ref_drops']}, "
                  f"choices moved {s['moved']}, "
                  f"{s['capacity_calls']} capacity calls, decode by "
                  f"{s['decode_route']}) held "
                  f"{s['drops_held']}, reshard {s['reshard_s']:.3f} s, "
                  f"decode {s['decode_s']:.3f} s "
                  f"({coll_line(s['decode'])}){held}; launches prefill "
                  f"{s['prefill']['launches']} decode "
                  f"{s['decode']['launches']}")
        if "19b" in r:
            f = r["19b"]
            print(f"  path19 19b rank {r['rank']} {f['arch']} {f['layout']} "
                  f"full depth bf16 batch {f['batch']} x {f['seq']} on "
                  f"{r['mesh']} (rows over {f['batch_axes']}; MoE tokens a "
                  f"call {f['moe_tokens_per_call']}, capacity "
                  f"{f['capacity']}, {f['dropped_forward']} slots dropped "
                  f"in the forward): step {f['step_s']:.3f} s (init "
                  f"{f['init_s']:.1f} s), loss {f['loss']:.6f}, MFU "
                  f"{f['mfu']:.4f}, peak {f['peak_mem_bytes'] / gib:.2f} "
                  f"GiB, parameters {f['param_bytes_rank'] / 1e9:.2f} GB a "
                  f"rank, {f['grad_leaves']} gradient blocks finite and "
                  f"non-zero {not f['grad_bad_leaves']}, launches "
                  f"{f['launches']}; {coll_line(f)}")
        if "19a" in r:
            print(f"  path19 19a rank {r['rank']}: peak "
                  f"{r['19a']['peak_mem_bytes'] / gib:.2f} GiB; by part "
                  f"(allocated / reserved GiB) " + ", ".join(
                      f"{k} {a / gib:.2f} / {b / gib:.2f}"
                      for k, (a, b) in r["19a"]["peaks"].items()))
        print(f"  path19 rank {r['rank']} of {r['mesh']}: " + ", ".join(
            f"{k[:-2]} {v:.1f} s" for k, v in r.items()
            if k.endswith("_s") and isinstance(v, float)))
    print(f"  path19: worlds {rep.get('a_s', 0.0):.1f} + "
          f"{rep.get('b_s', 0.0):.1f} s, whole path "
          f"{rep.get('total_s', 0.0):.1f} s", flush=True)


KERNEL_SOURCES = ["ensemble_kl_bank", "ensemble_kl", "swa_attn", "ssd_scan"]


def setup_torch():
    """torch with the port on its path, float32 matmuls in full float32
    (no TF32), or None when no CUDA card is visible."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def group_worker(index: int, out: str) -> int:
    """``chip_smoke.py --paths INDEX OUT``: the paths of PATH_GROUPS[INDEX]
    in order in this process (the kernels loaded from the parent's build),
    their reports and problems pickled to ``OUT``.  A path that raises
    becomes a problem with its traceback, and ends the group."""
    import pickle
    import traceback
    torch = setup_torch()
    if torch is None:
        return fail("torch.cuda.is_available() is False")
    torch.set_num_threads(WORKER_THREADS)
    from repro_torch.kernels import build
    build.build(KERNEL_SOURCES)
    paths, problems = {}, []
    for name, fn_name in PATH_GROUPS[index]:
        t0 = time.perf_counter()
        try:
            rep, more = globals()[fn_name]()
        except Exception:
            problems.append(f"{name} raised:\n{traceback.format_exc()}")
            break
        rep.setdefault("total_s", time.perf_counter() - t0)
        paths[name] = rep
        problems += [f"{name}: {p}" for p in more]
        print(f"  [group {index}] {name}: {rep['total_s']:.1f} s",
              flush=True)
    Path(out).write_bytes(pickle.dumps({"paths": paths,
                                        "problems": problems}))
    return 0


def run_path_groups(out_dir: Path) -> tuple:
    """Every PATH_GROUPS entry in a worker process of its own, all started
    together; waits for all (killing every one still running if the wait
    fails) and returns the reports of every path by name, the problems and
    the seconds until the last group ended."""
    import pickle
    procs, t0 = [], time.perf_counter()
    out_dir.mkdir(exist_ok=True)
    try:
        for i in range(len(PATH_GROUPS)):
            out = out_dir / f"chip_smoke_group{i}.pkl"
            out.unlink(missing_ok=True)
            procs.append((out, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--paths",
                 str(i), str(out)], cwd=ROOT)))
        for _, p in procs:
            p.wait(timeout=max(1.0, WORKER_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    paths, problems = {}, []
    for i, (out, p) in enumerate(procs):
        if p.returncode != 0 or not out.exists():
            problems.append(f"path group {i} exited with {p.returncode}")
            continue
        got = pickle.loads(out.read_bytes())
        out.unlink()
        paths.update(got["paths"])
        problems += got["problems"]
    return paths, problems, time.perf_counter() - t0


def alone_main(path: int, four: bool) -> int:
    """``chip_smoke.py --path18`` / ``--path19``: the kernels built and
    that path alone on one card; ``--four``: paths 18's and 19's
    four-card parts (four cards, one NCCL rank each).  The report is
    written to
    chiprun_out/chip_smoke_path{18,19}[_four].json."""
    start_s = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"the port (src/repro_torch) is not next to "
                    f"{Path(__file__).name}; run it from a checkout")
    torch = setup_torch()
    if torch is None:
        return fail("torch.cuda.is_available() is False")
    if four and torch.cuda.device_count() < 4:
        return fail(f"--four needs 4 cards, found "
                    f"{torch.cuda.device_count()}")
    from repro_torch.kernels import build
    build.build(KERNEL_SOURCES)
    print(f"build: {time.perf_counter() - start_s:.2f} s", flush=True)
    runs = {18: (layouts_four_path if four else
                 lambda: layouts_path("cuda"), print_path18),
            19: (moe_mesh_four_path if four else
                 lambda: moe_mesh_path("cuda"), print_path19)}
    problems = []
    for p in ((18, 19) if path == 0 else (path,)):
        run, show = runs[p]
        t0 = time.perf_counter()
        rep, more = run()
        rep["total_s"] = time.perf_counter() - t0
        show(rep)
        problems += more
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        name = f"chip_smoke_path{p}" + ("_four" if four else "") + ".json"
        (out_dir / name).write_text(json.dumps(rep, indent=1, default=str))
    if problems:
        for p in problems:
            print(f"chip_smoke: {p}", file=sys.stderr)
        return fail(f"{len(problems)} problem(s)")
    print(f"total {time.perf_counter() - start_s:.1f} s")
    print(card_line())
    return 0


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--paths":
        return group_worker(int(sys.argv[2]), sys.argv[3])
    alone = {"--path18": (18, False), "--path19": (19, False),
             "--four": (0, True)}
    if len(sys.argv) == 2 and sys.argv[1] in alone:
        return alone_main(*alone[sys.argv[1]])
    start_s = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"the port (src/repro_torch) is not next to "
                    f"{Path(__file__).name}; run it from a checkout")
    torch = setup_torch()
    if torch is None:
        return fail("torch.cuda.is_available() is False")
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
    libs = build.build(KERNEL_SOURCES)
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
    # block per row forward, each finishing its rows or (K2s) writing their
    # statistics, and the backward at both index widths, each for 1, 4 and
    # 8 teachers in flight and f32 and bf16 teachers (48)
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
    # every instantiation (f32 / bf16 x D buckets 64 / 128 / 256 x causal
    # / bidirectional) spills nothing: the paths run f32 D <= 64 (zamba2,
    # granite-moe, internvl2), D 128 causal (qwen3-8b) and bidirectional
    # (hubert's D = 80), D 256 (gemma3-4b)
    k4_spills = {n: u for n, u in report["k4_ptxas"].items()
                 if u.get("spill_stores") != 0 or u.get("spill_loads") != 0}
    if len(report["k4_ptxas"]) != K4_KERNELS or k4_spills:
        build_problems.append(f"swa_attn's {K4_KERNELS} instantiations "
                              f"spill or are missing: "
                              f"{report['k4_ptxas']}")
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
    k2s_timings, k2s_errors = k2s_phase(device)
    report["k2s_errors"], report["k2s_timings"] = k2s_errors, k2s_timings
    for e in k2s_errors:
        print(f"  check K2s K={e['K']} B={e['B']} V_loc={e['V_loc']} "
              f"{e['teachers']:8s} mode {e['mode']}: rows {e['fwd_err']:.2e}"
              f" against the plain version; merged chunks " + ", ".join(
                  f"{n}: loss {m['loss_err']:.2e} grad {m['grad'][0]:.2e}"
                  for n, m in e["merged"].items())
              + f" against whole K2f / K2b; two launches "
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
    k5_split = ssm_split_check(device)
    report.update(k4_errors=k4_errors, k4_timings=k4_timings,
                  k5_errors=k5_errors, k5_timings=k5_timings,
                  k5_split=k5_split)
    for e in k4_errors:
        print(f"  check swa_attn B={e['B']} H={e['H']} H_kv={e['H_kv']} "
              f"S={e['S']} D={e['D']} window={e['window']} "
              f"causal={e['causal']} {e['dtype']:8s}: "
              f"max abs err {e['max_abs_err']:.2e}, excess over the bound "
              f"{e['excess']:.2e} (rtol {e['rtol']:.0e} atol "
              f"{e['atol']:.0e}) {'ok' if e['ok'] else 'FAIL'}")
    for e in k5_errors:
        print(f"  check ssd_scan B={e['B']} S={e['S']} H={e['H']} P={e['P']} "
              f"N={e['N']} {e['dtype']:8s} from a state {e['init_state']}: "
              f"y {e['y_err']:.2e} state "
              f"{e['state_err']:.2e} sequential "
              f"{e.get('sequential_err', '-')} (rtol {e['rtol']:.0e} atol "
              f"{e['atol']:.0e}) {'ok' if e['ok'] else 'FAIL'}")
    for name, rows in (("swa_attn", k4_timings), ("ssd_scan", k5_timings)):
        for r in rows:
            shape = " ".join(f"{k}={r[k]}" for k in
                             ("B", "H", "H_kv", "S", "D", "window", "causal",
                              "dtype", "P", "N", "init_state") if k in r)
            lib = ("-" if r["library_ms"] is None else
                   f"{r['library_ms'] * 1e3:.1f} / "
                   f"{r['library_call_ms'] * 1e3:.1f}")
            print(f"  time {name} {shape}: {r['ms'] * 1e3:.1f} us device / "
                  f"{r['call_ms'] * 1e3:.1f} us per call; plain "
                  f"{r['plain_ms'] * 1e3:.1f} / "
                  f"{r['plain_call_ms'] * 1e3:.1f}; library {lib}; bound "
                  f"{r['bound_ms'] * 1e3:.1f} us by "
                  f"{r.get('bound_detail', r['bound_by'])}", flush=True)
    print(f"  check zamba2 mamba layer split through init_cache: "
          f"{k5_split} {'ok' if k5_split['ok'] else 'FAIL'}", flush=True)
    problems = build_problems + [
        f"kernel check failed: {e}" for e in
        errors + k1_modes + k1_grids + k1_poison + k2_errors + k2s_errors
        + nonfinite
        + k4_errors + k5_errors + [k5_split] if not e["ok"]]

    # 4. the paths, each with its own launch counts: paths 1-3 and 5-11 in
    # the PATH_GROUPS workers, beside each other; the served models after
    print(f"kernel phases done at {time.perf_counter() - start_s:.1f} s",
          flush=True)
    paths, group_problems, groups_s = run_path_groups(ROOT / "chiprun_out")
    problems += group_problems
    report["path_groups_s"] = groups_s
    print(f"path groups ({len(PATH_GROUPS)} workers): {groups_s:.1f} s, "
          f"done at {time.perf_counter() - start_s:.1f} s", flush=True)
    names = [name for group in PATH_GROUPS for name, _ in group]
    if any(name not in paths for name in names):
        for p in problems:
            print(f"chip_smoke: {p}", file=sys.stderr)
        return fail(f"paths without a report: "
                    f"{[n for n in names if n not in paths]}")
    # 10b rejoins path 10, its sub-paths in order; the seconds of both
    stale, rt = paths.pop("path10b_staleness"), paths["path10_runtime"]
    paths["path10_runtime"] = {
        "10a": rt["10a"], **{k: v for k, v in stale.items()
                             if k != "total_s"},
        **{k: v for k, v in rt.items() if k not in ("10a", "total_s")},
        "total_s": rt["total_s"] + stale["total_s"]}
    for name in ("path1_quickstart", "path2_generator", "path3_buffered"):
        print_path(name, paths[name])
    for name in ("path5a_hetero_bank", "path5b_hetero_fly",
                 "path6_baselines", "path7_ablations"):
        rep = paths[name]
        subs = ({name: rep} if name in ("path5a_hetero_bank",
                                        "path5b_hetero_fly") else
                {f"{name} {k}": v for k, v in rep.items() if k != "total_s"})
        if "fedavg" in rep:
            subs[f"{name} fedavg"] = rep["fedavg"]
        for sub, r in subs.items():
            print_path(sub, r)
        print(f"  {name}: whole path {rep['total_s']:.1f} s", flush=True)
    for name in ("path8a_buffered_hetero", "path8b_bucketing",
                 "path8c_tokens"):
        rep = paths[name]
        subs = ({f"{name} {k}": v for k, v in rep.items() if k != "total_s"}
                if name == "path8b_bucketing" else {name: rep})
        for sub, r in subs.items():
            print_path(sub, r)
        print(f"  {name}: whole path {rep['total_s']:.1f} s", flush=True)
    for name in ("path9a_defended", "path9b_undefended",
                 "path9c_robust_rules", "path9d_buffered_faults",
                 "path9e_resume"):
        rep = paths[name]
        subs = ({f"{name} {k}": v for k, v in rep.items() if k != "total_s"}
                if name == "path9c_robust_rules" else {name: rep})
        for sub, r in subs.items():
            print_path(sub, r)
        print(f"  {name}: whole path {rep['total_s']:.1f} s", flush=True)
    rep = paths["path10_runtime"]
    for sub, r in rep.items():
        if sub != "total_s":
            print_path(f"path10 {sub}", r)
    print_runtime(rep)
    print(f"  path10_runtime: whole path {rep['total_s']:.1f} s", flush=True)
    for name in ("path11a_cli", "path11b_bank_reuse"):
        print_path11(name, paths[name])
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
    for name, (arch, k4) in [(f"path12_{a}", (a, n)) for a, n in GQA_SERVE] + [
            ("path13a_moe", MOE_SERVE), ("path13b_vlm", VLM_SERVE)]:
        t0 = time.perf_counter()
        rep, path_problems = decoder_serve_path(device, arch, k4)
        rep["total_s"] = time.perf_counter() - t0
        paths[name] = rep
        problems += [f"{name}: {p}" for p in path_problems]
        print_path12(name, rep)
    t0 = time.perf_counter()
    rep, path_problems = encoder_forward_path(device, *AUDIO_FORWARD)
    rep["total_s"] = time.perf_counter() - t0
    paths["path13c_audio"] = rep
    problems += [f"path13c_audio: {p}" for p in path_problems]
    print_path13c("path13c_audio", rep)
    t0 = time.perf_counter()
    rep, path_problems = step_builders_path(device)
    rep["total_s"] = time.perf_counter() - t0
    paths["path14_steps"] = rep
    problems += [f"path14_steps: {p}" for p in path_problems]
    print_path14(rep)
    print(f"served models done at {time.perf_counter() - start_s:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    rep, path_problems = mesh_path(device)
    rep["total_s"] = time.perf_counter() - t0
    paths["path15_mesh"] = rep
    problems += [f"path15_mesh: {p}" for p in path_problems]
    print_path15(rep)
    print(f"path 15 done at {time.perf_counter() - start_s:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    rep, path_problems = model_axis_path(
        device, paths["path14_steps"]["14a_train"]["held"]["cpu_ulp_spread"])
    rep["total_s"] = time.perf_counter() - t0
    paths["path16_model_axis"] = rep
    problems += [f"path16_model_axis: {p}" for p in path_problems]
    print_path16(rep)
    print(f"path 16 done at {time.perf_counter() - start_s:.1f} s",
          flush=True)
    problems += paths_17_to_19(device, k2s_timings, paths, start_s)

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

    def path13_launches(name):
        """Each path 13 model's launches of ``name``: while serving (13a,
        13b) or in its one forward (13c)."""
        return {k: paths[p]["launches"].get(name, 0) for k, p in
                (("13a", "path13a_moe"), ("13b", "path13b_vlm"),
                 ("13c", "path13c_audio"))}

    def path14_launches(name):
        """Each path 14 sub-path's launches of ``name``: 14a over its
        steps, 14b's distill step, 14c's round, 14d's prefill."""
        p = paths["path14_steps"]
        return {"14a": p["14a_train"]["launches"].get(name, 0),
                "14b": p["14b_distill"]["launches"].get(name, 0),
                "14c": p["14c_fed_round"]["launches"].get(name, 0),
                "14d": p["14d_serve"]["prefill_launches"].get(name, 0)}

    def path15_launches(name):
        """Path 15's launches of ``name``: each rank of 15a(i), 15a(ii)
        and 15b, the sync runs 15a(iii) and 15b's, each rank of 15c and
        its unsharded round."""
        p = paths["path15_mesh"]
        ranks = lambda rows: [r["launches"].get(name, 0) for r in rows]
        return {"15a_i": ranks(p["15a_i"]), "15a_ii": ranks(p["15a_ii"]),
                "15a_iii": p["15a_iii_launches"].get(name, 0),
                "15b": ranks(p["15b"]),
                "15b_sync": p["15b_sync_launches"].get(name, 0),
                "15c": ranks(p["15c"]["ranks"]),
                "15c_unsharded": p["15c"]["unsharded_launches"].get(name, 0)}

    def path16_launches(name):
        """Path 16's launches of ``name`` on each rank: 16a's full-depth
        step and held step, 16b's held step, 16c's two prefills and 16d's
        full-depth round."""
        p = paths["path16_model_axis"]
        two, four = p["two"], p["four"]
        n = lambda r: r["launches"].get(name, 0)
        return {"16a": [n(r["16a_full"]["steps"][0]) for r in p["full"]],
                "16a_held": [n(r["16a_held"]) for r in two],
                "16b_held": [n(r["16b_held"]) for r in four],
                "16c_zamba2": [n(r["16c"][SERVE_ARCH]) for r in two],
                "16c_granite": [n(r["16c"][MOE_SERVE[0]]) for r in two],
                "16d": [n(r["16d"]["full"]) for r in two]}

    def path17_launches(name):
        """Path 17's launches of ``name`` on each rank: 17a's held and
        full-depth distill steps, 17b's and 17c's prefills and decodes."""
        ranks = paths["path17_mesh_serve"]["ranks"]
        n = lambda r: r["launches"].get(name, 0)
        out = {"17a_held": [n(r["17a_held"]) for r in ranks],
               "17a": [n(r["17a_full"]) for r in ranks]}
        for key in ("17b_held", "17b_gqa", "17b_full", "17c_held"):
            for part in ("prefill", "decode"):
                out[f"{key}_{part}"] = [n(r[key][part]) for r in ranks]
        return out

    def path18_launches(name):
        """Path 18's launches of ``name`` on each rank: 18a's held steps
        (each layout and knob) and held distill step, 18b's full-depth
        step, 18c's prefill and decode."""
        ranks = paths["path18_layouts"]["ranks"]
        n = lambda r: r["launches"].get(name, 0)
        out = {f"18a_{k}": [n(r["18a_train"][k]) for r in ranks]
               for k in ("dp_heavy", "dp_heavy_z3", "tp", "tp_acts",
                         "tp_naive")}
        out["18a_distill"] = [n(r["18a_distill"]["acts_True"])
                              for r in ranks]
        out["18b"] = [n(r["18b"]) for r in ranks]
        for part in ("prefill", "decode"):
            out[f"18c_{part}"] = [n(r["18c"][part]) for r in ranks]
        return out

    def path19_launches(name):
        """Path 19's launches of ``name`` on each rank: 19a's held steps
        (each layout), distill step, prefill and decode; 19b's
        full-depth step."""
        p = paths["path19_moe_mesh"]
        n = lambda r: r["launches"].get(name, 0)
        out = {f"19a_{k}": [n(r["19a"][k]) for r in p["a"]]
               for k in [t[0] for t in P19_TRAIN] + ["distill"]}
        for part in ("prefill", "decode"):
            out[f"19a_{part}"] = [n(r["19a"]["serve"][part]) for r in p["a"]]
        out["19b"] = [n(r["19b"]) for r in p["b"]]
        return out

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
                "path13_launches": path13_launches(name),
                "path14_launches": path14_launches(name),
                "path15_launches": path15_launches(name),
                "path16_launches": path16_launches(name),
                "path17_launches": path17_launches(name),
                "path18_launches": path18_launches(name),
                "path19_launches": path19_launches(name),
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
            "path13_launches": path13_launches(name),
            "path14_launches": path14_launches(name),
            "path15_launches": path15_launches(name),
            "path16_launches": path16_launches(name),
            "path17_launches": path17_launches(name),
            "path18_launches": path18_launches(name),
            "path19_launches": path19_launches(name),
            "path14_dtypes": sorted({d for sub in ("14a_train", "14b_distill",
                                                   "14c_fed_round",
                                                   "14d_serve")
                                     for d in paths["path14_steps"][sub]
                                     ["kernel_dtypes"].get(name, ())}),
            "max_abs_err": max(e["max_abs_err"] for e in errs
                               if e.get("dtype", "float32") == "float32"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "call_ms": t["call_ms"], "plain_call_ms": t["plain_call_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"] if lib else None,
            "bound_detail": t["bound_detail"]})
    # K2s: its launches are path 17a's full-depth step (rank 0), its
    # times at that step's shard (4 teachers over 2 x 512 rows, 16000 of
    # zamba2's 32000 columns, bf16 teachers)
    t = timing(k2s_timings, K=4, B=1024, V_loc=16000, teachers="bfloat16")
    name = "ensemble_kl_split_fwd"
    kernels.append({
        "name": name, "route": "cuda", "source": src + "ensemble_kl.cu",
        "replaces": pallas + "107",
        "launches": paths["path17_mesh_serve"]["ranks"][0]["17a_full"]
        ["launches"].get(name, 0),
        "path17_launches": path17_launches(name),
        "path18_launches": path18_launches(name),
        "path19_launches": path19_launches(name),
        "max_abs_err": max(e["fwd_err"] for e in k2s_errors),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "call_ms": t["call_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None})
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
