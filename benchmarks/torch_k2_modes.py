#!/usr/bin/env python3
"""Times the forward modes of the port's AVGLOGITS KL kernel (K2 / K3,
``src/repro_torch/kernels/csrc/ensemble_kl.cu``) against each other on one
CUDA card, at the shapes where ``kernels/ensemble_kl.py:plan`` switches
between them.

    python3 benchmarks/torch_k2_modes.py

For every (K, B, V) below it launches the forward under each candidate
plan: lane groups (G = 32, or V's next power of two below it), one block
per row, and a thread-block cluster of 2, 4 and 8 blocks per row, checks
each against the plain version (rtol 1e-5 / atol 1e-6 on the loss), and
prints the CUDA-graph device time of each, the plan's own choice marked
with ``*``.  These are the times that set the plan's thresholds
(``LANES_MAX_V`` and the cluster rule).  float32 teachers, T = 1.  Exits
non-zero without a CUDA card, or if a mode disagrees with the plain
version.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# lane groups against one block per row, for V across the lanes threshold;
# one block against clusters where B alone fills under a wave
LANE_SHAPES = [(k, b, v) for k in (1, 8) for b in (64, 256)
               for v in (3, 16, 33, 64, 128, 256, 512)]
CLUSTER_SHAPES = [(8, b, v) for b in (16, 64, 128) for v in (512, 1000, 5003)]
RTOL, ATOL = 1e-5, 1e-6


def candidates(k2, k, b, v):
    """The plan's own choice, and (name, Plan) of every forward mode that
    can run (K, B, V)."""
    own = k2.plan(k, b, v)
    lanes = k2.plan_in_mode(k, b, v, "lanes")
    out = [(f"lanes G={lanes.lanes}", lanes),
           ("block", k2.plan_in_mode(k, b, v, "block"))]
    out += [(f"cluster C={c}", k2.plan_in_mode(k, b, v, "cluster", c))
            for c in k2.CLUSTER_SIZES]
    return own, out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_k2_modes: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ref
    device = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"device: {card}", flush=True)
    bad = []
    for k, b, v in LANE_SHAPES + CLUSTER_SHAPES:
        s, t = chip_smoke.k2_case(k, b, v, "float32", seed=k + b + v,
                                  device=device)
        want = float(ref.ensemble_kl(s, t))
        own, plans = candidates(k2, k, b, v)
        times = {}
        for name, p in plans:
            got = float(k2.kl_fwd(s, t, launch=p)[0].sum() / b)
            if abs(got - want) > ATOL + RTOL * abs(want):
                bad.append((k, b, v, name, got, want))
            times[name] = chip_smoke.device_ms(
                lambda p=p: k2.kl_fwd(s, t, launch=p)) * 1e3
        chosen = next(n for n, p in plans
                      if (p.mode, p.cluster, p.lanes) ==
                      (own.mode, own.cluster, own.lanes))
        print(f"K={k} B={b:3d} V={v:4d}: " + "  ".join(
            f"{n}{'*' if n == chosen else ''} {us:.2f}"
            for n, us in times.items()), flush=True)
    for item in bad:
        print(f"torch_k2_modes: loss differs from the plain version: {item}",
              file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
