#!/usr/bin/env python3
"""Where the card and the CPU part on chip_smoke.py's path 7a (drop-worst
at Table 3's instability settings, FedDF on the logit bank, K1).

    python3 chip_probe_ablations.py [--device cpu]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(``--device cpu`` runs the "card" side on the CPU too, a dry run of the
script itself).  It prints, and gates nothing:

1. path 7a's round 1 on the card against the CPU, and the CPU's own
   sensitivity: a CPU run from the initial globals moved up by one unit
   in the last place;
2. the aggregation (drop-worst, then FedDF) of the card run's uploads,
   rerun from those uploads on the card with the kernels, on the card
   with their plain versions (``use_fused_kernel=False``) and on the CPU,
   and on the CPU from the uploads moved one ulp: the new globals' largest
   differences, each run's kept uploads (by their data sizes), distill
   steps, best-validation step and validation history;
3. the fusion alone, from the card run's inputs: every K1 call along the
   card's trajectory against the plain version on the same inputs (K1's
   tolerances of chip_smoke.py), then the distillation stopped after 1,
   10, 50 and all its steps without validation, and run with validation
   to its best step as the path does, on the CPU and on the card with the
   kernels and with the plain versions: each line the largest parameter
   differences of the three pairs (and the leaf each sits in) and the
   best validation steps.

It exits non-zero without a CUDA device unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def with_plain(spec):
    """``spec`` with the fused loss off: the kernels' plain versions."""
    fusion = dataclasses.replace(spec.strategy.fusion,
                                 use_fused_kernel=False)
    return dataclasses.replace(spec, strategy=dataclasses.replace(
        spec.strategy, fusion=fusion))


def up_one_ulp(tree):
    import torch
    from repro_torch.common.pytree import tree_map
    return tree_map(lambda x: torch.nextafter(
        x, torch.full_like(x, float("inf"))), tree)


def aggregations(cs, spec, dev):
    """Parts 1 and 2; returns the card run's recorded fusion."""
    from repro_torch.api import Experiment
    from repro_torch.common.pytree import tree_to
    calls, fusions = [], []
    with cs.recording_engine_aggregate(calls), cs.recording_fusions(fusions):
        card = Experiment(spec, device=dev).run()
    cpu = Experiment(spec, device="cpu").run()
    init = cs.engine_on(spec).init_globals()
    moved = Experiment(spec, device="cpu").run(init_globals=[
        up_one_ulp(init[0])])
    diff = lambda a, b: cs.max_abs_diff(a.global_params, b.global_params)
    print(f"7a round 1: card vs CPU {diff(card, cpu):.3g}; CPU vs CPU from "
          f"the init moved 1 ulp {diff(moved, cpu):.3g}; test acc card "
          f"{card.result.logs[0].test_acc} CPU "
          f"{cpu.result.logs[0].test_acc}", flush=True)

    t, groups, state, (new, _, _), _ = calls[0]
    runs = {}
    for name, d, plain, nudge in (("card kernels", dev, False, False),
                                  ("card plain", dev, True, False),
                                  ("cpu", "cpu", False, False),
                                  ("cpu, uploads +1 ulp", "cpu", False,
                                   True)):
        eng = cs.engine_on(with_plain(spec) if plain else spec, d)
        gs = [dataclasses.replace(
            g, prev_global=tree_to(g.prev_global, d),
            stack=tree_to(up_one_ulp(g.stack) if nudge else g.stack, d))
            for g in groups]
        recs = []
        with cs.recording_fusions(recs):
            out, _, infos = eng.aggregate(t, gs, state)
        runs[name] = (out, infos[0], recs[0]["info"],
                      [float(w) for w in recs[0]["weights"]])
    print(f"  the recorded card aggregation vs its rerun on the card: "
          f"{cs.max_abs_diff(new, runs['card kernels'][0]):.3g}",
          flush=True)
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            print(f"  aggregation {a} vs {b}: "
                  f"{cs.max_abs_diff(runs[a][0], runs[b][0]):.3g}",
                  flush=True)
    for name, (_, info, finfo, kept) in runs.items():
        print(f"  {name}: dropped {info['n_dropped']}, kept the uploads of "
              f"sizes {kept}, distill steps "
              f"{finfo['steps']}, best step {finfo['best_step']}, val "
              f"{[round(a, 4) for _, a in finfo['val_history']]}",
              flush=True)
    return fusions[0]


def per_step_check(cs, rec, spec, dev):
    """Every K1 call of the recorded fusion on ``dev`` against its plain
    version on the same inputs (``chip_smoke.checking_k1``)."""
    rows = []
    with cs.checking_k1(rows):
        _, info = cs.rerun_fusion(rec, spec, dev)
    print(f"the fusion, {info['steps']} steps: K1 against its plain version "
          f"on the same inputs at every step", flush=True)
    for lo, hi in ((0, 1), (1, 10), (10, 50), (50, len(rows))):
        part = rows[lo:hi]
        if part:
            print(f"  steps {lo + 1}-{hi}: max |loss diff| "
                  f"{max(r[0] for r in part):.3g} (excess over tol "
                  f"{max(r[1] for r in part):.3g}); max |grad diff| "
                  f"{max(r[2] for r in part):.3g} (excess over tol "
                  f"{max(r[3] for r in part):.3g})", flush=True)
    print(f"  every step within K1's tolerances: "
          f"{cs.k1_steps_summary(rows)['ok']}", flush=True)


def trajectories(cs, rec, spec, dev):
    full = rec["fusion"].max_steps
    for steps in (1, 10, 50, full, None):
        runs = {"cpu": cs.rerun_fusion(rec, spec, "cpu", steps=steps),
                "kernels": cs.rerun_fusion(rec, spec, dev, steps=steps),
                "plain": cs.rerun_fusion(rec, spec, dev, False, steps)}
        parts = []
        for a, b in (("kernels", "cpu"), ("plain", "cpu"),
                     ("kernels", "plain")):
            pa, pb = runs[a][0], runs[b][0]
            diffs = {k: float((pa[k] - pb[k]).abs().max()) for k in pa}
            leaf = max(diffs, key=diffs.get)
            parts.append(f"{a} vs {b} {diffs[leaf]:.3g} ({leaf})")
        best = {k: info["best_step"] for k, (_, info) in runs.items()}
        print(f"the fusion from the card's inputs, steps="
              f"{'all, best-validation' if steps is None else steps}: "
              f"{'; '.join(parts)}; best step {best}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args().device
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if dev == "cuda" and not torch.cuda.is_available():
        print("chip_probe_ablations: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    if dev == "cuda":
        print(f"card: {cs.card_line()}", flush=True)
    spec = cs.ablation_specs()["7a_dropworst"]
    rec = aggregations(cs, spec, dev)
    per_step_check(cs, rec, spec, dev)
    trajectories(cs, rec, spec, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
