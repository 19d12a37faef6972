#!/usr/bin/env python3
"""Where the card and the CPU part on chip_smoke.py's paths 5b and 6.

    python3 chip_probe_hetero.py [--device cpu]

Run from the root of a checkout on a machine with a CUDA card and nvcc
(``--device cpu`` runs the "card" side on the CPU too, a dry run of the
script itself).  It prints, and gates nothing:

1. path 5b (heterogeneous FedDF on the fly: K2 over the 6 teachers of
   three nets), round 1: per group, how far the card with its kernels
   and the card with their plain versions (``use_fused_kernel=False``)
   sit from the CPU and from each other; and the CPU's own sensitivity,
   a second CPU run from the initial globals moved up by one unit in the
   last place; each run's best-validation step per group;
2. path 6's ``fedavgm`` after 2 rounds: the card against the CPU, and
   the CPU's own sensitivity as in 1;
3. group 1's distillation of path 5b's round 1 alone: from the inputs
   the card's run gave it, step by step along the card's trajectory, the
   K2 loss and its gradient on the student logits against the plain
   version on the same inputs (K2's tolerances of chip_smoke.py); then,
   from the CPU run's inputs and from the card's, the distillation
   stopped after 1, 10, 50 and all its steps without validation, and run
   with validation to its best step as the path does, on the CPU and on
   the card with the kernels and with the plain versions: each line the
   largest parameter differences of the three pairs (and the leaf each
   sits in) and the best validation steps.

It exits non-zero without a CUDA device unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GROUP = 1          # proto-medium: the group whose globals part furthest


def ulp_init(spec):
    """The run's own initial globals (``RoundEngine.init_globals``, drawn
    on the CPU) with every weight moved up by one unit in the last
    place."""
    import torch
    from repro_torch.api import (build_cohort, build_splits,
                                 build_task_bundle, to_fl_config)
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.engine import RoundEngine
    bundle = build_task_bundle(spec)
    train, val, test, parts = build_splits(spec, bundle)
    nets, proto = build_cohort(spec, bundle)
    init = RoundEngine(nets, proto, train, parts, val, test,
                       to_fl_config(spec), heterogeneous=len(nets) > 1,
                       device="cpu").init_globals()
    up = lambda x: torch.nextafter(x, torch.full_like(x, float("inf")))
    return [tree_map(up, g) for g in init]


def with_plain(spec):
    """``spec`` with the fused loss off: the kernels' plain versions."""
    fusion = dataclasses.replace(spec.strategy.fusion,
                                 use_fused_kernel=False)
    return dataclasses.replace(spec, strategy=dataclasses.replace(
        spec.strategy, fusion=fusion))


def whole_runs(cs, dev):
    """Parts 1 and 2; returns the inputs (and infos) of path 5b's fusion in
    the CPU run and in the card's run with the kernels."""
    from repro_torch.api import Experiment
    from repro_torch.core import feddf
    fuse = feddf.feddf_fuse_heterogeneous_stacked
    recs = {}

    def run(name, spec, device):
        def recording(prototypes, source, fusion, val_x=None, val_y=None,
                      seed=0, importances=None):
            out = fuse(prototypes, source, fusion, val_x, val_y, seed,
                       importances)
            recs[name] = dict(prototypes=prototypes, fusion=fusion,
                              val_x=val_x, val_y=val_y, seed=seed,
                              infos=out[1])
            return out
        feddf.feddf_fuse_heterogeneous_stacked = recording
        try:
            return Experiment(spec, device=device).run()
        finally:
            feddf.feddf_fuse_heterogeneous_stacked = fuse

    spec = cs.hetero_spec(1, bank="off")
    card = run("card kernels", spec, dev)
    plain = run("card plain", with_plain(spec), dev)
    cpu = run("cpu", spec, "cpu")
    moved = Experiment(spec, device="cpu").run(init_globals=ulp_init(spec))
    print(f"5b round 1, per group: card kernels vs CPU "
          f"{cs.group_diffs(card, cpu)}; card plain vs CPU "
          f"{cs.group_diffs(plain, cpu)}; card kernels vs card plain "
          f"{cs.group_diffs(card, plain)}; CPU vs CPU from the init moved "
          f"1 ulp {cs.group_diffs(moved, cpu)}; distill steps "
          f"{[[l.distill_steps for l in g] for g in cs.group_logs(card)]}",
          flush=True)
    for name, r in recs.items():
        hist = r["infos"][GROUP]["val_history"]
        print(f"  {name}: best step per group "
              f"{[i.get('best_step') for i in r['infos']]}; group {GROUP} "
              f"val {[round(a, 4) for _, a in hist]}", flush=True)
    print(f"  the card runs' fusion inputs, kernels vs plain: "
          f"{stack_diff(recs['card kernels'], recs['card plain'])}; card "
          f"vs CPU: {stack_diff(recs['card kernels'], recs['cpu'])}",
          flush=True)

    spec = cs.baseline_specs()["fedavgm"]
    card = Experiment(spec, device=dev).run()
    cpu = Experiment(spec, device="cpu").run()
    moved = Experiment(spec, device="cpu").run(init_globals=ulp_init(spec))
    print(f"fedavgm rounds 1-2: card vs CPU {cs.group_diffs(card, cpu)}; "
          f"CPU vs CPU from the init moved 1 ulp "
          f"{cs.group_diffs(moved, cpu)}; test acc card "
          f"{[l.test_acc for l in card.result.logs]} CPU "
          f"{[l.test_acc for l in cpu.result.logs]}", flush=True)
    return recs["cpu"], recs["card kernels"]


def stack_diff(a, b) -> float:
    """Largest difference of two recorded fusions' teacher stacks."""
    import chip_smoke as cs
    return cs.max_abs_diff([st for _, st, _ in a["prototypes"]],
                           [st for _, st, _ in b["prototypes"]])


def group_distill(cs, rec, dev, fused, steps):
    """Group GROUP's distillation of the recorded fusion on ``dev``."""
    from repro_torch.api import build_splits, build_task_bundle
    from repro_torch.api.experiment import build_source
    from repro_torch.common.pytree import (tree_flatten, tree_to,
                                           tree_weighted_mean_stacked)
    from repro_torch.core import feddf
    spec = cs.hetero_spec(1, bank="off")
    bundle = build_task_bundle(spec)
    train = build_splits(spec, bundle)[0]
    protos = [(net, None if st is None else tree_to(st, dev), w)
              for net, st, w in rec["prototypes"]]
    teachers = [feddf.make_teacher_logits_fn(net, st)
                for net, st, _ in protos if st is not None]
    net, stack, weights = protos[GROUP]
    fusion = dataclasses.replace(rec["fusion"], use_fused_kernel=fused)
    if steps is not None:
        fusion = dataclasses.replace(fusion, max_steps=steps)
    val = ((rec["val_x"].to(dev), rec["val_y"].to(dev)) if steps is None
           else (None, None))
    p, info = feddf.distill(
        net, tree_weighted_mean_stacked(stack, weights), teachers,
        build_source(spec, bundle, train, dev), fusion, *val,
        rec["seed"] + GROUP)
    return {k: v.cpu() for k, v in tree_flatten(p).items()}, info


def per_step_check(cs, rec, dev):
    """Part 3's first half: every K2 call of group GROUP's distillation on
    ``dev`` also runs the plain version on the same inputs."""
    import torch
    from repro_torch.core import feddf
    from repro_torch.kernels import ref
    orig = feddf.ensemble_kl_loss
    rows = []

    def checking(s_logits, t_logits, temp):
        s_k = s_logits.detach().requires_grad_(True)
        s_p = s_logits.detach().requires_grad_(True)
        l_k, l_p = orig(s_k, t_logits, temp), ref.ensemble_kl(s_p, t_logits,
                                                              temp)
        (g_k,) = torch.autograd.grad(l_k, s_k)
        (g_p,) = torch.autograd.grad(l_p, s_p)
        d = (g_k - g_p).abs()
        want = float(l_p.detach())
        dl = abs(float(l_k.detach()) - want)
        rows.append((dl, dl - cs.K2_FWD_ATOL - cs.K2_FWD_RTOL * abs(want),
                     float(d.max()),
                     float((d - cs.K2_GRAD_ATOL
                            - cs.K2_GRAD_RTOL * g_p.abs()).max()),
                     float(g_p.abs().max()), tuple(t_logits.shape)))
        return orig(s_logits, t_logits, temp)

    feddf.ensemble_kl_loss = checking
    try:
        _, info = group_distill(cs, rec, dev, "auto", None)
    finally:
        feddf.ensemble_kl_loss = orig
    print(f"group {GROUP}, {info['steps']} steps, teachers "
          f"{sorted({r[5] for r in rows})}: K2 against its plain version "
          f"on the same inputs at every step", flush=True)
    for lo, hi in ((0, 1), (1, 10), (10, 50), (50, len(rows))):
        part = rows[lo:hi]
        if part:
            print(f"  steps {lo + 1}-{hi}: max |loss diff| "
                  f"{max(r[0] for r in part):.3g} (excess over tol "
                  f"{max(r[1] for r in part):.3g}); max |grad diff| "
                  f"{max(r[2] for r in part):.3g} (excess over tol "
                  f"{max(r[3] for r in part):.3g}); max |grad| "
                  f"{max(r[4] for r in part):.3g}", flush=True)
    print(f"  every step within K2's tolerances: "
          f"{all(r[1] <= 0 and r[3] <= 0 for r in rows)}", flush=True)


def trajectories(cs, rec, dev, inputs):
    """Part 3's second half, as chip_probe_path3.py does for path 3: group
    GROUP's distillation from ``inputs``' recorded fusion, on the CPU and
    on the card with the kernels and with the plain versions; the full
    step count without validation shows the raw trajectories, the run to
    its end the best-validation params the path returns."""
    full = rec["fusion"].max_steps
    for steps in (1, 10, 50, full, None):
        runs = {"cpu": group_distill(cs, rec, "cpu", "auto", steps),
                "kernels": group_distill(cs, rec, dev, "auto", steps),
                "plain": group_distill(cs, rec, dev, False, steps)}
        parts = []
        for a, b in (("kernels", "cpu"), ("plain", "cpu"),
                     ("kernels", "plain")):
            pa, pb = runs[a][0], runs[b][0]
            diffs = {k: float((pa[k] - pb[k]).abs().max()) for k in pa}
            leaf = max(diffs, key=diffs.get)
            parts.append(f"{a} vs {b} {diffs[leaf]:.3g} ({leaf})")
        best = {k: info["best_step"] for k, (_, info) in runs.items()}
        val_equal = len({tuple(info["val_history"])
                         for _, info in runs.values()}) == 1
        print(f"inputs of the {inputs} run, steps="
              f"{'all, best-validation' if steps is None else steps}: "
              f"{'; '.join(parts)}; best step {best}; validation histories "
              f"equal: {val_equal}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = ap.parse_args().device
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if dev == "cuda" and not torch.cuda.is_available():
        print("chip_probe_hetero: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    if dev == "cuda":
        print(f"card: {cs.card_line()}", flush=True)
    cpu_rec, card_rec = whole_runs(cs, dev)
    per_step_check(cs, card_rec, dev)
    trajectories(cs, cpu_rec, dev, "CPU")
    trajectories(cs, card_rec, dev, "card's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
