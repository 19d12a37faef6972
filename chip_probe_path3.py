#!/usr/bin/env python3
"""Where the card and the CPU part on chip_smoke.py's path 3.

    python3 chip_probe_path3.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It runs path 3 (the buffered-async driver, staleness 1, ``noise`` source)
for two rounds on the CPU, keeps the inputs of the second fusion (the
first with stale uploads, so the weighted teacher consensus), and reruns
that fusion's distillation alone, from the same inputs, on the CPU and on
the card: with the fused loss (kernel K3, or K2 on the unweighted but
equal consensus) and with autograd of the plain version
(``use_fused_kernel=False``), stopped after 1, 10 and 50 steps and run to
its end.  Each line prints the largest parameter difference from the CPU
run with the fused loss, the best validation step and the first
validation accuracies.  It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_path3: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.api import Experiment
    from repro_torch.common.pytree import tree_flatten, tree_to
    from repro_torch.core import feddf
    from repro_torch.data.distill_sources import RandomNoiseSource

    fuse = feddf.feddf_fuse_stacked
    calls = []

    def recording(net, stack, weights, source, fusion, val_x=None,
                  val_y=None, seed=0, student=None, teacher_weights=None):
        calls.append(dict(net=net, stack=stack, weights=weights,
                          fusion=fusion, val_x=val_x, val_y=val_y,
                          seed=seed, student=student, tw=teacher_weights))
        return fuse(net, stack, weights, source, fusion, val_x, val_y,
                    seed, student, teacher_weights)

    feddf.feddf_fuse_stacked = recording
    Experiment(cs.buffered_spec(2), device="cpu").run()
    feddf.feddf_fuse_stacked = fuse
    r = calls[1]
    print(f"card: {cs.card_line()}; teacher weights {r['tw']}")

    def run(dev, fused, weighted, steps):
        fusion = dataclasses.replace(r["fusion"], use_fused_kernel=fused)
        if steps is not None:
            fusion = dataclasses.replace(fusion, max_steps=steps)
        val = ((r["val_x"].to(dev), r["val_y"].to(dev)) if steps is None
               else (None, None))
        p, info = fuse(r["net"], tree_to(r["stack"], dev), r["weights"],
                       RandomNoiseSource((2,), device=dev), fusion, *val,
                       r["seed"], tree_to(r["student"], dev),
                       r["tw"] if weighted else None)
        return {k: v.cpu() for k, v in tree_flatten(p).items()}, info

    for steps in (1, 10, 50, None):
        base, _ = run("cpu", "auto", True, steps)
        for dev, fused, weighted in (("cpu", False, True),
                                     ("cuda", "auto", True),
                                     ("cuda", False, True),
                                     ("cuda", "auto", False)):
            p, info = run(dev, fused, weighted, steps)
            diff = max(float((p[k] - base[k]).abs().max()) for k in p)
            accs = [round(a, 4) for _, a in info["val_history"]][:6]
            print(f"steps={steps or 'all'} {dev} fused={fused} "
                  f"weighted={weighted}: max |param - cpu fused| {diff:.3g}; "
                  f"best step {info['best_step']}; val {accs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
