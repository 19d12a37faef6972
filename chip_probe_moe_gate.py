#!/usr/bin/env python3
"""Whether chip_smoke.py's path-19a gradient gates can fail, on the card.

    python3 chip_probe_moe_gate.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
On path 19a's 2 x 2 world of 4 gloo ranks sharing the card, with 19a's
leaned granite-moe-1b-a400m (its first 2 layers, f32, capacity factor
1.25) and 19a's references, it runs 19a's train steps as they are and
with a fault planted in the MoE's gradient (the functions patched in the
ranks' processes, nothing on disk changed):

* ``shares_as_copies``: under ``dp_heavy`` at 2 rows, whose model axis's
  ranks share their rows' loss, the experts' partial outputs summed over
  "model" with ``reduce_from`` (the gradient left as it is) instead of
  ``sum_over`` (the gradient summed too): each rank's experts see half of
  their gradient;
* ``router_share_lost``: on the partitioner path (``tp``,
  ``use_moe_shard_map=False``), whose model axis's ranks hold the same
  tokens, the router taken as it is instead of through ``copy_to``: its
  gradient is each rank's experts' share, never summed over "model";
* ``partitioner_as_expert_parallel``: the partitioner path built from
  the expert-parallel route, each data shard routing its own tokens at
  its own capacity instead of the global tokens at the global one.

A fault in the aux loss's share is not among them: 19a's lean spreads
each domain's tokens evenly over its own experts, where the aux loss has
no gradient.

Each run prints path 19a's figures (the largest share of a leaf's bound,
4 x its own 1-ulp spread, and the leaves nearest it; the loss, the aux
loss, the drops) and whether it held.  The probe fails unless every
clean run holds and every planted fault fails its gate.  Details go to
``chiprun_out/chip_probe_moe_gate.json``.  It exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (fault, 19a's train case)
RUNS = (("none", "dp_heavy"), ("none", "dp_heavy_shares"),
        ("none", "tp_noep"), ("shares_as_copies", "dp_heavy_shares"),
        ("router_share_lost", "tp_noep"),
        ("partitioner_as_expert_parallel", "tp_noep"))


def planted(fault: str):
    """Patch ``fault`` into the MoE module; returns the undo."""
    from repro_torch.common import sharding as shd
    from repro_torch.models import moe
    leave, enter, route = moe._leave, moe._enter, moe._moe_global
    if fault == "shares_as_copies":
        def _leave(out, mesh, model, mode):
            if mode == "shares":
                return shd.reduce_from(out, mesh, (model,))
            return leave(out, mesh, model, mode)
        moe._leave = _leave
    elif fault == "router_share_lost":
        def _enter(p, x2, mesh, model, mode):
            x2, pl = enter(p, x2, mesh, model, mode)
            return x2, dict(pl, router=p["router"])
        moe._enter = _enter
    elif fault == "partitioner_as_expert_parallel":
        def _moe_global(p, cfg, x2, mesh, rows, layout=None):
            dp = tuple(a for a in layout.dp_axes if a != layout.model_axis)
            return moe._moe_expert_parallel(p, cfg, x2, mesh, rows, dp,
                                            layout)
        moe._moe_global = _moe_global

    def undo():
        moe._leave, moe._enter, moe._moe_global = leave, enter, route
    return undo


def probe_rank() -> dict:
    """One rank: 19a's model, lean and references, then RUNS."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.launch import mesh as tmesh
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    cfg, params = cs.p19_model(device)
    batch = {k: v.to(device) for k, v in cs.p19_tokens(
        cfg, (cs.PATH19_BATCH, cs.STEP_HELD_SEQ), 1).items()}
    lean = cs.p19_shared_lean(cfg, params, batch["tokens"])
    refs = cs.p19_references(mesh, cfg, params, batch)
    cases = {name: (kw, rows, kind) for name, kw, rows, kind in cs.P19_TRAIN}
    out = {"rank": tmesh.world_rank(), "lean": lean, "runs": []}
    for fault, name in RUNS:
        kw, rows, kind = cases[name]
        undo = planted(fault)
        try:
            r = cs.p19_train(mesh, cfg, params,
                             {k: v[rows] for k, v in batch.items()},
                             refs[(rows.start, rows.stop, kind)], kw)
        finally:
            undo()
        out["runs"].append({"fault": fault, "case": name, **{
            k: r[k] for k in ("held", "grad_ratio", "grad_gap",
                              "worst_leaves", "loss_rel", "aux_err",
                              "bounds", "drops", "ref_drops", "moved")}})
        torch.cuda.empty_cache()
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_moe_gate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as tmesh
    build.build(cs.KERNEL_SOURCES)
    card = cs.card_line()
    ranks = tmesh.launch_ranks(probe_rank, 4, "cuda", threads=2,
                               timeout_s=cs.PATH19_TIMEOUT_S)
    bad = []
    for i, (fault, name) in enumerate(RUNS):
        r = ranks[0]["runs"][i]
        held = all(x["runs"][i]["held"] for x in ranks)
        print(f"{card}: 19a {name} fault {fault}: gradient's largest "
              f"share of its leaf's bound {r['grad_ratio']:.4g} (largest "
              f"gap {r['grad_gap']:.4g}; nearest {r['worst_leaves']}), "
              f"loss {r['loss_rel']:.3g}, aux {r['aux_err']:.3g} (bounds "
              f"{r['bounds']}), drops {r['drops']} (unsharded "
              f"{r['ref_drops']}, moved {r['moved']}): held {held}")
        if held != (fault == "none"):
            bad.append(f"{name} {fault}: held {held}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_probe_moe_gate.json").write_text(json.dumps(
        {"card": card, "runs": RUNS, "ranks": ranks}, indent=1,
        default=str))
    for b in bad:
        print(f"chip_probe_moe_gate: {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
