"""Analytic dry run for one NVIDIA H100: build every (architecture x input
shape) step on the ``meta`` device, count what it holds, and derive its
roofline terms (the JAX package's ``launch/dryrun.py`` lowers and compiles
on a TPU mesh instead; there is no XLA here, so this counts rather than
compiles).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --distill
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-medium-14b \
        --shape train_4k --layout dp_heavy_z3 --mesh 2x2

Each record holds ``params``, ``active_params`` and ``model_flops`` by
the JAX package's ``roofline`` formula; the bytes of the bundle's
arguments (parameters, Adam state, batch, caches) and results, and
whether they fit one card's memory (activations are not counted);
``compute_s = model_flops / peak bf16`` and ``memory_s = argument bytes /
HBM bandwidth`` at the H100 SXM's published peaks.  With ``--mesh DxM``
(or ``PxDxM``) the bundle is one rank's (rank 0's blocks, under
``--layout``: JAX's ``tp``, ``dp_heavy`` or ``dp_heavy_z3``), built on a
view of the mesh's shape with no world behind it; the terms stay the
whole step's FLOPs over one card's peak, the bytes that rank's.  There is
no collective term yet (ROADMAP queue 1 item 11.8.7).
Outputs one JSON per pair under ``experiments/dryrun_torch/``.  It needs
no card and allocates nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.common.pytree import tree_leaves
from repro_torch.launch import steps as steps_mod

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
CARD = "NVIDIA H100 SXM 80GB (published peaks)"
NO_COLLECTIVE = ("one device: no collective term yet (ROADMAP queue 1 "
                 "item 11.8.7)")
DISTILL_KW = dict(n_teachers=4, batch_size=128, seq_len=512)


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def roofline(cfg, shape, arg_bytes: int) -> dict:
    """``params``, ``active_params`` and ``model_flops`` as the JAX
    package's ``roofline`` computes them, with compute and memory terms
    at the H100's peaks."""
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    if shape.kind == "distill":
        # K teacher forwards (2ND each) + one student forward+backward
        # (6ND); K = 4 teachers in the dry-run bundle
        mult = 2 * 4 + 6
    else:
        mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * d_tokens
    terms = {"compute_s": model_flops / PEAK_FLOPS_BF16,
             "memory_s": arg_bytes / HBM_BW}
    return {**terms, "collective_s": None, "collective_note": NO_COLLECTIVE,
            "dominant": max(terms, key=terms.get),
            "model_flops": model_flops, "params": n_params,
            "active_params": n_active}


def bundle_bytes(bundle) -> dict:
    """Argument and result bytes of a bundle, the donated arguments'
    bytes, and whether what stays live (arguments + results - donated)
    fits one card."""
    arg = tree_bytes(bundle.args)
    out = tree_bytes(bundle.outs)
    donated = sum(tree_bytes(bundle.args[i]) for i in bundle.donate_argnums)
    live = arg + out - donated
    return {"argument_bytes": arg, "output_bytes": out,
            "donated_bytes": donated, "live_bytes": live,
            "card_bytes": HBM_BYTES, "fits": live <= HBM_BYTES}


class RankView:
    """A mesh's axis sizes by name and rank 0's coordinates, with no
    world behind them: what the step builders read to lay out one rank's
    blocks."""

    def __init__(self, shape):
        names = {2: ("data", "model"), 3: ("pod", "data", "model")}
        if len(shape) not in names:
            raise ValueError(f"a mesh of {len(shape)} axes: give DxM or "
                             f"PxDxM")
        self.mesh_dim_names = names[len(shape)]
        self.shape = dict(zip(self.mesh_dim_names, shape))

    def get_coordinate(self):
        return [0] * len(self.mesh_dim_names)


def make_bundle(arch: str, shape_name: str, distill: bool = False,
                mesh=None, **step_kw):
    """(config, shape, bundle, "") for a pair, or (config, shape, None,
    the skip reason) when the pair does not apply."""
    cfg = configs.get(arch)
    if distill:
        shape = configs.InputShape("distill_fusion", DISTILL_KW["seq_len"],
                                   DISTILL_KW["batch_size"], "distill")
        kw = {k: v for k, v in step_kw.items()
              if k in ("remat", "constrain_acts")}
        return cfg, shape, steps_mod.make_distill_step(cfg, mesh,
                                                       **DISTILL_KW,
                                                       **kw), ""
    shape = configs.get_shape(shape_name)
    ok, reason = configs.applicable(cfg, shape)
    if not ok:
        return cfg, shape, None, reason
    return cfg, shape, steps_mod.make_step(cfg, shape, mesh, **step_kw), ""


def run_one(arch: str, shape_name: str, *, distill: bool = False,
            out_dir: str = "experiments/dryrun_torch",
            variant: str = "baseline", step_kw=None, mesh=None) -> dict:
    """One pair's record; ``mesh`` a mesh shape (one rank's bundle on a
    :class:`RankView` of it) or None (one device)."""
    rec: dict = {"arch": arch, "shape": "distill_fusion" if distill
                 else shape_name, "card": CARD, "variant": variant,
                 "mesh": None if mesh is None else list(mesh),
                 "step_kw": dict(step_kw or {}), "ok": False}
    t0 = time.perf_counter()
    try:
        cfg, shape, bundle, reason = make_bundle(
            arch, shape_name, distill,
            None if mesh is None else RankView(mesh), **(step_kw or {}))
        if bundle is None:
            rec.update(skipped=reason, ok=True)
            return _finish(rec, out_dir, t0)
        if distill:
            rec["distill_kw"] = dict(DISTILL_KW)
        rec["memory"] = bundle_bytes(bundle)
        rec["roofline"] = roofline(cfg, shape,
                                   rec["memory"]["argument_bytes"])
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _finish(rec, out_dir, t0)


def _finish(rec: dict, out_dir: str, t0: float) -> dict:
    rec["total_s"] = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{rec['arch']}__{rec['shape']}__h100__{rec['variant']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=2)
    if "skipped" in rec:
        status = "SKIP: " + rec["skipped"]
    elif rec["ok"]:
        r, m = rec["roofline"], rec["memory"]
        status = (f"OK compute {r['compute_s']:.4g} s memory "
                  f"{r['memory_s']:.4g} s ({r['dominant']}), arguments "
                  f"{m['argument_bytes'] / 1e9:.2f} GB, "
                  f"{'fits' if m['fits'] else 'does not fit'}")
    else:
        status = "FAIL: " + rec.get("error", "?")
    print(f"[dryrun] {rec['arch']} x {rec['shape']} @ h100 -> {status}")
    return rec


def run_all(out_dir: str = "experiments/dryrun_torch", distill=True,
            **kw) -> list:
    """Every assigned (arch, shape) pair, then each arch's distill step."""
    recs = [run_one(a, s, out_dir=out_dir, **kw)
            for a in configs.ASSIGNED for s in configs.SHAPES]
    if distill:
        recs += [run_one(a, "distill_fusion", distill=True, out_dir=out_dir,
                         **kw) for a in configs.ASSIGNED]
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every assigned (arch, shape) pair and every "
                         "arch's distill step")
    ap.add_argument("--distill", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches (train only)")
    ap.add_argument("--naive-xent", action="store_true",
                    help="v0 loss (train only)")
    ap.add_argument("--layout", default="tp",
                    choices=list(steps_mod.LAYOUTS),
                    help="sharding layout preset (common/sharding.py; "
                         "train and prefill)")
    ap.add_argument("--constrain-acts", action="store_true",
                    help="assert batch-sharded activations at every block "
                         "boundary (train, prefill, distill)")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM: one rank's bundle on a mesh of "
                         "that shape (default: one device)")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    mesh = (None if args.mesh is None
            else tuple(int(n) for n in args.mesh.lower().split("x")))
    kw = dict(out_dir=args.out_dir, variant=args.variant, mesh=mesh,
              step_kw={**({"remat": False} if args.no_remat else {}),
                       **({"microbatch": args.microbatch}
                          if args.microbatch > 1 else {}),
                       **({"naive_xent": True} if args.naive_xent else {}),
                       **({"constrain_acts": True}
                          if args.constrain_acts else {}),
                       **({"layout": args.layout}
                          if args.layout != "tp" else {})} or None)
    if args.all:
        recs = run_all(**kw)
    elif not args.arch:
        ap.error("--arch required unless --all")
    elif args.distill:
        recs = [run_one(args.arch, "distill_fusion", distill=True, **kw)]
    elif not args.shape:
        ap.error("--shape required")
    else:
        recs = [run_one(args.arch, args.shape, **kw)]
    return 1 if any(not r["ok"] for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
