#!/usr/bin/env python3
"""How well conditioned chip_smoke.py's path-13 models are under the model
zoo's random init, on the card.

    python3 chip_probe_conditioning.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
The init (``ParamSpec.materialise``, as the JAX package draws it) takes a
stacked weight's fan-in from its repeat axis, so a deep model's weights
are ~7x wider than a well-scaled init, and a 2-layer init's wider still.
It prints, for granite-moe-1b-a400m served from seed 0 and its first
1, 2, 4, 8, 12, 16 and all 24 layers (capacity factor E / k, no slot
dropped): check (a) of path 13a (forward of 2002 tokens against prefill
of 2000 + 2 forced decode steps, batch 1) beside the model's own
sensitivity, the same forward with every weight moved by about one unit
in the last place (the largest logit change over all positions and over
the last two); the same check on the CPU at 2 and 4 layers (a 300-token
prompt); and, for hubert-xlarge, 2 layers card against CPU on 256 frames
with a 2-layer init and with the full model's first 2 layers, beside the
CPU's and the card's own 1-ulp spread.  Details go to
``chiprun_out/chip_probe_conditioning.json``.  It exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEPTHS = (1, 2, 4, 8, 12, 16, 24)
CPU_DEPTHS, CPU_PROMPT = (2, 4), 300


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_probe_conditioning: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import fake_audio_frames
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    out = {"card": card, "granite": [], "granite_cpu": [], "hubert": []}

    def spread(p, c, batch, seed):
        """Largest logit change over all positions and the last two when
        every weight moves by about 1 ulp."""
        with torch.no_grad():
            f0 = T.forward(p, c, batch)
            f1 = T.forward(cs.ulp_nudged(p, seed), c, batch)
        d = (f1 - f0).abs()
        return float(d.max()), float(d[:, -2:].max())

    cfg = configs.get("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, cs.SERVE_PROMPT + 2),
                         generator=torch.Generator().manual_seed(0))
    for n in DEPTHS:
        c, p = cs.served_layers(params, cfg, n)
        rec = {"layers": n, "check_a": cs.full_depth_check(p, c, toks, {},
                                                           1)}
        rec["ulp_spread_all"], rec["ulp_spread_last2"] = spread(
            p, c, {"tokens": toks.to(dev)}, 5)
        print(f"granite-moe {n} layers: {rec}", flush=True)
        out["granite"].append(rec)
    for n in CPU_DEPTHS:
        c, p = cs.served_layers(params, cfg, n)
        p = tree_map(lambda x: x.cpu(), p)
        t = toks[:, :CPU_PROMPT + 2]
        with torch.no_grad():
            full = T.forward(p, c, {"tokens": t})
            pre, caches = T.prefill(p, c, {"tokens": t[:, :CPU_PROMPT]},
                                    max_seq=CPU_PROMPT + 2)
            errs = []
            for i in range(2):
                d, caches = T.decode_step(
                    p, c, {"tokens": t[:, CPU_PROMPT + i: CPU_PROMPT + i
                                       + 1]}, caches, CPU_PROMPT + i)
                errs.append(float((d[:, 0] - full[:, CPU_PROMPT + i])
                                  .abs().max()))
        rec = {"layers": n, "prompt": CPU_PROMPT, "decode_err": errs,
               "prefill_err": float((pre - full[:, :CPU_PROMPT]).abs()
                                    .max()),
               "max_abs_logit": float(full.abs().max())}
        rec["ulp_spread_all"], rec["ulp_spread_last2"] = spread(
            p, c, {"tokens": t}, 6)
        print(f"granite-moe on the CPU, {n} layers: {rec}", flush=True)
        out["granite_cpu"].append(rec)
    del params
    torch.cuda.empty_cache()

    cfg = configs.get("hubert-xlarge")
    frames = fake_audio_frames(torch.Generator(device=dev).manual_seed(0),
                               cfg, 1, cs.GQA_CPU_PROMPT, device=dev)
    full_p = T.init(cfg, torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    small = dataclasses.replace(cfg, n_layers=cs.GQA_CPU_LAYERS)
    for what, p in (
            ("2-layer init", T.init(small, torch.Generator(
                device=dev).manual_seed(1), device=dev)),
            ("the full model's first 2 layers",
             cs.served_layers(full_p, cfg, cs.GQA_CPU_LAYERS)[1])):
        pc = tree_map(lambda x: x.cpu(), p)
        with torch.no_grad():
            g = T.forward(p, small, {"frames": frames}).cpu()
            c0 = T.forward(pc, small, {"frames": frames.cpu()})
        rec = {"weights": what, "wq_std": float(
                   p["blocks"][0]["mixer"]["wq"].std()),
               "max_abs_logit": float(c0.abs().max()),
               "card_vs_cpu": float((g - c0).abs().max()),
               "cpu_ulp_spread": spread(pc, small,
                                        {"frames": frames.cpu()}, 7)[0],
               "card_ulp_spread": spread(p, small, {"frames": frames},
                                         7)[0]}
        print(f"hubert-xlarge, {what}: {rec}", flush=True)
        out["hubert"].append(rec)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_probe_conditioning.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
