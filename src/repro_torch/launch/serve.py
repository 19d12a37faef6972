"""Serving driver: batched autoregressive decoding on the card (the JAX
package's ``launch/serve.py`` in PyTorch).

Initialise the parameters (fp32), draw the prompts (and, for a vision
model, the patch embeddings prepended to them), prefill them with caches
sized ``patches + prompt + gen``, take the first token by argmax, then run
``gen - 1`` one-token decode steps, each sampling one token.  An
encoder-only model (``frontend == "audio_frames"``: hubert) has no decode
step and is refused, as the JAX serve refuses it; run it through
``models.transformer.forward``.  The prefill runs the port's kernels (K4
attention, K5 SSD scan) on the card; decode is plain PyTorch, as the JAX
package's decode runs no Pallas kernel.

    python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --batch 4 --prompt-len 2000 --gen 32

(also ``--arch granite-moe-1b-a400m`` or ``internvl2-1b``, the latter with
256 random patch embeddings ahead of each prompt).

It runs on ``cuda`` and raises without a card unless ``--device cpu`` is
given.  :func:`serve` takes injected parameters, prompts and forced decode
inputs, so tests can hold it against the JAX package (whose ``jax.random``
init, prompts and sampling PyTorch cannot reproduce); sampling draws from
an explicit CPU ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch import configs
from repro_torch.api.experiment import resolve_device
from repro_torch.common.arch_config import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.frontends import fake_vision_patches

ENCODER_ONLY = ("encoder-only architecture (audio frames in): no decode "
                "step; run models.transformer.forward")


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor              # [B, gen] int64 on the CPU
    prefill_logits: torch.Tensor      # [B, V] float32: the prompt's last
    step_logits: List[torch.Tensor]   # gen - 1 tensors [B, V] float32
    prefill_s: float                  # wall seconds (device synchronised)
    decode_s: float

    @property
    def decode_tokens_per_s(self) -> float:
        b = self.tokens.shape[0]
        return b * len(self.step_logits) / max(self.decode_s, 1e-9)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` [B, V] by Gumbel-max, the
    uniform draws from ``generator`` on the CPU.  Returns [B, 1] int64."""
    u = torch.rand(logits.shape, generator=generator).clamp_(
        min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + gumbel.to(logits.device), dim=-1,
                        keepdim=True)


def serve(cfg: ArchConfig, params: dict, prompts: torch.Tensor, gen: int, *,
          device="cuda", generator: Optional[torch.Generator] = None,
          temperature: float = 1.0,
          forced_tokens: Optional[torch.Tensor] = None,
          patches: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` [B, S] and generate ``gen`` tokens.

    ``forced_tokens`` [B, gen - 1], when given, is fed to the decode steps
    in place of the previous token (teacher forcing); the tokens drawn are
    still reported.  A ``vision_patches`` model takes ``patches`` [B,
    n_frontend_tokens, d_model], prepended to the prompt in the prefill;
    decode then starts at position ``n_frontend_tokens + S``."""
    device = resolve_device(device)
    if cfg.frontend == "audio_frames":
        raise ValueError(f"{cfg.name}: {ENCODER_ONLY}")
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    n_front = 0
    batch = {}
    if cfg.frontend == "vision_patches":
        n_front = cfg.n_frontend_tokens
        want = (prompts.shape[0], n_front, cfg.d_model)
        got = None if patches is None else tuple(patches.shape)
        if got != want:
            raise ValueError(f"{cfg.name} takes patches {list(want)}, got "
                             f"{got}")
        batch["patches"] = patches.to(device)
    elif patches is not None:
        raise ValueError(f"{cfg.name} has no vision frontend: no patches")
    generator = generator or torch.Generator().manual_seed(0)
    prompts = prompts.to(device)
    b, s = prompts.shape
    if forced_tokens is not None and tuple(forced_tokens.shape) != (b,
                                                                    gen - 1):
        raise ValueError(f"forced_tokens must be [{b}, {gen - 1}], got "
                         f"{tuple(forced_tokens.shape)}")
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = T.prefill(params, cfg, {**batch, "tokens": prompts},
                                   max_seq=n_front + s + gen,
                                   last_only=True)
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits[:, -1].float().cpu()
        generated, step_logits = [tok.cpu()], []
        t0 = time.perf_counter()
        for i in range(gen - 1):
            if forced_tokens is not None:
                tok = forced_tokens[:, i: i + 1].to(device)
            lg, caches = T.decode_step(params, cfg, {"tokens": tok}, caches,
                                       n_front + s + i)
            lg = lg[:, -1]
            step_logits.append(lg.float().cpu())
            if temperature != 1.0:
                lg = lg / temperature
            tok = _sample(lg, generator)
            generated.append(tok.cpu())
        _sync(device)
        decode_s = time.perf_counter() - t0
    return ServeResult(torch.cat(generated, dim=1), prefill_logits,
                       step_logits, prefill_s, decode_s)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="feddf-paper")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if cfg.frontend == "audio_frames":
        raise SystemExit(f"{cfg.name}: {ENCODER_ONLY}")
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    params = T.init(cfg, gen, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen)
    patches = (fake_vision_patches(gen, cfg, args.batch)
               if cfg.frontend == "vision_patches" else None)
    print(f"init {cfg.name} on {device} in {time.perf_counter() - t0:.2f}s")
    res = serve(cfg, params, prompts, args.gen, device=device, generator=gen,
                temperature=args.temperature, patches=patches)
    b, s = prompts.shape
    print(f"prefill [{b}x{s}] in {res.prefill_s:.2f}s")
    print(f"generated [{b}x{args.gen}] in {res.decode_s:.2f}s "
          f"({res.decode_tokens_per_s:.1f} tok/s)")
    for row in res.tokens[: min(b, 4)]:
        print("  tokens:", row.tolist())
    return res


if __name__ == "__main__":
    main()
