"""Quickstart: FedDF vs FedAvg through the port's experiment API, on the
card.

20 non-iid clients (Dirichlet alpha=0.1), a 3-class toy task (the
paper's Fig. 1 setting), server-side ensemble distillation on an
out-of-domain unlabeled pool: ``examples/quickstart.py``'s spec, the same
JSON for both packages.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu \\
        --rounds 2 --samples 600

``--checkpoint-dir DIR`` snapshots every round of each strategy's run
under ``DIR/<strategy>``; ``--resume`` continues those runs from their
newest snapshots instead of starting anew.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

from repro_torch.api import (CohortSpec, Experiment, ExperimentSpec,
                             FusionSpec, ModelSpec, PartitionSpec,
                             SourceSpec, StrategySpec, TaskSpec)


def quickstart_spec(rounds: int = 10, samples: int = 6000) -> ExperimentSpec:
    return ExperimentSpec(
        # 3-class Gaussian blobs, heavily non-iid across 20 clients
        task=TaskSpec(name="blobs", n_samples=samples),
        partition=PartitionSpec(n_clients=20, alpha=0.1),
        # the paper's 3-layer MLP
        cohort=CohortSpec(prototypes=[ModelSpec("mlp",
                                                {"hidden": [64, 64, 64]})]),
        strategy=StrategySpec(name="feddf",
                              fusion=FusionSpec(max_steps=500, patience=250,
                                                eval_every=50,
                                                batch_size=64)),
        # unlabeled distillation data from another domain (uniform square)
        source=SourceSpec(name="unlabeled", params={"n": 4000}),
        rounds=rounds, client_fraction=0.4, local_epochs=20,
        local_batch_size=32, local_lr=0.05, seed=0)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--samples", type=int, default=6000)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot every round under DIR/<strategy>")
    ap.add_argument("--resume", action="store_true",
                    help="continue the runs under --checkpoint-dir")
    args = ap.parse_args(argv)
    if args.resume and args.checkpoint_dir is None:
        ap.error("--resume needs --checkpoint-dir")

    spec = quickstart_spec(args.rounds, args.samples)
    print(spec.to_json())  # the run, as data
    out = {}
    for strategy in ("fedavg", "feddf"):
        ckpt = (None if args.checkpoint_dir is None
                else os.path.join(args.checkpoint_dir, strategy))
        if args.resume:
            res = Experiment.resume(ckpt, device=args.device)
        else:
            s = dataclasses.replace(
                spec,
                strategy=dataclasses.replace(spec.strategy, name=strategy),
                source=spec.source if strategy == "feddf" else None)
            res = Experiment(s, device=args.device).run(checkpoint_dir=ckpt)
        curve = " ".join(f"{l.test_acc:.3f}" for l in res.result.logs)
        print(f"{strategy:7s} best={res.best_acc:.3f}  per-round: {curve}")
        out[strategy] = res
    return out


if __name__ == "__main__":
    main()
