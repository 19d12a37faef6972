"""End-to-end federated training driver (CLI) over the port's declarative
API (the JAX package's ``launch/train.py`` in PyTorch).

CLI flags compile into one serializable :class:`repro_torch.api.
ExperimentSpec`, the same JSON as the JAX package's CLI writes for the
same flags, so every run is reproducible as data:

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --strategy feddf --rounds 20 --clients 20 -C 0.4 --alpha 0.1 \\
        --local-epochs 20 --out runs/feddf \\
        --dump-config runs/feddf/spec.json

    # replay the exact run (identical per-round accuracy log):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --config runs/feddf/spec.json --out runs/replay

    # continue an interrupted run from its per-round checkpoints:
    PYTHONPATH=src python -m repro_torch.launch.train --resume runs/feddf

It runs on the card (``--device cuda``, the default, which raises without
one) unless ``--device cpu`` is given.  Strategies: any name in the
server-strategy registry (``core/strategies.py``) plus ``feddf-hetero``,
which compiles to a feddf run over the task's default three-prototype
ladder (Algorithm 3).  ``--driver`` selects the round driver (``sync``,
``async_pipelined``, ``buffered_async``, ``distributed``).
``--shard-clients`` and ``--driver multihost`` compile into the spec as in
the JAX CLI, and the run raises ``NotImplementedError`` (ROADMAP queue 1
item 11).  The run directory ``--out`` receives the final globals
(``global``, or ``proto_{g}`` per prototype group) through
``checkpoint/io.py`` in the JAX package's layout, ``spec.json`` and
``summary.json``; ``OUT/ckpt`` holds the per-round snapshots that
``--resume`` continues from.  The last line on standard error counts the
port's kernel launches of the run (``kernel launches: {...}``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from repro_torch.api import (BucketSpec, CohortSpec, DistSpec, DriverSpec,
                             Experiment, ExperimentSpec, FaultSpec,
                             FusionSpec, ModelSpec, ObsSpec, PartitionSpec,
                             PopulationSpec, PrivacySpec, ShardingSpec,
                             SourceSpec, StrategySpec, TaskSpec,
                             TrafficSpec, default_prototype_ladder)
from repro_torch.checkpoint import io as ckpt
from repro_torch.common.options import (ARRIVAL_KINDS, BANK_DTYPES,
                                        BUCKET_KINDS, BYZANTINE_MODES,
                                        SCREEN_MODES, TRANSPORT_KINDS)
from repro_torch.core.strategies import available_strategies
from repro_torch.dist.frames import available_codecs
from repro_torch.drivers.base import available_drivers, pending_drivers
from repro_torch.population.scheduler import available_samplers


def spec_from_args(args: argparse.Namespace) -> ExperimentSpec:
    """Compile CLI flags into the canonical experiment spec."""
    hetero = args.strategy == "feddf-hetero"
    strategy_name = "feddf" if hetero else args.strategy
    if args.robust_agg:
        # a robust aggregator overrides the strategy; it is not a new axis
        strategy_name = args.robust_agg

    task = TaskSpec(name=args.task, n_samples=args.n_samples)
    if hetero:
        prototypes = [ModelSpec.from_dict(m)
                      for m in default_prototype_ladder(args.task)]
    elif args.task == "blobs":
        prototypes = [ModelSpec("mlp", {"hidden": [64, 64, 64],
                                        "norm": args.norm})]
    else:
        prototypes = [ModelSpec("tiny_transformer", {})]

    batch_sizes = (None if not args.distill_batch_sizes else
                   [int(b) for b in args.distill_batch_sizes.split(",")])
    if batch_sizes is not None and len(batch_sizes) != len(prototypes):
        raise SystemExit(
            f"--distill-batch-sizes needs one entry per prototype "
            f"({len(prototypes)}), got {len(batch_sizes)}")

    return ExperimentSpec(
        task=task,
        partition=PartitionSpec(n_clients=args.clients, alpha=args.alpha),
        cohort=CohortSpec(prototypes=prototypes),
        strategy=StrategySpec(
            name=strategy_name, drop_worst=args.drop_worst,
            trim_frac=args.trim_frac,
            fusion=FusionSpec(
                max_steps=args.distill_steps,
                patience=max(args.distill_steps // 5, 100),
                eval_every=100, batch_size=64,
                bank_dtype=args.bank_dtype,
                batch_sizes=batch_sizes,
                distill_bucket=args.distill_bucket_by,
                distill_max_buckets=args.distill_max_buckets)),
        source=SourceSpec(name=args.distill_source),
        privacy=PrivacySpec(quantizer="binarize" if args.binarize else None),
        sharding=ShardingSpec(shard_clients=args.shard_clients),
        driver=DriverSpec(kind=args.driver, staleness=args.staleness,
                          prefetch=args.prefetch),
        bucket=BucketSpec(kind=args.bucket_by,
                          max_buckets=args.max_buckets),
        population=PopulationSpec(
            size=args.population_size, sampler=args.sampler,
            buffer_size=args.buffer_size,
            max_staleness=args.max_staleness,
            staleness_exponent=args.staleness_exponent,
            traffic=TrafficSpec(
                arrival=args.traffic, rate=args.traffic_rate,
                latency=args.traffic_latency, jitter=args.traffic_jitter,
                straggler_frac=args.straggler_frac,
                straggler_mult=args.straggler_mult,
                dropout=args.traffic_dropout)),
        faults=FaultSpec(
            nan_rate=args.faults_nan,
            byzantine_frac=args.faults_byzantine,
            byzantine_scale=args.faults_byzantine_scale,
            byzantine_mode=args.faults_byzantine_mode,
            bitflip_rate=args.faults_bitflip,
            crash_rate=args.faults_crash,
            screen=args.screen, teacher_filter=args.teacher_filter,
            quorum=args.quorum, retries=args.retries,
            backoff=args.backoff,
            transport_drop=args.faults_transport_drop,
            transport_corrupt=args.faults_transport_corrupt,
            transport_delay=args.faults_transport_delay,
            transport_delay_s=args.faults_transport_delay_s,
            transport_disconnect=args.faults_transport_disconnect),
        dist=DistSpec(
            transport=args.transport, wire_codec=args.wire_codec,
            n_pods=args.n_pods, heartbeat_s=args.heartbeat_s,
            upload_deadline_s=args.upload_deadline_s,
            verify_crc=not args.no_verify_crc,
            wire_log=args.wire_log),
        obs=ObsSpec(
            trace=bool(args.trace or args.profile),
            trace_path=args.trace or None,
            metrics_dir=args.metrics_dir or None,
            profile=bool(args.profile),
            profile_dir=args.profile_dir or None),
        rounds=args.rounds, client_fraction=args.fraction,
        local_epochs=args.local_epochs, local_lr=args.local_lr,
        target_accuracy=args.target, seed=args.seed)


def kernel_launches() -> dict:
    """The port's kernel launch counts in this process (all 0 on the
    CPU, where the plain versions run)."""
    from repro_torch.kernels import (ensemble_kl, ensemble_kl_bank,
                                     ssd_scan, swa_attn)
    out = {}
    for mod in (ensemble_kl_bank, ensemble_kl, swa_attn, ssd_scan):
        out.update(mod.LAUNCHES)
    return out


def print_event(event) -> None:
    l = event.log
    if event.heterogeneous:
        print(f"[round {l.round:3d}] proto{event.group} "
              f"test={l.test_acc:.4f} ens={l.ensemble_acc:.4f}")
    else:
        print(f"[round {l.round:3d}] test={l.test_acc:.4f} "
              f"val={l.val_acc:.4f} distill_steps={l.distill_steps} "
              f"dropped={l.n_dropped}")


def build_parser() -> argparse.ArgumentParser:
    """The full CLI surface, separate from :func:`main` so tests can pin
    the flag -> spec -> JSON round trip without running anything.  The
    options, their names and defaults are the JAX CLI's, plus
    ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run executes: cuda (the default; "
                         "raises without a CUDA device) or cpu")
    ap.add_argument("--config", default=None, metavar="SPEC_JSON",
                    help="load the full experiment spec from a JSON file "
                         "(all other experiment flags are ignored)")
    ap.add_argument("--dump-config", default=None, metavar="SPEC_JSON",
                    help="write the compiled spec to this path, then run")
    ap.add_argument("--resume", default=None, metavar="RUN_DIR",
                    help="continue a checkpointed run from RUN_DIR "
                         "(ignores the other experiment flags)")
    ap.add_argument("--strategy", default="feddf",
                    choices=available_strategies() + ["feddf-hetero"])
    ap.add_argument("--task", default="blobs", choices=["blobs", "tokens"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("-C", "--fraction", type=float, default=0.4)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--local-epochs", type=int, default=20)
    ap.add_argument("--local-lr", type=float, default=0.05)
    ap.add_argument("--n-samples", type=int, default=6000)
    ap.add_argument("--distill-source", default="unlabeled",
                    choices=["unlabeled", "in_domain", "generator", "noise"])
    ap.add_argument("--distill-steps", type=int, default=1000)
    ap.add_argument("--norm", default="none", choices=["none", "bn", "gn"])
    ap.add_argument("--drop-worst", action="store_true")
    ap.add_argument("--binarize", action="store_true")
    ap.add_argument("--target", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/latest")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="write resumable per-round checkpoints every N "
                         "rounds under OUT/ckpt (0 disables)")
    ap.add_argument("--shard-clients", action="store_true",
                    help="shard the round engine's client axis over all "
                         "devices (not ported: the run raises)")
    ap.add_argument("--driver", default="sync",
                    choices=sorted(available_drivers() + pending_drivers()),
                    help="round driver: sync | async_pipelined (overlap "
                         "round t+1 client training with round t fusion) "
                         "| buffered_async | distributed | multihost (not "
                         "ported: the run raises)")
    ap.add_argument("--bucket-by", default="none",
                    choices=["none", "pow2", "quantile"],
                    help="bucket clients by local-step count so skewed "
                         "cohorts stop running padded no-op steps; "
                         "trajectories are identical to --bucket-by none")
    ap.add_argument("--max-buckets", type=int, default=4,
                    help="cap on step buckets per prototype")
    ap.add_argument("--bank-dtype", default="float32",
                    choices=list(BANK_DTYPES),
                    help="teacher-logit-bank storage dtype: float32 keeps "
                         "bank trajectories identical; int8/fp8_e4m3 "
                         "shrink the bank ~4x with per-row scales "
                         "dequantized inside the fused kernel")
    ap.add_argument("--distill-batch-sizes", default=None,
                    metavar="B0,B1,...",
                    help="per-prototype distillation batch sizes "
                         "(heterogeneous fusion; one entry per prototype, "
                         "default: uniform)")
    ap.add_argument("--distill-bucket-by", default="none",
                    choices=list(BUCKET_KINDS),
                    help="bucket the per-prototype distill batch sizes "
                         "into padded capacities: none pads every group to "
                         "the largest size; pow2/quantile give small "
                         "students intermediate capacities")
    ap.add_argument("--distill-max-buckets", type=int, default=4,
                    help="cap on distill batch-size buckets")
    ap.add_argument("--staleness", type=int, default=0,
                    help="async_pipelined: 0 = exact sync semantics, S >= "
                         "1 = up to S rounds of training overlap the "
                         "oldest fusion; buffered_async: 1 overlaps wave "
                         "training with the previous fusion")
    ap.add_argument("--prefetch", type=int, default=1,
                    help="rounds of host-side batch building prefetched "
                         "ahead by the async driver")
    ap.add_argument("--traffic", default="always",
                    choices=list(ARRIVAL_KINDS),
                    help="client arrival model: always = every client "
                         "reachable every wave; bernoulli = online with "
                         "prob --traffic-rate")
    ap.add_argument("--traffic-rate", type=float, default=1.0,
                    help="bernoulli arrival probability per wave")
    ap.add_argument("--traffic-latency", type=float, default=0.0,
                    help="mean virtual upload latency (0 = instantaneous, "
                         "the degenerate sync-equivalent setting)")
    ap.add_argument("--traffic-jitter", type=float, default=0.0,
                    help="lognormal sigma of per-client speed and "
                         "per-upload latency noise")
    ap.add_argument("--straggler-frac", type=float, default=0.0,
                    help="fraction of persistently slow clients")
    ap.add_argument("--straggler-mult", type=float, default=8.0,
                    help="straggler latency multiplier")
    ap.add_argument("--traffic-dropout", type=float, default=0.0,
                    help="per-upload loss probability")
    ap.add_argument("--population-size", type=int, default=None,
                    help="registered client population size (default: the "
                         "partition roster; larger populations map onto "
                         "data partitions round-robin)")
    ap.add_argument("--sampler", default="uniform",
                    choices=available_samplers(),
                    help="cohort sampler: uniform | capacity_aware | "
                         "prioritized")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="buffered_async: aggregate every M buffered "
                         "uploads (default: the active cohort size K)")
    ap.add_argument("--max-staleness", type=int, default=4,
                    help="buffered_async: uploads more than this many "
                         "fusions old are dropped instead of fused")
    ap.add_argument("--staleness-exponent", type=float, default=0.5,
                    help="FedAsync importance (1+s)^-a exponent applied "
                         "to stale uploads at fusion")
    ap.add_argument("--faults-nan", type=float, default=0.0,
                    help="fault injection: per-upload probability of "
                         "NaN/Inf poisoning")
    ap.add_argument("--faults-byzantine", type=float, default=0.0,
                    help="fraction of persistently byzantine clients "
                         "(sign-flipped / scaled deltas, static draw)")
    ap.add_argument("--faults-byzantine-scale", type=float, default=10.0,
                    help="byzantine delta amplification factor")
    ap.add_argument("--faults-byzantine-mode", default="sign_flip",
                    choices=list(BYZANTINE_MODES),
                    help="byzantine payload: sign_flip sends the negated "
                         "scaled delta, scale sends it amplified")
    ap.add_argument("--faults-bitflip", type=float, default=0.0,
                    help="per-upload probability of payload bit flips")
    ap.add_argument("--faults-crash", type=float, default=0.0,
                    help="per-upload probability of a mid-round client "
                         "crash (partial upload: trailing delta zeroed)")
    ap.add_argument("--screen", default="auto",
                    choices=list(SCREEN_MODES),
                    help="upload screening (finite-ness + delta-norm "
                         "quarantine): auto = active iff any fault rate "
                         "is positive")
    ap.add_argument("--teacher-filter", default="auto",
                    choices=list(SCREEN_MODES),
                    help="FedDF teacher-consensus filter: drop non-finite "
                         "/ divergent teachers before distillation")
    ap.add_argument("--quorum", type=float, default=None,
                    help="minimum usable-upload fraction to fuse a round; "
                         "below it the round skips fusion (globals carry "
                         "over)")
    ap.add_argument("--retries", type=int, default=2,
                    help="re-dispatch attempts for quarantined uploads "
                         "before the client is written off for the round")
    ap.add_argument("--backoff", type=float, default=2.0,
                    help="exponential retry backoff base (virtual "
                         "seconds, buffered_async)")
    ap.add_argument("--trace", default=None, metavar="SPANS_JSONL",
                    help="arm the flight recorder and append phase spans "
                         "to this JSONL file; the summary gains an 'obs' "
                         "per-round phase breakdown")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="stream per-round metrics records to "
                         "DIR/metrics.jsonl + DIR/metrics.csv")
    ap.add_argument("--profile", action="store_true",
                    help="trace the run with torch.profiler, one record "
                         "function per span; writes to --profile-dir "
                         "(default OUT/profile)")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="profiler trace directory")
    ap.add_argument("--robust-agg", default=None,
                    choices=["trimmed_mean", "coordinate_median"],
                    help="override --strategy with a robust aggregator")
    ap.add_argument("--trim-frac", type=float, default=0.2,
                    help="trimmed_mean: fraction of client updates "
                         "trimmed from each end per coordinate")
    ap.add_argument("--transport", default="loopback",
                    choices=list(TRANSPORT_KINDS),
                    help="--driver distributed: loopback (pods are "
                         "threads) or tcp (one subprocess per pod on "
                         "localhost)")
    ap.add_argument("--wire-codec", default="fp32",
                    choices=available_codecs(),
                    help="payload codec for client uploads on the wire: "
                         "fp32 is exact (bit-identical to sync), "
                         "binarize/int8 cut bytes-on-wire ~32x/~4x")
    ap.add_argument("--n-pods", type=int, default=2,
                    help="client pods; client k homes on pod k %% n_pods")
    ap.add_argument("--heartbeat-s", type=float, default=5.0,
                    help="pod heartbeat period; a pod is presumed dead "
                         "after 3 missed beats and its clients re-route")
    ap.add_argument("--upload-deadline-s", type=float, default=30.0,
                    help="per-dispatch TRAIN->UPLOAD deadline before the "
                         "fusion pod re-dispatches")
    ap.add_argument("--no-verify-crc", action="store_true",
                    help="UNDEFENDED ablation: accept frames without "
                         "checking the CRC (corruption lands in params)")
    ap.add_argument("--wire-log", default=None, metavar="PATH",
                    help="append accepted UPLOAD frames to this crash-"
                         "safe record log; a restarted fusion pod "
                         "replays it")
    ap.add_argument("--faults-transport-drop", type=float, default=0.0,
                    help="P(UPLOAD frame silently lost in flight)")
    ap.add_argument("--faults-transport-corrupt", type=float, default=0.0,
                    help="P(UPLOAD frame bytes flipped in flight, caught "
                         "by the CRC unless --no-verify-crc)")
    ap.add_argument("--faults-transport-delay", type=float, default=0.0,
                    help="P(UPLOAD frame delivery delayed)")
    ap.add_argument("--faults-transport-delay-s", type=float, default=0.25,
                    help="delay duration for delayed frames (wall "
                         "seconds)")
    ap.add_argument("--faults-transport-disconnect", type=float,
                    default=0.0,
                    help="P(pod link goes dark for the rest of the round)")
    return ap


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.profile and not args.profile_dir:
        args.profile_dir = os.path.join(args.out, "profile")

    t0 = time.time()
    if args.resume:
        out = args.out if args.out != "runs/latest" else args.resume
        res = Experiment.resume(os.path.join(args.resume, "ckpt"),
                                device=args.device, observers=[print_event],
                                checkpoint_every=args.checkpoint_every)
        spec = res.spec
    else:
        spec = (ExperimentSpec.load(args.config) if args.config
                else spec_from_args(args))
        if args.dump_config:
            os.makedirs(os.path.dirname(args.dump_config) or ".",
                        exist_ok=True)
            spec.save(args.dump_config)
        out = args.out
        ckpt_dir = (os.path.join(out, "ckpt")
                    if args.checkpoint_every > 0 else None)
        res = Experiment(spec, device=args.device).run(
            observers=[print_event], checkpoint_dir=ckpt_dir,
            checkpoint_every=args.checkpoint_every)

    os.makedirs(out, exist_ok=True)
    summary = res.summary()
    if res.heterogeneous:
        for g, params in enumerate(res.global_params):
            ckpt.save(os.path.join(out, f"proto_{g}"), params,
                      {"arch": res.net_names[g]})
    else:
        ckpt.save(os.path.join(out, "global"), res.global_params[0],
                  {"net": res.net_names[0],
                   "strategy": spec.strategy.name})

    summary["wall_s"] = time.time() - t0
    # the spec is the config: replay any run dir with
    #   python -m repro_torch.launch.train --config <out>/spec.json
    summary["config"] = spec.to_dict()
    spec.save(os.path.join(out, "spec.json"))
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("per_round", "config")}, indent=2))
    print(f"kernel launches: {json.dumps(kernel_launches())}",
          file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
