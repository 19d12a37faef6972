"""The port's train CLI (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``).

* For a table of argv sets covering every flag group (``feddf-hetero``,
  ``--robust-agg``, step and distill buckets, population and traffic,
  faults, the distributed runtime, the flight recorder,
  ``--distill-batch-sizes``, the unported ``--shard-clients`` and
  ``--driver multihost``), the port's ``spec_from_args`` compiles to the
  JAX CLI's spec JSON, string for string: the spec is the contract.
* Both parsers have the same options, defaults and choices, apart from the
  port's ``--device``.
* ``main`` runs in-process on the CPU (600 samples, 50 distill steps, 2
  rounds): a ``--config`` replay of the dumped spec has the same per-round
  log, a ``--resume`` of the run stopped after round 1 continues it to the
  same log and globals, and the JAX package reads the port's ``spec.json``
  (``ExperimentSpec.load``) and ``global`` checkpoint (``checkpoint.io``).
* Running ``--shard-clients`` or ``--driver multihost`` raises
  ``NotImplementedError`` naming ROADMAP item 11; without ``--device cpu``
  and without a card the CLI raises.
* One subprocess smoke of ``python -m repro_torch.launch.train``.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JSpec
from repro.checkpoint import io as jckpt
from repro.core import mlp as jmlp
from repro.launch import train as jtrain
from repro_torch.checkpoint import io as tckpt
from repro_torch.launch import train as ttrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a quick CPU run: few clients and epochs, 600 samples, 50 distill steps
QUICK = ["--rounds", "2", "--n-samples", "600", "--distill-steps", "50",
         "--clients", "4", "-C", "0.5", "--local-epochs", "1"]

ARGV_TABLE = {
    "defaults": [],
    "quickstart": ["--strategy", "feddf", "--rounds", "2", "--clients",
                   "20", "-C", "0.4", "--alpha", "0.1", "--local-epochs",
                   "20", "--n-samples", "6000", "--distill-steps", "500"],
    "hetero": ["--strategy", "feddf-hetero", "--alpha", "0.1",
               "--bucket-by", "pow2"],
    "hetero_batches": ["--strategy", "feddf-hetero",
                       "--distill-batch-sizes", "32,64,48",
                       "--distill-bucket-by", "quantile",
                       "--distill-max-buckets", "2"],
    "tokens": ["--task", "tokens", "--strategy", "feddf-hetero",
               "--distill-source", "in_domain"],
    "robust": ["--robust-agg", "trimmed_mean", "--trim-frac", "0.3",
               "--faults-byzantine", "0.1", "--faults-nan", "0.02",
               "--faults-crash", "0.05", "--quorum", "0.6"],
    "median": ["--strategy", "fedavg", "--robust-agg", "coordinate_median"],
    "faults": ["--faults-byzantine-scale", "5", "--faults-byzantine-mode",
               "scale", "--faults-bitflip", "0.01", "--screen", "on",
               "--teacher-filter", "off", "--retries", "1", "--backoff",
               "1.5"],
    "buckets": ["--bucket-by", "quantile", "--max-buckets", "3",
                "--bank-dtype", "int8", "--norm", "bn"],
    "population": ["--driver", "buffered_async", "--population-size",
                   "10000", "--sampler", "prioritized", "--buffer-size",
                   "16", "--traffic", "bernoulli", "--traffic-rate", "0.5",
                   "--traffic-latency", "1.0", "--traffic-jitter", "0.2",
                   "--straggler-frac", "0.1", "--straggler-mult", "4",
                   "--traffic-dropout", "0.05", "--max-staleness", "3",
                   "--staleness-exponent", "0.7", "--staleness", "1"],
    "pipelined": ["--driver", "async_pipelined", "--staleness", "2",
                  "--prefetch", "2", "--distill-source", "generator"],
    "dist": ["--driver", "distributed", "--transport", "tcp",
             "--wire-codec", "int8", "--n-pods", "3", "--heartbeat-s", "2",
             "--upload-deadline-s", "10", "--no-verify-crc", "--wire-log",
             "runs/wire.log", "--faults-transport-drop", "0.05",
             "--faults-transport-corrupt", "0.1",
             "--faults-transport-delay", "0.2",
             "--faults-transport-delay-s", "0.5",
             "--faults-transport-disconnect", "0.01"],
    "obs": ["--trace", "runs/spans.jsonl", "--metrics-dir", "runs/m",
            "--profile", "--profile-dir", "runs/p"],
    "ablations": ["--strategy", "fedprox", "--drop-worst", "--binarize",
                  "--target", "0.8", "--seed", "3", "--local-lr", "0.1",
                  "--distill-source", "noise"],
    "unported": ["--shard-clients", "--driver", "multihost"],
}


@pytest.mark.parametrize("name", sorted(ARGV_TABLE))
def test_cli_compiles_to_the_jax_spec_json(name):
    argv = ARGV_TABLE[name]
    want = jtrain.spec_from_args(jtrain.build_parser().parse_args(argv))
    got = ttrain.spec_from_args(ttrain.build_parser().parse_args(argv))
    assert got.to_json() == want.to_json()


def _options(parser):
    """{option strings: (dest, default, sorted choices, nargs, const)}."""
    return {tuple(a.option_strings): (a.dest, a.default,
                                      None if a.choices is None
                                      else sorted(a.choices),
                                      a.nargs, a.const)
            for a in parser._actions if a.option_strings
            and a.dest != "help"}


def test_parsers_have_the_same_options_and_defaults():
    want, got = _options(jtrain.build_parser()), _options(
        ttrain.build_parser())
    assert got.pop(("--device",)) == ("device", "cuda", ["cpu", "cuda"],
                                      None, None)
    assert got == want


def test_distill_batch_sizes_need_one_per_prototype():
    for mod in (jtrain, ttrain):
        args = mod.build_parser().parse_args(["--distill-batch-sizes",
                                              "32,64"])
        with pytest.raises(SystemExit):
            mod.spec_from_args(args)


def _globals(out_dir):
    """The port's final globals of a run directory, restored by the port's
    checkpoint io on the mlp's tree."""
    from repro_torch.core import nets
    like = nets.mlp(2, 3, (64, 64, 64)).init(torch.Generator().manual_seed(0))
    return tckpt.restore(os.path.join(out_dir, "global"), like)


def test_main_replays_resumes_and_writes_what_jax_reads(tmp_path, capsys):
    run, replay, stopped = (tmp_path / n for n in ("run", "replay",
                                                    "stopped"))
    argv = QUICK + ["--device", "cpu"]
    first = ttrain.main(argv + ["--out", str(run), "--dump-config",
                                str(tmp_path / "dumped.json")])
    out = capsys.readouterr()
    assert "[round   2] test=" in out.out
    assert out.err.strip().splitlines()[-1].startswith("kernel launches:")
    assert len(first["per_round"]) == 2 and first["wall_s"] > 0
    # the spec as data: the dump, spec.json, summary["config"] and the JAX
    # CLI's spec for the same flags are one spec
    want = jtrain.spec_from_args(jtrain.build_parser().parse_args(QUICK))
    for path in (tmp_path / "dumped.json", run / "spec.json"):
        assert JSpec.load(str(path)).to_json() == want.to_json()
    assert first["config"] == want.to_dict()
    summary = json.loads((run / "summary.json").read_text())
    assert summary["per_round"] == first["per_round"]

    replayed = ttrain.main(["--config", str(tmp_path / "dumped.json"),
                            "--device", "cpu", "--out", str(replay)])
    assert replayed["per_round"] == first["per_round"]

    # the run stopped after round 1: its snapshots without round 2's
    shutil.copytree(run / "ckpt", stopped / "ckpt")
    shutil.rmtree(stopped / "ckpt" / "rounds" / "00002")
    resumed = ttrain.main(["--resume", str(stopped), "--device", "cpu"])
    assert resumed["per_round"] == first["per_round"]
    assert (stopped / "summary.json").exists()
    a, b = _globals(run), _globals(stopped)
    assert all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])

    # the JAX package reads the port's final globals
    jnet = jmlp(2, 3, (64, 64, 64))
    jg = jckpt.restore(str(run / "global"), jnet.init(jax.random.PRNGKey(0)))
    assert jckpt.metadata(str(run / "global")) == {"net": jnet.name,
                                                   "strategy": "feddf"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        keys = [p.key for p in path]
        np.testing.assert_array_equal(np.asarray(leaf),
                                      a[keys[0]][keys[1]].numpy())


@pytest.mark.parametrize("flags", [["--shard-clients"],
                                   ["--driver", "multihost"]])
def test_unported_axes_raise_not_implemented(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="item 11"):
        ttrain.main(QUICK + flags + ["--device", "cpu", "--out",
                                     str(tmp_path)])


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(QUICK + ["--out", str(tmp_path)])


def test_cli_subprocess_smoke(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", *QUICK, "--rounds", "1", "--checkpoint-every", "0",
         "--out", str(tmp_path / "run")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[round   1] test=" in out.stdout
    assert not (tmp_path / "run" / "ckpt").exists()
    assert json.loads((tmp_path / "run" / "summary.json").read_text())[
        "config"]["rounds"] == 1
