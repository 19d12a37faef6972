"""The port's analytic dry run (``repro_torch.launch.dryrun``) against the
JAX package's step builders and roofline formula, for every assigned
(architecture, input shape) pair and every architecture's distill step.

``params``, ``active_params`` and ``model_flops`` must equal what JAX's
``roofline`` computes for the pair, and the bytes of the port's bundle
arguments the bytes of JAX's bundle ``args`` (its ``ShapeDtypeStruct``
trees, built on a 1 x 1 CPU mesh).  JAX's ``launch/dryrun.py`` sets
``XLA_FLAGS`` to 512 host devices when it is imported: the devices are
initialised first and the variable restored after, so no other test in
the worker sees 512 devices.
"""
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jdry():
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


def _jax_arg_bytes(bundle) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(bundle.args))


def test_dryrun_matches_jax_roofline_and_argument_bytes(jdry, tmp_path):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    stub = types.SimpleNamespace(devices=np.zeros(1))
    recs = dryrun.run_all(out_dir=str(tmp_path))
    by_pair = {(r["arch"], r["shape"]): r for r in recs}
    assert len(by_pair) == len(configs.ASSIGNED) * (len(configs.SHAPES) + 1)
    for arch in jconfigs.ASSIGNED:
        cfg = jconfigs.get(arch)
        for name in list(jconfigs.SHAPES) + ["distill_fusion"]:
            rec = by_pair[(arch, name)]
            assert rec["ok"], rec.get("error")
            if name == "distill_fusion":
                shape = jconfigs.InputShape(name, 512, 128, "distill")
                bundle = jsteps.make_distill_step(cfg, mesh)
            else:
                shape = jconfigs.get_shape(name)
                ok, reason = jconfigs.applicable(cfg, shape)
                if not ok:
                    assert rec["skipped"] == reason
                    continue
                bundle = jsteps.make_step(cfg, shape, mesh)
            want = jdry.roofline(cfg, shape, stub, {}, 0.0)
            for k in ("params", "active_params", "model_flops"):
                assert rec["roofline"][k] == want[k], (arch, name, k)
            assert rec["memory"]["argument_bytes"] == \
                _jax_arg_bytes(bundle), (arch, name)
            assert rec["roofline"]["collective_s"] is None
            assert rec["roofline"]["compute_s"] == \
                rec["roofline"]["model_flops"] / dryrun.PEAK_FLOPS_BF16
    assert len(os.listdir(tmp_path)) == len(recs)


def test_dryrun_cli_writes_one_record_and_sets_no_environment(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    code = ("import os, sys; from repro_torch.launch import dryrun; "
            "assert 'XLA_FLAGS' not in os.environ; "
            "sys.exit(dryrun.main(sys.argv[1:]))")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "zamba2-1.2b", "--shape",
         "train_4k", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    files = os.listdir(tmp_path)
    assert files == ["zamba2-1.2b__train_4k__h100__baseline.json"]
    assert "fits" in out.stdout
