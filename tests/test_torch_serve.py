"""The port's third slice as a whole: zamba2-1.2b serving (prefill +
decode), the config registry, and parameter trees with tuples.

* The config registry equals the JAX package's, field for field.
* ``reduced(zamba2-1.2b, n_layers=10)`` (one pattern repeat of 6 mamba +
  the shared attention block, then a 3-mamba tail) with the JAX package's
  init converted: ``prefill`` plus 2 teacher-forced ``decode_step``s, and
  :func:`serve` with forced tokens, against JAX's ``T.prefill`` /
  ``T.decode_step`` on the same tokens.  Tolerance: rtol 2e-3 (as
  ``tests/test_decode.py``) plus an absolute 1e-3 * max|logit|.  The
  absolute part is wider than test_decode's 2e-4 because that test
  compares one framework with itself: this init is ill-conditioned
  (stacked block weights take their fan-in from the repeat axis, so dt *
  A reaches ~1e3 per step), and JAX's ``ssd_chunked`` takes the
  within-chunk decay exponents as differences of cumulative sums, which
  lose ~eps * |cumsum|; the port sums the segments directly.
* Within the port, ``prefill`` + ``decode_step`` reproduce ``forward`` to
  test_decode's own tolerances (prefill rtol 2e-3 / atol 2e-4, decode
  2e-3), for every reduced config the port runs.
* The CLI runs on the CPU when asked, and raises without a card otherwise.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.common.arch_config import reduced as jreduced
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.common.pytree import tree_flatten
from repro_torch.convert import to_numpy, to_torch
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_RTOL, CROSS_ATOL_REL = 2e-3, 1e-3
PREFILL_RTOL, PREFILL_ATOL, DECODE_ATOL = 2e-3, 2e-4, 2e-3


def _cross_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=CROSS_RTOL,
                               atol=CROSS_ATOL_REL * np.abs(want).max())


def _zamba(n_layers=10):
    cfg_j = jreduced(jconfigs.get("zamba2-1.2b"), n_layers=n_layers)
    cfg_t = reduced(configs.get("zamba2-1.2b"), n_layers=n_layers)
    pj = JT.init(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, pj, to_torch(jax.tree.map(np.asarray, pj))


def test_config_registry_matches_jax():
    assert sorted(configs.REGISTRY) == sorted(jconfigs.REGISTRY)
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    for name in jconfigs.REGISTRY:
        for n in (name, name + "-smoke"):
            assert dataclasses.asdict(configs.get(n)) == \
                dataclasses.asdict(jconfigs.get(n)), n
            assert configs.get(n).param_count() == \
                jconfigs.get(n).param_count()
        for shape in jconfigs.SHAPES:
            assert configs.applicable(configs.get(name),
                                      configs.get_shape(shape)) == \
                jconfigs.applicable(jconfigs.get(name),
                                    jconfigs.get_shape(shape))
    assert dataclasses.asdict(reduced(configs.get("zamba2-1.2b"),
                                      n_layers=10)) == \
        dataclasses.asdict(jreduced(jconfigs.get("zamba2-1.2b"),
                                    n_layers=10))
    with pytest.raises(KeyError):
        configs.get("nope")


def test_zamba_tree_round_trips_through_convert():
    cfg_j, _, pj, pt = _zamba()
    assert isinstance(pt["blocks"], tuple) and len(pt["blocks"]) == 7
    assert pt["blocks"][6] == {} and isinstance(pt["tail"], tuple)
    back = to_numpy(pt)
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                               pj))[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
    for (_, got), (_, want) in zip(flat_b, flat_j):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert jax.tree.structure(back) == jax.tree.structure(pj)
    assert "blocks/0/mixer/wz" in tree_flatten(pt)


def test_zamba_prefill_and_decode_match_jax():
    cfg_j, cfg_t, pj, pt = _zamba()
    b, s = 2, 40
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (b, s + 2))
    lj, cj = JT.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks[:, :s])},
                        max_seq=s + 4)
    lt, ct = T.prefill(pt, cfg_t, {"tokens": torch.from_numpy(toks[:, :s])},
                       max_seq=s + 4)
    _cross_close(lt, lj)
    # the caches K4 and K5's plain versions filled
    _cross_close(ct["blocks"][6].k, cj["blocks"][6].k)
    np.testing.assert_allclose(ct["blocks"][0].conv, cj["blocks"][0].conv,
                               rtol=1e-4, atol=1e-4)
    for i in range(2):
        dj, cj = JT.decode_step(pj, cfg_j,
                                {"tokens": jnp.asarray(toks[:, s + i:
                                                            s + i + 1])},
                                cj, jnp.int32(s + i))
        dt, ct = T.decode_step(pt, cfg_t,
                               {"tokens": torch.from_numpy(toks[:, s + i:
                                                                s + i + 1])},
                               ct, s + i)
        _cross_close(dt, dj)
    # serve() on the same prompt with the same two tokens forced
    res = serve_mod.serve(cfg_t, pt, torch.from_numpy(toks[:, :s]), 3,
                          device="cpu",
                          forced_tokens=torch.from_numpy(toks[:, s:]))
    _cross_close(res.prefill_logits, lj[:, -1])
    assert torch.equal(res.tokens[:, 0],
                       torch.from_numpy(np.array(jnp.argmax(lj[:, -1],
                                                              -1))))
    _cross_close(res.step_logits[1], dj[:, 0])
    assert res.tokens.shape == (b, 3)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b",
                                  "minicpm-2b", "feddf-paper"])
def test_prefill_decode_matches_forward(arch):
    """tests/test_decode.py for the port (every reduced config it runs)."""
    cfg = reduced(configs.get(arch))
    params = T.init(cfg, torch.Generator().manual_seed(2))
    b, s = 2, 40
    toks = torch.randint(0, cfg.vocab_size, (b, s + 2),
                         generator=torch.Generator().manual_seed(3))
    full = T.forward(params, cfg, {"tokens": toks})
    pre, caches = T.prefill(params, cfg, {"tokens": toks[:, :s]},
                            max_seq=s + 4)
    np.testing.assert_allclose(pre, full[:, :s], rtol=PREFILL_RTOL,
                               atol=PREFILL_ATOL)
    last, _ = T.prefill(params, cfg, {"tokens": toks[:, :s]}, max_seq=s + 4,
                        last_only=True)
    # only the unembed of the last position (a [B,1,d] product) differs
    np.testing.assert_allclose(last, pre[:, -1:], rtol=1e-5, atol=1e-6)
    for i in range(2):
        dec, caches = T.decode_step(params, cfg,
                                    {"tokens": toks[:, s + i: s + i + 1]},
                                    caches, s + i)
        err = float((dec[:, 0] - full[:, s + i]).abs().max())
        assert err < DECODE_ATOL, f"decode step {i}: err={err}"


def test_serve_samples_from_its_generator():
    cfg = reduced(configs.get("zamba2-1.2b"))
    params = T.init(cfg, torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (3, 12),
                            generator=torch.Generator().manual_seed(1))
    runs = [serve_mod.serve(cfg, params, prompts, 6, device="cpu",
                            generator=torch.Generator().manual_seed(7),
                            temperature=0.7) for _ in range(2)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert runs[0].tokens.shape == (3, 6)
    assert int(runs[0].tokens.min()) >= 0
    assert int(runs[0].tokens.max()) < cfg.vocab_size
    assert len(runs[0].step_logits) == 5
    with pytest.raises(ValueError):
        serve_mod.serve(cfg, params, prompts, 3, device="cpu",
                        forced_tokens=torch.zeros(3, 1, dtype=torch.int64))


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "zamba2-1.2b-smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "20", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill [2x20]" in out.stdout
    assert out.stdout.count("tokens:") == 2


def test_serve_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(["--arch", "zamba2-1.2b-smoke"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve_mod.main(["--arch", "granite-moe-1b-a400m-smoke", "--device",
                        "cpu"])
