"""The port's logit bank against the JAX package's: per-row quantization
(rows and scales), dequantization, the chunked build over a stacked
teacher ensemble, and the ``auto`` break-even decision."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feddf as jfeddf
from repro.core import logit_bank as jbank
from repro.core import nets as jnets
from repro.data.distill_sources import UnlabeledDataset as JSource
from repro_torch import convert
from repro_torch.common.pytree import tree_stack
from repro_torch.core import feddf as tfeddf
from repro_torch.core import logit_bank as tbank
from repro_torch.core import nets as tnets
from repro_torch.data.distill_sources import UnlabeledDataset as TSource


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(33, 7)) * rng.uniform(0.1, 20, (33, 1))
            ).astype(np.float32)
    rows[4] = 0.0        # all-zero row: scale 1
    rows[5, 2] = 127.5   # a half-way int8 value after scaling
    return rows


@pytest.mark.parametrize("dtype_name", ["int8", "fp8_e4m3"])
def test_quantize_rows_match_jax(dtype_name):
    rows = _rows()
    jq, js = jbank.quantize_rows(jnp.asarray(rows), dtype_name)
    tq, ts = tbank.quantize_rows(torch.from_numpy(rows), dtype_name)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jq.astype(jnp.float32)),
                          tq.float().numpy())
    np.testing.assert_array_equal(
        tbank.dequantize_rows(tq, ts).numpy(),
        np.asarray(jbank.dequantize_rows(jq, js)))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8",
                                        "fp8_e4m3"])
def test_bank_build_matches_jax(dtype_name):
    """Bank rows of 4 stacked teachers over a 700-row pool (two chunks).
    Tolerance: the teachers' float32 forwards and the K-mean are summed in
    another order (1e-5); quantized rows may then land one step apart."""
    jn, tn = jnets.mlp(2, 3, (16, 16)), tnets.mlp(2, 3, (16, 16))
    jtrees = [jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(k)))
              for k in range(4)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jtrees)
    tstack = tree_stack([convert.to_torch(t) for t in jtrees])
    pool = np.random.default_rng(1).uniform(-3, 3, (700, 2)).astype(
        np.float32)
    jb = jbank.build_logit_bank(
        [jfeddf.make_teacher_logits_fn(jn, jstack)], jnp.asarray(pool),
        dtype=dtype_name)
    tb = tbank.build_logit_bank(
        [tfeddf.make_teacher_logits_fn(tn, tstack)], torch.from_numpy(pool),
        dtype=dtype_name)
    assert (tb.n, tb.n_teachers, tb.n_teacher_batch_forwards, tb.nbytes) == \
        (jb.n, jb.n_teachers, jb.n_teacher_batch_forwards, jb.nbytes)
    jrows = np.asarray(jbank.dequantize_rows(jb.logits, jb.scales))
    trows = tbank.dequantize_rows(tb.logits, tb.scales).numpy()
    step = (0.0 if jb.scales is None
            else np.asarray(jb.scales)[:, None] * (1.0 if dtype_name == "int8"
                                                    else 0.0))
    atol = {"float32": 1e-5, "bfloat16": 0.0}.get(dtype_name, 1e-5)
    if dtype_name == "bfloat16":
        # one bf16 rounding step apart at most
        atol = np.abs(jrows).max() * 2 ** -7
    if dtype_name == "fp8_e4m3":
        atol = np.abs(jrows).max() * 2 ** -3
    assert np.all(np.abs(trows - jrows) <= atol + step + 1e-5)
    if jb.scales is not None:
        np.testing.assert_allclose(tb.scales.numpy(), np.asarray(jb.scales),
                                   rtol=1e-5)


def test_resolve_bank_decisions_and_break_even():
    fusion_j = jfeddf.FusionConfig(max_steps=60, patience=40, eval_every=20,
                                   batch_size=32)
    fusion_t = tfeddf.FusionConfig(**{f.name: getattr(fusion_j, f.name)
                                      for f in dataclasses.fields(fusion_j)})
    for have_val in (True, False):
        for pat in (0, 10, 40, 1000):
            fj = dataclasses.replace(fusion_j, patience=pat)
            ft = dataclasses.replace(fusion_t, patience=pat)
            assert tfeddf.expected_distill_steps(ft, have_val) == \
                jfeddf.expected_distill_steps(fj, have_val)
    pool = np.zeros((3000, 2), np.float32)
    tn = tnets.mlp(2, 3, (4,))
    stack = tree_stack([tn.init(torch.Generator().manual_seed(0))])
    fn = tfeddf.make_teacher_logits_fn(tn, stack)
    for mode, steps, want in (("off", 60, "off"), ("auto", 60,
                                                   "skipped_small_run"),
                              ("auto", 100, "built"), ("on", 60, "built")):
        ft = dataclasses.replace(fusion_t, logit_bank=mode)
        fj = dataclasses.replace(fusion_j, logit_bank=mode)
        bank, reason = tbank.resolve_bank([fn], TSource(pool), ft,
                                          expected_steps=steps)
        assert reason == want and (bank is not None) == (want == "built")
        if mode != "off":
            jfn = jfeddf.make_teacher_logits_fn(
                jnets.mlp(2, 3, (4,)),
                jax.tree.map(lambda x: jnp.asarray(x.numpy()), stack))
            jbank.PERSISTENT_BANK.clear()
            _, jreason = jbank.resolve_bank([jfn], JSource(pool), fj,
                                            expected_steps=steps)
            assert jreason == want
