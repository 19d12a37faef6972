"""Whole chaos specs through ``repro_torch.api.Experiment`` on the CPU,
held against the JAX package (docs/robustness.md), with the JAX
package's ``jax.random`` draws injected: the init, the distillation
indices and the teacher filter's probe batch.

Sync: the defended FedDF on the logit bank, the undefended one with its
divergence rollback, ``trimmed_mean`` and ``coordinate_median`` over
byzantine uploads, a quorum skip, and the teacher filter on the fly.
Buffered: a chaos run and a run whose quorum skips every round.  Every
fault decision (corrupted, quarantined, retried, filtered, fused, rolled
back) is equal, and the globals agree within 1e-4 (the atol of
``test_torch_slice.py``: float32 summation order over local SGD and Adam
distillation).  An armed but fault-free config equals the plain run bit
for bit in the port.  The ``gpu`` test holds K1 (every bank dtype and
launch mode) and K2 / K3 on rows holding a NaN, a +Inf and a -Inf teacher
logit against their plain versions on the card.

JAX is imported inside the tests that use it, so the file also loads
where only PyTorch is installed (``pytest -m gpu`` on the card's machine).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten


def _japi():
    from repro import api as japi
    return japi

N_SAMPLES, POOL = 600, 300
N_TEST = int(N_SAMPLES * 0.2)
CHAOS = dict(byzantine_frac=0.3, byzantine_scale=10.0, nan_rate=0.3,
             crash_rate=0.1, bitflip_rate=0.1, quorum=0.5)
FACTS = ("round", "n_participants", "distill_steps", "bank", "n_corrupted",
         "n_quarantined", "n_retries", "n_teachers_filtered", "fused",
         "rolled_back", "staleness_hist")


def chaos_spec(pkg, strategy="feddf", faults=None, rounds=2, bank="auto",
               driver=None, population=None, **kw):
    kw.setdefault("client_fraction", 0.5)
    kw.setdefault("local_epochs", 2)
    return pkg.ExperimentSpec(
        task=pkg.TaskSpec(name="blobs", n_samples=N_SAMPLES),
        partition=pkg.PartitionSpec(n_clients=6, alpha=1.0),
        cohort=pkg.CohortSpec(prototypes=[pkg.ModelSpec(
            "mlp", {"hidden": [16, 16]})]),
        strategy=pkg.StrategySpec(
            name=strategy, trim_frac=0.2, fusion=pkg.FusionSpec(
                max_steps=40, patience=40, eval_every=20, batch_size=32,
                logit_bank=bank)),
        source=(pkg.SourceSpec(name="unlabeled", params={"n": POOL})
                if strategy == "feddf" else None),
        driver=driver or pkg.DriverSpec(),
        population=population or pkg.PopulationSpec(),
        faults=pkg.FaultSpec(**(faults or {})),
        rounds=rounds, local_batch_size=32, local_lr=0.05, seed=0, **kw)


def jax_probe(jspec):
    """The teacher filter's probe batches as the JAX package samples
    them: ``source.sample(PRNGKey(seed), n)`` on the spec's pool."""
    import jax
    japi = _japi()
    bundle = japi.build_task_bundle(jspec)
    train = japi.build_splits(jspec, bundle)[0]
    src = japi.build_source(jspec, bundle, train)
    return lambda seed, n: np.asarray(src.sample(jax.random.PRNGKey(seed),
                                                 n))


def run_both(jspec):
    import jax
    from test_torch_slice import jax_index_stream
    japi = _japi()
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    feddf = jspec.strategy.name == "feddf"
    filt = feddf and tapi.to_fl_config(tspec).faults.teacher_filter_active
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=[convert.to_torch(init)],
        index_stream=jax_index_stream(POOL) if feddf else None,
        filter_probe=jax_probe(jspec) if filt else None)
    return jres, tres


def facts(res):
    return [tuple(getattr(l, k) for k in FACTS) for l in res.result.logs]


def assert_agree(jres, tres):
    from test_torch_baselines import assert_tree_close
    assert facts(tres) == facts(jres)
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / N_TEST + 1e-12
    assert_tree_close(tres.global_params[0], jres.global_params[0], 1e-4)
    assert tres.summary().get("faults") == jres.summary().get("faults")


SYNC_CASES = {
    # screen + teacher filter, FedDF on the bank
    "defended_feddf_bank": dict(faults=CHAOS),
    # no defense: NaN uploads reach the fusion, the guard rolls back
    "undefended_rollback": dict(faults=dict(nan_rate=0.5, screen="off",
                                            teacher_filter="off")),
    "trimmed_mean": dict(strategy="trimmed_mean", client_fraction=1.0,
                         faults=dict(byzantine_frac=0.3, screen="off")),
    "coordinate_median": dict(strategy="coordinate_median",
                              client_fraction=1.0,
                              faults=dict(byzantine_frac=0.3, nan_rate=0.2,
                                          screen="off")),
    # every upload poisoned: the screen quarantines the cohort, the quorum
    # skips both fusions and the globals carry over
    "quorum_skip": dict(strategy="fedavg", faults=dict(
        nan_rate=1.0, quorum=0.5, retries=1)),
    # screen off, teacher filter on, distillation on the fly
    "teacher_filter_on_the_fly": dict(bank="off", faults=dict(
        nan_rate=0.6, screen="off")),
}


@pytest.mark.parametrize("case", list(SYNC_CASES))
def test_sync_chaos_spec_matches_jax(case):
    jres, tres = run_both(chaos_spec(_japi(), **SYNC_CASES[case]))
    assert_agree(jres, tres)
    logs = tres.result.logs
    assert sum(l.n_corrupted for l in logs) > 0
    if case == "defended_feddf_bank":
        assert sum(l.n_quarantined for l in logs) > 0
        assert all(l.bank == "bank" for l in logs)
    if case == "undefended_rollback":
        assert any(l.rolled_back for l in logs)
    if case == "quorum_skip":
        assert not any(l.fused for l in logs)
        assert logs[0].test_acc == logs[1].test_acc
    if case == "teacher_filter_on_the_fly":
        assert sum(l.n_teachers_filtered for l in logs) > 0
        assert all(l.bank == "on_the_fly" for l in logs)
    for v in tree_flatten(tres.global_params[0]).values():
        assert bool(torch.isfinite(v).all())


def buffered_case(pkg, quorum_skips: bool):
    if quorum_skips:
        return chaos_spec(pkg, strategy="fedavg", local_epochs=1,
                          driver=pkg.DriverSpec(kind="buffered_async"),
                          population=pkg.PopulationSpec(size=12,
                                                        buffer_size=3),
                          faults=dict(nan_rate=1.0, retries=0, quorum=0.5))
    return chaos_spec(
        pkg, strategy="fedavg", rounds=3,
        driver=pkg.DriverSpec(kind="buffered_async"),
        population=pkg.PopulationSpec(size=12, buffer_size=3,
                                      max_staleness=4,
                                      traffic=pkg.TrafficSpec(latency=1.0,
                                                              jitter=0.2)),
        faults=dict(nan_rate=0.3, byzantine_frac=0.25, crash_rate=0.1,
                    quorum=0.5, retries=0))


@pytest.mark.parametrize("quorum_skips", [False, True],
                         ids=["chaos", "quorum_skips_every_round"])
def test_buffered_chaos_matches_jax(quorum_skips):
    jres, tres = run_both(buffered_case(_japi(), quorum_skips))
    assert_agree(jres, tres)
    s = tres.summary()["faults"]
    assert s["corrupted_uploads"] > 0 and s["quarantined_uploads"] > 0
    if quorum_skips:
        assert s["rounds_skipped"] == len(tres.result.logs) == 2


@pytest.mark.parametrize("driver", ["sync", "buffered_async"])
def test_armed_faultfree_config_is_bit_identical(driver):
    """A fault axis that can fire (so the upload screen, the quorum and
    the divergence guard are armed) but never does leaves the run bit for
    bit as it was.  The teacher filter stays off here: it is a decision
    rule over honest teachers too (on this spec it drops one of three
    honest teachers in round 1, as the JAX package's does), not a seam
    that only faults trigger."""
    pop = (tapi.PopulationSpec(size=12, buffer_size=3, max_staleness=4,
                               traffic=tapi.TrafficSpec(latency=1.0,
                                                        jitter=0.2))
           if driver == "buffered_async" else None)
    base = chaos_spec(tapi, driver=tapi.DriverSpec(kind=driver),
                      population=pop)
    armed = dataclasses.replace(base, faults=tapi.FaultSpec(
        nan_rate=1e-12, screen="on", teacher_filter="off", quorum=0.9,
        retries=4))
    a = tapi.Experiment(base, device="cpu").run()
    b = tapi.Experiment(armed, device="cpu").run()
    assert a.result.logs == b.result.logs
    fa, fb = tree_flatten(a.global_params[0]), tree_flatten(
        b.global_params[0])
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# the card: K1 and K2 / K3 on non-finite teacher rows
# ---------------------------------------------------------------------------

POISON = {1: float("nan"), 3: float("inf"), 5: float("-inf")}


def _poison_rows(t, rows_dim):
    """A NaN, a +Inf and a -Inf logit in rows 1, 3 and 5."""
    for r, val in POISON.items():
        t.select(rows_dim, r)[..., r % t.shape[-1]] = val
    return t


def _rows_agree(got, want, rtol, atol):
    """Non-finite in exactly the same places, close elsewhere."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    d = (got[fin] - want[fin]).abs()
    assert bool((d <= atol + rtol * want[fin].abs()).all())


@pytest.mark.gpu
def test_kernels_on_nonfinite_teacher_rows_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    from repro_torch.core.logit_bank import bank_dtype, quantize_rows
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ensemble_kl_bank as k1
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(0)
    b, temp = 7, 2.5
    for v in (3, 300, 5003):                   # lanes, block, cluster
        s = torch.randn(b, v, generator=gen).cuda()
        for dtype_name in ("float32", "bfloat16", "int8", "fp8_e4m3"):
            bank32 = _poison_rows(torch.randn(b, v, generator=gen) * 3, 0)
            idx = torch.arange(b)
            if dtype_name in ("int8", "fp8_e4m3"):
                rows, scales = quantize_rows(bank32, dtype_name)
            else:
                rows, scales = bank32.to(bank_dtype(dtype_name)), None
            row_scale = torch.ones(b) if scales is None else scales[idx]
            rows, idx, row_scale = rows.cuda(), idx.cuda(), row_scale.cuda()
            scales = None if scales is None else scales.cuda()
            kl, lse_t, lse_s = k1.bank_kl_fwd(s, rows, scales, idx, temp)
            t = rows[idx].float() * row_scale[:, None]
            want = _plain_rows(s, t[None], temp)
            _rows_agree(kl, want, 2e-6, 5e-6)
            sp = s.clone().requires_grad_(True)
            (g_want,) = torch.autograd.grad(ref.ensemble_kl_bank(
                sp, rows, row_scale, idx, temp), sp)
            g1 = torch.ones((), device="cuda")
            ds = k1.bank_kl_bwd(s, rows, scales, idx, lse_t, lse_s, g1, temp)
            _rows_agree(ds, g_want, 0.0, 3e-7)
        for tdt in (torch.float32, torch.bfloat16):
            t = _poison_rows(torch.randn(3, b, v, generator=gen) * 3,
                             1).to(tdt).cuda()
            for pre in (False, True):
                tin = t[0] if pre else t
                kl, lse_t, lse_s = k2.kl_fwd(s, tin, temp, pre)
                want = _plain_rows(s, tin[None] if pre else tin, temp)
                _rows_agree(kl, want, 1e-5, 1e-6)
                sp = s.clone().requires_grad_(True)
                plain = ref.ensemble_kl_pre if pre else ref.ensemble_kl
                (g_want,) = torch.autograd.grad(plain(sp, tin, temp), sp)
                ds = k2.kl_bwd(s, tin, lse_t, lse_s,
                               torch.ones((), device="cuda"), temp, pre)
                _rows_agree(ds, g_want, 1e-4, 1e-7)
                again = k2.kl_fwd(s, tin, temp, pre)
                for x, y in zip(again, (kl, lse_t, lse_s)):
                    assert torch.equal(x.view(torch.int32),
                                       y.view(torch.int32))


def _plain_rows(s, teachers, temp):
    """Per-row KL(softmax(mean_k t_k / T) || softmax(s / T)): the plain
    versions' arithmetic (``kernels/ref.py``) before the batch mean, in
    the kernels' T-scaled units."""
    from repro_torch.kernels import ref
    logp_t = torch.log_softmax(ref._mean_teacher(teachers, temp), -1)
    logp_s = torch.log_softmax(s.float() / temp, -1)
    return (logp_t.exp() * (logp_t - logp_s)).sum(-1)
