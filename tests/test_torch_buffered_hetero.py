"""The buffered-async driver over several prototypes (Algorithm 3 under
FedBuff-style buffering) in the port against the JAX package on the CPU.

The 3-prototype spec of ``test_torch_hetero.py`` runs 3 rounds on the
``buffered_async`` driver with staleness 1 and traffic latency, through
``repro.api.Experiment`` and ``repro_torch.api.Experiment`` with the JAX
init, noise draws or distill indices injected.  Stale uploads reach
rounds 2 and 3, so the heterogeneous fusion takes the weighted teacher
consensus: the ``noise`` source on the fly (kernel K3's plain version),
the ``unlabeled`` pool through a pre-weighted bank (K1's).  A buffer of 3
leaves a group without an upload in round 1 (it keeps its global); a
buffer of 4 with stragglers fuses uploads of two ages in round 3, so the
teachers' weights differ within the consensus.

Held per group: the population telemetry (numpy on both sides) exactly,
the bank decision, distill steps, teacher forwards and participants
exactly, test and ensemble accuracy within one test example and the
globals within 1e-4 (``test_torch_buffered.py``'s bounds)."""
import dataclasses

import pytest

from repro import api as japi
from repro_torch import api as tapi

from test_torch_buffered import jax_noise_stream
from test_torch_hetero import assert_runs_agree, hetero_spec, jax_hetero_init
from test_torch_slice import jax_index_stream

TELEMETRY = ("staleness_hist", "buffer_fill", "n_straggling",
             "n_dropped_uploads", "n_stale_dropped", "eff_participants")


def buffered_hetero_spec(pkg, source: str, buffer_size: int,
                         stragglers: bool = False):
    base = hetero_spec(pkg, rounds=3)
    traffic = (pkg.TrafficSpec(latency=1.0, jitter=0.5, straggler_frac=0.3,
                               straggler_mult=4.0) if stragglers
               else pkg.TrafficSpec(latency=1.0, jitter=0.2))
    return dataclasses.replace(
        base,
        source=pkg.SourceSpec(name=source,
                              params={"n": 300} if source == "unlabeled"
                              else {}),
        driver=pkg.DriverSpec(kind="buffered_async", staleness=1),
        population=pkg.PopulationSpec(buffer_size=buffer_size,
                                      max_staleness=4, traffic=traffic))


@pytest.mark.parametrize("source,buffer_size,stragglers,want_bank", [
    ("noise", 3, False, "on_the_fly"), ("noise", 4, True, "on_the_fly"),
    ("unlabeled", 4, True, "bank")])
def test_buffered_heterogeneous_run_matches_jax(source, buffer_size,
                                                stragglers, want_bank):
    jspec = buffered_hetero_spec(japi, source, buffer_size, stragglers)
    jres = japi.Experiment(jspec).run()
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    streams = ({"draw_stream": jax_noise_stream()} if source == "noise"
               else {"index_stream": jax_index_stream(300)})
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=jax_hetero_init(jspec), **streams)
    assert tres.heterogeneous and len(tres.results) == 3
    for jr, tr in zip(jres.results, tres.results, strict=True):
        for jl, tl in zip(jr.logs, tr.logs, strict=True):
            for k in TELEMETRY:
                assert getattr(tl, k) == getattr(jl, k), k
    assert_runs_agree(tres.results, tres.global_params, jres.results,
                      jres.global_params, int(600 * 0.2))
    logs = [l for r in tres.results for l in r.logs]
    # stale uploads fused: the weighted consensus ran
    assert any(sum(l.staleness_hist[1:]) > 0 for l in logs)
    fused = [l for l in logs if l.n_participants]
    assert fused and all(l.bank == want_bank for l in fused)
    if stragglers:             # one round fuses uploads of two ages
        assert any(sum(1 for n in l.staleness_hist if n) > 1 for l in logs)
    else:                      # a group without an upload keeps its global
        assert any(l.n_participants == 0 for l in logs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("temp", [1.0, 2.5])
def test_k2_at_six_teachers_matches_plain_on_card(dtype_name, temp):
    """Round 1 of buffered heterogeneous fusion at the published widths
    fuses 6 fresh uploads of three nets over a distill batch of 64 rows of
    3 classes: K2 at (6, 64, 3), lane groups, 2 of the 8-teacher template's
    slots empty.  K2's tolerances (forward rtol 1e-5 / atol 1e-6, gradient
    rtol 1e-4 / atol 1e-7); two launches equal bit for bit."""
    import numpy as np
    import torch
    from test_torch_ablations import _card_with_nvcc
    why = _card_with_nvcc()
    if why:
        pytest.skip(why)
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ops, ref
    assert k2.plan(6, 64, 3).mode == "lanes"
    gen = torch.Generator().manual_seed(6)
    s = (torch.randn(64, 3, generator=gen) * 3).cuda()
    t = (torch.randn(6, 64, 3, generator=gen) * 3).to(
        getattr(torch, dtype_name)).cuda()
    s_p, s_k = s.clone().requires_grad_(True), s.clone().requires_grad_(True)
    want = ref.ensemble_kl(s_p, t, temp)
    got = ops.ensemble_kl_loss(s_k, t, temp)
    (g_want,) = torch.autograd.grad(want, s_p)
    (g_got,) = torch.autograd.grad(got, s_k)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_got.cpu().numpy(), g_want.cpu().numpy(),
                               rtol=1e-4, atol=1e-7)
    g1 = torch.ones((), device="cuda")
    first, second = k2.kl_fwd(s, t, temp), k2.kl_fwd(s, t, temp)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(k2.kl_bwd(s, t, first[1], first[2], g1, temp),
                       k2.kl_bwd(s, t, first[1], first[2], g1, temp))
