"""The step builders' gradients on the card (``pytest -m gpu`` on a
machine with a CUDA card and nvcc; they skip without one).  The file
imports no JAX, so it loads where only PyTorch is installed.

* K4 and K5 through their autograd functions (``ops.swa_attention``,
  ``ops.ssd_scan``), float32 and bfloat16: the forward is the kernel
  (one launch each), held against the plain version at K4 / K5's
  tolerances (rtol 1e-4 / atol 1e-5 in float32, 3e-2 in bfloat16); the
  backward recomputes the plain version, so its gradients equal the plain
  version's own autograd on the same inputs (the same arithmetic: within
  1e-6).
* A reduced zamba2-1.2b train step on the card (bf16, 2 microbatches,
  remat): every parameter leaf's gradient finite and non-zero.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.common.arch_config import reduced
from repro_torch.common.pytree import tree_flatten
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_autograd_on_the_card(dtype):
    _need_card()
    from repro_torch.kernels import ssd_scan, swa_attn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=3e-2, atol=3e-2)
    q, k, v, go = (r(2, 8, 300, 64), r(2, 4, 300, 64), r(2, 4, 300, 64),
                   r(2, 8, 300, 64))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = swa_attn.LAUNCHES["swa_attn"]
    out = ops.swa_attention(*a, None, True)
    assert swa_attn.LAUNCHES["swa_attn"] == n0 + 1
    ref_out = tref.swa_attn(*b, None, True)
    torch.testing.assert_close(out, ref_out, **tol)
    torch.autograd.backward(out, go)
    torch.autograd.backward(ref_out, go)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-6, atol=1e-6)
    x, bm, cm = r(2, 300, 4, 64), r(2, 300, 64), r(2, 300, 64)
    dt = torch.rand(2, 300, 4, generator=g, device=dev) * 0.1
    a_log = torch.rand(4, generator=g, device=dev)
    ins = (x, dt, a_log, bm, cm)
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    n0 = ssd_scan.LAUNCHES["ssd_scan"]
    y, st = ops.ssd_scan(*a, 64)
    assert ssd_scan.LAUNCHES["ssd_scan"] == n0 + 1
    y2, st2 = tref.ssd_scan(*b, 64)
    torch.testing.assert_close(y, y2, **tol)
    (y.float().sum() + st.sum()).backward()
    (y2.float().sum() + st2.sum()).backward()
    for p, p2 in zip(a, b):
        torch.testing.assert_close(p.grad, p2.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_reduced_zamba2_train_step_on_the_card_reaches_every_leaf():
    _need_card()
    ct = reduced(configs.get("zamba2-1.2b"))
    bundle = steps.make_train_step(ct, InputShape("t", 128, 2, "train"),
                                   microbatch=2)
    args = bundle.init_args(torch.Generator(device="cuda").manual_seed(0))
    grads, m = steps.train_grads(args[0], ct, args[3], microbatch=2)
    assert torch.isfinite(m["loss"])
    for path, g in tree_flatten(grads).items():
        assert bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0), \
            path
    bundle.fn(*args)
