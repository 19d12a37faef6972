"""The persistent cross-round logit-bank cache of the port against the JAX
package's (``core/logit_bank.py`` ``PERSISTENT_BANK``).

The five persistent-bank tests of ``tests/test_logit_bank.py``, each run
through both packages on the same teacher stacks (the JAX init converted
through numpy) and the same pool, the port drawing JAX's distillation
indices (injected): the bank decisions (``bank`` / ``bank_reused`` /
``skipped_small_run``), the teacher batch forwards and the fused
parameters must match JAX's (parameters within 2e-5, as
``tests/test_torch_feddf.py``); a re-fuse equals the first fuse bit for
bit within each package.  Both caches are module-global, so every test
clears both at its start and end.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.pytree import tree_stack as jtree_stack
from repro.core import feddf as jfeddf
from repro.core import logit_bank as jbank
from repro.core import nets as jnets
from repro.data.distill_sources import UnlabeledDataset as JSource
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_stack
from repro_torch.core import feddf as tfeddf
from repro_torch.core import logit_bank as tbank
from repro_torch.core import nets as tnets
from repro_torch.data.distill_sources import UnlabeledDataset as TSource

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _clear_both_caches():
    jbank.PERSISTENT_BANK.clear()
    tbank.PERSISTENT_BANK.clear()
    yield
    jbank.PERSISTENT_BANK.clear()
    tbank.PERSISTENT_BANK.clear()


def jax_index_stream(n_pool):
    """The indices JAX's distill chunk draws: ``key, k1 = split(key)``
    per step from ``PRNGKey(seed)``, then ``sample_indices(k1, b)``."""
    src = JSource(np.zeros((n_pool, 1), np.float32))

    def stream(seed, batch_size, chunk):
        key = jax.random.PRNGKey(seed)
        while True:
            block = []
            for _ in range(chunk):
                key, k1 = jax.random.split(key)
                block.append(np.asarray(src.sample_indices(k1, batch_size)))
            yield np.stack(block)
    return stream


def _fusions(**kw):
    base = dict(max_steps=75, patience=1_000, eval_every=25, batch_size=32,
                use_fused_kernel=False)
    base.update(kw)
    return jfeddf.FusionConfig(**base), tfeddf.FusionConfig(**base)


def _sources(n=400, dim=2, seed=0):
    x = np.random.default_rng(seed).uniform(-3, 3, (n, dim)).astype(
        np.float32)
    return JSource(x), TSource(x, indices=jax_index_stream(n))


def _val(n=150, dim=2, classes=3, seed=1):
    r = np.random.default_rng(seed)
    x = r.uniform(-3, 3, (n, dim)).astype(np.float32)
    y = r.integers(0, classes, size=n)
    return (jnp.asarray(x), y), (torch.from_numpy(x), torch.from_numpy(y))


def _nets(hidden, name=None):
    return (jnets.mlp(2, 3, hidden=hidden, name=name),
            tnets.mlp(2, 3, hidden=hidden, name=name))


def _stacks(jnet, k, seed0=0):
    """The JAX stack of ``k`` inits and the same trees as a port stack."""
    trees = [jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed0 + i)))
             for i in range(k)]
    return (jtree_stack([jax.tree.map(jnp.asarray, t) for t in trees]),
            tree_stack([convert.to_torch(t) for t in trees]))


def _close_to_jax(tp, jp, atol=ATOL):
    tflat = tree_flatten(tp)
    for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_allclose(tflat[key].numpy(), np.asarray(v),
                                   rtol=0, atol=atol)


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_persistent_bank_reused_for_identical_teacher_stacks():
    jnet, tnet = _nets((16,))
    jstack, tstack = _stacks(jnet, 4)
    jsrc, tsrc = _sources()
    (jvx, jvy), (tvx, tvy) = _val()
    jf, tf = _fusions(logit_bank="on")
    runs = {}
    for pkg, fuse, net, stack, src, fus, vx, vy in (
            ("jax", jfeddf.feddf_fuse_stacked, jnet, jstack, jsrc, jf, jvx,
             jvy),
            ("torch", tfeddf.feddf_fuse_stacked, tnet, tstack, tsrc, tf, tvx,
             tvy)):
        counter = (jbank if pkg == "jax" else tbank).TEACHER_FORWARDS
        out = []
        for _ in range(2):
            counter.reset()
            p, info = fuse(net, stack, [1.0] * 4, src, fus, vx, vy, seed=3)
            out.append((p, info, counter.count))
        runs[pkg] = out
    for pkg in ("jax", "torch"):
        (_, i1, n1), (_, i2, n2) = runs[pkg]
        assert i1["bank_decision"] == "bank" and n1 > 0
        assert i1["teacher_batch_forwards"] == n1
        assert i2["bank_decision"] == "bank_reused"
        assert n2 == 0 and i2["teacher_batch_forwards"] == 0
        assert i2["bank_build_s"] == 0.0
    for i in range(2):
        (tp, ti, tn), (jp, ji, jn) = runs["torch"][i], runs["jax"][i]
        assert (ti["bank_decision"], ti["teacher_batch_forwards"], tn,
                ti["steps"]) == (ji["bank_decision"],
                                 ji["teacher_batch_forwards"], jn,
                                 ji["steps"])
        _close_to_jax(tp, jp)
    assert _bit_equal(runs["torch"][0][0], runs["torch"][1][0])


def test_cached_bank_beats_small_run_skip():
    """A cached bank is free, so a run too short to amortize a build still
    uses it."""
    jnet, tnet = _nets((8,))
    jstack, tstack = _stacks(jnet, 2)
    jsrc, tsrc = _sources(n=4000)
    reasons = {}
    for pkg, mod, bank, net, stack, src in (
            ("jax", jfeddf, jbank, jnet, jstack, jsrc),
            ("torch", tfeddf, tbank, tnet, tstack, tsrc)):
        tfn = mod.make_teacher_logits_fn(net, stack)
        small = mod.FusionConfig(max_steps=10_000, patience=25,
                                 eval_every=25, batch_size=16,
                                 use_fused_kernel=False)
        on = mod.FusionConfig(max_steps=75, patience=1_000, eval_every=25,
                              batch_size=32, use_fused_kernel=False,
                              logit_bank="on")
        exp = mod.expected_distill_steps(small, True)
        got = [bank.resolve_bank([tfn], src, small, expected_steps=exp)]
        got.append(bank.resolve_bank([tfn], src, on))
        got.append(bank.resolve_bank([tfn], src, small, expected_steps=exp))
        reasons[pkg] = [r for _, r in got]
        assert got[0][0] is None and got[2][0] is not None
        assert got[2][0].reused
    assert reasons["torch"] == reasons["jax"] == [
        "skipped_small_run", "built", "reused"]


def test_persistent_bank_drops_when_uploads_die():
    """The keyed uploads are held weakly: once the teacher stacks are freed,
    the entry (bank rows included) goes with them."""
    jnet, tnet = _nets((8,))
    jsrc, tsrc = _sources(n=64)
    jf, tf = _fusions(logit_bank="on", max_steps=25)
    for pkg, mod, bank, net, src, fus in (
            ("jax", jfeddf, jbank, jnet, jsrc, jf),
            ("torch", tfeddf, tbank, tnet, tsrc, tf)):
        stack = _stacks(jnet, 2)[0 if pkg == "jax" else 1]
        mod.feddf_fuse_stacked(net, stack, [1.0, 1.0], src, fus, seed=0)
        tfn = mod.make_teacher_logits_fn(net, stack)
        assert bank.resolve_bank([tfn], src, fus)[1] == "reused", pkg
        assert bank.PERSISTENT_BANK._bank is not None
        del stack, tfn
        gc.collect()
        assert bank.PERSISTENT_BANK._bank is None, pkg


def test_persistent_bank_invalidated_on_any_upload_change():
    jnet, tnet = _nets((16,))
    jsrc, tsrc = _sources()
    jf, tf = _fusions(logit_bank="on")
    s1, s2 = _stacks(jnet, 3), _stacks(jnet, 3, seed0=50)
    got = {}
    for i, (pkg, mod, bank, net, src, fus) in enumerate((
            ("jax", jfeddf, jbank, jnet, jsrc, jf),
            ("torch", tfeddf, tbank, tnet, tsrc, tf))):
        mod.feddf_fuse_stacked(net, s1[i], [1.0] * 3, src, fus, seed=1)
        bank.TEACHER_FORWARDS.reset()
        p, info = mod.feddf_fuse_stacked(net, s2[i], [1.0] * 3, src, fus,
                                         seed=1)
        # new uploads, new leaf identities: rebuilt, not reused
        assert info["bank_decision"] == "bank", pkg
        assert bank.TEACHER_FORWARDS.count > 0
        got[pkg] = (p, info["teacher_batch_forwards"],
                    bank.TEACHER_FORWARDS.count)
    assert got["torch"][1:] == got["jax"][1:]
    _close_to_jax(got["torch"][0], got["jax"][0])


def test_persistent_bank_shared_across_hetero_round_repeat():
    """Repeating a heterogeneous fusion with unchanged teacher stacks
    rebuilds nothing; every group's info reports the reuse."""
    pairs = [_nets((8,), "a"), _nets((12,), "b")]
    jprotos, tprotos = [], []
    for i, (jn, tn) in enumerate(pairs):
        js, ts = _stacks(jn, 2, seed0=7 * i)
        jprotos.append((jn, js, [1.0, 1.0]))
        tprotos.append((tn, ts, [1.0, 1.0]))
    jsrc, tsrc = _sources(seed=3)
    jf, tf = _fusions(logit_bank="on")
    runs = {}
    for pkg, mod, bank, protos, src, fus in (
            ("jax", jfeddf, jbank, jprotos, jsrc, jf),
            ("torch", tfeddf, tbank, tprotos, tsrc, tf)):
        f1, i1 = mod.feddf_fuse_heterogeneous_stacked(protos, src, fus,
                                                      seed=2)
        assert all(i["bank_decision"] == "bank" for i in i1), pkg
        bank.TEACHER_FORWARDS.reset()
        f2, i2 = mod.feddf_fuse_heterogeneous_stacked(protos, src, fus,
                                                      seed=2)
        assert all(i["bank_decision"] == "bank_reused" for i in i2), pkg
        assert bank.TEACHER_FORWARDS.count == 0
        assert all(i["teacher_batch_forwards"] == 0 for i in i2)
        runs[pkg] = (f1, f2, [i["teacher_batch_forwards"] for i in i1],
                     [i["steps"] for i in i2])
    assert runs["torch"][2:] == runs["jax"][2:]
    for a, b in zip(runs["torch"][0], runs["torch"][1]):
        assert _bit_equal(a, b)
    for tp, jp in zip(runs["torch"][1], runs["jax"][1]):
        _close_to_jax(tp, jp)
