"""The paper's remaining ablations in the port against the JAX package:
drop-worst (Table 3), 1-bit clients (Table 4), DP uploads (§3) and SWAG
teachers (Table 7), module by module and through both packages'
``Experiment`` on the CPU, with the JAX package's init and ``jax.random``
draws injected into the port.  Plus the K2 kernel at SWAG's 13 teachers
on the card (``gpu``, skips here).

Tolerances, stated per test:
- ``binarize``: signs, untouched leaves and the straight-through sum
  ``w + (sign(w) * s - w)`` for the same scale ``s`` bit for bit.  The
  scale ``mean|w|`` itself is a float32 sum that XLA and PyTorch take in
  different orders, 0-3 units in the last place apart, so the binarized
  leaves are held to 1e-6 of the scale.
- ``comm_bytes``: equal integers.
- privacy: a few float32 operations over O(1) values, 1e-6 absolute.
- SWAG: the mean over K = 5 clients bit for bit; the population
  variance 1e-7 absolute plus 1e-6 relative (XLA accumulates the squares
  with fused multiply-adds, PyTorch's ``var`` does not: a few units in the
  last place of O(1) values); the samples add sqrt(scale * var / 2) times
  the same draws, 1e-6.
- drop-worst: equal accuracies (exact counts), equal kept indices.
- the client update with binarized forwards or DP against JAX's
  SEQUENTIAL ``make_local_update`` (JAX's batched equalities fail in
  every run, ROADMAP.md queue 3), 1e-5 absolute over up to 24 SGD steps.
- whole runs at ``test_torch_slice.py``'s bounds: globals within 1e-4,
  test accuracy within one test example, equal bank decisions, distill
  steps, participants and drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import client as jclient
from repro.core import dropworst as jdrop
from repro.core import feddf as jfeddf
from repro.core import nets as jnets
from repro.core import privacy as jpriv
from repro.core import quantize as jquant
from repro.core import swag as jswag
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import gaussian_mixture
from repro.optim import optimizers as jopt
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.common.pytree import tree_flatten
from repro_torch.core import client as tclient
from repro_torch.core import dropworst as tdrop
from repro_torch.core import feddf as tfeddf
from repro_torch.core import nets as tnets
from repro_torch.core import privacy as tpriv
from repro_torch.core import quantize as tquant
from repro_torch.core import swag as tswag
from repro_torch.optim import optimizers as topt

from test_torch_baselines import assert_tree_close
from test_torch_slice import jax_index_stream, jax_latent_stream, tiny_spec


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _nested(shapes):
    """A JAX tree of zeros with the given ``{path: shape}`` leaves."""
    out = {}
    for path, shape in shapes.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(shape, np.float32)
    return out


def jax_dp_draws(seed, shapes):
    """The standard normal draws JAX's ``gaussian_noise_like`` takes for
    one client keyed ``PRNGKey(seed)``: one split key a leaf, in
    ``jax.tree.leaves`` order."""
    leaves = jax.tree_util.tree_flatten_with_path(_nested(shapes))[0]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return {_path(path): np.asarray(jax.random.normal(k, x.shape,
                                                      jnp.float32))
            for (path, x), k in zip(leaves, keys)}


def jax_swag_draws(seed, n_samples, shapes):
    """The draws of JAX's ``swag_sample``: its key chain over samples,
    one split key a leaf within each."""
    leaves = jax.tree_util.tree_flatten_with_path(_nested(shapes))[0]
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_samples):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, len(leaves))
        out.append({_path(path): np.asarray(jax.random.normal(
            k, x.shape, jnp.float32)) for (path, x), k in zip(leaves, keys)})
    return out


def _np_tree(rng, k=None):
    """A tree with every case the quantizer sees: weight matrices, a
    matrix one element under ``min_size``, an all-zero matrix, vectors."""
    lead = () if k is None else (k,)
    return {"dense_0": {"w": rng.normal(size=lead + (2, 64)),
                        "b": rng.normal(size=lead + (64,))},
            "dense_1": {"w": rng.normal(size=lead + (64, 3)),
                        "b": rng.normal(size=lead + (3,))},
            "small": {"w": rng.normal(size=lead + (31, 1))},
            "zero": {"w": np.zeros(lead + (8, 8))},
            "vec": {"v": rng.normal(size=lead + (100,))}}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("stacked", [False, True])
def test_binarize_matches_jax(stacked):
    rng = np.random.default_rng(0)
    tree = _f32(_np_tree(rng, 5 if stacked else None))
    jfn = jax.vmap(jquant.binarize) if stacked else jquant.binarize
    want = jax.tree.map(np.asarray, jfn(jax.tree.map(jnp.asarray, tree)))
    got = tree_flatten(tquant.binarize(convert.to_torch(tree),
                                       stacked=stacked))
    lead = 1 if stacked else 0
    flat_in = tree_flatten(convert.to_torch(tree))
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        key = _path(path)
        g, x = got[key].numpy(), flat_in[key].numpy()
        client_shape = x.shape[lead:]
        if len(client_shape) < 2 or np.prod(client_shape) < 32:
            np.testing.assert_array_equal(g, w, err_msg=key)  # untouched
            np.testing.assert_array_equal(g, x, err_msg=key)
            continue
        axes = tuple(range(lead, x.ndim))
        scale = np.abs(x).mean(axis=axes, keepdims=True)
        np.testing.assert_array_equal(np.sign(g), np.sign(x), err_msg=key)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale.max(),
                                   err_msg=key)
        # the same scale gives the same bits: JAX's sum, JAX's scale
        s_j = jnp.mean(jnp.abs(jnp.asarray(x)), axis=axes, keepdims=True)
        want_ste = np.asarray(jnp.asarray(x) + jax.lax.stop_gradient(
            jnp.sign(jnp.asarray(x)) * s_j - jnp.asarray(x)))
        got_ste = tquant._ste(torch.from_numpy(x),
                              torch.from_numpy(np.array(s_j))).numpy()
        np.testing.assert_array_equal(got_ste, want_ste, err_msg=key)
    assert not got["zero/w"].any()


def test_binarize_stacked_is_per_client_bit_for_bit():
    """A stack binarizes exactly as its clients one by one; a leaf is
    judged by one client's shape ([K, 31, 1] stays full precision although
    the stack has 155 elements, [K, 100] although it has 2 dimensions)."""
    rng = np.random.default_rng(1)
    stack = convert.to_torch(_f32(_np_tree(rng, 5)))
    got = tree_flatten(tquant.binarize(stack, stacked=True))
    for k in range(5):
        one = tree_flatten(tquant.binarize(
            {p: {q: v[k] for q, v in leaves.items()}
             for p, leaves in stack.items()}))
        for path, v in one.items():
            assert torch.equal(got[path][k], v), path
    assert torch.equal(got["small/w"], tree_flatten(stack)["small/w"])
    assert torch.equal(got["vec/v"], tree_flatten(stack)["vec/v"])


def test_binarize_gradient_is_the_identity():
    """The straight-through estimator: d binarize(w) / dw = 1 exactly."""
    rng = np.random.default_rng(2)
    for stacked in (False, True):
        w = torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(np.float32)
                             [0 if not stacked else slice(None)])
        w.requires_grad_(True)
        c = torch.from_numpy(rng.normal(size=tuple(w.shape)).astype(
            np.float32))
        (g,) = torch.autograd.grad(
            (tquant.binarize({"w": w}, stacked=stacked)["w"] * c).sum(), w)
        assert torch.equal(g, c)


@pytest.mark.parametrize("binarized", [False, True])
def test_comm_bytes_matches_jax_on_the_lowbit_mlp(binarized):
    """examples/lowbit_fl.py's mlp [64, 64] on the blobs task."""
    jn = jnets.mlp(2, 3, (64, 64))
    jp = jn.init(jax.random.PRNGKey(0))
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    assert tquant.comm_bytes(tp, binarized) == \
        jquant.comm_bytes(jp, binarized)
    assert tquant.comm_bytes(tp, True) < tquant.comm_bytes(tp)


def _dp_pair(scale):
    rng = np.random.default_rng(3)
    g = _f32({"dense_0": {"w": rng.normal(size=(2, 8)),
                          "b": rng.normal(size=(8,))},
              "dense_1": {"w": rng.normal(size=(8, 3)),
                          "b": rng.normal(size=(3,))}})
    c = jax.tree.map(lambda a: (a + scale * rng.normal(size=a.shape)
                                ).astype(np.float32), g)
    return g, c


@pytest.mark.parametrize("clip", [0.5, 100.0])  # above, below the norm
def test_global_norm_and_clip_match_jax(clip):
    g, c = _dp_pair(1.0)
    delta = jax.tree.map(lambda a, b: a - b, c, g)
    tdelta = convert.to_torch(delta)
    np.testing.assert_allclose(float(tpriv.global_norm(tdelta)),
                               float(jpriv.global_norm(delta)), rtol=1e-6)
    assert_tree_close(tpriv.clip_by_global_norm(tdelta, clip),
                      jpriv.clip_by_global_norm(delta, clip), 1e-6)
    if clip > 10:  # below the threshold: untouched
        assert_tree_close(tpriv.clip_by_global_norm(tdelta, clip), delta, 0)


@pytest.mark.parametrize("noise_multiplier", [0.0, 0.3])
def test_privatize_update_matches_jax_with_its_draws(noise_multiplier):
    g, c = _dp_pair(1.0)
    want = jpriv.privatize_update(g, c, clip=1.0,
                                  noise_multiplier=noise_multiplier,
                                  key=jax.random.PRNGKey(42))
    got = tpriv.privatize_update(convert.to_torch(g), convert.to_torch(c),
                                 clip=1.0, noise_multiplier=noise_multiplier,
                                 seed=42, draws=jax_dp_draws)
    assert_tree_close(got, want, 1e-6)
    # the stacked form: one norm per client, client k's noise from seed k
    stack = jax.tree.map(lambda a, b: np.stack([a, b, a]), c,
                         _dp_pair(0.01)[1])
    got = tree_flatten(tpriv.privatize_update_stacked(
        convert.to_torch(g), convert.to_torch(stack), clip=1.0,
        noise_multiplier=noise_multiplier, seeds=[42, 7, 9],
        draws=jax_dp_draws))
    for k, seed in enumerate([42, 7, 9]):
        want = jpriv.privatize_update(
            g, jax.tree.map(lambda a: a[k], stack), clip=1.0,
            noise_multiplier=noise_multiplier,
            key=jax.random.PRNGKey(seed))
        assert_tree_close({p: v[k] for p, v in got.items()}, want, 1e-6)


def test_port_draws_repeat_and_follow_leaf_order():
    """The port's own draws: one CPU generator per seed, leaves in sorted
    path order, so the same seed gives the same noise whatever the tree's
    insertion order."""
    shapes = {"b/w": (3, 2), "a/w": (4,), "a/b": (2,)}
    one = tpriv.normal_draws(5, shapes)
    two = tpriv.normal_draws(5, dict(reversed(list(shapes.items()))))
    assert list(one) == ["a/b", "a/w", "b/w"]
    for p in shapes:
        assert torch.equal(one[p], two[p])
    g = torch.Generator().manual_seed(5)
    assert torch.equal(one["a/b"], torch.randn(2, generator=g))


def _swag_stack():
    rng = np.random.default_rng(4)
    stack = _f32({"dense_0": {"w": rng.normal(size=(5, 2, 8)),
                              "b": rng.normal(size=(5, 8))},
                  "dense_1": {"w": rng.normal(size=(5, 8, 3))}})
    stack["dense_1"]["b"] = np.broadcast_to(                # clients agree
        rng.normal(size=(1, 3)).astype(np.float32), (5, 3)).copy()
    return stack


def test_swag_fit_stacked_matches_jax():
    stack = _swag_stack()
    jm, jv = jswag.swag_fit_stacked(stack)
    tm, tv = tswag.swag_fit_stacked(convert.to_torch(stack))
    assert_tree_close(tm, jm, 0)
    tflat = tree_flatten(tv)
    for path, v in jax.tree_util.tree_flatten_with_path(jv)[0]:
        np.testing.assert_allclose(tflat[_path(path)].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=_path(path))
    assert (tree_flatten(tv)["dense_1/b"] == 0).all()
    assert all((v >= 0).all() for v in tree_flatten(tv).values())


def test_swag_teachers_stacked_matches_jax_with_its_draws():
    stack = _swag_stack()
    want = jswag.swag_teachers_stacked(stack, 3, scale=0.5, seed=11)
    got = tswag.swag_teachers_stacked(convert.to_torch(stack), 3, scale=0.5,
                                      seed=11, draws=jax_swag_draws)
    assert tree_flatten(got)["dense_0/w"].shape[0] == 8
    assert_tree_close(got, want, 1e-6)
    assert tswag.swag_teachers_stacked(stack, 0) is stack
    # the list form: the same teachers as JAX's list form
    trees = [jax.tree.map(lambda a: a[k], stack) for k in range(5)]
    jl = jswag.swag_teachers(trees, 3, scale=0.5, seed=11)
    tl = tswag.swag_teachers([convert.to_torch(t) for t in trees], 3,
                             scale=0.5, seed=11, draws=jax_swag_draws)
    assert len(tl) == len(jl) == 8
    for a, b in zip(tl, jl):
        assert_tree_close(a, b, 1e-6)
    # the port's own draws: the fusion seed's CPU generator, repeatable
    a = tswag.swag_teachers_stacked(convert.to_torch(stack), 3, seed=11)
    b = tswag.swag_teachers_stacked(convert.to_torch(stack), 3, seed=11)
    for p, v in tree_flatten(a).items():
        assert torch.equal(v, tree_flatten(b)[p])


def test_swag_fuse_appends_the_mean_teacher_weight(monkeypatch):
    """feddf_fuse_stacked draws the SWAG teachers after the student is
    initialised and gives each the received teachers' mean importance;
    the teachers and weights reaching ``distill`` match JAX's."""
    stack = _swag_stack()
    seen = {}

    def capture(pkg):
        def fake(net, student, fns, source, fusion, vx, vy, seed,
                 teacher_weights=None):
            seen[pkg] = (student, fns[0], teacher_weights)
            return student, {}
        return fake
    monkeypatch.setattr(jfeddf, "distill", capture("jax"))
    monkeypatch.setattr(tfeddf, "distill", capture("torch"))
    jf = jfeddf.FusionConfig(swag_samples=4, swag_scale=0.5)
    tf = tfeddf.FusionConfig(swag_samples=4, swag_scale=0.5)
    jn, tn = jnets.mlp(2, 3, (8,)), tnets.mlp(2, 3, (8,))
    w, imp = [1.0, 2.0, 3.0, 1.0, 1.0], [1.0, 0.5, 0.25, 1.0, 0.5]
    jfeddf.feddf_fuse_stacked(jn, stack, w, None, jf, seed=3,
                              teacher_weights=np.asarray(imp))
    tfeddf.feddf_fuse_stacked(tn, convert.to_torch(stack), w, None, tf,
                              seed=3, teacher_weights=np.asarray(imp),
                              swag_draws=jax_swag_draws)
    (js, jfn, jw), (ts, tfn, tw) = seen["jax"], seen["torch"]
    assert_tree_close(ts, js, 1e-6)           # the received models' mean
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tw[5:], np.full(4, np.mean(imp)))
    x = np.random.default_rng(5).normal(size=(7, 2)).astype(np.float32)
    assert tfn.n_teachers == 9
    np.testing.assert_allclose(tfn(torch.from_numpy(x)).numpy(),
                               np.asarray(jfn(x)), rtol=0, atol=1e-5)


def _trained_stack(k):
    """K copies of one mlp fitted to blobs (well above chance), each
    nudged a little."""
    ds = gaussian_mixture(600, seed=6)
    jn = jnets.mlp(2, 3, (16,))
    p = jn.init(jax.random.PRNGKey(0))
    bx, by = jclient.build_batches(ds.x, ds.y, 32, 3, seed=0)
    p = jclient.make_local_update(jn, jopt.sgd(0.1))(
        p, jnp.asarray(bx), jnp.asarray(by), p)
    rng = np.random.default_rng(7)
    stack = jax.tree.map(lambda a: (np.asarray(a)[None] + 0.01 * rng.normal(
        size=(k,) + a.shape)).astype(np.float32), p)
    return jn, stack, ds


def test_drop_worst_stacked_matches_jax():
    """Two clients at chance (last layer zeroed: every prediction is class
    0) are dropped; the others stay, with their weights."""
    jn, stack, ds = _trained_stack(5)
    for k in (1, 3):
        stack["dense_1"]["w"][k] = 0
        stack["dense_1"]["b"][k] = 0
    w = [10.0, 20.0, 30.0, 40.0, 50.0]
    jkept, jw, ji = jdrop.drop_worst_stacked(jn, stack, w, ds.x, ds.y, 3)
    tkept, tw, ti = tdrop.drop_worst_stacked(
        tnets.mlp(2, 3, (16,)), convert.to_torch(stack), w,
        torch.from_numpy(ds.x), torch.from_numpy(ds.y), 3)
    assert ti == ji == [0, 2, 4]
    assert tw == jw == [10.0, 30.0, 50.0]
    assert_tree_close(tkept, jax.tree.map(np.asarray, jkept), 0)
    # the list form agrees
    trees = [jax.tree.map(lambda a: a[k], stack) for k in range(5)]
    tl = tdrop.drop_worst(tnets.mlp(2, 3, (16,)),
                          [convert.to_torch(t) for t in trees], w,
                          torch.from_numpy(ds.x), torch.from_numpy(ds.y), 3)
    assert tl[2] == jdrop.drop_worst(jn, trees, w, ds.x, ds.y, 3)[2] == ji


def test_drop_worst_keeps_the_argmax_when_all_are_at_chance():
    """Every client predicts one class (last layer zeroed, one-hot bias):
    each scores that class's share, all under 1.5 x chance; the first
    client of the most frequent class survives."""
    jn, stack, ds = _trained_stack(4)
    stack["dense_1"]["w"][:] = 0
    stack["dense_1"]["b"][:] = 0
    for k, cls in enumerate([0, 1, 2, 1]):
        stack["dense_1"]["b"][k, cls] = 1.0
    counts = np.bincount(ds.y, minlength=3)
    assert counts.max() / len(ds.y) < 0.5
    w = [1.0, 2.0, 3.0, 4.0]
    _, jw, ji = jdrop.drop_worst_stacked(jn, stack, w, ds.x, ds.y, 3)
    tkept, tw, ti = tdrop.drop_worst_stacked(
        tnets.mlp(2, 3, (16,)), convert.to_torch(stack), w,
        torch.from_numpy(ds.x), torch.from_numpy(ds.y), 3)
    best = [0, 1, 2, 1][int(np.argmax(counts))]
    assert ti == ji == [best]
    assert tw == jw == [w[best]]
    assert tree_flatten(tkept)["dense_1/b"].shape == (1, 3)


def _clients(dim=2):
    ds = gaussian_mixture(500, dim=dim, seed=2)
    parts = dirichlet_partition(ds.y, 5, 0.3, seed=2)[:4]
    return ds, parts, [21, 22, 23, 24]


def test_binarized_2d_mlp_has_exact_ties_at_init():
    """Why the binarized runs are held on 4-D inputs: with 2-D inputs the
    binarized first layer has four distinct columns (the sign patterns of
    its 2 rows), so at the zero-bias init over a tenth of the
    second-layer pre-activations cancel to within 1e-6 of the largest
    (in float64, from JAX's binarized weights): zero up to the last bits
    of the weights, so the order of the float32 sums decides their ReLU
    gate, and the step's gradient moves with that order by O(0.1).  With
    4-D inputs under a hundredth do."""
    def near_ties(dim):
        ds = gaussian_mixture(64, dim=dim, seed=2)
        jp = jnets.mlp(dim, 3, (16, 16)).init(jax.random.PRNGKey(3))
        q = jax.tree.map(lambda a: np.asarray(a, np.float64),
                         jquant.binarize(jp))
        h = np.maximum(ds.x @ q["dense_0"]["w"] + q["dense_0"]["b"], 0)
        z = np.abs(h @ q["dense_1"]["w"] + q["dense_1"]["b"])
        return (z <= 1e-6 * z.max()).mean()
    assert near_ties(2) > 0.1
    assert near_ties(4) < 0.01


def test_single_teacher_fusion_is_rounding_noise_in_jax():
    """Why the drop-worst run keeps two survivors: FedDF over ONE teacher
    starts the student as that teacher, so the KL gradient is zero in
    exact arithmetic; Adam divides the float32 residue by its own root
    mean square, and a student moved by one unit in the last place ends
    more than 1e-3 away from the unmoved one, in the JAX package alone."""
    jn, stack, ds = _trained_stack(1)
    pool = np.random.default_rng(9).uniform(-3, 3, (300, 2)).astype(
        np.float32)
    from repro.data.distill_sources import UnlabeledDataset
    fusion = jfeddf.FusionConfig(max_steps=40, patience=40, eval_every=20,
                                 batch_size=32, logit_bank="on")
    runs = []
    for nudge in (False, True):
        student = jax.tree.map(lambda a: np.asarray(a[0]), stack)
        if nudge:
            student = jax.tree.map(
                lambda a: np.nextafter(a, np.float32(np.inf)), student)
        p, _ = jfeddf.feddf_fuse_stacked(jn, stack, [1.0],
                                         UnlabeledDataset(pool), fusion,
                                         student=student)
        runs.append(jax.tree.leaves(p))
    assert max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(*runs)) > 1e-3


@pytest.mark.parametrize("what", ["binarize", "dp"])
def test_batched_update_matches_jax_sequential(what):
    """All four clients in one batched update (binarized forwards; or DP
    uploads with JAX's per-client draws) against JAX's sequential
    ``make_local_update`` client by client, followed for DP by JAX's
    ``privatize_update`` keyed as its engine keys it.  Binarized on 4-D
    inputs (see the exact-ties test)."""
    dim = 4 if what == "binarize" else 2    # see the exact-ties test
    ds, parts, seeds = _clients(dim)
    xb, yb, mask = tclient.build_batched_batches(ds.x, ds.y, parts, 16, 2,
                                                 seeds)
    assert len(set(mask.sum(axis=1).tolist())) > 1  # padded steps are hit
    jn, tn = jnets.mlp(dim, 3, (16, 16)), tnets.mlp(dim, 3, (16, 16))
    jp = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(3)))
    tp = convert.to_torch(jp)
    dp = dict(dp_clip=0.5, dp_noise_multiplier=0.2,
              dp_draws=jax_dp_draws) if what == "dp" else {}
    update = tclient.make_batched_local_update(
        tn, topt.sgd(0.05),
        quantize=tquant.binarize if what == "binarize" else None, **dp)
    dp_seeds = [100 + k for k in range(4)]
    stack = tree_flatten(update(tp, torch.from_numpy(xb),
                                torch.from_numpy(yb), tp,
                                torch.from_numpy(mask), dp_seeds))
    seq = jclient.make_local_update(
        jn, jopt.sgd(0.05),
        quantize=jquant.binarize if what == "binarize" else None)
    # the port's own sequential reference takes the quantizer too
    tseq = tclient.make_local_update(
        tn, topt.sgd(0.05),
        quantize=tquant.binarize if what == "binarize" else None)
    for k, (idx, s) in enumerate(zip(parts, seeds)):
        bx, by = jclient.build_batches(ds.x[idx], ds.y[idx], 16, 2, seed=s)
        want = seq(jp, jnp.asarray(bx), jnp.asarray(by), jp)
        if what == "dp":
            want = jpriv.privatize_update(
                jp, want, clip=0.5, noise_multiplier=0.2,
                key=jax.random.PRNGKey(dp_seeds[k]))
        else:
            assert_tree_close(tseq(tp, torch.from_numpy(bx),
                                   torch.from_numpy(by), tp), want, 1e-5)
        assert_tree_close({p: v[k] for p, v in stack.items()}, want, 1e-5)


def test_batched_dp_update_needs_its_seeds():
    tn = tnets.mlp(2, 3, (4,))
    tp = tn.init(torch.Generator().manual_seed(0))
    update = tclient.make_batched_local_update(tn, topt.sgd(0.1),
                                               dp_clip=1.0)
    x = torch.zeros(2, 1, 4, 2)
    with pytest.raises(ValueError, match="seed"):
        update(tp, x, torch.zeros(2, 1, 4, dtype=torch.int64), tp,
               torch.ones(2, 1, dtype=torch.bool))


def test_evaluate_with_quantize_matches_jax():
    ds = gaussian_mixture(700, seed=8)
    jn, tn = jnets.mlp(2, 3, (16, 16)), tnets.mlp(2, 3, (16, 16))
    jp = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(1)))
    got = tclient.evaluate(tn, convert.to_torch(jp), torch.from_numpy(ds.x),
                           torch.from_numpy(ds.y), quantize=tquant.binarize)
    assert got == jclient.evaluate(jn, jp, ds.x, ds.y,
                                   quantize=jquant.binarize)
    assert got != tclient.evaluate(tn, convert.to_torch(jp),
                                   torch.from_numpy(ds.x),
                                   torch.from_numpy(ds.y))


# -- whole runs --------------------------------------------------------------

FUSION = {"max_steps": 60, "patience": 40, "eval_every": 20,
          "batch_size": 32}
# Drop-worst at Table 3's instability settings (alpha 0.3, local lr 0.2,
# benchmarks/table3_dropworst.py), seed 2: one of the three uploads drops
# each round and two survive.  Where one survives (seed 0), the student
# starts AS its only teacher, the KL gradient is zero in exact arithmetic
# and Adam normalises rounding noise into lr-sized steps, in both packages
# (test_single_teacher_fusion_is_rounding_noise_in_jax).
# Binarized clients on 4-D blobs: on 2-D inputs the binarized first layer
# has only four distinct columns, so second-layer pre-activations are
# exactly zero at the zero-bias init and float32 summation order decides
# their ReLU gate (test_binarized_2d_mlp_has_exact_ties_at_init).
ABLATIONS = {
    "drop_worst": {"strategy": {"name": "feddf", "drop_worst": True,
                                "fusion": FUSION},
                   "partition": {"n_clients": 6, "alpha": 0.3},
                   "local_lr": 0.2, "seed": 2},
    "binarize": {"privacy": {"clip": None, "noise_multiplier": 0.0,
                             "quantizer": "binarize"},
                 "task": {"name": "blobs", "n_samples": 600,
                          "params": {"dim": 4}}},
    "dp": {"privacy": {"clip": 5.0, "noise_multiplier": 0.01,
                       "quantizer": None}},
    "swag_bank": {"strategy": {"name": "feddf", "fusion": {
        **FUSION, "swag_samples": 5, "swag_scale": 0.5}}},
    "swag_fly": {"strategy": {"name": "feddf", "fusion": {
        **FUSION, "swag_samples": 5, "swag_scale": 0.5}},
        "source": {"name": "generator", "params": {"latent_dim": 8}}},
}


def ablation_spec(pkg, name):
    d = tiny_spec(pkg).to_dict()
    d.update(ABLATIONS[name])
    return pkg.ExperimentSpec.from_dict(d)


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_spec_matches_jax_round_by_round(name, monkeypatch):
    from repro_torch.api import experiment as texp
    from repro_torch.data.distill_sources import GeneratorSource
    jspec = ablation_spec(japi, name)
    jres = japi.Experiment(jspec).run()
    bundle = japi.build_task_bundle(jspec)
    jnet = japi.build_cohort(jspec, bundle)[0][0]
    init = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(jspec.seed)))
    streams = {}
    if name == "swag_fly":
        jsrc = japi.build_source(jspec, bundle,
                                 japi.build_splits(jspec, bundle)[0])
        monkeypatch.setattr(texp, "build_source", lambda s, b, t, device:
                            GeneratorSource(
                                (2,), latent_dim=8, hidden=jsrc.hidden,
                                mean=jsrc.mean, std=jsrc.std, device=device,
                                w1=np.asarray(jsrc._w1),
                                w2=np.asarray(jsrc._w2)))
        streams["draw_stream"] = jax_latent_stream(8)
    else:
        streams["index_stream"] = jax_index_stream(300)
    if name == "dp":
        streams["dp_noise_stream"] = jax_dp_draws
    if name.startswith("swag"):
        streams["swag_draw_stream"] = jax_swag_draws
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    tres = tapi.Experiment(tspec, device="cpu").run(
        init_globals=[convert.to_torch(init)], **streams)
    n_test = int(600 * 0.2)
    assert len(tres.result.logs) == len(jres.result.logs) == 2
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        assert tl.bank == jl.bank
        assert tl.distill_steps == jl.distill_steps
        assert tl.n_participants == jl.n_participants
        assert tl.n_dropped == jl.n_dropped
        assert tl.teacher_forwards == jl.teacher_forwards
        assert abs(tl.test_acc - jl.test_acc) <= 1.0 / n_test + 1e-12
    assert_tree_close(tres.global_params[0], jres.global_params[0], 1e-4)
    logs = tres.result.logs
    if name == "drop_worst":               # the knob did something
        assert all(0 < l.n_dropped < l.n_dropped + l.n_participants
                   for l in logs)
    if name == "swag_fly":                 # 5 SWAG teachers every step
        assert all(l.teacher_forwards == (l.n_participants + 5)
                   * l.distill_steps for l in logs)


@pytest.mark.parametrize("stream", ["dp_noise_stream", "swag_draw_stream"])
def test_run_refuses_a_draw_stream_without_its_knob(stream):
    spec = tiny_spec(tapi)
    with pytest.raises(ValueError, match=stream):
        tapi.Experiment(spec, device="cpu").run(**{stream: jax_dp_draws})


def test_ablation_specs_validate_in_the_port():
    """The four knobs no longer raise; an unknown quantizer does."""
    for name in ABLATIONS:
        spec = ablation_spec(tapi, name)
        assert spec.validate() is spec
    d = tiny_spec(tapi).to_dict()
    d["privacy"] = {"clip": None, "noise_multiplier": 0.0,
                    "quantizer": "ternary"}
    with pytest.raises(ValueError, match="quantizer"):
        tapi.ExperimentSpec.from_dict(d).validate()


# -- K2 at SWAG's K = 13 on the card -----------------------------------------

def _card_with_nvcc():
    if not torch.cuda.is_available():
        return "needs a CUDA card (the CUDA kernel has no CPU mode)"
    if torch.cuda.get_device_capability(0) < (9, 0):
        return "needs an sm_90 card (the kernels build for sm_90a)"
    from repro_torch.kernels import build
    try:
        build.nvcc()
    except RuntimeError:
        return "needs nvcc to build the kernel"
    return None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("temp", [1.0, 2.5])
def test_k2_at_thirteen_teachers_matches_plain_on_card(dtype_name, temp):
    """The quickstart's 8 uploads + 5 SWAG teachers over a distill batch
    of 64 rows of 3 classes: lane groups, the 8-teacher load template run
    twice, 3 live slots the second time.  K2's tolerances (forward rtol
    1e-5 / atol 1e-6, gradient rtol 1e-4 / atol 1e-7); two launches equal
    bit for bit."""
    why = _card_with_nvcc()
    if why:
        pytest.skip(why)
    from repro_torch.kernels import ensemble_kl as k2
    from repro_torch.kernels import ops, ref
    assert k2.plan(13, 64, 3).mode == "lanes"
    assert k2.plan(13, 64, 3).teacher_batch == 8
    gen = torch.Generator().manual_seed(13)
    s = (torch.randn(64, 3, generator=gen) * 3).cuda()
    t = (torch.randn(13, 64, 3, generator=gen) * 3).to(
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
