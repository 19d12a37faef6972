"""The port's sharding rules (``repro_torch.common.sharding``) against the
JAX package's ``repro.common.sharding``, in-process, on the CPU.

The rules, ``logical_to_pspec`` / ``tree_pspecs`` over every zoo config's
logical parameter axes, ``fit_pspec`` and ``kv_cache_rules`` are pure
logic: both packages must return the same tables and the same
partition specs, exactly.  JAX's ``fit_pspec`` reads only
``mesh.shape[axis]``, so a stub exposing ``shape`` stands in for a mesh
in both packages."""
import itertools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.common import sharding as jshd
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.common import sharding as shd
from repro_torch.models import transformer as T

LAYOUTS = ("tp", "dp_heavy", "dp_heavy_z3")
ZOO = sorted(configs.REGISTRY)


class StubMesh:
    """Only what ``fit_pspec`` reads: the axis sizes by name."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = (StubMesh(data=2, model=1), StubMesh(data=16, model=16),
          StubMesh(data=3, model=4), StubMesh(pod=2, data=16, model=16),
          StubMesh(pod=2, data=3, model=5))


def _rule_sets():
    for layout, multi_pod, fsdp, cache, clients in itertools.product(
            LAYOUTS, (False, True), (False, True), (False, True),
            (False, True)):
        yield dict(layout=layout, multi_pod=multi_pod, fsdp=fsdp,
                   shard_cache_seq=cache, shard_clients=clients)


def _jflat(tree):
    """{path: tuple(PartitionSpec)} of a JAX tree of specs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(v) for path, v in leaves}


def _tflat(tree, prefix=""):
    if isinstance(tree, shd.PartitionSpec):
        return {prefix: tuple(tree)}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_tflat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_rules_match_jax(layout, multi_pod):
    for fsdp, cache, clients in itertools.product((False, True), repeat=3):
        kw = dict(layout=layout, multi_pod=multi_pod, fsdp=fsdp,
                  shard_cache_seq=cache, shard_clients=clients)
        assert shd.make_rules(**kw) == jshd.make_rules(**kw), kw
    extra = {"vocab": (), "seq": ("model",)}
    assert shd.make_rules(layout=layout, multi_pod=multi_pod, extra=extra) \
        == jshd.make_rules(layout=layout, multi_pod=multi_pod, extra=extra)


def test_logical_to_pspec_matches_jax_on_conflicts():
    rules = shd.make_rules(shard_clients=True, layout="dp_heavy")
    for logical in (("clients", "batch", None), ("batch", "embed", "vocab"),
                    ("embed", "embed"), (None,), ("heads", "mlp", "qkv"),
                    ("unknown", "batch")):
        got = shd.logical_to_pspec(logical, rules)
        want = jshd.logical_to_pspec(logical, rules)
        assert isinstance(got, shd.PartitionSpec)
        assert tuple(got) == tuple(want), logical


@pytest.mark.parametrize("name", ZOO)
def test_tree_pspecs_over_zoo_config_match_jax(name):
    """Every zoo config's parameter specs under every rule set."""
    logical_t = T.logical(configs.get(name))
    logical_j = JT.logical(jconfigs.get(name))
    for kw in _rule_sets():
        rules = shd.make_rules(**kw)
        got = _tflat(shd.tree_pspecs(logical_t, rules))
        want = _jflat(jshd.tree_pspecs(logical_j, jshd.make_rules(**kw)))
        assert got == want, (name, kw)


@pytest.mark.parametrize("name", ["qwen3-8b", "zamba2-1.2b",
                                  "granite-moe-1b-a400m", "gemma3-4b"])
def test_fit_pspec_matches_jax(name):
    """Each leaf's spec fitted to its shape on meshes whose axes divide
    some dims and not others (trimmed from the right, or dropped)."""
    cfg_t, cfg_j = configs.get(name), jconfigs.get(name)
    shapes = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path): tuple(s.shape)
              for path, s in jax.tree_util.tree_flatten_with_path(
                  JT.param_specs(cfg_j),
                  is_leaf=lambda x: hasattr(x, "logical"))[0]}
    for kw in _rule_sets():
        specs_t = _tflat(shd.tree_pspecs(T.logical(cfg_t),
                                         shd.make_rules(**kw)))
        specs_j = _jflat(jshd.tree_pspecs(JT.logical(cfg_j),
                                          jshd.make_rules(**kw)))
        for mesh in MESHES:
            if kw["multi_pod"] != ("pod" in mesh.shape):
                continue
            for path, shape in shapes.items():
                got = shd.fit_pspec(shd.P(*specs_t[path]), shape, mesh)
                want = jshd.fit_pspec(JP(*specs_j[path]), shape, mesh)
                assert tuple(got) == tuple(want), (name, kw, path, shape)


def test_fit_pspec_trims_tuples_from_the_right():
    mesh = StubMesh(pod=2, data=3, model=4)
    for spec, shape in (((("pod", "data"), "model"), (12, 8)),
                        ((("pod", "data"), None), (4, 3)),
                        ((("pod", "data", "model"),), (6,)),
                        (("model", ("pod", "data")), (5, 7)),
                        (("data",), (9, 2))):
        got = shd.fit_pspec(shd.P(*spec), shape, mesh)
        want = jshd.fit_pspec(JP(*spec), shape, mesh)
        assert tuple(got) == tuple(want), (spec, shape)
    # the struct-tree form walks dicts and tuples alike
    tree = {"a": (shd.P("data", "model"), shd.P(None))}
    structs = {"a": (np.zeros((6, 8)), np.zeros((5,)))}
    fitted = shd.fit_pspecs(tree, structs, mesh)
    assert tuple(fitted["a"][0]) == ("data", "model")
    assert tuple(fitted["a"][1]) == (None,)


@pytest.mark.parametrize("batch,data_size", [(1, 16), (32, 16), (16, 16)])
def test_kv_cache_rules_match_jax(batch, data_size):
    for kw in _rule_sets():
        got = shd.kv_cache_rules(shd.make_rules(**kw), batch=batch,
                                 data_size=data_size)
        want = jshd.kv_cache_rules(jshd.make_rules(**kw), batch=batch,
                                   data_size=data_size)
        assert got == want, kw


def test_axis_size_reads_names_from_a_stub():
    assert shd.axis_size(StubMesh(data=3, model=2), "model") == 2
    assert shd.axis_names(StubMesh(pod=2, data=1)) == ("pod", "data")


def test_tensor_digest_moves_with_any_element():
    import torch
    a = torch.arange(1000, dtype=torch.float32)
    b = a.clone()
    assert shd.tensor_digest(a) == shd.tensor_digest(b)
    for i in (0, 499, 999):
        c = a.clone()
        c[i] = torch.nextafter(c[i], torch.tensor(1e9))
        assert shd.tensor_digest(c) != shd.tensor_digest(a), i
    # a permutation of equal values is another digest
    assert shd.tensor_digest(a.flip(0)) != shd.tensor_digest(a)
    bf = a.to(torch.bfloat16)
    assert shd.tensor_digest(bf) == shd.tensor_digest(bf.clone())
    assert shd.tree_digest({"x": a, "y": (bf,)}) == \
        shd.tree_digest({"x": b, "y": (bf.clone(),)})


CACHE_MESHES = (StubMesh(data=2, model=2), StubMesh(data=16, model=16),
                StubMesh(data=3, model=4), StubMesh(data=4, model=1))


def _cache_leaves(tree) -> list:
    """(field, spec) of each cache leaf in layer order (both packages'
    trees: a dict of tuples of KVCache / SSMCache)."""
    return [(f, tuple(x)) for group in (tree["blocks"], tree["tail"])
            for c in group if c for f, x in zip(c._fields, c)]


@pytest.mark.parametrize("batch,max_seq", [(1, 32768), (32, 32768),
                                           (16, 4001)])
def test_cache_pspecs_match_jax(batch, max_seq):
    """``T.cache_pspecs`` (the serve step's decode caches) against JAX's
    ``fit_pspecs(tree_pspecs(cache_logical(cfg), kv_cache_rules(...)))``
    for every decoder of the zoo: attention caches and SSM states the
    same specs (an SSM state's heads split as its layer's ``A_log``, which
    JAX's fit gives too wherever the port's heads split); the conv
    history's batch as JAX's, its channels by segment (``Segmented``)
    over the axis JAX splits them over, or whole where the layer's heads
    stay whole."""
    import jax.numpy as jnp
    for name in ZOO:
        cfg, cj = configs.get(name), jconfigs.get(name)
        if not cfg.is_decoder or cfg.frontend != "none":
            continue
        for mesh in CACHE_MESHES:
            rules = shd.make_rules(fsdp=True)
            got = _cache_leaves(T.cache_pspecs(
                cfg, shd.kv_cache_rules(rules, batch=batch,
                                        data_size=mesh.shape["data"]),
                mesh, batch, max_seq, T.param_pspecs(cfg, rules, mesh)))
            structs = jax.eval_shape(lambda: JT.init_caches(
                cj, batch, max_seq, jnp.float32))
            want = _cache_leaves(jshd.fit_pspecs(jshd.tree_pspecs(
                JT.cache_logical(cj), jshd.kv_cache_rules(
                    jshd.make_rules(fsdp=True), batch=batch,
                    data_size=mesh.shape["data"])), structs, mesh))
            assert [f for f, _ in got] == [f for f, _ in want], name
            for (field, g), (_, w) in zip(got, want):
                if field != "conv":
                    assert g == w, (name, mesh.shape, field, g, w)
                    continue
                assert g[:-1] == w[:-1], (name, g, w)
                assert g[-1] is None or (
                    isinstance(g[-1], shd.Segmented)
                    and g[-1].axis == w[-1]
                    and g[-1].split == (True, False, False)), (name, g, w)
