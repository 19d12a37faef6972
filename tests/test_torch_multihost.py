"""The client axis over a ``torch.distributed`` mesh: the ``multihost``
driver, ``sharding.shard_clients``, a sharded logit bank and
``drive_fed_rounds``, on gloo ranks on the CPU, against the JAX package.

One module-scoped ``launch_ranks`` of 4 ranks runs every case of
:func:`rank_suite` (port code only: this module imports JAX inside the
parent's functions alone, so a spawned rank that imports it stays free
of JAX), plus a world of 2 ranks (``make_host_mesh(2, 1)``) and one of
1 rank in this process.
The parent computes the references:

* the JAX package's own ``multihost`` test spec (``gaussian_mixture(1200,
  3, 2)``, 8 clients, C = 0.5, ``fedavg``, 2 rounds) and a ``feddf``
  variant on the logit bank: each round's test accuracy equals JAX's
  ``sync``; the globals stay within ``tests/test_torch_slice.py``'s
  1e-4 of JAX's; a 1-rank mesh equals the port's ``sync`` bit for bit.
  JAX's init and distillation indices are injected;
* ``drive_fed_rounds`` on reduced qwen3-8b (over ``make_host_mesh(4,
  1)``, ``(2, 1)`` and ``(2, 2)``, the last tensor-parallel within each
  client), and reduced granite-moe over ``(2, 2)`` (each client's MoE
  expert-parallel over "model"): JAX's own loop does not run under the
  installed JAX
  (``ShardingTypeError`` at the embedding take, on any mesh), so it is
  held against a loop over JAX's ``make_fed_round_step(...).jit()`` on a
  1 x 1 mesh and a numpy mean, within ``tests/test_torch_steps.py``'s
  1e-5 of each leaf's largest value.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as tmesh

ROUNDS = 2
SEED = 0
FUSION = dict(max_steps=60, patience=40, eval_every=20, batch_size=32,
              logit_bank="on")
FED = dict(n_clients=4, local_steps=2, batch_size=2, seq_len=16)
PARAM_ATOL = 1e-4          # tests/test_torch_slice.py's bound on globals
STEP_REL = 1e-5            # tests/test_torch_steps.py's bound
SPREAD_FACTOR = 4.0        # tests/test_torch_steps.py's
MOE_ARCH = "granite-moe-1b-a400m"
RANK_TIMEOUT_S = 300


class Replay:
    """A distillation index stream replayed from blocks the parent drew
    with JAX: ``(seed, batch_size, chunk) -> iterator``."""

    def __init__(self, blocks):
        self.blocks = blocks

    def __call__(self, seed, batch_size, chunk):
        yield from self.blocks[int(seed)]


# ---------------------------------------------------------------------------
# what the ranks run (port code only)
# ---------------------------------------------------------------------------

def _data(n_clients=8):
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import (gaussian_mixture,
                                            train_val_test_split)
    ds = gaussian_mixture(1200, n_classes=3, dim=2, seed=0)
    train, val, test = train_val_test_split(ds)
    return train, val, test, dirichlet_partition(train.y, n_clients, 1.0,
                                                 seed=0)


def _pool():
    return np.random.default_rng(1).uniform(-3, 3, (256, 2)).astype(
        np.float32)


def run_case(driver, strategy, init, blocks=None, fraction=0.5,
             hetero=False, bucket="none"):
    """The JAX multihost test's run through the port's ``run_rounds``;
    returns (per-group test accuracies, per-group logs' facts, globals as
    numpy, the engine's client caps)."""
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.core.engine import BucketConfig
    from repro_torch.core.feddf import FusionConfig
    from repro_torch.core.nets import mlp
    from repro_torch.core.server import FLConfig, run_rounds
    from repro_torch.data.distill_sources import UnlabeledDataset
    train, val, test, parts = _data()
    cfg = FLConfig(strategy=strategy, rounds=ROUNDS, client_fraction=fraction,
                   local_epochs=2, local_batch_size=32, local_lr=0.05,
                   seed=SEED, fusion=FusionConfig(**FUSION),
                   bucketing=BucketConfig(kind=bucket))
    nets = [mlp(2, 3, hidden=(16,))] + ([mlp(2, 3, hidden=(16, 16))]
                                        if hetero else [])
    proto = [k % len(nets) for k in range(len(parts))]
    source = None if blocks is None else UnlabeledDataset(
        _pool(), indices=Replay(blocks))
    caps = []
    from repro_torch.core import engine as eng
    seen = eng.RoundEngine._train_bucket

    def recording(self, p, global_, bb):
        caps.append((p, bb.k_real, bb.cap_clients))
        return seen(self, p, global_, bb)
    eng.RoundEngine._train_bucket = recording
    try:
        res, globals_, _ = run_rounds(
            nets, proto, train, parts, val, test, cfg, source=source,
            heterogeneous=hetero, device="cpu", init_globals=init,
            driver=driver)
    finally:
        eng.RoundEngine._train_bucket = seen
    facts = [[(l.distill_steps, l.bank, l.n_participants) for l in r.logs]
             for r in res]
    acc = [[l.test_acc for l in r.logs] for r in res]
    flat = [{k: v.numpy() for k, v in tree_flatten(g).items()}
            for g in globals_]
    return acc, facts, flat, caps


def bank_case():
    """A sharded bank against the unsharded one on this rank: the full
    rows and a gather by index, float32 and int8; a pool that the axis
    does not divide raises, as JAX's ``device_put`` does."""
    from repro_torch.common.sharding import NamedSharding, P
    from repro_torch.core.feddf import make_teacher_logits_fn
    from repro_torch.core.logit_bank import build_logit_bank
    from repro_torch.core.nets import mlp
    from repro_torch.common.pytree import tree_stack
    net = mlp(4, 5, hidden=(16,))
    stack = tree_stack([net.init(torch.Generator().manual_seed(i))
                        for i in range(3)])
    tfn = make_teacher_logits_fn(net, stack)
    mesh = tmesh.make_client_mesh()
    out = []
    for n, dtype in ((512, "float32"), (256, "int8")):
        pool = torch.as_tensor(np.random.default_rng(0).uniform(
            -3, 3, (n, 4)).astype(np.float32))
        plain = build_logit_bank([tfn], pool, dtype=dtype)
        sharded = build_logit_bank([tfn], pool, dtype=dtype,
                                   sharding=NamedSharding(mesh, P("data")))
        full = sharded.full()
        idx = np.random.default_rng(2).integers(0, n, 97)
        rows, scales = sharded.gather(idx)
        out.append({
            "n": n, "dtype": dtype, "local_rows": int(sharded.logits.shape[0]),
            "block": sharded.block, "bank_n": sharded.n,
            "rows_equal": torch.equal(full.logits, plain.logits),
            "pool_equal": torch.equal(full.pool, plain.pool),
            "scales_equal": (full.scales is None and plain.scales is None)
            or torch.equal(full.scales, plain.scales),
            "gather_equal": torch.equal(rows, plain.logits[idx])
            and (scales is None or torch.equal(scales, plain.scales[idx]))})
    uneven = [_raises(lambda n: build_logit_bank(
        [tfn], torch.zeros(n, 4), sharding=NamedSharding(mesh, P("data"))),
        n) for n in (9, 513)]
    return out, uneven


def fed_case(hosts, model, init, arch="qwen3-8b"):
    """``drive_fed_rounds`` on reduced ``arch`` over ``make_host_mesh``."""
    from repro_torch import configs
    from repro_torch.common.arch_config import reduced
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.drivers import drive_fed_rounds
    ct = reduced(configs.get(arch))
    mesh = tmesh.make_host_mesh(hosts, model)
    params, stats = drive_fed_rounds(ct, mesh, rounds=ROUNDS, seed=SEED,
                                     init_params=init, **FED)
    return ({k: v.float().numpy() for k, v in tree_flatten(params).items()},
            stats)


def _raises(fn, *args):
    try:
        fn(*args)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def rank_suite(refs):
    """Every case of a 4-rank world on one rank; the parent compares."""
    out = {"rank": tmesh.world_rank()}
    out["fedavg"] = run_case("multihost", "fedavg", refs["init"])
    out["feddf"] = run_case("multihost", "feddf", refs["init"],
                            refs["blocks"])
    out["indivisible"] = _raises(run_case, "multihost", "fedavg",
                                 refs["init"], None, 0.375)
    out["hetero"] = run_case("multihost", "fedavg", refs["hetero_init"],
                             hetero=True, bucket="pow2")
    out["bank"] = bank_case()
    out["fed_4x1"] = fed_case(4, 1, refs["fed_init"])
    out["fed_2x2"] = fed_case(2, 2, refs["fed_init"])
    out["fed_2x2_moe"] = fed_case(2, 2, refs["moe_init"], MOE_ARCH)
    return out


def one_rank_suite(refs):
    """A 1-rank world, in this process."""
    with tmesh.one_rank_world("cpu"):
        return {"fedavg": run_case("multihost", "fedavg", refs["init"]),
                "feddf": run_case("multihost", "feddf", refs["init"],
                                  refs["blocks"])}


def two_rank_suite(refs):
    return fed_case(2, 1, refs["fed_init"])


def failing_rank():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


# ---------------------------------------------------------------------------
# the parent: JAX's references and the comparisons
# ---------------------------------------------------------------------------

def _jax_refs():
    import jax
    from repro import configs as jconfigs
    from repro.common.arch_config import reduced as jreduced
    from repro.core import mlp as jmlp
    from repro.data.distill_sources import UnlabeledDataset
    from repro.models import transformer as JT
    from repro_torch import convert
    src = UnlabeledDataset(_pool())
    n_steps = FUSION["max_steps"] + FUSION["eval_every"]

    @jax.jit
    def draws(key):
        """The distillation's draws, one split per step (as its loop)."""
        def step(key, _):
            key, k1 = jax.random.split(key)
            return key, src.sample_indices(k1, FUSION["batch_size"])
        return jax.lax.scan(step, key, None, length=n_steps)[1]

    blocks = {seed: np.array(draws(jax.random.PRNGKey(seed))).reshape(
        -1, FUSION["eval_every"], FUSION["batch_size"])
        for seed in range(SEED + 1, SEED + ROUNDS + 1)}  # cfg.seed + t
    to_t = lambda t: convert.to_torch(jax.tree.map(np.asarray, t))
    init = [to_t(jmlp(2, 3, hidden=(16,)).init(jax.random.PRNGKey(SEED)))]
    hetero = [to_t(jmlp(2, 3, hidden=h).init(jax.random.PRNGKey(SEED + p)))
              for p, h in enumerate(((16,), (16, 16)))]
    cj = jreduced(jconfigs.get("qwen3-8b"))
    fed = jax.jit(lambda key: JT.init(cj, key, jax.numpy.float32))(
        jax.random.PRNGKey(SEED))
    cm = jreduced(jconfigs.get(MOE_ARCH))
    moe = jax.jit(lambda key: JT.init(cm, key, jax.numpy.float32))(
        jax.random.PRNGKey(SEED))
    return {"init": init, "hetero_init": hetero, "blocks": blocks,
            "fed_init": to_t(fed), "moe_init": to_t(moe)}, fed, cj, moe, cm


@pytest.fixture(scope="module")
def world():
    """Every rank world's results, and the parent's references."""
    refs, fed_j, cj, moe_j, cm = _jax_refs()
    threads = max(1, (os.cpu_count() or 4) // 4)
    four = tmesh.launch_ranks(rank_suite, 4, "cpu", args=(refs,),
                              timeout_s=RANK_TIMEOUT_S, threads=threads)
    two = tmesh.launch_ranks(two_rank_suite, 2, "cpu", args=(refs,),
                             timeout_s=RANK_TIMEOUT_S, threads=2 * threads)
    return {"refs": refs, "four": four, "two": two,
            "one": one_rank_suite(refs),
            "fed_j": fed_j, "cj": cj, "moe_j": moe_j, "cm": cm}


def _jax_run(strategy, hetero=False, fraction=0.5):
    import jax
    from repro.core import FLConfig, FusionConfig, mlp, run_rounds
    from repro.core.engine import BucketConfig
    from repro.data import (dirichlet_partition, gaussian_mixture,
                            train_val_test_split)
    from repro.data.distill_sources import UnlabeledDataset
    ds = gaussian_mixture(1200, n_classes=3, dim=2, seed=0)
    train, val, test = train_val_test_split(ds)
    parts = dirichlet_partition(train.y, 8, 1.0, seed=0)
    cfg = FLConfig(strategy=strategy, rounds=ROUNDS,
                   client_fraction=fraction, local_epochs=2,
                   local_batch_size=32, local_lr=0.05, seed=SEED,
                   fusion=FusionConfig(**FUSION),
                   bucketing=BucketConfig(kind="pow2" if hetero
                                          else "none"))
    nets = [mlp(2, 3, hidden=(16,))] + ([mlp(2, 3, hidden=(16, 16))]
                                        if hetero else [])
    source = None if strategy != "feddf" else UnlabeledDataset(_pool())
    res, globals_, _ = run_rounds(
        nets, [k % len(nets) for k in range(8)], train, parts, val, test,
        cfg, source=source, heterogeneous=hetero, driver="sync")
    acc = [[l.test_acc for l in r.logs] for r in res]
    facts = [[(l.distill_steps, l.bank, l.n_participants) for l in r.logs]
             for r in res]
    flat = [{"/".join(str(p.key) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(g)[0]}
            for g in globals_]
    return acc, facts, flat


def _close(got, want, atol):
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("strategy", ["fedavg", "feddf"])
def test_multihost_over_4_ranks_matches_jax_sync(world, strategy):
    acc_j, facts_j, flat_j = _jax_run(strategy)
    for r in world["four"]:
        acc, facts, flat, _ = r[strategy]
        assert acc == acc_j, (r["rank"], acc, acc_j)
        assert facts == facts_j
        _close(flat, flat_j, PARAM_ATOL)
    if strategy == "feddf":
        assert all(b == "bank" for b in (f[1] for f in facts_j[0]))


@pytest.mark.parametrize("strategy", ["fedavg", "feddf"])
def test_ranks_agree_and_one_rank_equals_the_port_sync(world, strategy):
    """Every rank returns the same globals, bit for bit; a 1-rank mesh is
    the port's sync driver bit for bit."""
    runs = [r[strategy] for r in world["four"]]
    for acc, facts, flat, _ in runs[1:]:
        assert acc == runs[0][0] and facts == runs[0][1]
        for k in flat[0]:
            assert np.array_equal(flat[0][k], runs[0][2][0][k]), k
    refs = world["refs"]
    sync = run_case("sync", strategy, refs["init"],
                    refs["blocks"] if strategy == "feddf" else None)
    one = world["one"][strategy]
    assert one[0] == sync[0] and one[1] == sync[1]
    for k in sync[2][0]:
        assert np.array_equal(one[2][0][k], sync[2][0][k]), k


def test_indivisible_cohort_raises_do_not_divide(world):
    for r in world["four"]:
        assert r["indivisible"] is not None
        assert "ValueError" in r["indivisible"]
        assert "do not divide" in r["indivisible"]


def test_hetero_bucketed_caps_pad_to_the_axis_and_match(world):
    """Algorithm 3 with pow2 step buckets: every client cap is padded up
    to a multiple of 4, some lanes are padding, and the run matches the
    port's one-device sync and JAX's sync."""
    refs = world["refs"]
    sync = run_case("sync", "fedavg", refs["hetero_init"], hetero=True,
                    bucket="pow2")
    acc_j, _, flat_j = _jax_run("fedavg", hetero=True)
    for r in world["four"]:
        acc, facts, flat, caps = r["hetero"]
        assert all(cap % 4 == 0 for _, _, cap in caps), caps
        assert any(cap > k for _, k, cap in caps), caps
        assert any(cap % 4 for _, _, cap in sync[3]), sync[3]
        assert acc == sync[0] and facts == sync[1]
        _close(flat, sync[2], 1e-6)
        assert acc == acc_j
        _close(flat, flat_j, PARAM_ATOL)


def test_sharded_bank_matches_unsharded(world):
    for r in world["four"]:
        cases, uneven = r["bank"]
        for case in cases:
            per = case["n"] // 4
            assert case["bank_n"] == case["n"]
            start = r["rank"] * per
            assert case["block"] == (start, start + per)
            assert case["local_rows"] == per
            assert case["rows_equal"] and case["pool_equal"], case
            assert case["scales_equal"] and case["gather_equal"], case
        for got in uneven:
            assert got is not None and got.startswith("ValueError"), got
            assert "does not divide over 4 ranks" in got


def _jax_fed_loop(world, cfg="cj", init="fed_j"):
    """A loop over JAX's make_fed_round_step(...).jit() on a 1 x 1 mesh,
    the FedAvg mean in numpy."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    cj, params = world[cfg], world[init]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    if ("step", cfg) not in world:
        world[("step", cfg)] = jsteps.make_fed_round_step(
            cj, mesh, param_dtype=jnp.float32, **FED).jit()
    step = world[("step", cfg)]
    rng = np.random.default_rng(SEED)
    k = FED["n_clients"]
    for _ in range(ROUNDS):
        stacked = jax.tree.map(
            lambda p: jnp.broadcast_to(p[None], (k,) + p.shape), params)
        toks = rng.integers(0, cj.vocab_size, (k, FED["local_steps"],
                                               FED["batch_size"],
                                               FED["seq_len"]),
                            dtype=np.int32)
        with mesh:
            new = step(stacked, {"tokens": toks, "labels": toks})
        params = jax.tree.map(
            lambda s: np.asarray(s, np.float32).mean(axis=0), new)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("hosts", [4, 2])
def test_drive_fed_rounds_matches_the_jax_loop(world, hosts):
    if "fed_want" not in world:
        world["fed_want"] = _jax_fed_loop(world)
    want = world["fed_want"]
    runs = ([r["fed_4x1"] for r in world["four"]] if hosts == 4
            else world["two"])
    for flat, stats in runs:
        assert [s["round"] for s in stats] == list(range(1, ROUNDS + 1))
        assert all(s["update_norm"] > 0 for s in stats)
        assert all(s["all_reduce_bytes"] > 0 for s in stats)
        assert flat.keys() == want.keys()
        for k in want:
            gap = float(np.abs(flat[k] - want[k]).max())
            assert gap <= STEP_REL * float(np.abs(want[k]).max()), (k, gap)
    # every rank ends with the same global, bit for bit
    for flat, _ in runs[1:]:
        assert all(np.array_equal(flat[k], runs[0][0][k]) for k in flat)


def test_a_model_axis_raises_naming_11_8(world):
    """``drive_fed_rounds`` on ``make_host_mesh(2, 2)`` (item 11.8.5: each
    client's replica tensor-parallel over "model") against the JAX loop,
    within STEP_REL of each leaf's largest; every rank returns the same
    gathered global, bit for bit."""
    if "fed_want" not in world:
        world["fed_want"] = _jax_fed_loop(world)
    want = world["fed_want"]
    runs = [r["fed_2x2"] for r in world["four"]]
    for flat, stats in runs:
        assert [s["round"] for s in stats] == list(range(1, ROUNDS + 1))
        assert all(s["update_norm"] > 0 for s in stats)
        assert all(s["all_reduce_bytes"] > 0 for s in stats)
        assert flat.keys() == want.keys()
        for k in want:
            gap = float(np.abs(flat[k] - want[k]).max())
            assert gap <= STEP_REL * float(np.abs(want[k]).max()), (k, gap)
    for flat, _ in runs[1:]:
        assert all(np.array_equal(flat[k], runs[0][0][k]) for k in flat)
    # the update norm is the global one: a leaf split over "model" summed
    # over it, a whole one counted once (the 4 x 1 run's, where each rank
    # holds every leaf whole)
    for (_, s4), (_, s2) in zip((r["fed_4x1"] for r in world["four"]),
                                runs):
        for a, b in zip(s4, s2):
            assert b["update_norm"] == pytest.approx(a["update_norm"],
                                                     rel=1e-4)


def test_drive_fed_rounds_moe_on_a_model_axis_matches_the_jax_loop(world):
    """Reduced granite-moe on ``make_host_mesh(2, 2)``: each client's MoE
    runs expert-parallel over "model" at its whole batch (the federated
    round passes its mesh, no data axes), where JAX's round runs one
    device's dispatch; against the JAX loop within STEP_REL of each
    leaf's largest or, where that is tighter than JAX's own rounding,
    SPREAD_FACTOR times the JAX loop's 1-ulp spread (the embedding's
    is 9.0e-6 of its largest after 2 rounds); every rank's global the
    same."""
    import jax
    rng = np.random.default_rng(5)
    world["moe_j_nudged"] = jax.tree.map(lambda x: (np.asarray(x) * (
        1 + 2.0 ** -23 * rng.standard_normal(x.shape))).astype(np.float32),
        world["moe_j"])
    want = _jax_fed_loop(world, "cm", "moe_j")
    nudged = _jax_fed_loop(world, "cm", "moe_j_nudged")
    rel = lambda a: max(float(np.abs(a[k] - want[k]).max()
                              / np.abs(want[k]).max()) for k in want)
    bound = max(STEP_REL, SPREAD_FACTOR * rel(nudged))
    runs = [r["fed_2x2_moe"] for r in world["four"]]
    for flat, stats in runs:
        assert [s["round"] for s in stats] == list(range(1, ROUNDS + 1))
        assert all(s["update_norm"] > 0 for s in stats)
        assert flat.keys() == want.keys()
        assert rel(flat) <= bound, (rel(flat), bound)
    for flat, _ in runs[1:]:
        assert all(np.array_equal(flat[k], runs[0][0][k]) for k in flat)


def test_a_failing_rank_fails_the_launch_within_its_timeout():
    import time
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.launch_ranks(failing_rank, 2, "cpu", timeout_s=120)
    assert time.perf_counter() - t0 < 60


def test_meshes_need_a_world_that_matches():
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        tmesh.make_client_mesh()
    with tmesh.one_rank_world("cpu"):
        mesh = tmesh.make_client_mesh()
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        with pytest.raises(ValueError, match="needs 4 ranks"):
            tmesh.make_client_mesh(4)
        with pytest.raises(ValueError, match="needs 4 ranks"):
            tmesh.make_debug_mesh()
    assert tmesh.choose_backend("cpu", 4, 3) == ("gloo",
                                                 torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.choose_backend("cuda", 1, 0)


@pytest.mark.parametrize("local, rank, want", [
    (8, 3, ("nccl", torch.device("cuda", 3))),   # 16 ranks, 2 nodes of 8
    (4, 1, ("nccl", torch.device("cuda", 1))),
    (16, 11, ("gloo", torch.device("cuda", 3))),  # 16 ranks on one node
])
def test_backend_follows_the_ranks_of_this_node(monkeypatch, local, rank,
                                                want):
    """NCCL whenever this node's ranks have a card each, however large the
    whole world; gloo round-robin when they outnumber the node's cards."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert tmesh.choose_backend("cuda", local, rank) == want


def test_torchrun_world_reads_the_local_world_size(monkeypatch):
    """Under torchrun the backend is chosen from LOCAL_WORLD_SIZE, not from
    WORLD_SIZE."""
    import torch.distributed as dist
    seen = {}
    monkeypatch.setenv("RANK", "11")
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    monkeypatch.setattr(tmesh, "choose_backend", lambda device, local, rank:
                        seen.update(args=(local, rank)) or
                        ("gloo", torch.device("cpu")))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: seen.update(kw=kw))
    try:
        assert tmesh.init_world("cpu") == torch.device("cpu")
    finally:
        tmesh._WORLD.update(device=None, backend=None)
    assert seen["args"] == (8, 3)
    assert seen["kw"]["rank"] == 11 and seen["kw"]["world_size"] == 16


def test_drive_fed_rounds_outside_a_world_runs_on_the_card():
    """With no mesh and no world, ``drive_fed_rounds`` takes the card and
    raises without one; the CPU must be asked for."""
    from repro_torch import configs
    from repro_torch.common.arch_config import reduced
    from repro_torch.drivers import drive_fed_rounds
    ct = reduced(configs.get("qwen3-8b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            drive_fed_rounds(ct, None, rounds=1, seed=SEED, **FED)
    params, stats = drive_fed_rounds(ct, None, rounds=1, seed=SEED,
                                     device="cpu", **FED)
    assert next(iter(params.values())).device.type == "cpu"
    assert stats[0]["update_norm"] > 0 and stats[0]["all_reduce_bytes"] == 0
