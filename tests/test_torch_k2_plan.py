"""The launch plan of the AVGLOGITS KL kernels (K2 / K3, and K1 on the
logit bank, which runs the same plan at K = 1) and the order in which they
merge, checked on the CPU (no card, no nvcc).

``repro_torch.kernels.ensemble_kl.plan`` picks each launch's shape on the
host; the CUDA kernels (``kernels/csrc/ensemble_kl.cu``,
``kernels/csrc/ensemble_kl_bank.cu``) index by it.  Here:

* the index mapping of every mode, simulated in numpy from the plan, gives
  every (row, element) pair to exactly one lane of exactly one block, in
  the forward and in the flat backward; the plan stays inside the kernels'
  limits; each ``chip_smoke.py`` shape gets its named mode;
* a numpy float32 model of the kernels' merge order (per-lane online
  statistics, the lane group's xor tree, the warps' xor tree, the
  cluster's tree over its ranks, empty lanes and slices at -1e30) is held
  against the plain versions (``ref.ensemble_kl`` / ``ref.ensemble_kl_pre``)
  and the JAX package (``repro.kernels.ref``, and the Pallas kernel in
  interpret mode for bfloat16 teachers, whose quotient the JAX reference
  does not round) at K2's tolerances: forward rtol 1e-5 / atol 1e-6,
  gradient rtol 1e-4 / atol 1e-7;
* K1 (``ensemble_kl_bank.plan``: the same plan with K1's own cluster
  threshold): the same ownership at its ``chip_smoke.py`` shapes (the
  backward on its grid capped at one wave, also on a one-SM card so it
  walks grid-stride), each shape's named mode, and the same model on gathered,
  dequantized bank rows (``t = bank * (scale * 1/T)``, ``s = student *
  1/T``) for every bank dtype, held against ``ref.ensemble_kl_bank`` and
  the JAX package's ``ensemble_kl_bank`` (Pallas, interpret mode) and
  ``repro.kernels.ref`` at K1's tolerances: forward 5e-6 + 2e-6 |loss|,
  gradient 3e-7.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ensemble_kl as k2
from repro_torch.kernels import ensemble_kl_bank as k1

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
NEG = np.float32(-1e30)
KERNEL_MAX_THREADS = 256          # kMaxThreads in ensemble_kl.cu
GRID_MAX = 2 ** 31 - 1

# (K, B, V): V = 1 and 3, B = 1, the paths' and chip_smoke.py's shapes, a
# ragged cluster, a slice just past the lane groups, block mode just past
# the SM count, B = 65536, and the JAX kernel's widest V; then K2s's
# vocabulary shards (its plan is K2f's at V_loc): zamba2's 32000 and
# qwen3-8b's 151936 over two ranks, and odd V_loc on a cluster and in
# lane groups (5003 over 2 and 3 ranks, 7 over 2)
PLAN_SHAPES = [(1, 1, 1), (8, 64, 3), (3, 1, 3), (1, 64, 3), (8, 256, 64),
               (5, 37, 5003), (8, 64, 1000), (4, 1024, 32000), (3, 1, 5003),
               (1, 37, 5003), (8, 7, 300), (2, 3, 257), (2, 160, 1000),
               (1, 65536, 3), (2, 33, 40), (1, 1, 262144),
               (4, 1024, 16000), (4, 256, 75968), (3, 7, 2501), (2, 1, 1667),
               (4, 64, 3)]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the index mapping, as the kernels compute it from the plan
# ---------------------------------------------------------------------------

def _forward_pairs(p, b, v, blocks):
    """Flat indices row * V + col that ``blocks`` (a range of blockIdx.x)
    of the forward own, one entry per (block, thread, element)."""
    x = np.arange(blocks.start, blocks.stop)[:, None]
    t = np.arange(p.threads)[None, :]
    if p.mode == "lanes":
        row = x * (p.threads // p.lanes) + t // p.lanes
        first, end, step = t % p.lanes, np.full_like(row, v), p.lanes
    else:
        row = x // p.cluster
        rank = x % p.cluster
        width = -(-v // p.cluster)
        v0 = np.minimum(v, rank * width)
        v1 = np.minimum(v, v0 + width)
        first, end, step = v0 + t, np.broadcast_to(v1, (len(x), p.threads)), \
            p.threads
    out = []
    for j in range(-(-v // step) + 1):
        col = first + j * step
        keep = (col < end) & (row < b)
        out.append((row * v + col)[keep])
    return np.concatenate(out)


def _backward_pairs(p, n, blocks):
    x = np.arange(blocks.start, blocks.stop)[:, None]
    i0 = x * p.bwd_threads + np.arange(p.bwd_threads)[None, :]
    out, stride = [], p.bwd_grid * p.bwd_threads
    for j in range(-(-n // stride)):
        i = i0 + j * stride
        out.append(i[i < n])
    return np.concatenate(out)


def _count_owners(pairs_of, grid, n, chunk):
    """Every index in [0, n) owned exactly once over blocks [0, grid)."""
    counts = np.zeros(n, np.uint8)
    for start in range(0, grid, chunk):
        idx = pairs_of(range(start, min(grid, start + chunk)))
        assert idx.size == 0 or (idx.min() >= 0 and idx.max() < n)
        uniq = np.unique(idx)
        assert uniq.size == idx.size, "an element has two owners in a chunk"
        counts[idx] += 1
    return counts


@pytest.mark.parametrize("k,b,v", PLAN_SHAPES)
def test_plan_owns_every_element_exactly_once(k, b, v):
    p = k2.plan(k, b, v)
    chunk = max(1, 4_000_000 // (p.threads * max(1, -(-v // p.threads))))
    counts = _count_owners(lambda r: _forward_pairs(p, b, v, r), p.grid,
                           b * v, chunk)
    assert (counts == 1).all(), (p, np.bincount(counts))
    counts = _count_owners(lambda r: _backward_pairs(p, b * v, r),
                           p.bwd_grid, b * v, max(1, 4_000_000 // p.bwd_threads))
    assert (counts == 1).all(), p


@pytest.mark.parametrize("k,b,v", PLAN_SHAPES)
def test_plan_stays_inside_the_kernels_limits(k, b, v):
    p = k2.plan(k, b, v)
    for threads in (p.threads, p.bwd_threads):
        assert 32 <= threads <= min(1024, KERNEL_MAX_THREADS)
        assert threads % 32 == 0
    assert p.cluster in (1, 2, 4, 8) and p.grid % p.cluster == 0
    assert 1 <= p.grid <= GRID_MAX and 1 <= p.bwd_grid <= GRID_MAX
    assert p.teacher_batch in k2.TEACHER_BATCHES and p.teacher_batch >= \
        min(k, k2.TEACHER_BATCHES[-1])
    if p.mode == "lanes":
        assert p.lanes in (1, 2, 4, 8, 16, 32) and p.cluster == 1
        assert p.rows_per_block * p.lanes == p.threads
        assert p.lanes >= v       # a lane owns at most one element
        assert (p.grid - 1) * p.rows_per_block < b <= p.grid * \
            p.rows_per_block
    else:
        assert p.lanes == p.threads
        assert p.grid == b * p.cluster
        assert (p.mode == "cluster") == (p.cluster > 1)


# the mode each chip_smoke.py shape is planned into (K2 (K, B, V); K3 is
# K = 1), with its lanes per row or cluster size
CHIP_SMOKE_MODES = {
    (8, 64, 3): ("lanes", 4), (6, 64, 3): ("lanes", 4),
    (13, 64, 3): ("lanes", 4),
    (8, 256, 64): ("block", 1),
    (5, 37, 5003): ("cluster", 8), (1, 64, 3): ("lanes", 4),
    (8, 64, 1000): ("cluster", 4), (4, 1024, 32000): ("block", 1),
    (3, 1, 5003): ("cluster", 8), (1, 256, 64): ("block", 1),
    (1, 37, 5003): ("cluster", 8),
}


def test_chip_smoke_shapes_get_their_modes():
    cs = _chip_smoke()
    shapes = set(cs.K2_SHAPES) | {(1, b, v) for b, v in cs.K3_SHAPES}
    assert shapes == set(CHIP_SMOKE_MODES)
    assert set(cs.K2_MODES) == {m for m, _ in CHIP_SMOKE_MODES.values()}
    for (k, b, v), (mode, width) in CHIP_SMOKE_MODES.items():
        p = k2.plan(k, b, v)
        assert p.mode == mode, (k, b, v, p)
        assert (p.lanes if mode == "lanes" else p.cluster) == width
        if mode == "cluster":    # B blocks alone fill under a wave
            assert b < k2.SMS
    # (3, 1, 5003): one row on a cluster of 8, the last slice ragged
    p = k2.plan(3, 1, 5003)
    width = -(-5003 // 8)
    assert p.cluster == 8 and 5003 - 7 * width not in (0, width)


def test_plan_refuses_empty_shapes():
    for bad in ((0, 1, 1), (1, 0, 1), (1, 1, 0)):
        with pytest.raises(ValueError):
            k2.plan(*bad)


# ---------------------------------------------------------------------------
# a numpy float32 model of the kernels' arithmetic, in their merge order
# ---------------------------------------------------------------------------

class _Stats:
    """The kernels' online statistics, one per lane: m_t, z_t, st, ss,
    m_s, z_s (float32 arrays of one shape)."""
    FIELDS = ("m_t", "z_t", "st", "ss", "m_s", "z_s")

    def __init__(self, shape=None, **fields):
        if shape is not None:
            zero = np.zeros(shape, np.float32)
            fields = {f: (np.full(shape, NEG) if f.startswith("m") else zero)
                      for f in self.FIELDS}
        for f in self.FIELDS:
            setattr(self, f, np.asarray(fields[f], np.float32))

    def take(self, index):
        return _Stats(**{f: getattr(self, f)[index] for f in self.FIELDS})


def _push(a, s, t, use):
    """push(): one element (s, t already divided by T) where ``use``."""
    up = use & (t > a.m_t)
    c = np.exp(np.where(up, a.m_t - t, np.float32(0)))
    a.z_t, a.st, a.ss = (np.where(up, x * c, x) for x in (a.z_t, a.st, a.ss))
    a.m_t = np.where(up, t, a.m_t)
    e = np.exp(np.where(use, t - a.m_t, np.float32(0)))
    a.z_t = np.where(use, a.z_t + e, a.z_t)
    a.st = np.where(use, a.st + e * t, a.st)
    a.ss = np.where(use, a.ss + e * s, a.ss)
    up = use & (s > a.m_s)
    a.z_s = np.where(up, a.z_s * np.exp(np.where(up, a.m_s - s,
                                                 np.float32(0))), a.z_s)
    a.m_s = np.where(up, s, a.m_s)
    a.z_s = np.where(use, a.z_s + np.exp(np.where(use, s - a.m_s,
                                                  np.float32(0))), a.z_s)


def _merge(a, b):
    m = np.maximum(a.m_t, b.m_t)
    ca, cb = np.exp(a.m_t - m), np.exp(b.m_t - m)
    ms = np.maximum(a.m_s, b.m_s)
    return _Stats(m_t=m, z_t=a.z_t * ca + b.z_t * cb,
                  st=a.st * ca + b.st * cb, ss=a.ss * ca + b.ss * cb, m_s=ms,
                  z_s=a.z_s * np.exp(a.m_s - ms) + b.z_s * np.exp(b.m_s - ms))


def _xor_tree(a, n):
    """What lane 0 holds after xor shuffles at offsets n/2, ..., 1 over the
    last axis (n a power of two): each round merges the lower half's lane
    (first) with its partner in the upper half."""
    off = n // 2
    while off:
        a = _merge(a.take((..., slice(0, off))),
                   a.take((..., slice(off, 2 * off))))
        off //= 2
    return a.take((..., 0))


def _round_bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _inputs(student, teachers, temp, dtype_name):
    """s_v = student / T and t_v = mean_k round_TT(teacher_k / T), summed in
    teacher order, in float32."""
    temp = np.float32(temp)
    s = (student / temp).astype(np.float32)
    acc = np.zeros(student.shape, np.float32)
    for tk in teachers:
        q = (tk / temp).astype(np.float32)
        acc = acc + (_round_bf16(q) if dtype_name == "bfloat16" else q)
    return s, (acc / np.float32(len(teachers))).astype(np.float32)


def _model_forward(s, t, p):
    """Per-row (kl, lse_t, lse_s) in the plan's merge order."""
    tot = _model_stats(s, t, p)
    with np.errstate(over="ignore", under="ignore"):
        lt = tot.m_t + np.log(tot.z_t)
        ls = tot.m_s + np.log(tot.z_s)
        kl = (tot.st - tot.ss) / tot.z_t - lt + ls
    return kl.astype(np.float32), lt.astype(np.float32), ls.astype(np.float32)


def _model_stats(s, t, p):
    """Per-row statistics in the plan's merge order, unfinished (K2s's
    planes)."""
    b, v = s.shape
    with np.errstate(over="ignore", under="ignore"):
        if p.mode == "lanes":
            a = _Stats((b, p.lanes))
            lane = np.arange(p.lanes)[None, :]
            for j in range(-(-v // p.lanes)):
                col = lane + j * p.lanes
                use = np.broadcast_to(col < v, (b, p.lanes))
                c = np.minimum(col, v - 1)
                _push(a, np.take_along_axis(s, np.broadcast_to(c, a.m_t.shape),
                                            1),
                      np.take_along_axis(t, np.broadcast_to(c, a.m_t.shape),
                                         1), use)
            tot = _xor_tree(a, p.lanes)
        else:
            c_n, thr = p.cluster, p.threads
            width = -(-v // c_n)
            rank = np.arange(c_n)[:, None]
            v0 = np.minimum(v, rank * width)
            v1 = np.minimum(v, v0 + width)
            a = _Stats((b, c_n, thr))
            for j in range(-(-width // thr)):
                col = v0 + np.arange(thr)[None, :] + j * thr
                use = np.broadcast_to(col < v1, (b, c_n, thr))
                c = np.broadcast_to(np.minimum(col, v - 1), (b, c_n, thr))
                _push(a, s[np.arange(b)[:, None, None], c],
                      t[np.arange(b)[:, None, None], c], use)
            n_warps = thr // 32
            warps = _xor_tree(_Stats(**{f: getattr(a, f).reshape(
                b, c_n, n_warps, 32) for f in _Stats.FIELDS}), 32)
            pad = 1 << (n_warps - 1).bit_length()
            if pad > n_warps:
                empty = _Stats((b, c_n, pad - n_warps))
                warps = _Stats(**{f: np.concatenate(
                    [getattr(warps, f), getattr(empty, f)], -1)
                    for f in _Stats.FIELDS})
            tot = _xor_tree(_xor_tree(warps, pad), c_n)
    return tot


def _model_grad(s, t, lt, ls, temp, b):
    """The flat backward at a unit cotangent: (p_s - p_t) * (g * T) / B."""
    gs = np.float32(np.float32(1.0) * np.float32(temp)) / np.float32(b)
    return ((np.exp(s - ls[:, None]) - np.exp(t - lt[:, None])) * gs
            ).astype(np.float32)


# every forward mode: lane groups of 4 and 16, one block per row (with 7
# warps, a count that is not a power of two), clusters of 8 (one ragged),
# of 4 and of 2
MODEL_SHAPES = [(8, 64, 3), (2, 5, 16), (3, 5, 200), (1, 6, 33),
                (5, 37, 5003), (3, 1, 5003), (8, 64, 1000), (2, 100, 700),
                (2, 140, 300)]


def _case(k, b, v, dtype_name):
    rng = np.random.default_rng(7 * k + 3 * b + v)
    student = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    t32 = torch.from_numpy((rng.normal(size=(k, b, v)) * 3)
                           .astype(np.float32))
    t_t = t32.to(getattr(torch, dtype_name))       # the stored teachers
    return student, t_t, t_t.float().numpy()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("temp", [1.0, 2.5])
@pytest.mark.parametrize("k,b,v", MODEL_SHAPES)
def test_merge_order_model_matches_plain_and_jax(k, b, v, temp, dtype_name):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ensemble_kl import ensemble_kl as jkernel
    p = k2.plan(k, b, v)
    student, t_t, stored = _case(k, b, v, dtype_name)
    s, t = _inputs(student, stored, temp, dtype_name)
    kl, lt, ls = _model_forward(s, t, p)
    loss = float(np.float32(kl.sum(dtype=np.float32)) / np.float32(b)
                 * np.float32(temp ** 2))
    s_t = torch.from_numpy(student)
    want = float(ref.ensemble_kl(s_t, t_t, temp))
    np.testing.assert_allclose(loss, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    # the row statistics themselves, against log-softmax's normaliser
    t_mean = ref._mean_teacher(t_t, temp)
    np.testing.assert_allclose(lt, torch.logsumexp(t_mean, -1).numpy(),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(ls, torch.logsumexp(s_t / temp, -1).numpy(),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    if dtype_name == "float32":
        jwant = float(jref.ensemble_kl(jnp.asarray(student),
                                       jnp.asarray(stored), temp))
    else:
        jwant = float(jkernel(jnp.asarray(student),
                              jnp.asarray(stored).astype(jnp.bfloat16), temp,
                              8, True))
    np.testing.assert_allclose(loss, jwant, rtol=FWD_RTOL, atol=FWD_ATOL)
    grad = _model_grad(s, t, lt, ls, temp, b)
    np.testing.assert_allclose(
        grad, ref.ensemble_kl_grad(s_t, t_t, temp).numpy(), rtol=GRAD_RTOL,
        atol=GRAD_ATOL)


@pytest.mark.parametrize("temp", [1.0, 2.5])
@pytest.mark.parametrize("b,v", [(64, 3), (256, 64), (37, 5003)])
def test_merge_order_model_matches_plain_k3(b, v, temp):
    """K3 (pre-averaged rows) runs the same kernels with K = 1."""
    p = k2.plan(1, b, v)
    student, t_t, stored = _case(1, b, v, "float32")
    s, t = _inputs(student, stored, temp, "float32")
    kl, lt, ls = _model_forward(s, t, p)
    loss = float(np.float32(kl.sum(dtype=np.float32)) / np.float32(b)
                 * np.float32(temp ** 2))
    want = float(ref.ensemble_kl_pre(torch.from_numpy(student), t_t[0], temp))
    np.testing.assert_allclose(loss, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_allclose(
        _model_grad(s, t, lt, ls, temp, b),
        ref.ensemble_kl_grad(torch.from_numpy(student), t_t, temp).numpy(),
        rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_model_merges_empty_lanes_as_zero_weight():
    """A lane, warp or slice that owns no element holds m = -1e30 and
    merges with weight exactly 0: one element on 32 lanes and on a cluster
    of 8 gives that element's own statistics."""
    s = np.array([[0.5]], np.float32)
    t = np.array([[-2.0]], np.float32)
    for p in (k2.plan(1, 1, 1), k2.Plan(1, "lanes", 32, 1, 1, 32, 1, 32, 1),
              k2.Plan(1, "cluster", 32, 1, 8, 32, 8, 32, 1)):
        kl, lt, ls = _model_forward(s, t, p)
        assert lt[0] == t[0, 0] and ls[0] == s[0, 0] and kl[0] == 0.0


# K2s's shards: each chunk of V_loc columns planned on its own (lane groups
# of 4 and 2 for 3 + 2 of 5 classes, clusters of 8 for 2502 / 2501 of
# 5003, one block per row past the SMs for 234 / 233 of 700 over 3,
# clusters of 4 for 750 of 3000 over 4 and of 2 for 700 of 1400 over 2),
# the statistics merged across the chunks in float32 as ops merges them
# across ranks (the max, the rescaled sums)
SPLIT_MODEL_SHAPES = [(4, 6, 5, 2), (5, 37, 5003, 2), (2, 140, 700, 3),
                      (8, 64, 3000, 4), (2, 100, 1400, 2)]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,b,v,parts", SPLIT_MODEL_SHAPES)
def test_split_merge_order_model_matches_plain(k, b, v, parts, dtype_name):
    temp = 2.5
    student, t_t, stored = _case(k, b, v, dtype_name)
    s, t = _inputs(student, stored, temp, dtype_name)
    cols = np.array_split(np.arange(v), parts)
    shards = [_model_stats(s[:, c], t[:, c], k2.plan(k, b, len(c)))
              for c in cols]
    with np.errstate(over="ignore", under="ignore"):
        m_t = np.max([x.m_t for x in shards], axis=0)
        m_s = np.max([x.m_s for x in shards], axis=0)
        c_t = [np.exp(x.m_t - m_t) for x in shards]
        z_t, st, ss = (np.float32(sum(getattr(x, f) * c for x, c in
                                      zip(shards, c_t)))
                       for f in ("z_t", "st", "ss"))
        z_s = np.float32(sum(x.z_s * np.exp(x.m_s - m_s) for x in shards))
        lt, ls = m_t + np.log(z_t), m_s + np.log(z_s)
        kl = (st - ss) / z_t - lt + ls
    loss = float(np.float32(kl.sum(dtype=np.float32)) / np.float32(b)
                 * np.float32(temp ** 2))
    s_t = torch.from_numpy(student)
    np.testing.assert_allclose(loss, float(ref.ensemble_kl(s_t, t_t, temp)),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    plain = ref.kl_combine([ref.kl_partial(s_t[:, c], t_t[:, :, c], temp)
                            for c in cols])
    for got, want in zip((kl, lt, ls), plain):
        np.testing.assert_allclose(got, want.numpy(), rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
    grad = np.concatenate([_model_grad(s[:, c], t[:, c], lt, ls, temp, b)
                           for c in cols], axis=1)
    np.testing.assert_allclose(
        grad, ref.ensemble_kl_grad(s_t, t_t, temp).numpy(), rtol=GRAD_RTOL,
        atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# K1: the logit-bank kernels run the same plan at K = 1
# ---------------------------------------------------------------------------

K1_FWD_ATOL, K1_FWD_RTOL = 5e-6, 2e-6
K1_BWD_ATOL = 3e-7
BANK_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")

# (B, V): chip_smoke.py's K1 shapes, V = 1, B = 1, one row on a ragged
# cluster of 8, lanes with a row slot past B, and the plan's switch points
K1_PLAN_SHAPES = [(64, 3), (256, 64), (37, 5003), (1024, 32000), (1, 1),
                  (1, 5003), (7, 3), (64, 33), (16, 513), (16, 4097),
                  (128, 5003)]


@pytest.mark.parametrize("sms", [k2.SMS, 1])
@pytest.mark.parametrize("b,v", K1_PLAN_SHAPES)
def test_k1_plan_owns_every_element_exactly_once(b, v, sms):
    p = k1.plan(b, v, sms)
    counts = _count_owners(lambda r: _forward_pairs(p, b, v, r), p.grid,
                           b * v, max(1, 4_000_000 // (
                               p.threads * max(1, -(-v // p.threads)))))
    assert (counts == 1).all(), (p, np.bincount(counts))
    # the backward on the wrapper's grid: at most one wave, grid-stride past
    q = dataclasses.replace(p, bwd_grid=k1.bwd_grid(p, sms))
    assert 1 <= q.bwd_grid <= k1.BWD_BLOCKS_PER_SM * sms
    counts = _count_owners(lambda r: _backward_pairs(q, b * v, r),
                           q.bwd_grid, b * v,
                           max(1, 4_000_000 // q.bwd_threads))
    assert (counts == 1).all(), q


# the mode each chip_smoke.py K1 shape (B, N, V) is planned into, with its
# lanes per row or cluster size
K1_CHIP_SMOKE_MODES = {
    (64, 4000, 3): ("lanes", 4), (256, 4096, 64): ("block", 1),
    (37, 1000, 5003): ("cluster", 8), (1024, 4096, 32000): ("block", 1),
    (32, 4000, 3): ("lanes", 4), (48, 4000, 3): ("lanes", 4),
    (64, 4000, 4): ("lanes", 4),
}


def test_k1_chip_smoke_shapes_get_their_modes():
    cs = _chip_smoke()
    assert set(cs.SHAPES) == set(K1_CHIP_SMOKE_MODES)
    for (b, n, v), (mode, width) in K1_CHIP_SMOKE_MODES.items():
        p = k1.plan(b, v)
        assert p.mode == mode, (b, v, p)
        assert (p.lanes if mode == "lanes" else p.cluster) == width
    # the mode timings sit where the plan switches: V = 32 / 33, and at
    # B = 16, 64, 128 K2's V = 512 / 513, V = 2000, and K1's V = 4096 / 4097
    # and 5003 (clusters of 8, 4, 2)
    want = {(64, 32): ("lanes", 1), (64, 33): ("block", 1)}
    for b, c in ((16, 8), (64, 4), (128, 2)):
        want.update({(b, v): ("block", 1) for v in (512, 513, 2000, 4096)})
        want.update({(b, v): ("cluster", c) for v in (4097, 5003)})
        assert k2.plan(1, b, 513).mode == "cluster"    # K2 switches at 513
    assert set(cs.K1_MODE_SHAPES) == set(want)
    for (b, v), (mode, c) in want.items():
        p = k1.plan(b, v)
        assert (p.mode, p.cluster) == (mode, c), (b, v, p)
    assert {m for m, _ in cs.K1_FWD_MODES} == set(cs.K2_MODES)
    for mode, v in cs.K1_POISON_SHAPES.items():
        assert k1.plan(7, v).mode == mode
    # the backward grids differ where chip_smoke.py times both
    for b, v in cs.K1_BWD_GRID_SHAPES:
        p = k1.plan(b, v)
        assert k1.bwd_grid(p, k2.SMS) < p.bwd_grid


def _bank_case(b, n, v, dtype_name):
    """numpy student, the stored rows as float32 and in their storage dtype
    (torch), scales (float32 [N] or None) and idx, from a seed."""
    from repro_torch.core.logit_bank import bank_dtype, quantize_rows
    rng = np.random.default_rng(11 * b + 5 * n + v)
    student = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    bank32 = torch.from_numpy((rng.normal(size=(n, v)) * 3)
                              .astype(np.float32))
    idx = rng.integers(0, n, size=b).astype(np.int64)
    if dtype_name in ("int8", "fp8_e4m3"):
        rows, scales = quantize_rows(bank32, dtype_name)
        scales = scales.numpy()
    else:
        rows, scales = bank32.to(bank_dtype(dtype_name)), None
    return student, rows, rows.float().numpy(), scales, idx


def _bank_inputs(student, stored, scales, idx, temp):
    """The kernels' s = student * (1/T) and t = bank[idx] * (scale * (1/T)),
    1/T rounded to float32 as the wrapper passes it."""
    inv_t = np.float32(1.0 / temp)
    s = (student * inv_t).astype(np.float32)
    factor = (np.full(len(idx), inv_t, np.float32) if scales is None
              else (scales[idx] * inv_t).astype(np.float32))
    return s, (stored[idx] * factor[:, None]).astype(np.float32)


# every forward mode of K1's plan: lane groups of 4 and 16, one block per
# row of 7 warps and of 8 warps with 4 elements a thread, clusters of 8
# (one ragged row alone) and of 4
K1_MODEL_SHAPES = [(64, 4000, 3), (5, 40, 16), (3, 20, 200), (64, 200, 1000),
                   (37, 1000, 5003), (1, 50, 5003), (64, 200, 5003)]


@pytest.mark.parametrize("dtype_name", BANK_DTYPES)
@pytest.mark.parametrize("temp", [1.0, 2.5])
@pytest.mark.parametrize("b,n,v", K1_MODEL_SHAPES)
def test_k1_merge_order_model_matches_plain_and_jax(b, n, v, temp,
                                                    dtype_name):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ensemble_kl import ensemble_kl_bank as jkernel
    p = k1.plan(b, v)
    student, rows, stored, scales, idx = _bank_case(b, n, v, dtype_name)
    s, t = _bank_inputs(student, stored, scales, idx, temp)
    kl, lt, ls = _model_forward(s, t, p)
    loss = float(np.float32(kl.sum(dtype=np.float32)) / np.float32(b)
                 * np.float32(temp ** 2))
    grad = _model_grad(s, t, lt, ls, temp, b)

    row_scale = (np.ones(b, np.float32) if scales is None
                 else scales[idx].astype(np.float32))
    s_t = torch.from_numpy(student).requires_grad_(True)
    want = ref.ensemble_kl_bank(s_t, rows, torch.from_numpy(row_scale),
                                torch.from_numpy(idx), temp)
    (g_want,) = torch.autograd.grad(want, s_t)
    rows_j = jnp.asarray(stored).astype(
        {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
         "int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}[dtype_name])
    s_j, rs_j, idx_j = (jnp.asarray(student), jnp.asarray(row_scale),
                        jnp.asarray(idx.astype(np.int32)))
    jk = lambda x: jkernel(x, rows_j, rs_j, idx_j, temp, True)
    jr = lambda x: jref.ensemble_kl_bank(x, rows_j, rs_j, idx_j, temp)
    for w, gw in ((float(want.detach()), g_want.numpy()),
                  (float(jk(s_j)), np.asarray(jax.grad(jk)(s_j))),
                  (float(jr(s_j)), np.asarray(jax.grad(jr)(s_j)))):
        assert abs(loss - w) <= K1_FWD_ATOL + K1_FWD_RTOL * abs(w)
        assert np.abs(grad - gw).max() <= K1_BWD_ATOL
