"""Teacher-logit bank: FedDF's precomputed, device-resident fast path.

The teachers are frozen during fusion and AVGLOGITS only consumes
``mean_k f(x_k, d)``, so for a source with a finite pool the averaged
teacher logits are computed once per round (one chunked batched forward
of the stacked teachers over the pool, reduced to the fp32 mean) and the
distillation steps gather bank rows by the sampled indices instead of
re-running the teachers: ``K x steps`` forwards become ``K x ceil(N /
chunk)``.

Rows are stored as float32, bfloat16, int8 or fp8 e4m3; the quantized
dtypes carry one fp32 scale per row, and the fused distillation kernel
dequantizes rows in registers (``kernels/ensemble_kl_bank.py``).

Teacher weights (the buffered-async driver's staleness importance) fold
into the stored rows at build time: the bank holds the weighted consensus
instead of the uniform mean, and the distillation steps stay the same.

With a ``sharding`` (``common/sharding.NamedSharding`` over one mesh
axis, ``P(axis)``) each rank keeps only its contiguous block
of rows, pool and scales alike, as ``device_put`` lays a ``P(axis)``
array out: ``N / n`` rows each, and a pool that the axis does not divide
raises, as there; :meth:`LogitBank.full` and
:meth:`LogitBank.gather` give the unsharded rows and a gather by index
on every rank.  A sharded bank takes no persistent-cache key.

A size-1 cross-round cache (:data:`PERSISTENT_BANK`) keeps the last build:
when the very same frozen teacher tensors are fused again over the same
pool (a repeated fusion of one round's uploads), :func:`resolve_bank`
returns the cached rows as ``reused`` instead of forwarding every teacher
again.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
import weakref
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.common.options import (BANK_DTYPES, LOGIT_BANK_MODES,
                                        QUANTIZED_BANK_DTYPES)
from repro_torch.common.pytree import tree_leaves
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import REGISTRY

DEFAULT_CHUNK = 512

# symmetric per-row quantization: q = round/cast(row / scale) with
# scale = amax(|row|) / QUANT_MAX[dtype]
_INT8_MAX = 127.0
_FP8_E4M3_MAX = 448.0  # largest finite float8_e4m3fn value
_QUANT_MAX = {"int8": _INT8_MAX, "fp8_e4m3": _FP8_E4M3_MAX}
_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


# Teacher *batch* forwards (one teacher, one batch of rows), from bank
# builds and on-the-fly distillation chunks alike: the evidence that the
# bank removes the K x steps redundancy.
TEACHER_FORWARDS = REGISTRY.counter("core.logit_bank.teacher_forwards")


@dataclasses.dataclass
class LogitBank:
    """Per-round bank of averaged teacher logits over a distillation pool:
    ``pool`` [N, ...] and ``logits`` [N, C] in ``dtype_name``, on one
    device; ``scales`` [N] fp32 for the quantized dtypes, else None.  A
    sharded bank holds rows ``block`` = ``[start, stop)`` of ``n_total``
    in those fields."""

    pool: torch.Tensor
    logits: torch.Tensor
    n_teachers: int
    n_teacher_batch_forwards: int
    build_time_s: float
    scales: Optional[torch.Tensor] = None
    dtype_name: str = "float32"
    reused: bool = False
    sharding: Any = None
    block: Optional[Tuple[int, int]] = None
    n_total: Optional[int] = None

    @property
    def n(self) -> int:
        return self.n_total if self.n_total is not None \
            else int(self.pool.shape[0])

    def _gather_blocks(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's ``local`` [m, ...] in rank order over the sharded
        axis, its bytes gathered as uint8."""
        from repro_torch.common.sharding import all_gather
        raw = local.contiguous().view(torch.uint8)
        out = all_gather(raw, self.sharding.mesh, _axes(self.sharding))
        return out.view(local.dtype)

    def full(self) -> "LogitBank":
        """The unsharded bank on every rank (a collective call)."""
        if self.sharding is None:
            return self
        take = lambda t: None if t is None else self._gather_blocks(t)
        return dataclasses.replace(
            self, pool=take(self.pool), logits=take(self.logits),
            scales=take(self.scales), sharding=None, block=None,
            n_total=None)

    def gather(self, idx) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(logits[idx], scales[idx] or None)`` of the whole bank on
        every rank; all ranks call it with the same ``idx``."""
        idx = torch.as_tensor(idx, device=self.logits.device).long()
        if self.sharding is None:
            return (self.logits[idx],
                    None if self.scales is None else self.scales[idx])
        # every rank picks row idx % per of its block; the owner's counts
        per = _block_rows(self.n, self.sharding)
        owner, local = idx // per, idx % per
        pick = torch.arange(len(idx), device=idx.device)

        def one(t):
            got = self._gather_blocks(t[local])
            return got.view((-1, len(idx)) + tuple(t.shape[1:]))[owner, pick]
        return one(self.logits), None if self.scales is None \
            else one(self.scales)

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def nbytes(self) -> int:
        """Bank row bytes, scales included."""
        total = self.logits.numel() * self.logits.element_size()
        if self.scales is not None:
            total += self.scales.numel() * self.scales.element_size()
        return int(total)


def _axes(sharding) -> Tuple[str, ...]:
    entry = tuple(sharding.spec)[0]
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_rows(n: int, sharding) -> int:
    """Rows per rank of an ``n``-row array laid out ``P(axis)``."""
    from repro_torch.common.sharding import axis_size
    axes = _axes(sharding)
    if len(axes) != 1:
        raise NotImplementedError(
            f"a bank sharded over {axes} (one axis only; ROADMAP queue 1 "
            f"item 11.8)")
    size = axis_size(sharding.mesh, axes[0])
    if n % size:
        raise ValueError(f"a pool of {n} rows does not divide over "
                         f"{size} ranks")
    return n // size


def bank_dtype(name: str) -> torch.dtype:
    """Storage dtype for a ``FusionConfig.bank_dtype`` literal."""
    if name not in BANK_DTYPES:
        raise ValueError(f"bank_dtype must be one of {sorted(BANK_DTYPES)}, "
                         f"got {name!r}")
    return _STORAGE[name]


def quantize_rows(rows: torch.Tensor, dtype_name: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization of fp32 logit rows ``[M, C]`` ->
    ``(q [M, C] storage dtype, scales [M] fp32)``.  int8 rounds half to
    even (as ``jnp.round``); fp8 rounds in the cast.  All-zero rows get
    scale 1, so dequantization is exact for them."""
    qmax = _QUANT_MAX[dtype_name]
    storage = bank_dtype(dtype_name)
    rows = rows.float()
    amax = rows.abs().amax(dim=-1)
    scales = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = rows / scales[:, None]
    if dtype_name == "int8":
        q = torch.clamp(torch.round(scaled), -_INT8_MAX, _INT8_MAX)
    else:
        q = torch.clamp(scaled, -qmax, qmax)
    return q.to(storage), scales


def dequantize_rows(rows: torch.Tensor,
                    scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 logit rows from stored bank rows (+ their per-row scales)."""
    out = rows.float()
    if scales is not None:
        out = out * scales[..., None]
    return out


def _normalized_weights(teacher_weights, k_total: int,
                        device) -> torch.Tensor:
    w = torch.as_tensor(teacher_weights, dtype=torch.float32).reshape(-1)
    if tuple(w.shape) != (k_total,):
        raise ValueError(
            f"teacher_weights must have shape ({k_total},) to match the "
            f"concatenated teacher axis, got {tuple(w.shape)}")
    return (w / w.sum()).to(device)


def build_logit_bank(teacher_logit_fns: Sequence[Callable], pool, *,
                     chunk_size: int = DEFAULT_CHUNK,
                     dtype: str = "float32", sharding=None,
                     teacher_weights=None) -> LogitBank:
    """One chunked pass of every teacher group over ``pool`` -> LogitBank.

    Each chunk evaluates all groups' stacked teachers ([K_g, c, C] each),
    concatenates them along the teacher axis and reduces to the fp32 mean,
    or to the ``teacher_weights`` consensus (``[K]`` in concat order, any
    positive scale: renormalized here); the full [K, N, C] tensor never
    exists.  The quantized dtypes quantize each chunk's rows in the same
    pass.  With a ``sharding`` this rank keeps its own block of the rows
    only."""
    t0 = time.perf_counter()
    bank_dtype(dtype)
    n = int(pool.shape[0])
    c = max(1, min(int(chunk_size), n))
    rows, scales, k_total, n_chunks = [], [], 0, 0
    w_norm = None
    with torch.no_grad():
        for s in range(0, n, c):
            t = torch.cat([f(pool[s:s + c]) for f in teacher_logit_fns],
                          dim=0).float()
            k_total = int(t.shape[0])
            if teacher_weights is not None and w_norm is None:
                w_norm = _normalized_weights(teacher_weights, k_total,
                                             t.device)
            mean = (t.mean(dim=0) if w_norm is None
                    else torch.tensordot(w_norm, t, dims=([0], [0])))
            if dtype in QUANTIZED_BANK_DTYPES:
                q, sc = quantize_rows(mean, dtype)
                rows.append(q)
                scales.append(sc)
            else:
                rows.append(mean.to(_STORAGE[dtype]))
            n_chunks += 1
            TEACHER_FORWARDS.add(k_total)
    bank = LogitBank(pool=pool, logits=torch.cat(rows),
                     n_teachers=k_total,
                     n_teacher_batch_forwards=n_chunks * k_total,
                     build_time_s=time.perf_counter() - t0,
                     scales=torch.cat(scales) if scales else None,
                     dtype_name=dtype)
    return bank if sharding is None else _shard(bank, sharding)


def _shard(bank: LogitBank, sharding) -> LogitBank:
    """This rank's block of a whole bank's rows, pool and scales (JAX
    builds the whole bank and then puts it on the mesh: the rows are the
    unsharded build's, bit for bit)."""
    from repro_torch.common.sharding import axis_index
    n = bank.n
    per = _block_rows(n, sharding)
    start = axis_index(sharding.mesh, _axes(sharding)[0]) * per
    stop = start + per
    cut = lambda t: None if t is None else t[start:stop].clone()
    return dataclasses.replace(
        bank, pool=cut(bank.pool), logits=cut(bank.logits),
        scales=cut(bank.scales), sharding=sharding, block=(start, stop),
        n_total=n)


class _PersistentBankCache:
    """Size-1 cross-round bank cache for static teacher pools.

    Keyed on the identity of the teacher stacks (the ``id()`` of every
    stacked teacher leaf, the pool's and the bank dtype) and on the teacher
    weights by value: fusing the exact same frozen tensors again reuses the
    previous build's rows.  New uploads are new tensors with new ids, a
    miss that replaces the entry.  The keyed tensors are held through weak
    references: a hit needs all of them alive, so a recycled id never hits,
    and the entry (bank rows included) dies with the first keyed tensor, so
    a training run's replaced uploads are not pinned."""

    def __init__(self):
        self._gen = 0
        self._key = None
        self._refs: Tuple = ()
        self._bank: Optional[LogitBank] = None

    def lookup(self, key) -> Optional[LogitBank]:
        if key is None or key != self._key:
            return None
        if any(r() is None for r in self._refs):
            self.clear()  # a keyed tensor died; its id may be recycled
            return None
        return self._bank

    def store(self, key, referents, bank: LogitBank) -> None:
        self._gen += 1
        gen = self._gen

        def on_dead(_ref, _gen=gen):
            # drop the bank once any keyed tensor is freed, unless a newer
            # entry (or a clear) has already replaced this one
            if self._gen == _gen:
                self.clear()

        self._key = key
        self._refs = tuple(weakref.ref(x, on_dead) for x in referents)
        self._bank = bank

    def clear(self) -> None:
        self._gen += 1
        self._key, self._refs, self._bank = None, (), None


PERSISTENT_BANK = _PersistentBankCache()


def _identity_key(teacher_logit_fns, pool, dtype_name: str,
                  teacher_weights=None):
    """(key, referents) for the persistent cache, or (None, ()) when a
    teacher fn carries no stamped ``.stack`` (nothing stable to key on).
    The teacher weights join the key by value: the same stacks fused under
    other importances must not hit."""
    ids, referents = [], []
    for f in teacher_logit_fns:
        stack = getattr(f, "stack", None)
        if stack is None:
            return None, ()
        leaves = tree_leaves(stack)
        ids.extend(id(x) for x in leaves)
        referents.extend(leaves)
    referents.append(pool)
    w_key = (None if teacher_weights is None else tuple(
        float(w) for w in torch.as_tensor(teacher_weights).reshape(-1)))
    return (tuple(ids), id(pool), dtype_name, w_key), referents


def resolve_bank(teacher_logit_fns: Sequence[Callable], source, fusion, *,
                 sharding=None, expected_steps: Optional[int] = None,
                 teacher_weights=None
                 ) -> Tuple[Optional[LogitBank], str]:
    """Resolve ``FusionConfig.logit_bank`` against the source.

    Returns ``(bank_or_None, reason)``, reason one of ``built`` /
    ``reused`` (a :data:`PERSISTENT_BANK` hit) / ``off`` / ``no_teachers``
    / ``no_pool`` / ``skipped_small_run``.  ``auto`` builds whenever the
    source has a pool and the run is expected to touch at least ``N`` pool
    rows (``expected_steps x batch_size >= N``); a shorter run keeps the
    on-the-fly path.  A cached bank costs no forward, so the lookup comes
    before that break-even skip.  ``teacher_weights`` fold into the bank
    rows (:func:`build_logit_bank`); a ``sharding`` shards them and skips
    the persistent cache."""
    mode = getattr(fusion, "logit_bank", "off")
    if mode not in LOGIT_BANK_MODES:
        raise ValueError(f"logit_bank must be one of {LOGIT_BANK_MODES}, "
                         f"got {mode!r}")
    if mode == "off":
        return None, "off"
    if not teacher_logit_fns:
        return None, "no_teachers"
    pool = source.pool()
    if pool is None:
        if mode == "on":
            warnings.warn(
                f"logit_bank='on' but source {type(source).__name__} has "
                f"no indexable pool(); falling back to on-the-fly teacher "
                f"forwards", UserWarning, stacklevel=2)
        return None, "no_pool"
    bank_dtype(fusion.bank_dtype)
    key, referents = (None, ()) if sharding is not None else \
        _identity_key(teacher_logit_fns, pool, fusion.bank_dtype,
                      teacher_weights)
    cached = PERSISTENT_BANK.lookup(key)
    if cached is not None:
        with _trace.span("bank_reuse", pool_n=len(pool)):
            return dataclasses.replace(cached, reused=True), "reused"
    if (mode == "auto" and expected_steps is not None
            and expected_steps * fusion.batch_size < len(pool)):
        return None, "skipped_small_run"
    with _trace.span("bank_build", pool_n=len(pool),
                     n_teachers=len(teacher_logit_fns)):
        bank = build_logit_bank(teacher_logit_fns, pool,
                                dtype=fusion.bank_dtype, sharding=sharding,
                                teacher_weights=teacher_weights)
    if key is not None:
        PERSISTENT_BANK.store(key, referents, bank)
    return bank, "built"
