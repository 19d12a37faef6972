"""The AVGLOGITS KL kernels against raw or pre-averaged teachers on the
card (K2f / K2b and K3f / K3b).

CUDA source: ``kernels/csrc/ensemble_kl.cu``; it replaces the Pallas TPU
kernels ``_fwd_kernel`` / ``_bwd_kernel`` of the JAX package's
``kernels/ensemble_kl.py``, reached through ``ensemble_kl`` (K2: raw
teachers ``[K, B, V]``, the on-the-fly distillation path) and
``ensemble_kl_pre`` (K3: one ``[B, V]`` row per sample, the weighted
teacher consensus of the buffered-async driver).  :func:`ensemble_kl` and
:func:`ensemble_kl_pre` bind each pair as one ``torch.autograd.Function``:
the loss ``T^2 * mean_b KL(softmax(mean_k t_k / T) || softmax(s_b / T))``
is differentiable in the student logits only.

These wrappers take CUDA tensors only; ``kernels/ops.py`` routes CPU
tensors to the plain versions in ``kernels/ref.py``.  Every launch adds
one to ``LAUNCHES[<kernel>]``, so a run can show it went through the
kernels.

:func:`plan` chooses each launch's shape on the host, in plain Python, so
the CPU tests can check it: the forward's mode (lane groups at small V, a
thread-block cluster per row at large V with few rows, one block per row
otherwise), its lanes per row, cluster size, threads and grid, and the
backward's flat grid over the ``B * V`` elements.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "ensemble_kl"
LAUNCHES: Dict[str, int] = {"ensemble_kl_fwd": 0, "ensemble_kl_bwd": 0,
                            "ensemble_kl_pre_fwd": 0,
                            "ensemble_kl_pre_bwd": 0}
# teacher dtype -> the C interface's teacher_kind
TEACHER_KINDS = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # student, teachers, kl, lse_t, lse_s, K, B, V, T, kind, batch, mode,
    # lanes, cluster, threads, grid, device, stream
    "ensemble_kl_fwd": [_P] * 5 + [_I, _I, _I, _F] + [_I] * 8 + [_P],
    # student, teachers, lse_t, lse_s, g, ds, K, B, V, T, kind, batch,
    # threads, grid, device, stream
    "ensemble_kl_bwd": [_P] * 6 + [_I, _I, _I, _F] + [_I] * 5 + [_P],
    # the same without K (it is 1)
    "ensemble_kl_pre_fwd": [_P] * 5 + [_I, _I, _F] + [_I] * 8 + [_P],
    "ensemble_kl_pre_bwd": [_P] * 6 + [_I, _I, _F] + [_I] * 5 + [_P],
}

# Streaming multiprocessors of an H100 SXM: the plan's default when it is
# not given the card's own count.
SMS = 132
# The thresholds between the forward modes, from card times
# (benchmarks/torch_k2_modes.py; PERF.md).  Lane groups win while a lane
# owns one element; one block per row wins up to two elements a thread;
# past that, rows too few to fill the SMs take a cluster of C blocks each,
# the largest C that keeps B * C within CLUSTER_FILL blocks an SM.
LANES_MAX_V = 32
LANE_BLOCK_THREADS = 128      # threads of a lane-group block
ROW_BLOCK_THREADS = 256       # most threads of a cluster or row block
CLUSTER_SIZES = (2, 4, 8)     # portable thread-block cluster sizes
CLUSTER_FILL = 2.5
TEACHER_BATCHES = (1, 4, 8)   # teacher loads a lane keeps in flight
BWD_THREADS = 256
BWD_MAX_BLOCKS = 1 << 20      # past this the backward walks grid-stride
# the C interface's mode argument
MODES = {"lanes": 0, "cluster": 1, "block": 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one ``(B, V)`` launch maps onto the card.

    Forward: ``mode`` is ``lanes`` (``lanes`` threads per row, a power of
    two up to 32; ``rows_per_block`` rows a block), ``cluster`` (a cluster
    of ``cluster`` blocks per row, block r reducing the r-th slice of
    ``ceil(V / cluster)`` elements) or ``block`` (one block per row).  In
    the last two, ``lanes`` is the block's ``threads``.  Backward: a flat
    grid of ``bwd_grid`` blocks of ``bwd_threads`` over the ``B * V``
    elements.  Both load the K teachers of an element ``teacher_batch`` at
    a time (the kernel is compiled for 1, 4 and 8)."""
    teacher_batch: int
    mode: str
    lanes: int
    rows_per_block: int
    cluster: int
    threads: int
    grid: int
    bwd_threads: int
    bwd_grid: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round32(n: int) -> int:
    return 32 * _cdiv(n, 32)


@functools.lru_cache(maxsize=1024)
def plan(k: int, b: int, v: int, sms: int = SMS) -> Plan:
    """The launch plan for ``k`` teachers over ``b`` rows of ``v`` classes
    on a card of ``sms`` streaming multiprocessors."""
    if k < 1 or b < 1 or v < 1 or sms < 1:
        raise ValueError(f"no plan for K={k}, B={b}, V={v} on {sms} SMs")
    # the smallest batch that holds all K, else 8 at a time: a small K runs
    # no dead loads, a large K keeps 8 in flight
    batch = next((n for n in TEACHER_BATCHES if n >= k), TEACHER_BATCHES[-1])
    bwd_threads = min(BWD_THREADS, _round32(b * v))
    bwd_grid = min(_cdiv(b * v, bwd_threads), BWD_MAX_BLOCKS)
    if v <= LANES_MAX_V:
        lanes = min(32, 1 << (v - 1).bit_length())
        threads = min(LANE_BLOCK_THREADS, _round32(b * lanes))
        rows = threads // lanes
        return Plan(batch, "lanes", lanes, rows, 1, threads, _cdiv(b, rows),
                    bwd_threads, bwd_grid)
    if b < sms and v > 2 * ROW_BLOCK_THREADS:
        c = max((c for c in CLUSTER_SIZES if b * c <= CLUSTER_FILL * sms),
                default=CLUSTER_SIZES[0])
        threads = min(ROW_BLOCK_THREADS, _round32(_cdiv(v, c)))
        return Plan(batch, "cluster", threads, 1, c, threads, b * c,
                    bwd_threads, bwd_grid)
    threads = min(ROW_BLOCK_THREADS, _round32(v))
    return Plan(batch, "block", threads, 1, 1, threads, b, bwd_threads,
                bwd_grid)


_SMS: Dict[int, int] = {}


def card_plan(device: torch.device, k: int, b: int, v: int) -> Plan:
    """:func:`plan` for the CUDA card ``device``, with its SM count."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return plan(k, b, v, _SMS[index])


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_FNS: Dict[str, Callable] = {}


def _fn(name: str):
    """The C entry point, built and typed on first use."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.library(SOURCE), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(student: torch.Tensor, teachers: torch.Tensor, pre: bool
           ) -> Tuple[int, int, int]:
    """(K, B, V) of a valid launch; raises on what the kernel does not
    take."""
    if student.device.type != "cuda":
        raise ValueError(f"the CUDA KL kernel takes CUDA tensors, got the "
                         f"student on {student.device}")
    if teachers.device != student.device:
        raise ValueError(f"teachers are on {teachers.device}, the student "
                         f"on {student.device}")
    if student.dtype != torch.float32:
        raise TypeError(f"student logits must be float32, got "
                        f"{student.dtype}")
    if teachers.dtype not in TEACHER_KINDS:
        raise TypeError(f"teacher dtype {teachers.dtype} is not one of "
                        f"{list(TEACHER_KINDS)}")
    want_dim = 2 if pre else 3
    if student.dim() != 2 or teachers.dim() != want_dim:
        raise ValueError(f"expected student [B, V] and teachers "
                         f"{'[B, V]' if pre else '[K, B, V]'}; got "
                         f"{tuple(student.shape)}, {tuple(teachers.shape)}")
    b, v = student.shape
    k = 1 if pre else teachers.shape[0]
    if tuple(teachers.shape[-2:]) != (b, v):
        raise ValueError(f"shape mismatch: student {tuple(student.shape)}, "
                         f"teachers {tuple(teachers.shape)}")
    if b == 0 or v == 0 or k == 0:
        raise ValueError("empty student batch or teacher ensemble")
    if k * b * v >= 2 ** 62 or max(k, b, v) >= 2 ** 31:
        raise ValueError("shape exceeds the kernel's index range")
    for name, t in (("student", student), ("teachers", teachers)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return k, b, v


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kl_fwd(student, teachers, temperature: float = 1.0, pre: bool = False,
           launch: Plan | None = None):
    """K2f (``pre=False``, teachers [K, B, V]) or K3f (``pre=True``, rows
    [B, V]): per-row ``(kl, lse_t, lse_s)``, each float32 [B].  ``launch``
    overrides :func:`card_plan` (to time the modes against each other)."""
    k, b, v = _check(student, teachers, pre)
    kl, lse_t, lse_s = (torch.empty(b, device=student.device,
                                    dtype=torch.float32) for _ in range(3))
    name = "ensemble_kl_pre_fwd" if pre else "ensemble_kl_fwd"
    shape = (b, v) if pre else (k, b, v)
    p = launch or card_plan(student.device, k, b, v)
    err = _fn(name)(student.data_ptr(), teachers.data_ptr(), kl.data_ptr(),
                    lse_t.data_ptr(), lse_s.data_ptr(), *shape,
                    float(temperature), TEACHER_KINDS[teachers.dtype],
                    p.teacher_batch, MODES[p.mode], p.lanes, p.cluster,
                    p.threads, p.grid,
                    student.device.index, _stream(student))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return kl, lse_t, lse_s


def kl_bwd(student, teachers, lse_t, lse_s, g, temperature: float = 1.0,
           pre: bool = False):
    """K2b / K3b: ``d loss / d student`` [B, V] float32 for the cotangent
    ``g`` (a 0-dim float32 CUDA tensor, read by the kernel: no host
    sync)."""
    k, b, v = _check(student, teachers, pre)
    for name, t, shape in (("lse_t", lse_t, (b,)), ("lse_s", lse_s, (b,)),
                           ("g", g, ())):
        if (t.device != student.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{shape} tensor on {student.device}")
    ds = torch.empty_like(student)
    name = "ensemble_kl_pre_bwd" if pre else "ensemble_kl_bwd"
    shape = (b, v) if pre else (k, b, v)
    p = card_plan(student.device, k, b, v)
    err = _fn(name)(student.data_ptr(), teachers.data_ptr(),
                    lse_t.data_ptr(), lse_s.data_ptr(), g.data_ptr(),
                    ds.data_ptr(), *shape, float(temperature),
                    TEACHER_KINDS[teachers.dtype], p.teacher_batch,
                    p.bwd_threads, p.bwd_grid,
                    student.device.index, _stream(student))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return ds


class _EnsembleKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, student, teachers, temperature, pre):
        kl, lse_t, lse_s = kl_fwd(student, teachers, temperature, pre)
        ctx.save_for_backward(student, teachers, lse_t, lse_s)
        ctx.temperature, ctx.pre = temperature, pre
        # a fixed-order device reduction (no atomics): repeatable bit for bit
        return kl.sum() / student.shape[0] * temperature ** 2

    @staticmethod
    def backward(ctx, g):
        student, teachers, lse_t, lse_s = ctx.saved_tensors
        ds = kl_bwd(student, teachers, lse_t, lse_s, g.float().contiguous(),
                    ctx.temperature, ctx.pre)
        return ds, None, None, None


def ensemble_kl(student, teachers, temperature: float = 1.0):
    """K2: AVGLOGITS loss against the raw teachers, on the card.
    student: [B, V] float32 CUDA (differentiable); teachers: [K, B, V]
    float32 or bfloat16."""
    return _EnsembleKL.apply(student, teachers, float(temperature), False)


def ensemble_kl_pre(student, consensus, temperature: float = 1.0):
    """K3: AVGLOGITS loss against pre-averaged teacher rows (the weighted
    consensus), on the card.  consensus: [B, V] float32 or bfloat16."""
    return _EnsembleKL.apply(student, consensus, float(temperature), True)
