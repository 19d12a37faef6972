"""Flash attention, causal or bidirectional, with an optional sliding window
on the card (K4).

CUDA source: ``kernels/csrc/swa_attn.cu``; it replaces the Pallas TPU
kernel ``_swa_kernel`` of the JAX package's ``kernels/swa_attn.py``
(forward only, as there).  :func:`swa_attn` takes q ``[B, H, S, D]`` and
k, v ``[B, H_kv, S, D]`` with ``H_kv`` dividing ``H`` (grouped-query
attention: query head h reads key / value head ``h // (H // H_kv)``, as the
JAX models' ``_sdpa`` groups them), float32 or bfloat16, ``D <= 256``, and
returns the output in q's dtype.  ``causal=False`` is the encoder's
bidirectional mask (a template mode of the kernel; a window stays one-sided,
``i - j < window``, as the JAX models mask).

This wrapper takes CUDA tensors only; ``kernels/ops.py`` routes CPU tensors
to the plain version ``kernels/ref.py:swa_attn``, and gives CUDA tensors
a gradient by recomputing the plain version in the backward pass (the JAX
package has no backward kernel either).  Every launch adds one to
``LAUNCHES["swa_attn"]``, so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

SOURCE = "swa_attn"
LAUNCHES: Dict[str, int] = {"swa_attn": 0}
# launches by the input's dtype ("float32", "bfloat16"), reset with LAUNCHES
LAUNCH_DTYPES: Dict[str, int] = {}
KINDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
# q, k, v, o, bh, h, h_kv, s, d, window, scale, causal, kind, device, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]
_FN = []


def reset_launches() -> None:
    LAUNCHES["swa_attn"] = 0
    LAUNCH_DTYPES.clear()


def _fn():
    """The C entry point, built and typed on first use."""
    if not _FN:
        fn = build.library(SOURCE).swa_attn_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def swa_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: Optional[int], causal: bool = True) -> torch.Tensor:
    """K4: attention of q ``[B, H, S, D]`` over k, v ``[B, H_kv, S, D]``
    (contiguous, one CUDA device, one dtype, ``H_kv`` dividing ``H``),
    causal or not, each query limited to keys ``j > i - window`` when
    ``window`` is not None."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA attention kernel takes CUDA tensors, got "
                         f"q on {q.device}")
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, S, D], got {tuple(q.shape)}")
    b, h, s, d = q.shape
    h_kv = k.shape[1] if k.dim() == 4 else 0
    for name, t in (("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != (b, h_kv, s, d)
                or h_kv == 0 or h % h_kv):
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; q is {q.dtype} {tuple(q.shape)} "
                             f"on {q.device} (k and v [B, H_kv, S, D], "
                             f"H_kv dividing H)")
    if q.dtype not in KINDS:
        raise TypeError(f"dtype {q.dtype} is not one of {list(KINDS)}")
    if b * h == 0 or s == 0 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"shape {tuple(q.shape)} outside the kernel's range "
                         f"(non-empty, D <= {MAX_HEAD_DIM})")
    if b * h >= 2 ** 31 or -(-s // 64) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    o = torch.empty_like(q)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b * h, h, h_kv, s, d,
                0 if window is None else min(int(window), s),
                1.0 / math.sqrt(d), int(bool(causal)), KINDS[q.dtype],
                q.device.index,
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swa_attn launch failed with cudaError {err}")
    LAUNCHES["swa_attn"] += 1
    kind = str(q.dtype).removeprefix("torch.")
    LAUNCH_DTYPES[kind] = LAUNCH_DTYPES.get(kind, 0) + 1
    return o
