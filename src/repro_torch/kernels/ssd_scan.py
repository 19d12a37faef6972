"""The Mamba2 chunked SSD scan on the card (K5).

CUDA source: ``kernels/csrc/ssd_scan.cu``; it replaces the Pallas TPU
kernel ``_ssd_kernel`` of the JAX package's ``kernels/ssd_scan.py``
(forward only, as there).  :func:`ssd_scan` returns ``(y, final_state)``
as ``ssd_chunked`` does: the Pallas kernel drops the final state, but the
prefill cache needs it.  It starts from a given state ``[B, H, N, P]``
float32, as ``ssd_chunked(init_state=)`` does, or from zero.  The kernel
scans in chunks of ``CHUNK`` steps, whatever chunk the config names (the
function does not depend on the chunk, up to rounding).

This wrapper takes CUDA tensors only; ``kernels/ops.py`` routes CPU tensors
to the plain version ``kernels/ref.py:ssd_scan``, and gives CUDA tensors
a gradient by recomputing the plain version in the backward pass (the JAX
package has no backward kernel either).  Every launch adds one to
``LAUNCHES["ssd_scan"]``, so a run can show it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "ssd_scan"
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}
# launches by the input's dtype ("float32", "bfloat16"), reset with LAUNCHES
LAUNCH_DTYPES: Dict[str, int] = {}
KINDS = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64          # the kernel's own chunk (csrc/ssd_scan.cu kChunk)
MAX_STATE = 128     # N and P limits of the kernel's shared memory plan
MAX_HEAD_DIM = 128
# x, dt, a_log, bmat, cmat, init_state, y, final_state, b, s, h, p, n,
# kind, device, stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FN = []


def reset_launches() -> None:
    LAUNCHES["ssd_scan"] = 0
    LAUNCH_DTYPES.clear()


def _fn():
    """The C entry point, built and typed on first use."""
    if not _FN:
        fn = build.library(SOURCE).ssd_scan_fwd
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: x ``[B,S,H,P]``, dt ``[B,S,H]`` float32, a_log ``[H]`` float32,
    bmat / cmat ``[B,S,N]`` (x's dtype, float32 or bfloat16), and the
    initial state ``[B,H,N,P]`` float32 or None (zero), all contiguous on
    one CUDA device.  Returns y ``[B,S,H,P]`` in x's dtype and the final
    state ``[B,H,N,P]`` float32."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA SSD kernel takes CUDA tensors, got x on "
                         f"{x.device}")
    if x.dtype not in KINDS:
        raise TypeError(f"x dtype {x.dtype} is not one of {list(KINDS)}")
    if x.dim() != 4:
        raise ValueError(f"expected x [B, S, H, P], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = bmat.shape[-1] if bmat.dim() == 3 else -1
    want = {"dt": ((b, s, h), torch.float32, dt),
            "a_log": ((h,), torch.float32, a_log),
            "bmat": ((b, s, n), x.dtype, bmat),
            "cmat": ((b, s, n), x.dtype, cmat)}
    if init_state is not None:
        want["init_state"] = ((b, h, n, p), torch.float32, init_state)
    for name, (shape, dtype, t) in want.items():
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; expected {dtype} {shape} on "
                             f"{x.device}")
    if min(b, s, h, p, n) <= 0 or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"x {tuple(x.shape)}, N = {n} outside the kernel's "
                         f"range (non-empty, P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE})")
    if b * h >= 2 ** 31 or b * s * h * p >= 2 ** 62:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's range")
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("bmat", bmat),
                    ("cmat", cmat), ("init_state", init_state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(x)
    final = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    err = _fn()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                bmat.data_ptr(), cmat.data_ptr(),
                None if init_state is None else init_state.data_ptr(),
                y.data_ptr(),
                final.data_ptr(), b, s, h, p, n, KINDS[x.dtype],
                x.device.index,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed with cudaError {err}")
    LAUNCHES["ssd_scan"] += 1
    kind = str(x.dtype).removeprefix("torch.")
    LAUNCH_DTYPES[kind] = LAUNCH_DTYPES.get(kind, 0) + 1
    return y, final
