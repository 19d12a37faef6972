"""Process-wide work counters used as test and bench evidence.

:class:`TraceCounter` is an alias of :class:`repro_torch.obs.metrics.
Counter`; module-level counters next to what they count (``TEACHER_
FORWARDS`` in ``core/logit_bank.py``) are entries of the unified
:data:`repro_torch.obs.metrics.REGISTRY` under dotted names, so per-round
metric records and ``RunResult.summary()["obs"]`` enumerate them.  The
JAX package's retrace counters have no counterpart: nothing compiles in
the port.
"""
from __future__ import annotations

from repro_torch.obs.metrics import Counter as TraceCounter

__all__ = ["TraceCounter"]
