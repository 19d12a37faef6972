"""Shared option-literal sets for the fusion knobs and the spec axes.

A copy of the literal tables of the JAX package, so that the port's spec
validation and its runtime resolvers (``core/logit_bank.py``,
``kernels/ops.py``) agree without importing that package.  Dependency-free.
"""
from __future__ import annotations

LOGIT_BANK_MODES = ("auto", "on", "off")
# float32 keeps bank trajectories identical to on-the-fly; bfloat16 halves
# the rows; int8 / fp8_e4m3 store quantized rows plus one fp32 scale per row
BANK_DTYPES = ("float32", "bfloat16", "int8", "fp8_e4m3")
# the subset of BANK_DTYPES stored as (quantized rows, per-row fp32 scale)
QUANTIZED_BANK_DTYPES = ("int8", "fp8_e4m3")
FUSED_KERNEL_MODES = (True, False, "auto")

# step-count bucketing of the round engine's client axis
BUCKET_KINDS = ("none", "pow2", "quantile")

# client arrival processes of the population traffic model
ARRIVAL_KINDS = ("always", "bernoulli")

# fault-injection / defense knobs
SCREEN_MODES = ("auto", "on", "off")
BYZANTINE_MODES = ("sign_flip", "scale")

# transports and wire codecs of the distributed runtime (``dist/``), and
# the cohort samplers of the population layer
TRANSPORT_KINDS = ("loopback", "tcp")
WIRE_CODECS = ("fp32", "binarize", "int8")
SAMPLER_KINDS = ("uniform", "capacity_aware", "prioritized")
