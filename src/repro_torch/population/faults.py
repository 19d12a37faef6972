"""Deterministic fault injection + upload screening for the population.

:class:`FaultModel` mirrors :class:`~repro_torch.population.traffic.TrafficModel`:
every draw is keyed on ``(salt, seed, domain, wave, client, attempt)``
through ``np.random.default_rng``'s SeedSequence, so the fault trace is a
pure function of (config, seed) — resuming a run never replays or shifts
which uploads are corrupted, and a retry (``attempt`` bump) redraws the
transport faults without touching any sequential RNG state.

Fault taxonomy (docs/robustness.md):

- **byzantine** — a persistent (static-domain) subset of clients whose
  upload delta is adversarially transformed every round: ``sign_flip``
  sends ``base - scale * delta``, ``scale`` sends ``base + scale * delta``.
- **crash** — the client dies mid-upload: all parameters after a random
  cut point in the flattened payload arrive as zeros (a torn, partial
  upload).
- **bitflip** — transport corruption of the serialized payload: a few
  random bits of one float32 tensor are XOR'd (float32 viewed as uint32).
- **nan** — one tensor entry is replaced by NaN/+Inf/-Inf.

Corruption operates on host-side numpy leaf lists (the one-row trees the
drivers move around, in the JAX package's leaf order:
``common/pytree.tree_leaves_jax``), never on the device.  The module is
the JAX package's, copied verbatim: its draws match bit for bit.

:class:`NormScreen` is the matching defense: finite-ness checks plus
robust-z (median / MAD) outlier screening of upload delta norms, either
within one cohort (sync driver) or against a rolling per-prototype window
of accepted norms (buffered_async).  Its rolling state checkpoints through
``state_dict`` so resumed runs screen identically.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.population.config import FaultConfig

_SALT = 0xFA_17BAD
_DOMAINS = {"static": 0, "corrupt": 1, "transport": 2}

# MAD floor as a fraction of the median: when honest norms are (near)
# identical the MAD collapses to 0 and any jitter would z-score to
# infinity; requiring > sigma * 5% relative deviation keeps honest
# uploads safe while scale-10 byzantine deltas still score in the 100s.
_REL_MAD_FLOOR = 0.05
_MAD_TO_SIGMA = 1.4826


class FaultModel:
    """Counter-based corruption draws for ``n`` registered clients."""

    def __init__(self, cfg: FaultConfig, seed: int, n: int):
        cfg.validate()
        self.cfg = cfg
        self.seed = int(seed)
        self.n = int(n)
        rng = self._rng("static", 0, 0, 0)
        self.byzantine = (rng.random(self.n) < cfg.byzantine_frac
                          if cfg.byzantine_frac > 0
                          else np.zeros(self.n, np.bool_))

    def _rng(self, domain: str, wave: int, client: int,
             attempt: int) -> np.random.Generator:
        return np.random.default_rng(
            (_SALT, self.seed, _DOMAINS[domain], int(wave), int(client),
             int(attempt)))

    # -- injection -------------------------------------------------------

    def corrupt(self, wave: int, client: int, leaves: Sequence[np.ndarray],
                base_leaves: Sequence[np.ndarray],
                attempt: int = 0) -> Tuple[List[np.ndarray], Tuple[str, ...]]:
        """Apply this upload's faults; returns ``(new_leaves, kinds)``.

        ``leaves`` / ``base_leaves`` are matching flat leaf lists of the
        uploaded params and the global model they trained from.  Input
        arrays are never mutated; untouched leaves are passed through by
        reference.  ``kinds`` names the fault classes that fired (empty
        for a clean upload).
        """
        cfg = self.cfg
        out: List[np.ndarray] = [np.asarray(l) for l in leaves]
        kinds: List[str] = []
        if self.byzantine[int(client)]:
            scale = cfg.byzantine_scale
            for i, (l, b) in enumerate(zip(out, base_leaves)):
                if not np.issubdtype(l.dtype, np.floating):
                    continue
                b = np.asarray(b, l.dtype)
                delta = l.astype(np.float64) - b.astype(np.float64)
                if cfg.byzantine_mode == "sign_flip":
                    new = b.astype(np.float64) - scale * delta
                else:
                    new = b.astype(np.float64) + scale * delta
                out[i] = new.astype(l.dtype)
            kinds.append("byzantine")
        rng = self._rng("corrupt", wave, client, attempt)
        # one unconditional uniform per fault class keeps the draw layout
        # (and thus every downstream draw) stable as rates are tuned
        u = rng.random(3)
        if cfg.crash_rate > 0 and u[0] < cfg.crash_rate:
            self._crash(rng, out)
            kinds.append("crash")
        if cfg.bitflip_rate > 0 and u[1] < cfg.bitflip_rate:
            if self._bitflip(rng, out):
                kinds.append("bitflip")
        if cfg.nan_rate > 0 and u[2] < cfg.nan_rate:
            if self._poison(rng, out):
                kinds.append("nan")
        return out, tuple(kinds)

    @staticmethod
    def _crash(rng: np.random.Generator, out: List[np.ndarray]) -> None:
        sizes = [int(l.size) for l in out]
        total = sum(sizes)
        if total < 2:
            return
        cut = int(rng.integers(1, total))  # at least one param survives
        seen = 0
        for i, l in enumerate(out):
            if seen >= cut:
                out[i] = np.zeros_like(l)
            elif seen + sizes[i] > cut:
                flat = np.array(l).reshape(-1)
                flat[cut - seen:] = 0
                out[i] = flat.reshape(l.shape)
            seen += sizes[i]

    def _bitflip(self, rng: np.random.Generator,
                 out: List[np.ndarray]) -> bool:
        cand = [i for i, l in enumerate(out)
                if l.dtype == np.float32 and l.size > 0]
        if not cand:
            return False
        i = int(cand[int(rng.integers(len(cand)))])
        flat = np.array(out[i]).reshape(-1)
        nb = self.cfg.bitflip_bits
        idx = rng.integers(0, flat.size, size=nb)
        bits = rng.integers(0, 32, size=nb).astype(np.uint32)
        view = flat.view(np.uint32)
        view[idx] ^= np.uint32(1) << bits
        out[i] = flat.reshape(out[i].shape)
        return True

    # -- transport domain (distributed runtime, docs/distributed.md) ----

    def transport_fault(self, wave: int, pod: int,
                        attempt: int) -> Optional[str]:
        """Fault class for one UPLOAD frame, keyed ``(round, pod, attempt)``.

        Returns ``"disconnect"`` / ``"drop"`` / ``"corrupt"`` / ``"delay"``
        or None.  One unconditional uniform per class keeps the draw
        layout stable as rates are tuned; an ``attempt`` bump (a retry)
        is a fresh draw, never a replay.  At most one class
        fires per frame, checked in severity order.
        """
        cfg = self.cfg
        rng = self._rng("transport", wave, pod, attempt)
        u = rng.random(4)
        if cfg.transport_disconnect > 0 and u[0] < cfg.transport_disconnect:
            return "disconnect"
        if cfg.transport_drop > 0 and u[1] < cfg.transport_drop:
            return "drop"
        if cfg.transport_corrupt > 0 and u[2] < cfg.transport_corrupt:
            return "corrupt"
        if cfg.transport_delay > 0 and u[3] < cfg.transport_delay:
            return "delay"
        return None

    def corrupt_frame(self, wave: int, pod: int, attempt: int,
                      data: bytes, n_bytes: int = 4) -> bytes:
        """Deterministically flip ``n_bytes`` bytes of an encoded frame.

        Re-derives the same generator as :meth:`transport_fault` (skipping
        its four class uniforms) so the corruption positions are a pure
        function of (config, seed, round, pod, attempt).
        """
        rng = self._rng("transport", wave, pod, attempt)
        rng.random(4)  # skip the class draws
        buf = bytearray(data)
        if not buf:
            return bytes(buf)
        idx = rng.integers(0, len(buf), size=n_bytes)
        masks = rng.integers(1, 256, size=n_bytes)
        for i, m in zip(idx, masks):
            buf[int(i)] ^= int(m)
        return bytes(buf)

    @staticmethod
    def _poison(rng: np.random.Generator, out: List[np.ndarray]) -> bool:
        cand = [i for i, l in enumerate(out)
                if np.issubdtype(l.dtype, np.floating) and l.size > 0]
        if not cand:
            return False
        i = int(cand[int(rng.integers(len(cand)))])
        flat = np.array(out[i]).reshape(-1)
        j = int(rng.integers(flat.size))
        flat[j] = (np.nan, np.inf, -np.inf)[int(rng.integers(3))]
        out[i] = flat.reshape(out[i].shape)
        return True


def _float_leaves(leaves: Sequence[np.ndarray]) -> List[np.ndarray]:
    return [np.asarray(l) for l in leaves
            if np.issubdtype(np.asarray(l).dtype, np.floating)]


def leaves_finite(leaves: Sequence[np.ndarray]) -> bool:
    """True iff every float leaf is entirely finite (host-side)."""
    return all(bool(np.isfinite(l).all()) for l in _float_leaves(leaves))


def delta_norm(leaves: Sequence[np.ndarray],
               base_leaves: Sequence[np.ndarray]) -> float:
    """Global L2 norm of the upload delta across float leaves."""
    total = 0.0
    for l, b in zip(leaves, base_leaves):
        l = np.asarray(l)
        if not np.issubdtype(l.dtype, np.floating):
            continue
        d = l.astype(np.float64) - np.asarray(b, np.float64)
        total += float(np.sum(d * d))
    return math.sqrt(total)


def robust_z(values: np.ndarray, center: float, mad: float) -> np.ndarray:
    """|z| against a median/MAD location estimate, with a relative floor."""
    denom = _MAD_TO_SIGMA * mad + _REL_MAD_FLOOR * abs(center) + 1e-12
    return np.abs(np.asarray(values, np.float64) - center) / denom


def outlier_mask(norms: Sequence[float], sigma: float) -> np.ndarray:
    """Within-cohort screen: True where a norm is a robust-z outlier.

    Non-finite norms are always outliers; the median/MAD baseline is
    computed over the finite subset only.
    """
    norms = np.asarray(norms, np.float64)
    bad = ~np.isfinite(norms)
    finite = norms[~bad]
    if finite.size == 0:
        return np.ones_like(bad)
    med = float(np.median(finite))
    mad = float(np.median(np.abs(finite - med)))
    z = robust_z(norms, med, mad)
    return bad | (z > sigma)


class NormScreen:
    """Rolling per-prototype delta-norm screen for the buffered path.

    Keeps a bounded window of recently *accepted* norms per prototype;
    an incoming upload is rejected when its norm robust-z-scores beyond
    ``sigma`` against that window.  The first ``min_history`` uploads per
    prototype are screened for finiteness only (no baseline yet).
    """

    def __init__(self, sigma: float = 6.0, window: int = 128,
                 min_history: int = 4):
        self.sigma = float(sigma)
        self.window = int(window)
        self.min_history = int(min_history)
        self.history: Dict[int, List[float]] = {}

    def check(self, proto: int, norm: float) -> Tuple[bool, Optional[str]]:
        """Screen one upload; accepted norms enter the window."""
        if not math.isfinite(norm):
            return False, "nonfinite"
        hist = self.history.setdefault(int(proto), [])
        if len(hist) >= self.min_history:
            arr = np.asarray(hist, np.float64)
            med = float(np.median(arr))
            mad = float(np.median(np.abs(arr - med)))
            if float(robust_z(np.asarray([norm]), med, mad)[0]) > self.sigma:
                return False, "norm_outlier"
        hist.append(float(norm))
        if len(hist) > self.window:
            del hist[:len(hist) - self.window]
        return True, None

    # -- checkpointing ---------------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        d: Dict[str, np.ndarray] = {
            "protos": np.asarray(sorted(self.history), np.int64)}
        for p in sorted(self.history):
            d[f"hist_{p}"] = np.asarray(self.history[p], np.float64)
        return d

    def load_state(self, d: Dict[str, np.ndarray]) -> None:
        self.history = {}
        for p in np.asarray(d["protos"], np.int64).tolist():
            self.history[int(p)] = [
                float(x) for x in np.asarray(d[f"hist_{p}"], np.float64)]
