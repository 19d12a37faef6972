"""Client-side local training (Algorithm 2).

:func:`make_batched_local_update` trains ALL active clients of a round at
once: the parameters are stacked to a leading client axis [K, ...], the
round's batches to ``[K, n_steps, B, ...]``, and each local step runs one
batched forward/backward over the K clients (``torch.matmul`` broadcasts
over the client axis; the summed per-client losses give every client
exactly its own gradient).  Clients with fewer steps than the scan length
are masked: padded steps are no-ops through ``torch.where`` on the step
mask, parameters and optimizer state alike (Adam's ``m`` and ``v``), so
each client's trajectory equals its own sequential run
(:func:`make_local_update`).  The loop issues no host sync.

Low-bit clients (Table 4) run their forwards through ``quantize`` inside
the loss, on the full-precision master copy (the straight-through
estimator, ``core/quantize.py``); the batched update calls it with
``stacked=True``.  With ``dp_clip`` set, each client's upload is clipped
and noised against the round's global model after its last step
(``core/privacy.py``), its noise drawn on the host from its own seed.

With a ``mesh`` the client axis is sharded over ``client_axis``, as
JAX's ``shard_map`` with ``P(client_axis)`` lays it out: rank ``r`` of
``n`` trains the contiguous clients ``[r K/n, (r+1) K/n)`` of the round's
batches (built whole on every rank, so every draw matches the one-device
run) and the ranks' uploads are all-gathered to the full ``[K, ...]``
stack on every rank.

The numpy batch builders are verbatim copies of the JAX package's, so both
packages train on bitwise-identical batches.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.pytree import (tree_flatten, tree_map,
                                       tree_unflatten)
from repro_torch.core.nets import Net
from repro_torch.core.privacy import (NormalDraws, normal_draws,
                                      privatize_update_stacked)
from repro_torch.optim.optimizers import Optimizer, apply_updates


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the batch axis (the last axis before the
    classes): a scalar for [B, C] logits, one value per client for
    stacked [K, B, C] logits."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0].mean(dim=-1)


def make_local_update(net: Net, opt: Optimizer, *, prox_mu: float = 0.0,
                      quantize: Optional[Callable] = None):
    """One client's local training, step by step: the sequential reference
    the batched update is held against.

    Returns ``fn(params, xb [n,B,...], yb [n,B], anchor) -> params`` with
    every tensor on one device.  ``anchor`` is the round's global model
    (FedProx pulls towards it when ``prox_mu > 0``); ``quantize`` maps the
    params the forward sees."""

    def run(params, xb, yb, anchor):
        flat = {p: v.detach().clone() for p, v in
                tree_flatten(params).items()}
        trainable = net.trainable_mask(params)
        names = [p for p in flat if trainable[p]]
        anchors = tree_flatten(anchor)
        state = opt.init([flat[p] for p in names])
        for i in range(int(xb.shape[0])):
            with torch.enable_grad():
                leaves = {p: v.detach().requires_grad_(trainable[p])
                          for p, v in flat.items()}
                tree = tree_unflatten(leaves)
                logits, stats = net.apply_with_stats(
                    tree if quantize is None else quantize(tree), xb[i])
                loss = softmax_xent(logits, yb[i])
                if prox_mu > 0.0:
                    sq = sum(((leaves[p] - anchors[p].detach()) ** 2).sum()
                             for p in names)
                    loss = loss + 0.5 * prox_mu * sq
                grads = torch.autograd.grad(loss, [leaves[p] for p in names])
            with torch.no_grad():
                cur = [flat[p] for p in names]
                deltas, state = opt.update(list(grads), state, cur, i)
                for p, v in zip(names, apply_updates(cur, deltas)):
                    flat[p] = v
                stats = tree_flatten(stats)
                for p in flat:
                    if not trainable[p]:  # BN running stats from the forward
                        flat[p] = stats[p].detach().to(flat[p].dtype)
        return tree_unflatten(flat)

    return run


def make_batched_local_update(net: Net, opt: Optimizer, *,
                              prox_mu: float = 0.0,
                              quantize: Optional[Callable] = None,
                              dp_clip: Optional[float] = None,
                              dp_noise_multiplier: float = 0.0,
                              dp_draws: NormalDraws = normal_draws,
                              mesh=None, client_axis: str = "data"):
    """Vectorized local training for all K active clients of a round.

    Returns ``fn(params, xb [K,n,B,...], yb [K,n,B], anchor, step_mask
    [K,n], dp_seeds=None) -> stacked params [K, ...]`` with every tensor
    on one device.  ``params`` / ``anchor`` are the round's (unstacked)
    global tree; FedProx pulls each client towards ``anchor`` when
    ``prox_mu > 0``.  ``quantize(params, stacked=True)`` maps the params
    every forward sees.  With ``dp_clip`` set, client ``k``'s upload is
    privatized against ``anchor`` with noise drawn by ``dp_draws`` from
    ``dp_seeds[k]``.  With a ``mesh`` each rank trains its block of the
    client axis over ``client_axis`` (K must be a multiple of the axis
    size) and every rank returns the all-gathered ``[K, ...]`` stack."""

    def run(params, xb, yb, anchor, step_mask, dp_seeds=None):
        if dp_clip is not None and dp_seeds is None:
            raise ValueError("DP uploads need one noise seed per client")
        k, n_steps = int(xb.shape[0]), int(xb.shape[1])
        flat = {p: v.detach().unsqueeze(0).expand(k, *v.shape).clone()
                for p, v in tree_flatten(params).items()}
        trainable = net.trainable_mask(params)
        names = [p for p in flat if trainable[p]]
        anchors = tree_flatten(anchor)
        state = opt.init([flat[p] for p in names])

        def keep(valid, new, old):
            """``new`` for the clients whose step is real, else ``old``."""
            return torch.where(valid.reshape((k,) + (1,) * (old.dim() - 1)),
                               new, old)

        for s in range(n_steps):
            x, y, valid = xb[:, s], yb[:, s], step_mask[:, s]
            with torch.enable_grad():
                leaves = {p: v.detach().requires_grad_(trainable[p])
                          for p, v in flat.items()}
                tree = tree_unflatten(leaves)
                logits, stats = net.apply_with_stats(
                    tree if quantize is None
                    else quantize(tree, stacked=True), x)
                # per-client mean losses, summed: each client's gradient is
                # exactly that of its own loss
                loss = softmax_xent(logits, y).sum()
                if prox_mu > 0.0:
                    sq = sum(((leaves[p] - anchors[p].detach()) ** 2).sum()
                             for p in names)
                    loss = loss + 0.5 * prox_mu * sq
                grads = torch.autograd.grad(loss, [leaves[p] for p in names])
            with torch.no_grad():
                cur = [flat[p] for p in names]
                # padded steps sit at the end, so a valid step's index is s
                deltas, new_state = opt.update(list(grads), state, cur, s)
                for p, v in zip(names, apply_updates(cur, deltas)):
                    flat[p] = keep(valid, v, flat[p])
                stats = tree_flatten(stats)
                for p in flat:
                    if not trainable[p]:  # BN running stats from the forward
                        flat[p] = keep(valid, stats[p].to(flat[p].dtype),
                                       flat[p])
                state = type(state)(*([keep(valid, a, b) for a, b in
                                       zip(new, old)]
                                      for new, old in zip(new_state, state)))
        stack = tree_unflatten(flat)
        if dp_clip is not None:
            with torch.no_grad():
                stack = privatize_update_stacked(
                    anchor, stack, clip=dp_clip,
                    noise_multiplier=dp_noise_multiplier, seeds=dp_seeds,
                    draws=dp_draws)
        return stack

    if mesh is None:
        return run
    from repro_torch.common.sharding import (all_gather, axis_index,
                                             axis_size)
    n_ranks = axis_size(mesh, client_axis)
    me = axis_index(mesh, client_axis)

    def sharded(params, xb, yb, anchor, step_mask, dp_seeds=None):
        k = int(xb.shape[0])
        if k % n_ranks:
            raise ValueError(
                f"a client axis of {k} does not divide over the "
                f"{client_axis!r} mesh axis ({n_ranks} ranks)")
        block = slice(me * (k // n_ranks), (me + 1) * (k // n_ranks))
        local = run(params, xb[block], yb[block], anchor, step_mask[block],
                    None if dp_seeds is None else list(dp_seeds)[block])
        return tree_map(lambda v: all_gather(v, mesh, (client_axis,)),
                        local)

    return sharded


def build_batches(x: np.ndarray, y: np.ndarray, batch_size: int, epochs: int,
                  seed: int):
    """[n_steps, B, ...] arrays for the scanned local update."""
    rng = np.random.default_rng(seed)
    n = len(y)
    steps_per_epoch = max(1, n // batch_size)
    xs, ys = [], []
    for _ in range(epochs):
        if n >= batch_size:
            order = rng.permutation(n)[: steps_per_epoch * batch_size]
        else:
            order = rng.choice(n, size=batch_size, replace=True)
        xe = x[order].reshape(steps_per_epoch, batch_size, *x.shape[1:])
        ye = y[order].reshape(steps_per_epoch, batch_size)
        xs.append(xe)
        ys.append(ye)
    return np.concatenate(xs), np.concatenate(ys)


def n_local_steps(n_samples: int, batch_size: int, epochs: int) -> int:
    """Scan length :func:`build_batches` produces for a client of
    ``n_samples`` examples."""
    return epochs * max(1, n_samples // batch_size)


def build_batched_batches(x: np.ndarray, y: np.ndarray,
                          parts: Sequence[np.ndarray], batch_size: int,
                          epochs: int, seeds: Sequence[int],
                          n_steps: Optional[int] = None):
    """Stack every active client's scanned batches to one round tensor.

    Returns ``(xb [K,n,B,...], yb [K,n,B], step_mask [K,n])``.  Clients with
    fewer steps than ``n_steps`` (or the round maximum) are zero-padded at
    the END and masked out, preserving step-for-step equivalence with the
    sequential path.  Pass a fixed ``n_steps`` (max over ALL clients) so
    every round reuses one compiled program.
    """
    per = [build_batches(x[idx], y[idx], batch_size, epochs, seed=s)
           for idx, s in zip(parts, seeds)]
    steps = [xb.shape[0] for xb, _ in per]
    n = max(steps) if n_steps is None else n_steps
    if n < max(steps):
        raise ValueError(f"n_steps={n} < max client steps {max(steps)}")
    k = len(per)
    xb = np.zeros((k, n) + per[0][0].shape[1:], per[0][0].dtype)
    yb = np.zeros((k, n) + per[0][1].shape[1:], per[0][1].dtype)
    step_mask = np.zeros((k, n), bool)
    for i, (xk, yk) in enumerate(per):
        xb[i, : len(xk)] = xk
        yb[i, : len(yk)] = yk
        step_mask[i, : len(xk)] = True
    return xb, yb, step_mask


# ---------------------------------------------------------------------------
# step-count bucketing (docs/bucketing.md)
#
# Padding every client of a prototype group to the group-wide maximum scan
# length is what makes ONE compiled program per prototype possible, but on
# a skewed Dirichlet split the largest client can have 10-50x the steps of
# the median, so most vmapped lanes burn masked no-op FLOPs.  Bucketing
# partitions the clients into a small FIXED set of step capacities
# (computed once per run from the static per-client step counts) and runs
# one vmapped scan per bucket: a 10-step client no longer scans 500 padded
# steps, and the compile count stays bounded by buckets x prototypes.
# ---------------------------------------------------------------------------


def bucket_capacities(step_counts: Sequence[int], kind: str,
                      max_buckets: int = 4) -> List[int]:
    """The run-fixed set of scan-length capacities for one prototype group.

    Returns an ascending list whose LAST entry is exactly
    ``max(step_counts)`` (so a single bucket reproduces the unbucketed
    path bit-for-bit) and whose length is ``<= max_buckets``.

    ``pow2``      capacities are powers of two clipped at the maximum; when
                  that yields more than ``max_buckets``, the LARGEST
                  capacities are kept (small clients fall into bigger
                  buckets — more padding, never a truncated scan).
    ``quantile``  capacities at ``max_buckets`` evenly-spaced quantiles of
                  the step-count distribution (always including the max).
    ``none``      the single group-wide maximum: today's padded path.
    """
    steps = sorted(int(s) for s in step_counts)
    if not steps:
        return [1]
    smax = steps[-1]
    if kind == "none" or max_buckets <= 1 or steps[0] == smax:
        return [smax]
    if kind == "pow2":
        caps = sorted({min(1 << (int(s) - 1).bit_length() if s > 1 else 1,
                           smax) for s in steps} | {smax})
        return caps[-max_buckets:]
    if kind == "quantile":
        qs = [steps[min(len(steps) - 1,
                        int(np.ceil((i + 1) / max_buckets * len(steps))) - 1)]
              for i in range(max_buckets)]
        return sorted(set(qs) | {smax})
    raise ValueError(f"unknown bucket kind {kind!r}; expected one of "
                     f"('none', 'pow2', 'quantile')")


def assign_buckets(step_counts: Sequence[int],
                   caps: Sequence[int]) -> np.ndarray:
    """Index of the smallest capacity holding each client's step count."""
    idx = np.searchsorted(np.asarray(caps), np.asarray(step_counts),
                          side="left")
    if (idx >= len(caps)).any():
        raise ValueError(f"step count(s) exceed the largest bucket "
                         f"capacity {caps[-1]}")
    return idx


def build_bucketed_batches(
        x: np.ndarray, y: np.ndarray, parts: Sequence[np.ndarray],
        batch_size: int, epochs: int, seeds: Sequence[int],
        caps: Sequence[int],
) -> List[Tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Bucketed variant of :func:`build_batched_batches`.

    Partitions the clients over the run-fixed ``caps`` (ascending scan
    capacities, see :func:`bucket_capacities`) and stacks each bucket's
    scanned batches separately, padded only to the BUCKET's capacity.

    Returns one ``(bucket_index, positions, xb, yb, step_mask)`` tuple per
    non-empty bucket, where ``positions`` are the clients' indices into
    ``parts`` — each client's batch stream is byte-identical to the one
    :func:`build_batched_batches` builds (same per-client seeds, same
    order), only the zero-padded tail is shorter.
    """
    steps = [n_local_steps(len(idx), batch_size, epochs) for idx in parts]
    which = assign_buckets(steps, caps)
    out = []
    for b in range(len(caps)):
        pos = np.flatnonzero(which == b)
        if not len(pos):
            continue
        xb, yb, mask = build_batched_batches(
            x, y, [parts[i] for i in pos], batch_size, epochs,
            seeds=[seeds[i] for i in pos], n_steps=int(caps[b]))
        out.append((b, pos, xb, yb, mask))
    return out


def stacked_logits_fn(net: Net):
    """``fn(stacked params [K, ...], x [B, ...]) -> [K, B, C]`` in eval
    mode: the stacked forward broadcasts over the client axis."""
    def fn(stack, x):
        with torch.no_grad():
            return net.apply(stack, x, train=False)
    return fn


def evaluate_stacked(net: Net, stack, x: torch.Tensor, y: torch.Tensor,
                     batch_size: int = 512) -> np.ndarray:
    """Per-client top-1 accuracies [K] of a stacked tree, one stacked
    forward per batch; the counts are read once."""
    fn = stacked_logits_fn(net)
    correct = None
    for s in range(0, len(y), batch_size):
        pred = fn(stack, x[s:s + batch_size]).argmax(dim=-1)     # [K, b]
        hit = (pred == y[s:s + batch_size][None]).sum(dim=-1)
        correct = hit if correct is None else correct + hit
    return correct.cpu().numpy() / len(y)


def evaluate(net: Net, params: dict, x: torch.Tensor, y: torch.Tensor,
             batch_size: int = 512, quantize: Optional[Callable] = None
             ) -> float:
    """Top-1 accuracy in eval mode (BN uses running stats), of the
    ``quantize``d params when given.  ``x`` and ``y`` live on the params'
    device; the count is read once."""
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    with torch.no_grad():
        if quantize is not None:
            params = quantize(params)
        for s in range(0, len(y), batch_size):
            pred = net.apply(params, x[s:s + batch_size],
                             train=False).argmax(dim=-1)
            correct += (pred == y[s:s + batch_size]).sum()
    return int(correct.item()) / len(y)
