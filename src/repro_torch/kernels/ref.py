"""Plain PyTorch versions of the port's kernels (the allclose ground truth
on the card, and what CPU tensors run)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _mean_teacher(teacher_logits: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """``mean_k(t_k / T)`` in float32, in the Pallas kernel's order: the
    division happens in the teachers' own dtype (a bf16 quotient is
    rounded to bf16), then the mean over K in float32."""
    return (teacher_logits / temperature).float().mean(dim=0)


def ensemble_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """KL( softmax(mean_k teachers / T), softmax(student / T) ) * T^2,
    mean over batch rows.  student: [B, V]; teachers: [K, B, V].  Plain
    version of K2 (its gradient is autograd's)."""
    t = _mean_teacher(teacher_logits, temperature)
    s = (student_logits / temperature).float()
    logp_t = F.log_softmax(t, dim=-1)
    logp_s = F.log_softmax(s, dim=-1)
    kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_s), dim=-1)
    return kl.mean() * temperature ** 2


def ensemble_kl_grad(student_logits: torch.Tensor,
                     teacher_logits: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """d loss / d student = (softmax(s/T) - softmax(t̄/T)) * T / B, the
    plain version of K2b for a unit cotangent."""
    b = student_logits.shape[0]
    t = _mean_teacher(teacher_logits, temperature)
    s = (student_logits / temperature).float()
    g = (torch.softmax(s, -1) - torch.softmax(t, -1)) * temperature / b
    return g.to(student_logits.dtype)


def ensemble_kl_pre(student_logits: torch.Tensor,
                    teacher_avg_logits: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Plain version of K3: the K2 loss against pre-averaged teacher rows
    [B, V] (the weighted consensus)."""
    return ensemble_kl(student_logits, teacher_avg_logits[None], temperature)


def ensemble_kl_bank(student_logits: torch.Tensor, bank_rows: torch.Tensor,
                     row_scale: torch.Tensor, idx: torch.Tensor,
                     temperature: float = 1.0) -> torch.Tensor:
    """Plain version of the fused bank kernel pair (K1): gather the sampled
    bank rows, dequantize with their per-row scales, then the AVGLOGITS KL;
    autograd gives its gradient.  bank_rows: [N, V] any storage dtype;
    row_scale / idx: [B]."""
    t = bank_rows[idx].float() * row_scale[:, None]
    return ensemble_kl(student_logits, t[None], temperature)


# ---------------------------------------------------------------------------
# swa_attn: sliding-window (or full causal) attention (K4)
# ---------------------------------------------------------------------------

def swa_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int | None) -> torch.Tensor:
    """q: [B, H, S, D], k/v: [B, H_kv, S, D] with H_kv dividing H (query
    head h reads key head h // (H // H_kv)); causal, optionally limited to
    i - j < window.  Plain version of K4."""
    s = q.shape[2]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j <= i
    if window is not None:
        mask = mask & (i - j < window)
    scores = torch.where(mask, scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# ssd_scan: Mamba2 chunked state-space scan (K5)
# ---------------------------------------------------------------------------

def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, chunk: int):
    """Chunked SSD: the function of the JAX model's ``ssd_chunked`` from a
    zero state, with the within-chunk segment sums of ``dt * A`` summed
    directly rather than as differences of cumulative sums (see below).
    x:[B,S,H,P] dt:[B,S,H] a_log:[H] bmat/cmat:[B,S,N].  Returns
    (y [B,S,H,P] in x's dtype, final_state [B,H,N,P] float32).  Plain
    version of K5."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // q

    a = -torch.exp(a_log.float())  # [H], negative
    da = dt.float() * a  # [B,S,H]

    xc = x.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    dac = da.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()

    cum = torch.cumsum(dac, dim=2)  # [B,nc,Q,H]

    # segment sums seg_ij = sum_{k=j+1..i} da_k (i >= j), summed directly by
    # a cumulative sum over i of da masked to k > j: taking them as
    # cum_i - cum_j (as ssd_chunked does) loses ~eps * |cum| in the exponent,
    # percent-level errors once |cum| reaches ~1e5 within a chunk
    strict = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device), diagonal=-1)
    seg = torch.cumsum(torch.where(strict[None, None, :, :, None],
                                   dac[:, :, :, None, :], 0.0), dim=2)

    # intra-chunk: y_ij = (C_i.B_j) exp(seg_ij) dt_j x_j, j<=i; the upper
    # triangle is masked BEFORE the exp
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  -torch.inf))  # [B,nc,Q,Q,H]
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # [B,nc,Q,Q]
    kern = cb[..., None] * decay * dtc[:, :, None, :, :]  # [B,nc,Q,Q,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", kern, xc)

    # chunk states: S_c = sum_j exp(seg_{last,j}) dt_j B_j (x) x_j
    decay_end = torch.exp(seg[:, :, -1])  # [B,nc,Q,H]
    states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_end * dtc, bc, xc)

    # inter-chunk recurrence over nc, from a zero state
    total = torch.exp(cum[:, :, -1, :])  # [B,nc,H]
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)  # the state entering chunk c
        state = state * total[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # [B,nc,H,N,P]

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cc, torch.exp(cum),
                           entering)
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_scan_sequential(x, dt, a_log, bmat, cmat) -> torch.Tensor:
    """Step-by-step recurrence (an independent second oracle for the
    chunked algorithm)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    a = -torch.exp(a_log.float())
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        bt, ct = bmat[:, t].float(), cmat[:, t].float()
        decay = torch.exp(dtt * a)  # [B,H]
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dtt, bt, xt)
        ys.append(torch.einsum("bn,bhnp->bhp", ct, state))
    return torch.stack(ys, dim=1).to(x.dtype)
