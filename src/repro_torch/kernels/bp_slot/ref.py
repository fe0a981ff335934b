"""Plain PyTorch versions of the per-slot decision (bp_slot kernel family).

Port of `repro.kernels.bp_slot.ref`, batched: every panel gains a leading
fleet axis [B].  The expressions and their evaluation order are the JAX
package's, so on identical float32 inputs they give identical bits.  They
are what the wrappers in `kernel.py` run for CPU tensors, and what the CUDA
kernels are held to, bit for bit, on the card.

Tie-break contract: the routing argmax and the load-balance argmin resolve
ties to the lowest index, like `torch.argmax`/`torch.argmin` (first
occurrence).
"""
from __future__ import annotations

import torch

#: Order of the 12 per-comp-node panels in the stacked [B, 12, NC] layout
#: that `comp_balance_decide` hands its CUDA kernel.
PANELS = ("q0", "q1", "q2", "H", "caps", "mask", "x1", "x2", "ca1", "ca2",
          "cc", "x_net")


def pair_count(x1, x2, ca1, ca2, cc, x_net, pairing: str):
    """P_n(t): combinable same-tag pairs at each comp node, [B, NC]."""
    if pairing == "fifo":
        P = torch.minimum(ca1, ca2) - cc
    elif pairing == "bound":
        P = (x1 + x2 - x_net) / 2.0
    else:
        raise ValueError(f"unknown pairing model {pairing!r}")
    # jnp.clip(P, 0, hi) == minimum(maximum(P, 0), hi)
    return torch.minimum(torch.clamp(P, min=0.0), torch.minimum(x1, x2))


def combine_amount(P, caps, xsum, thresholded: bool, threshold: float):
    """Z_n(t): pairs actually combined, capped by capacity and optionally
    gated by the pi1' threshold (combine only when X1+X2 >= 2 C_n + X̄)."""
    if thresholded:
        gate = xsum >= 2.0 * caps + threshold
        return torch.minimum(torch.where(gate, caps, torch.zeros_like(caps)),
                             P)
    return torch.minimum(P, caps)


def balance_score(eps, q0, q1, q2, H, mask):
    """Join-shortest-sum-of-queues score (paper eq. (9)), +inf on masked
    comp nodes.  ``eps`` is [B]; the panels are [B, NC]."""
    score = (1.0 + eps)[:, None] * q0 + q1 + q2 + H
    if mask is None:
        return score
    return torch.where(mask > 0, score, torch.full_like(score, float("inf")))


def slot_route_ref(Qf: torch.Tensor, m_idx: torch.Tensor, l_idx: torch.Tensor):
    """BP routing decision over the flattened class axis.

    Qf: [B, N, C] per-node backlogs, classes flattened i-major
    (`Q.reshape(B, N, -1)`); m_idx/l_idx: [B, E] endpoints.  Returns
    (best [B, E] int32 flat class index, dmax [B, E] signed differential).
    Builds the whole [B, E, C] differential.
    """
    C = Qf.shape[-1]
    qm = torch.gather(Qf, 1, m_idx.long()[..., None].expand(-1, -1, C))
    ql = torch.gather(Qf, 1, l_idx.long()[..., None].expand(-1, -1, C))
    diff = qm - ql
    best = torch.argmax(diff.abs(), dim=2)
    dmax = torch.gather(diff, 2, best[..., None])[..., 0]
    return best.to(torch.int32), dmax


def comp_balance_ref(eps, q0, q1, q2, H, caps, mask, x1, x2, ca1, ca2, cc,
                     x_net, *, pairing: str, thresholded: bool,
                     threshold: float):
    """Per-comp-node decision: pairs -> combine amount Z, and the masked
    load-balance argmin n_star, from one set of panels.

    ``eps`` is [B]; every other input a [B, NC] panel.  Returns
    (Z [B, NC] f32, n_star [B] i32).
    """
    capm = caps * mask
    P = pair_count(x1, x2, ca1, ca2, cc, x_net, pairing)
    Z = combine_amount(P, capm, x1 + x2, thresholded, threshold)
    score = balance_score(eps, q0, q1, q2, H, mask)
    return Z, torch.argmin(score, dim=1).to(torch.int32)
