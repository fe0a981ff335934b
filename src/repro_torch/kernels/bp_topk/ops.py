"""Gate entry points: `bp_topk_op` over any leading token axes, and the
whole gate of one MoE layer with a gradient for training.

`bp_topk_op` ports `repro.kernels.bp_topk.ops`: it flattens the leading
axes of [..., E] scores into the kernel's [T, E] rows and restores them on
the outputs (the JAX package's `_route` does the same reshape around its
call).  `BpTopkRouteFn` is `bp_topk_route` with the gradient of its
weights.
"""
from __future__ import annotations

import torch

from .kernel import bp_topk, bp_topk_route
from .ref import bp_topk_ref


def bp_topk_op(scores: torch.Tensor, bias: torch.Tensor, k: int):
    """scores [..., E] float32, bias [E] -> (idx [..., k] int32,
    w [..., k] float32) through the `bp_topk` wrapper."""
    lead, E = scores.shape[:-1], scores.shape[-1]
    idx, w = bp_topk(scores.reshape(-1, E).contiguous(), bias.contiguous(), k)
    return idx.reshape(*lead, k), w.reshape(*lead, k)


class BpTopkRouteFn(torch.autograd.Function):
    """`bp_topk_route` with the gradient of its weights ``w``.

    Forward: the wrapper (on a CUDA tensor one launch of the fused gate).
    The picks, counts, new queues and steps are not differentiable: the
    reference stops the gradient at the bias H / C, the counts and H
    (`repro.models.moe._route`).  Backward, for ``w`` only, in closed form
    from the saved logits and picks: with p = softmax(logits) in float32,
    s the sum of the picked p and g the incoming gradient,

        dL/dp_m = (g_m - sum_j g_j w_j) / max(s, 1e-9)  for picked m, else 0,
        dL/dlogits = p * (dL/dp - <p, dL/dp>),

    the gradient of the reference's take-along-axis of the probabilities
    at the picks, renormalised (``w`` recomputed from p in float32, as
    the reference's training path computes it)."""

    @staticmethod
    def forward(ctx, logits, H, steps, cap, k, backpressure):
        idx, w, counts, H_new, steps_new = bp_topk_route(
            logits, H, steps, cap, k, backpressure)
        ctx.mark_non_differentiable(idx, counts, H_new, steps_new)
        ctx.save_for_backward(logits, idx)
        return idx, w, counts, H_new, steps_new

    @staticmethod
    def backward(ctx, _d_idx, d_w, _d_counts, _d_H, _d_steps):
        logits, idx = ctx.saved_tensors
        p = torch.softmax(logits.to(torch.float32), dim=-1)
        picked = torch.gather(p, 1, idx)
        s = torch.clamp(picked.sum(-1, keepdim=True), min=1e-9)
        g = d_w.to(torch.float32)
        d_sel = (g - (g * (picked / s)).sum(-1, keepdim=True)) / s
        d_p = torch.zeros_like(p).scatter_(1, idx, d_sel)   # distinct picks
        d_logits = p * (d_p - (p * d_p).sum(-1, keepdim=True))
        return d_logits.to(logits.dtype), None, None, None, None, None


def bp_topk_route_fn(logits, H, steps, cap: float, k: int,
                     backpressure: bool):
    """`bp_topk_route` with the gradient of ``w`` (`BpTopkRouteFn`)."""
    return BpTopkRouteFn.apply(logits, H, steps, cap, k, backpressure)


__all__ = ["BpTopkRouteFn", "bp_topk_op", "bp_topk_ref", "bp_topk_route_fn"]
