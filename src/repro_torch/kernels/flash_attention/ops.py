"""Public entry points of flash attention: the reference's op, and the
op with a gradient for training.

`flash_attention_op` ports `repro.kernels.flash_attention.ops.
flash_attention_op`.  The
reference's ``block_q``/``block_k`` choose the Pallas kernel's tiles and
require S and T to be multiples of them; the CUDA kernels' tiles are fixed
(see `kernel.py`) and take any S and T, so here they are accepted for the
signature's sake and do not change the result.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention
from .ref import flash_attention_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window=None, block_q: int = 128,
                       block_k: int = 128) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, KH, T, D] -> [B, H, S, D] through the
    `flash_attention` wrapper (the CUDA kernel on a CUDA tensor)."""
    del block_q, block_k                  # the kernels' tiles are fixed
    return flash_attention(q, k, v, causal=causal, window=window)


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` with a gradient.

    Forward: the `flash_attention` wrapper (on a CUDA tensor one launch of
    a hand-written kernel), saving q, k and v, not the [S, T] scores.
    Backward: the plain version (`flash_attention_ref`, float32 scores,
    as the reference's XLA autodiff of its `sdpa`) recomputed on q, k, v
    detached and widened to float32, under `torch.enable_grad`, and
    `torch.autograd.grad` of it with the incoming gradient (widened too),
    each result rounded once to its input's dtype; one layer's scores
    exist only during that layer's backward.  The Pallas kernel has no
    backward either; a hand-written backward kernel is later work
    (ROADMAP B)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().to(torch.float32).requires_grad_()
                   for t in saved]
            out = flash_attention_ref(*qkv, causal=ctx.causal,
                                      window=ctx.window)
            grads = torch.autograd.grad(out, qkv,
                                        grad_out.to(torch.float32))
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None, None)


def flash_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window=None) -> torch.Tensor:
    """`flash_attention_op` with a gradient (`FlashAttentionFn`)."""
    return FlashAttentionFn.apply(q, k, v, causal, window)


__all__ = ["FlashAttentionFn", "flash_attention_fn", "flash_attention_op",
           "flash_attention_ref"]
