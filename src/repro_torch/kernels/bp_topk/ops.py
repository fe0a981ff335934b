"""Gate entry point over any leading token axes, on top of `bp_topk`.

Port of `repro.kernels.bp_topk.ops`: `bp_topk_op` flattens the leading
axes of [..., E] scores into the kernel's [T, E] rows and restores them on
the outputs (the JAX package's `_route` does the same reshape around its
call).
"""
from __future__ import annotations

import torch

from .kernel import bp_topk
from .ref import bp_topk_ref


def bp_topk_op(scores: torch.Tensor, bias: torch.Tensor, k: int):
    """scores [..., E] float32, bias [E] -> (idx [..., k] int32,
    w [..., k] float32) through the `bp_topk` wrapper."""
    lead, E = scores.shape[:-1], scores.shape[-1]
    idx, w = bp_topk(scores.reshape(-1, E).contiguous(), bias.contiguous(), k)
    return idx.reshape(*lead, k), w.reshape(*lead, k)


__all__ = ["bp_topk_op", "bp_topk_ref"]
