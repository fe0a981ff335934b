"""Public entry point of flash attention, with the reference's signature.

Port of `repro.kernels.flash_attention.ops.flash_attention_op`.  The
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


__all__ = ["flash_attention_op", "flash_attention_ref"]
