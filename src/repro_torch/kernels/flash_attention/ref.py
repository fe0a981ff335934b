"""Plain PyTorch version of flash attention (GQA, causal and window masks).

Port of `repro.kernels.flash_attention.ref.attention_ref`: the scores are
materialized ([B, H, S, T] float32), masked by index with -1e30, and
softmaxed; rows with no valid key give 0 (the kernel's max(l, 1e-30)
guard).  The tests and `chip_smoke.py` hold the CUDA kernel to it; nothing
on the card's main path calls it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30     # the reference kernel's mask value


def key_mask(S: int, T: int, *, causal: bool, window, device=None):
    """[S, T] validity by index: query i sees key j when j <= i (causal)
    and j > i - window (window)."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qi >= kj
    if window is not None:
        mask &= kj > qi - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None) -> torch.Tensor:
    """q [B,H,S,D], k [B,KH,T,D], v [B,KH,T,Dv] -> [B,H,S,Dv] in q's dtype
    (f32 math, scores scaled by 1/sqrt(D)); query head h reads kv head
    h // (H / KH)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G = H // KH
    kk = k.repeat_interleave(G, dim=1).to(torch.float32)
    vv = v.repeat_interleave(G, dim=1).to(torch.float32)
    s = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32), kk) / \
        math.sqrt(D)
    mask = key_mask(S, T, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vv)
    any_valid = mask.any(dim=1)[:, None]
    return torch.where(any_valid, out, 0.0).to(q.dtype)
