"""GQA attention with RoPE: the prefill forward and the decode path.

Port of `repro.models.attention`: `KVCache`, `init_attn`, `_project_qkv`,
`_mask`, `sdpa` (the einsum reference path, scores in float32 with -1e30
on masked keys), `attention` (the train/prefill self-attention, with a
gradient through the kernel on the card),
`init_cache` and `decode_attention`.  The reference's other prefill forms
(`sdpa_chunked`, `sdpa_banded`), cross-attention and `prefill_cache` wait
for later slices (ROADMAP A13).

Unlike the reference's pure functions, `decode_attention` writes the new
key, value and position into the cache's tensors in place (the port's
choice: a functional copy would copy every layer's cache each step) and
returns the same cache.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..kernels.flash_attention.ops import (flash_attention_fn,
                                          flash_attention_op)
from .common import Init, apply_rope


class KVCache(NamedTuple):
    """Ring-buffer KV cache with explicit absolute positions.

    For full-attention layers T_cache = max_len; for sliding-window layers
    T_cache = window (the ring wraps).  `kpos` records each slot's absolute
    position (-1 = empty); `pos` is one position shared by every batch row
    (the reference's: all slots of a serving batch advance together).
    Stacked caches carry a leading [L] axis on every field.
    """
    k: torch.Tensor      # [B, T_cache, KH, D]
    v: torch.Tensor      # [B, T_cache, KH, D]
    kpos: torch.Tensor   # [T_cache] int32 absolute positions (-1 = empty)
    pos: torch.Tensor    # [] int32 — next absolute position to write


def init_attn(cfg, ini: Init, *, kv_heads: int | None = None) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    KH = kv_heads or cfg.n_kv_heads
    Dh = cfg.head_dim
    p = {
        "wq": ini.param((d, H, Dh), ("embed", "heads", "head_dim")),
        "wk": ini.param((d, KH, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ini.param((d, KH, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ini.param((H, Dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.param((H, Dh), ("heads", "head_dim"), kind="zeros")
        p["bk"] = ini.param((KH, Dh), ("kv_heads", "head_dim"), kind="zeros")
        p["bv"] = ini.param((KH, Dh), ("kv_heads", "head_dim"), kind="zeros")
    return p


def _project_qkv(cfg, p, x, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """[..., S, T] boolean validity mask from absolute positions."""
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        m &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def sdpa(q, k, v, mask) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,KH,D], mask [B,S,T] -> [B,S,H,D]."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qh = q.reshape(B, S, KH, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qh, k) / math.sqrt(D)
    scores = torch.where(mask[:, None, None, :, :],
                         scores.to(torch.float32), -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, D)


def attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
              window: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """Full (train/prefill) self-attention: x [B, S, d] -> [B, S, d].

    The core is chosen by the device.  On CUDA it is the hand-written
    kernel, given the [B, S, H, D] projections as their [B, H, S, D]
    ``transpose(1, 2)`` views (the kernel reads strides, so nothing is
    copied) and masking by index: through `flash_attention_fn`, which
    carries the gradient (`FlashAttentionFn`), when the projections need
    one (training), and through `flash_attention_op` otherwise (prefill,
    and any forward whose weights need no gradient).  On the CPU it is
    `sdpa` with
    `_mask` over ``positions``: the reference's "naive" impl.  The two
    agree because every caller passes positions = arange(S) (`lm_logits`),
    so position and index coincide.  The reference's sharding constraints
    and context parallelism do not apply on one device."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    if x.device.type == "cuda":
        core = (flash_attention_fn if any(t.requires_grad for t in (q, k, v))
                else flash_attention_op)
        out = core(*(t.contiguous().transpose(1, 2) for t in (q, k, v)),
                   causal=causal, window=window).transpose(1, 2)
    else:
        pos = positions if positions.dim() == 2 else positions[None, :]
        pos = pos.expand(x.shape[:2])
        out = sdpa(q, k, v, _mask(pos, pos, causal=causal, window=window))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def init_cache(cfg, batch: int, max_len: int, dtype, *,
               kv_heads: int | None = None, window: Optional[int] = None,
               device=None) -> KVCache:
    """An empty KV cache on ``device``: CUDA unless the caller asks for
    the CPU."""
    device = resolve_device(device)
    KH = kv_heads or cfg.n_kv_heads
    T_cache = min(window, max_len) if window else max_len
    shape = (batch, T_cache, KH, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((T_cache,), -1, dtype=torch.int32,
                              device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def decode_attention(cfg, p: dict, x: torch.Tensor, cache: KVCache, *,
                     window: Optional[int] = None):
    """x: [B, 1, d]; writes at pos % T_cache (in place), attends over the
    valid slots, advances pos.  Returns (y [B, 1, d], cache)."""
    B = x.shape[0]
    T_cache = cache.k.shape[1]
    positions = cache.pos.reshape(1, 1).expand(B, 1)
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    wslot = torch.remainder(cache.pos, T_cache).reshape(1).long()
    cache.k.index_copy_(1, wslot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, wslot, v_new.to(cache.v.dtype))
    cache.kpos.index_copy_(0, wslot, cache.pos.reshape(1))
    valid = (cache.kpos >= 0) & (cache.kpos <= cache.pos)
    if window is not None:
        valid &= cache.kpos > cache.pos - window
    mask = valid[None, None, :].expand(B, 1, T_cache)
    out = sdpa(q, cache.k, cache.v, mask)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    cache.pos.add_(1)
    return y, cache
