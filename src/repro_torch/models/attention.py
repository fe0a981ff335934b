"""GQA attention with RoPE: the prefill forward, cross-attention and the
decode path; and multi-head latent attention (MLA), prefill only.

Port of `repro.models.attention`: `KVCache`, `init_attn`, `_project_qkv`,
`_mask`, `sdpa` (the einsum reference path, scores in float32 with -1e30
on masked keys), the online-softmax forms `sdpa_chunked` and
`sdpa_banded`, `attention` (the train/prefill self-attention, with a
gradient through the kernel on the card), `cross_attention` and
`encode_kv` (the encoder-decoder's), `init_cache`, `prefill_cache` and
`decode_attention`.

Unlike the reference's pure functions, `decode_attention` writes the new
key, value and position into the cache's tensors in place (the port's
choice: a functional copy would copy every layer's cache each step) and
returns the same cache.

`mla_attention` is the port's own (the JAX package has no MLA): DeepSeek-V3's
latent attention for configs with a ``kv_lora_rank`` (`is_mla`), whose q/k
heads (no-RoPE part + RoPE part) are wider than its v heads; the cores
(`sdpa`, `sdpa_chunked`, `_kernel_core`) take v with its own head dim.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..kernels.flash_attention.ops import (flash_attention_fn,
                                          flash_attention_op)
from ..obs import spans
from ..runtime import flags
from .common import Init, apply_rope, rmsnorm


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
    """q [B,S,H,D], k [B,T,KH,D], v [B,T,KH,Dv], mask [B,S,T] ->
    [B,S,H,Dv]; scores scaled by 1/sqrt(D)."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    qh = q.reshape(B, S, KH, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qh, k) / math.sqrt(D)
    scores = torch.where(mask[:, None, None, :, :],
                         scores.to(torch.float32), -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, v.shape[-1])


def _pad_to(x, n: int, axis: int, value=0):
    """``x`` padded with ``value`` at the end of ``axis`` to a multiple of
    ``n``."""
    pad = (-x.shape[axis]) % n
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def sdpa_chunked(q, k, v, q_pos, k_pos, *, causal: bool,
                 window: Optional[int], chunk_q: int = 2048,
                 chunk_k: int = 2048) -> torch.Tensor:
    """Online-softmax attention over query and key chunks (the reference's
    `sdpa_chunked`, its nested scans as `flags.layer_scan` loops): no
    [S, T] score tensor, at most [chunk_q, chunk_k] per head.  Padded
    queries carry position -1e9, padded keys -1 (invalid).

    q [B,S,H,D]; k [B,T,KH,D]; v [B,T,KH,Dv]; q_pos [B,S]; k_pos [B,T]
    (-1 = invalid) -> [B,S,H,Dv]; scores scaled by 1/sqrt(D).
    """
    B, S, H, D = q.shape
    KH, T, Dv = k.shape[2], k.shape[1], v.shape[-1]
    G = H // KH
    cq, ck = min(chunk_q, S), min(chunk_k, T)
    qp = _pad_to(q, cq, 1)
    qpos = _pad_to(q_pos, cq, 1, value=-(10 ** 9))
    kp = _pad_to(k, ck, 1)
    vp = _pad_to(v, ck, 1)
    kpos = _pad_to(k_pos, ck, 1, value=-1)
    Sq, Tk = qp.shape[1], kp.shape[1]
    nq, nk = Sq // cq, Tk // ck

    qh = qp.reshape(B, nq, cq, KH, G, D).transpose(0, 1)
    qpos_c = qpos.reshape(B, nq, cq).transpose(0, 1)
    kh = kp.reshape(B, nk, ck, KH, D).transpose(0, 1)
    vh = vp.reshape(B, nk, ck, KH, Dv).transpose(0, 1)
    kpos_c = kpos.reshape(B, nk, ck).transpose(0, 1)
    scale = 1.0 / math.sqrt(D)

    def q_block(_, xs):
        qc, qpc = xs                               # [B,cq,KH,G,D], [B,cq]

        def kv_block(carry, xs2):
            m, l, acc = carry
            kc, vc, kpc = xs2                      # [B,ck,KH,D], [B,ck]
            s = torch.einsum("bskgd,btkd->bkgst", qc, kc) * scale
            s = s.to(torch.float32)
            valid = (kpc[:, None, :] >= 0) & (qpc[:, :, None] >= 0)
            if causal:
                valid &= qpc[:, :, None] >= kpc[:, None, :]
            if window is not None:
                valid &= kpc[:, None, :] > qpc[:, :, None] - window
            valid = valid[:, None, None]           # [B,1,1,cq,ck]
            s = torch.where(valid, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            l_new = l * alpha + p.sum(dim=-1)
            acc_new = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(vc.dtype), vc)
            return (m_new, l_new, acc_new.to(acc.dtype)), None

        dev = q.device
        m0 = torch.full((B, KH, G, cq), -1e30, dtype=torch.float32,
                        device=dev)
        l0 = torch.zeros((B, KH, G, cq), dtype=torch.float32, device=dev)
        a0 = torch.zeros((B, KH, G, cq, Dv), dtype=torch.float32, device=dev)
        (m, l, acc), _ = flags.layer_scan(kv_block, (m0, l0, a0),
                                          (kh, vh, kpos_c))
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return None, out.to(q.dtype)               # [B,KH,G,cq,Dv]

    _, outs = flags.layer_scan(q_block, None, (qh, qpos_c))
    # outs: [nq, B, KH, G, cq, Dv] -> [B, Sq, H, Dv]
    out = outs.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, KH * G, Dv)
    return out[:, :S]


def sdpa_banded(q, k, v, q_pos, k_pos, *, window: int) -> torch.Tensor:
    """Sliding-window attention in O(S * window): each query block of
    ``window`` rows attends to the previous block and its own, masked
    causally and by the window through the absolute positions (the
    reference's `sdpa_banded`).

    q [B,S,H,D]; k/v [B,T,KH,D] with S == T (self-attention only).
    """
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    cb = window
    qp = _pad_to(q, cb, 1)
    kp = _pad_to(k, cb, 1)
    vp = _pad_to(v, cb, 1)
    qpos = _pad_to(q_pos, cb, 1, value=-(10 ** 9))
    kpos = _pad_to(k_pos, cb, 1, value=-1)
    Sp = qp.shape[1]
    nb = Sp // cb

    qb = qp.reshape(B, nb, cb, KH, G, D)
    qpb = qpos.reshape(B, nb, cb)

    def banded(t, fill=0):  # [B, Sp, ...] -> [B, nb, 2cb, ...]
        tb = t.reshape(B, nb, cb, *t.shape[2:])
        prev = torch.cat([torch.full_like(tb[:, :1], fill), tb[:, :-1]],
                         dim=1)
        return torch.cat([prev, tb], dim=2)

    kb = banded(kp)
    vb = banded(vp)
    # block 0's shifted-in band must carry INVALID positions, not pos 0
    kpb = banded(torch.where(kpos < 0, -(10 ** 9), kpos)[..., None],
                 fill=-(10 ** 9))[..., 0]

    s = torch.einsum("bnskgd,bntkd->bkgnst", qb, kb) / math.sqrt(D)
    valid = (kpb[:, :, None, :] >= 0) & (qpb[:, :, :, None] >= 0)
    valid &= qpb[:, :, :, None] >= kpb[:, :, None, :]          # causal
    valid &= kpb[:, :, None, :] > qpb[:, :, :, None] - window  # window
    # s: [B,KH,G,nb,cb,2cb]; valid: [B,nb,cb,2cb] -> broadcast over KH,G
    s = torch.where(valid[:, None, None], s.to(torch.float32), -1e30)
    w = torch.softmax(s, dim=-1)
    any_valid = valid.any(dim=-1)                              # [B,nb,cb]
    w = torch.where(any_valid[:, None, None, :, :, None], w, 0.0)
    out = torch.einsum("bkgnst,bntkd->bnskgd", w.to(vb.dtype), vb)
    return out.reshape(B, Sp, KH * G, D)[:, :S]


def _kernel_core(q, k, v, *, causal: bool, window: Optional[int]):
    """The flash kernel on [B, S, H, D] q, [B, T, KH, D] k and
    [B, T, KH, Dv] v, given as their [B, H, S, D] ``transpose(1, 2)``
    views (the kernel reads strides), -> [B, S, H, Dv]: through
    `flash_attention_fn` (`FlashAttentionFn`, the gradient; dense copies
    of q, k and v, which it saves) when any input needs a gradient, else
    `flash_attention_op` on the views themselves where the head dim is
    contiguous (the wrapper copies what its kernel cannot read in place;
    MLA's v, a column slice of the latent expansion, it reads in place).
    """
    if any(t.requires_grad for t in (q, k, v)):
        return flash_attention_fn(
            *(t.contiguous().transpose(1, 2) for t in (q, k, v)),
            causal=causal, window=window).transpose(1, 2)
    return flash_attention_op(
        *((t if t.stride(-1) == 1 else t.contiguous()).transpose(1, 2)
          for t in (q, k, v)),
        causal=causal, window=window).transpose(1, 2)


def attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
              window: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """Full (train/prefill) self-attention: x [B, S, d] -> [B, S, d].

    On CUDA the core is the hand-written kernel (`_kernel_core`), masking
    by index, under either `runtime.flags.attention_impl`.  Index and
    position agree because every caller passes positions = arange(S)
    (`lm_logits`, with or without a prefix; `encdec.encode`).  Off the
    card (the CPU, and the dry-run's meta trace) the core is the
    reference's choice by the flags, over ``positions``: "chunked" with a
    window and causal is `sdpa_banded`; "chunked" otherwise
    `sdpa_chunked` with query chunks of 2048 (one chunk under
    `context_parallel`); "naive" the masked `sdpa`.  The reference's
    sharding constraints only shard and are left out."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = _core(q, k, v, positions, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def _core(q, k, v, positions, *, causal: bool, window: Optional[int]):
    """`attention`'s core on q [B, S, H, D], k [B, S, KH, D], v [B, S, KH,
    Dv] -> [B, S, H, Dv]: the flash kernel on CUDA, else the reference's
    choice by the flags (see `attention`)."""
    if q.device.type == "cuda":
        return _kernel_core(q, k, v, causal=causal, window=window)
    pos = positions if positions.dim() == 2 else positions[None, :]
    pos = pos.expand(q.shape[:2])
    if flags.attn_impl() == "chunked" and window is not None and causal:
        return sdpa_banded(q, k, v, pos, pos, window=window)
    if flags.attn_impl() == "chunked":
        cq = 10 ** 9 if flags.ctx_par() else 2048
        return sdpa_chunked(q, k, v, pos, pos, causal=causal, window=window,
                            chunk_q=cq)
    return sdpa(q, k, v, _mask(pos, pos, causal=causal, window=window))


# ---------------------------------------------------------------------------
# Multi-head latent attention (MLA)
# ---------------------------------------------------------------------------

def is_mla(cfg) -> bool:
    """Whether ``cfg``'s attention is MLA (a config with a latent rank)."""
    return getattr(cfg, "kv_lora_rank", 0) > 0


def init_mla(cfg, ini: Init) -> dict:
    """MLA's projections, as DeepSeek-V3 names them: ``wq`` (`q_proj`, no
    q latent), ``wkv_a`` (`kv_a_proj_with_mqa`: the latent c and the shared
    RoPE key), ``kv_norm`` (c's RMSNorm gain, held as g and applied as
    1 + g), ``wkv_b`` (`kv_b_proj`: c to every head's no-RoPE key and
    value) and ``wo`` (`o_proj`)."""
    d, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    Dn, Dr, Dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                  cfg.v_head_dim)
    return {
        "wq": ini.param((d, H, Dn + Dr), ("embed", "heads", "head_dim")),
        "wkv_a": ini.param((d, R + Dr), ("embed", None)),
        "kv_norm": ini.param((R,), (None,), kind="zeros"),
        "wkv_b": ini.param((R, H, Dn + Dv), (None, "heads", "head_dim")),
        "wo": ini.param((H, Dv, d), ("heads", "head_dim", "embed")),
    }


def _mla_qkv(cfg, p, x, positions):
    """x [B, S, d] -> q, k [B, S, H, Dn + Dr] and v [B, S, H, Dv]:

      q = x W_q, its last Dr columns rotated;
      [c, k_pe] = x W_kv_a, c = RMSNorm(c), k_pe rotated;
      [k_nope, v] = c W_kv_b per head;
      k = [k_nope, k_pe] with the one k_pe in every head.

    RoPE is the port's half-split rotation (`common.apply_rope`) over the
    Dr columns."""
    dt = x.dtype
    B, S, _ = x.shape
    R, Dn, Dr = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    kv = x @ p["wkv_a"].to(dt)                                # [B, S, R+Dr]
    c = rmsnorm(kv[..., :R], p["kv_norm"], cfg.norm_eps)
    kvb = torch.einsum("bsr,rhk->bshk", c, p["wkv_b"].to(dt))
    q_pe = apply_rope(q[..., Dn:], positions, cfg.rope_theta)
    k_pe = apply_rope(kv[..., None, R:], positions, cfg.rope_theta)
    q = torch.cat([q[..., :Dn], q_pe], dim=-1)
    k = torch.cat([kvb[..., :Dn], k_pe.expand(B, S, cfg.n_heads, Dr)],
                  dim=-1)
    return q, k, kvb[..., Dn:]


def mla_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Multi-head latent attention over the whole sequence (the prefill):
    x [B, S, d] -> [B, S, d].  q and k (`_mla_qkv`) have
    Dn + Dr columns a head and v Dv; scores scale by 1/sqrt(Dn + Dr); the
    core is `attention`'s (`_core`: on CUDA the flash kernel's (Dn + Dr,
    Dv) instance, masking by index, v read in place as the 128-column
    slice of the latent expansion), then ``wo``.  Spans: ``mla.latent``
    (the projections, the norm, RoPE and the K/V assembly) and
    ``mla.core``; counter ``mla.kv_expanded_bytes``, the bytes of K and V
    the latent expands to.  Decode through a latent cache is not ported
    (`transformer` refuses an MLA decode)."""
    dev = x.device
    with spans.span("mla.latent", device=dev):
        q, k, v = _mla_qkv(cfg, p, x, positions)
    spans.count("mla.kv_expanded_bytes",
                (k.numel() + v.numel()) * k.element_size())
    with spans.span("mla.core", device=dev):
        out = _core(q, k, v, positions, causal=causal, window=None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def cross_attention(cfg, p: dict, x: torch.Tensor, memory_kv,
                    mem_mask=None) -> torch.Tensor:
    """Decoder cross-attention of x [B, S, d] against precomputed memory
    K/V ([B, T, KH, D] each) -> [B, S, d].  On CUDA the core is the flash
    kernel, not causal and without a window (`_kernel_core`); the kernel
    takes no mask, so a ``mem_mask`` [B, S, T] (no caller passes one) is
    refused there.  On the CPU the core is `sdpa`, with the mask if
    given."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    k, v = memory_kv
    if x.device.type == "cuda":
        if mem_mask is not None:
            raise NotImplementedError(
                "cross_attention: the flash kernel takes no memory mask")
        out = _kernel_core(q, k, v, causal=False, window=None)
    else:
        B, S = x.shape[:2]
        m = (torch.ones((B, S, k.shape[1]), dtype=torch.bool,
                        device=x.device) if mem_mask is None else mem_mask)
        out = sdpa(q, k, v, m)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def encode_kv(cfg, p: dict, mem: torch.Tensor):
    """The memory's cross-attention K/V: mem [B, T, d] -> ([B, T, KH, D],
    [B, T, KH, D]) (no RoPE, as in the reference)."""
    dt = mem.dtype
    k = torch.einsum("btd,dhk->bthk", mem, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", mem, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


def init_cache(cfg, batch: int, max_len: int, dtype, *,
               kv_heads: int | None = None, window: Optional[int] = None,
               device=None, abstract: bool = False) -> KVCache:
    """An empty KV cache on ``device``: CUDA unless the caller asks for
    the CPU, the meta device when ``abstract``."""
    device = resolve_device(device, abstract)
    KH = kv_heads or cfg.n_kv_heads
    T_cache = min(window, max_len) if window else max_len
    shape = (batch, T_cache, KH, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((T_cache,), -1, dtype=torch.int32,
                              device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def prefill_cache(cache: KVCache, k: torch.Tensor,
                  v: torch.Tensor) -> KVCache:
    """Load a full prefix (no wrap) into a fresh cache; k/v: [B, S, KH, D].
    Returns a new cache, as the reference's does (the given one is left
    as it was)."""
    S = k.shape[1]
    kc, vc, kpos = cache.k.clone(), cache.v.clone(), cache.kpos.clone()
    kc[:, :S] = k.to(kc.dtype)
    vc[:, :S] = v.to(vc.dtype)
    kpos[:S] = torch.arange(S, dtype=torch.int32, device=kpos.device)
    return KVCache(kc, vc, kpos, torch.tensor(S, dtype=torch.int32,
                                              device=kpos.device))


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
