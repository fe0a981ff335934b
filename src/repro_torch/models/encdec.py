"""Encoder-decoder backbone (seamless-m4t).

Port of `repro.models.encdec`: a bidirectional encoder over precomputed
frame embeddings (the modality frontend is a stub, as in the reference)
and a causal decoder with cross-attention.  On CUDA every attention core
is one flash kernel launch: the encoder's not causal, the decoder's self
attention causal, its cross-attention not causal against the memory
(`attention.cross_attention`); at decode the self-attention reads its
cache through the einsum `sdpa` and the cross-attention is the kernel at
one query row.  The reference's `lax.scan`s and `lax.map` over the
layers are Python loops over `unbind` views; `lm_decode_step` writes the
self cache in place, as the decoder-only decode does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..device import resolve_device
from . import transformer as tfm
from .attention import (KVCache, attention, cross_attention,
                        decode_attention, encode_kv, init_attn, init_cache)
from .common import (Init, cross_entropy, embed, init_embedding, init_mlp,
                     init_norm, norm, swiglu, unembed)


class EncDecCache(NamedTuple):
    self_kv: KVCache            # stacked [dec_layers], decoder self-attention
    cross_k: torch.Tensor       # [dec_layers, B, S_src, KH, Dh]
    cross_v: torch.Tensor


def init_dec_block(cfg, ini: Init) -> dict:
    return {
        "ln1": init_norm(cfg, ini, cfg.d_model),
        "attn": init_attn(cfg, ini),
        "lnx": init_norm(cfg, ini, cfg.d_model),
        "xattn": init_attn(cfg, ini),
        "ln2": init_norm(cfg, ini, cfg.d_model),
        "mlp": init_mlp(cfg, ini),
    }


def init_lm(cfg, gen: torch.Generator | None = None, dtype=torch.float32,
            abstract: bool = False) -> dict:
    """Annotated parameter tree, drawn from ``gen`` on its device (meta
    tensors and no generator when ``abstract``)."""
    ini = Init(gen=gen, dtype=dtype, abstract=abstract)
    return {
        "embed": init_embedding(cfg, ini),
        "encoder": tfm.init_block(cfg, ini.stacked(cfg.enc_layers),
                                  moe=False),
        "ln_enc": init_norm(cfg, ini, cfg.d_model),
        "decoder": init_dec_block(cfg, ini.stacked(cfg.dec_layers)),
        "ln_f": init_norm(cfg, ini, cfg.d_model),
    }


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def _remat(fn, remat: str):
    """The reference checkpoints each block whole unless remat is
    "none"."""
    return tfm._remat(fn, "none" if remat == "none" else "full")


def encode(cfg, params, frames, *, remat="full"):
    """frames [B, S_src, d] (precomputed embeddings) -> memory
    [B, S_src, d]."""
    positions = _positions(frames)
    body = _remat(functools.partial(tfm.block_fwd, cfg, window=None,
                                    causal=False), remat)
    x = frames
    for lp in tfm.unstack(params["encoder"], cfg.enc_layers):
        x, _, _ = body(lp, x, positions)
    return norm(cfg, x, params["ln_enc"])


def dec_block_fwd(cfg, p, x, positions, memory):
    h = norm(cfg, x, p["ln1"])
    h = attention(cfg, p["attn"], h, positions, window=None, causal=True)
    x = x + h
    h = norm(cfg, x, p["lnx"])
    h = cross_attention(cfg, p["xattn"], h, encode_kv(cfg, p["xattn"],
                                                      memory))
    x = x + h
    h = norm(cfg, x, p["ln2"])
    return x + swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])


def decode_fwd(cfg, params, tokens, memory, *, activ_dtype, remat="full",
               last_only=False):
    """The decoder over tokens [B, S] against memory [B, S_src, d] ->
    logits [B, S, V] (the last position only with ``last_only``)."""
    x = embed(cfg, params["embed"], tokens, activ_dtype)
    positions = _positions(x)
    body = _remat(functools.partial(dec_block_fwd, cfg), remat)
    for lp in tfm.unstack(params["decoder"], cfg.dec_layers):
        x = body(lp, x, positions, memory)
    x = norm(cfg, x, params["ln_f"])
    if last_only:
        x = x[:, -1:]
    return unembed(cfg, params["embed"], x)


def lm_loss(cfg, params, batch, *, activ_dtype=torch.bfloat16,
            remat="full", router_H=None):
    """batch {frames [B, S_src, d], tokens [B, S_tgt + 1]} -> (CE,
    (router_H, {"ce"}))."""
    memory = encode(cfg, params, batch["frames"].to(activ_dtype),
                    remat=remat)
    logits = decode_fwd(cfg, params, batch["tokens"][:, :-1], memory,
                        activ_dtype=activ_dtype, remat=remat)
    ce = cross_entropy(logits, batch["tokens"][:, 1:])
    return ce, (router_H, {"ce": ce})


def lm_logits(cfg, params, batch, *, activ_dtype=torch.bfloat16,
              remat="full", router_H=None, last_only=False):
    """Prefill = encode + the full decoder forward over the target
    prefix: (logits, router_H, aux = 0)."""
    memory = encode(cfg, params, batch["frames"].to(activ_dtype),
                    remat=remat)
    logits = decode_fwd(cfg, params, batch["tokens"], memory,
                        activ_dtype=activ_dtype, remat=remat,
                        last_only=last_only)
    return logits, router_H, torch.zeros((), dtype=torch.float32,
                                         device=logits.device)


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device=None,
                       abstract: bool = False):
    """Empty caches on ``device`` (CUDA unless asked, meta when
    ``abstract``): the decoder's stacked self caches and zero cross K/V of
    max_len rows."""
    dev = resolve_device(device, abstract)
    L = cfg.dec_layers
    c = init_cache(cfg, batch, max_len, dtype, device=dev)
    xshape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return EncDecCache(
        self_kv=KVCache(*(t.expand((L,) + t.shape).contiguous()
                          for t in c)),
        cross_k=torch.zeros(xshape, dtype=dtype, device=dev),
        cross_v=torch.zeros(xshape, dtype=dtype, device=dev))


def cache_axes(tree: EncDecCache):
    xkv = ("layers", "cache_batch", "cache_seq", "act_kv_heads", None)
    return EncDecCache(self_kv=tfm.cache_axes(tree.self_kv),
                       cross_k=xkv, cross_v=xkv)


def build_cross_cache(cfg, params, memory, max_len, dtype,
                      self_cache=None) -> EncDecCache:
    """Each decoder layer's cross K/V of the encoder's memory [B, S_src, d]
    (the serving prefill of an encoder-decoder), beside ``self_cache`` or
    fresh self caches of max_len on the memory's device."""
    kv = [encode_kv(cfg, lp["xattn"], memory)
          for lp in tfm.unstack(params["decoder"], cfg.dec_layers)]
    if self_cache is None:
        self_cache = init_decode_caches(cfg, memory.shape[0], max_len, dtype,
                                        device=memory.device).self_kv
    return EncDecCache(self_kv=self_cache,
                       cross_k=torch.stack([k for k, _ in kv]).to(dtype),
                       cross_v=torch.stack([v for _, v in kv]).to(dtype))


def lm_decode_step(cfg, params, caches: EncDecCache, tokens, *,
                   activ_dtype=torch.bfloat16, router_H=None):
    """One decoder token against the self caches (written in place) and
    the precomputed cross K/V: tokens [B] -> (logits [B, V], caches)."""
    x = embed(cfg, params["embed"], tokens[:, None], activ_dtype)
    L = cfg.dec_layers
    for lp, c, ck, cv in zip(tfm.unstack(params["decoder"], L),
                             tfm.unstack(caches.self_kv, L),
                             caches.cross_k.unbind(0),
                             caches.cross_v.unbind(0)):
        h = norm(cfg, x, lp["ln1"])
        h, _ = decode_attention(cfg, lp["attn"], h, c, window=None)
        x = x + h
        h = norm(cfg, x, lp["lnx"])
        x = x + cross_attention(cfg, lp["xattn"], h,
                                (ck.to(x.dtype), cv.to(x.dtype)))
        h = norm(cfg, x, lp["ln2"])
        x = x + swiglu(h, lp["mlp"]["gate"], lp["mlp"]["up"],
                       lp["mlp"]["down"])
    x = norm(cfg, x, params["ln_f"])
    logits = unembed(cfg, params["embed"], x)[:, 0, :]
    return logits, caches
