"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention block
applied after every `attn_every` mamba layers (shared weights, a KV cache
of its own per application).  zamba2-2.7b: 54 = 9 groups x 6 mamba layers,
the shared block 9 times.

Port of `repro.models.zamba`.  The mamba stack is [n_groups, k, ...] and
split into views by two `unbind`s (`transformer.unstack`), as gemma3's
local stack is; the reference's nested `layer_scan` is a loop over them.
Only the mamba layers are rematerialized (`transformer._remat`, full under
any mode but "none", as the reference's `jax.checkpoint`); the shared block
runs through `transformer.block_fwd` as is, and its gradient sums over its
applications.  On the card its attention core is the flash kernel at
head dim 80 (bf16: the sm90 kernel; float32: the CUDA-core kernel).

`lm_decode_step` updates the caches in place (each mamba layer's
`MambaState` through `mamba.mamba_decode`, each application's KV cache
through `attention.decode_attention`) and returns the same `ZambaCache`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import transformer as tfm
from .attention import KVCache, init_cache
from .common import (Init, cross_entropy, embed, init_embedding, init_norm,
                     norm, unembed)
from .mamba import (MambaState, init_mamba, init_mamba_state, mamba_decode,
                    mamba_fwd, mamba_state_axes)


def _groups(cfg):
    k = cfg.attn_every
    n_groups = cfg.n_layers // k
    if n_groups * k != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups "
                         f"of {k}")
    return n_groups, k


def init_stack(cfg, ini: Init) -> dict:
    n_groups, k = _groups(cfg)
    return {
        "mamba": {"m": init_mamba(cfg, ini.stacked(n_groups, k)),
                  "ln": init_norm(cfg, ini.stacked(n_groups, k), cfg.d_model)},
        "shared": tfm.init_block(cfg, ini, moe=False),   # one shared block
    }


def init_lm(cfg, gen: torch.Generator | None = None, dtype=torch.float32,
            abstract: bool = False) -> dict:
    """Annotated parameter tree, drawn from ``gen`` on its device (meta
    tensors and no generator when ``abstract``)."""
    ini = Init(gen=gen, dtype=dtype, abstract=abstract)
    return {
        "embed": init_embedding(cfg, ini),
        "stack": init_stack(cfg, ini),
        "ln_f": init_norm(cfg, ini, cfg.d_model),
    }


def _mamba_body(cfg, lp, x):
    return x + mamba_fwd(cfg, lp["m"], norm(cfg, x, lp.get("ln")))


def _mamba_layer(cfg, lp, x, remat):
    body = tfm._remat(_mamba_body, "none" if remat == "none" else "full")
    return body(cfg, lp, x)


def stack_fwd(cfg, p, x, positions, *, remat="full"):
    """x [B, S, d] through every group: its k mamba layers, then the shared
    block (no window)."""
    n_groups, k = _groups(cfg)
    shared = p["shared"]
    for lp_group in tfm.unstack(p["mamba"], n_groups):
        for lp in tfm.unstack(lp_group, k):
            x = _mamba_layer(cfg, lp, x, remat)
        x, _, _ = tfm.block_fwd(cfg, shared, x, positions, window=None)
    return x


def _positions(x):
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None, :].expand(B, S)


def lm_loss(cfg, params, batch, *, activ_dtype=torch.bfloat16, remat="full",
            router_H=None):
    """batch {tokens [B, S+1]} -> (CE of tokens[:, 1:] given tokens[:, :-1],
    (router_H, {"ce"}))."""
    tokens = batch["tokens"]
    x = embed(cfg, params["embed"], tokens[:, :-1], activ_dtype)
    x = stack_fwd(cfg, params["stack"], x, _positions(x), remat=remat)
    x = norm(cfg, x, params.get("ln_f"))
    logits = unembed(cfg, params["embed"], x)
    ce = cross_entropy(logits, tokens[:, 1:])
    return ce, (router_H, {"ce": ce})


def lm_logits(cfg, params, tokens, *, activ_dtype=torch.bfloat16,
              remat="full", router_H=None, prefix_embeds=None,
              last_only=False):
    """tokens [B, S] -> (logits [B, S, V] (or [B, 1, V] with
    ``last_only``), router_H, 0)."""
    x = embed(cfg, params["embed"], tokens, activ_dtype)
    x = stack_fwd(cfg, params["stack"], x, _positions(x), remat=remat)
    x = norm(cfg, x, params.get("ln_f"))
    if last_only:
        x = x[:, -1:]
    return (unembed(cfg, params["embed"], x), router_H,
            torch.zeros((), dtype=torch.float32, device=x.device))


class ZambaCache(NamedTuple):
    ssm: MambaState          # stacked [n_groups, k]
    attn: KVCache            # stacked [n_groups]


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device=None,
                       abstract: bool = False):
    """Zero SSM states [n_groups, k] and the shared block's KV caches
    [n_groups] (max_len slots each) on ``device``: CUDA unless the caller
    asks for the CPU, the meta device when ``abstract``."""
    n_groups, k = _groups(cfg)
    dev = resolve_device(device, abstract)
    ssm = init_mamba_state(cfg, batch, dtype, device=dev)
    attn = init_cache(cfg, batch, max_len, dtype, device=dev)
    return ZambaCache(ssm=tfm.stack_state((n_groups, k), ssm),
                      attn=tfm.stack_state((n_groups,), attn))


def cache_axes(tree: ZambaCache):
    return ZambaCache(ssm=mamba_state_axes(tree.ssm),
                      attn=tfm.cache_axes(tree.attn))


def lm_decode_step(cfg, params, caches: ZambaCache, tokens, *,
                   activ_dtype=torch.bfloat16, router_H=None):
    """tokens: [B] int -> (logits [B, V], caches), the caches updated in
    place."""
    n_groups, k = _groups(cfg)
    x = embed(cfg, params["embed"], tokens[:, None], activ_dtype)
    stack = params["stack"]
    shared = stack["shared"]
    for lp_group, ssm_group, attn_cache in zip(
            tfm.unstack(stack["mamba"], n_groups),
            tfm.unstack(caches.ssm, n_groups),
            tfm.unstack(caches.attn, n_groups)):
        for lp, st in zip(tfm.unstack(lp_group, k),
                          tfm.unstack(ssm_group, k)):
            h, _ = mamba_decode(cfg, lp["m"], norm(cfg, x, lp.get("ln")), st)
            x = x + h
        x, _, _ = tfm.block_decode(cfg, shared, x, attn_cache, window=None)
    x = norm(cfg, x, params.get("ln_f"))
    logits = unembed(cfg, params["embed"], x)[:, 0, :]
    return logits, caches
