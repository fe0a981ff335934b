"""Vision-prefix VLM (internvl2).

Port of `repro.models.vlm`.  The InternViT frontend is a stub, as in the
reference: the batch carries precomputed patch embeddings, a learned
2-layer projector (norm, ``w1``, tanh-approximated GELU as
`jax.nn.gelu`'s default, ``w2``) maps them into the LM's embedding space,
and the qwen2-shaped backbone (`transformer`) runs them as a prefix in
front of the text.  Decode reuses the transformer's: the prefix already
lies in the caches.
"""
from __future__ import annotations

import torch

from . import transformer as tfm
from .common import Init, cross_entropy, init_norm, norm


def init_lm(cfg, gen: torch.Generator | None = None, dtype=torch.float32,
            abstract: bool = False) -> dict:
    """The backbone's tree (`transformer.init_lm`) plus the projector,
    drawn from ``gen`` in that order (meta tensors and no generator when
    ``abstract``)."""
    p = tfm.init_lm(cfg, gen, dtype=dtype, abstract=abstract)
    ini = Init(gen=gen, dtype=dtype, abstract=abstract)
    p["projector"] = {
        "ln": init_norm(cfg, ini, cfg.d_model),
        "w1": ini.param((cfg.d_model, cfg.d_model), ("embed", "ff")),
        "w2": ini.param((cfg.d_model, cfg.d_model), ("ff", "embed")),
    }
    return p


def _project(cfg, p, patches, dtype):
    """patches [B, P, d] -> the prefix embeddings [B, P, d] in ``dtype``."""
    x = norm(cfg, patches.to(dtype), p["projector"]["ln"])
    x = torch.nn.functional.gelu(
        torch.einsum("bpd,de->bpe", x, p["projector"]["w1"].to(dtype)),
        approximate="tanh")
    return torch.einsum("bpe,ed->bpd", x, p["projector"]["w2"].to(dtype))


def lm_loss(cfg, params, batch, *, activ_dtype=torch.bfloat16,
            remat="full", router_H=None):
    """batch {patch_embeds [B, P, d], tokens [B, S_text + 1]} -> (CE on the
    text positions only, (router_H', {"ce"}))."""
    prefix = _project(cfg, params, batch["patch_embeds"], activ_dtype)
    tokens = batch["tokens"]
    logits, H_out, _ = tfm.lm_logits(
        cfg, params, tokens[:, :-1], activ_dtype=activ_dtype, remat=remat,
        router_H=router_H, prefix_embeds=prefix)
    P = prefix.shape[1]
    ce = cross_entropy(logits[:, P:], tokens[:, 1:])
    return ce, (H_out, {"ce": ce})


def lm_logits(cfg, params, batch, *, activ_dtype=torch.bfloat16,
              remat="full", router_H=None, last_only=False):
    """batch {patch_embeds, tokens} -> (logits [B, P + S, V], router_H',
    aux)."""
    prefix = _project(cfg, params, batch["patch_embeds"], activ_dtype)
    return tfm.lm_logits(cfg, params, batch["tokens"],
                         activ_dtype=activ_dtype, remat=remat,
                         router_H=router_H, prefix_embeds=prefix,
                         last_only=last_only)


init_decode_caches = tfm.init_decode_caches
cache_axes = tfm.cache_axes
lm_decode_step = tfm.lm_decode_step      # decode: prefix already in cache
