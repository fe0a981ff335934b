"""Decoder-only transformer stack (dense, MoE and Gemma's k-local:1-global
pattern): init, the training loss, the prefill forward and decode.

Port of `repro.models.transformer`.  Layer params are stacked ([L, ...]
leading dims) as in the reference; its `layer_scan` over the stack becomes
a Python loop over the layers, each layer's params one `unbind` view per
leaf (`unstack`), so the gradient of a stacked leaf is one stack of its
layers' gradients.  The local/global pattern (`_pattern`) stacks its
params and caches as {"local": [n_groups, k, ...], "global": [n_groups,
...], "tail": [tail, ...]}; the [n_groups, k] stacks are split by two
`unbind`s, so every layer's params and caches are views (a `reshape` of a
non-contiguous stack would copy, and a cache written in place through a
copy would lose the write).  `_remat` gives the reference's
per-block rematerialization: ``"full"`` keeps only each block's inputs
(`torch.utils.checkpoint`), ``"dots"`` also the outputs of its 2-D
matrix products (`jax.checkpoint_policies.dots_with_no_batch_dims_saveable`
as a selective-checkpoint policy), ``"none"`` everything.

Every MoE layer routes through `bp_topk_route`, the whole gate in one
launch of a CUDA kernel on the card, at decode, prefill and training
(through `BpTopkRouteFn` when the router needs a gradient).  The forward
(`lm_logits`, `lm_loss`) threads the per-layer router queues H through
the stack and returns each layer's new H, as the reference does;
`lm_decode_step`, like the reference, drops them: at decode the caller's
H is the bias.

DeepSeek-V3's block (`configs.moonlight_16b_a3b.MLAConfig`, the port's
own): `block_fwd` runs `attention.mla_attention` where the config has a
latent rank, and a config with ``first_dense_layers`` stacks them apart,
{"dense": [n_dense, ...], "layers": [n_layers - n_dense, ...]}, dense
SwiGLUs of width ``dense_d_ff`` run first; the router queues H are the MoE
layers' alone ([n_layers - n_dense, E]).  Decode of an MLA config (a
latent cache) is not ported and is refused.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..core.router import RouterState
from ..device import resolve_device
from .attention import (KVCache, attention, decode_attention, init_attn,
                        init_cache, init_mla, is_mla, mla_attention)
from .common import (Init, cross_entropy, embed, init_embedding, init_mlp,
                     init_norm, norm, swiglu, unembed)
from .moe import init_moe, moe_ffn


class ModelState(NamedTuple):
    """Non-parameter model state: per-MoE-layer router queues H."""
    router_H: Optional[torch.Tensor]    # [L_moe, E] or None


def n_dense(cfg) -> int:
    """Leading dense layers of an MoE stack (``first_dense_layers``)."""
    return getattr(cfg, "first_dense_layers", 0)


#: The families another module stacks.
_STACKED_BY = {"hybrid": "models.zamba", "ssm": "models.xlstm",
               "encdec": "models.encdec"}


def _check_family(cfg) -> None:
    """The families this module stacks: dense and MoE decoders, and the
    VLM's backbone (a dense decoder behind a projector); any other is
    refused, naming the module that stacks it."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"{cfg.name}: models.transformer does not stack the "
            f"{cfg.family!r} family; "
            f"{_STACKED_BY.get(cfg.family, 'no module')} does")


def _check_decode(cfg) -> None:
    """Decode needs a KV cache of the config's attention: an MLA config
    (a latent cache) is refused."""
    if is_mla(cfg):
        raise NotImplementedError(
            f"{cfg.name}: decode through a latent (MLA) cache is not ported; "
            f"the port runs this model's prefill only")


def _dots_policy(ctx, func, *args, **kwargs):
    """Save the outputs of matrix products without batch dims (`mm`, and
    `bmm` over one batch entry, which is how `torch.einsum` runs a
    projection); recompute everything else."""
    if func is torch.ops.aten.mm.default or (
            func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` under the reference's remat ``mode``: none | dots | full."""
    if mode == "none":
        return fn
    if mode == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
    elif mode == "full":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"remat {mode!r}: expected none, dots or full")
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def init_block(cfg, ini: Init, *, moe: bool, d_ff: int | None = None) -> dict:
    """One block's params; ``d_ff`` the dense MLP's width (``cfg.d_ff``
    unless given)."""
    p = {
        "ln1": init_norm(cfg, ini, cfg.d_model),
        "attn": init_mla(cfg, ini) if is_mla(cfg) else init_attn(cfg, ini),
        "ln2": init_norm(cfg, ini, cfg.d_model),
    }
    if moe:
        p["moe"] = init_moe(cfg, ini)
    else:
        p["mlp"] = init_mlp(cfg, ini, ff=d_ff)
    return {k: v for k, v in p.items() if v is not None}


def block_fwd(cfg, p: dict, x, positions, *, window, router_H=None,
              causal: bool = True):
    """x [B, S, d] -> (x', router_H', aux).  Attention is MLA for a config
    with a latent rank (`attention.is_mla`).  The MoE FFN runs its capacity
    path with one group per sequence (G = B) and routes through
    `bp_topk_route`."""
    h = norm(cfg, x, p.get("ln1"))
    if is_mla(cfg):
        h = mla_attention(cfg, p["attn"], h, positions, causal=causal)
    else:
        h = attention(cfg, p["attn"], h, positions, window=window,
                      causal=causal)
    x = x + h
    h = norm(cfg, x, p.get("ln2"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        rs = RouterState(H=router_H, steps=torch.zeros(
            (), dtype=torch.int32, device=x.device))
        h, rs_new, aux = moe_ffn(cfg, p["moe"], h, rs, use_kernel=True)
        router_H = rs_new.H
    else:
        h = swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])
    return x + h, router_H, aux


def block_decode(cfg, p: dict, x, cache: KVCache, *, window, router_H=None):
    """One token through one block: (x [B, 1, d], cache) -> (x', cache,
    router_H').  The MoE routing goes through `bp_topk_route`."""
    h = norm(cfg, x, p.get("ln1"))
    h, cache = decode_attention(cfg, p["attn"], h, cache, window=window)
    x = x + h
    h = norm(cfg, x, p.get("ln2"))
    if "moe" in p:
        rs = RouterState(H=router_H, steps=torch.zeros(
            (), dtype=torch.int32, device=x.device))
        h, rs_new, _ = moe_ffn(cfg, p["moe"], h, rs, group_size=x.shape[0],
                               dropless=True, use_kernel=True)
        router_H = rs_new.H
    else:
        h = swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])
    return x + h, cache, router_H


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def _pattern(cfg):
    """(n_groups, k_local, tail) for the k-local:1-global pattern."""
    if not cfg.local_global:
        return 0, 0, 0
    k = cfg.local_global
    n_groups = cfg.n_layers // (k + 1)
    tail = cfg.n_layers - n_groups * (k + 1)
    return n_groups, k, tail


def init_stack(cfg, ini: Init) -> dict:
    _check_family(cfg)
    moe = cfg.family == "moe"
    if cfg.local_global:
        n_groups, k, tail = _pattern(cfg)
        p = {
            "local": init_block(cfg, ini.stacked(n_groups, k), moe=moe),
            "global": init_block(cfg, ini.stacked(n_groups), moe=moe),
        }
        if tail:
            p["tail"] = init_block(cfg, ini.stacked(tail), moe=moe)
        return p
    nd = n_dense(cfg)
    if nd:
        return {"dense": init_block(cfg, ini.stacked(nd), moe=False,
                                    d_ff=cfg.dense_d_ff),
                "layers": init_block(cfg, ini.stacked(cfg.n_layers - nd),
                                     moe=moe)}
    return {"layers": init_block(cfg, ini.stacked(cfg.n_layers), moe=moe)}


def stack_fwd(cfg, p: dict, x, positions, *, remat: str = "full",
              router_H=None):
    """Run all blocks in order, each under `_remat(remat)`; returns (x,
    router_H' [L, E] or None, aux_total).  A rematerialized block's
    forward runs again in the backward (its kernels launch again); what
    that second run returns is dropped, so each layer's H is updated
    once.  Under the local/global pattern each group runs its k local
    blocks (``window=cfg.window``), then its global block (no window),
    then the tail's local blocks; ``router_H`` passes through unchanged,
    as in the reference, whose pattern serves dense stacks only.  Leading
    dense layers (`n_dense`) run before the stack's MoE layers, which
    alone read and update ``router_H``."""
    _check_family(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    local = _remat(functools.partial(block_fwd, cfg, window=cfg.window),
                   remat)
    if cfg.local_global:
        n_groups, k, tail = _pattern(cfg)
        glob = _remat(functools.partial(block_fwd, cfg, window=None), remat)
        for lp_l, lp_g in zip(unstack(p["local"], n_groups),
                              unstack(p["global"], n_groups)):
            for lp in unstack(lp_l, k):
                x, _, _ = local(lp, x, positions)
            x, _, _ = glob(lp_g, x, positions)
        for lp in unstack(p["tail"], tail) if tail else ():
            x, _, _ = local(lp, x, positions)
        return x, router_H, aux_total
    moe = cfg.family == "moe"
    if moe and router_H is None:
        raise ValueError(f"{cfg.name}: an MoE stack needs router_H [L, E]")
    nd = n_dense(cfg)
    for lp in unstack(p["dense"], nd) if nd else ():
        x, _, _ = local(lp, x, positions)
    H_out = []
    for i, lp in enumerate(unstack(p["layers"], cfg.n_layers - nd)):
        x, H, aux = local(lp, x, positions,
                          router_H=router_H[i] if moe else None)
        aux_total = aux_total + aux
        H_out.append(H)
    return x, (torch.stack(H_out) if moe else router_H), aux_total


def init_model_state(cfg, device=None, abstract: bool = False) -> ModelState:
    """The router queues of a MoE model (zeros), on ``device``: CUDA unless
    the caller asks for the CPU, the meta device when ``abstract``."""
    if cfg.family == "moe":
        return ModelState(router_H=torch.zeros(
            (cfg.n_layers - n_dense(cfg), cfg.n_experts), dtype=torch.float32,
            device=resolve_device(device, abstract)))
    return ModelState(router_H=None)


def _is_state(tree) -> bool:
    """A NamedTuple of tensors: a KVCache or a recurrent state."""
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (dicts of [L, ...] tensors, stacked
    KVCaches or recurrent states): views, so in-place cache updates reach
    the stack."""
    if _is_state(tree):
        return type(tree)(*(t[i] for t in tree))
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def stack_state(prefix: tuple, state):
    """A KVCache or recurrent state with ``prefix`` stack axes in front of
    every field: each field copied to [*prefix, ...] (its own memory, for
    in-place writes through `unstack`'s views)."""
    return type(state)(*(t.expand(tuple(prefix) + t.shape).contiguous()
                         for t in state))


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree of dicts, KVCaches or recurrent
    states, each leaf split by one `unbind` (views, as `layer` gives)."""
    if _is_state(tree):
        return [type(tree)(*f) for f in zip(*(t.unbind(0) for t in tree))]
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# LM wrapper: init / loss / decode
# ---------------------------------------------------------------------------

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


def lm_logits(cfg, params, tokens, *, activ_dtype=torch.bfloat16,
              remat="full", router_H=None, prefix_embeds=None,
              last_only=False):
    """tokens [B, S] -> (logits [B, P + S, V], router_H', aux), where
    ``prefix_embeds`` [B, P, d] (the VLM's projected patches) go in front
    of the token embeddings.  ``last_only`` unembeds only the final
    position (serving prefill).  Positions are arange over the whole
    sequence, prefix included, as in the reference."""
    x = embed(cfg, params["embed"], tokens, activ_dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(activ_dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x, H_out, aux = stack_fwd(cfg, params["stack"], x, positions,
                              remat=remat, router_H=router_H)
    x = norm(cfg, x, params.get("ln_f"))
    if last_only:
        x = x[:, -1:]
    return unembed(cfg, params["embed"], x), H_out, aux


def lm_loss(cfg, params, batch, *, activ_dtype=torch.bfloat16,
            remat="full", router_H=None):
    """batch {tokens [B, S+1], optional mask [B, S]} -> (scalar loss,
    (router_H', {"ce", "aux"})): the CE of predicting ``tokens[:, 1:]``
    from ``tokens[:, :-1]`` (`common.cross_entropy`) plus the routers' aux
    loss."""
    tokens = batch["tokens"]
    logits, H_out, aux = lm_logits(cfg, params, tokens[:, :-1],
                                   activ_dtype=activ_dtype, remat=remat,
                                   router_H=router_H)
    ce = cross_entropy(logits, tokens[:, 1:], batch.get("mask", None))
    return ce + aux, (H_out, {"ce": ce, "aux": aux})


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device=None,
                       abstract: bool = False):
    """Stacked caches mirroring the stack structure, every field with the
    stack's leading axes, on ``device`` (CUDA unless the caller asks for
    the CPU, meta when ``abstract``): {"layers": [L]} or, under the
    local/global pattern, {"local": [n_groups, k], "global": [n_groups],
    "tail": [tail]}, whose local and tail caches hold min(window, max_len)
    slots (a ring) and whose global caches hold max_len."""
    _check_family(cfg)
    _check_decode(cfg)
    dev = resolve_device(device, abstract)

    def stacked(prefix, window=None):
        return stack_state(prefix, init_cache(cfg, batch, max_len, dtype,
                                              window=window, device=dev))

    if cfg.local_global:
        n_groups, k, tail = _pattern(cfg)
        caches = {"local": stacked((n_groups, k), window=cfg.window),
                  "global": stacked((n_groups,))}
        if tail:
            caches["tail"] = stacked((tail,), window=cfg.window)
        return caches
    return {"layers": stacked((cfg.n_layers,), window=cfg.window)}


def cache_axes(tree):
    """Logical axes for a (possibly stacked) cache tree: a KVCache of axis
    tuples in place of each KVCache, as the reference's."""
    def one(c: KVCache):
        pre = ("layers",) * (c.k.dim() - 4)
        kv = pre + ("cache_batch", "cache_seq", "act_kv_heads", None)
        return KVCache(k=kv, v=kv, kpos=pre + ("cache_seq",), pos=pre)
    if isinstance(tree, KVCache):
        return one(tree)
    return {k: cache_axes(v) for k, v in tree.items()}


def lm_decode_step(cfg, params, caches, tokens, *,
                   activ_dtype=torch.bfloat16, router_H=None):
    """tokens: [B] int -> (logits [B, V], caches).  The caches are
    updated in place (see `attention.decode_attention`)."""
    _check_family(cfg)
    _check_decode(cfg)
    x = embed(cfg, params["embed"], tokens[:, None], activ_dtype)
    stack = params["stack"]
    if cfg.local_global:
        n_groups, k, tail = _pattern(cfg)
        for lp_l, lp_g, c_l, c_g in zip(
                unstack(stack["local"], n_groups),
                unstack(stack["global"], n_groups),
                unstack(caches["local"], n_groups),
                unstack(caches["global"], n_groups)):
            for lp, c in zip(unstack(lp_l, k), unstack(c_l, k)):
                x, _, _ = block_decode(cfg, lp, x, c, window=cfg.window)
            x, _, _ = block_decode(cfg, lp_g, x, c_g, window=None)
        if tail:
            for lp, c in zip(unstack(stack["tail"], tail),
                             unstack(caches["tail"], tail)):
                x, _, _ = block_decode(cfg, lp, x, c, window=cfg.window)
    else:
        for i, (lp, c) in enumerate(zip(unstack(stack["layers"],
                                                cfg.n_layers),
                                        unstack(caches["layers"],
                                                cfg.n_layers))):
            H = None if router_H is None else router_H[i]
            x, _, _ = block_decode(cfg, lp, x, c, window=cfg.window,
                                   router_H=H)
    x = norm(cfg, x, params.get("ln_f"))
    logits = unembed(cfg, params["embed"], x)[:, 0, :]
    return logits, caches
