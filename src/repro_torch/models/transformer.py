"""Decoder-only transformer stack (dense and MoE): init, the training
loss, the prefill forward and decode.

Port of `repro.models.transformer` for stacks without the local/global
pattern (which waits for its families, ROADMAP A13).  Layer params are
stacked ([L, ...] leading dims) as in the reference; its `layer_scan` over
the stack becomes a Python loop over the layers, each layer's params one
`unbind` view per leaf (`unstack`), so the gradient of a stacked leaf is
one stack of its layers' gradients.  `_remat` gives the reference's
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
                        init_cache)
from .common import (Init, cross_entropy, embed, init_embedding, init_mlp,
                     init_norm, norm, swiglu, unembed)
from .moe import init_moe, moe_ffn


class ModelState(NamedTuple):
    """Non-parameter model state: per-MoE-layer router queues H."""
    router_H: Optional[torch.Tensor]    # [L_moe, E] or None


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe") or cfg.local_global:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with local_global="
            f"{cfg.local_global} is not ported yet (ROADMAP A13)")


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

def init_block(cfg, ini: Init, *, moe: bool) -> dict:
    p = {
        "ln1": init_norm(cfg, ini, cfg.d_model),
        "attn": init_attn(cfg, ini),
        "ln2": init_norm(cfg, ini, cfg.d_model),
    }
    if moe:
        p["moe"] = init_moe(cfg, ini)
    else:
        p["mlp"] = init_mlp(cfg, ini)
    return {k: v for k, v in p.items() if v is not None}


def block_fwd(cfg, p: dict, x, positions, *, window, router_H=None,
              causal: bool = True):
    """x [B, S, d] -> (x', router_H', aux).  The MoE FFN runs its capacity
    path with one group per sequence (G = B) and routes through
    `bp_topk_route`."""
    h = norm(cfg, x, p.get("ln1"))
    h = attention(cfg, p["attn"], h, positions, window=window, causal=causal)
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

def init_stack(cfg, ini: Init) -> dict:
    _check_family(cfg)
    return {"layers": init_block(cfg, ini.stacked(cfg.n_layers),
                                 moe=cfg.family == "moe")}


def stack_fwd(cfg, p: dict, x, positions, *, remat: str = "full",
              router_H=None):
    """Run all blocks in order, each under `_remat(remat)`; returns (x,
    router_H' [L, E] or None, aux_total).  A rematerialized block's
    forward runs again in the backward (its kernels launch again); what
    that second run returns is dropped, so each layer's H is updated
    once."""
    _check_family(cfg)
    moe = cfg.family == "moe"
    if moe and router_H is None:
        raise ValueError(f"{cfg.name}: an MoE stack needs router_H [L, E]")
    body = _remat(functools.partial(block_fwd, cfg, window=cfg.window),
                  remat)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    H_out = []
    for i, lp in enumerate(unstack(p["layers"], cfg.n_layers)):
        x, H, aux = body(lp, x, positions,
                         router_H=router_H[i] if moe else None)
        aux_total = aux_total + aux
        H_out.append(H)
    return x, (torch.stack(H_out) if moe else router_H), aux_total


def init_model_state(cfg, device=None) -> ModelState:
    """The router queues of a MoE model (zeros), on ``device``: CUDA unless
    the caller asks for the CPU."""
    if cfg.family == "moe":
        return ModelState(router_H=torch.zeros(
            (cfg.n_layers, cfg.n_experts), dtype=torch.float32,
            device=resolve_device(device)))
    return ModelState(router_H=None)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (dicts of [L, ...] tensors or stacked
    KVCaches): views, so in-place cache updates reach the stack."""
    if isinstance(tree, KVCache):
        return KVCache(*(t[i] for t in tree))
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree of dicts, each leaf split by one
    `unbind` (views, as `layer` gives)."""
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


# ---------------------------------------------------------------------------
# LM wrapper: init / loss / decode
# ---------------------------------------------------------------------------

def init_lm(cfg, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Annotated parameter tree, drawn from ``gen`` on its device."""
    ini = Init(gen=gen, dtype=dtype)
    return {
        "embed": init_embedding(cfg, ini),
        "stack": init_stack(cfg, ini),
        "ln_f": init_norm(cfg, ini, cfg.d_model),
    }


def lm_logits(cfg, params, tokens, *, activ_dtype=torch.bfloat16,
              remat="full", router_H=None, last_only=False):
    """tokens [B, S] -> (logits [B, S, V], router_H', aux).
    ``last_only`` unembeds only the final position (serving prefill).
    Positions are arange over the sequence, as in the reference.  The
    reference's ``prefix_embeds`` serves the VLM family, which is not
    ported."""
    x = embed(cfg, params["embed"], tokens, activ_dtype)
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


def init_decode_caches(cfg, batch: int, max_len: int, dtype, device=None):
    """Stacked caches mirroring the stack structure: {"layers": KVCache}
    with a leading [L] axis on every field, on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    _check_family(cfg)
    c = init_cache(cfg, batch, max_len, dtype, window=cfg.window,
                   device=resolve_device(device))
    return {"layers": KVCache(*(
        t[None].repeat(cfg.n_layers, *([1] * t.dim())) for t in c))}


def lm_decode_step(cfg, params, caches, tokens, *,
                   activ_dtype=torch.bfloat16, router_H=None):
    """tokens: [B] int -> (logits [B, V], caches).  The caches are
    updated in place (see `attention.decode_attention`)."""
    _check_family(cfg)
    x = embed(cfg, params["embed"], tokens[:, None], activ_dtype)
    stack, stacked = params["stack"]["layers"], caches["layers"]
    for i in range(cfg.n_layers):
        H = None if router_H is None else router_H[i]
        x, _, _ = block_decode(cfg, layer(stack, i), x, layer(stacked, i),
                               window=cfg.window, router_H=H)
    x = norm(cfg, x, params.get("ln_f"))
    logits = unembed(cfg, params["embed"], x)[:, 0, :]
    return logits, caches
