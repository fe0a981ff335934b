"""Train, prefill and serve step builders.

Port of `repro.runtime.step`.  `make_train_step` assembles loss ->
(optionally microbatch-accumulated) gradients -> (optionally compressed)
gradients -> AdamW, threading the backpressure MoE router queues H through
the step outside the gradient, like the paper's H_n.  The reference jits
its steps and hands sharding metadata to the launcher; the port runs them
eagerly on the device its tensors lie on (the state's axes trees are
still returned, for the reference's signature), the prefill under
`torch.inference_mode()` (nothing needs a gradient).  Abstract state
(``init_train_state(rcfg, abstract=True)``) lies on the meta device: the
reference's ShapeDtypeStruct tree, which the dry-run traces.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..configs.base import RunConfig
from ..device import resolve_device
from ..models import get_model, split_tree
from ..models.common import tree_leaves, tree_map
from ..obs import spans
from ..optim import (AdamW, AdamWState, EFState, compress_int8_ef,
                     compress_topk_ef, init_ef, init_ef_abstract,
                     warmup_cosine)

COMPRESSIONS = {"none": None, "int8_ef": compress_int8_ef,
                "topk_ef": compress_topk_ef}


class TrainState(NamedTuple):
    step: torch.Tensor                  # [] int32
    params: Any
    opt: AdamWState
    router_H: Optional[torch.Tensor]    # [L, E] or None
    ef: Optional[EFState]               # error-feedback residuals or None


def _dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def make_optimizer(total_steps: int = 10_000) -> AdamW:
    return AdamW(lr=warmup_cosine(3e-4, warmup=200, total=total_steps))


def init_train_state(rcfg: RunConfig, gen: torch.Generator | None = None,
                     *, device=None, abstract: bool = False,
                     optimizer: AdamW | None = None):
    """Returns (state, state_axes): params drawn from ``gen`` in
    ``rcfg.param_dtype``, zero moments, zero router queues and, with
    gradient compression, zero residuals, on ``device`` (CUDA unless
    asked, raising without a card; ``gen`` must draw on that device).
    With ``abstract`` the same tree lies on the meta device, drawn from
    no generator and allocating nothing."""
    dev = resolve_device(device, abstract)
    if not abstract and (gen is None or gen.device.type != dev.type):
        raise ValueError(f"the state on {dev} needs a generator drawing "
                         f"there, got {gen and gen.device}")
    api = get_model(rcfg.model)
    opt = optimizer or make_optimizer()
    params, p_axes = split_tree(api.init(gen, dtype=_dtype(
        rcfg.param_dtype), abstract=abstract))
    H = api.init_state(device=dev).router_H
    if rcfg.grad_compression == "none":
        ef = None
    else:
        ef = init_ef_abstract(params) if abstract else init_ef(params)
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                       params=params,
                       opt=(opt.init_abstract(params) if abstract
                            else opt.init(params)),
                       router_H=H, ef=ef)
    axes = TrainState(
        step=(),
        params=p_axes,
        opt=AdamWState(count=(), m=p_axes, v=p_axes),
        router_H=(None, None) if H is not None else None,
        ef=EFState(err=p_axes) if ef is not None else None,
    )
    return state, axes


def make_train_step(rcfg: RunConfig, optimizer: AdamW | None = None):
    """``train_step(state, batch) -> (new_state, metrics)``.

    ``batch`` is {"tokens": [B, S+1]} (tensors or numpy arrays, moved to
    the params' device); ``metrics`` holds the loss ("loss", "ce" and,
    without accumulation, "aux") as 0-d tensors.  With ``rcfg.grad_accum``
    = n > 1 the batch splits into n microbatches of B/n rows, run in turn:
    gradients summed in float32 and divided by n, H carried from
    microbatch to microbatch, the loss their mean.  Then the gradients are
    compressed (``rcfg.grad_compression``) and AdamW steps.

    The step updates the state in place: the params and the AdamW moments
    are written into the given state's tensors, which the returned state
    shares, so the given state must not be used afterwards (the reference
    donates it).  The step count, AdamW count, router queues and
    compression residuals are new tensors."""
    if rcfg.grad_compression not in COMPRESSIONS:
        raise ValueError(f"grad_compression {rcfg.grad_compression!r}: "
                         f"expected one of {sorted(COMPRESSIONS)}")
    api = get_model(rcfg.model)
    opt = optimizer or make_optimizer()
    adt = _dtype(rcfg.activ_dtype)
    compress = COMPRESSIONS[rcfg.grad_compression]
    n_micro = rcfg.grad_accum

    def value_and_grad(params, batch, router_H):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, (H, metrics) = api.loss(leaves, batch, activ_dtype=adt,
                                      remat=rcfg.remat, router_H=router_H)
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                         allow_unused=True,
                                         materialize_grads=True))
        H = None if H is None else H.detach()
        return (loss.detach(), H, {k: v.detach() for k, v in
                                   metrics.items()},
                tree_map(lambda _: next(grads), leaves))

    def train_step(state: TrainState, batch):
        dev = state.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.enable_grad():
            if n_micro > 1:
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device),
                    state.params)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                H = state.router_H
                for i in range(n_micro):
                    mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                       + v.shape[1:])[i]
                          for k, v in batch.items()}
                    l, H, _, g = value_and_grad(state.params, mb, H)
                    for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                        a.add_(b.to(torch.float32))
                    loss = loss + l
                    del g
                grads = tree_map(lambda g: g / n_micro, grads)
                loss = loss / n_micro
                metrics = {"ce": loss}
            else:
                loss, H, metrics, grads = value_and_grad(
                    state.params, batch, state.router_H)
        ef = state.ef
        if compress is not None:
            grads, ef = compress(grads, ef)
        params, opt_state = opt.update(grads, state.opt, state.params)
        new = TrainState(step=state.step + 1, params=params, opt=opt_state,
                         router_H=H, ef=ef)
        return new, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(rcfg: RunConfig):
    """Forward pass emitting last-position logits (inference prefill):
    ``prefill_step(params, batch, router_H) -> logits [B, 1, V]`` in the
    run's activation dtype.  As in the reference, the step drops the new
    router queues; `ModelAPI.logits` returns them.  Each call is one span
    ``prefill.step`` (`obs.spans`, off unless recording)."""
    api = get_model(rcfg.model)
    adt = _dtype(rcfg.activ_dtype)

    def prefill_step(params, batch, router_H):
        dev = next(iter(batch.values())).device
        with spans.span("prefill.step", device=dev), torch.inference_mode():
            logits, _, _ = api.logits(params, batch, activ_dtype=adt,
                                      remat="none", router_H=router_H,
                                      last_only=True)
        return logits

    return prefill_step


def make_serve_step(rcfg: RunConfig):
    """One decode step: ``serve_step(params, caches, batch, router_H) ->
    (logits [B, V], caches)``, the caches updated in place."""
    api = get_model(rcfg.model)
    adt = _dtype(rcfg.activ_dtype)

    def serve_step(params, caches, batch, router_H):
        return api.decode_step(params, caches, batch, activ_dtype=adt,
                               router_H=router_H)

    return serve_step
