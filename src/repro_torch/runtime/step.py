"""Prefill and serve step builders.

Port of the inference half of `repro.runtime.step`: `_dtype`,
`make_prefill_step` and `make_serve_step`.  The reference jits its steps
and hands sharding metadata to the launcher; the port runs them eagerly on
the device its tensors lie on, and the prefill under
`torch.inference_mode()` (nothing needs a gradient).  `make_train_step`
and the optimizer wait for the training slice (ROADMAP A13).
"""
from __future__ import annotations

import torch

from ..configs.base import RunConfig
from ..models import get_model


def _dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def make_prefill_step(rcfg: RunConfig):
    """Forward pass emitting last-position logits (inference prefill):
    ``prefill_step(params, batch, router_H) -> logits [B, 1, V]`` in the
    run's activation dtype.  As in the reference, the step drops the new
    router queues; `ModelAPI.logits` returns them."""
    api = get_model(rcfg.model)
    adt = _dtype(rcfg.activ_dtype)

    def prefill_step(params, batch, router_H):
        with torch.inference_mode():
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
