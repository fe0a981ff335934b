"""Uniform model API — the entry point the serving engine, the step
builders and tests use.

Port of `repro.models.api` for the families the port runs: dense (with
the k-local:1-global pattern) and MoE decoder-only transformers, the VLM
and the encoder-decoder:

  api = get_model(cfg)
  params~ = api.init(gen, dtype)                    # Annotated tree
  loss, (H', metrics) = api.loss(params, batch, ...)  # training loss
  logits, H', aux = api.logits(params, batch, ...)  # prefill forward
  caches = api.init_decode(batch, max_len, dtype, device)
  axes = api.cache_axes(caches)
  logits, caches = api.decode_step(params, caches, batch, ...)

The hybrid (zamba) and ssm (xLSTM) families raise NotImplementedError
naming the ROADMAP item that ports them.  The reference's abstract
`batch_specs` belongs to the dry-run, which is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from . import encdec, transformer, vlm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: Any
    mod: Any

    def init(self, gen: torch.Generator, dtype=torch.float32):
        return self.mod.init_lm(self.cfg, gen, dtype=dtype)

    def init_state(self, device=None):
        """The model's state (MoE router queues) on ``device``: CUDA
        unless asked (`device.resolve_device`), raising without a card."""
        return transformer.init_model_state(self.cfg,
                                            device=resolve_device(device))

    def loss(self, params, batch, *, activ_dtype=torch.bfloat16,
             remat="full", router_H=None):
        return self.mod.lm_loss(self.cfg, params, batch,
                                activ_dtype=activ_dtype, remat=remat,
                                router_H=router_H)

    def logits(self, params, batch, *, activ_dtype=torch.bfloat16,
               remat="none", router_H=None, last_only=False):
        """The VLM and the encoder-decoder read the whole batch (patch
        embeddings, frames); the decoders its tokens."""
        inputs = (batch if self.cfg.family in ("encdec", "vlm")
                  else batch["tokens"])
        return self.mod.lm_logits(self.cfg, params, inputs,
                                  activ_dtype=activ_dtype, remat=remat,
                                  router_H=router_H, last_only=last_only)

    def init_decode(self, batch: int, max_len: int, dtype, device=None):
        """Empty decode caches on ``device``, resolved as `init_state`."""
        return self.mod.init_decode_caches(self.cfg, batch, max_len, dtype,
                                           device=resolve_device(device))

    def cache_axes(self, tree):
        return self.mod.cache_axes(tree)

    def decode_step(self, params, caches, batch, *,
                    activ_dtype=torch.bfloat16, router_H=None):
        return self.mod.lm_decode_step(self.cfg, params, caches,
                                       batch["tokens"],
                                       activ_dtype=activ_dtype,
                                       router_H=router_H)


_FAMILY = {"dense": transformer, "moe": transformer, "vlm": vlm,
           "encdec": encdec}


def get_model(cfg) -> ModelAPI:
    if cfg.family in _FAMILY:
        return ModelAPI(cfg=cfg, mod=_FAMILY[cfg.family])
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet "
        f"(ROADMAP A13, LLM substrate)")
