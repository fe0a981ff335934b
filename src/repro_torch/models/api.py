"""Uniform model API — the entry point the serving engine, the step
builders and tests use.

Port of `repro.models.api` for every family: dense (with the
k-local:1-global pattern) and MoE decoder-only transformers, the Mamba2 +
shared-attention hybrid (`zamba`), xLSTM (`xlstm`), the VLM and the
encoder-decoder:

  api = get_model(cfg)
  params~ = api.init(gen, dtype)                    # Annotated tree
  loss, (H', metrics) = api.loss(params, batch, ...)  # training loss
  logits, H', aux = api.logits(params, batch, ...)  # prefill forward
  caches = api.init_decode(batch, max_len, dtype, device)
  axes = api.cache_axes(caches)
  logits, caches = api.decode_step(params, caches, batch, ...)

The reference's abstract `batch_specs` belongs to the dry-run, which is
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from . import encdec, transformer, vlm, xlstm, zamba


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: Any
    mod: Any

    def init(self, gen: torch.Generator, dtype=torch.float32):
        return self.mod.init_lm(self.cfg, gen, dtype=dtype)

    def init_state(self, device=None):
        """The model's state on ``device``: CUDA unless asked
        (`device.resolve_device`), raising without a card.  Only an MoE
        model has one (its router queues); every other family's is
        ``ModelState(router_H=None)``."""
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


_FAMILY = {"dense": transformer, "moe": transformer, "hybrid": zamba,
           "ssm": xlstm, "encdec": encdec, "vlm": vlm}


def get_model(cfg) -> ModelAPI:
    if cfg.family not in _FAMILY:
        raise KeyError(f"{cfg.name}: unknown family {cfg.family!r}; known: "
                       f"{sorted(_FAMILY)}")
    return ModelAPI(cfg=cfg, mod=_FAMILY[cfg.family])
