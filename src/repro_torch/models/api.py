"""Uniform model API — the entry point the serving engine, the step
builders and tests use.

Port of `repro.models.api` for every family: dense (with the
k-local:1-global pattern) and MoE decoder-only transformers, the Mamba2 +
shared-attention hybrid (`zamba`), xLSTM (`xlstm`), the VLM and the
encoder-decoder:

  api = get_model(cfg)
  params~ = api.init(gen, dtype, abstract)          # Annotated tree
  loss, (H', metrics) = api.loss(params, batch, ...)  # training loss
  logits, H', aux = api.logits(params, batch, ...)  # prefill forward
  caches = api.init_decode(batch, max_len, dtype, device, abstract)
  axes = api.cache_axes(caches)
  logits, caches = api.decode_step(params, caches, batch, ...)
  specs, axes = api.batch_specs(shape)              # meta inputs (dry-run)

Abstract state and specs are tensors on the meta device: the reference's
ShapeDtypeStructs, which the dry-run (`launch.dryrun`) traces.
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

    def init(self, gen: torch.Generator | None = None, dtype=torch.float32,
             abstract: bool = False):
        return self.mod.init_lm(self.cfg, gen, dtype=dtype,
                                abstract=abstract)

    def init_state(self, device=None, abstract: bool = False):
        """The model's state on ``device``: CUDA unless asked
        (`device.resolve_device`), raising without a card; the meta device
        when ``abstract``.  Only an MoE model has one (its router queues);
        every other family's is ``ModelState(router_H=None)``."""
        return transformer.init_model_state(
            self.cfg, device=resolve_device(device, abstract))

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

    def init_decode(self, batch: int, max_len: int, dtype, device=None,
                    abstract: bool = False):
        """Empty decode caches on ``device``, resolved as `init_state`."""
        return self.mod.init_decode_caches(
            self.cfg, batch, max_len, dtype,
            device=resolve_device(device, abstract))

    def cache_axes(self, tree):
        return self.mod.cache_axes(tree)

    def decode_step(self, params, caches, batch, *,
                    activ_dtype=torch.bfloat16, router_H=None):
        return self.mod.lm_decode_step(self.cfg, params, caches,
                                       batch["tokens"],
                                       activ_dtype=activ_dtype,
                                       router_H=router_H)

    def batch_specs(self, shape, activ_dtype=torch.bfloat16):
        """Abstract inputs of ``shape`` (a `ShapeConfig`): (meta tensors,
        logical axes), the reference's shapes, dtypes and axes.  Tokens are
        int32 as the reference's; the port's steps index with them as they
        are (the cross entropy widens its labels to int64 itself)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def tok(*sh):
            return torch.empty(sh, dtype=torch.int32, device="meta")

        def emb(*sh):
            return torch.empty(sh, dtype=activ_dtype, device="meta")

        if shape.kind == "decode":
            return {"tokens": tok(B)}, {"tokens": ("act_batch",)}
        if cfg.family == "encdec":
            specs = {"frames": emb(B, S, cfg.d_model), "tokens": tok(B, S)}
            axes = {"frames": ("act_batch", "act_seq", "act_embed"),
                    "tokens": ("act_batch", "act_seq")}
        elif cfg.family == "vlm":
            specs = {"patch_embeds": emb(B, cfg.n_patches, cfg.d_model),
                     "tokens": tok(B, S - cfg.n_patches)}
            axes = {"patch_embeds": ("act_batch", None, "act_embed"),
                    "tokens": ("act_batch", "act_seq")}
        else:
            specs = {"tokens": tok(B, S)}
            axes = {"tokens": ("act_batch", "act_seq")}
        return specs, axes


_FAMILY = {"dense": transformer, "moe": transformer, "hybrid": zamba,
           "ssm": xlstm, "encdec": encdec, "vlm": vlm}


def get_model(cfg) -> ModelAPI:
    if cfg.family not in _FAMILY:
        raise KeyError(f"{cfg.name}: unknown family {cfg.family!r}; known: "
                       f"{sorted(_FAMILY)}")
    return ModelAPI(cfg=cfg, mod=_FAMILY[cfg.family])
