"""Optimizer and gradient compression of the training step (port of
`repro.optim`): AdamW with global-norm clipping and a warmup+cosine
schedule, and int8 / top-k gradient compression with error feedback."""
from .adamw import AdamW, AdamWState, global_norm, warmup_cosine
from .compression import (EFState, compress_int8_ef, compress_topk_ef,
                          init_ef, init_ef_abstract)

__all__ = ["AdamW", "AdamWState", "global_norm", "warmup_cosine", "EFState",
           "init_ef", "init_ef_abstract", "compress_int8_ef",
           "compress_topk_ef"]
