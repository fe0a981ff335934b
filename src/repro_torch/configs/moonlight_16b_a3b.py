"""moonlight-16b-a3b [moe] — Moonlight-16B-A3B as published (deepseek_v3):
multi-head latent attention, 64 routed experts top-6 behind a sigmoid gate
beside 2 shared experts, and one leading dense layer.
[hf:moonshotai/Moonlight-16B-A3B config.json]

The port's own configuration: the JAX package has no such model (its
`moonshot-v1-16b-a3b` is a plain-attention guess at the same name), so it
is not in `ARCHS` or `cells()`; `get_config` finds it.

`MLAConfig` carries what the base `ModelConfig` cannot say.  Every base
field keeps its meaning: ``head_dim`` is the q/k head width (the no-RoPE
and RoPE parts together), ``n_kv_heads`` equals ``n_heads`` (the latent
expands to every head), ``d_ff`` is a routed expert's width.  The MLA path
reads the parts: ``qk_nope_head_dim`` + ``qk_rope_head_dim`` for q and k,
``v_head_dim`` for v.
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A `ModelConfig` with DeepSeek-V3's block (see the module's
    docstring):

      * ``kv_lora_rank``: the latent c's width (`kv_a_proj_with_mqa` maps d
        to it and one shared RoPE key of ``qk_rope_head_dim``);
      * ``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``;
      * ``n_shared_experts``: experts of width ``d_ff`` that every token
        passes, unweighted, held as one SwiGLU of their summed width;
      * ``first_dense_layers`` of SwiGLU width ``dense_d_ff`` ahead of the
        MoE layers;
      * ``score_func``: the gate's scores, "softmax" or "sigmoid"; the
        routed weights are the picks' scores over their sum times
        ``routed_scale``;
      * ``norm_eps``: every RMSNorm's epsilon.
    """
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    score_func: str = "softmax"
    routed_scale: float = 1.0
    norm_eps: float = 1e-6


CONFIG = MLAConfig(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=1408, vocab=163840, rope_theta=50_000.0, tie_embeddings=False,
    n_experts=64, top_k=6, router="backpressure",
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, n_shared_experts=2, first_dense_layers=1,
    dense_d_ff=11264, score_func="sigmoid", routed_scale=2.446,
    norm_eps=1e-5,
)
