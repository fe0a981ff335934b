"""Model, shape and run configuration: `ModelConfig`, `ShapeConfig`,
`SHAPES`, `RunConfig` and `reduced`.

A copy of `repro.configs.base` for the families the port runs (the port
imports nothing of `repro`), fields and defaults unchanged.  Of
`RunConfig`'s knobs the port's step builders read `model`,
`activ_dtype`, `param_dtype`, `remat`, `grad_accum` and
`grad_compression`; the dry-run (`launch.dryrun`) reads the sharding
knobs for its logical meshes and sets the attention flags from
`attn_impl` and `ctx_par`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention details
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    window: Optional[int] = None   # sliding-window size for local layers
    local_global: int = 0          # k => pattern (k local : 1 global); 0 = all global
    norm: str = "rmsnorm"          # rmsnorm | layernorm_nonparam
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    router: str = "backpressure"   # backpressure | aux | plain
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: shared attn block every k ssm layers
    # xLSTM
    slstm_every: int = 0           # 1 sLSTM per k blocks (rest mLSTM)
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # VLM
    n_patches: int = 0

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch decode at 500k context without quadratic attention?"""
        return self.family in ("ssm", "hybrid")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Distribution + performance knobs (hillclimb surface)."""
    model: ModelConfig
    shape: ShapeConfig
    multi_pod: bool = False
    # sharding strategy
    fsdp: bool = True              # shard params/opt over 'data' (else pure DP)
    seq_shard_decode: bool = True  # shard KV cache / state over 'data' at decode
    kv_seq_tp: str = "off"         # off | auto: cache seq over 'model' when
                                   # kv_heads don't divide the model axis
    expert_parallel: bool = True   # shard experts over 'model' (else replicate)
    # memory / remat
    remat: str = "full"            # full | dots | none
    scan_layers: bool = True
    attn_impl: str = "naive"       # naive (materialized) | chunked (online-softmax)
    ctx_par: bool = False          # context-parallel attention (q-seq over model)
    # numerics
    activ_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # optimizer
    grad_accum: int = 1
    grad_compression: str = "none" # none | int8_ef | topk_ef


def reduced(model: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's rules)."""
    scale = dict(
        n_layers=min(model.n_layers, 2 if model.local_global == 0 else model.local_global + 1),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(model.n_kv_heads, 2) if model.n_kv_heads < model.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab=256,
    )
    if model.local_global:
        scale["n_layers"] = model.local_global + 1
        scale["window"] = 8
    if model.n_experts:
        scale["n_experts"] = 8
        scale["top_k"] = min(model.top_k, 2)
        scale["d_ff"] = 32
        scale["capacity_factor"] = 4.0   # effectively dropless at test sizes
    if model.family in ("ssm", "hybrid"):
        scale["ssm_state"] = 16
        scale["ssm_head_dim"] = 16
        scale["ssm_chunk"] = 16
    if model.attn_every:
        scale["attn_every"] = 2
        scale["n_layers"] = 4
    if model.slstm_every:
        scale["slstm_every"] = 2
        scale["n_layers"] = 4
    if model.enc_layers:
        scale["enc_layers"] = 2
        scale["dec_layers"] = 2
    if model.n_patches:
        scale["n_patches"] = 8
    scale.update(overrides)
    return dataclasses.replace(model, **scale)
