"""Config registry of the ported architectures: `get_config(arch_id)`.

Only the configurations whose family the port runs are here (dense and
MoE decoder-only transformers); the JAX package's other architectures
follow with their families (ROADMAP A13).
"""
from . import granite_moe_1b_a400m, moonshot_v1_16b_a3b, olmo_1b, qwen2_05b
from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig, reduced

_MODULES = (olmo_1b, qwen2_05b, moonshot_v1_16b_a3b, granite_moe_1b_a400m)

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"ported: {sorted(ARCHS)}")
    return ARCHS[arch]


__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS",
           "get_config", "reduced"]
