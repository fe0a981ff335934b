"""Config registry of the ported architectures: `get_config(arch_id)`.

Every configuration of the reference: dense (with gemma3's
local/global pattern), MoE, the VLM, the encoder-decoder, the Mamba2 +
shared-attention hybrid (zamba2-2.7b) and xLSTM (xlstm-350m).
`paper_grid.problem(C)` is the paper's own network instance.  `cells()`
lists the dry-run's (arch, shape) cells in the reference's order.

`get_config` also finds the port's own configurations (`PORT_ONLY`),
which the JAX package does not have and which `ARCHS` and `cells()` leave
out: moonlight-16b-a3b (latent attention, shared experts, a sigmoid gate).
"""
from . import (gemma3_27b, granite_moe_1b_a400m, internvl2_1b,
               moonlight_16b_a3b, moonshot_v1_16b_a3b, olmo_1b, qwen2_05b,
               qwen15_32b, seamless_m4t_large_v2, xlstm_350m, zamba2_2p7b)
from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig, reduced

# The reference's order: `ARCHS` and `cells()` list as its registry does.
_MODULES = (gemma3_27b, olmo_1b, qwen15_32b, qwen2_05b, moonshot_v1_16b_a3b,
            granite_moe_1b_a400m, seamless_m4t_large_v2, zamba2_2p7b,
            internvl2_1b, xlstm_350m)

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
#: Configurations of the port alone, outside the reference's registry.
PORT_ONLY = {moonlight_16b_a3b.CONFIG.name: moonlight_16b_a3b.CONFIG}


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in PORT_ONLY:
        return PORT_ONLY[arch]
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(ARCHS) + sorted(PORT_ONLY)}")


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; long_500k only for sub-quadratic
    archs unless include_skipped (the reference's rule)."""
    out = []
    for name, mc in ARCHS.items():
        for sname in SHAPES:
            if sname == "long_500k" and not (mc.is_subquadratic
                                             or include_skipped):
                continue
            out.append((name, sname))
    return out


__all__ = ["ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCHS",
           "PORT_ONLY", "get_config", "reduced", "cells"]
