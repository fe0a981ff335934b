"""moonshot-v1-16b-a3b [moe] — 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]

The JAX package's guess at the model, kept as it has it;
`moonlight_16b_a3b` is the published model (latent attention, shared
experts, a leading dense layer)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, router="backpressure",
)
