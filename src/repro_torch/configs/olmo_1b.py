"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab=50304,
    norm="layernorm_nonparam", tie_embeddings=True,
)
