"""internvl2-1b [vlm] — InternViT frontend STUB (precomputed patch
embeddings) + qwen2-0.5b-shaped LM backbone. [arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655,
    qkv_bias=True, tie_embeddings=True, n_patches=256,
)
