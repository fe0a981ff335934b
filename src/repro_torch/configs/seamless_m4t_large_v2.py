"""seamless-m4t-large-v2 [audio] — enc-dec backbone; the audio frontend is a
STUB (input_specs provides precomputed frame embeddings). "24L" = 24 encoder
+ 24 decoder layers (following the released checkpoint; see DESIGN.md §5).
[arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206,
    enc_layers=24, dec_layers=24, tie_embeddings=True,
)
