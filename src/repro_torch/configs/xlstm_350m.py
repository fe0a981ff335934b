"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (1 sLSTM per 6 blocks), d_ff=0
(blocks carry their own projections). [arXiv:2405.04517; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab=50304,
    slstm_every=6, ssm_head_dim=256,
)
