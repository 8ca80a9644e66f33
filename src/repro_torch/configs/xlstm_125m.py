"""xlstm-125m [arXiv:2405.04517].

A copy of the reference package's ``configs/xlstm_125m.py``.

12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks (1 sLSTM
every 4 blocks, xLSTM[7:1]-style ratio).  Attention-free: long_500k runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)
