"""hymba-1.5b [arXiv:2411.13676].

A copy of the reference package's ``configs/hymba_15b.py``.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + mamba heads per block.  Attention is sliding-window
(2048) except 3 global layers (first/middle/last, per the Hymba paper),
so long_500k runs (sub-quadratic).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    sliding_window=2048,
    global_attn_layers=(0, 15, 31),
    norm="rmsnorm",
    act="silu",
)
