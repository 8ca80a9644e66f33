"""qwen1.5-4b [hf:Qwen/Qwen1.5 family].

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
)
