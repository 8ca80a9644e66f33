"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family].

A copy of the reference package's ``configs/qwen3_moe_235b.py``.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    norm="rmsnorm",
    act="silu",
)
