"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064 — phi3-mini
backbone + CLIP frontend.  The CLIP tower is a STUB: input_specs()
supplies precomputed patch embeddings (576 tokens) prepended to the
token stream.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    num_image_tokens=576,
    norm="rmsnorm",
    act="silu",
)
