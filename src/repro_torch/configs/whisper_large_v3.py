"""whisper-large-v3 [arXiv:2212.04356].

Enc-dec: 32 encoder + 32 decoder layers, d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866.  The conv/audio frontend is a STUB: input_specs()
supplies precomputed frame embeddings (1500 x 1280).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    encoder_layers=32,
    encoder_frames=1500,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
)
