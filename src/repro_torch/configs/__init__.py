"""Architecture registry of the port: every arch of the reference
registry.  The dense decoders and phi-3-vision (the VLM: the dense
branch with an image-embedding prefix) share the dense branch of
``models/lm.py``; xlstm-125m (the xLSTM branch), hymba-1.5b (the hybrid
branch) and the MoE decoders phi3.5-moe and qwen3-moe (the MoE branch)
are built for their train paths only; whisper-large-v3 is the
encoder-decoder of ``models/encdec.py``.

``get_config`` accepts the exact id or the short alias, as the reference
registry does.  ``SHAPES`` and ``get_shape`` are the reference's
input-shape cells.
"""
from __future__ import annotations

from repro_torch.configs import (glm4_9b, hymba_15b, internlm2_20b,
                                 phi3_vision, phi35_moe_42b, qwen3_moe_235b,
                                 qwen15_4b, qwen2_15b, whisper_large_v3,
                                 xlstm_125m)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced

ARCHS = {
    "qwen2-1.5b": qwen2_15b.CONFIG,
    "qwen1.5-4b": qwen15_4b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "hymba-1.5b": hymba_15b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "phi-3-vision-4.2b": phi3_vision.CONFIG,
}

_ALIASES = {
    "qwen2": "qwen2-1.5b",
    "qwen15-4b": "qwen1.5-4b",
    "glm4": "glm4-9b",
    "internlm2": "internlm2-20b",
    "xlstm": "xlstm-125m",
    "hymba": "hymba-1.5b",
    "phi35-moe": "phi3.5-moe-42b-a6.6b",
    "qwen3-moe": "qwen3-moe-235b-a22b",
    "whisper": "whisper-large-v3",
    "phi3-vision": "phi-3-vision-4.2b",
}


def get_config(arch: str) -> ModelConfig:
    key = _ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(ARCHS)} "
            f"(aliases {sorted(_ALIASES)})")
    return ARCHS[key]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCHS", "ModelConfig", "SHAPES", "ShapeConfig", "get_config",
           "get_shape", "reduced"]
