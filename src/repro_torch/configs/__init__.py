"""Architecture registry of the port: the dense decoders that share the
ported dense branch of ``models/lm.py``, and xlstm-125m (the xLSTM
branch, train path only).

``get_config`` accepts the exact id or the short alias, as the reference
registry does.  Families the port does not build yet (MoE, audio,
hybrid, VLM) raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

from repro_torch.configs import (glm4_9b, internlm2_20b, qwen15_4b, qwen2_15b,
                                 xlstm_125m)
from repro_torch.configs.base import ModelConfig, ShapeConfig, reduced

ARCHS = {
    "qwen2-1.5b": qwen2_15b.CONFIG,
    "qwen1.5-4b": qwen15_4b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
}

_ALIASES = {
    "qwen2": "qwen2-1.5b",
    "qwen15-4b": "qwen1.5-4b",
    "glm4": "glm4-9b",
    "internlm2": "internlm2-20b",
    "xlstm": "xlstm-125m",
}

# archs of the reference registry (ids and aliases) that the port does
# not build yet, with the ROADMAP item that brings each family
_MOE = "ROADMAP queue 1, item 11 (MoE family, kernel K4)"
_NOT_PORTED = {
    "phi3.5-moe-42b-a6.6b": _MOE, "phi35-moe": _MOE,
    "qwen3-moe-235b-a22b": _MOE, "qwen3-moe": _MOE,
    "whisper-large-v3": "ROADMAP queue 1, item 11 (encoder-decoder)",
    "whisper": "ROADMAP queue 1, item 11 (encoder-decoder)",
    "hymba-1.5b": "ROADMAP queue 1, item 11 (hybrid family, kernel K5)",
    "hymba": "ROADMAP queue 1, item 11 (hybrid family, kernel K5)",
    "phi-3-vision-4.2b": "ROADMAP queue 1, item 11 (VLM family)",
    "phi3-vision": "ROADMAP queue 1, item 11 (VLM family)",
}


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet: {_NOT_PORTED[arch]}")
    key = _ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(ARCHS)} "
            f"(aliases {sorted(_ALIASES)})")
    return ARCHS[key]


__all__ = ["ARCHS", "ModelConfig", "ShapeConfig", "get_config", "reduced"]
