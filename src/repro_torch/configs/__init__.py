"""Architecture registry of the port: the dense decoders that share the
ported dense branch of ``models/lm.py``, xlstm-125m (the xLSTM branch),
hymba-1.5b (the hybrid branch) and the MoE decoders phi3.5-moe and
qwen3-moe (the MoE branch), the last four for their train paths only.

``get_config`` accepts the exact id or the short alias, as the reference
registry does.  Families the port does not build yet (audio, VLM) raise
``NotImplementedError`` naming the ROADMAP entry that brings them.
"""
from __future__ import annotations

from repro_torch.configs import (glm4_9b, hymba_15b, internlm2_20b,
                                 phi35_moe_42b, qwen3_moe_235b, qwen15_4b,
                                 qwen2_15b, xlstm_125m)
from repro_torch.configs.base import ModelConfig, ShapeConfig, reduced

ARCHS = {
    "qwen2-1.5b": qwen2_15b.CONFIG,
    "qwen1.5-4b": qwen15_4b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "hymba-1.5b": hymba_15b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
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
}

# archs of the reference registry (ids and aliases) that the port does
# not build yet, with the ROADMAP entry that brings each family
_ENCDEC = "ROADMAP queue 1, the encoder-decoder family"
_VLM = "ROADMAP queue 1, the VLM family"
_NOT_PORTED = {
    "whisper-large-v3": _ENCDEC, "whisper": _ENCDEC,
    "phi-3-vision-4.2b": _VLM, "phi3-vision": _VLM,
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
