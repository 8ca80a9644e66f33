"""Architecture registry of the port: the dense decoders that share the
ported dense branch of ``models/lm.py``, xlstm-125m (the xLSTM branch),
hymba-1.5b (the hybrid branch) and the MoE decoders phi3.5-moe and
qwen3-moe (the MoE branch), the last four for their train paths only.

``get_config`` accepts the exact id or the short alias, as the reference
registry does.  Families the port does not build yet (audio, VLM) raise
``NotImplementedError`` naming the ROADMAP entry that brings them;
``plan_config`` returns every arch of the reference registry, those two
included, for the planner and the cost model, which read only a config's
sizes.  ``SHAPES`` and ``get_shape`` are the reference's input-shape
cells.
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


# configs of the archs above, for planning only (no model is built)
_PLAN_ONLY = {
    "whisper-large-v3": whisper_large_v3.CONFIG,
    "whisper": whisper_large_v3.CONFIG,
    "phi-3-vision-4.2b": phi3_vision.CONFIG,
    "phi3-vision": phi3_vision.CONFIG,
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


def plan_config(arch: str) -> ModelConfig:
    """The config of any arch of the reference registry, built by the
    port or not: what the planner and the cost model size a plan by."""
    if arch in _PLAN_ONLY:
        return _PLAN_ONLY[arch]
    return get_config(arch)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCHS", "ModelConfig", "SHAPES", "ShapeConfig", "get_config",
           "get_shape", "plan_config", "reduced"]
