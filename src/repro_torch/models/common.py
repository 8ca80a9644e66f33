"""Shared model building blocks: parameter init, norms, RoPE, activations.

Counterpart of the reference package's ``models/common.py``.  Norms and
RoPE compute in float32 and cast back to the input's dtype, as the
reference does; RoPE is the half-split form (not interleaved).
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _fold(seed: int, name: str) -> int:
    """A 63-bit generator seed for parameter ``name`` under ``seed``."""
    h = hashlib.md5(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def init_param(name: str, shape: Sequence[int], *, seed: int,
               device: torch.device, dtype: torch.dtype = torch.float32,
               init: str = "normal", scale: float = 0.02) -> torch.Tensor:
    """One parameter, initialised as the reference's ``ParamBuilder.p``
    does: ``normal`` is a fan-in-scaled normal with std
    ``min(scale, fan_in ** -0.5)`` (fan-in is ``shape[-2]``, or
    ``shape[-1]`` for a vector), ``small_normal`` a normal with std 0.01,
    ``zeros``/``ones`` are constant.

    The draw comes from a ``torch.Generator`` on ``device`` seeded by
    ``(seed, name)``, so each parameter is reproducible on its own; it
    does not give the reference's bits (tests bridge weights instead)."""
    shape = tuple(shape)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "normal":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = min(scale, fan_in ** -0.5)
    elif init == "small_normal":
        std = 0.01
    else:
        raise ValueError(init)
    gen = torch.Generator(device=device).manual_seed(_fold(seed, name))
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(dt)


def apply_norm(params, name: str, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, params[f"{name}_g"], params[f"{name}_b"])
    return rms_norm(x, params[f"{name}_g"])


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., head_dim // 2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D).  cos/sin: (B, S, D/2) or (S, D/2)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:  # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)
