"""K1: flash attention forward, a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``flash_attention_bhsd`` of the reference
package (``src/repro/kernels/flash_attention.py``); the CUDA source, with
what bounds it on the H100 and what its design does about it, is
``csrc/flash_attention.cu``.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.attention`.

:func:`flash_attention` chooses by the tensors' device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (or raises).  The
kernel takes the reference layout as it is — q ``(B, S, H, D)``, k/v
``(B, T, KH, D)`` — with ``D`` unpadded and ``S``/``T`` ragged, so the
wrapper neither transposes nor pads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

plain = ref.attention

# kernel launches since the last reset (a run resets it to 0 and reads it
# to show that its path went through the kernel)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Raises on anything
    it does not take: tensors off the card, mixed or unsupported dtypes,
    bad shapes, non-contiguous inputs."""
    global launches
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors; "
                             f"{name} is on {x.device}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KH, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, T, KH, D) = ({B}, T, KH, {D}); "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if KH < 1 or H % KH:
        raise ValueError(f"num_heads {H} must be a multiple of kv heads {KH}")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"head_dim {D} must be a multiple of 8 in [8, 256]")
    if window < 0 or q_offset < 0:
        raise ValueError("window and q_offset must be >= 0")
    if S == 0 or T == 0 or B == 0:
        raise ValueError("empty attention")
    out = torch.empty_like(q)
    lib = build.library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KH, D, D ** -0.5, int(causal), int(window), int(q_offset),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "repro_flash_attention")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q ``(B, S, H, D)``, k/v ``(B, T, KH, D)`` -> ``(B, S, H, D)``."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
