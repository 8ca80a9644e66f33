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

Two paths, one rule (:func:`tensor_core_path`, defined beside K1-bwd;
the C entries check it as well): bf16 with a head dim that is a multiple
of 16 in [64, 128] runs on the tensor cores (``wgmma`` fed by TMA);
float32 and other head dims (e.g. 40) run the float32 FMA kernel.  Each
path counts its launches (``tc_launches``, ``fma_launches``) beside
``launches``; a chosen path that fails to launch raises, and nothing
falls back to the other.

For training, :class:`FlashAttention` joins K1 to its backward, K1-bwd
(:mod:`repro_torch.kernels.flash_attention_bwd`): the forward also
writes each row's log-sum-exp and saves ``(q, k, v, out, lse)``, the
backward recomputes the probabilities from them — the structure of the
reference's custom VJP in ``src/repro/kernels/flash_xla.py``.  On CPU
tensors the same Function runs the plain pair
(``ref.attention_fwd``/``ref.attention_bwd``).  :func:`flash_attention`
takes the Function only when autograd needs it; serving (no input that
requires grad) launches the forward alone and writes no LSE.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, flash_attention_bwd, ref
from repro_torch.kernels.flash_attention_bwd import tensor_core_path

plain = ref.attention

# kernel launches since the last reset (a run resets them to 0 and reads
# them to show that its path went through the kernel): all, and by path
launches = 0
tc_launches = 0
fma_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0, with_lse: bool = False):
    """Launch the CUDA kernel on the current stream.  Returns ``out``, or
    ``(out, lse)`` with ``with_lse`` (lse ``(B, S, H)`` float32, each
    row's log-sum-exp of its scaled, masked scores).  Raises on anything
    it does not take: tensors off the card, mixed or unsupported dtypes,
    bad shapes, non-contiguous inputs."""
    global launches, tc_launches, fma_launches
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
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = build.library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, T, H, KH, D,
        D ** -0.5, int(causal), int(window), int(q_offset),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "repro_flash_attention")
    launches += 1
    if tensor_core_path(q.dtype, D):
        tc_launches += 1
    else:
        fma_launches += 1
    return out if lse is None else (out, lse)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the plain version on a CPU tensor, the kernel on a
    CUDA tensor."""
    if q.device.type == "cpu":
        return ref.attention_fwd(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, with_lse=True)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: K1 forward with LSE, K1-bwd backward (the
    plain pair on CPU tensors).  Saves ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd.flash_attention_bwd(
            q, k, v, out, lse, do.contiguous(), causal=causal, window=window,
            q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q ``(B, S, H, D)``, k/v ``(B, T, KH, D)`` -> ``(B, S, H, D)``,
    differentiable when autograd records and an input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
