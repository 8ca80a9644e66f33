"""K1-bwd: the flash attention backward, a hand-written CUDA kernel for
Hopper.

Replaces the backward the reference package trains with, the custom VJP
``_bwd_vjp`` of ``src/repro/kernels/flash_xla.py`` (the TPU path keeps
that VJP around its Pallas forward, ``flash_attention_bhsd``); the CUDA
source, with what bounds it on the H100 and what its design does about
it, is ``csrc/flash_attention_bwd.cu``.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.attention_bwd`.

:func:`flash_attention_bwd` chooses by the tensors' device: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (or raises).
The kernel reads the reference layout as it is — q, out, dO
``(B, S, H, D)``, k/v ``(B, T, KH, D)``, lse ``(B, S, H)`` float32 — and
returns dq, dk, dv in the input dtype.  It is deterministic: no atomics,
every sum in a fixed order.  It takes the forward's path, by the one rule
both use (:func:`tensor_core_path`, here because K1's module imports this
one): bf16 at a head dim that is a multiple of 16 in [64, 128] on the
tensor cores, the rest on the float32 FMA kernels; ``tc_launches`` and
``fma_launches`` count each path beside ``launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

plain = ref.attention_bwd

# kernel launches since the last reset (one per backward call): all, and
# by path
launches = 0
tc_launches = 0
fma_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
BQ, BK = 32, 64      # the FMA kernels' q and kv tiles


def tensor_core_path(dtype: torch.dtype, head_dim: int) -> bool:
    """True when K1 and K1-bwd run on the tensor cores for this dtype and
    head dim: bf16, and a head dim that is a multiple of 16 in [64, 128]
    (every head dim of the repo's configs: 64, 96, 128).  float32 stays
    on the FMA kernels (TF32 products would break its bounds), as do the
    other head dims.  ``repro_flash_attention_tensor_cores`` in the CUDA
    source is the same rule."""
    return (dtype == torch.bfloat16 and head_dim % 16 == 0
            and 64 <= head_dim <= 128)


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of the larger FMA (dK/dV) kernel at ``head_dim``:
    K, V, Q and dO tiles as float32 rows of ``D + 4``, the P and dS tiles,
    and the tile's lse and delta (``smem_bytes`` in the CUDA source)."""
    return 4 * (2 * BK * (head_dim + 4) + 2 * BQ * (head_dim + 4)
                + 2 * BQ * (BK + 1) + 2 * BQ)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the backward kernels on the current stream.  Raises on
    anything they do not take: tensors off the card, mixed or unsupported
    dtypes, bad shapes, non-contiguous or misaligned inputs, a head dim
    outside [8, 256] or not a multiple of 8, a shared-memory layout over
    what a block may use."""
    global launches, tc_launches, fma_launches
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("do", do),
                    ("lse", lse)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors; "
                             f"{name} is on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name != "lse" and x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KH, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, T, KH, D) = ({B}, T, KH, {D}); "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out and do must be {tuple(q.shape)}; got "
                         f"{tuple(out.shape)} and {tuple(do.shape)}")
    if lse.shape != (B, S, H):
        raise ValueError(f"lse must be ({B}, {S}, {H}), got "
                         f"{tuple(lse.shape)}")
    if KH < 1 or H % KH:
        raise ValueError(f"num_heads {H} must be a multiple of kv heads {KH}")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"head_dim {D} must be a multiple of 8 in [8, 256]")
    if smem_bytes(D) > SMEM_LIMIT:
        raise ValueError(f"head_dim {D} needs {smem_bytes(D)} bytes of "
                         f"shared memory, over the {SMEM_LIMIT} a block "
                         f"may use")
    if window < 0 or q_offset < 0:
        raise ValueError("window and q_offset must be >= 0")
    if S == 0 or T == 0 or B == 0:
        raise ValueError("empty attention")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    lib = build.library()
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, T, H, KH, D, D ** -0.5,
        int(causal), int(window), int(q_offset), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "repro_flash_attention_bwd")
    launches += 1
    if tensor_core_path(q.dtype, D):
        tc_launches += 1
    else:
        fma_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """``(dq, dk, dv)`` of attention from the saved forward: the plain
    version on a CPU tensor, the kernel on a CUDA tensor."""
    if q.device.type == "cpu":
        return plain(q, k, v, out, lse, do, causal=causal, window=window,
                     q_offset=q_offset)
    return flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                                    window=window, q_offset=q_offset)
