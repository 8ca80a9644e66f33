"""K4: the grouped matmul over expert-sorted rows, a hand-written CUDA
kernel for Hopper, and its backward.

K4 replaces the TPU kernel ``moe_gmm_sorted`` of the reference package
(``src/repro/kernels/moe_gmm.py``); its CUDA source, with what bounds it
on the H100 and what its design does about it, is ``csrc/moe_gmm.cu``.
The plain version is :func:`repro_torch.kernels.ref.moe_gmm`.

:func:`moe_gmm` chooses by the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises).  Tokens
``(M, K)`` are sorted so that expert ``e`` owns ``group_sizes[e]``
consecutive rows; w is ``(E, K, N)``, or ``(E, N, K)`` read transposed
with ``transpose_w``.  The two versions differ on the rows past
``sum(group_sizes)`` only: K4 writes zeros there (as the Pallas kernel
does), the plain version the last expert's product (as the reference's
oracle does).

:class:`MoeGmm` gives K4 a backward; the reference has none and lets XLA
differentiate its einsum.  dX is K4 again, on dY with each ``W_e`` read
transposed (one launch); dW_e = X_eᵀ dY_e is a plain product — one
``torch.bmm`` on the equal-group layout of the MoE layer's capacity
buffer, a loop over the groups in expert order otherwise.  Both are
deterministic: K4 sums every output element in one thread in a fixed
order, and no gradient is scattered with atomics.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build, ref

plain = ref.moe_gmm

# kernel launches since the last reset (the forward's and the backward's
# dX products alike)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Sizes = Union[torch.Tensor, Sequence[int]]


def _sizes_tensor(group_sizes: Sizes, device: torch.device) -> torch.Tensor:
    """``group_sizes`` as an int32 tensor on ``device``; equal sizes are
    filled on the device (no host copy that waits for the stream)."""
    if isinstance(group_sizes, torch.Tensor):
        return group_sizes.to(device=device, dtype=torch.int32)
    sizes = [int(s) for s in group_sizes]
    if sizes and all(s == sizes[0] for s in sizes):
        return torch.full((len(sizes),), sizes[0], dtype=torch.int32,
                          device=device)
    return torch.tensor(sizes, dtype=torch.int32).to(device)


def moe_gmm_cuda(tokens: torch.Tensor, group_sizes: Sizes, w: torch.Tensor,
                 *, transpose_w: bool = False) -> torch.Tensor:
    """Launch K4 on the current stream.  Raises on anything it does not
    take."""
    global launches
    for name, x in (("tokens", tokens), ("w", w)):
        if x.device.type != "cuda":
            raise ValueError(f"moe_gmm_cuda needs CUDA tensors; {name} is "
                             f"on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tokens.dtype not in _DTYPES:
        raise ValueError(f"dtype {tokens.dtype} not supported (float32 or "
                         f"bfloat16)")
    if w.dtype != tokens.dtype:
        raise ValueError(f"w is {w.dtype}, tokens are {tokens.dtype}")
    if tokens.dim() != 2 or w.dim() != 3:
        raise ValueError(f"tokens must be (M, K) and w (E, K, N); got "
                         f"{tuple(tokens.shape)} and {tuple(w.shape)}")
    M, K = tokens.shape
    E = w.shape[0]
    N, Kw = (w.shape[1], w.shape[2]) if transpose_w else (w.shape[2],
                                                          w.shape[1])
    if Kw != K:
        raise ValueError(f"w {tuple(w.shape)} does not contract tokens' K = "
                         f"{K}" + (" (transposed)" if transpose_w else ""))
    if isinstance(group_sizes, torch.Tensor):
        if group_sizes.device != tokens.device:
            raise ValueError(f"group_sizes is on {group_sizes.device}, "
                             f"tokens on {tokens.device}")
        if group_sizes.dtype.is_floating_point:
            raise ValueError("group_sizes must be integers")
    sizes = _sizes_tensor(group_sizes, tokens.device)
    if sizes.shape != (E,):
        raise ValueError(f"group_sizes must be ({E},), got "
                         f"{tuple(sizes.shape)}")
    if M == 0 or N == 0:
        return torch.zeros((M, N), dtype=tokens.dtype, device=tokens.device)
    out = torch.empty((M, N), dtype=tokens.dtype, device=tokens.device)
    sched = torch.empty((2 * (E + 2),), dtype=torch.int32,
                        device=tokens.device)
    err = build.library().repro_moe_gmm(
        tokens.data_ptr(), sizes.data_ptr(), w.data_ptr(), out.data_ptr(),
        sched.data_ptr(), M, K, N, E, int(transpose_w),
        _DTYPES[tokens.dtype],
        torch.cuda.current_stream(tokens.device).cuda_stream)
    build.check(err, "repro_moe_gmm")
    launches += 1
    return out


def moe_gmm(tokens: torch.Tensor, group_sizes: Sizes, w: torch.Tensor, *,
            transpose_w: bool = False) -> torch.Tensor:
    """``(M, N)``: the plain version on a CPU tensor, K4 on a CUDA
    tensor."""
    if tokens.device.type == "cpu":
        return plain(tokens, group_sizes, w, transpose_w=transpose_w)
    return moe_gmm_cuda(tokens, group_sizes, w, transpose_w=transpose_w)


def weight_grad(tokens: torch.Tensor, dy: torch.Tensor,
                sizes: Sequence[int], E: int) -> torch.Tensor:
    """dW ``(E, K, N)`` in tokens' dtype: ``X_eᵀ dY_e`` for each group, the
    rows past ``sum(sizes)`` counted as the forward counted them (the last
    expert's on a CPU tensor, none on a CUDA one)."""
    M, K = tokens.shape
    N = dy.shape[1]
    sizes = [int(s) for s in sizes]
    if E and sizes == [M // E] * E and M % E == 0:
        # the capacity buffer's equal groups: one batched product
        g = M // E
        return torch.bmm(tokens.view(E, g, K).transpose(1, 2),
                         dy.view(E, g, N))
    dw = torch.zeros((E, K, N), dtype=tokens.dtype, device=tokens.device)
    for e, (lo, hi) in enumerate(ref.group_ranges(
            sizes, M, tail_to_last=tokens.device.type == "cpu")):
        if hi > lo:
            dw[e] = tokens[lo:hi].t() @ dy[lo:hi]
    return dw


class MoeGmm(torch.autograd.Function):
    """Differentiable grouped matmul: K4 forward, K4 on the transposed
    weights for dX and plain products for dW (the plain versions on CPU
    tensors).  Saves the tokens and the weights."""

    @staticmethod
    def forward(ctx, tokens, w, sizes: torch.Tensor,
                host_sizes: Optional[Tuple[int, ...]]):
        ctx.save_for_backward(tokens, w, sizes)
        ctx.host_sizes = host_sizes
        return moe_gmm(tokens, sizes, w)

    @staticmethod
    def backward(ctx, dy):
        tokens, w, sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gmm(dy, sizes, w, transpose_w=True)
        if ctx.needs_input_grad[1]:
            host = ctx.host_sizes
            if host is None:  # reads the sizes back from the device
                host = tuple(sizes.tolist())
            dw = weight_grad(tokens, dy, host, w.shape[0])
        return dx, dw, None, None


def moe_gmm_op(tokens: torch.Tensor, group_sizes: Sizes,
               w: torch.Tensor) -> torch.Tensor:
    """``(M, N)`` grouped product, differentiable through :class:`MoeGmm`
    when autograd records and tokens or w require grad.  ``group_sizes``
    may be a sequence of ints (known on the host: the backward then reads
    nothing back from the device) or an integer tensor."""
    if torch.is_grad_enabled() and (tokens.requires_grad or w.requires_grad):
        host = (None if isinstance(group_sizes, torch.Tensor)
                else tuple(int(s) for s in group_sizes))
        sizes = _sizes_tensor(group_sizes, tokens.device)
        return MoeGmm.apply(tokens, w, sizes, host)
    return moe_gmm(tokens, group_sizes, w)
