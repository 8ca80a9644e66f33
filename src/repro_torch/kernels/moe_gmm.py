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

Two paths, chosen by the C entry alone (``repro_moe_gmm_tensor_cores``
plus 16-byte-aligned pointers): bf16 with K and N multiples of 8 runs on
the tensor cores — ``wgmma`` fed by TMA, one persistent block an SM
walking 128 x 256 output tiles in the order :func:`tile_order` gives;
float32 and other widths run the float32 FMA kernel.  The entry reports
the path it launched, and the wrapper counts it (``tc_launches``,
``fma_launches``) beside ``launches``; a launch that fails raises, and
nothing falls back to the other path.

:class:`MoeGmm` gives K4 a backward; the reference has none and lets XLA
differentiate its einsum.  dX is K4 again, on dY with each ``W_e`` read
transposed (one launch); dW_e = X_eᵀ dY_e is a plain product — one
``torch.bmm`` on the equal-group layout of the MoE layer's capacity
buffer, a loop over the groups in expert order otherwise.  Both are
deterministic: K4 sums every output element in one warpgroup (or one
thread) in a fixed order, and no gradient is scattered with atomics.
"""
from __future__ import annotations

import bisect
import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build, ref, work

plain = ref.moe_gmm

# kernel launches since the last reset (the forward's and the backward's
# dX products alike): all, and by path
launches = 0
tc_launches = 0
fma_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Sizes = Union[torch.Tensor, Sequence[int]]

# The tensor-core path's tiling (``csrc/moe_gmm.cu``, namespace ``tc``):
# rows and columns of an output tile, and row tiles of a raster band
BM, BN, BAND = 128, 256, 16
Tile = Tuple[int, int, int, int]  # (group, row0, row_end, n0)


def schedule(sizes: Sequence[int], M: int) -> Tuple[List[int], List[int]]:
    """The schedule kernel's output: ``row_start`` and ``tile_start``, each
    ``E + 2`` long.  Group ``g < E`` is expert g's rows, group ``E`` the
    rows past ``sum(sizes)`` (clamped to M); ``row_start[E + 1]`` is M and
    ``tile_start[E + 1]`` the number of row tiles of ``BM`` rows."""
    row_start, tile_start = [], []
    rows = tiles = 0
    for size in sizes:
        lo = min(rows, M)
        rows += max(int(size), 0)
        row_start.append(lo)
        tile_start.append(tiles)
        tiles += -(-(min(rows, M) - lo) // BM)
    lo = min(rows, M)
    return (row_start + [lo, M],
            tile_start + [tiles, tiles + -(-(M - lo) // BM)])


def _tile_at(row_start, tile_start, n_ct: int, t: int) -> Tile:
    """The ``t``-th tile of the walk (the kernel's ``tile_at``)."""
    E = len(row_start) - 2
    # the largest g with tile_start[g] <= t // n_ct: empty groups are skipped
    g = bisect.bisect_right(tile_start, t // n_ct, 0, E + 1) - 1
    first = tile_start[g]
    rows = tile_start[g + 1] - first
    u = t - first * n_ct
    b = u // (BAND * n_ct)
    in_band = min(BAND, rows - b * BAND)
    r = u - b * BAND * n_ct
    row0 = row_start[g] + (b * BAND + r % in_band) * BM
    return g, row0, min(row0 + BM, row_start[g + 1]), (r // in_band) * BN


def tile_order(sizes: Sequence[int], M: int, N: int,
               blocks: int) -> List[List[Tile]]:
    """For each of ``blocks`` blocks, the ``(group, row0, row_end, n0)``
    output tiles it takes, in the order it takes them: block b takes
    tiles b, b + blocks, ... of one walk.  The walk goes group by group
    (the tail group E, the rows past ``sum(sizes)``, last); inside a group
    in bands of ``BAND`` row tiles, the row tile fastest inside a band and
    the column tile next.  A tile never straddles two groups; group g's
    tiles cover its rows ``[row_start[g], row_start[g + 1])``."""
    row_start, tile_start = schedule(sizes, M)
    n_ct = -(-N // BN)
    total = tile_start[-1] * n_ct
    return [[_tile_at(row_start, tile_start, n_ct, t)
             for t in range(b, total, blocks)] for b in range(blocks)]


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
                 *, transpose_w: bool = False,
                 host_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch K4 on the current stream.  Raises on anything it does not
    take.  Without rows, columns, depth or experts (M, N, K or E 0) the
    product is zeros and nothing launches.  A dry call under a counter
    (:func:`work.dry`) counts and returns the output unlaunched;
    ``host_sizes`` (the sizes known on the host, where ``group_sizes`` is
    their tensor) are read by the count alone."""
    global launches, tc_launches, fma_launches
    dry = work.dry(tokens)
    for name, x in (("tokens", tokens), ("w", w)):
        if x.device.type != "cuda" and not dry:
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
    if M == 0 or N == 0 or K == 0 or E == 0:
        return torch.zeros((M, N), dtype=tokens.dtype, device=tokens.device)
    out = torch.empty((M, N), dtype=tokens.dtype, device=tokens.device)
    sched = torch.empty((2 * (E + 2),), dtype=torch.int32,
                        device=tokens.device)
    if work.counting():
        if host_sizes is None and not isinstance(group_sizes, torch.Tensor):
            host_sizes = group_sizes
        rows = M if host_sizes is None else min(
            M, sum(max(int(s), 0) for s in host_sizes))
        work.record("K4", M=M, K=K, N=N, E=E, rows=rows,
                    dtype=work.dtype_name(tokens.dtype))
    if dry:
        return out
    tc = ctypes.c_int(-1)  # the path the library launched
    err = build.library().repro_moe_gmm(
        tokens.data_ptr(), sizes.data_ptr(), w.data_ptr(), out.data_ptr(),
        sched.data_ptr(), M, K, N, E, int(transpose_w),
        _DTYPES[tokens.dtype],
        torch.cuda.current_stream(tokens.device).cuda_stream,
        ctypes.addressof(tc))
    build.check(err, "repro_moe_gmm")
    launches += 1
    if tc.value == 1:
        tc_launches += 1
    else:
        fma_launches += 1
    return out


def tile_order_cuda(sizes: torch.Tensor, M: int, N: int,
                    blocks: int) -> List[List[Tile]]:
    """The tensor-core path's walk as the card runs it (the kernel's own
    schedule and ``tile_at``, in a kernel of ``blocks`` blocks that only
    writes the tiles out): the card tests hold it against
    :func:`tile_order`."""
    E = sizes.numel()
    sizes = sizes.to(dtype=torch.int32).contiguous()
    n_tiles = (-(-M // BM) + E) * -(-N // BN)  # at most
    steps = -(-n_tiles // blocks)
    sched = torch.empty((2 * (E + 2),), dtype=torch.int32,
                        device=sizes.device)
    tiles = torch.empty((blocks, steps, 4), dtype=torch.int32,
                        device=sizes.device)
    err = build.library().repro_moe_gmm_walk(
        sizes.data_ptr(), sched.data_ptr(), tiles.data_ptr(), M, N, E,
        blocks, steps, torch.cuda.current_stream(sizes.device).cuda_stream)
    build.check(err, "repro_moe_gmm_walk")
    return [[tuple(t) for t in block if t[0] >= 0]
            for block in tiles.tolist()]


def moe_gmm(tokens: torch.Tensor, group_sizes: Sizes, w: torch.Tensor, *,
            transpose_w: bool = False,
            host_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``(M, N)``: the plain version on a CPU tensor, K4 on a CUDA
    tensor."""
    if work.takes_plain(tokens):
        return plain(tokens, group_sizes, w, transpose_w=transpose_w)
    return moe_gmm_cuda(tokens, group_sizes, w, transpose_w=transpose_w,
                        host_sizes=host_sizes)


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
        return moe_gmm(tokens, sizes, w, host_sizes=host_sizes)

    @staticmethod
    def backward(ctx, dy):
        tokens, w, sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gmm(dy, sizes, w, transpose_w=True,
                         host_sizes=ctx.host_sizes)
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
