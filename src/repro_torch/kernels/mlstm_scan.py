"""K6 and K6-bwd: the chunkwise mLSTM and its backward, hand-written CUDA
kernels for Hopper.

K6 replaces the TPU kernel ``mlstm_scan_bhsd`` of the reference package
(``src/repro/kernels/mlstm_scan.py``); its CUDA source, with what bounds
it on the H100 and what its design does about it, is
``csrc/mlstm_scan.cu``.  The reference cannot differentiate its TPU
kernel and trains the mLSTM by autodiff through the sequential oracle
``ref.mlstm_scan``; K6-bwd (``csrc/mlstm_scan_bwd.cu``) computes those
gradients chunk by chunk.  The plain versions are
:func:`repro_torch.kernels.ref.mlstm_scan_chunked` and
:func:`repro_torch.kernels.ref.mlstm_scan_bwd`.

Each function chooses by the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises).  The
kernels read the reference layout as it is — q/k ``(B, H, S, D)``, v
``(B, H, S, DV)``, gates ``(B, H, S)`` — take any S (the ragged edge is
masked in the kernel) and D, DV that are multiples of 8 up to 384.  The
gates go to the kernels as float32 and their gradients come back in the
gates' dtype.

:class:`MLSTMScan` joins the pair for training: the forward also writes
each row's stabiliser ``m`` and normaliser ``qn`` and saves them with its
inputs and output; the backward recomputes the chunk states from them.
On CPU tensors the same Function runs the plain pair.  Both kernels are
deterministic: no atomics, every sum in a fixed order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

plain = ref.mlstm_scan_chunked
plain_bwd = ref.mlstm_scan_bwd

# kernel launches since the last reset: K6 (forward) and K6-bwd
launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
CHUNK, TILE, MAX_DIM = ref.MLSTM_CHUNK, 64, 384


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of K6 (and of K6-bwd's dv walk) at head dim
    D: the (D, 64) slice of C, n, the chunk's q and k rows padded to
    D + 4, the v tile, the chunk's scores and gate arrays (``vtile_floats``
    in ``csrc/mlstm_common.cuh``)."""
    L, D = CHUNK, head_dim
    return 4 * (D * TILE + D + 2 * L * (D + 4) + L * TILE + L * (L + 1)
                + 6 * L + 4)


def bwd_smem_bytes(head_dim: int, value_dim: int) -> int:
    """Dynamic shared memory of K6-bwd's larger walk: the dv walk's
    :func:`smem_bytes`, or the dq/dk walks' (64, DV + 4) rows of C, the
    chunk's v and dO rows, two 64-wide row tiles and the pair matrix
    (``dtile_floats``)."""
    L, DV = CHUNK, value_dim
    dtile = 4 * (TILE * (DV + 4) + TILE + 2 * L * (DV + 4)
                 + 2 * L * (TILE + 4) + L * (L + 1) + 6 * L + 4)
    return max(smem_bytes(head_dim), dtile)


def _check(name: str, tensors, q: torch.Tensor, v: torch.Tensor,
           i_pre: torch.Tensor, f_pre: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    for n, x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors; {n} is on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32 or "
                         f"bfloat16)")
    for n, x in tensors:
        if x.dim() == 4 and x.dtype != q.dtype:
            raise ValueError(f"{n} is {x.dtype}, q is {q.dtype}")
    for n, x in (("i_pre", i_pre), ("f_pre", f_pre)):
        if not x.is_floating_point():
            raise ValueError(f"{n} must be a floating dtype, got {x.dtype}")
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q and v must be 4-D, got {tuple(q.shape)} and "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    DV = v.shape[-1]
    if v.shape[:3] != (B, H, S):
        raise ValueError(f"v must be ({B}, {H}, {S}, DV), got "
                         f"{tuple(v.shape)}")
    for n, x in tensors:
        want = {4: (B, H, S, DV if n in ("v", "h", "dh") else D),
                3: (B, H, S)}.get(x.dim())
        if want is None or tuple(x.shape) != want:
            raise ValueError(f"{n} must be {want}, got {tuple(x.shape)}")
    for n, d in (("head_dim", D), ("value dim", DV)):
        if d % 8 or not 8 <= d <= MAX_DIM:
            raise ValueError(f"{n} {d} must be a multiple of 8 in "
                             f"[8, {MAX_DIM}]")
    if bwd_smem_bytes(D, DV) > SMEM_LIMIT:
        raise ValueError(f"D={D}, DV={DV} need {bwd_smem_bytes(D, DV)} bytes "
                         f"of shared memory, over the {SMEM_LIMIT} a block "
                         f"may use")
    if B == 0 or H == 0 or S == 0:
        raise ValueError("empty mLSTM scan")


def mlstm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                    with_stats: bool = False):
    """Launch K6 on the current stream.  Returns h ``(B, H, S, DV)`` in
    q's dtype, or ``(h, m, qn)`` with ``with_stats`` (each row's
    stabiliser and normaliser, ``(B, H, S)`` float32)."""
    global launches
    _check("mlstm_scan_cuda", (("q", q), ("k", k), ("v", v), ("i_pre", i_pre),
                               ("f_pre", f_pre)), q, v, i_pre, f_pre)
    B, H, S, D = q.shape
    DV = v.shape[-1]
    ip, fp = i_pre.float(), f_pre.float()
    h = torch.empty_like(v)
    m = qn = None
    if with_stats:
        m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        qn = torch.empty_like(m)
    err = build.library().repro_mlstm_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ip.data_ptr(),
        fp.data_ptr(), h.data_ptr(), None if m is None else m.data_ptr(),
        None if qn is None else qn.data_ptr(), B, H, S, D, DV, D ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "repro_mlstm_scan")
    launches += 1
    return (h, m, qn) if with_stats else h


def mlstm_scan_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor,
                        h: torch.Tensor, m: torch.Tensor, qn: torch.Tensor,
                        dh: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch K6-bwd on the current stream: ``(dq, dk, dv, d i_pre,
    d f_pre)`` from K6's inputs, output and stats and the incoming
    ``dh``, each in its input's dtype."""
    global bwd_launches
    _check("mlstm_scan_bwd_cuda",
           (("q", q), ("k", k), ("v", v), ("i_pre", i_pre), ("f_pre", f_pre),
            ("h", h), ("m", m), ("qn", qn), ("dh", dh)), q, v, i_pre, f_pre)
    if m.dtype != torch.float32 or qn.dtype != torch.float32:
        raise ValueError(f"m and qn must be float32, got {m.dtype} and "
                         f"{qn.dtype}")
    B, H, S, D = q.shape
    DV = v.shape[-1]
    ip, fp = i_pre.float(), f_pre.float()
    dev = q.device
    ntd = -(-D // TILE)
    rden, dqn = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
                 for _ in range(2))
    qdq, kdk = (torch.empty((B, H, S, ntd), dtype=torch.float32, device=dev)
                for _ in range(2))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di, df = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
              for _ in range(2))
    err = build.library().repro_mlstm_scan_bwd(
        *(x.data_ptr() for x in (q, k, v, ip, fp, h, m, qn, dh, rden, dqn,
                                 qdq, kdk, dq, dk, dv, di, df)),
        B, H, S, D, DV, D ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "repro_mlstm_scan_bwd")
    bwd_launches += 1
    return dq, dk, dv, di.to(i_pre.dtype), df.to(f_pre.dtype)


def mlstm_scan_fwd(q, k, v, i_pre, f_pre):
    """``(h, m, qn)``: the plain version on a CPU tensor, K6 on a CUDA
    tensor."""
    if q.device.type == "cpu":
        return plain(q, k, v, i_pre, f_pre, with_stats=True)
    return mlstm_scan_cuda(q, k, v, i_pre, f_pre, with_stats=True)


def mlstm_scan_bwd(q, k, v, i_pre, f_pre, h, m, qn, dh):
    """``(dq, dk, dv, d i_pre, d f_pre)``: the plain version on a CPU
    tensor, K6-bwd on a CUDA tensor."""
    if q.device.type == "cpu":
        return plain_bwd(q, k, v, i_pre, f_pre, h, m, qn, dh)
    return mlstm_scan_bwd_cuda(q, k, v, i_pre, f_pre, h, m, qn, dh)


class MLSTMScan(torch.autograd.Function):
    """Differentiable mLSTM: K6 forward with its stats, K6-bwd backward
    (the plain pair on CPU tensors).  Saves the inputs, ``h``, ``m`` and
    ``qn``."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre):
        q, k, v, i_pre, f_pre = (x.contiguous() for x in (q, k, v, i_pre,
                                                         f_pre))
        h, m, qn = mlstm_scan_fwd(q, k, v, i_pre, f_pre)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, h, m, qn)
        return h

    @staticmethod
    def backward(ctx, dh):
        return mlstm_scan_bwd(*ctx.saved_tensors, dh.contiguous())


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """h ``(B, H, S, DV)`` of the chunkwise mLSTM, differentiable when
    autograd records and an input requires grad."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v, i_pre, f_pre)):
        return MLSTMScan.apply(q, k, v, i_pre, f_pre)
    if q.device.type == "cpu":
        return plain(q, k, v, i_pre, f_pre)
    return mlstm_scan_cuda(*(x.contiguous() for x in (q, k, v, i_pre,
                                                      f_pre)))
