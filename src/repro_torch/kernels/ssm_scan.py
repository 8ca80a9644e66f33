"""K5 and K5-bwd: the selective scan and its checkpointed-adjoint
backward, hand-written CUDA kernels for Hopper.

K5 replaces the TPU kernel ``ssm_scan_bsd`` of the reference package
(``src/repro/kernels/ssm_scan.py``); its CUDA source, with what bounds it
on the H100 and what its design does about it, is ``csrc/ssm_scan.cu``.
The reference has no backward kernel: it trains its scan by autodiff
through the oracle or through the checkpointed-adjoint custom VJP of
``kernels/ssm_vjp.py``; K5-bwd (``csrc/ssm_scan_bwd.cu``) is that VJP's
counterpart.  The plain versions are
:func:`repro_torch.kernels.ref.ssm_scan_fwd_ckpt` and
:func:`repro_torch.kernels.ref.ssm_scan_bwd`.

For serving, :func:`ssm_scan_with_state` asks K5 for the final float32
state ``(B, Din, N)`` beside y, which the hybrid's prefill hands to
decode; the reference runs its sequential oracle there, because its
Pallas kernel is stateless.  Its plain version is
:func:`repro_torch.kernels.ref.ssm_scan_chunked` at K5's chunk.

Each function chooses by the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (or raises).  The
kernels read the reference layout as it is — x, dt ``(B, S, Din)`` in
float32 or bfloat16 (the same dtype), A ``(Din, N)``, B and C ``(B, S,
N)``, D ``(Din,)`` — take any S and Din (the ragged edges are masked in
the kernels) and any state size N from 1 to 64 (hymba's is 16).  A, B, C
and D go to the kernels as float32 and their gradients come back in their
own dtypes; dx and ddt come back in x's dtype.

:class:`SSMScan` joins the pair for training: the forward also writes the
float32 state at each chunk start and saves it with its inputs; the
backward recomputes each chunk's states from it.  On CPU tensors the same
Function runs the plain pair.  Both kernels are deterministic: no
atomics, every sum in a fixed order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref, work

plain = ref.ssm_scan_fwd_ckpt
plain_bwd = ref.ssm_scan_bwd

# kernel launches since the last reset: K5 (forward; ``state_launches``
# of them with the final state) and K5-bwd
launches = 0
state_launches = 0
bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = ref.SSM_CHUNK  # steps between checkpoints (csrc/ssm_common.cuh)
MAX_STATE = 64         # the largest state size N the kernels take
CHANNELS = 16          # channels a block of K5-bwd covers (its partials)


def _check(name: str, x, dt, A, Bmat, Cmat, D, extra=()) -> None:
    """Raise on anything the kernels do not take (a dry call's tensors
    may lie off the card)."""
    tensors = (("x", x), ("dt", dt), ("A", A), ("B", Bmat), ("C", Cmat),
               ("D", D)) + tuple(extra)
    dry = work.dry(x)
    for n, t in tensors:
        if t.device.type != "cuda" and not dry:
            raise ValueError(f"{name} needs CUDA tensors; {n} is on "
                             f"{t.device}")
        if not t.is_floating_point():
            raise ValueError(f"{n} must be a floating dtype, got {t.dtype}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32 or "
                         f"bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, Din), got {tuple(x.shape)}")
    Bsz, S, Din = x.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    want = {"x": (Bsz, S, Din), "dt": (Bsz, S, Din), "A": (Din, N),
            "B": (Bsz, S, N), "C": (Bsz, S, N), "D": (Din,),
            "dy": (Bsz, S, Din), "ckpt": (-(-S // CHUNK), Bsz, Din, N)}
    for n, t in tensors:
        if tuple(t.shape) != want[n]:
            raise ValueError(f"{n} must be {want[n]}, got {tuple(t.shape)}")
    if dt.dtype != x.dtype:
        raise ValueError(f"dt is {dt.dtype}, x is {x.dtype}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size N={N} not supported (1 to "
                         f"{MAX_STATE})")
    if Bsz == 0 or S == 0 or Din == 0:
        raise ValueError("empty selective scan")


def _f32(*xs):
    return [t.float().contiguous() for t in xs]


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
                  with_ckpt: bool = False, with_state: bool = False):
    """Launch K5 on the current stream.  Returns y ``(B, S, Din)`` in x's
    dtype, or ``(y, ckpt)`` with ``with_ckpt`` (the float32 state at each
    chunk start, ``(ceil(S / CHUNK), B, Din, N)``), or ``(y, state)``
    with ``with_state`` (the final float32 state ``(B, Din, N)``).  A dry
    call under a counter (:func:`work.dry`) counts and returns the outputs
    unlaunched."""
    global launches, state_launches
    if with_ckpt and with_state:
        raise ValueError("K5 writes the checkpoints or the final state, "
                         "not both")
    _check("ssm_scan_cuda", x, dt, A, Bmat, Cmat, D)
    Bsz, S, Din = x.shape
    N = A.shape[-1]
    x, dt = x.contiguous(), dt.contiguous()
    Af, Bf, Cf, Df = _f32(A, Bmat, Cmat, D)
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    ckpt = (torch.empty((-(-S // CHUNK), Bsz, Din, N), **f32)
            if with_ckpt else None)
    fin = torch.empty((Bsz, Din, N), **f32) if with_state else None
    work.record("K5", B=Bsz, S=S, Din=Din, N=N,
                dtype=work.dtype_name(x.dtype), chunk=CHUNK,
                with_ckpt=bool(with_ckpt), with_state=bool(with_state))
    if work.dry(x):
        return (y, fin) if with_state else ((y, ckpt) if with_ckpt else y)
    err = build.library().repro_ssm_scan(
        x.data_ptr(), dt.data_ptr(), Af.data_ptr(), Bf.data_ptr(),
        Cf.data_ptr(), Df.data_ptr(), y.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(),
        None if fin is None else fin.data_ptr(), Bsz, S, Din, N,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "repro_ssm_scan")
    launches += 1
    if with_state:
        state_launches += 1
        return y, fin
    return (y, ckpt) if with_ckpt else y


def ssm_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor,
                      ckpt: torch.Tensor, dy: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Launch K5-bwd on the current stream: ``(dx, ddt, dA, dB, dC, dD)``
    from K5's inputs, its checkpoints and the incoming ``dy``; dx and ddt
    in x's dtype, the others in their inputs' dtypes."""
    global bwd_launches
    _check("ssm_scan_bwd_cuda", x, dt, A, Bmat, Cmat, D,
           (("ckpt", ckpt), ("dy", dy)))
    if ckpt.dtype != torch.float32:
        raise ValueError(f"ckpt must be float32, got {ckpt.dtype}")
    Bsz, S, Din = x.shape
    N = A.shape[-1]
    dev = x.device
    x, dt, ckpt = x.contiguous(), dt.contiguous(), ckpt.contiguous()
    dy = dy.to(x.dtype).contiguous()
    Af, Bf, Cf, Df = _f32(A, Bmat, Cmat, D)
    blocks = -(-Din // CHANNELS)
    f32 = dict(dtype=torch.float32, device=dev)
    part_bc = torch.empty((2, blocks, Bsz, N, S), **f32)
    part_dA = torch.empty((Bsz, Din, N), **f32)
    part_dD = torch.empty((Bsz, Din), **f32)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = (torch.empty((Bsz, S, N), **f32) for _ in range(2))
    dA = torch.empty((Din, N), **f32)
    dD = torch.empty((Din,), **f32)
    work.record("K5-bwd", B=Bsz, S=S, Din=Din, N=N,
                dtype=work.dtype_name(x.dtype), chunk=CHUNK,
                channels=CHANNELS)
    if work.dry(x):
        return (dx, ddt, dA.to(A.dtype), dB.to(Bmat.dtype),
                dC.to(Cmat.dtype), dD.to(D.dtype))
    err = build.library().repro_ssm_scan_bwd(
        *(t.data_ptr() for t in (x, dt, Af, Bf, Cf, Df, ckpt, dy, dx, ddt,
                                 part_bc, part_dA, part_dD, dB, dC, dA, dD)),
        Bsz, S, Din, N, _DTYPES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "repro_ssm_scan_bwd")
    bwd_launches += 1
    return (dx, ddt, dA.to(A.dtype), dB.to(Bmat.dtype), dC.to(Cmat.dtype),
            dD.to(D.dtype))


def ssm_scan_fwd(x, dt, A, Bmat, Cmat, D):
    """``(y, ckpt)``: the plain version on a CPU tensor, K5 on a CUDA
    tensor."""
    if work.takes_plain(x):
        return plain(x, dt, A, Bmat, Cmat, D)
    return ssm_scan_cuda(x, dt, A, Bmat, Cmat, D, with_ckpt=True)


def ssm_scan_bwd(x, dt, A, Bmat, Cmat, D, ckpt, dy):
    """``(dx, ddt, dA, dB, dC, dD)``: the plain version on a CPU tensor,
    K5-bwd on a CUDA tensor."""
    if work.takes_plain(x):
        return plain_bwd(x, dt, A, Bmat, Cmat, D, ckpt, dy)
    return ssm_scan_bwd_cuda(x, dt, A, Bmat, Cmat, D, ckpt, dy)


class SSMScan(torch.autograd.Function):
    """Differentiable selective scan: K5 forward with its checkpoints,
    K5-bwd backward (the plain pair on CPU tensors).  Saves the inputs and
    the checkpoints."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, D):
        y, ckpt = ssm_scan_fwd(x, dt, A, Bmat, Cmat, D)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, D, ckpt)
        return y

    @staticmethod
    def backward(ctx, dy):
        return ssm_scan_bwd(*ctx.saved_tensors, dy.contiguous())


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor,
             D: torch.Tensor) -> torch.Tensor:
    """y ``(B, S, Din)`` of the selective scan, differentiable when
    autograd records and an input requires grad."""
    xs = (x, dt, A, Bmat, Cmat, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        return SSMScan.apply(*xs)
    if work.takes_plain(x):
        return plain(*xs)[0]
    return ssm_scan_cuda(*xs)


def ssm_scan_with_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, S, Din), final float32 state (B, Din, N))`` of the
    selective scan, for the prefill (no autograd): the plain version on a
    CPU tensor, K5 with its state output on a CUDA tensor."""
    if work.takes_plain(x):
        return ref.ssm_scan_chunked(x, dt, A, Bmat, Cmat, D, chunk=CHUNK)
    return ssm_scan_cuda(x, dt, A, Bmat, Cmat, D, with_state=True)
