"""Gradient compression: int8 quantization with error feedback.

Counterpart of the reference package's ``train/compression.py``, op for
op (bit for bit on the same float32 input).  At a few hundred chips the
slow link is the one between pods; compressing the gradient all-reduce
over the ``pod`` axis by 4x (float32 -> int8 blockwise) cuts it.  The
residual (quantization error) is fed back into the next step's gradient
(error feedback), which keeps SGD's convergence guarantees (Karimireddy
et al., 2019).

Blocks run along the **last** axis only, 256 elements a block (the whole
axis when it is shorter), so a leaf split on a leading dim compresses
block for block as the global leaf does.  :func:`compress_` is the train
step's form: it writes the compressed gradient and the new error into
the given tensors, walking the leaf in blocks of rows so its float32
temporaries stay small beside the leaf.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import Tree, flatten, unflatten

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization along the last axis:
    ``(q int8 (..., blocks, block), scale float32 (..., blocks, 1))``."""
    xf = x.float()
    if xf.dim() == 0:
        xf = xf[None]
    last = xf.shape[-1]
    block = BLOCK if last >= BLOCK else last
    pad = (-last) % block
    if pad:
        xf = F.pad(xf, (0, pad))
    nb = (last + pad) // block
    blocks = xf.reshape(tuple(xf.shape[:-1]) + (nb, block))
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    full = q.float() * scale
    full = full.reshape(tuple(full.shape[:-2]) + (-1,))
    shape = tuple(shape)
    if shape == ():
        return (full.reshape(()) if full.numel() == 1
                else full[..., 0]).to(dtype)
    last = shape[-1]
    if full.shape[-1] != last:
        full = full[..., :last]
    return full.reshape(shape).to(dtype)


def compress_residual(x: torch.Tensor
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                 torch.Tensor]:
    """Quantize and return ``((q, scale), residual)`` for error
    feedback."""
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s, x.shape, torch.float32)
    return (q, s), x.float() - back


def compressed_psum(x: torch.Tensor, mesh, axis: str, error: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce over the mesh axis ``axis``:
    ``(the sum over the axis's ranks of each one's dequantized value,
    this rank's new error)``."""
    from repro_torch.parallel import collectives

    corrected = x.float() + error
    (q, s), new_err = compress_residual(corrected)
    deq = dequantize_int8(q, s, x.shape, torch.float32)
    return collectives.all_reduce(deq, mesh, axis), new_err


def reduce_stacked(grads_stacked: Tree, err: Tree) -> Tuple[Tree, Tree]:
    """Reference semantics for tests: per-worker gradients stacked on axis
    0 are compressed (with error feedback) then summed — numerically what
    :func:`compressed_psum` computes across a mesh axis."""

    def one(g, e):
        corrected = g.float() + e
        qs = [compress_residual(corrected[i]) for i in range(g.shape[0])]
        deq = torch.stack([dequantize_int8(q, s, g.shape[1:], torch.float32)
                           for (q, s), _ in qs])
        return deq.sum(dim=0), torch.stack([r for _, r in qs])

    errs = dict(flatten(err))
    out = [(path, one(g, errs[path])) for path, g in flatten(grads_stacked)]
    return (unflatten((p, o[0]) for p, o in out),
            unflatten((p, o[1]) for p, o in out))


@torch.no_grad()
def compress_(g: torch.Tensor, err: torch.Tensor) -> None:
    """The train step's compression of one gradient leaf, in place: ``g``
    becomes the dequantized ``g + err`` (in ``g``'s dtype) and ``err``
    the new residual, as the reference's step computes them; the leaf is
    walked in blocks of rows (blocks run along the last axis, so this is
    the same bit for bit)."""
    from repro_torch.train.optimizer import _row_blocks

    blocks = [(g, err)] if g.dim() < 2 else _row_blocks(g, err)
    for gb, eb in blocks:
        (q, s), r = compress_residual(gb.float() + eb)
        gb.copy_(dequantize_int8(q, s, gb.shape, gb.dtype))
        eb.copy_(r)
