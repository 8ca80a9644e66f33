"""Public attention entry points of the port, in the reference layout.

The counterpart of the reference package's ``kernels/ops.py``.  There is
no backend switch: each function dispatches on its tensors' device
through the kernel wrappers — a CPU tensor takes the plain PyTorch
version, a CUDA tensor always launches the hand-written kernel, at every
size (the reference's size thresholds for its XLA fallbacks do not
apply).  The kernels read the reference's layouts as they are, take
``D`` unpadded and mask the ragged ``S``/``T`` edge themselves, so no
transposing or padding happens here.

  * :func:`flash_attention` — prefill (K1), q ``(B, S, H, D)``, k/v
    ``(B, T, KH, D)``;
  * :func:`paged_decode_attention` — one decode token through the page
    table (K2), q ``(B, 1, H, D)``, pools ``(KH, P, page, D)``;
  * :func:`decode_attention` — one decode token against a dense cache:
    the plain version on every device, as in the reference, where the
    dense decode read is the oracle on every backend.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention as paged_decode_attention)

__all__ = ["decode_attention", "flash_attention", "paged_decode_attention"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a dense cache: q ``(B, 1, H, D)``,
    k/v ``(B, T, KH, D)``, valid lengths ``(B,)``."""
    return ref.attention(q, k, v, causal=False, window=0, kv_len=kv_len)
