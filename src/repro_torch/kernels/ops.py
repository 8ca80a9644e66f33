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
  * :func:`paged_decode_attention_mq` — speculative verify through the
    page table (K3), q ``(B, T, H, D)`` with ``T = k + 1`` draft
    positions, row ``t`` seeing the kv positions ``< base_len + t``;
  * :func:`decode_attention` and :func:`decode_attention_mq` — one decode
    token, or the ``T`` verify rows, against a dense cache: the plain
    version on every device, as in the reference, where the dense decode
    and verify reads are never a Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention as paged_decode_attention)
from repro_torch.kernels.paged_attention_mq import (
    paged_attention_mq as paged_decode_attention_mq)

__all__ = ["decode_attention", "decode_attention_mq", "flash_attention",
           "paged_decode_attention", "paged_decode_attention_mq"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a dense cache: q ``(B, 1, H, D)``,
    k/v ``(B, T, KH, D)``, valid lengths ``(B,)``."""
    return ref.attention(q, k, v, causal=False, window=0, kv_len=kv_len)


def decode_attention_mq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        base_len: torch.Tensor) -> torch.Tensor:
    """Verify attention against a dense cache: q ``(B, T, H, D)``, k/v
    ``(B, S_max, KH, D)``; row ``t`` sees the positions
    ``< base_len[b] + t``."""
    return ref.decode_attention_mq(q, k, v, base_len)
