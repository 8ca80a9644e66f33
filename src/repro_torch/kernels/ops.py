"""Public kernel entry points of the port, in the reference layout.

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
    and verify reads are never a Pallas kernel;
  * :func:`mlstm_scan` — the xLSTM matrix memory of the train path (K6,
    and K6-bwd under autograd), q/k ``(B, H, S, D)``, v ``(B, H, S, DV)``,
    gates ``(B, H, S)``; :func:`mlstm_step` — one recurrent step, the
    sequential oracle, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import mlstm_scan as _mlstm
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention as paged_decode_attention)
from repro_torch.kernels.paged_attention_mq import (
    paged_attention_mq as paged_decode_attention_mq)

__all__ = ["decode_attention", "decode_attention_mq", "flash_attention",
           "mlstm_scan", "mlstm_step", "paged_decode_attention",
           "paged_decode_attention_mq"]


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


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, *,
               chunk: int = 256) -> torch.Tensor:
    """The mLSTM of the train path (K6, and K6-bwd when autograd records):
    q/k ``(B, H, S, D)``, v ``(B, H, S, DV)``, gate pre-activations
    ``(B, H, S)`` -> h ``(B, H, S, DV)``.  ``chunk`` keeps the reference's
    signature, where it is the TPU kernel's block length; the port's
    kernels and their plain versions run 32-row chunks whatever it is (the
    chunkwise form is exact for any chunk length, up to rounding)."""
    del chunk
    return _mlstm.mlstm_scan(q, k, v, i_pre, f_pre)


def mlstm_step(q, k, v, i_pre, f_pre, state):
    """One recurrent step (the reference's decode path): the sequential
    oracle from ``state = (C, n, m)``, q/k/v ``(B, H, D)`` or
    ``(B, H, 1, D)``, gates ``(B, H)`` or ``(B, H, 1)``.  Returns
    ``(h (B, H, DV), new state)``."""
    h, state = ref.mlstm_scan(
        q[:, :, None, :] if q.dim() == 3 else q,
        k[:, :, None, :] if k.dim() == 3 else k,
        v[:, :, None, :] if v.dim() == 3 else v,
        i_pre[..., None] if i_pre.dim() == 2 else i_pre,
        f_pre[..., None] if f_pre.dim() == 2 else f_pre,
        initial=state,
    )
    return h[:, :, 0, :], state
