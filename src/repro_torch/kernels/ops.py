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
    token, or the ``T`` verify rows, against a dense cache, and
    :func:`masked_decode_attention`, one token against a window layer's
    ring buffer: the plain version on every device, as in the reference,
    where the dense decode and verify reads are never a Pallas kernel;
    :func:`decode_attention_partial` and :func:`merge_partials`, one
    token against each block of a sequence-split cache and the blocks'
    partials joined (the arithmetic GSPMD makes of the reference's
    dense decode read on a cache split over ``model``), plain too;
  * :func:`mlstm_scan` — the xLSTM matrix memory of the train path (K6,
    and K6-bwd under autograd), q/k ``(B, H, S, D)``, v ``(B, H, S, DV)``,
    gates ``(B, H, S)``; :func:`mlstm_scan_with_state` — the prefill's,
    K6 with its final ``(C, n, m)`` (the reference runs its sequential
    oracle there); :func:`mlstm_step` — one recurrent step of decode, the
    sequential oracle, as in the reference;
  * :func:`ssm_scan` — the selective scan of the hybrid's train path (K5,
    and K5-bwd under autograd), x/dt ``(B, S, Din)``, A ``(Din, N)``,
    B/C ``(B, S, N)``, D ``(Din,)``; :func:`ssm_scan_with_state` — the
    prefill's, K5 with its final state (the reference's oracle there);
    :func:`ssm_step` — one recurrent step of decode, the sequential
    oracle, as in the reference;
  * :func:`moe_gmm` — the grouped matmul over expert-sorted rows of the
    MoE layer's expert FFN (K4, with K4 on the transposed weights for dX
    under autograd), tokens ``(M, K)``, group sizes ``(E,)``, w
    ``(E, K, N)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import mlstm_scan as _mlstm
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import (
    paged_attention as paged_decode_attention)
from repro_torch.kernels.paged_attention_mq import (
    paged_attention_mq as paged_decode_attention_mq)

__all__ = ["decode_attention", "decode_attention_mq",
           "decode_attention_partial", "flash_attention",
           "masked_decode_attention", "merge_partials",
           "mlstm_scan", "mlstm_scan_with_state", "mlstm_step", "moe_gmm",
           "paged_decode_attention", "paged_decode_attention_mq", "ssm_scan",
           "ssm_scan_with_state", "ssm_step"]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a dense cache: q ``(B, 1, H, D)``,
    k/v ``(B, T, KH, D)``, valid lengths ``(B,)``."""
    return ref.attention(q, k, v, causal=False, window=0, kv_len=kv_len)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, valid: torch.Tensor):
    """One decode token against one block of a sequence-split cache: the
    block's float32 ``(out (B, H, D), lse (B, H))`` over the positions
    ``valid`` ``(B, T)`` marks, q ``(B, 1, H, D)``, k/v ``(B, T, KH, D)``;
    :func:`merge_partials` joins the blocks.  The plain version on every
    device, as the dense decode read is."""
    return ref.decode_attention_partial(q, k, v, valid)


def merge_partials(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Blocks' partial attentions ``(n, ..., D)`` with their ``(n, ...)``
    log-sum-exps merged into the attention over their union (float32)."""
    return ref.merge_partials(out, lse)


def masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid: torch.Tensor
                            ) -> torch.Tensor:
    """Single-token attention against the slots of a ring-buffer cache
    that ``valid`` ``(B, T)`` marks: q ``(B, 1, H, D)``, k/v ``(B, T, KH,
    D)``."""
    return ref.masked_decode_attention(q, k, v, valid)


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


def mlstm_scan_with_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          i_pre: torch.Tensor, f_pre: torch.Tensor):
    """The prefill's mLSTM: ``(h (B, H, S, DV), (C, n, m))``, the final
    state in float32 — K6 with its state output on the card, its plain
    version on the CPU.  The reference's prefill gets the same state from
    its sequential oracle (``kref.mlstm_scan``)."""
    return _mlstm.mlstm_scan_with_state(q, k, v, i_pre, f_pre)


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


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
             block_d: int = 256, chunk: int = 128) -> torch.Tensor:
    """The selective scan of the train path (K5, and K5-bwd when autograd
    records): x, dt ``(B, S, Din)``, A ``(Din, N)``, B, C ``(B, S, N)``,
    D ``(Din,)`` -> y ``(B, S, Din)`` in x's dtype.  ``block_d`` and
    ``chunk`` keep the reference's signature, where they are the TPU
    kernel's channel block and sequence block; the port's kernels take 16
    channels a block, and they and their plain versions checkpoint the
    state every 32 steps, whatever those are (the scan is exact for any
    blocking, up to rounding)."""
    del block_d, chunk
    return _ssm.ssm_scan(x, dt, A, Bmat, Cmat, D)


def ssm_scan_with_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        D: torch.Tensor):
    """The prefill's selective scan: ``(y (B, S, Din), final float32
    state (B, Din, N))`` — K5 with its state output on the card, its
    plain version on the CPU.  The reference's prefill gets the same
    state from its oracle (or its chunked scan)."""
    return _ssm.ssm_scan_with_state(x, dt, A, Bmat, Cmat, D)


def ssm_step(x, dt, A, Bmat, Cmat, D, state):
    """One recurrent step (the decode path): the sequential oracle from
    ``state`` ``(B, Din, N)``, x/dt ``(B, Din)``, B/C ``(B, N)``.  Returns
    ``(y (B, Din), new float32 state)``."""
    y, state = ref.ssm_scan(x[:, None], dt[:, None], A, Bmat[:, None],
                            Cmat[:, None], D, initial=state)
    return y[:, 0], state


def moe_gmm(tokens: torch.Tensor, group_sizes, w: torch.Tensor, *,
            block_m: int = 256) -> torch.Tensor:
    """``out[i] = tokens[i] @ w[e(i)]`` over expert-sorted tokens
    ``(M, K)``, ``group_sizes`` ``(E,)`` (an integer tensor, or a sequence
    of ints known on the host), w ``(E, K, N)`` -> ``(M, N)``: K4, and
    its backward when autograd records.  ``block_m`` keeps the
    reference's signature, where it is the TPU kernel's row tile (and the
    multiple the reference pads M to); the port's kernel tiles each group
    by itself and takes any M, whatever it is."""
    del block_m
    return _gmm.moe_gmm_op(tokens, group_sizes, w)
