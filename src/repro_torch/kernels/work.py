"""The work of each hand-written kernel, and the hook through which a
counter sees every kernel call.

A counter (:class:`repro_torch.launch.op_stats.OpCounter`) counts the
aten ops of a step as eager mode runs them.  A kernel is no aten op: its
wrapper calls :func:`record` once a call with the call's shapes and
flags, and the counter takes the call's FLOPs and bytes from the
kernel's formula here (:data:`FORMULAS`), not from the ops of its plain
version.  While a counter is active, a call on a tensor that is not a
real CUDA tensor (a fake tensor of the dry-run, or a CPU tensor) is
*dry* (:func:`dry`): the wrapper allocates the outputs and the
temporaries the CUDA path allocates, and returns them without launching
and without running the plain version.  A call on a CUDA tensor counts
and launches as before; with no counter active nothing changes.

Each formula takes the JSON-able parameters its wrapper records and
returns ``{"flops", "bytes", "transcendentals"}``:

  * FLOPs are what the kernel computes.  Attention counts the
    (query, key) pairs that its mask leaves (a causal or windowed tile
    that the kernel skips is not counted, nor the masked part of a
    diagonal tile), 2·D FLOPs a pair for each product of a pair;
  * bytes are what it reads and writes: each input once, each output
    once, and each float32 temporary it writes and reads back twice;
  * transcendentals are its exponentials.

The paged kernels (K2, K3) walk each slot's lengths, which live on the
card.  On a real tensor the counter reads them (a counting run is not a
timed run); on a fake tensor, which has no values, every slot counts as
full, ``max_pages · page`` positions: a bound.  K4 counts the rows of
its host group sizes, or all ``M`` rows when the sizes are a tensor (the
capacity buffer of the MoE layer fills every row).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

_counters: List[Any] = []


def counting() -> Optional[Any]:
    """The innermost active counter, or None."""
    return _counters[-1] if _counters else None


def push(counter) -> None:
    _counters.append(counter)


def pop(counter) -> None:
    if not _counters or _counters[-1] is not counter:
        raise RuntimeError("counters must exit in the reverse order of "
                           "their entry")
    _counters.pop()


def is_fake(x: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor) or x.device.type == "meta"


def dry(x: torch.Tensor) -> bool:
    """True when a kernel call on ``x`` only counts and allocates: a
    counter is active and ``x`` is not a real CUDA tensor."""
    return bool(_counters) and (x.device.type != "cuda" or is_fake(x))


def takes_plain(x: torch.Tensor) -> bool:
    """True when a wrapper takes its kernel's plain version: ``x`` is on
    the CPU and no counter is active."""
    return x.device.type == "cpu" and not _counters


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def record(kernel: str, **params) -> None:
    """Count one call of ``kernel`` (a key of :data:`FORMULAS`) on the
    active counter, if any."""
    if _counters:
        _counters[-1].kernel(kernel, params)


def lengths(x: torch.Tensor) -> Optional[List[int]]:
    """The values of a small integer tensor of a real call (the paged
    kernels' lengths), or None for a fake one."""
    if is_fake(x):
        return None
    return [int(v) for v in x.tolist()]


def _size(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def attention_pairs(S: int, T: int, causal: bool, window: int,
                    q_offset: int) -> int:
    """The (query, key) pairs the mask of K1/K1-bwd leaves: query row
    ``i`` at position ``q_offset + i`` sees the keys ``j < T`` with
    ``j <= p`` when causal and ``p - j < window`` when windowed."""
    p = np.arange(S, dtype=np.int64) + q_offset
    hi = np.minimum(p + 1, T) if causal else np.full(S, T, dtype=np.int64)
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros(
        S, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_fwd(B, S, T, H, KH, D, dtype, causal, window, q_offset,
              with_lse) -> Dict[str, float]:
    """K1: QKᵀ and PV over the unmasked pairs of each (batch, head)."""
    pairs = B * H * attention_pairs(S, T, causal, window, q_offset)
    e = _size(dtype)
    io = e * (2 * B * S * H * D + 2 * B * T * KH * D)
    return {"flops": 4.0 * D * pairs,
            "bytes": float(io + (4 * B * S * H if with_lse else 0)),
            "transcendentals": float(pairs)}


def flash_bwd(B, S, T, H, KH, D, dtype, causal, window, q_offset
              ) -> Dict[str, float]:
    """K1-bwd: QKᵀ recomputed, dP = dO Vᵀ, dV = Pᵀ dO, dQ = dS K and
    dK = dSᵀ Q over the unmasked pairs; reads q, k, v, out, dO and lse,
    writes dq, dk, dv, and writes and reads its float32 ``delta``."""
    pairs = B * H * attention_pairs(S, T, causal, window, q_offset)
    e = _size(dtype)
    io = e * (5 * B * S * H * D + 4 * B * T * KH * D)
    return {"flops": 10.0 * D * pairs,
            "bytes": float(io + 4 * B * S * H + 2 * 4 * B * S * H),
            "transcendentals": float(pairs)}


def paged(B, T, H, KH, D, dtype, page, max_pages, base) -> Dict[str, float]:
    """K2 (``T`` 1) and K3: each query row ``t`` of slot ``b`` against the
    ``base[b] + t`` positions it sees (``max_pages · page`` a slot when
    ``base`` is None), QKᵀ and PV; reads q, the visible K/V rows and the
    page table, writes out."""
    cap = max_pages * page
    rows = []
    for b in range(B):
        for t in range(T):
            rows.append(cap if base is None else max(0, min(base[b] + t,
                                                            cap)))
    seen = sum(rows)  # (row, position) pairs of one query head
    kv_rows = (B * cap if base is None
               else sum(max(0, min(base[b] + T - 1, cap)) for b in range(B)))
    e = _size(dtype)
    return {"flops": 4.0 * D * H * seen,
            "bytes": float(e * (2 * B * T * H * D + 2 * kv_rows * KH * D)
                           + 4 * (B * max_pages + B)),
            "transcendentals": float(H * seen)}


def gmm(M, K, N, E, rows, dtype) -> Dict[str, float]:
    """K4: ``rows`` rows (``M`` past ``sum(sizes)`` are written as zeros)
    times their expert's (K, N) weights; reads those rows and the
    weights, writes all M rows."""
    e = _size(dtype)
    return {"flops": 2.0 * rows * K * N,
            "bytes": float(e * (rows * K + E * K * N + M * N) + 4 * E),
            "transcendentals": 0.0}


# FLOPs of the selective scan for each (batch, step, channel, state)
# element: forward exp(dt·A) times h, plus (dt·x)·B, and C·h into y (6);
# backward the state recomputed from the checkpoint (4), the adjoint
# dy·C + a·g (3), and the dA, dB, dC, d(dt) and dx terms (14)
SSM_FWD_PER_STATE, SSM_BWD_PER_STATE = 6, 21


def ssm_fwd(B, S, Din, N, dtype, chunk, with_ckpt, with_state
            ) -> Dict[str, float]:
    """K5: the scan over ``(B, S, Din, N)``; reads x, dt (x's dtype), A,
    B, C, D (float32), writes y and the checkpoints or the final state."""
    e = _size(dtype)
    el = B * S * Din * N
    io = e * 3 * B * S * Din + 4 * (Din * N + 2 * B * S * N + Din)
    if with_ckpt:
        io += 4 * (-(-S // chunk)) * B * Din * N
    if with_state:
        io += 4 * B * Din * N
    return {"flops": float(SSM_FWD_PER_STATE * el + 3 * B * S * Din),
            "bytes": float(io), "transcendentals": float(el)}


def ssm_bwd(B, S, Din, N, dtype, chunk, channels) -> Dict[str, float]:
    """K5-bwd: reads the inputs, the checkpoints and dy, writes dx, ddt,
    dA, dB, dC, dD, and writes and reads its float32 partials."""
    e = _size(dtype)
    el = B * S * Din * N
    blocks = -(-Din // channels)
    ins = e * 3 * B * S * Din + 4 * (Din * N + 2 * B * S * N + Din)
    ckpt = 4 * (-(-S // chunk)) * B * Din * N
    outs = e * 2 * B * S * Din + 4 * (Din * N + 2 * B * S * N + Din)
    part = 4 * (2 * blocks * B * N * S + B * Din * N + B * Din)
    return {"flops": float(SSM_BWD_PER_STATE * el + 6 * B * S * Din),
            "bytes": float(ins + ckpt + outs + 2 * part),
            "transcendentals": float(el)}


def mlstm_fwd(B, H, S, D, DV, dtype, chunk, with_stats, with_state
              ) -> Dict[str, float]:
    """K6, chunkwise over chunks of ``chunk`` rows: each row reads the
    carried state (q·C, q·n: 2·D·DV + 2·D) and adds to it (kᵀv, k:
    2·D·DV + D), and meets the rows of its chunk up to itself (qkᵀ and
    its product with v: 2·(D + DV) a pair, (chunk + 1)/2 pairs a row on
    average)."""
    rows = B * H * S
    pairs = B * H * _causal_chunk_pairs(S, chunk)
    e = _size(dtype)
    io = e * (2 * rows * D + 2 * rows * DV) + 4 * 2 * rows
    if with_stats:
        io += 4 * 2 * rows
    if with_state:
        io += 4 * B * H * (D * DV + D + 1)
    return {"flops": float(rows * (4 * D * DV + 3 * D)
                           + 2 * (D + DV) * pairs),
            "bytes": float(io), "transcendentals": float(pairs + 2 * rows)}


def mlstm_bwd(B, H, S, D, DV, dtype, chunk, tile) -> Dict[str, float]:
    """K6-bwd: per row the four state products (dh·Cᵀ, kᵀ·dC, v·dCᵀ and
    the carried dC update, 8·D·DV) and per pair the recomputed qkᵀ, dP,
    dV, dQ and dK (6·D + 4·DV); reads the inputs, h, m, qn and dh, writes
    dq, dk, dv and the gates' gradients, and writes and reads its float32
    row terms."""
    rows = B * H * S
    pairs = B * H * _causal_chunk_pairs(S, chunk)
    e = _size(dtype)
    ntd = -(-D // tile)
    ins = e * (2 * rows * D + 3 * rows * DV) + 4 * 4 * rows
    outs = e * (2 * rows * D + rows * DV) + 4 * 2 * rows
    temps = 4 * (2 * rows + 2 * rows * ntd)
    return {"flops": float(rows * (8 * D * DV + 8 * D)
                           + (6 * D + 4 * DV) * pairs),
            "bytes": float(ins + outs + 2 * temps),
            "transcendentals": float(pairs + 2 * rows)}


def _causal_chunk_pairs(S: int, chunk: int) -> int:
    """Pairs (i, j <= i) inside each chunk of ``chunk`` rows of ``S``."""
    full, rest = divmod(S, chunk)
    return full * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2


FORMULAS: Dict[str, Callable[..., Dict[str, float]]] = {
    "K1": flash_fwd, "K1-bwd": flash_bwd, "K2": paged, "K3": paged,
    "K4": gmm, "K5": ssm_fwd, "K5-bwd": ssm_bwd, "K6": mlstm_fwd,
    "K6-bwd": mlstm_bwd,
}


def work(kernel: str, params: Dict[str, Any]) -> Dict[str, float]:
    """``{"flops", "bytes", "transcendentals"}`` of one call."""
    return FORMULAS[kernel](**params)
