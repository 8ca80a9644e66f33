"""Mixture-of-Experts layer: top-k routing and sort-based capacity
dispatch, the expert FFN through K4.

Counterpart of the reference package's ``models/moe.py`` for its
``scatter`` implementation (``apply_moe_shardmap``, the expert-parallel
form, waits for parallelism: ROADMAP queue 1, parallelism and
elasticity).  The function is the reference's: one group per batch row,
the router in float32, softmax, top-k with the gates renormalised, the
Switch aux loss, a stable sort of each row's (token, k) entries by
expert, capacity ``moe_capacity``, overflow dropped, and the combine
weighing each kept expert output by its gate.

What differs is the layout and the arithmetic's order:

  * the dispatch writes the capacity buffer expert-major, ``(E, B, C, D)``
    viewed as ``(E·B·C, D)``: E groups of ``B·C`` rows, exactly K4's
    grouped matmul (``ops.moe_gmm``), so the three expert einsums of the
    reference are three K4 launches and no permute;
  * top-k is a stable descending sort (``jax.lax.top_k`` puts the lower
    index first on ties; ``torch.topk`` does not promise an order);
  * dispatch and combine are :class:`torch.autograd.Function` pairs whose
    forward and backward are gathers: each kept slot knows its source
    (token, k), each token its K slots, and a token's K contributions
    are summed in k order.  Nothing is scattered with atomics, so a step
    gives the same bits every time (resume is exact on the card).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import activation


def moe_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init)`` of the MoE parameters, each with a
    leading layer axis (the reference's ``init_moe``)."""
    L, D, E, F_ = num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    return {
        "router": ((L, D, E), "normal"),
        "moe_wg": ((L, E, D, F_), "normal"),
        "moe_wu": ((L, E, D, F_), "normal"),
        "moe_wd": ((L, E, F_, D), "normal"),
    }


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    cap = int(tokens_per_group * cfg.top_k * cfg.moe_capacity_factor
              / cfg.num_experts)
    return max(cap, cfg.top_k)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 2-D ``x``, where ``idx == len(x)`` gives a zero
    row."""
    pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return pad.index_select(0, idx)


class _Dispatch(torch.autograd.Function):
    """Tokens ``(N, D)`` -> capacity rows ``(E·B·C, D)``: slot ``i`` takes
    token ``slot_tok[i]`` (``N``: an empty slot, zeros).  The backward
    gathers each token's K slots (``tok_slot``, ``E·B·C`` where the entry
    was dropped) and sums them in k order."""

    @staticmethod
    def forward(ctx, x, slot_tok, tok_slot):
        ctx.save_for_backward(tok_slot)
        return _gather_rows(x, slot_tok)

    @staticmethod
    def backward(ctx, dbuf):
        tok_slot, = ctx.saved_tensors
        dbuf = dbuf.contiguous()
        dx = _gather_rows(dbuf, tok_slot[:, 0])
        for k in range(1, tok_slot.shape[1]):
            dx = dx + _gather_rows(dbuf, tok_slot[:, k])
        return dx, None, None


class _Combine(torch.autograd.Function):
    """Expert outputs ``(E·B·C, D)`` and float32 gates ``(N, K)`` ->
    tokens ``(N, D)``: ``sum_k gate[n, k] · ob[tok_slot[n, k]]`` in k
    order, in the outputs' dtype (a dropped entry's slot is the zero row).
    ``slot_entry[i]`` is slot i's flat (token, k) entry, ``N·K`` for an
    empty slot: the backward of the outputs is a gather through it."""

    @staticmethod
    def forward(ctx, ob, gates, tok_slot, slot_entry):
        dt = ob.dtype
        g = gates.to(dt)
        out = _gather_rows(ob, tok_slot[:, 0]) * g[:, :1]
        for k in range(1, gates.shape[1]):
            out = out + _gather_rows(ob, tok_slot[:, k]) * g[:, k:k + 1]
        ctx.save_for_backward(ob, gates, tok_slot, slot_entry)
        return out

    @staticmethod
    def backward(ctx, dout):
        ob, gates, tok_slot, slot_entry = ctx.saved_tensors
        dout = dout.contiguous()
        K = gates.shape[1]
        d_ob = d_gates = None
        if ctx.needs_input_grad[0]:
            g = torch.cat([gates.reshape(-1), gates.new_zeros(1)])
            d_ob = (_gather_rows(dout, slot_entry // K)
                    * g.index_select(0, slot_entry).to(dout.dtype)[:, None])
        if ctx.needs_input_grad[1]:
            d_gates = torch.stack(
                [(dout.float() * _gather_rows(ob, tok_slot[:, k]).float()
                  ).sum(-1) for k in range(K)], dim=-1).to(gates.dtype)
        return d_ob, d_gates, None, None


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest probabilities along the last axis, the
    lower index first on ties (``jax.lax.top_k``'s order)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


@torch.no_grad()
def dispatch_plan(expert_ids: torch.Tensor, num_experts: int,
                  capacity: int) -> Dict[str, torch.Tensor]:
    """Where each (token, k) entry of each group goes, as the reference's
    ``dispatch_group`` decides: the row's ``S·K`` entries, flattened
    token-major, are stably sorted by expert; an entry's position in its
    expert's run is its capacity slot, and positions ``>= C`` are
    dropped.  Returns flat indices into the ``(E, B, C)`` slots and the
    ``(B·S)`` tokens:

      * ``tok_slot`` ``(B·S, K)``: each entry's slot, ``E·B·C`` if dropped;
      * ``slot_tok`` ``(E·B·C,)``: each slot's token, ``B·S`` if empty;
      * ``slot_entry`` ``(E·B·C,)``: each slot's entry ``token·K + k``,
        ``B·S·K`` if empty.
    """
    B, S, K = expert_ids.shape
    E, C, M = num_experts, capacity, S * K
    dev = expert_ids.device
    flat_e = expert_ids.reshape(B, M)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # (B, M)
    rank = torch.argsort(order, dim=-1)  # each entry's sorted position
    counts = F.one_hot(flat_e, E).sum(1)  # (B, E)
    starts = counts.cumsum(-1) - counts
    pos = rank - starts.gather(1, flat_e)
    b = torch.arange(B, device=dev)[:, None]
    tok_slot = torch.where(pos < C, flat_e * (B * C) + b * C + pos,
                           E * B * C)
    c = torch.arange(C, device=dev)
    j = (starts[:, :, None] + c).clamp(max=M - 1)  # (B, E, C)
    entry = order.gather(1, j.reshape(B, E * C)).reshape(B, E, C)
    valid = c < counts[:, :, None]
    bb = b[:, :, None]
    slot_entry = torch.where(valid, bb * M + entry, B * M)
    slot_tok = torch.where(valid, bb * S + entry // K, B * S)
    return {"tok_slot": tok_slot.reshape(B * S, K),
            "slot_tok": slot_tok.permute(1, 0, 2).reshape(-1),
            "slot_entry": slot_entry.permute(1, 0, 2).reshape(-1)}


def apply_moe(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, D)`` normed, one group per batch row -> ``(output
    (B, S, D) in x's dtype, float32 aux loss)``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    C = moe_capacity(cfg, S)
    dt = x.dtype

    logits = x.float() @ p["router"].float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    expert_ids = top_k(probs.detach(), K)  # (B, S, K)
    onehot = F.one_hot(expert_ids, E).to(probs.dtype)  # (B, S, K, E)
    # the chosen probabilities as masked sums (exact), whose gradient is a
    # product, not a scatter
    gate_vals = (probs[:, :, None, :] * onehot).sum(-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # ---- aux load-balance loss (Switch-style) --------------------------
    density = onehot[:, :, 0].mean(dim=(0, 1))
    density_prob = probs.mean(dim=(0, 1))
    aux = (density * density_prob).sum() * E * cfg.router_aux_weight

    plan = dispatch_plan(expert_ids, E, C)
    buf = _Dispatch.apply(x.reshape(B * S, D), plan["slot_tok"],
                          plan["tok_slot"])  # (E·B·C, D)
    sizes = [B * C] * E
    h_g = ops.moe_gmm(buf, sizes, p["moe_wg"].to(dt))
    h_u = ops.moe_gmm(buf, sizes, p["moe_wu"].to(dt))
    h = activation(h_g, cfg.act) * h_u
    out_buf = ops.moe_gmm(h, sizes, p["moe_wd"].to(dt))  # (E·B·C, D)
    out = _Combine.apply(out_buf, gate_vals.reshape(B * S, K),
                         plan["tok_slot"], plan["slot_entry"])
    return out.view(B, S, D), aux.float()
