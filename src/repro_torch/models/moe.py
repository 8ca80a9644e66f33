"""Mixture-of-Experts layer: top-k routing and sort-based capacity
dispatch, the expert FFN through K4.

Counterpart of the reference package's ``models/moe.py``: its
``scatter`` implementation (:func:`apply_moe`) and its expert-parallel
``shard_map`` implementation (:func:`apply_moe_shardmap`), chosen by
:func:`set_moe_impl` as in the reference (the sharded train step sets it
from ``Plan.moe_impl`` for its forward and backward).  The scatter
function is the reference's: one group per batch row, the router in
float32, softmax, top-k with the gates renormalised, the Switch aux
loss, a stable sort of each row's (token, k) entries by expert, capacity
``moe_capacity``, overflow dropped, and the combine weighing each kept
expert output by its gate.

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

Served split over ``model`` (``serve/sharded.py``, where the reference's
serving layout puts ``experts`` on ``model``), each rank holds ``E/m``
experts and :func:`apply_moe_split` gives its partial output: the whole
routing and dispatch plan, then only its experts' slots (``_experts``),
the partials summed over ``model`` by the caller
(``lm._ffn_residual``).  :func:`expert_blocks` runs the same arithmetic
on one device.

On a mesh the aux loss is the Switch loss of the global batch, as GSPMD
computes the reference's scatter path: the top-1 densities are averaged
over the ranks that hold different tokens before their product with the
router's mean probabilities (ROADMAP §3: the reference's ``shard_map``
averages per-shard losses instead, which agrees with its scatter path
only on a mesh of one).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import activation
from repro_torch.parallel import collectives, tensor

# the leaves whose experts dim the expert-parallel layer and the split
# serving layer keep local (the reference's shard_map in_specs
# ``P("model", None, None)``; ``parallel/tensor.py``'s experts region);
# the router is gathered whole
EXPERT_LEAVES = tensor.REGIONS["experts"][0]

_moe_impl = "scatter"  # scatter | shard_map
_moe_mesh = None
_moe_dp_axes: Tuple[str, ...] = ("data",)
# when a list, each layer call appends (kept entries, all entries) as
# device tensors: the dropped share of a run
drop_stats: Optional[list] = None
# the experts computed in this many blocks, their partial outputs summed
# (:func:`expert_blocks`)
_expert_blocks = 1


def set_moe_impl(impl: str, mesh=None, dp_axes=("data",)) -> None:
    """Choose the MoE implementation (``scatter`` or ``shard_map``) and
    the mesh it runs on, as the reference's ``set_moe_impl``."""
    global _moe_impl, _moe_mesh, _moe_dp_axes
    assert impl in ("scatter", "shard_map"), impl
    _moe_impl = impl
    _moe_mesh = mesh
    _moe_dp_axes = tuple(dp_axes)


@contextlib.contextmanager
def moe_impl(impl: str, mesh=None, dp_axes=("data",)):
    """:func:`set_moe_impl` for a block of code (a train step's forward
    and backward), restored after."""
    saved = (_moe_impl, _moe_mesh, _moe_dp_axes)
    set_moe_impl(impl, mesh, dp_axes)
    try:
        yield
    finally:
        set_moe_impl(*saved)


@contextlib.contextmanager
def expert_blocks(n: int):
    """For a block of code, :func:`apply_moe` computes the experts as
    ``n`` blocks of ``E/n``, each block's partial output as
    :func:`apply_moe_split` gives it on rank r of n, summed in block
    order: the arithmetic of the experts held split over ``n`` ranks, on
    one device."""
    global _expert_blocks
    saved = _expert_blocks
    _expert_blocks = n
    try:
        yield
    finally:
        _expert_blocks = saved


def _dp(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _moe_dp_axes if a in mesh.shape)


def moe_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init, logical axes)`` of the MoE parameters,
    each with a leading layer axis (the reference's ``init_moe``)."""
    L, D, E, F_ = num_layers, cfg.d_model, cfg.num_experts, cfg.d_ff
    return {
        "router": ((L, D, E), "normal", ("layers", "embed", "experts")),
        "moe_wg": ((L, E, D, F_), "normal",
                   ("layers", "experts", "embed", "mlp")),
        "moe_wu": ((L, E, D, F_), "normal",
                   ("layers", "experts", "embed", "mlp")),
        "moe_wd": ((L, E, F_, D), "normal",
                   ("layers", "experts", "mlp", "embed")),
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


def _switch_aux(density, density_prob, cfg, mesh, axes):
    """The Switch aux loss of the tokens of every rank along ``axes``
    (each holding as many): the top-1 densities averaged over them (no
    gradient), the mean probabilities averaged with a gradient that is
    each rank's own share."""
    if not axes or mesh.size(axes) == 1:
        return (density * density_prob).sum() * cfg.num_experts \
            * cfg.router_aux_weight
    density = collectives.all_reduce(density.detach().clone(), mesh, axes
                                     ) / mesh.size(axes)
    local = (density * density_prob).sum() * cfg.num_experts \
        * cfg.router_aux_weight
    return collectives.mean(local, mesh, axes)


def _count_drops(tok_slot: torch.Tensor, dropped_slot: int) -> None:
    if drop_stats is not None:
        kept = (tok_slot != dropped_slot).sum()
        drop_stats.append((kept, tok_slot.numel()))


def _route(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig):
    """The router over every expert: x ``(B, S, D)`` -> (top-k expert ids
    ``(B, S, K)``, their renormalised float32 gates ``(B, S, K)``, the
    float32 Switch aux loss)."""
    E, K = cfg.num_experts, cfg.top_k
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
    if _moe_mesh is not None:  # the global batch's, over the data ranks
        aux = _switch_aux(density, density_prob, cfg, _moe_mesh,
                          _dp(_moe_mesh))
    else:
        aux = (density * density_prob).sum() * E * cfg.router_aux_weight
    return expert_ids, gate_vals, aux.float()


def _plan(p, x, cfg):
    """Routing and capacity dispatch of x ``(B, S, D)`` over every expert,
    the capacity from this call's sequence length: (gates, the
    :func:`dispatch_plan`, capacity, aux loss); the dropped entries
    counted once."""
    B, S, _ = x.shape
    E = cfg.num_experts
    C = moe_capacity(cfg, S)
    expert_ids, gates, aux = _route(p, x, cfg)
    plan = dispatch_plan(expert_ids, E, C)
    _count_drops(plan["tok_slot"], E * B * C)
    return gates, plan, C, aux


def _experts(p, x, gates, plan, C, cfg, first: int = 0) -> torch.Tensor:
    """The expert FFN of the slots of the ``n`` experts ``p["moe_w*"]``
    hold (experts ``first`` to ``first + n - 1``; all E by default) and
    the combine of their entries, every entry routed to another expert
    weighing zero: ``(B, S, D)`` in x's dtype.  Only those experts'
    ``n·B·C`` slots are dispatched, three K4 launches over ``n`` groups
    of ``B·C`` rows."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    n = p["moe_wg"].shape[0]
    dt = x.dtype
    tok_slot, slot_tok, slot_entry = (plan[k] for k in (
        "tok_slot", "slot_tok", "slot_entry"))
    if n < E:
        lo, hi = first * B * C, (first + n) * B * C
        tok_slot = torch.where((tok_slot >= lo) & (tok_slot < hi),
                               tok_slot - lo, hi - lo)
        slot_tok, slot_entry = slot_tok[lo:hi], slot_entry[lo:hi]
    buf = _Dispatch.apply(x.reshape(B * S, D), slot_tok,
                          tok_slot)  # (n·B·C, D)
    sizes = [B * C] * n
    h_g = ops.moe_gmm(buf, sizes, p["moe_wg"].to(dt))
    h_u = ops.moe_gmm(buf, sizes, p["moe_wu"].to(dt))
    h = activation(h_g, cfg.act) * h_u
    out_buf = ops.moe_gmm(h, sizes, p["moe_wd"].to(dt))  # (n·B·C, D)
    out = _Combine.apply(out_buf, gates.reshape(B * S, K), tok_slot,
                         slot_entry)
    return out.view(B, S, D)


def apply_moe(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, D)`` normed, one group per batch row -> ``(output
    (B, S, D) in x's dtype, float32 aux loss)``; under
    ``set_moe_impl("shard_map", mesh)``, :func:`apply_moe_shardmap`;
    under :func:`expert_blocks` ``(n)``, the sum of the ``n`` partials
    :func:`apply_moe_split` gives, in block order."""
    if _moe_impl == "shard_map":
        return apply_moe_shardmap(p, x, cfg)
    gates, plan, C, aux = _plan(p, x, cfg)
    n = _expert_blocks
    if n == 1:
        return _experts(p, x, gates, plan, C, cfg), aux
    e = cfg.num_experts // n
    out = None
    for r in range(n):
        pr = {k: p[k][r * e:(r + 1) * e] for k in EXPERT_LEAVES}
        part = _experts(pr, x, gates, plan, C, cfg, r * e)
        out = part if out is None else out + part
    return out, aux


def apply_moe_split(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, rank: int, ranks: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts held split over ``ranks`` ranks (the serving
    layout, ``serve/sharded.py``): ``p["moe_w*"]`` hold this rank's
    ``E/ranks`` experts (from ``rank·E/ranks`` on), ``p["router"]`` the
    whole router, and x ``(B, S, D)`` is the same on every rank.  Every
    rank routes all its tokens exactly as :func:`apply_moe` does (the
    same capacity and dispatch over all E experts, so the dropped
    entries are the unsplit layer's), then runs only its experts' slots
    and combines only their entries.  Returns ``(this rank's partial
    output, whose sum over the ranks is the layer's output; the float32
    aux loss of the whole routing, the same on every rank)``."""
    E = cfg.num_experts
    e = p["moe_wg"].shape[0]
    assert e * ranks == E, (e, ranks, E)
    gates, plan, C, aux = _plan(p, x, cfg)
    return _experts(p, x, gates, plan, C, cfg, rank * e), aux


# ===========================================================================
# shard_map MoE: explicit all-to-all dispatch (expert parallelism)
# ===========================================================================
def shardmap_capacity(cfg: ModelConfig, local_tokens: int) -> int:
    """The expert-parallel layer's capacity: from the rank's local token
    count, padded to 8 (the reference's ``apply_moe_shardmap``)."""
    C = max(int(local_tokens * cfg.top_k * cfg.moe_capacity_factor
                / cfg.num_experts), cfg.top_k)
    return ((C + 7) // 8) * 8


def apply_moe_shardmap(p: Dict[str, torch.Tensor], x: torch.Tensor,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE (the reference's ``apply_moe_shardmap``):
    each rank routes its local tokens — its batch rows over the data
    axes, its slice of the sequence over ``model`` — into one
    ``(E, C, D)`` buffer, exchanges expert shards with one all-to-all
    over ``model``, runs the expert FFN on its ``E/m`` local experts
    through K4 (three launches, as the scatter path), and reverses.

    ``x`` ``(B_loc, S, D)`` is the rank's batch rows, the whole sequence
    (every ``model`` rank holds the same); ``p["moe_w*"]`` hold the
    rank's local experts ``(E/m, ...)`` (the train step's gather keeps
    the experts dim local) and ``p["router"]`` the whole router.  The
    output is gathered back over the sequence, since the rest of the
    block is not split over ``model``.  Autodiff runs the all-to-all's
    backward as an all-to-all; the router's gradient is summed over
    ``model`` (each rank routes its own tokens)."""
    mesh = _moe_mesh
    assert mesh is not None, "shard_map MoE needs set_moe_impl(mesh=...)"
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    dp = _dp(mesh)
    m = mesh.shape.get("model", 1)
    assert E % m == 0, (E, m)
    assert S % m == 0, (S, m)
    e_loc = E // m
    assert p["moe_wg"].shape[0] == e_loc, (p["moe_wg"].shape, e_loc)
    dt = x.dtype
    mdl = ("model",) if "model" in mesh.shape else ()

    xl = collectives.scatter(x, 1, mesh, mdl) if mdl else x
    T = B * (S // m)
    C = shardmap_capacity(cfg, T)
    toks = xl.reshape(T, D)
    router = collectives.sum_grad(p["router"], mesh, mdl) if mdl \
        else p["router"]
    probs = torch.softmax(toks.float() @ router.float(), dim=-1)  # (T, E)
    expert_ids = top_k(probs.detach(), K)  # (T, K)
    onehot = F.one_hot(expert_ids, E).to(probs.dtype)
    gate_vals = (probs[:, None, :] * onehot).sum(-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    aux = _switch_aux(onehot[:, 0].mean(0), probs.mean(0), cfg, mesh,
                      dp + mdl)

    # one group of all T local tokens; slots expert-major, (E·C, D)
    plan = dispatch_plan(expert_ids[None], E, C)
    _count_drops(plan["tok_slot"], E * C)
    buf = _Dispatch.apply(toks, plan["slot_tok"], plan["tok_slot"])
    # chunk j (experts of model rank j) to rank j: (m, E/m, C, D) from
    # each source rank, regrouped expert-major for K4
    buf = collectives.all_to_all(buf, mesh, "model") if mdl else buf
    if m > 1:
        buf = buf.view(m, e_loc, C, D).transpose(0, 1).reshape(-1, D)
    sizes = [m * C] * e_loc
    h_g = ops.moe_gmm(buf, sizes, p["moe_wg"].to(dt))
    h_u = ops.moe_gmm(buf, sizes, p["moe_wu"].to(dt))
    h = activation(h_g, cfg.act) * h_u
    out_buf = ops.moe_gmm(h, sizes, p["moe_wd"].to(dt))  # (E/m·m·C, D)
    if m > 1:
        out_buf = out_buf.view(e_loc, m, C, D).transpose(0, 1).reshape(-1, D)
        out_buf = collectives.all_to_all(out_buf, mesh, "model")
    out = _Combine.apply(out_buf, gate_vals, plan["tok_slot"],
                         plan["slot_entry"])
    out = out.view(B, S // m, D)
    out = collectives.gather(out, 1, mesh, mdl) if mdl else out
    return out, aux.float()
