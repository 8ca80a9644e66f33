"""Decoder-only language model: the dense, VLM, MoE, hybrid and xLSTM
branches.

Counterpart of the reference package's ``models/lm.py`` for
``family="dense"`` — init, embedding and tied/untied head, the gated MLP,
the train forward and the next-token loss, the dense and paged decode
caches, ragged prefill, and the decode and speculative verify steps on
both caches — and ``family="vlm"`` (phi-3-vision: the dense branch whose
embedding takes ``extra["image_embeds"]`` over the first
``num_image_tokens`` positions, and whose loss leaves out the positions
that predict an image position), ``family="moe"`` (each block's MLP
replaced by the routed experts of ``models/moe.py``, whose aux loss the
blocks carry into the loss; prefill, decode and verify route each step's
rows with that step's capacity), ``family="hybrid"`` (hymba: each block's
attention, global or sliding-window by layer, and its SSM heads side by
side, fused; its cache one dict a layer, a window layer's K/V a ring of
``min(window, max_seq)`` slots) and ``family="ssm"`` (the xLSTM: the
grouped block layout; its cache the layers' recurrent states).  The
reference's ``scan`` over stacked layers is a Python loop here, so the
hybrid's per-layer global/window flag is a static ``if``, not a
``cond``.  As in the reference, the hybrid and the xLSTM take no padded
prefill, no paged cache and no verify, and the MoE decoders no padded
prefill.  The encoder-decoder is ``models/encdec.py``.

The train path (``forward_train``/``loss_fn``) has no counterpart of the
reference's ``hints.*`` calls: those are GSPMD layout constraints that
pin activations and logits to a mesh's shardings.  On a mesh each rank
runs this forward on its rows, and under the split over ``model`` that
the sharded step installs (``parallel/tensor.py``) the embedding, the
MLP, the head and the loss (and attention, ``models/attention.py``)
compute the rank's blocks: the logits come out ``(B, S, V/m)``, pinned
on their vocab as the reference's ``hints.logits`` pins them.  The
sharded step also installs its gathering (``parallel/fsdp.py``): then
:func:`layers` gives each layer's slices of the rank's blocks, each
block function gathers its layer first, and the embedding, head and
final norm are gathered where read.  Every family's prefill and decode
run under the same split and gathering when served on a mesh
(``serve/sharded.py``): the K/V cache is each rank's block of the
sequence (the hybrid's rings and states whole), and the logits come
back whole over the vocab.

Remat ``"full"`` is ``torch.utils.checkpoint`` (non-reentrant) around
each block, the reference's ``jax.checkpoint`` of the scan body; for the
xLSTM around each group of blocks, and ``"dots"`` there is ``"full"``, as
in the reference, whose ``_xlstm_forward`` checkpoints with no policy for
both.
Remat ``"dots"`` of the other blocks is the same checkpoint with a
selective policy (:func:`dots_policy`), the reference's
``checkpoint_dots_with_no_batch_dims``: the outputs of the block's
products without batch dimensions are saved, everything else is
recomputed in the backward.

Parameters keep the reference's tree and shapes (:func:`param_shapes`):
``embed``, ``final_g``, and ``blocks`` with a leading layer axis on every
entry — for the MoE decoders ``blocks/router`` and ``blocks/moe_w*`` in
place of ``blocks/mlp_*``, for the hybrid also ``blocks/ssm_*`` and
``blocks/fuse_*``, for the xLSTM ``blocks/mlstm`` and ``blocks/slstm``.
``blocks`` (for the xLSTM ``blocks/mlstm`` and ``blocks/slstm``) may
also be a list of per-layer dicts (what
:meth:`repro_torch.models.api.Model.serving_params` prepares once, so a
decode step does not re-slice the stacked tensors).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe
from repro_torch.models import recurrent as rec
from repro_torch.models.attention import (attend_decode, attend_decode_paged,
                                          attend_prefill, attend_train,
                                          attend_verify, attend_verify_paged)
from repro_torch.models.common import activation, apply_norm, init_param
from repro_torch.parallel import fsdp, tensor
from repro_torch.tree import unflatten

Params = Dict[str, Any]

RECURRENT = ("ssm", "hybrid")  # families whose decode cache holds state


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config no family of the reference
    builds either."""
    built = cfg.is_encoder_decoder or (
        (cfg.num_experts > 0) == (cfg.family == "moe")
        and cfg.family in ("dense", "vlm", "moe", "hybrid", "ssm"))
    if not built:
        raise ValueError(
            f"family {cfg.family!r} of {cfg.name!r} (experts "
            f"{cfg.num_experts}) is no model family: the port builds the "
            f"dense decoder, the VLM, the MoE decoder, the hybrid, the "
            f"xLSTM and the encoder-decoder")


# ===========================================================================
# Init
# ===========================================================================
def param_table(cfg: ModelConfig) -> Dict[str, Tuple]:
    """``path -> (shape, init, logical axes)`` of every parameter, paths
    joined by ``/`` as the reference's tree nests them, the axes those
    its ``ParamBuilder.p`` records (what ``parallel.sharding.param_spec``
    maps onto a mesh)."""
    require_ported(cfg)
    L, D, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    out = {"embed": ((V, D), "normal", ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((D, V), "normal", ("embed", "vocab"))
    out["final_g"] = ((D,), "ones", ("embed",))
    if cfg.norm == "layernorm":
        out["final_b"] = ((D,), "zeros", ("embed",))
    if cfg.family == "ssm":
        every = cfg.slstm_every
        if every:
            if cfg.num_layers % every:
                raise ValueError(f"num_layers {cfg.num_layers} is not a "
                                 f"multiple of slstm_every {every}")
            groups = cfg.num_layers // every
            blocks = {f"mlstm/{k}": v for k, v in
                      rec.mlstm_shapes(cfg, groups * (every - 1)).items()}
            blocks.update({f"slstm/{k}": v for k, v in
                           rec.slstm_shapes(cfg, groups).items()})
        else:
            blocks = {f"mlstm/{k}": v for k, v in
                      rec.mlstm_shapes(cfg, L).items()}
    else:
        blocks = {**norm_shapes(cfg, L, ("norm1", "norm2")),
                  **attention_shapes(cfg, L)}
        if cfg.family == "hybrid":
            blocks.update(rec.ssm_shapes(cfg, L))
            blocks.update(fuse_attn=((L, D), "ones", ("layers", "embed")),
                          fuse_ssm=((L, D), "ones", ("layers", "embed")))
        if cfg.num_experts > 0:
            blocks.update(moe.moe_shapes(cfg, L))
        elif F > 0:
            blocks.update(mlp_shapes(cfg, L))
    out.update({f"blocks/{k}": v for k, v in blocks.items()})
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``path -> (shape, init)`` of every parameter."""
    return {k: (shape, init)
            for k, (shape, init, _) in param_table(cfg).items()}


def norm_shapes(cfg: ModelConfig, L: int, names) -> Dict[str, Tuple]:
    """Stacked gains (and, for layer norm, biases) of the norms ``names``."""
    out, axes = {}, ("layers", "embed")
    for n in names:
        out[f"{n}_g"] = ((L, cfg.d_model), "ones", axes)
        if cfg.norm == "layernorm":
            out[f"{n}_b"] = ((L, cfg.d_model), "zeros", axes)
    return out


def attention_shapes(cfg: ModelConfig, L: int,
                     prefix: str = "attn") -> Dict[str, Tuple]:
    """Stacked projections (and QKV biases) of ``L`` attention layers."""
    D, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv = ("layers", "embed", "kv_heads", "head_dim")
    out = {f"{prefix}_wq": ((L, D, H, Dh), "normal",
                            ("layers", "embed", "heads", "head_dim")),
           f"{prefix}_wk": ((L, D, KH, Dh), "normal", kv),
           f"{prefix}_wv": ((L, D, KH, Dh), "normal", kv),
           f"{prefix}_wo": ((L, H, Dh, D), "normal",
                            ("layers", "heads", "head_dim", "embed"))}
    if cfg.qkv_bias:
        kv = ("layers", "kv_heads", "head_dim")
        out.update({f"{prefix}_bq": ((L, H, Dh), "zeros",
                                     ("layers", "heads", "head_dim")),
                    f"{prefix}_bk": ((L, KH, Dh), "zeros", kv),
                    f"{prefix}_bv": ((L, KH, Dh), "zeros", kv)})
    return out


def mlp_shapes(cfg: ModelConfig, L: int) -> Dict[str, Tuple]:
    """Stacked weights of ``L`` MLPs (gated for SiLU)."""
    D, F = cfg.d_model, cfg.d_ff
    up = ((L, D, F), "normal", ("layers", "embed", "mlp"))
    out = {"mlp_wg": up} if cfg.act == "silu" else {}
    out.update(mlp_wu=up,
               mlp_wd=((L, F, D), "normal", ("layers", "mlp", "embed")))
    return out


def init_params(cfg: ModelConfig, shapes, seed: int,
                device: torch.device) -> Params:
    """Parameters of ``shapes`` (``path -> (shape, init)``) with the
    reference's names, drawn as :func:`repro_torch.models.common.init_param`
    says, in ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    return unflatten(
        (path, init_param(path, shape, seed=seed, device=device, dtype=dtype,
                          init=init))
        for path, (shape, init) in shapes.items())


def _unstack(blocks: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Per-layer dicts of stacked parameters (views, by ``unbind``, whose
    gradient is one stack of the layers' gradients)."""
    per = {k: v.unbind(0) for k, v in blocks.items()}
    n = len(next(iter(per.values())))
    return [{k: per[k][i] for k in per} for i in range(n)]


def layers(cfg: ModelConfig, blocks) -> List[Dict[str, torch.Tensor]]:
    """Per-layer parameter dicts of a stack of layers; under the sharded
    step's gathering (``parallel/fsdp.py``) each layer's slices of this
    rank's blocks, which the layer's function gathers
    (``fsdp.layer``)."""
    if isinstance(blocks, list):
        return blocks
    per = fsdp.layers(blocks)
    return _unstack(blocks) if per is None else per


# ===========================================================================
# Shared pieces
# ===========================================================================
def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 extra: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype``; for the VLM, ``image_embeds``
    ``(B, n_img, D)`` in place of the first ``n_img`` positions when the
    sequence holds them (the reference's ``dynamic_update_slice``: the
    overlaid positions take no gradient into ``embed``)."""
    dt = getattr(torch, cfg.dtype)
    emb = fsdp.leaf(params["embed"])
    sp = tensor.active()
    if sp is not None and sp.splits("vocab"):
        # vocab-parallel: this rank's block of rows looks up the tokens it
        # holds, zeros for the rest, summed over ``model`` (one term a
        # token is non-zero: the sum is exact)
        t = tokens.reshape(-1).long() - sp.rank * emb.shape[0]
        inside = (t >= 0) & (t < emb.shape[0])
        x = emb.index_select(0, torch.where(inside, t, 0))
        x = sp.reduce_sum(torch.where(inside[:, None], x, 0.0))
    else:
        # index_select: its gradient has a deterministic CUDA implementation
        x = emb.index_select(0, tokens.reshape(-1).long())
    x = x.view(*tokens.shape, -1).to(dt)
    if cfg.family == "vlm" and extra and "image_embeds" in extra:
        img = extra["image_embeds"]
        if tokens.shape[1] >= img.shape[1]:
            x = torch.cat([img.to(dt), x[:, img.shape[1]:]], dim=1)
    return x


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head: ``(B, S, V)`` logits, or under a
    vocab-parallel split this rank's ``(B, S, V/m)`` block."""
    xn = apply_norm(fsdp.norm_leaves(params, "final"), "final", x, cfg.norm)
    head = fsdp.leaf(params["embed"]).t() if cfg.tie_embeddings \
        else fsdp.leaf(params["lm_head"])
    sp = tensor.active()
    if sp is not None and sp.splits("vocab"):
        xn = sp.sum_grad(xn)
    return xn @ head.to(xn.dtype)


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """The (gated) MLP; under a split of its hidden dim this rank's
    columns of ``mlp_wg``/``mlp_wu`` and rows of ``mlp_wd``, the terms
    summed over ``model``."""
    dt = x.dtype
    sp = tensor.active()
    split = sp is not None and sp.splits("mlp")
    if split:
        x = sp.sum_grad(x)
    hu = x @ p["mlp_wu"].to(dt)
    if cfg.act == "silu":
        h = activation(x @ p["mlp_wg"].to(dt), "silu") * hu
    else:
        h = activation(hu, "gelu")
    out = h @ p["mlp_wd"].to(dt)
    return sp.reduce_sum(out) if split else out


def _ffn_residual(p, x, cfg) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(x + its FFN on the norm2'ed x, the MoE layer's float32 aux
    loss or None)``: the routed experts for the MoE decoders (capacity
    from this call's sequence length, as in the reference; under a split
    that holds the experts split, this rank's experts' partial output
    summed over ``model``), else the MLP (none when ``d_ff`` is 0)."""
    if cfg.num_experts > 0:
        xn = apply_norm(p, "norm2", x, cfg.norm)
        sp = tensor.active()
        if sp is not None and sp.splits("experts"):
            out, aux = moe.apply_moe_split(p, sp.sum_grad(xn), cfg, sp.rank,
                                           sp.size)
            out = sp.reduce_sum(out)
        else:
            out, aux = moe.apply_moe(p, xn, cfg)
        return x + out, aux
    if cfg.d_ff > 0:
        x = x + apply_mlp(p, apply_norm(p, "norm2", x, cfg.norm), cfg)
    return x, None


def _hybrid_mix(p, attn, ssm_out):
    """The hybrid's fused mean of its attention and SSM outputs."""
    dt = attn.dtype
    return 0.5 * (attn * p["fuse_attn"].to(dt)
                  + ssm_out * p["fuse_ssm"].to(dt))


# ===========================================================================
# Train
# ===========================================================================
def _block_train(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, window: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block of the train path: ``(x, aux loss)``, the aux
    loss the MoE layer's (a float32 0 elsewhere).  The hybrid's block runs
    attention (``window`` 0 = global) and the SSM heads on the same normed
    input and adds their fused mean.  ``p`` may be a layer's slices under
    the sharded step's gathering, gathered here first."""
    p = fsdp.layer(p)
    h = apply_norm(p, "norm1", x, cfg.norm)
    mix = attend_train(p, h, cfg, causal=True, window=window)
    if cfg.family == "hybrid":
        mix = _hybrid_mix(p, mix, rec.apply_ssm(p, h, cfg))
    x, aux = _ffn_residual(p, x + mix, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer ``i``'s attention window: 0 (global) for the hybrid's global
    layers and for every other decoder, else ``cfg.sliding_window`` (the
    reference's ``_layer_flags``)."""
    if cfg.family == "hybrid" and i not in cfg.global_attn_layers:
        return cfg.sliding_window
    return 0


def dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """Remat ``dots``: save the output of every product without batch
    dimensions that autograd records, recompute the rest.  At dispatch
    those products are ``aten.mm`` alone: each projection and FFN matmul
    ``x @ W`` (``x`` ``(B, S, D)`` folded to rows) — q, k, v and the
    output projection, the MLP's gate, up and down, the MoE router, the
    hybrid's SSM in, z, B, C, dt and out projections.  No block reaches
    ``aten.addmm`` (biases are added apart).  Recomputed: ``aten.bmm``
    (batched products), the elementwise chain, and the kernels K1, K4
    and K5.  A kernel's ``autograd.Function`` runs its forward with grad
    mode off, so the products of its plain version on a CPU tensor
    (K1's batched einsums, K4's per-group ``mm``) are not saved either:
    a kernel is one opaque op, as a ``pallas_call`` is no
    ``dot_general`` in the reference."""
    del ctx, args, kwargs
    if func is torch.ops.aten.mm.default and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(dots_policy)


def _scan_blocks(cfg: ModelConfig, blocks, x: torch.Tensor,
                 remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, aux)`` after every block, the blocks' aux losses summed in
    layer order from a float32 zero (the reference's scan carry)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots; got {remat!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layers(cfg, blocks)):
        window = layer_window(cfg, i)
        if remat == "full":
            x, a = checkpoint(_block_train, cfg, p, x, window,
                              use_reentrant=False)
        elif remat == "dots":
            x, a = checkpoint(_block_train, cfg, p, x, window,
                              use_reentrant=False, context_fn=_dots_contexts)
        else:
            x, a = _block_train(cfg, p, x, window)
        aux = aux + a
    return x, aux


def _xlstm_group(cfg: ModelConfig, x: torch.Tensor, mlayers, slayer):
    """One group of the xLSTM: its mLSTM blocks, then its sLSTM block
    (none when ``slstm_every`` is 0), each gathered first under the
    sharded step's gathering."""
    for p in mlayers:
        x = rec.apply_mlstm(fsdp.layer(p), x, cfg)
    return x if slayer is None \
        else rec.apply_slstm(fsdp.layer(slayer), x, cfg)


def _xlstm_groups(cfg: ModelConfig, blocks: Params):
    """``[(mLSTM layers, sLSTM layer or None), ...]``, one pair a group
    (one mLSTM layer a group when ``slstm_every`` is 0)."""
    mlayers = layers(cfg, blocks["mlstm"])
    every = cfg.slstm_every
    if not every:
        return [([p], None) for p in mlayers]
    return [(mlayers[g * (every - 1):(g + 1) * (every - 1)], sp)
            for g, sp in enumerate(layers(cfg, blocks["slstm"]))]


def _xlstm_forward(cfg: ModelConfig, blocks: Params, x: torch.Tensor,
                   remat: str = "none") -> torch.Tensor:
    """G groups of (slstm_every - 1) mLSTM + 1 sLSTM blocks, or only
    mLSTM blocks when ``slstm_every`` is 0; remat ``full`` (and ``dots``,
    as in the reference) checkpoints each group, or each block of the
    mLSTM-only stack."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots; got {remat!r}")
    for mp, sp in _xlstm_groups(cfg, blocks):
        if remat == "none":
            x = _xlstm_group(cfg, x, mp, sp)
        else:
            x = checkpoint(_xlstm_group, cfg, x, mp, sp, use_reentrant=False)
    return x


def forward_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  extra: Optional[Dict[str, torch.Tensor]] = None,
                  remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``(B, S)`` (and, for the VLM, ``extra["image_embeds"]``) ->
    ``(logits (B, S, V) in cfg.dtype, aux loss)``; the logits are the
    rank's vocab block under a vocab-parallel split."""
    require_ported(cfg)
    x = embed_tokens(params, cfg, tokens, extra)
    if cfg.family == "ssm":
        x = _xlstm_forward(cfg, params["blocks"], x, remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = _scan_blocks(cfg, params["blocks"], x, remat)
    return lm_logits(params, cfg, x), aux


def token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``(B, S-1)`` float32 negative log-likelihood of each next token:
    position ``t``'s logits against token ``t + 1``.  Under a split of
    the vocab the logits are this rank's vocab block
    (:func:`_vocab_parallel_nll`)."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    sp = tensor.active()
    if sp is not None and sp.splits("vocab"):
        return _vocab_parallel_nll(sp, logits, targets)
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, targets[..., None])[..., 0]


def _vocab_parallel_nll(sp, logits: torch.Tensor, targets: torch.Tensor
                        ) -> torch.Tensor:
    """The NLL from this rank's float32 vocab block of the logits: the
    max over every block (no gradient), the blocks' sums of exponentials
    summed over ``model``, and the target's logit from the block that
    holds it, summed over ``model``."""
    vb = logits.shape[-1]
    mx = sp.max(logits.detach().amax(-1))
    logz = torch.log(sp.reduce_sum(torch.exp(logits - mx[..., None]).sum(-1)))
    t = targets - sp.rank * vb
    inside = (t >= 0) & (t < vb)
    picked = torch.gather(logits, -1, torch.where(inside, t, 0)[..., None])
    picked = sp.reduce_sum(torch.where(inside, picked[..., 0], 0.0))
    return logz + mx - picked


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32 over ``batch["tokens"]`` plus the
    aux loss; returns ``(loss, {"loss", "ce", "aux", "tokens"})`` as the
    reference's ``loss_fn`` does.  Every position counts, except for the
    VLM, whose loss leaves out the predictions at positions
    ``< num_image_tokens - 1`` (those of an image position)."""
    tokens = batch["tokens"]
    logits, aux = forward_train(params, cfg, tokens, batch, remat)
    nll = token_nll(logits, tokens)
    if cfg.family == "vlm" and cfg.num_image_tokens:
        pos = torch.arange(nll.shape[1], device=nll.device)[None]
        mask = (pos >= cfg.num_image_tokens - 1).to(nll.dtype).expand_as(nll)
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
    else:
        denom = torch.full((), float(max(nll.numel(), 1)), device=nll.device)
        ce = nll.sum() / denom
    total = ce + aux
    return total, {"loss": total, "ce": ce, "aux": aux, "tokens": denom}


# ===========================================================================
# Caches
# ===========================================================================
def _stack(states: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-layer state dicts stacked along a new leading axis."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device) -> Params:
    """The zero decode cache of ``batch`` slots and ``max_seq`` positions,
    the reference's ``init_cache`` layouts:

      * dense, VLM and MoE: ``(L, B, max_seq, KH, Dh)`` K/V and ``pos``;
      * the hybrid: ``{"layers": [...], "pos"}``, one dict a layer, K/V
        ``(B, size, KH, Dh)`` with ``size`` ``max_seq`` for a global
        layer and ``min(window, max_seq)`` for a window layer (a ring),
        ``slot_pos`` ``(B, size)`` -1 (no position held) and the SSM
        state (:func:`repro_torch.models.recurrent.ssm_state_spec`);
      * the xLSTM: ``{"mlstm", "slstm", "pos"}``, each layer's recurrent
        state stacked, the mLSTM's ``(groups, slstm_every - 1, B, ...)``
        and the sLSTM's ``(groups, B, ...)`` (``(L, B, ...)`` mLSTM
        states alone when ``slstm_every`` is 0), float32."""
    require_ported(cfg)
    dt = getattr(torch, cfg.dtype)
    KH, Dh, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        every = cfg.slstm_every
        m = rec.mlstm_state_spec(cfg, batch, device)
        if not every:
            return {"mlstm": _stack([m] * L), "pos": pos}
        groups = L // every
        s = rec.slstm_state_spec(cfg, batch, device)
        return {"mlstm": _stack([_stack([m] * (every - 1))] * groups),
                "slstm": _stack([s] * groups), "pos": pos}
    if cfg.family == "hybrid":
        out = []
        for i in range(L):
            w = layer_window(cfg, i)
            size = min(w, max_seq) if w else max_seq
            out.append({
                "k": torch.zeros((batch, size, KH, Dh), dtype=dt,
                                 device=device),
                "v": torch.zeros((batch, size, KH, Dh), dtype=dt,
                                 device=device),
                "slot_pos": torch.full((batch, size), -1, dtype=torch.int32,
                                       device=device),
                "ssm": rec.ssm_state_spec(cfg, batch, device)})
        return {"layers": out, "pos": pos}
    shape = (L, batch, max_seq, KH, Dh)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": pos,
    }


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int,
                     device: torch.device) -> Params:
    """Paged decode cache: global ``(L, KH, num_pages, page, Dh)`` K/V
    pools shared by every slot plus a per-slot ``(batch, max_pages)``
    int32 page table (-1 = unmapped).  Pool page 0 is the engine's null
    page and is never allocated.  The hybrid's and the xLSTM's recurrent
    state has no per-position pages: ``ValueError``, as in the
    reference."""
    require_ported(cfg)
    if cfg.family in RECURRENT:
        raise ValueError(f"paged KV cache unsupported for family "
                         f"{cfg.family!r}: only dense-attention caches page")
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page_size,
             cfg.head_dim)
    return {
        "k_pool": torch.zeros(shape, dtype=dt, device=device),
        "v_pool": torch.zeros(shape, dtype=dt, device=device),
        "page_table": torch.full((batch, max_pages), -1, dtype=torch.int32,
                                 device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ===========================================================================
# Prefill / decode
# ===========================================================================
def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None,
            max_seq: Optional[int] = None,
            lens: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
    """Full forward emitting the decode cache (:func:`init_cache`'s
    layout for ``max_seq`` positions).  Returns (last-token logits
    ``(B, V)``, cache).  Under the serving split over ``model``
    (``serve/sharded.py``) the forward is split as the train forward is,
    the cache's K/V (the hybrid's global layers') are this rank's block
    of the sequence (``Split.cache_block``), every other cache leaf is
    whole and the same on every ``model`` rank, and the logits come back
    whole over the vocab.

    ``lens`` (B,) marks ragged rows of a right-padded batch: logits come
    from position ``lens[b] - 1`` and the cache position is ``lens[b]``,
    so decode's ``kv_len`` masking hides the pad positions' K/V.
    Causality makes every real position independent of the padding, for
    attention-only models: the recurrent families would carry pad steps
    in their state and the MoE decoders' capacity depends on the padded
    length, so they raise ``ValueError``, as the reference does.
    ``extra`` carries the VLM's ``image_embeds``."""
    require_ported(cfg)
    B, S = tokens.shape
    max_seq = max_seq or S
    if lens is not None and cfg.family in RECURRENT:
        raise ValueError(f"padded prefill (lens) unsupported for family "
                         f"{cfg.family!r}: recurrent state would include "
                         f"pad steps")
    if lens is not None and cfg.num_experts > 0:
        raise ValueError("padded prefill (lens) unsupported for MoE: "
                         "expert capacity scales with the padded length "
                         "and pad tokens would evict real ones")
    x = embed_tokens(params, cfg, tokens, extra)
    full = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if cfg.family == "ssm":
        x, cache = _xlstm_prefill(cfg, params["blocks"], x)
        logits = _whole_logits(params, cfg, x[:, -1:])
        return logits[:, 0], dict(cache, pos=full)
    per_layer = layers(cfg, params["blocks"])
    if cfg.family == "hybrid":
        cache_layers = []
        for i, p in enumerate(per_layer):
            x, cl = _hybrid_block_prefill(cfg, p, x, layer_window(cfg, i),
                                          max_seq)
            cache_layers.append(cl)
        logits = _whole_logits(params, cfg, x[:, -1:])
        return logits[:, 0], {"layers": cache_layers, "pos": full}
    held, start, n = cache_block(S, max_seq)
    shape = (len(per_layer), B, held, cfg.num_kv_heads, cfg.head_dim)
    kcache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vcache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, p in enumerate(per_layer):
        p = fsdp.layer(p)
        h = apply_norm(p, "norm1", x, cfg.norm)
        attn, k, v = attend_prefill(p, h, cfg, (start, n))
        x, _ = _ffn_residual(p, x + attn, cfg)
        kcache[i, :, :n] = k
        vcache[i, :, :n] = v
    if lens is None:
        x_last = x[:, -1:]
        pos = full
    else:
        pos = lens.to(device=x.device, dtype=torch.int32)
        x_last = x[torch.arange(B, device=x.device), pos.long() - 1][:, None]
    logits = _whole_logits(params, cfg, x_last)
    return logits[:, 0], {"k": kcache, "v": vcache, "pos": pos}


def cache_block(S: int, max_seq: int) -> Tuple[int, int, int]:
    """``(held, start, n)``: the positions of a decode cache of
    ``max_seq`` that this rank holds (all of them, or under the serving
    split its block, ``Split.cache_block``), the first of them, and how
    many of them a prompt of ``S`` positions reaches."""
    sp = tensor.active()
    held = max_seq if sp is None else sp.cache_block(max_seq)
    start = 0 if sp is None else min(sp.rank * held, S)
    return held, start, max(0, min(S, start + held) - start)


def _whole_logits(params: Params, cfg: ModelConfig,
                  x: torch.Tensor) -> torch.Tensor:
    """:func:`lm_logits` over the whole vocab: under a vocab-parallel
    split the ranks' blocks gathered over ``model``."""
    logits = lm_logits(params, cfg, x)
    sp = tensor.active()
    if sp is not None and sp.splits("vocab"):
        logits = sp.gather(logits, logits.dim() - 1)
    return logits


def _hybrid_block_prefill(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                          x: torch.Tensor, window: int, max_seq: int
                          ) -> Tuple[torch.Tensor, Params]:
    """One hybrid block over the prompt: attention through K1 (causal,
    ``window`` 0 = global) beside the SSM heads through K5 with its final
    state, then the block's cache entry (the reference's
    ``_hybrid_block_prefill``).  A layer's K/V takes ``size`` slots
    (:func:`init_cache`); when the prompt is longer, the ring holds its
    last ``size`` positions, position ``t`` at slot ``t % size``.

    Under the serving split over ``model`` (``serve/sharded.py``) the
    attention and the SSM heads are split as the train forward splits
    them; a global layer's K/V and ``slot_pos`` are this rank's block of
    the sequence (``slot_pos`` -1 past the prompt), and a window layer's
    ring and every SSM state are whole, the same on every ``model`` rank
    (the ring's K/V of every KV head from the rows held alike, the SSM's
    channel blocks gathered: ``models/recurrent.py``).  ``p`` may be a
    layer's slices under the gathering, gathered here first."""
    p = fsdp.layer(p)
    B, S, _ = x.shape
    dev = x.device
    h = apply_norm(p, "norm1", x, cfg.norm)
    size = min(window, max_seq) if window else max_seq
    split = window == 0 and tensor.active() is not None
    if split:
        if S > max_seq:
            raise ValueError(f"a prompt of {S} positions does not fit a "
                             f"split cache of {max_seq}")
        held, start, n = cache_block(S, max_seq)
    else:  # the last ``size`` positions
        held, start = size, max(0, S - size)
        n = S - start
    attn, k, v = attend_prefill(p, h, cfg, (start, n), window=window)
    ssm_out, ssm_state = rec.prefill_ssm(p, h, cfg)
    x, _ = _ffn_residual(p, x + _hybrid_mix(p, attn, ssm_out), cfg)
    if split or S <= size:  # the first n slots hold positions start..
        kc = k.new_zeros((B, held) + k.shape[2:])
        vc = v.new_zeros((B, held) + v.shape[2:])
        kc[:, :n], vc[:, :n] = k, v
        sp = torch.full((B, held), -1, dtype=torch.int32, device=dev)
        sp[:, :n] = torch.arange(start, start + n, dtype=torch.int32,
                                 device=dev)
    else:  # the ring: slot j holds the t in [S - size, S) with t = j mod size
        j = torch.arange(size, device=dev)
        at = (j - start) % size  # into the last ``size`` positions
        kc, vc = k[:, at], v[:, at]
        sp = (start + at).to(torch.int32).expand(B, size).contiguous()
    return x, {"k": kc, "v": vc, "slot_pos": sp, "ssm": ssm_state}


def _xlstm_prefill(cfg: ModelConfig, blocks: Params, x: torch.Tensor):
    """The xLSTM over the prompt, each mLSTM block through K6 with its
    final state and each sLSTM block's loop keeping its own: ``(x, the
    cache's state leaves)`` in :func:`init_cache`'s layout (the
    reference's ``_xlstm_prefill_cache``).  Each layer is gathered first
    under the serving gathering (``serve/sharded.py``: every ``model``
    rank runs its rows' prefill whole, as the train step's
    ``GATHER_AND_REPEAT``)."""
    mstates, sstates = [], []
    for mp, sp in _xlstm_groups(cfg, blocks):
        group = []
        for p in mp:
            x, st = rec.prefill_mlstm(fsdp.layer(p), x, cfg)
            group.append(st)
        mstates.append(_stack(group))
        if sp is not None:
            x, st = rec.prefill_slstm(fsdp.layer(sp), x, cfg)
            sstates.append(st)
    if not cfg.slstm_every:  # (L, B, ...): one mLSTM layer a "group"
        return x, {"mlstm": {k: v[:, 0] for k, v in _stack(mstates).items()}}
    return x, {"mlstm": _stack(mstates), "slstm": _stack(sstates)}


def _xlstm_decode(cfg: ModelConfig, blocks: Params, cache: Params,
                  x: torch.Tensor) -> torch.Tensor:
    """One token through the xLSTM, each layer's state read from the
    cache and written back in place (the reference's ``_xlstm_decode``
    returns new stacks), each layer gathered first as in
    :func:`_xlstm_prefill`."""
    every = cfg.slstm_every
    for g, (mp, sp) in enumerate(_xlstm_groups(cfg, blocks)):
        for j, p in enumerate(mp):
            at = (g, j) if every else (g,)
            state = {k: v[at] for k, v in cache["mlstm"].items()}
            x, new = rec.decode_mlstm(fsdp.layer(p), state, x, cfg)
            for k, v in new.items():
                state[k].copy_(v)
        if sp is not None:
            state = {k: v[g] for k, v in cache["slstm"].items()}
            x, new = rec.decode_slstm(fsdp.layer(sp), state, x, cfg)
            for k, v in new.items():
                state[k].copy_(v)
    return x


def _hybrid_block_decode(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                         cl: Params, x: torch.Tensor, pos: torch.Tensor,
                         window: int, kv_blocks: int = 1) -> torch.Tensor:
    """One token through a hybrid block: a global layer's dense read (in
    ``kv_blocks`` sequence blocks, or under the serving split this rank's
    block), a window layer's ring read whole
    (:func:`repro_torch.models.attention.attend_decode` with ``window``),
    and the SSM heads' step on the whole state, written back in place.
    ``p`` may be a layer's slices under the gathering, gathered here
    first."""
    p = fsdp.layer(p)
    h = apply_norm(p, "norm1", x, cfg.norm)
    attn = attend_decode(p, h, cl["k"], cl["v"], pos, cfg, window=window,
                         slot_pos=cl["slot_pos"] if window else None,
                         kv_blocks=1 if window else kv_blocks)
    ssm_out, new = rec.decode_ssm(p, cl["ssm"], h, cfg)
    for k, v in new.items():
        cl["ssm"][k].copy_(v)
    return _ffn_residual(p, x + _hybrid_mix(p, attn, ssm_out), cfg)[0]


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, kv_blocks: int = 1
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B, 1).  Returns (logits (B, V), cache with ``pos + 1``).

    Dispatches on the family and the cache layout: a ``k_pool`` key marks
    the paged cache.  The new token's K/V (and a recurrent layer's new
    state) is written into the given cache in place (the reference
    returns new arrays); the returned dict holds the same tensors and the
    advanced ``pos``.

    Under the serving split over ``model`` (``serve/sharded.py``) the
    dense cache's K/V, and the hybrid's global layers' K/V, are this
    rank's block of the sequence (``models/attention.py``'s
    ``_attend_decode_blocks``), the hybrid's rings and SSM states are
    whole, the SSM stepped whole on every ``model`` rank, and the logits
    come back whole over the vocab; the xLSTM gathers each layer and
    steps its state whole.  ``kv_blocks > 1`` reads a whole dense cache
    (the hybrid's global layers') on one device in that many sequence
    blocks, merged as the split merges its ranks' blocks."""
    require_ported(cfg)
    sp = tensor.active()
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    blocks = params["blocks"]
    if cfg.family == "ssm":
        x = _xlstm_decode(cfg, blocks, cache, x)
    elif cfg.family == "hybrid":
        for i, (p, cl) in enumerate(zip(layers(cfg, blocks),
                                        cache["layers"])):
            x = _hybrid_block_decode(cfg, p, cl, x, pos, layer_window(cfg, i),
                                     kv_blocks)
    else:
        paged = "k_pool" in cache
        if paged and (sp is not None or kv_blocks > 1):
            raise ValueError("the paged cache is read whole, on one device")
        for i, p in enumerate(layers(cfg, blocks)):
            p = fsdp.layer(p)
            h = apply_norm(p, "norm1", x, cfg.norm)
            if paged:
                attn = attend_decode_paged(p, h, cache["k_pool"][i],
                                           cache["v_pool"][i],
                                           cache["page_table"], pos, cfg)
            else:
                attn = attend_decode(p, h, cache["k"][i], cache["v"][i], pos,
                                     cfg, kv_blocks=kv_blocks)
            x, _ = _ffn_residual(p, x + attn, cfg)
    logits = _whole_logits(params, cfg, x)[:, 0]
    return logits, dict(cache, pos=pos + 1)


def verify_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Speculative verify: tokens ``(B, T)`` — the last committed token
    plus ``k = T - 1`` drafts — scored in one pass.  Returns
    ``(logits (B, T, V), cache with pos + T)``, where ``logits[:, i]`` is
    the target distribution for the token after ``tokens[:, i]``.

    All T K/V rows are written into the given cache in place (dense or
    paged, by the ``k_pool`` key); the engine rewinds ``pos`` after
    acceptance, and rejected rows stay above ``pos``, hidden by the
    per-row limits until real tokens overwrite them.  A MoE layer routes
    the T rows of a slot as one group, with the capacity of T tokens, as
    the reference does.  The recurrent families raise ``ValueError``:
    their state cannot roll back rejected drafts."""
    require_ported(cfg)
    if cfg.family in RECURRENT:
        raise ValueError(f"speculative verify unsupported for family "
                         f"{cfg.family!r}: recurrent state cannot roll back "
                         f"rejected drafts")
    pos = cache["pos"]
    T = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    paged = "k_pool" in cache
    for i, p in enumerate(layers(cfg, params["blocks"])):
        h = apply_norm(p, "norm1", x, cfg.norm)
        if paged:
            attn = attend_verify_paged(p, h, cache["k_pool"][i],
                                       cache["v_pool"][i],
                                       cache["page_table"], pos, cfg)
        else:
            attn = attend_verify(p, h, cache["k"][i], cache["v"][i], pos, cfg)
        x, _ = _ffn_residual(p, x + attn, cfg)
    logits = lm_logits(params, cfg, x)
    return logits, dict(cache, pos=pos + T)
