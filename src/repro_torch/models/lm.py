"""Decoder-only language model: the dense, MoE, hybrid and xLSTM branches.

Counterpart of the reference package's ``models/lm.py`` for
``family="dense"`` — init, embedding and tied/untied head, the gated MLP,
the train forward and the next-token loss, the dense and paged decode
caches, ragged prefill, and the decode and speculative verify steps on
both caches — and the train paths of ``family="moe"`` (each block's MLP
replaced by the routed experts of ``models/moe.py``, whose aux loss the
blocks carry into the loss), ``family="hybrid"`` (hymba: each block's
attention, global or sliding-window by layer, and its SSM heads side by
side, fused) and ``family="ssm"`` (the xLSTM: the grouped block layout).
The reference's ``scan`` over stacked layers is a Python loop here, so
the hybrid's per-layer global/window flag is a static ``if``, not a
``cond``.  The serving paths (prefill, caches, decode) of the MoE
decoders, the hybrid and the xLSTM, and the other families, raise
``NotImplementedError`` naming the ROADMAP entry that brings them.

The train path (``forward_train``/``loss_fn``) has no counterpart of the
reference's ``hints.*`` calls: those pin activations and logits to a
device mesh's shardings, and the port runs on one card with no mesh
(ROADMAP queue 1, parallelism and elasticity).  Remat ``"full"`` is
``torch.utils.checkpoint`` (non-reentrant) around each block, the
reference's ``jax.checkpoint`` of the scan body; for the xLSTM around
each group of blocks, and ``"dots"`` there is ``"full"``, as in the
reference, whose ``_xlstm_forward`` checkpoints with no policy for both.

Parameters keep the reference's tree and shapes (:func:`param_shapes`):
``embed``, ``final_g``, and ``blocks`` with a leading layer axis on every
entry — for the MoE decoders ``blocks/router`` and ``blocks/moe_w*`` in
place of ``blocks/mlp_*``, for the hybrid also ``blocks/ssm_*`` and
``blocks/fuse_*``, for the xLSTM ``blocks/mlstm`` and ``blocks/slstm``.
Dense ``blocks`` may also be a list of per-layer dicts (what
:meth:`repro_torch.models.api.Model.serving_params` prepares once, so a
decode step does not re-slice the stacked tensors).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import recurrent as rec
from repro_torch.models.attention import (attend_decode, attend_decode_paged,
                                          attend_train, attend_verify,
                                          attend_verify_paged, out_proj, qkv)
from repro_torch.models.common import (activation, apply_norm, apply_rope,
                                       init_param, rope_angles)
from repro_torch.tree import unflatten

Params = Dict[str, Any]

XLSTM_SERVING = "ROADMAP queue 1, xLSTM serving"
HYMBA_SERVING = "ROADMAP queue 1, hymba serving"
MOE_SERVING = "ROADMAP queue 1, MoE serving"
_SERVING_LATER = {
    "moe": (MOE_SERVING, "the engine's exact-length admission groups: "
            "capacity dispatch makes a token's expert output depend on the "
            "other tokens of its row, so padding or mixing lengths would "
            "change the routing"),
    "ssm": (XLSTM_SERVING, "prefill through K6 with a final state, the "
            "recurrent decode, the engine's exact-length admission groups"),
    "hybrid": (HYMBA_SERVING, "the hybrid prefill and decode blocks, the "
               "ring-buffer window cache, the SSM decode state, the "
               "engine's exact-length admission groups"),
}


def require_ported(cfg: ModelConfig, *, serving: bool = False) -> None:
    """Raise ``NotImplementedError`` for what the port does not build:
    families other than the dense decoder, the MoE decoder, the hybrid
    and the xLSTM, and, with ``serving``, the MoE decoder's, the hybrid's
    and the xLSTM's serving paths (their train paths are ported)."""
    built = (not cfg.is_encoder_decoder
             and (cfg.num_experts > 0) == (cfg.family == "moe")
             and cfg.family in ("dense", "moe", "hybrid", "ssm"))
    if not built:
        raise NotImplementedError(
            f"family {cfg.family!r} of {cfg.name!r} is not ported to "
            f"PyTorch yet: only the dense decoder, the MoE decoder, the "
            f"hybrid and the xLSTM are (ROADMAP queue 1 lists the VLM and "
            f"the encoder-decoder family)")
    if serving and cfg.family in _SERVING_LATER:
        item, what = _SERVING_LATER[cfg.family]
        raise NotImplementedError(
            f"serving {cfg.name!r} (family {cfg.family!r}) is not ported to "
            f"PyTorch yet, only its train path is: {item} ({what})")


# ===========================================================================
# Init
# ===========================================================================
def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``path -> (shape, init)`` of every parameter, paths joined by
    ``/`` as the reference's tree nests them."""
    require_ported(cfg)
    L, D, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"embed": ((V, D), "normal")}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((D, V), "normal")
    out["final_g"] = ((D,), "ones")
    if cfg.norm == "layernorm":
        out["final_b"] = ((D,), "zeros")
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
        blocks = {
            "norm1_g": ((L, D), "ones"), "norm2_g": ((L, D), "ones"),
            "attn_wq": ((L, D, H, Dh), "normal"),
            "attn_wk": ((L, D, KH, Dh), "normal"),
            "attn_wv": ((L, D, KH, Dh), "normal"),
            "attn_wo": ((L, H, Dh, D), "normal"),
        }
        if cfg.norm == "layernorm":
            blocks.update(norm1_b=((L, D), "zeros"), norm2_b=((L, D), "zeros"))
        if cfg.qkv_bias:
            blocks.update(attn_bq=((L, H, Dh), "zeros"),
                          attn_bk=((L, KH, Dh), "zeros"),
                          attn_bv=((L, KH, Dh), "zeros"))
        if cfg.family == "hybrid":
            blocks.update(rec.ssm_shapes(cfg, L))
            blocks.update(fuse_attn=((L, D), "ones"),
                          fuse_ssm=((L, D), "ones"))
        if cfg.num_experts > 0:
            blocks.update(moe.moe_shapes(cfg, L))
        elif F > 0:
            if cfg.act == "silu":
                blocks["mlp_wg"] = ((L, D, F), "normal")
            blocks.update(mlp_wu=((L, D, F), "normal"),
                          mlp_wd=((L, F, D), "normal"))
    out.update({f"blocks/{k}": v for k, v in blocks.items()})
    return out


def init_lm(cfg: ModelConfig, seed: int, device: torch.device) -> Params:
    """Parameters with the reference's names and shapes, drawn as
    :func:`repro_torch.models.common.init_param` says, in
    ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    return unflatten(
        (path, init_param(path, shape, seed=seed, device=device, dtype=dtype,
                          init=init))
        for path, (shape, init) in param_shapes(cfg).items())


def _unstack(blocks: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Per-layer dicts of stacked parameters (views, by ``unbind``, whose
    gradient is one stack of the layers' gradients)."""
    per = {k: v.unbind(0) for k, v in blocks.items()}
    n = len(next(iter(per.values())))
    return [{k: per[k][i] for k in per} for i in range(n)]


def layers(cfg: ModelConfig, blocks) -> List[Dict[str, torch.Tensor]]:
    """Per-layer parameter dicts of the dense decoder."""
    if isinstance(blocks, list):
        return blocks
    return _unstack(blocks)


# ===========================================================================
# Shared pieces
# ===========================================================================
def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    # index_select: its gradient has a deterministic CUDA implementation
    x = params["embed"].index_select(0, tokens.reshape(-1).long())
    return x.view(*tokens.shape, -1).to(getattr(torch, cfg.dtype))


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xn = apply_norm(params, "final", x, cfg.norm)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return xn @ head.to(xn.dtype)


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    hu = x @ p["mlp_wu"].to(dt)
    if cfg.act == "silu":
        h = activation(x @ p["mlp_wg"].to(dt), "silu") * hu
    else:
        h = activation(hu, "gelu")
    return h @ p["mlp_wd"].to(dt)


def _mlp_residual(p, x, cfg):
    if cfg.d_ff > 0:
        x = x + apply_mlp(p, apply_norm(p, "norm2", x, cfg.norm), cfg)
    return x


# ===========================================================================
# Train
# ===========================================================================
def _block_train(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, window: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block of the train path: ``(x, aux loss)``, the aux
    loss the MoE layer's (a float32 0 elsewhere).  The hybrid's block runs
    attention (``window`` 0 = global) and the SSM heads on the same normed
    input and adds their fused mean."""
    h = apply_norm(p, "norm1", x, cfg.norm)
    mix = attend_train(p, h, cfg, causal=True, window=window)
    if cfg.family == "hybrid":
        dt = x.dtype
        mix = 0.5 * (mix * p["fuse_attn"].to(dt)
                     + rec.apply_ssm(p, h, cfg) * p["fuse_ssm"].to(dt))
    x = x + mix
    if cfg.num_experts > 0:
        out, aux = moe.apply_moe(p, apply_norm(p, "norm2", x, cfg.norm), cfg)
        return x + out, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _mlp_residual(p, x, cfg), aux


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer ``i``'s attention window: 0 (global) for the hybrid's global
    layers and for every other decoder, else ``cfg.sliding_window`` (the
    reference's ``_layer_flags``)."""
    if cfg.family == "hybrid" and i not in cfg.global_attn_layers:
        return cfg.sliding_window
    return 0


def _scan_blocks(cfg: ModelConfig, blocks, x: torch.Tensor,
                 remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, aux)`` after every block, the blocks' aux losses summed in
    layer order from a float32 zero (the reference's scan carry)."""
    if remat == "dots":
        raise NotImplementedError(
            "remat 'dots' (save only the matmul outputs) is not ported yet: "
            "ROADMAP queue 1, remat dots")
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be none, full or dots; got {remat!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layers(cfg, blocks)):
        window = layer_window(cfg, i)
        if remat == "full":
            x, a = checkpoint(_block_train, cfg, p, x, window,
                              use_reentrant=False)
        else:
            x, a = _block_train(cfg, p, x, window)
        aux = aux + a
    return x, aux


def _xlstm_group(cfg: ModelConfig, x: torch.Tensor, mlayers, slayer):
    """One group of the xLSTM: its mLSTM blocks, then its sLSTM block
    (none when ``slstm_every`` is 0)."""
    for p in mlayers:
        x = rec.apply_mlstm(p, x, cfg)
    return x if slayer is None else rec.apply_slstm(slayer, x, cfg)


def _xlstm_forward(cfg: ModelConfig, blocks: Params, x: torch.Tensor,
                   remat: str = "none") -> torch.Tensor:
    """G groups of (slstm_every - 1) mLSTM + 1 sLSTM blocks, or only
    mLSTM blocks when ``slstm_every`` is 0; remat ``full`` (and ``dots``,
    as in the reference) checkpoints each group, or each block of the
    mLSTM-only stack."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots; got {remat!r}")
    mlayers = _unstack(blocks["mlstm"])
    every = cfg.slstm_every
    if every:
        slayers = _unstack(blocks["slstm"])
        groups = [(mlayers[g * (every - 1):(g + 1) * (every - 1)], sp)
                  for g, sp in enumerate(slayers)]
    else:
        groups = [([p], None) for p in mlayers]
    for mp, sp in groups:
        if remat == "none":
            x = _xlstm_group(cfg, x, mp, sp)
        else:
            x = checkpoint(_xlstm_group, cfg, x, mp, sp, use_reentrant=False)
    return x


def forward_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``(B, S)`` -> ``(logits (B, S, V) in cfg.dtype, aux loss)``."""
    require_ported(cfg)
    x = embed_tokens(params, cfg, tokens)
    if cfg.family == "ssm":
        x = _xlstm_forward(cfg, params["blocks"], x, remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = _scan_blocks(cfg, params["blocks"], x, remat)
    return lm_logits(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32 over ``batch["tokens"]`` plus the
    aux loss; returns ``(loss, {"loss", "ce", "aux", "tokens"})`` as the
    reference's ``loss_fn`` does (every position counts: the dense, MoE,
    hybrid and xLSTM families have no image-token mask)."""
    tokens = batch["tokens"]
    logits, aux = forward_train(params, cfg, tokens, remat)
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - gold  # (B, S-1)
    denom = torch.tensor(float(max(nll.numel(), 1)), device=nll.device)
    ce = nll.sum() / denom
    total = ce + aux
    return total, {"loss": total, "ce": ce, "aux": aux, "tokens": denom}


# ===========================================================================
# Caches
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device) -> Params:
    """Dense decode cache: ``(L, B, max_seq, KH, Dh)`` K/V + ``pos``."""
    require_ported(cfg, serving=True)
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int,
                     device: torch.device) -> Params:
    """Paged decode cache: global ``(L, KH, num_pages, page, Dh)`` K/V
    pools shared by every slot plus a per-slot ``(batch, max_pages)``
    int32 page table (-1 = unmapped).  Pool page 0 is the engine's null
    page and is never allocated."""
    require_ported(cfg, serving=True)
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
            max_seq: Optional[int] = None,
            lens: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
    """Full forward emitting the dense cache.  Returns (last-token logits
    ``(B, V)``, cache with K/V ``(L, B, max_seq, KH, Dh)``).

    ``lens`` (B,) marks ragged rows of a right-padded batch: logits come
    from position ``lens[b] - 1`` and the cache position is ``lens[b]``,
    so decode's ``kv_len`` masking hides the pad positions' K/V.
    Causality makes every real position independent of the padding."""
    require_ported(cfg, serving=True)
    B, S = tokens.shape
    max_seq = max_seq or S
    x = embed_tokens(params, cfg, tokens)
    cos, sin = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.head_dim, cfg.rope_theta)
    per_layer = layers(cfg, params["blocks"])
    shape = (len(per_layer), B, max_seq, cfg.num_kv_heads, cfg.head_dim)
    kcache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vcache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, p in enumerate(per_layer):
        h = apply_norm(p, "norm1", x, cfg.norm)
        q, k, v = qkv(p, h, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = ops.flash_attention(q, k, v, causal=True)
        x = x + out_proj(p, attn)
        x = _mlp_residual(p, x, cfg)
        kcache[i, :, :S] = k
        vcache[i, :, :S] = v
    if lens is None:
        x_last = x[:, -1:]
        pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    else:
        pos = lens.to(device=x.device, dtype=torch.int32)
        x_last = x[torch.arange(B, device=x.device), pos.long() - 1][:, None]
    logits = lm_logits(params, cfg, x_last)
    return logits[:, 0], {"k": kcache, "v": vcache, "pos": pos}


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """tokens: (B, 1).  Returns (logits (B, V), cache with ``pos + 1``).

    Dispatches on the cache layout: a ``k_pool`` key marks the paged
    cache.  The new token's K/V is written into the given cache in place
    (the reference returns new arrays); the returned dict holds the same
    K/V tensors and the advanced ``pos``."""
    require_ported(cfg, serving=True)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    paged = "k_pool" in cache
    for i, p in enumerate(layers(cfg, params["blocks"])):
        h = apply_norm(p, "norm1", x, cfg.norm)
        if paged:
            attn = attend_decode_paged(p, h, cache["k_pool"][i],
                                       cache["v_pool"][i],
                                       cache["page_table"], pos, cfg)
        else:
            attn = attend_decode(p, h, cache["k"][i], cache["v"][i], pos, cfg)
        x = _mlp_residual(p, x + attn, cfg)
    logits = lm_logits(params, cfg, x)[:, 0]
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
    per-row limits until real tokens overwrite them."""
    require_ported(cfg, serving=True)
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
        x = _mlp_residual(p, x + attn, cfg)
    logits = lm_logits(params, cfg, x)
    return logits, dict(cache, pos=pos + T)
