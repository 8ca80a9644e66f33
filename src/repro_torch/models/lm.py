"""Decoder-only language model, dense branch.

Counterpart of the reference package's ``models/lm.py`` for
``family="dense"``: init, embedding and tied/untied head, the gated MLP,
the train forward and the next-token loss, the dense and paged decode
caches, ragged prefill, and the decode and speculative verify steps on
both caches.  The reference's ``scan`` over stacked layers is a Python
loop here.  Other families raise ``NotImplementedError``.

The train path (``forward_train``/``loss_fn``) has no counterpart of the
reference's ``hints.*`` calls: those pin activations and logits to a
device mesh's shardings, and the port runs on one card with no mesh
(parallelism is ROADMAP queue 1, item 10).  Remat ``"full"`` is
``torch.utils.checkpoint`` (non-reentrant) around each block, the
reference's ``jax.checkpoint`` of the scan body.

Parameters keep the reference's tree and shapes: ``embed``,
``final_g``, and ``blocks`` with a leading layer axis on every entry.
``blocks`` may also be a list of per-layer dicts (what
:meth:`repro_torch.models.api.Model.serving_params` prepares once, so a
decode step does not re-slice the stacked tensors).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import (attend_decode, attend_decode_paged,
                                          attend_train, attend_verify,
                                          attend_verify_paged, out_proj, qkv)
from repro_torch.models.common import (activation, apply_norm, apply_rope,
                                       init_param, rope_angles)

Params = Dict[str, Any]


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_encoder_decoder or cfg.num_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} of {cfg.name!r} is not ported to "
            f"PyTorch yet: only the dense decoder is (ROADMAP queue 1, "
            f"item 11 lists the other families)")


# ===========================================================================
# Init
# ===========================================================================
def init_lm(cfg: ModelConfig, seed: int, device: torch.device) -> Params:
    """Parameters with the reference's names and shapes, drawn as
    :func:`repro_torch.models.common.init_param` says, in
    ``cfg.param_dtype``."""
    require_dense(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    L, D, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def p(name, shape, init="normal"):
        return init_param(name, shape, seed=seed, device=device, dtype=dtype,
                          init=init)

    params: Params = {"embed": p("embed", (V, D))}
    if not cfg.tie_embeddings:
        params["lm_head"] = p("lm_head", (D, V))
    params["final_g"] = p("final_g", (D,), "ones")
    if cfg.norm == "layernorm":
        params["final_b"] = p("final_b", (D,), "zeros")

    shapes = {
        "norm1_g": ((L, D), "ones"), "norm2_g": ((L, D), "ones"),
        "attn_wq": ((L, D, H, Dh), "normal"),
        "attn_wk": ((L, D, KH, Dh), "normal"),
        "attn_wv": ((L, D, KH, Dh), "normal"),
        "attn_wo": ((L, H, Dh, D), "normal"),
    }
    if cfg.norm == "layernorm":
        shapes.update(norm1_b=((L, D), "zeros"), norm2_b=((L, D), "zeros"))
    if cfg.qkv_bias:
        shapes.update(attn_bq=((L, H, Dh), "zeros"),
                      attn_bk=((L, KH, Dh), "zeros"),
                      attn_bv=((L, KH, Dh), "zeros"))
    if cfg.d_ff > 0:
        if cfg.act == "silu":
            shapes["mlp_wg"] = ((L, D, F), "normal")
        shapes.update(mlp_wu=((L, D, F), "normal"), mlp_wd=((L, F, D), "normal"))
    params["blocks"] = {name: p(f"blocks/{name}", shape, init)
                        for name, (shape, init) in shapes.items()}
    return params


def layers(cfg: ModelConfig, blocks) -> List[Dict[str, torch.Tensor]]:
    """Per-layer parameter dicts (views of the stacked tensors, by
    ``unbind``, whose gradient is one stack of the layers' gradients)."""
    if isinstance(blocks, list):
        return blocks
    per = {k: v.unbind(0) for k, v in blocks.items()}
    return [{k: per[k][i] for k in per} for i in range(cfg.num_layers)]


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
                 x: torch.Tensor) -> torch.Tensor:
    """One dense decoder block of the train path (its MoE aux loss is 0)."""
    h = apply_norm(p, "norm1", x, cfg.norm)
    x = x + attend_train(p, h, cfg, causal=True)
    return _mlp_residual(p, x, cfg)


def _scan_blocks(cfg: ModelConfig, blocks, x: torch.Tensor,
                 remat: str = "none") -> torch.Tensor:
    if remat == "dots":
        raise NotImplementedError(
            "remat 'dots' (save only the matmul outputs) is not ported yet: "
            "ROADMAP queue 1, remat dots")
    if remat not in ("none", "full"):
        raise ValueError(f"remat must be none, full or dots; got {remat!r}")
    for p in layers(cfg, blocks):
        if remat == "full":
            x = checkpoint(_block_train, cfg, p, x, use_reentrant=False)
        else:
            x = _block_train(cfg, p, x)
    return x


def forward_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``(B, S)`` -> ``(logits (B, S, V) in cfg.dtype, aux loss)``."""
    require_dense(cfg)
    x = embed_tokens(params, cfg, tokens)
    x = _scan_blocks(cfg, params["blocks"], x, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_logits(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32 over ``batch["tokens"]`` plus the
    aux loss; returns ``(loss, {"loss", "ce", "aux", "tokens"})`` as the
    reference's ``loss_fn`` does (every position counts: the dense family
    has no image-token mask)."""
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
    require_dense(cfg)
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
    require_dense(cfg)
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
    require_dense(cfg)
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
    require_dense(cfg)
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
    require_dense(cfg)
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
