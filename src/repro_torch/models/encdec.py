"""Whisper-style encoder-decoder (the audio family).

Counterpart of the reference package's ``models/encdec.py``.  The
audio frontend is a stub there and here: the inputs carry precomputed
frame embeddings ``extra["frames"]`` ``(B, T, d_model)``.  Both stacks
take sinusoidal positions (no parameters, no RoPE): the encoder over its
``T`` frames, the decoder over its token positions.

Every attention of the train path and of prefill goes through
:func:`repro_torch.kernels.ops.flash_attention` (K1 forward, K1-bwd
backward on the card): the encoder's self-attention and the decoder's
cross attention non-causal, the decoder's self-attention causal.  The
decode step reads its self-attention cache through the dense decode read
(written in place at ``pos``, no RoPE) and its cross cache ``xk``/``xv``
through the same plain read over all ``T`` frames, as the reference does
on every backend.

The reference's ``scan`` over stacked layers is a Python loop here.
Remat ``"full"`` (and ``"dots"``, which the reference treats as
``"full"`` here) checkpoints each decoder block; the encoder is not
rematerialised, as in the reference, whose ``jax.checkpoint`` wraps only
the decoder scan's body.

Parameters keep the reference's tree: ``embed`` (the tied head),
``final_g``/``final_b``, ``enc_final_g``/``enc_final_b``, ``enc_blocks``
(norms, ``attn_*``, ``mlp_*``) and ``blocks`` (three norms, ``attn_*``,
the cross attention's ``xattn_*``, ``mlp_*``), each block entry with a
leading layer axis (or, after
:meth:`repro_torch.models.api.Model.serving_params`, a list of per-layer
dicts).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import (_proj, attend_decode, cross_kv,
                                          out_proj, qkv)
from repro_torch.models.common import apply_norm
from repro_torch.models.lm import (Params, apply_mlp, attention_shapes,
                                   embed_tokens, layers, lm_logits,
                                   mlp_shapes, norm_shapes, token_nll)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``path -> (shape, init)`` of every parameter, as the reference's
    ``init_encdec`` builds them."""
    D, V = cfg.d_model, cfg.vocab_size
    out = {"embed": ((V, D), "normal")}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((D, V), "normal")
    for name in ("final", "enc_final"):
        out[f"{name}_g"] = ((D,), "ones")
        if cfg.norm == "layernorm":
            out[f"{name}_b"] = ((D,), "zeros")
    Le, L = cfg.encoder_layers, cfg.num_layers
    enc = {**norm_shapes(cfg, Le, ("norm1", "norm2")),
           **attention_shapes(cfg, Le), **mlp_shapes(cfg, Le)}
    dec = {**norm_shapes(cfg, L, ("norm1", "norm2", "norm3")),
           **attention_shapes(cfg, L), **attention_shapes(cfg, L, "xattn"),
           **mlp_shapes(cfg, L)}
    out.update({f"enc_blocks/{k}": v for k, v in enc.items()})
    out.update({f"blocks/{k}": v for k, v in dec.items()})
    return out


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """``(..., d)`` float32: sines then cosines of ``positions`` at
    frequencies ``10000 ** (-i / (d/2 - 1))`` (the reference's ``half - 1``
    denominator)."""
    half = d // 2
    dev = positions.device
    log_base = torch.log(torch.tensor(10000.0, device=dev))
    freq = torch.exp(-log_base * torch.arange(half, device=dev,
                                              dtype=torch.float32)
                     / (half - 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p, "norm1", x, cfg.norm)
    q, k, v = qkv(p, h, cfg)
    x = x + out_proj(p, ops.flash_attention(q, k, v, causal=False))
    return x + apply_mlp(p, apply_norm(p, "norm2", x, cfg.norm), cfg)


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames ``(B, T, D)`` stub embeddings -> encoder states ``(B, T, D)``
    in ``cfg.dtype``."""
    dt = getattr(torch, cfg.dtype)
    T = frames.shape[1]
    pe = sinusoidal(torch.arange(T, device=frames.device), cfg.d_model)
    x = frames.to(dt) + pe[None].to(dt)
    for p in layers(cfg, params["enc_blocks"]):
        x = _enc_block(cfg, p, x)
    return apply_norm(params, "enc_final", x, cfg.norm)


def _dec_embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the sinusoid of ``positions`` (``(S,)`` or
    ``(B, S)``), in ``cfg.dtype``."""
    x = embed_tokens(params, cfg, tokens)
    pe = sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x + (pe[None] if pe.dim() == 2 else pe)


def _dec_block(cfg: ModelConfig, p, x: torch.Tensor, enc: torch.Tensor
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One decoder block over the whole sequence: ``(x, (k, v, xk, xv))``,
    the self-attention's K/V and the cross attention's K/V of ``enc``."""
    h = apply_norm(p, "norm1", x, cfg.norm)
    q, k, v = qkv(p, h, cfg)
    x = x + out_proj(p, ops.flash_attention(q, k, v, causal=True))
    h2 = apply_norm(p, "norm2", x, cfg.norm)
    xk, xv = cross_kv(p, enc)
    qx = _proj(h2, p["xattn_wq"])
    xout = ops.flash_attention(qx, xk, xv, causal=False)
    x = x + out_proj(p, xout, prefix="xattn")
    x = x + apply_mlp(p, apply_norm(p, "norm3", x, cfg.norm), cfg)
    return x, (k, v, xk, xv)


def _dec_block_train(cfg, p, x, enc):
    return _dec_block(cfg, p, x, enc)[0]


def forward_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  extra: Dict[str, torch.Tensor], remat: str = "none"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``(B, S)`` decoder tokens, ``extra["frames"]`` ``(B, T, D)``
    -> ``(logits (B, S, V) in cfg.dtype, a float32 zero aux loss)``."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots; got {remat!r}")
    enc = encode(params, cfg, extra["frames"])
    x = _dec_embed(params, cfg, tokens,
                   torch.arange(tokens.shape[1], device=tokens.device))
    for p in layers(cfg, params["blocks"]):
        if remat == "none":
            x = _dec_block_train(cfg, p, x, enc)
        else:
            x = checkpoint(_dec_block_train, cfg, p, x, enc,
                           use_reentrant=False)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_logits(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: str = "none"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32 over every decoder position;
    ``(loss, {"loss", "ce", "aux", "tokens"})`` as the reference's."""
    tokens = batch["tokens"]
    logits, aux = forward_train(params, cfg, tokens, batch, remat)
    nll = token_nll(logits, tokens)
    ce = nll.mean()
    denom = torch.tensor(float(nll.numel()), device=ce.device)
    return ce, {"loss": ce, "ce": ce, "aux": aux, "tokens": denom}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device) -> Params:
    """Decode cache: self-attention K/V ``(L, B, max_seq, KH, Dh)``, the
    cross cache ``xk``/``xv`` ``(L, B, T, KH, Dh)`` and ``pos``."""
    dt = getattr(torch, cfg.dtype)
    L, KH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(s):
        return torch.zeros((L, batch, s, KH, Dh), dtype=dt, device=device)

    return {"k": zeros(max_seq), "v": zeros(max_seq),
            "xk": zeros(cfg.encoder_frames), "xv": zeros(cfg.encoder_frames),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Dict[str, torch.Tensor], max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Encode the frames, run the decoder over the whole prompt, and emit
    the cache: ``(last-token logits (B, V), cache)``.  Every row is a
    full-length prompt (no padded ``lens``: the engine groups the
    encoder-decoder's requests by exact length)."""
    B, S = tokens.shape
    max_seq = max_seq or S
    enc = encode(params, cfg, extra["frames"])
    x = _dec_embed(params, cfg, tokens, torch.arange(S, device=tokens.device))
    cache = init_cache(cfg, B, max_seq, x.device)
    for i, p in enumerate(layers(cfg, params["blocks"])):
        x, (k, v, xk, xv) = _dec_block(cfg, p, x, enc)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    cache["pos"].fill_(S)
    return lm_logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """tokens ``(B, 1)`` at each row's ``pos``: ``(logits (B, V), cache
    with pos + 1)``.  The self-attention K/V is written in place; the
    cross cache is read as it is."""
    pos = cache["pos"]
    B = tokens.shape[0]
    x = _dec_embed(params, cfg, tokens, pos[:, None])
    T = cache["xk"].shape[2]
    xlen = torch.full((B,), T, dtype=torch.int32, device=x.device)
    for i, p in enumerate(layers(cfg, params["blocks"])):
        h = apply_norm(p, "norm1", x, cfg.norm)
        x = x + attend_decode(p, h, cache["k"][i], cache["v"][i], pos, cfg,
                              use_rope=False)
        h2 = apply_norm(p, "norm2", x, cfg.norm)
        qx = _proj(h2, p["xattn_wq"])
        xout = ops.decode_attention(qx, cache["xk"][i], cache["xv"][i],
                                    kv_len=xlen)
        x = x + out_proj(p, xout, prefix="xattn")
        x = x + apply_mlp(p, apply_norm(p, "norm3", x, cfg.norm), cfg)
    logits = lm_logits(params, cfg, x)[:, 0]
    return logits, dict(cache, pos=pos + 1)
