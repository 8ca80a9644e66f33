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
from repro_torch.models.attention import (attend_cross_decode, attend_decode,
                                          attend_prefill, attend_train)
from repro_torch.models.common import apply_norm
from repro_torch.models.lm import (Params, _whole_logits, apply_mlp,
                                   attention_shapes, cache_block,
                                   embed_tokens, layers, lm_logits,
                                   mlp_shapes, norm_shapes, token_nll)
from repro_torch.parallel import fsdp


def param_table(cfg: ModelConfig) -> Dict[str, Tuple]:
    """``path -> (shape, init, logical axes)`` of every parameter, as the
    reference's ``init_encdec`` builds them."""
    D, V = cfg.d_model, cfg.vocab_size
    out = {"embed": ((V, D), "normal", ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((D, V), "normal", ("embed", "vocab"))
    for name in ("final", "enc_final"):
        out[f"{name}_g"] = ((D,), "ones", ("embed",))
        if cfg.norm == "layernorm":
            out[f"{name}_b"] = ((D,), "zeros", ("embed",))
    Le, L = cfg.encoder_layers, cfg.num_layers
    enc = {**norm_shapes(cfg, Le, ("norm1", "norm2")),
           **attention_shapes(cfg, Le), **mlp_shapes(cfg, Le)}
    dec = {**norm_shapes(cfg, L, ("norm1", "norm2", "norm3")),
           **attention_shapes(cfg, L), **attention_shapes(cfg, L, "xattn"),
           **mlp_shapes(cfg, L)}
    out.update({f"enc_blocks/{k}": v for k, v in enc.items()})
    out.update({f"blocks/{k}": v for k, v in dec.items()})
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``path -> (shape, init)`` of every parameter."""
    return {k: (shape, init)
            for k, (shape, init, _) in param_table(cfg).items()}


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """``(..., d)`` float32: sines then cosines of ``positions`` at
    frequencies ``10000 ** (-i / (d/2 - 1))`` (the reference's ``half - 1``
    denominator)."""
    half = d // 2
    dev = positions.device
    log_base = torch.log(torch.full((), 10000.0, device=dev))
    freq = torch.exp(-log_base * torch.arange(half, device=dev,
                                              dtype=torch.float32)
                     / (half - 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """One encoder block (non-causal self-attention, then the MLP), split
    over ``model`` as ``attend_train`` and ``apply_mlp`` say; ``p`` may
    be a layer's slices under the sharded step's gathering."""
    p = fsdp.layer(p)
    h = apply_norm(p, "norm1", x, cfg.norm)
    x = x + attend_train(p, h, cfg, causal=False, use_rope=False)
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
    return apply_norm(fsdp.norm_leaves(params, "enc_final"), "enc_final", x,
                      cfg.norm)


def _dec_embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the sinusoid of ``positions`` (``(S,)`` or
    ``(B, S)``), in ``cfg.dtype``."""
    x = embed_tokens(params, cfg, tokens)
    pe = sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x + (pe[None] if pe.dim() == 2 else pe)


def _dec_block_train(cfg: ModelConfig, p, x: torch.Tensor,
                     enc: torch.Tensor) -> torch.Tensor:
    """One decoder block over the whole sequence (the causal
    self-attention, the cross attention over ``enc``, then the MLP)
    through the train path's attention (``attend_train``: split over
    ``model`` by heads or by the decoder's query rows); ``p`` may be a
    layer's slices under the sharded step's gathering."""
    p = fsdp.layer(p)
    h = apply_norm(p, "norm1", x, cfg.norm)
    x = x + attend_train(p, h, cfg, causal=True, use_rope=False)
    h2 = apply_norm(p, "norm2", x, cfg.norm)
    x = x + attend_train(p, h2, cfg, causal=False, use_rope=False,
                         prefix="xattn", kv=enc)
    return x + apply_mlp(p, apply_norm(p, "norm3", x, cfg.norm), cfg)


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
    denom = torch.full((), float(nll.numel()), device=ce.device)
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
    encoder-decoder's requests by exact length).

    Under the serving split over ``model`` (``serve/sharded.py``) the
    encoder and the decoder are split as the train forward splits them;
    the self-attention cache is this rank's block of the sequence
    (``lm.cache_block``), the cross cache ``xk``/``xv`` is whole and the
    same on every ``model`` rank (every KV head: where the rank projected
    only its heads', all are projected from the encoder's states it holds
    alike, as ``attend_prefill`` does), and the logits come back whole
    over the vocab."""
    B, S = tokens.shape
    max_seq = max_seq or S
    enc = encode(params, cfg, extra["frames"])
    x = _dec_embed(params, cfg, tokens, torch.arange(S, device=tokens.device))
    per_layer = layers(cfg, params["blocks"])
    held, start, n = cache_block(S, max_seq)
    L, T, KH, Dh = len(per_layer), enc.shape[1], cfg.num_kv_heads, \
        cfg.head_dim

    def zeros(s):
        return torch.zeros((L, B, s, KH, Dh), dtype=x.dtype, device=x.device)

    cache = {"k": zeros(held), "v": zeros(held), "xk": zeros(T),
             "xv": zeros(T)}
    for i, p in enumerate(per_layer):
        p = fsdp.layer(p)
        h = apply_norm(p, "norm1", x, cfg.norm)
        attn, k, v = attend_prefill(p, h, cfg, (start, n), use_rope=False)
        x = x + attn
        h2 = apply_norm(p, "norm2", x, cfg.norm)
        xattn, xk, xv = attend_prefill(p, h2, cfg, (0, T), use_rope=False,
                                       prefix="xattn", kv=enc)
        x = x + xattn
        x = x + apply_mlp(p, apply_norm(p, "norm3", x, cfg.norm), cfg)
        cache["k"][i, :, :n] = k
        cache["v"][i, :, :n] = v
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return _whole_logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, kv_blocks: int = 1
                ) -> Tuple[torch.Tensor, Params]:
    """tokens ``(B, 1)`` at each row's ``pos``: ``(logits (B, V), cache
    with pos + 1)``.  The self-attention K/V is written in place; the
    cross cache is read as it is (``attend_cross_decode``).  Under the
    serving split over ``model`` the self-attention cache is this rank's
    block of the sequence (``models/attention.py``'s
    ``_attend_decode_blocks``), the cross cache whole, and the logits
    come back whole over the vocab; ``kv_blocks > 1`` reads a whole
    self-attention cache on one device in that many sequence blocks,
    merged as the split merges its ranks' blocks."""
    pos = cache["pos"]
    x = _dec_embed(params, cfg, tokens, pos[:, None])
    for i, p in enumerate(layers(cfg, params["blocks"])):
        p = fsdp.layer(p)
        h = apply_norm(p, "norm1", x, cfg.norm)
        x = x + attend_decode(p, h, cache["k"][i], cache["v"][i], pos, cfg,
                              use_rope=False, kv_blocks=kv_blocks)
        h2 = apply_norm(p, "norm2", x, cfg.norm)
        x = x + attend_cross_decode(p, h2, cache["xk"][i], cache["xv"][i],
                                    cfg)
        x = x + apply_mlp(p, apply_norm(p, "norm3", x, cfg.norm), cfg)
    logits = _whole_logits(params, cfg, x)[:, 0]
    return logits, dict(cache, pos=pos + 1)
