"""Uniform model API: ``build_model(cfg, device) -> Model``.

Counterpart of the reference package's ``models/api.py``: the train
loss and the serving entry points of every family.  A :class:`Model` dispatches
to ``models/encdec.py`` for the encoder-decoder and to ``models/lm.py``
for the rest, as the reference does.  A :class:`Model` knows its config
and its device; it holds no weights — parameters are passed to each
call, as in the reference, so bridged weights and the port's own init go
through the same calls.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA device with no GPU present
raises instead of falling back.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm, sampling
from repro_torch.tree import unflatten

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run on the CPU")
    return dev


def param_table(cfg: ModelConfig) -> Dict[str, Tuple]:
    """``path -> (shape, init, logical axes)`` of every parameter of
    ``cfg``'s model."""
    if cfg.is_encoder_decoder:
        return encdec.param_table(cfg)
    return lm.param_table(cfg)


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """``path -> (shape, init)`` of every parameter of ``cfg``'s model."""
    if cfg.is_encoder_decoder:
        return encdec.param_shapes(cfg)
    return lm.param_shapes(cfg)


# parameter names (prefixes) that the forward reads in float32, which
# serving keeps in float32: casting them to a narrower dtype first would
# round what the reference reads unrounded
FLOAT32_PARAMS = ("norm", "final", "enc_final", "ln", "headnorm", "router",
                  "w_gates", "r_gates", "b_gates", "ssm_w_B", "ssm_w_C",
                  "ssm_w_dt", "ssm_b_dt", "ssm_A_log", "ssm_D")


class Model:
    def __init__(self, cfg: ModelConfig, device: torch.device):
        lm.require_ported(cfg)
        self.cfg = cfg
        self.device = device

    # ---- init ------------------------------------------------------------
    def init(self, seed: int = 0) -> lm.Params:
        """Fresh parameters in ``cfg.param_dtype`` on the model's device."""
        return lm.init_params(self.cfg, param_shapes(self.cfg), seed,
                              self.device)

    def param_specs(self) -> Tuple[lm.Params, lm.Params]:
        """``(tree of parameters on the meta device, tree of logical-axes
        tuples)`` without allocation, as the reference's
        ``Model.param_specs`` returns shapes and axes."""
        dtype = getattr(torch, self.cfg.param_dtype)
        table = param_table(self.cfg)
        specs = unflatten(
            (path, torch.empty(shape, dtype=dtype, device="meta"))
            for path, (shape, _, _) in table.items())
        return specs, unflatten((path, axes)
                                for path, (_, _, axes) in table.items())

    # ---- train -----------------------------------------------------------
    def loss(self, params: lm.Params, batch, remat: str = "none"):
        """``(loss, metrics)`` of a batch ``{"tokens": (B, S)}`` (plus
        ``frames`` for the encoder-decoder, ``image_embeds`` for the
        VLM): the next-token cross-entropy of
        :func:`repro_torch.models.lm.loss_fn` or
        :func:`repro_torch.models.encdec.loss_fn`, differentiable with
        respect to ``params`` (float32 master weights, cast to
        ``cfg.dtype`` at each use as in the reference)."""
        if self.cfg.is_encoder_decoder:
            return encdec.loss_fn(params, self.cfg, batch, remat)
        return lm.loss_fn(params, self.cfg, batch, remat)

    def serving_params(self, params: lm.Params) -> lm.Params:
        """Weights for serving, made once: every matrix, bias and the
        embedding in ``cfg.dtype`` (numerically what the reference's
        per-use ``.astype(dtype)`` gives), what the forward reads in
        float32 kept in float32 (:data:`FLOAT32_PARAMS`: the norm gains,
        the MoE router, the sLSTM's gates, the SSM's ``A``, ``D``, ``dt``
        and B/C projections), and the stacked blocks (the encoder's, and
        the xLSTM's mLSTM and sLSTM stacks too) split into per-layer
        dicts.  Idempotent: params already prepared come back as they
        are."""
        dt = getattr(torch, self.cfg.dtype)

        def cast(name, x):
            keep = name.startswith(FLOAT32_PARAMS)
            return x.to(self.device, torch.float32 if keep else dt)

        def split(stack):
            return [{k: cast(k, v) for k, v in layer.items()}
                    for layer in lm.layers(self.cfg, stack)]

        stacks = ("blocks", "enc_blocks")
        out = {k: cast(k, v) for k, v in params.items() if k not in stacks}
        for name in stacks:
            if name not in params:
                continue
            if self.cfg.family == "ssm":
                out[name] = {k: split(v) for k, v in params[name].items()}
            else:
                out[name] = split(params[name])
        return out

    # ---- serve -----------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None,
                max_seq: Optional[int] = None,
                lens: Optional[torch.Tensor] = None):
        """Full forward emitting the decode cache.  ``extra`` carries the
        encoder-decoder's ``frames`` or the VLM's ``image_embeds``;
        ``lens`` (B,) enables ragged right-padded batches (see
        :func:`repro_torch.models.lm.prefill`), for the models of
        :meth:`supports_padded_prefill` only."""
        if self.cfg.is_encoder_decoder:
            if lens is not None:
                raise ValueError("padded prefill (lens) is not supported "
                                 "for encoder-decoder models")
            return encdec.prefill(params, self.cfg, tokens, extra or {},
                                  max_seq)
        return lm.prefill(params, self.cfg, tokens, extra, max_seq,
                          lens=lens)

    def decode_step(self, params, cache, tokens: torch.Tensor,
                    kv_blocks: int = 1):
        """One decode step (see :func:`repro_torch.models.lm.decode_step`;
        ``kv_blocks`` reads a decoder's dense cache in that many sequence
        blocks)."""
        if self.cfg.is_encoder_decoder:
            if kv_blocks != 1:
                raise ValueError("the encoder-decoder's cache is read whole")
            return encdec.decode_step(params, self.cfg, cache, tokens)
        return lm.decode_step(params, self.cfg, cache, tokens, kv_blocks)

    def decode_and_sample(self, params, cache, last_token: torch.Tensor, *,
                          seed: int, temperatures, greedy_only: bool = False):
        """One decode step for the whole batch followed by per-slot
        sampling (greedy where ``temperatures[b] <= 0``), returning
        ``((B,) int32 tokens, new cache)``.  Row ``b``'s stream is keyed by
        ``(seed, b, pos[b])``."""
        pos = cache["pos"]
        logits, new_cache = self.decode_step(params, cache, last_token)
        toks = sampling.sample_tokens(
            logits, temperatures, seed=seed, slots=range(logits.shape[0]),
            pos=pos, greedy_only=greedy_only)
        return toks, new_cache

    def supports_padded_prefill(self) -> bool:
        """Whether ragged (right-padded + lens) prefill is exact: for
        pure attention decoders only (recurrent state would carry the pad
        steps, MoE capacity depends on the padded length, and the
        encoder-decoder's prefill takes no lens)."""
        return (not self.cfg.is_encoder_decoder
                and self.cfg.family not in lm.RECURRENT
                and self.cfg.num_experts == 0)

    def verify_step(self, params, cache, tokens: torch.Tensor):
        """Speculative verify: score ``tokens`` ``(B, k+1)`` — the last
        committed token plus k drafts — in one pass, returning
        ``(logits (B, k+1, V), cache with pos + k + 1)``; the engine
        rewinds ``pos`` after acceptance (see
        :func:`repro_torch.models.lm.verify_step`)."""
        if self.cfg.is_encoder_decoder:
            raise ValueError("speculative verify is not supported for "
                             "encoder-decoder models")
        return lm.verify_step(params, self.cfg, cache, tokens)

    def supports_speculative(self) -> bool:
        """Whether draft/verify speculative decoding is exact for this
        model: the decode cache must be position-addressable (dense or
        paged attention K/V) so rejected drafts roll back by a ``pos``
        rewind.  Recurrent state cannot rewind."""
        return (not self.cfg.is_encoder_decoder
                and self.cfg.family not in lm.RECURRENT)

    def supports_paged_cache(self) -> bool:
        """Whether the decode cache can be paged: dense ``{k, v, pos}``
        attention caches only (not recurrent state, not the
        encoder-decoder's cross cache)."""
        return (not self.cfg.is_encoder_decoder
                and self.cfg.family not in lm.RECURRENT)

    def init_cache(self, batch: int, max_seq: int, device=None):
        """The dense decode cache on ``device`` (default: the model's)."""
        device = self.device if device is None else torch.device(device)
        if self.cfg.is_encoder_decoder:
            return encdec.init_cache(self.cfg, batch, max_seq, device)
        return lm.init_cache(self.cfg, batch, max_seq, device)

    def cache_specs(self, batch: int, max_seq: int):
        """The decode cache's tensors on the meta device: shapes and
        dtypes, no allocation."""
        return self.init_cache(batch, max_seq, device="meta")

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Stand-ins on the meta device for every model input of a shape
        cell: ``tokens`` (and ``frames`` or ``image_embeds``) for train
        and prefill, ``tokens`` and the cache for decode."""
        cfg, B = self.cfg, shape.global_batch
        dt = getattr(torch, cfg.dtype)

        def meta(*size, dtype=dt):
            return torch.empty(size, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            specs = {"tokens": meta(B, shape.seq_len, dtype=torch.int32)}
            if cfg.is_encoder_decoder:
                specs["frames"] = meta(B, cfg.encoder_frames, cfg.d_model)
            if cfg.family == "vlm" and cfg.num_image_tokens:
                specs["image_embeds"] = meta(B, cfg.num_image_tokens,
                                             cfg.d_model)
            return specs
        return {"tokens": meta(B, 1, dtype=torch.int32),
                "cache": self.cache_specs(B, shape.seq_len)}

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_pages: int):
        return lm.init_paged_cache(self.cfg, batch, num_pages, page_size,
                                   max_pages, self.device)


def build_model(cfg: ModelConfig, device: Device = None) -> Model:
    """A :class:`Model` on ``device`` (default ``cuda``; raises when no
    GPU is present — pass ``device='cpu'`` for the CPU)."""
    return Model(cfg, resolve_device(device))
