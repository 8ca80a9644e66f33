"""Uniform model API: ``build_model(cfg, device) -> Model``.

Counterpart of the reference package's ``models/api.py`` for the train
loss (dense decoders and the xLSTM) and the serving entry points (dense
decoders).  A :class:`Model` knows its config
and its device; it holds no weights — parameters are passed to each
call, as in the reference, so bridged weights and the port's own init go
through the same calls.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA device with no GPU present
raises instead of falling back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm, sampling

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run on the CPU")
    return dev


class Model:
    def __init__(self, cfg: ModelConfig, device: torch.device):
        lm.require_ported(cfg)
        self.cfg = cfg
        self.device = device

    # ---- init ------------------------------------------------------------
    def init(self, seed: int = 0) -> lm.Params:
        """Fresh parameters in ``cfg.param_dtype`` on the model's device."""
        return lm.init_lm(self.cfg, seed, self.device)

    # ---- train -----------------------------------------------------------
    def loss(self, params: lm.Params, batch, remat: str = "none"):
        """``(loss, metrics)`` of a batch ``{"tokens": (B, S)}``: the
        next-token cross-entropy of :func:`repro_torch.models.lm.loss_fn`,
        differentiable with respect to ``params`` (float32 master
        weights, cast to ``cfg.dtype`` at each use as in the reference)."""
        return lm.loss_fn(params, self.cfg, batch, remat)

    def serving_params(self, params: lm.Params) -> lm.Params:
        """Weights for serving, made once: every matrix, bias and the
        embedding in ``cfg.dtype`` (numerically what the reference's
        per-use ``.astype(dtype)`` gives), norm gains kept in float32, and
        the stacked blocks split into per-layer dicts.  Idempotent: params
        already prepared come back as they are.  Dense decoders only: the
        xLSTM's serving is not ported."""
        lm.require_ported(self.cfg, serving=True)
        dt = getattr(torch, self.cfg.dtype)

        def cast(name, x):
            keep = name.startswith(("norm", "final"))
            return x.to(self.device, torch.float32 if keep else dt)

        out = {k: cast(k, v) for k, v in params.items() if k != "blocks"}
        out["blocks"] = [{k: cast(k, v) for k, v in layer.items()}
                         for layer in lm.layers(self.cfg, params["blocks"])]
        return out

    # ---- serve -----------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor,
                max_seq: Optional[int] = None,
                lens: Optional[torch.Tensor] = None):
        """Full forward emitting the dense cache; ``lens`` (B,) enables
        ragged right-padded batches (see :func:`repro_torch.models.lm.prefill`)."""
        return lm.prefill(params, self.cfg, tokens, max_seq, lens=lens)

    def decode_step(self, params, cache, tokens: torch.Tensor):
        return lm.decode_step(params, self.cfg, cache, tokens)

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
        """Ragged (right-padded + lens) prefill is exact for pure attention
        models, the only ones the port builds."""
        return (not self.cfg.is_encoder_decoder
                and self.cfg.family not in ("ssm", "hybrid")
                and self.cfg.num_experts == 0)

    def verify_step(self, params, cache, tokens: torch.Tensor):
        """Speculative verify: score ``tokens`` ``(B, k+1)`` — the last
        committed token plus k drafts — in one pass, returning
        ``(logits (B, k+1, V), cache with pos + k + 1)``; the engine
        rewinds ``pos`` after acceptance (see
        :func:`repro_torch.models.lm.verify_step`)."""
        return lm.verify_step(params, self.cfg, cache, tokens)

    def supports_speculative(self) -> bool:
        """Whether draft/verify speculative decoding is exact for this
        model: the decode cache must be position-addressable (dense or
        paged attention K/V) so rejected drafts roll back by a ``pos``
        rewind.  Recurrent state cannot rewind."""
        return (not self.cfg.is_encoder_decoder
                and self.cfg.family not in ("ssm", "hybrid"))

    def supports_paged_cache(self) -> bool:
        return (not self.cfg.is_encoder_decoder
                and self.cfg.family not in ("ssm", "hybrid"))

    def init_cache(self, batch: int, max_seq: int):
        return lm.init_cache(self.cfg, batch, max_seq, self.device)

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_pages: int):
        return lm.init_paged_cache(self.cfg, batch, num_pages, page_size,
                                   max_pages, self.device)


def build_model(cfg: ModelConfig, device: Device = None) -> Model:
    """A :class:`Model` on ``device`` (default ``cuda``; raises when no
    GPU is present — pass ``device='cpu'`` for the CPU)."""
    return Model(cfg, resolve_device(device))
