"""Model configuration for the PyTorch port.

A copy of the reference package's ``ModelConfig``, ``ShapeConfig`` and
``reduced``: the port imports nothing of the JAX package, so the fields,
their defaults and the reduction rule are kept here verbatim (a config
built by either package describes the same model).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters."""

    name: str
    family: str  # dense | moe | audio | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # Derived / optional
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (gated) | gelu
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # Encoder-decoder (audio family)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1500

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0
    sliding_window: int = 0
    global_attn_layers: Tuple[int, ...] = ()

    # VLM
    num_image_tokens: int = 0

    # Numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Parameters, by the reference's formulas: a dense decoder
        (embedding, blocks, final norm, untied head), an MoE decoder (the
        same with the router and the gated experts in place of the MLP),
        the hybrid (each block's attention, mamba heads, MLP, norms and
        one fuse vector, as the reference counts them), or the xLSTM
        (``family="ssm"``) — for the xLSTM its per-layer average, rounded
        down, times the layers, as the reference reports it; an
        encoder-decoder adds each decoder block's cross-attention and
        norm and its encoder blocks."""
        d, v = self.d_model, self.vocab_size
        head = 0 if self.tie_embeddings else v * d
        final = d * (2 if self.norm == "layernorm" else 1)
        if self.family == "ssm":
            if self.slstm_every:
                n_s = self.num_layers // self.slstm_every
                n_m = self.num_layers - n_s
            else:
                n_m, n_s = self.num_layers, 0
            total = (n_m * self._mlstm_block_params()
                     + n_s * self._slstm_block_params())
            return (v * d + head + self.num_layers
                    * (total // self.num_layers) + final)
        norms = 2 * d * (2 if self.norm == "layernorm" else 1)
        ffn = (self._moe_params() if self.num_experts > 0
               else self._mlp_params())
        block = self._attn_params() + ffn + norms
        if self.family == "hybrid":
            block += self._ssm_params() + d
        enc = 0
        if self.is_encoder_decoder:  # cross-attention and its norm
            block += self._attn_params() + final
            enc = self.encoder_layers * (self._attn_params()
                                         + self._mlp_params() + 4 * d)
        return v * d + head + self.num_layers * block + enc + final

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts active),
        by the reference's formula; the cost model reads it."""
        if self.num_experts == 0:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.num_layers * self._moe_params()
        return dense + self.num_layers * (
            d * self.num_experts + self.top_k * 3 * d * self.d_ff)

    def _attn_params(self) -> int:
        d = self.d_model
        p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        return p

    def _mlp_params(self) -> int:
        if self.d_ff == 0:
            return 0
        return (3 if self.act == "silu" else 2) * self.d_model * self.d_ff

    def _moe_params(self) -> int:
        """The router and the gated experts (up, gate, down each)."""
        d = self.d_model
        return d * self.num_experts + self.num_experts * 3 * d * self.d_ff

    def _ssm_params(self) -> int:
        """Mamba-style heads of a hybrid block, as the reference counts
        them (its B, C and dt projections simplified to ``2 N + 1``
        vectors a channel; the tree's low-rank dt has more)."""
        d = self.d_model
        d_in = self.ssm_expand * d
        return (d * 2 * d_in  # in_proj (x and z branches)
                + d_in * self.ssm_conv  # depthwise conv
                + d_in * (2 * self.ssm_state + 1)  # B, C, dt projections
                + d_in * self.ssm_state  # A (log)
                + d_in  # D skip
                + d_in * d)  # out_proj

    def _mlstm_block_params(self) -> int:
        d, h = self.d_model, self.num_heads
        d_in = 2 * d
        dh = d_in // h
        return (2 * d  # layernorm
                + 2 * d * d_in  # up proj (x, z)
                + 3 * h * dh * dh  # q, k, v block-diagonal per head
                + 2 * d_in * h + 2 * h  # i/f gate projections + biases
                + d_in  # headnorm
                + d_in * d)  # down proj

    def _slstm_block_params(self) -> int:
        d, h = self.d_model, self.num_heads
        dh = d // h
        fs = int(math.ceil(d * 4 / 3 / 64) * 64)
        return (4 * d  # two layernorms
                + d * 4 * d  # gate input projections
                + h * 4 * dh * dh  # recurrent per-head
                + 4 * d  # gate biases
                + d  # headnorm
                + 3 * d * fs)  # gated FFN


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length, global batch and kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


def reduced(model: ModelConfig, **overrides) -> ModelConfig:
    """Build the family-faithful reduced config used by smoke tests."""
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(model.num_kv_heads, 2)),
        d_ff=0 if model.d_ff == 0 else 128,
        vocab_size=256,
        head_dim=16,
        encoder_layers=2 if model.is_encoder_decoder else 0,
        encoder_frames=8,
        num_experts=4 if model.num_experts else 0,
        top_k=min(model.top_k, 2) if model.num_experts else 0,
        num_image_tokens=4 if model.num_image_tokens else 0,
        sliding_window=16 if model.sliding_window else 0,
        global_attn_layers=(0,) if model.global_attn_layers else (),
        slstm_every=2 if model.slstm_every else 0,
        name=model.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(model, **small)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention; skip for pure full-attention
    archs (the reference's rule, DESIGN.md §5)."""
    if shape.name == "long_500k" and model.family not in ("ssm", "hybrid"):
        return False, "long_500k skipped: pure full-attention arch (O(S^2))"
    return True, ""
