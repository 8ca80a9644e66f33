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
        """Parameters of the families the port builds: a dense decoder
        (embedding, blocks, final norm, untied head) or the xLSTM
        (``family="ssm"``), by the reference's formulas — for the xLSTM its
        per-layer average, rounded down, times the layers, as the
        reference reports it."""
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
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        mlp = (3 if self.act == "silu" else 2) * d * self.d_ff
        norms = 2 * d * (2 if self.norm == "layernorm" else 1)
        return v * d + head + self.num_layers * (attn + mlp + norms) + final

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
