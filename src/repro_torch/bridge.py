"""Weight bridge: the reference package's parameter tree -> the port's.

:func:`from_jax_params` takes the tree that the reference's
``Model.init`` returns, already turned into numpy arrays by the caller
(``jax.tree.map(np.asarray, params)``), and maps it by name onto the
port's parameters; :func:`from_jax_train_state` does the same for the
reference's whole train state (parameters, AdamW moments and counts).
Both take numpy only, so the port never imports JAX; only the parity
tests hold both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import require_dense

BLOCK_KEYS = ("norm1_g", "norm2_g", "norm1_b", "norm2_b",
              "attn_wq", "attn_wk", "attn_wv", "attn_wo",
              "attn_bq", "attn_bk", "attn_bv",
              "mlp_wg", "mlp_wu", "mlp_wd")
TOP_KEYS = ("embed", "lm_head", "final_g", "final_b")


def _tensor(name: str, x) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (numpy's ml_dtypes
    extension type) by their 16-bit view."""
    if not isinstance(x, np.ndarray):
        raise TypeError(f"{name}: expected a numpy array, got "
                        f"{type(x).__name__}")
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(x.view(np.int16), copy=True)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device, dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Any]:
    """Map a numpy copy of the reference parameter tree to the port's
    tree: ``embed``, ``final_g`` (and ``lm_head``/``final_b`` where the
    config has them) and ``blocks/{...}`` with the leading layer axis.
    ``dtype`` casts every tensor (default: keep each array's dtype).
    Raises on a missing or unexpected key, or a shape that does not fit
    the config."""
    require_dense(cfg)

    def conv(name, x):
        t = _tensor(name, x).to(device)
        return t if dtype is None else t.to(dtype)

    extra = set(tree) - set(TOP_KEYS) - {"blocks"}
    bextra = set(tree["blocks"]) - set(BLOCK_KEYS)
    if extra or bextra:
        raise KeyError(f"unexpected parameters: {sorted(extra | bextra)}")
    out = {k: conv(k, v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = {k: conv(f"blocks/{k}", v)
                     for k, v in tree["blocks"].items()}

    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    want = {"embed": (V, D), "final_g": (D,),
            "blocks/attn_wq": (L, D, H, Dh), "blocks/attn_wk": (L, D, KH, Dh),
            "blocks/attn_wv": (L, D, KH, Dh), "blocks/attn_wo": (L, H, Dh, D),
            "blocks/norm1_g": (L, D), "blocks/norm2_g": (L, D)}
    if cfg.qkv_bias:
        want.update({"blocks/attn_bq": (L, H, Dh),
                     "blocks/attn_bk": (L, KH, Dh),
                     "blocks/attn_bv": (L, KH, Dh)})
    if cfg.d_ff > 0:
        want.update({"blocks/mlp_wu": (L, D, cfg.d_ff),
                     "blocks/mlp_wd": (L, cfg.d_ff, D)})
        if cfg.act == "silu":
            want["blocks/mlp_wg"] = (L, D, cfg.d_ff)
    if not cfg.tie_embeddings:
        want["lm_head"] = (D, V)
    for name, shape in want.items():
        top, _, sub = name.partition("/")
        t = out["blocks"].get(sub) if sub else out.get(top)
        if t is None:
            raise KeyError(f"missing parameter {name}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    return out


def from_jax_train_state(tree: Dict[str, Any], cfg: ModelConfig,
                         device) -> Dict[str, Any]:
    """Map a numpy copy of the reference's train state
    ``{"params", "opt": {"m", "v", "count"}, "step"}`` (what its
    ``init_train_state`` builds and its train step returns) onto the
    port's: parameters and both moments by :func:`from_jax_params`, each
    array keeping its dtype (float32 or bfloat16 moments), the counts as
    int32 scalars."""
    extra = set(tree) - {"params", "opt", "step"}
    if extra:
        raise KeyError(f"unexpected train-state entries: {sorted(extra)} "
                       f"(gradient compression is not ported)")
    opt = tree["opt"]
    return {
        "params": from_jax_params(tree["params"], cfg, device),
        "opt": {"m": from_jax_params(opt["m"], cfg, device),
                "v": from_jax_params(opt["v"], cfg, device),
                "count": _tensor("opt/count", np.asarray(opt["count"])).to(
                    device, torch.int32)},
        "step": _tensor("step", np.asarray(tree["step"])).to(device,
                                                             torch.int32),
    }
