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
from repro_torch.models.api import param_shapes
from repro_torch.tree import flatten, unflatten


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
    tree, path by path (:func:`repro_torch.models.api.param_shapes`):
    ``embed``, ``final_g`` (and ``lm_head``/``final_b`` where the config
    has them) and ``blocks/...`` with the leading layer axis — for the
    hybrid also every ``blocks/ssm_*`` and ``blocks/fuse_*`` leaf, for the
    xLSTM the nested ``blocks/mlstm/...`` and ``blocks/slstm/...``, for
    the encoder-decoder also ``enc_final_*``, ``enc_blocks/...`` and the
    decoder blocks' ``xattn_*`` and ``norm3_*`` (the VLM's tree is the
    dense one).
    ``dtype`` casts every tensor (default: keep each array's dtype).
    Raises on a missing or unexpected key, or a shape that does not fit
    the config."""
    want = {path: shape for path, (shape, _) in param_shapes(cfg).items()}
    got = dict(flatten(tree))
    extra, missing = set(got) - set(want), set(want) - set(got)
    if extra:
        raise KeyError(f"unexpected parameters: {sorted(extra)}")
    if missing:
        raise KeyError(f"missing parameters: {sorted(missing)}")
    out = []
    for path, x in got.items():
        t = _tensor(path, x).to(device)
        if tuple(t.shape) != want[path]:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{want[path]}")
        out.append((path, t if dtype is None else t.to(dtype)))
    return unflatten(out)


def from_jax_train_state(tree: Dict[str, Any], cfg: ModelConfig,
                         device) -> Dict[str, Any]:
    """Map a numpy copy of the reference's train state
    ``{"params", "opt": {"m", "v", "count"}, "step"}`` (and
    ``"grad_err"`` under gradient compression; what its
    ``init_train_state`` builds and its train step returns) onto the
    port's: parameters, both moments and the compression's error by
    :func:`from_jax_params`, each array keeping its dtype (float32 or
    bfloat16 moments), the counts as int32 scalars."""
    extra = set(tree) - {"params", "opt", "step", "grad_err"}
    if extra:
        raise KeyError(f"unexpected train-state entries: {sorted(extra)}")
    opt = tree["opt"]
    out = {
        "params": from_jax_params(tree["params"], cfg, device),
        "opt": {"m": from_jax_params(opt["m"], cfg, device),
                "v": from_jax_params(opt["v"], cfg, device),
                "count": _tensor("opt/count", np.asarray(opt["count"])).to(
                    device, torch.int32)},
        "step": _tensor("step", np.asarray(tree["step"])).to(device,
                                                             torch.int32),
    }
    if "grad_err" in tree:
        out["grad_err"] = from_jax_params(tree["grad_err"], cfg, device)
    return out
