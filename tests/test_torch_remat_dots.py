"""Remat ``dots`` in the port against the reference, on the CPU.

The reference's ``remat="dots"`` is ``jax.checkpoint`` of each block
under ``checkpoint_dots_with_no_batch_dims``; the port's is a selective
``torch.utils.checkpoint`` of each block under
:func:`repro_torch.models.lm.dots_policy`, which saves the outputs of
the ``aten.mm`` products autograd records (the projections, the FFN,
the router, the SSM's projections) and recomputes the rest.  Each
family's reduced config in float32 (qwen2-1.5b, hymba-1.5b, phi3.5-moe,
phi-3-vision, the states and batches of their own test modules, weights
bridged through numpy):

  * the loss at ``dots`` against ``jax.value_and_grad`` of the
    reference's loss at ``dots``: rtol 1e-5; every gradient leaf within
    1e-4 of that leaf's max |g| (the tolerances of each family's remat
    ``none`` parity: the same sums in other orders);
  * the bytes the forward keeps for the backward lie strictly between
    ``full``'s and ``none``'s, and ``dots`` keeps exactly ``full``'s
    (each block's input) plus the outputs of the block's products,
    counted from the config's shapes.
"""
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import test_torch_hymba
import test_torch_moe
import test_torch_train
import test_torch_vlm
from repro_torch.models import lm, recurrent
from repro_torch.tree import flatten

FAMILIES = {
    "qwen2": (test_torch_train.Ref, test_torch_train._port),
    "hymba": (test_torch_hymba.Ref, test_torch_hymba._port),
    "phi35-moe": (lambda: test_torch_moe.Ref(test_torch_moe.ARCHS[0]),
                  test_torch_moe._port),
    "phi3-vision": (test_torch_vlm.Ref, test_torch_vlm._port),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    make_ref, port = FAMILIES[request.param]
    r = make_ref()
    batch = r.batch(0) if hasattr(r, "batch") else r.stream.batch_at(0)
    return r, port, {k: np.ascontiguousarray(v) for k, v in batch.items()}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_and_gradients_match_reference(family):
    r, port, batch = family
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(
        lambda p: r.model.loss(p, jbatch, remat="dots"), has_aux=True))(
        r.state["params"])
    model, tstate, _ = port(r)
    params = tstate["params"]
    leaves = [p.requires_grad_() for _, p in flatten(params)]
    tl, tmetrics = model.loss(params, _tbatch(batch), remat="dots")
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for name in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmetrics[name]), _np(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=key)


def _product_widths(cfg):
    """Output widths of one block's ``aten.mm`` products, row by row
    (``B * S`` rows each): the attention's q, k, v and output
    projections; the MLP's gate (SiLU), up and down, or the MoE router;
    the hybrid's SSM in, z, B, C, both dt and out projections."""
    D, F, KH, Dh = cfg.d_model, cfg.d_ff, cfg.num_kv_heads, cfg.head_dim
    widths = [cfg.num_heads * Dh, KH * Dh, KH * Dh, D]
    if cfg.num_experts:
        widths.append(cfg.num_experts)
    elif F:
        widths += [F, F, D] if cfg.act == "silu" else [F, D]
    if cfg.family == "hybrid":
        din, N, rank = recurrent.ssm_dims(cfg)
        widths += [din, din, N, N, rank, din, D]
    return widths


def _kept_bytes(model, params, batch, remat):
    """``(outside, block inputs, saved products)`` bytes the forward keeps
    for the backward, each storage once and the parameters left out:
    what autograd saves outside a checkpointed block (everything, for
    ``none``), each checkpointed block's input, and the outputs the
    ``dots`` policy saves."""
    skip = {p.untyped_storage().data_ptr() for _, p in flatten(params)}
    seen, kept = set(), {"outside": 0, "inputs": 0, "products": 0}

    def keep(t, part):
        s = t.untyped_storage()
        if s.data_ptr() not in skip | seen:
            seen.add(s.data_ptr())
            kept[part] += s.nbytes()

    def pack(t):
        keep(t, "outside")
        return t

    real_checkpoint, real_policy = lm.checkpoint, lm.dots_policy

    def checkpoint(fn, cfg, p, x, *args, **kwargs):
        keep(x, "inputs")
        return real_checkpoint(fn, cfg, p, x, *args, **kwargs)

    def policy(ctx, func, *args, **kwargs):
        out = real_policy(ctx, func, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            keep(ctx.op_output, "products")
        return out

    with mock.patch.object(lm, "checkpoint", checkpoint), \
            mock.patch.object(lm, "dots_policy", policy), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(params, batch, remat=remat)
    torch.autograd.grad(loss, [p for _, p in flatten(params)])
    return kept


def test_saved_bytes_lie_between_full_and_none(family):
    r, port, batch = family
    model, tstate, _ = port(r)
    params = tstate["params"]
    for _, p in flatten(params):
        p.requires_grad_()
    kept = {remat: _kept_bytes(model, params, _tbatch(batch), remat)
            for remat in ("none", "full", "dots")}
    total = {k: sum(v.values()) for k, v in kept.items()}
    assert total["full"] < total["dots"] < total["none"], total
    cfg = model.cfg
    B, S = batch["tokens"].shape
    rows, L = B * S, cfg.num_layers
    assert kept["full"]["products"] == 0
    assert kept["dots"]["outside"] == kept["full"]["outside"]
    assert kept["dots"]["inputs"] == kept["full"]["inputs"] \
        == L * rows * cfg.d_model * 4
    assert kept["dots"]["products"] == L * rows * sum(_product_widths(cfg)) * 4
