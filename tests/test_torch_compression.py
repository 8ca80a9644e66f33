"""The port's gradient compression against the reference's, on the CPU.

Tolerances, each with its reason:

  * ``quantize_int8``, ``dequantize_int8``, ``compress_residual`` and
    ``reduce_stacked`` (2 and 4 workers): bit for bit (the same float32
    operations in the same order);
  * ``compressed_psum`` on a spawned gloo world of 2: bit for bit against
    ``reduce_stacked`` (a sum of two is exact in either order);
  * a 3-step ``compress_grads`` train of reduced qwen2-1.5b in float32
    (the port's step against the reference's): the loss and the other
    metrics rtol 1e-5; the parameters and moments within 1e-5 of each
    leaf's max |x|; ``grad_err`` within 1e-5 of the max |g + e| it was
    quantized from (254 times its own max: the error is at most half a
    quantization step, max |g + e| / 127 — a gradient that differs by
    1e-7 of its max moves the error by as much, which is 2.5e-5 of the
    error's own max), except where the two sit on either side of one
    rounding boundary (a gradient that differs in its last bits rounds
    the other way there, and the error carries that into the next
    steps), where the two differ by at most one quantization step (2.5
    times the error's max: a step is twice the largest error of its
    block).  Such a flip moves that element's compressed gradient by one
    quantization step (at most 1/127 of its block's max), so the
    parameters and moments may differ there too, by less than 1e-2 of
    the leaf's max.  Fewer than one element in 10^3 of the state is off
    its 1e-5 in all.  AdamW's ``eps`` is 1e-3 in these runs: at its
    default of 1e-8 the normalised update turns the float noise of
    gradient entries near zero into steps of up to ±lr, on which two
    summation orders cannot agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.parallel.sharding import Plan as JPlan
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import compression as jcomp
from repro.train import init_train_state as jinit_train_state
from repro.train import jit_train_step, make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_train_state
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.train import (OptimizerConfig, Plan, compression,
                               make_train_step)
from repro_torch.tree import flatten
from torch_worlds import psum_world, run_world

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10, eps=1e-3)
SHAPES = [(), (7,), (256,), (3, 300), (2, 5, 512), (4, 1000), (2, 3, 17)]


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape)
                      * 10.0 ** rng.uniform(-4, 2, shape), np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_dequantize_residual_bit_for_bit(shape):
    x = _x(shape)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = compression.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dtype in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jcomp.dequantize_int8(jq, js, shape, dtype),
                          np.float32)
        got = compression.dequantize_int8(
            tq, ts, shape, getattr(torch, jnp.dtype(dtype).name)).float()
        np.testing.assert_array_equal(got.numpy(), want)
    (_, _), jr = jcomp.compress_residual(jnp.asarray(x))
    (_, _), tr = compression.compress_residual(torch.from_numpy(x))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("n", [2, 4])
def test_reduce_stacked_bit_for_bit(n):
    g = {"a": _x((n, 5, 600), 1), "b": {"c": _x((n, 3), 2)}}
    e = {"a": _x((n, 5, 600), 3) * 1e-3, "b": {"c": _x((n, 3), 4) * 1e-3}}
    js, je = jcomp.reduce_stacked(jax.tree.map(jnp.asarray, g),
                                  jax.tree.map(jnp.asarray, e))
    tconv = lambda t: {k: (tconv(v) if isinstance(v, dict)  # noqa: E731
                           else torch.from_numpy(v)) for k, v in t.items()}
    ts, te = compression.reduce_stacked(tconv(g), tconv(e))
    for (k, x), (_, y) in zip(flatten(ts), flatten(js)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=k)
    for (k, x), (_, y) in zip(flatten(te), flatten(je)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=k)


def test_compressed_psum_on_a_world_of_two(tmp_path):
    g, e = _x((2, 4, 700), 5), _x((2, 4, 700), 6) * 1e-3
    res = run_world(psum_world, 2, tmp_path, torch.from_numpy(g),
                    torch.from_numpy(e))
    want, want_err = jcomp.reduce_stacked({"g": jnp.asarray(g)},
                                          {"g": jnp.asarray(e)})
    for rank, (total, err) in enumerate(res):
        np.testing.assert_array_equal(total.numpy(), np.asarray(want["g"]))
        np.testing.assert_array_equal(err.numpy(),
                                      np.asarray(want_err["g"][rank]))


def _flipped(x: np.ndarray, want: np.ndarray, key: str, err: bool) -> int:
    """The elements of a leaf off by more than its tolerance, each checked
    against its bound (module docstring): for ``grad_err`` 1e-5 of the
    max |g + e| (254 times its max), at most one quantization step off
    (2.5 times its max); else 1e-5 of its max, at most 1e-2 off."""
    top = max(float(np.abs(want).max()), 1e-30)
    tol, bound = (1e-5 * 254 * top, 2.5 * top) if err else (1e-5 * top,
                                                           1e-2 * top)
    diff = np.abs(x - want)
    assert np.all(diff <= bound), (key, float(diff.max()), top)
    return int((diff > tol).sum())


def assert_state_matches(got, want_np, flip_share: float = 1e-3) -> None:
    """Each leaf of a port state within 1e-5 of its max |x| of the
    reference's (numpy) state; under compression (``grad_err`` in the
    state) up to the rounding flips of the module docstring, fewer than
    ``flip_share`` of the state's elements."""
    flat = dict(flatten(want_np))
    flips = "grad_err" in want_np
    off = total = 0
    for key, x in flatten(got):
        want = np.asarray(flat[key], np.float32)
        x = x.detach().float().numpy()
        if not flips:
            top = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(x, want, atol=1e-5 * top, rtol=0,
                                       err_msg=key)
            continue
        off += _flipped(x, want, key, key.startswith("grad_err/"))
        total += x.size
    assert off <= flip_share * total, (off, total)


def reference_run(arch, over, jplan, batches, steps):
    """The reference's unsharded train step from its own init: the
    initial state and each step's state and metrics, as numpy."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32",
                               **over)
    model = jbuild_model(jcfg)
    opt = JOptimizerConfig(**OPT)
    state = jax.jit(lambda k: jinit_train_state(model, k, opt, jplan))(
        jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    step = jit_train_step(jmake_train_step(model, opt, jplan), donate=False)
    out = []
    for i in range(steps):
        state, m = step(state, jax.tree.map(jnp.asarray, batches[i]))
        out.append((jax.tree.map(np.asarray, state),
                    {k: float(v) for k, v in m.items()}))
    return init, out


def _batches(n, B=4, S=16, seed=1):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 256, (B, S)).astype(np.int32)}
            for _ in range(n)]


def test_compress_grads_train_matches_reference():
    steps = 3
    batches = _batches(steps)
    init, ref = reference_run("qwen2-1.5b", {}, JPlan(
        remat="none", compress_grads=True), batches, steps)
    cfg = dataclasses.replace(reduced(get_config("qwen2-1.5b")),
                              dtype="float32")
    model = build_model(cfg, "cpu")
    state = from_jax_train_state(init, cfg, "cpu")
    step = make_train_step(model, OptimizerConfig(**OPT),
                           Plan(remat="none", compress_grads=True))
    for i in range(steps):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batches[i].items()})
        want_state, want = ref[i]
        for name in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[name]), want[name],
                                       rtol=1e-5, err_msg=f"{name} {i}")
        assert_state_matches(state, want_state)
        assert any(float(e.abs().max()) > 0
                   for _, e in flatten(state["grad_err"]))
