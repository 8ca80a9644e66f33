"""hymba's bf16 decode drift: the port against the reference, on the CPU.

On the card, hymba-1.5b's bf16 decode logits sit 0.033-0.046 of max
|logit| from its own train forward at full depth, against 0.0022 at the
prefill (``chip_smoke.py`` phase 38).  This holds where that drift comes
from: reduced hymba-1.5b in bfloat16 (2 layers: layer 0 global, layer 1
a window of 16; and 8 layers, 0 and 7 global), on the reference's
weights bridged through numpy with the SSM parameters moved off their
init, a prompt of 20 tokens (past the window, where the reference's
window mask is right) and 12 decode steps teacher-forced.  The output
projection is scaled by 40 so that the logits (max ~25) stand above
bf16's resolution (at init they are below 1, where one bf16 step of the
output is 0.4% of the max).  Measured: each package's decode against
its own ``forward_train``, and the port's decode against the
reference's, as the mean |difference| over the decode steps' logits
divided by the mean |logit|:

  * the port's decode drifts from its forward no more than the
    reference's decode drifts from the reference's forward (measured
    0.0022 against 0.0034 at 2 layers, 0.0062 against 0.0075 at 8, 0.0089
    against 0.0100 at 16): the drift is bf16's in both packages, and it
    grows with depth in both;
  * every max |difference| (each decode against its forward, and the
    port's decode against the reference's) within 2e-2 of max |logit|,
    the bf16 tolerance of ``tests/test_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import lm as jlm
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, lm
from test_torch_model import JaxModel
from test_torch_serve_families import HYMBA_MOVED, one_torch_thread  # noqa: F401

ARCH = "hymba-1.5b"
S, STEPS, HEAD_SCALE = 20, 12, 40.0
BOUND = 2e-2


def _logits(layers: int):
    """``(port decode, port forward, reference decode, reference forward)``
    float32 logits at positions S - 1 .. S - 1 + STEPS."""
    over = dict(dtype="bfloat16")
    if layers != 2:
        over.update(num_layers=layers, global_attn_layers=(0, layers - 1))
    jcfg = jreduced(jget_config(ARCH), **over)
    tcfg = reduced(get_config(ARCH), **over)
    params, _ = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    jmodel = JaxModel(jcfg)
    rng = np.random.default_rng(1)
    blocks = params["blocks"]
    for name, mean, std in HYMBA_MOVED:
        blocks[name] = jnp.asarray(
            mean + std * rng.standard_normal(blocks[name].shape), jnp.float32)
    params["lm_head"] = params["lm_head"] * HEAD_SCALE
    model = build_model(tcfg, device="cpu")
    master = from_jax_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    served = model.serving_params(master)
    tokens = np.random.default_rng(7).integers(
        1, 256, (2, S + STEPS)).astype(np.int32)
    window = slice(S - 1, S + STEPS)

    jfwd = np.asarray(jax.jit(lambda p, t: jlm.forward_train(p, jcfg, t)[0])(
        params, jnp.asarray(tokens)), np.float32)[:, window]
    jl, jc = jmodel.prefill(params, jnp.asarray(tokens[:, :S]), max_seq=64)
    jdec = [np.asarray(jl, np.float32)]
    for t in range(S, S + STEPS):
        jl, jc = jmodel.decode_step(params, jc, jnp.asarray(tokens[:, t:t + 1]))
        jdec.append(np.asarray(jl, np.float32))
    with torch.no_grad():
        tfwd = lm.forward_train(master, tcfg, torch.from_numpy(tokens))[0]
        tl, tc = model.prefill(served, torch.from_numpy(tokens[:, :S]),
                               max_seq=64)
        tdec = [tl.float().numpy()]
        for t in range(S, S + STEPS):
            tl, tc = model.decode_step(served, tc,
                                       torch.from_numpy(tokens[:, t:t + 1]))
            tdec.append(tl.float().numpy())
    return (np.stack(tdec, 1), tfwd.float().numpy()[:, window],
            np.stack(jdec, 1), jfwd)


@pytest.mark.parametrize("layers", [2, 8])
def test_decode_drift_is_bf16s_in_both_packages(layers):
    tdec, tfwd, jdec, jfwd = _logits(layers)
    scale, mean = float(np.abs(jfwd).max()), float(np.abs(jfwd).mean())
    assert scale > 10  # the logits stand above bf16's resolution

    def drift(a, b):  # decode steps only: the prefill's row is position S-1
        d = np.abs(a[:, 1:] - b[:, 1:])
        return float(d.mean()) / mean, float(d.max()) / scale

    port, ref, across = drift(tdec, tfwd), drift(jdec, jfwd), drift(tdec, jdec)
    assert 0 < port[0] <= ref[0], (port, ref)
    for name, (_, worst) in (("port", port), ("reference", ref),
                             ("port vs reference", across)):
        assert worst < BOUND, (name, worst)
