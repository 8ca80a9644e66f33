"""Recurrent blocks: the xLSTM's mLSTM and sLSTM halves and the hybrid's
Mamba-style SSM heads.

Counterpart of the reference package's ``models/recurrent.py``: the
parameters' names and shapes (:func:`mlstm_shapes`, :func:`slstm_shapes`,
:func:`ssm_shapes`), the projections, the blocks' forward, and for
serving their decode states (``*_state_spec``), a prefill that returns
the final state (``prefill_*``) and the one-token decode (``decode_*``),
at the reference's dtype at each operation.

The mLSTM's matrix memory runs through ``ops.mlstm_scan`` (K6, and
K6-bwd under autograd), the SSM's selective scan through
``ops.ssm_scan`` (K5, and K5-bwd under autograd); their prefills through
``ops.mlstm_scan_with_state`` and ``ops.ssm_scan_with_state``, K6 and K5
with their final-state outputs (the reference's prefill runs its
sequential oracles there), and their decode steps through
``ops.mlstm_step`` and ``ops.ssm_step``, one step of the oracles on every
device, as in the reference.  The sLSTM is a loop over time in plain
PyTorch, as the reference's ``jax.lax.scan`` is no kernel; its input
projection ``x_t . w_gates`` does not depend on the state, so it is one
float32 product over all steps before the loop (:func:`slstm_loop`),
and each step adds its recurrent part with one batched product
(``baddbmm``): the same float32 sums in another order.  Its decode is
the same loop over one step.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import activation, layer_norm, rms_norm
from repro_torch.parallel import collectives, tensor

NEG_INF = -1e30


# ===========================================================================
# mLSTM (xLSTM matrix-memory block)
# ===========================================================================
def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = 2 * cfg.d_model  # projection factor 2
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


# logical axes of the per-head block-diagonal projections and of the SSM's
# d_inner-by-small matrices (the reference's ``ParamBuilder.p`` axes)
_HEAD_PROJ = ("layers", "heads", "head_dim", None)
_MLP_ROWS = ("layers", "mlp", None)


def mlstm_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init, logical axes)`` of the mLSTM parameters,
    each with a leading layer axis (the reference's ``init_mlstm``)."""
    D = cfg.d_model
    d_in, NH, DH = mlstm_dims(cfg)
    L = num_layers
    return {
        "ln_g": ((L, D), "ones", ("layers", "embed")),
        "ln_b": ((L, D), "zeros", ("layers", "embed")),
        "w_up_x": ((L, D, d_in), "normal", ("layers", "embed", "mlp")),
        "w_up_z": ((L, D, d_in), "normal", ("layers", "embed", "mlp")),
        # per-head block-diagonal projections: each head projects only
        # its own DH-slice
        "w_q": ((L, NH, DH, DH), "normal", _HEAD_PROJ),
        "w_k": ((L, NH, DH, DH), "normal", _HEAD_PROJ),
        "w_v": ((L, NH, DH, DH), "normal", _HEAD_PROJ),
        "w_i": ((L, d_in, NH), "small_normal", ("layers", "mlp", "heads")),
        "w_f": ((L, d_in, NH), "small_normal", ("layers", "mlp", "heads")),
        "b_i": ((L, NH), "zeros", ("layers", "heads")),
        "b_f": ((L, NH), "ones", ("layers", "heads")),
        "headnorm_g": ((L, NH, DH), "ones", ("layers", "heads", "head_dim")),
        "w_down": ((L, d_in, D), "normal", ("layers", "mlp", "embed")),
    }


def _mlstm_qkvif(p, h, cfg):
    dt = h.dtype
    d_in, NH, DH = mlstm_dims(cfg)
    hh = h.reshape(h.shape[0], h.shape[1], NH, DH)  # (B, S, NH, DH)
    q = torch.einsum("bshd,hde->bhse", hh, p["w_q"].to(dt))
    k = torch.einsum("bshd,hde->bhse", hh, p["w_k"].to(dt))
    v = torch.einsum("bshd,hde->bhse", hh, p["w_v"].to(dt))
    i_pre = (torch.einsum("bsd,dh->bhs", h, p["w_i"].to(dt))
             + p["b_i"].to(dt)[None, :, None])
    f_pre = (torch.einsum("bsd,dh->bhs", h, p["w_f"].to(dt))
             + 3.0 * p["b_f"].to(dt)[None, :, None])
    return q, k, v, i_pre, f_pre


def _mlstm_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                 mix: Callable):
    """The mLSTM block around its memory: ``mix(q, k, v, i_pre, f_pre)``
    gives ``(h (B, NH, S, DH), state)``.  Returns ``(x + out, state)``."""
    d_in, NH, DH = mlstm_dims(cfg)
    B, S, D = x.shape
    xn = layer_norm(x, p["ln_g"], p["ln_b"])
    h = xn @ p["w_up_x"].to(x.dtype)
    z = xn @ p["w_up_z"].to(x.dtype)
    out, state = mix(*_mlstm_qkvif(p, h, cfg))  # (B, NH, S, DH)
    out = rms_norm(out.transpose(1, 2), p["headnorm_g"])  # (B, S, NH, DH)
    out = out.reshape(B, S, d_in) * F.silu(z)
    return x + out @ p["w_down"].to(x.dtype), state


def apply_mlstm(p: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Train path.  x: (B, S, D)."""
    return _mlstm_block(p, x, cfg,
                        lambda *a: (ops.mlstm_scan(*a), None))[0]


def mlstm_state_spec(cfg: ModelConfig, batch: int, device=None):
    """The zero decode state of one mLSTM layer (float32)."""
    d_in, NH, DH = mlstm_dims(cfg)
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, NH, DH, DH), **kw),
            "n": torch.zeros((batch, NH, DH), **kw),
            "m": torch.full((batch, NH), NEG_INF, **kw)}


def prefill_mlstm(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig):
    """The prefill's mLSTM block, x ``(B, S, D)``: ``(x out, the final
    state {C, n, m})`` through K6 with its state output (the reference's
    ``_mlstm_prefill_layer``, which runs its sequential oracle)."""
    def mix(*a):
        h, (C, n, m) = ops.mlstm_scan_with_state(*a)
        return h, {"C": C, "n": n, "m": m}
    return _mlstm_block(p, x, cfg, mix)


def decode_mlstm(p: Dict[str, Any], state: Dict[str, torch.Tensor],
                 x: torch.Tensor, cfg: ModelConfig):
    """One token, x ``(B, 1, D)``: ``(x out, new state)``, one step of
    the sequential oracle (``ops.mlstm_step``)."""
    def mix(*a):
        h, (C, n, m) = ops.mlstm_step(*a, (state["C"], state["n"],
                                           state["m"]))
        return h[:, :, None], {"C": C, "n": n, "m": m}
    return _mlstm_block(p, x, cfg, mix)


# ===========================================================================
# sLSTM (scalar-memory block with head-wise recurrence)
# ===========================================================================
def slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    NH = cfg.num_heads
    return NH, cfg.d_model // NH


def slstm_ffn_dim(cfg: ModelConfig) -> int:
    return int(math.ceil(cfg.d_model * 4 / 3 / 64) * 64)


def slstm_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init, logical axes)`` of the sLSTM parameters,
    each with a leading layer axis (the reference's ``init_slstm``)."""
    D = cfg.d_model
    NH, DH = slstm_dims(cfg)
    Fs = slstm_ffn_dim(cfg)
    L = num_layers
    return {
        "ln_g": ((L, D), "ones", ("layers", "embed")),
        "ln_b": ((L, D), "zeros", ("layers", "embed")),
        "w_gates": ((L, D, 4, NH, DH), "normal",
                    ("layers", "embed", None, "heads", "head_dim")),
        "r_gates": ((L, NH, 4, DH, DH), "small_normal",
                    ("layers", "heads", None, "head_dim", None)),
        "b_gates": ((L, 4, NH, DH), "zeros",
                    ("layers", None, "heads", "head_dim")),
        "headnorm_g": ((L, NH, DH), "ones", ("layers", "heads", "head_dim")),
        "ln2_g": ((L, D), "ones", ("layers", "embed")),
        "ln2_b": ((L, D), "zeros", ("layers", "embed")),
        "ffn_wg": ((L, D, Fs), "normal", ("layers", "embed", "mlp")),
        "ffn_wu": ((L, D, Fs), "normal", ("layers", "embed", "mlp")),
        "ffn_wd": ((L, Fs, D), "normal", ("layers", "mlp", "embed")),
    }


def slstm_state_spec(cfg: ModelConfig, batch: int, device=None):
    NH, DH = slstm_dims(cfg)
    kw = dict(dtype=torch.float32, device=device)
    return {
        "h": torch.zeros((batch, NH, DH), **kw),
        "c": torch.zeros((batch, NH, DH), **kw),
        "n": torch.zeros((batch, NH, DH), **kw),
        "m": torch.full((batch, NH, DH), NEG_INF, **kw),
    }


def _slstm_cell(state, pre):
    """One recurrence step from the gate pre-activations ``pre`` (.., 4,
    DH) — ``x_t . w_gates + h . r_gates + b_gates`` in float32 — and the
    state ``h, c, n, m`` (.., DH), as the reference's ``_slstm_cell``."""
    c, n, m = state["c"], state["n"], state["m"]
    z_pre, i_pre, f_pre, o_pre = pre.unbind(-2)
    z = torch.tanh(z_pre)
    log_f = F.logsigmoid(f_pre + 3.0)
    m_new = torch.maximum(log_f + m, i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c_new = f_sc * c + i_sc * z
    n_new = f_sc * n + i_sc
    h_tilde = c_new / torch.clamp(n_new.abs(), min=1e-6) * torch.sign(n_new)
    h_new = torch.sigmoid(o_pre) * h_tilde
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def slstm_loop(wx: torch.Tensor, r: torch.Tensor,
               state: Dict[str, torch.Tensor]):
    """The sLSTM's recurrence over time, head-major: ``wx`` ``(S, NH, B,
    4 * DH)`` the input projections with the bias, ``r`` ``(NH, DH, 4 *
    DH)`` the recurrent weights, ``state`` the initial ``h, c, n, m`` ``(NH,
    B, DH)``.  Each step's recurrent product is one ``baddbmm`` over the
    heads.  Returns every step's h, ``(S, NH, B, DH)``, and the final
    state.  The steps' inputs come from one ``unbind``, whose backward
    stacks their gradients once (a slice per step would write a
    zero-filled copy of all of ``wx`` for each step's gradient)."""
    S, NH, B, G = wx.shape
    hs = []
    for wx_t in wx.unbind(0):
        pre = torch.baddbmm(wx_t, state["h"], r).view(NH, B, 4, G // 4)
        state = _slstm_cell(state, pre)
        hs.append(state["h"])
    return torch.stack(hs), state


def _slstm_block(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                 state: Dict[str, torch.Tensor]):
    """The sLSTM block over x ``(B, S, D)`` from ``state`` ``h, c, n, m``
    ``(B, NH, DH)``: ``(x out, the final state)``."""
    B, S, D = x.shape
    NH, DH = slstm_dims(cfg)
    xn = layer_norm(x, p["ln_g"], p["ln_b"]).float()
    # x_t . w_gates + b_gates for every step: (S, NH, B, 4 * DH)
    wx = torch.einsum("bsd,dghk->shbgk", xn, p["w_gates"].float())
    wx = (wx + p["b_gates"].float().transpose(0, 1)[None, :, None]
          ).reshape(S, NH, B, 4 * DH)
    # r_gates (NH, 4, DH, DH) -> (NH, DH, 4 * DH): h (NH, B, DH) @ r
    r = p["r_gates"].float().permute(0, 2, 1, 3).reshape(NH, DH, 4 * DH)
    hs, state = slstm_loop(wx, r, {k: v.transpose(0, 1)
                                   for k, v in state.items()})
    hs = hs.permute(2, 0, 1, 3)  # (B, S, NH, DH)
    out = rms_norm(hs, p["headnorm_g"]).reshape(B, S, D).to(x.dtype)
    x = x + out
    xn2 = layer_norm(x, p["ln2_g"], p["ln2_b"])
    hg = xn2 @ p["ffn_wg"].to(x.dtype)
    hu = xn2 @ p["ffn_wu"].to(x.dtype)
    return (x + (activation(hg, "gelu") * hu) @ p["ffn_wd"].to(x.dtype),
            {k: v.transpose(0, 1) for k, v in state.items()})


def apply_slstm(p: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Train path: a sequential loop over time (the sLSTM is inherently
    sequential — the xLSTM paper places few of these blocks)."""
    return prefill_slstm(p, x, cfg)[0]


def prefill_slstm(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig):
    """The sLSTM block from the zero state: ``(x out, the final state
    {h, c, n, m} (B, NH, DH))`` (the reference's ``_slstm_prefill_layer``;
    the train path keeps only x)."""
    return _slstm_block(p, x, cfg, slstm_state_spec(cfg, x.shape[0],
                                                    x.device))


def decode_slstm(p: Dict[str, Any], state: Dict[str, torch.Tensor],
                 x: torch.Tensor, cfg: ModelConfig):
    """One token, x ``(B, 1, D)``: ``(x out, new state)``, the loop of
    one step (the reference's ``decode_slstm``)."""
    return _slstm_block(p, x, cfg, state)


# ===========================================================================
# Mamba-style SSM heads (hymba hybrid blocks)
# ===========================================================================
def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, 16  # (d_inner, state, dt_rank)


def ssm_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init, logical axes)`` of the SSM parameters
    (``ssm_*``), each with a leading layer axis (the reference's ``init_ssm``)."""
    D = cfg.d_model
    d_in, N, R = ssm_dims(cfg)
    L, K = num_layers, cfg.ssm_conv
    shapes = {
        "w_in": ((L, D, d_in), "normal", ("layers", "embed", "mlp")),
        "w_z": ((L, D, d_in), "normal", ("layers", "embed", "mlp")),
        "conv_w": ((L, K, d_in), "small_normal", ("layers", None, "mlp")),
        "w_B": ((L, d_in, N), "small_normal", _MLP_ROWS),
        "w_C": ((L, d_in, N), "small_normal", _MLP_ROWS),
        "w_dt1": ((L, d_in, R), "small_normal", _MLP_ROWS),
        "w_dt2": ((L, R, d_in), "small_normal", ("layers", None, "mlp")),
        "b_dt": ((L, d_in), "zeros", ("layers", "mlp")),
        "A_log": ((L, d_in, N), "zeros", _MLP_ROWS),
        "D": ((L, d_in), "ones", ("layers", "mlp")),
        "w_out": ((L, d_in, D), "normal", ("layers", "mlp", "embed")),
    }
    return {f"ssm_{k}": v for k, v in shapes.items()}


def _ssm_coeffs(p, xc, sp=None):
    """B, C and dt in float32 (dt low-rank, biased toward small steps), and
    ``A = -exp(A_log)``.  Under a split of the channels (``sp``) the
    rank's rows of ``w_B``, ``w_C`` and ``w_dt1`` give partial products,
    summed over ``model`` in one all-reduce before use; each rank's scan
    reads the sums for its own channels only, so their gradients are
    partial too and are summed over ``model`` on the way back."""
    xf = xc.float()
    if sp is None:
        Bm = xf @ p["ssm_w_B"].float()
        Cm = xf @ p["ssm_w_C"].float()
        low = xf @ p["ssm_w_dt1"].float()
    else:
        w = torch.cat([p["ssm_w_B"], p["ssm_w_C"], p["ssm_w_dt1"]], 1)
        N = p["ssm_w_B"].shape[1]
        Bm, Cm, low = sp.sum_grad(sp.reduce_sum(xf @ w.float())).split(
            [N, N, w.shape[1] - 2 * N], -1)
    dt = F.softplus(low @ p["ssm_w_dt2"].float()
                    + p["ssm_b_dt"].float() - 4.0)
    A = -torch.exp(p["ssm_A_log"].float())  # (d_in, N), negative
    return dt, A, Bm, Cm


def _ssm_branch(p: Dict[str, Any], xn: torch.Tensor, cfg: ModelConfig,
                with_state: bool):
    """The SSM heads over xn ``(B, S, D)`` normed: ``(out (B, S, D),
    state)``, the state ``{h, conv}`` with ``with_state`` (K5 with its
    final state, and the last ``ssm_conv - 1`` raw inputs in float32,
    zeros before the first as the causal padding has them), else None.

    Under a split of the channels over ``model`` (the ``ssm`` region of
    ``parallel/tensor.py``) the rank runs its ``d_in/m`` channels: the
    input's gradient summed over ``model``, the scan (K5, K5-bwd) on its
    channels alone, and the output projection's terms summed over
    ``model``; the state's channel blocks are then gathered whole
    (:func:`_gather_state`), as the serving layout holds it."""
    S, dt_ = xn.shape[1], xn.dtype
    K = cfg.ssm_conv
    sp = tensor.active()
    if sp is not None and not sp.splits("ssm"):
        sp = None
    if sp is not None:
        xn = sp.sum_grad(xn)
    xin, z = xn @ p["ssm_w_in"].to(dt_), xn @ p["ssm_w_z"].to(dt_)
    # causal depthwise conv over time: K shifted products, summed in
    # cfg.dtype in the reference's order
    conv_w = p["ssm_conv_w"].to(dt_)  # (K, d_in)
    xpad = F.pad(xin, (0, 0, K - 1, 0))
    xc = F.silu(sum(xpad[:, i:i + S] * conv_w[i] for i in range(K)))
    dt, A, Bm, Cm = _ssm_coeffs(p, xc, sp)
    args = (xc, dt.to(dt_), A, Bm, Cm, p["ssm_D"])
    state = None
    if with_state:
        y, h = ops.ssm_scan_with_state(*args)
        state = {"h": h, "conv": xpad[:, S:].float()}
        if sp is not None:
            state = _gather_state(state, sp)
    else:
        y = ops.ssm_scan(*args)
    out = (y * F.silu(z)) @ p["ssm_w_out"].to(dt_)
    return (out if sp is None else sp.reduce_sum(out)), state


def _gather_state(state: Dict[str, torch.Tensor], sp) -> Dict[str, Any]:
    """The ranks' channel blocks of the prefill's final state ``{h (B,
    d_in/m, N), conv (B, K-1, d_in/m)}`` gathered over ``model`` in one
    all-gather: the whole state, the same bits on every rank."""
    h, conv = state["h"], state["conv"]
    both = torch.cat([h, conv.transpose(1, 2)], -1)  # float32 both
    both = collectives.all_gather_dim(both, 1, sp.mesh, tensor.AXIS)
    N = h.shape[-1]
    return {"h": both[..., :N].contiguous(),
            "conv": both[..., N:].transpose(1, 2).contiguous()}


def apply_ssm(p: Dict[str, Any], xn: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Train path.  xn: (B, S, D) already normed.  Returns (B, S, D)."""
    return _ssm_branch(p, xn, cfg, with_state=False)[0]


def prefill_ssm(p: Dict[str, Any], xn: torch.Tensor, cfg: ModelConfig):
    """The hybrid prefill's SSM heads: ``(out (B, S, D), state {h,
    conv})`` (the reference's SSM branch of ``_hybrid_block_prefill``)."""
    return _ssm_branch(p, xn, cfg, with_state=True)


def ssm_state_spec(cfg: ModelConfig, batch: int, device=None):
    """The zero decode state of one layer's SSM heads (float32): the
    scan's ``h`` ``(B, d_inner, N)`` and the last ``ssm_conv - 1`` raw
    inputs of the convolution, ``conv`` ``(B, ssm_conv - 1, d_inner)``."""
    d_in, N, _ = ssm_dims(cfg)
    kw = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d_in, N), **kw),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in), **kw)}


def decode_ssm(p: Dict[str, Any], state: Dict[str, torch.Tensor],
               xn: torch.Tensor, cfg: ModelConfig):
    """One token, xn ``(B, 1, D)`` normed: ``(out (B, 1, D), new
    state)``, the convolution over the carried inputs and one step of the
    sequential scan (``ops.ssm_step``), as the reference's
    ``decode_ssm``.  Never split: the serving split over ``model`` holds
    the state whole and gathers this layer's SSM leaves whole for the
    decode (``serve/sharded.py``), so every ``model`` rank steps the
    whole state of its rows, with no collective."""
    dt_ = xn.dtype
    xin, z = xn @ p["ssm_w_in"].to(dt_), xn @ p["ssm_w_z"].to(dt_)
    hist = torch.cat([state["conv"].to(dt_), xin], dim=1)  # (B, K, d_in)
    xc = F.silu((hist * p["ssm_conv_w"].to(dt_)).sum(1, keepdim=True))
    dt, A, Bm, Cm = _ssm_coeffs(p, xc)
    y, h = ops.ssm_step(xc[:, 0], dt[:, 0].to(dt_), A, Bm[:, 0], Cm[:, 0],
                        p["ssm_D"], state["h"])
    out = (y[:, None] * F.silu(z)) @ p["ssm_w_out"].to(dt_)
    return out, {"h": h, "conv": hist[:, 1:].float()}
