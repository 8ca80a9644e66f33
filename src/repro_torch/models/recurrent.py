"""Recurrent blocks: the xLSTM's mLSTM and sLSTM halves and the hybrid's
Mamba-style SSM heads.

Counterpart of the reference package's ``models/recurrent.py`` for the
train path: the parameters' names and shapes (:func:`mlstm_shapes`,
:func:`slstm_shapes`, :func:`ssm_shapes`), the projections, the blocks'
forward and the sLSTM's initial state, at the reference's dtype at each
operation.  The decode states (the mLSTM's, the SSM's
``ssm_state_spec``/``decode_ssm``) come with the xLSTM's and hymba's
serving (ROADMAP queue 1).

The mLSTM's matrix memory runs through ``ops.mlstm_scan`` (K6, and
K6-bwd under autograd), the SSM's selective scan through
``ops.ssm_scan`` (K5, and K5-bwd under autograd).  The sLSTM is a loop
over time in plain PyTorch, as the reference's ``jax.lax.scan`` is no
kernel; its input projection ``x_t . w_gates`` does not depend on the
state, so it is one float32 product over all steps before the loop
(:func:`slstm_loop`), and each step adds its recurrent part with one
batched product (``baddbmm``): the same float32 sums in another order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import activation, layer_norm, rms_norm

NEG_INF = -1e30


# ===========================================================================
# mLSTM (xLSTM matrix-memory block)
# ===========================================================================
def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = 2 * cfg.d_model  # projection factor 2
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def mlstm_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init)`` of the mLSTM parameters, each with a
    leading layer axis (the reference's ``init_mlstm``)."""
    D = cfg.d_model
    d_in, NH, DH = mlstm_dims(cfg)
    L = num_layers
    return {
        "ln_g": ((L, D), "ones"), "ln_b": ((L, D), "zeros"),
        "w_up_x": ((L, D, d_in), "normal"), "w_up_z": ((L, D, d_in), "normal"),
        # per-head block-diagonal projections: each head projects only
        # its own DH-slice
        "w_q": ((L, NH, DH, DH), "normal"), "w_k": ((L, NH, DH, DH), "normal"),
        "w_v": ((L, NH, DH, DH), "normal"),
        "w_i": ((L, d_in, NH), "small_normal"),
        "w_f": ((L, d_in, NH), "small_normal"),
        "b_i": ((L, NH), "zeros"), "b_f": ((L, NH), "ones"),
        "headnorm_g": ((L, NH, DH), "ones"),
        "w_down": ((L, d_in, D), "normal"),
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


def apply_mlstm(p: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Train path.  x: (B, S, D)."""
    d_in, NH, DH = mlstm_dims(cfg)
    B, S, D = x.shape
    xn = layer_norm(x, p["ln_g"], p["ln_b"])
    h = xn @ p["w_up_x"].to(x.dtype)
    z = xn @ p["w_up_z"].to(x.dtype)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(p, h, cfg)
    out = ops.mlstm_scan(q, k, v, i_pre, f_pre)  # (B, NH, S, DH)
    out = rms_norm(out.transpose(1, 2), p["headnorm_g"])  # (B, S, NH, DH)
    out = out.reshape(B, S, d_in) * F.silu(z)
    return x + out @ p["w_down"].to(x.dtype)


# ===========================================================================
# sLSTM (scalar-memory block with head-wise recurrence)
# ===========================================================================
def slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    NH = cfg.num_heads
    return NH, cfg.d_model // NH


def slstm_ffn_dim(cfg: ModelConfig) -> int:
    return int(math.ceil(cfg.d_model * 4 / 3 / 64) * 64)


def slstm_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init)`` of the sLSTM parameters, each with a
    leading layer axis (the reference's ``init_slstm``)."""
    D = cfg.d_model
    NH, DH = slstm_dims(cfg)
    Fs = slstm_ffn_dim(cfg)
    L = num_layers
    return {
        "ln_g": ((L, D), "ones"), "ln_b": ((L, D), "zeros"),
        "w_gates": ((L, D, 4, NH, DH), "normal"),
        "r_gates": ((L, NH, 4, DH, DH), "small_normal"),
        "b_gates": ((L, 4, NH, DH), "zeros"),
        "headnorm_g": ((L, NH, DH), "ones"),
        "ln2_g": ((L, D), "ones"), "ln2_b": ((L, D), "zeros"),
        "ffn_wg": ((L, D, Fs), "normal"), "ffn_wu": ((L, D, Fs), "normal"),
        "ffn_wd": ((L, Fs, D), "normal"),
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
               state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sLSTM's recurrence over time, head-major: ``wx`` ``(S, NH, B,
    4 * DH)`` the input projections with the bias, ``r`` ``(NH, DH, 4 *
    DH)`` the recurrent weights, ``state`` the initial ``h, c, n, m`` ``(NH,
    B, DH)``.  Each step's recurrent product is one ``baddbmm`` over the
    heads.  Returns every step's h, ``(S, NH, B, DH)``.  The steps' inputs
    come from one ``unbind``, whose backward stacks their gradients once
    (a slice per step would write a zero-filled copy of all of ``wx`` for
    each step's gradient)."""
    S, NH, B, G = wx.shape
    hs = []
    for wx_t in wx.unbind(0):
        pre = torch.baddbmm(wx_t, state["h"], r).view(NH, B, 4, G // 4)
        state = _slstm_cell(state, pre)
        hs.append(state["h"])
    return torch.stack(hs)


def apply_slstm(p: Dict[str, Any], x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Train path: a sequential loop over time (the sLSTM is inherently
    sequential — the xLSTM paper places few of these blocks)."""
    B, S, D = x.shape
    NH, DH = slstm_dims(cfg)
    xn = layer_norm(x, p["ln_g"], p["ln_b"]).float()
    # x_t . w_gates + b_gates for every step: (S, NH, B, 4 * DH)
    wx = torch.einsum("bsd,dghk->shbgk", xn, p["w_gates"].float())
    wx = (wx + p["b_gates"].float().transpose(0, 1)[None, :, None]
          ).reshape(S, NH, B, 4 * DH)
    # r_gates (NH, 4, DH, DH) -> (NH, DH, 4 * DH): h (NH, B, DH) @ r
    r = p["r_gates"].float().permute(0, 2, 1, 3).reshape(NH, DH, 4 * DH)
    state = {k: v.transpose(0, 1)
             for k, v in slstm_state_spec(cfg, B, x.device).items()}
    hs = slstm_loop(wx, r, state).permute(2, 0, 1, 3)  # (B, S, NH, DH)
    out = rms_norm(hs, p["headnorm_g"]).reshape(B, S, D).to(x.dtype)
    x = x + out
    xn2 = layer_norm(x, p["ln2_g"], p["ln2_b"])
    hg = xn2 @ p["ffn_wg"].to(x.dtype)
    hu = xn2 @ p["ffn_wu"].to(x.dtype)
    return x + (activation(hg, "gelu") * hu) @ p["ffn_wd"].to(x.dtype)


# ===========================================================================
# Mamba-style SSM heads (hymba hybrid blocks)
# ===========================================================================
def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, cfg.ssm_state, 16  # (d_inner, state, dt_rank)


def ssm_shapes(cfg: ModelConfig, num_layers: int):
    """``name -> (shape, init)`` of the SSM parameters (``ssm_*``), each
    with a leading layer axis (the reference's ``init_ssm``)."""
    D = cfg.d_model
    d_in, N, R = ssm_dims(cfg)
    L, K = num_layers, cfg.ssm_conv
    shapes = {
        "w_in": ((L, D, d_in), "normal"), "w_z": ((L, D, d_in), "normal"),
        "conv_w": ((L, K, d_in), "small_normal"),
        "w_B": ((L, d_in, N), "small_normal"),
        "w_C": ((L, d_in, N), "small_normal"),
        "w_dt1": ((L, d_in, R), "small_normal"),
        "w_dt2": ((L, R, d_in), "small_normal"),
        "b_dt": ((L, d_in), "zeros"), "A_log": ((L, d_in, N), "zeros"),
        "D": ((L, d_in), "ones"), "w_out": ((L, d_in, D), "normal"),
    }
    return {f"ssm_{k}": v for k, v in shapes.items()}


def _ssm_coeffs(p, xc):
    """B, C and dt in float32 (dt low-rank, biased toward small steps), and
    ``A = -exp(A_log)``."""
    xf = xc.float()
    Bm = xf @ p["ssm_w_B"].float()
    Cm = xf @ p["ssm_w_C"].float()
    dt = F.softplus(xf @ p["ssm_w_dt1"].float() @ p["ssm_w_dt2"].float()
                    + p["ssm_b_dt"].float() - 4.0)
    A = -torch.exp(p["ssm_A_log"].float())  # (d_in, N), negative
    return dt, A, Bm, Cm


def apply_ssm(p: Dict[str, Any], xn: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Train path.  xn: (B, S, D) already normed.  Returns (B, S, D)."""
    S, dt_ = xn.shape[1], xn.dtype
    K = cfg.ssm_conv
    xin, z = xn @ p["ssm_w_in"].to(dt_), xn @ p["ssm_w_z"].to(dt_)
    # causal depthwise conv over time: K shifted products, summed in
    # cfg.dtype in the reference's order
    conv_w = p["ssm_conv_w"].to(dt_)  # (K, d_in)
    xpad = F.pad(xin, (0, 0, K - 1, 0))
    xc = F.silu(sum(xpad[:, i:i + S] * conv_w[i] for i in range(K)))
    dt, A, Bm, Cm = _ssm_coeffs(p, xc)
    y = ops.ssm_scan(xc, dt.to(dt_), A, Bm, Cm, p["ssm_D"])
    return (y * F.silu(z)) @ p["ssm_w_out"].to(dt_)
