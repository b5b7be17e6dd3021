"""Mamba-1 selective SSM block (falcon-mamba-7b) and the linear-recurrence
scan that it and the RG-LRU block share.

The port of the JAX package's ``repro.models.ssm``.  The full-sequence path
runs the recurrence ``h_t = a_t * h_{t-1} + b_t`` as a log-depth doubling
scan (:func:`linear_scan`) where the reference runs
``jax.lax.associative_scan``: the same recurrence in float32, summed in
another order.  Decode is one O(1) step of the recurrence, so the whole
context lives in a ``[B, d_inner, state]`` state.

The order of operations and the dtypes are the reference's: the projections
and the depthwise causal convolution run in the input dtype (bf16 at full
width), the gates, the scan and the readout in float32.

On a mesh (``rules``: the rank's blocks of the leaves, their FSDP split
gathered by the caller) the block runs channel parallel over ``"model"``
when the axis splits ``d_inner`` (``manual_tp.inner_split``), as the
reference's ``"inner"`` axes store it:

    x, z  = exchange(x_in @ in_proj_loc)           (the rank's channels)
    conv, gates, scan, readout on the rank's channels (no collective)
    dt, B, C = all_reduce_sum(xc_loc @ x_proj_loc)   (float32, whole)
    y     = all_reduce_sum(y_loc @ out_proj_loc)     (float32, rounded once)

``in_proj``'s stored block is contiguous over the concatenated ``[x |
z]`` columns, so a rank holds columns of x or of z, not both
(``manual_tp.xz_channels``): one uneven all-to-all of the product's
columns gives each rank x and z of its channels, where gathering the
weight would move 128 MiB a layer at full width.  The state is the rank's
channels, ``h [B, d_inner/tp, N]``, ``conv [B, w-1, d_inner/tp]``.  Under
autograd the block's input and the whole ``dt, B, C`` sum their gradients
over the model axis (each rank's covers its channels) and the exchange
sends its gradient back.  Where the axis does not split ``d_inner`` the
block runs whole on every rank (``in_proj`` gathered if the guard split
its ``2·d_inner`` columns alone).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models import manual_tp as tp_lib
from repro_torch.models.layers import _normal
from repro_torch.models.sharding import gather_dims, local_shape


class SSMState(NamedTuple):
    conv: torch.Tensor   # [L?, B, conv_width-1, d_inner] recent inputs
    h: torch.Tensor      # [L?, B, d_inner, state] (float32)


# ---------------------------------------------------------------------------
# the scan


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1 of ``a``, ``b`` ``[B, S,
    ...]``, from ``h_{-1} = h0`` (``[B, ...]``) or from zero; returns every
    ``h_t``, ``[B, S, ...]``.

    A doubling (Hillis-Steele) scan: after the step of span ``d`` element
    ``t`` holds the composition of elements ``t-2d+1 .. t``, as the pair
    ``(A, B)`` with ``h_t = A * h_{t-2d} + B``; ``ceil(log2 S)`` steps of a
    few whole-tensor operations each, where a loop over time would launch
    a few kernels per token and layer.  Under autograd (an input that
    requires a gradient) each step's result is a concatenation instead of
    writes into a new tensor (``out=`` has no gradient): the same
    operations, so the same values.  Serving keeps the writes: the
    concatenations' extra pass made falcon-mamba-7b's prefill 46 % slower
    on an H100 (PERF.md)."""
    S = a.shape[1]
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, h0))
    A, Bv = a, b
    d = 1
    while d < S:
        last = 2 * d >= S and h0 is None      # A is not needed any more
        if grad:
            Bv = torch.cat([Bv[:, :d],
                            torch.addcmul(Bv[:, d:], Bv[:, :-d], A[:, d:])], 1)
            if not last:
                A = torch.cat([A[:, :d], A[:, :-d] * A[:, d:]], 1)
            d *= 2
            continue
        nb = torch.empty_like(Bv)
        nb[:, :d] = Bv[:, :d]
        torch.addcmul(Bv[:, d:], Bv[:, :-d], A[:, d:], out=nb[:, d:])
        if not last:
            na = torch.empty_like(A)
            na[:, :d] = A[:, :d]
            torch.mul(A[:, :-d], A[:, d:], out=na[:, d:])
            A = na
        Bv = nb
        d *= 2
    if h0 is not None:
        Bv = torch.addcmul(Bv, A, h0[:, None])
    return Bv


# ---------------------------------------------------------------------------
# params


def dims(cfg: ArchConfig):
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or cfg.d_model // 16
    return s, d_inner, dt_rank


#: the reference's logical axes of a Mamba block's leaves
SSM_AXES = {"in_proj": ("embed", "inner"), "conv_w": ("conv", "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", "null"),
            "dt_proj": ("dt", "inner"), "dt_bias": ("inner",),
            "A_log": ("inner", "state"), "D": ("inner",),
            "out_proj": ("inner", "embed")}


def init_ssm(gen, cfg: ArchConfig, dtype, device=None) -> dict:
    """The reference's leaves, scales and layouts (``A`` by the S4D-real
    init, ``A = -(1..state)`` per channel)."""
    s, din, dtr = dims(cfg)
    d = cfg.d_model
    sd, si = 1.0 / math.sqrt(d), 1.0 / math.sqrt(din)
    a0 = torch.arange(1, s.state_dim + 1, dtype=torch.float32,
                      device=device)[None].repeat(din, 1)
    return {
        "in_proj": _normal(gen, (d, 2 * din), dtype, sd, device),
        "conv_w": _normal(gen, (s.conv_width, din), dtype, si, device),
        "conv_b": torch.zeros((din,), dtype=dtype, device=device),
        "x_proj": _normal(gen, (din, dtr + 2 * s.state_dim), dtype, si,
                          device),
        "dt_proj": _normal(gen, (dtr, din), dtype, 1.0 / math.sqrt(dtr),
                           device),
        "dt_bias": torch.full((din,), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a0),
        "D": torch.ones((din,), dtype=torch.float32, device=device),
        "out_proj": _normal(gen, (din, d), dtype, si, device)}


# ---------------------------------------------------------------------------
# the block


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv in ``x``'s dtype.  x: [B,S,din]; w:
    [width,din]; state: optional [B,width-1,din] of the inputs *before* x
    (decode).  Adds the ``width`` taps in order, as the reference.  Returns
    (y [B,S,din], new_state [B,width-1,din])."""
    width, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    ext = torch.cat([state.to(x.dtype), x], dim=1)      # [B,W-1+S,din]
    y = b.to(x.dtype)[None, None]
    for i in range(width):
        y = y + w[i].to(x.dtype) * ext[:, i:i + S]
    return y, ext[:, S:]


def _softplus(x):
    """jax.nn.softplus, exact everywhere (``F.softplus`` turns into the
    identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_inputs(p, xc, cfg: ArchConfig, rules=None):
    """Shared projections, float32: xc [B,S,din] -> (dA [B,S,din,N] as the
    exp argument, Bx [B,S,din,N], C [B,S,N], xf [B,S,din]).  With
    ``rules`` (channel parallel) ``xc`` is the rank's channels and the
    ``x_proj`` product is summed over the model axis."""
    s, din, dtr = dims(cfg)
    xf = xc.float()
    proj = torch.matmul(xf, p["x_proj"].float())
    if rules is not None:
        proj = rules.mesh.sum_grad(
            rules.mesh.all_reduce_sum(proj, tp_lib.AXIS), tp_lib.AXIS)
    dt, B, C = torch.split(proj, [dtr, s.state_dim, s.state_dim], dim=-1)
    dt = torch.matmul(dt, p["dt_proj"].float())
    dt = _softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                  # [din,N]
    dA = dt[..., None] * A[None, None]                  # [B,S,din,N]
    Bx = dt[..., None] * B[:, :, None, :] * xf[..., None]
    return dA, Bx, C, xf


def _readout(p, h, C, xc, z, x, rules=None):
    """y = (h . C + D xc) silu(z), projected back in ``x``'s dtype (with
    ``rules``: the rank's rows of ``out_proj``, summed in float32)."""
    y = torch.einsum("bsdn,bsn->bsd", h, C)
    y = y + p["D"].float()[None, None] * xc.float()
    y = y * F.silu(z.float())
    out = torch.matmul(y.to(x.dtype), p["out_proj"].to(x.dtype))
    return out if rules is None else tp_lib.row_sum(out, rules, x.dtype)


def _channel_rules(p, cfg: ArchConfig, rules):
    """(p, the rules the block runs with): ``rules`` when it runs channel
    parallel, else None with ``in_proj`` whole (module docstring)."""
    if rules is None:
        return p, None
    _, din, _ = dims(cfg)
    if tp_lib.inner_split(din, rules):
        return p, rules
    return {**p, "in_proj": gather_dims(p["in_proj"], SSM_AXES["in_proj"],
                                        rules, {"inner": 2 * din})}, None


def _in_proj(p, x, rules=None):
    """x [B,S,D] -> (x_in, z), the input projection's halves (with
    ``rules``: of the rank's channels, ``manual_tp.xz_channels``)."""
    if rules is None:
        return torch.chunk(torch.matmul(x, p["in_proj"].to(x.dtype)), 2,
                           dim=-1)
    x = rules.mesh.sum_grad(x, tp_lib.AXIS)
    return tp_lib.xz_channels(torch.matmul(x, p["in_proj"].to(x.dtype)),
                              rules)


SCAN_CHUNK = 512  # bound the [B,chunk,din,N] scan working set


def apply_ssm(p, x, cfg: ArchConfig, state: Optional[SSMState] = None,
              chunk: int = SCAN_CHUNK, rules=None):
    """Full-sequence selective scan.  x: [B,S,D] -> (y [B,S,D], new
    SSMState).  A sequence longer than ``chunk`` whose length is a multiple
    of it runs as seeded chunks (the reference's rule), each seeded with
    the state the previous one left.  With ``rules``: the rank's blocks
    and state (module docstring)."""
    p, rules = _channel_rules(p, cfg, rules)
    S = x.shape[1]
    if chunk and S > chunk and S % chunk == 0:
        ys = []
        for i in range(S // chunk):
            y, state = _apply_ssm_core(p, x[:, i * chunk:(i + 1) * chunk],
                                       cfg, state, rules)
            ys.append(y)
        return torch.cat(ys, dim=1), state
    return _apply_ssm_core(p, x, cfg, state, rules)


def _apply_ssm_core(p, x, cfg: ArchConfig, state: Optional[SSMState] = None,
                    rules=None):
    xin, z = _in_proj(p, x, rules)
    conv_state = state.conv if state is not None else None
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dA, Bx, C, _ = _ssm_inputs(p, xc, cfg, rules)
    h = linear_scan(torch.exp(dA), Bx,
                    state.h if state is not None else None)   # [B,S,din,N]
    out = _readout(p, h, C, xc, z, x, rules)
    return out, SSMState(conv=conv_state, h=h[:, -1])


def decode_ssm(p, x, cfg: ArchConfig, state: SSMState, rules=None):
    """One-token step.  x: [B,1,D]; state: one layer's (with ``rules``:
    the rank's, module docstring)."""
    p, rules = _channel_rules(p, cfg, rules)
    xin, z = _in_proj(p, x, rules)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"], state.conv)
    xc = F.silu(xc)
    dA, Bx, C, _ = _ssm_inputs(p, xc, cfg, rules)
    h = state.h * torch.exp(dA[:, 0]) + Bx[:, 0]         # [B,din,N]
    out = _readout(p, h[:, None], C, xc, z, x, rules)
    return out, SSMState(conv=conv_state, h=h)


def ssm_state_specs(cfg: ArchConfig, batch, dtype, n_layers=None,
                    rules=None):
    """(shape, dtype) of each leaf of the state; with ``rules`` the rank's
    channels of it."""
    s, din, _ = dims(cfg)
    if rules is not None:
        din = local_shape((din,), ("inner",), rules)[0]
    L = (n_layers,) if n_layers else ()
    return SSMState(conv=(L + (batch, s.conv_width - 1, din), dtype),
                    h=(L + (batch, din, s.state_dim), torch.float32))


def init_ssm_state(cfg: ArchConfig, batch, dtype, n_layers=None,
                   device=None, rules=None) -> SSMState:
    return SSMState(*(torch.zeros(shape, dtype=dt, device=device)
                      for shape, dt in ssm_state_specs(cfg, batch, dtype,
                                                       n_layers, rules)))
