"""RG-LRU recurrent block (recurrentgemma-2b / Griffin).

The port of the JAX package's ``repro.models.rglru``: the temporal mix of
the "recurrent" layers of the 1:2 hybrid pattern,

    r_t = sigmoid(w_a * x_t + b_a)          (recurrence gate)
    i_t = sigmoid(w_x * x_t + b_x)          (input gate)
    a_t = exp(c * r_t * log(sigmoid(lam)))  (per-channel decay, c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

with per-channel (diagonal) gates, as the reference.  The full-sequence path
runs the recurrence with ``ssm.linear_scan`` (the reference:
``jax.lax.associative_scan``); decode is one O(1) step.

On a mesh (``rules`` and ``cfg``: the rank's blocks of the leaves, their
FSDP split gathered by the caller) the block runs channel parallel over
``"model"`` when the axis splits ``lru_width`` (``manual_tp.inner_split``):
``in_x`` and ``in_gate`` column parallel (the block's input sums its
gradient over the axis), the conv, the gates, ``lam`` and the scan on the
rank's channels with no collective, and ``out`` row parallel, its partial
products summed in float32 and rounded once.  The state is the rank's
channels.  Otherwise every leaf is whole and the block runs whole.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, HybridConfig
from repro_torch.models import manual_tp as tp_lib
from repro_torch.models.layers import _act, _normal
from repro_torch.models.sharding import local_shape
from repro_torch.models.ssm import _causal_conv, linear_scan

_C = 8.0


class LRUState(NamedTuple):
    conv: torch.Tensor   # [L?, B, conv_width-1, W]
    h: torch.Tensor      # [L?, B, W] (float32)


def lru_width(cfg: ArchConfig) -> int:
    h = cfg.hybrid or HybridConfig()
    return h.lru_width or cfg.d_model


#: the reference's logical axes of an RG-LRU block's leaves
RGLRU_AXES = {"in_x": ("embed", "inner"), "in_gate": ("embed", "inner"),
              "conv_w": ("conv", "inner"), "conv_b": ("inner",),
              "w_a": ("inner",), "b_a": ("inner",), "w_x": ("inner",),
              "b_x": ("inner",), "lam": ("inner",), "out": ("inner", "embed")}


def init_rglru(gen, cfg: ArchConfig, dtype, device=None, conv_width=4):
    """The reference's leaves and scales; ``lam`` so that a lies in [0.9,
    0.999] at r = 1 (Griffin's appendix)."""
    d, w = cfg.d_model, lru_width(cfg)
    s = 1.0 / math.sqrt(d)
    u = torch.empty((w,), dtype=torch.float32, device=device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.sqrt(u) / (1 - torch.sqrt(u)))  # logit of sqrt(u)

    def zeros():
        return torch.zeros((w,), dtype=torch.float32, device=device)
    return {"in_x": _normal(gen, (d, w), dtype, s, device),
            "in_gate": _normal(gen, (d, w), dtype, s, device),
            "conv_w": _normal(gen, (conv_width, w), dtype,
                              1.0 / math.sqrt(w), device),
            "conv_b": torch.zeros((w,), dtype=dtype, device=device),
            "w_a": zeros(), "b_a": zeros(), "w_x": zeros(), "b_x": zeros(),
            "lam": lam,
            "out": _normal(gen, (w, d), dtype, 1.0 / math.sqrt(w), device)}


def _gates(p, xc):
    """xc: [B,S,W] (after the conv) -> (log_a, bx), float32."""
    xf = xc.float()
    r = torch.sigmoid(p["w_a"] * xf + p["b_a"])
    i = torch.sigmoid(p["w_x"] * xf + p["b_x"])
    log_a = _C * r * F.logsigmoid(p["lam"])             # [B,S,W]
    a2 = torch.exp(2.0 * log_a)
    bx = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9)) * i * xf
    return log_a, bx


def _mix(p, x, state_conv, rules=None):
    """The two input projections and the conv: (xc, gate, conv state)."""
    if rules is not None:
        x = rules.mesh.sum_grad(x, tp_lib.AXIS)
    xw = torch.matmul(x, p["in_x"].to(x.dtype))
    gate = torch.matmul(x, p["in_gate"].to(x.dtype))
    xc, conv_state = _causal_conv(xw, p["conv_w"], p["conv_b"], state_conv)
    return xc, gate, conv_state


def _out(p, h, gate, x, rules=None):
    y = h * _act(gate.float(), "gelu")
    out = torch.matmul(y.to(x.dtype), p["out"].to(x.dtype))
    return out if rules is None else tp_lib.row_sum(out, rules, x.dtype)


def _channel_rules(cfg, rules):
    """The rules the block runs with: ``rules`` when it runs channel
    parallel, else None (every leaf whole)."""
    if rules is None or not tp_lib.inner_split(lru_width(cfg), rules):
        return None
    return rules


SCAN_CHUNK = 1024


def apply_rglru(p, x, state: Optional[LRUState] = None,
                chunk: int = SCAN_CHUNK, *, cfg: Optional[ArchConfig] = None,
                rules=None):
    """x: [B,S,D] -> (y [B,S,D], new LRUState).  Seeded chunks for a
    sequence longer than ``chunk`` whose length is a multiple of it, as in
    ``ssm.apply_ssm``.  With ``rules`` (and the ``cfg`` that gives the
    whole width): the rank's blocks and state (module docstring)."""
    rules = _channel_rules(cfg, rules)
    S = x.shape[1]
    if chunk and S > chunk and S % chunk == 0:
        ys = []
        for i in range(S // chunk):
            y, state = _apply_rglru_core(p, x[:, i * chunk:(i + 1) * chunk],
                                         state, rules)
            ys.append(y)
        return torch.cat(ys, dim=1), state
    return _apply_rglru_core(p, x, state, rules)


def _apply_rglru_core(p, x, state: Optional[LRUState] = None, rules=None):
    xc, gate, conv_state = _mix(p, x, state.conv if state is not None
                                else None, rules)
    log_a, bx = _gates(p, xc)
    h = linear_scan(torch.exp(log_a), bx,
                    state.h if state is not None else None)   # [B,S,W] f32
    return _out(p, h, gate, x, rules), LRUState(conv=conv_state, h=h[:, -1])


def decode_rglru(p, x, state: LRUState, *, cfg: Optional[ArchConfig] = None,
                 rules=None):
    """One-token step.  x: [B,1,D] (``cfg`` and ``rules`` as for
    :func:`apply_rglru`)."""
    rules = _channel_rules(cfg, rules)
    xc, gate, conv_state = _mix(p, x, state.conv, rules)
    log_a, bx = _gates(p, xc)
    h = state.h * torch.exp(log_a[:, 0]) + bx[:, 0]     # [B,W]
    return _out(p, h[:, None], gate, x, rules), LRUState(conv=conv_state, h=h)


def lru_state_specs(cfg: ArchConfig, batch, dtype, n=None, conv_width=4,
                    rules=None):
    """(shape, dtype) of each leaf of the state; with ``rules`` the rank's
    channels of it."""
    w = lru_width(cfg)
    if rules is not None:
        w = local_shape((w,), ("inner",), rules)[0]
    L = (n,) if n else ()
    return LRUState(conv=(L + (batch, conv_width - 1, w), dtype),
                    h=(L + (batch, w), torch.float32))


def init_lru_state(cfg: ArchConfig, batch, dtype, n=None, device=None,
                   conv_width=4, rules=None) -> LRUState:
    return LRUState(*(torch.zeros(shape, dtype=dt, device=device)
                      for shape, dt in lru_state_specs(cfg, batch, dtype, n,
                                                       conv_width, rules)))
