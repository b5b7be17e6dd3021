"""Plain PyTorch version of the push kernel (``csrc/ppr_push.cu``).

The port of the reference's ``push_tile``: one ACL push round, in the
expression order of ``core/visit.push_algebra.active`` and ``.step``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.minplus.ref import masked_matmul_ref


def push_ref(p: torch.Tensor, r: torch.Tensor, acc: torch.Tensor,
             w: Optional[torch.Tensor], deg: torch.Tensor, *, alpha: float,
             eps: float, lane_mask: Optional[torch.Tensor] = None,
             spread: Optional[Callable] = None):
    """p, r, acc: [Q, B]; w: [B, B] (+inf absent); deg: [B] (or [1, B]),
    integer or float.  Returns ``(p1, r1, acc1, active)``.

    ``lane_mask`` (bool, broadcastable to [Q, B]) further gates the active
    set (the fused visit passes the per-query edge-budget lane).
    ``spread(x) -> [Q, B]`` replaces ``masked_matmul_ref(x, w)`` (the
    fused visit's plain version passes the engine's own contraction call,
    so both run the same float32 sum).
    """
    degc = torch.clamp(deg, min=1).to(torch.float32)
    active = (r >= eps * degc) & (deg > 0)
    if lane_mask is not None:
        active = active & lane_mask
    af = active.to(r.dtype)
    p1 = p + alpha * r * af
    pushed = (1.0 - alpha) * r * af / degc
    sp = masked_matmul_ref(pushed, w) if spread is None else spread(pushed)
    r1 = r * (1.0 - af) + sp
    return p1, r1, acc + pushed, active
