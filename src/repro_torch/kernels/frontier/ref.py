"""Plain PyTorch version of the frontier kernel (``csrc/frontier.cu``).

The port of the reference's ``frontier_tile``: the consolidation that
starts a min-plus visit, in the expression order of
``core/visit.minplus_algebra.begin``.
"""
from __future__ import annotations

import torch

INF = float("inf")


def frontier_ref(buf: torch.Tensor, dist: torch.Tensor, *, delta: float,
                 strict: bool = False):
    """buf, dist: [Q, B] -> ``(d1, srcs, alpha, pending, active)``.

    ``alpha`` is the per-row best pending value, kept ``[Q, 1]``.
    ``strict`` pends an op only when it strictly improves the value
    (``minplus_algebra(strict=True)``).
    """
    lt = torch.lt if strict else torch.le
    pending = torch.isfinite(buf) & lt(buf, dist)
    d1 = torch.minimum(dist, torch.where(pending, buf, INF))
    alpha = torch.where(pending, d1, INF).amin(dim=1, keepdim=True)
    active = pending & (d1 <= alpha + delta)
    srcs = torch.where(active, d1, INF)
    return d1, srcs, alpha, pending, active
