"""Plain PyTorch versions of the contraction kernels (``csrc/minplus.cu``).

``minplus_ref(d, w)[..., q, v] = min_u d[q, u] + w[..., u, v]``
``masked_matmul_ref(x, w) = x @ isfinite(w)``

The CPU path of ``ops`` runs these, and the card's kernels are held against
them.  ``w`` may carry leading batch dims (``[S, B, B]`` gives ``[S, Q, B]``).
"""
from __future__ import annotations

import torch


#: contraction-dim chunk of ``minplus_ref``
_CHUNK = 32


def minplus_ref(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d: [Q, B] (+inf inactive); w: [..., B, B] (+inf absent).

    Chunked over the contraction dim so the candidate temp is
    ``[..., Q, _CHUNK, B]``, not ``[..., Q, B, B]``.  Chunking only
    reassociates an exact min, so the result does not depend on it.
    """
    q, b = d.shape
    if w.shape[-2:] != (b, b):
        raise ValueError(f"weight block must be [..., {b}, {b}] to match d "
                         f"{(q, b)}; got {tuple(w.shape)}")
    out = torch.full((*w.shape[:-2], q, b), float("inf"), dtype=d.dtype,
                     device=d.device)
    for u0 in range(0, b, _CHUNK):
        u1 = min(u0 + _CHUNK, b)
        cand = (d[:, u0:u1, None] + w[..., None, u0:u1, :]).amin(dim=-2)
        torch.minimum(out, cand, out=out)
    return out


def masked_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """PPR spread: ``out[..., q, v] = sum_u x[q, u] * [w[..., u, v] finite]``."""
    return x @ torch.isfinite(w).to(x.dtype)
