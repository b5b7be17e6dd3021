"""Plain PyTorch versions of the contraction kernels (``csrc/minplus.cu``).

``minplus_ref(d, w)[..., q, v] = min_u d[q, u] + w[..., u, v]``
``masked_matmul_ref(x, w) = x @ isfinite(w)``

The CPU path of ``ops`` runs these on the dense blocks, and the card's
kernels are held against them.  ``w`` may carry leading batch dims
(``[S, B, B]`` gives ``[S, Q, B]``).

:func:`list_contract_ref` emulates the kernels' own per-cell order over the
column lists of each block's finite entries (``core/engine.column_lists``),
the tile the fused visit shares; the tests hold it against the dense
versions bit for bit.
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


def list_contract_ref(name: str, x: torch.Tensor, col_ptr: torch.Tensor,
                      col_u: torch.Tensor, col_w: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """The kernels' list contraction of ``x [Q, B]`` with blocks ``idx
    [S]`` (``< 0``: the identity plane; ``>= nblk``: a NaN plane),
    ``[S, Q, B]``: each output cell (q, v) takes the entries of column v's
    list one after another, in ascending u,
      ``"minplus"``        acc = min(acc, x[q, u] + w)     from +inf
      ``"masked_matmul"``  acc = acc + x[q, u]              from +0
    (``acc + x`` rounds once, as the kernels' ``fmaf(x, 1, acc)``)."""
    minplus = name == "minplus"
    Q, B = x.shape
    out = torch.full((idx.shape[0], Q, B), float("inf") if minplus else 0.0,
                     dtype=x.dtype, device=x.device)
    for s, k in enumerate(idx.tolist()):
        if k < 0:
            continue
        if k >= col_ptr.shape[0]:
            out[s] = float("nan")
            continue
        ptr = col_ptr[k].long()
        count = ptr[1:] - ptr[:-1]
        acc = out[s]
        for e in range(int(count.max()) if B else 0):
            cols = torch.nonzero(count > e).squeeze(1)
            pos = ptr[cols] + e
            xs = x[:, col_u[pos].long()]
            if minplus:
                acc[:, cols] = torch.minimum(acc[:, cols], xs + col_w[pos])
            else:
                acc[:, cols] = acc[:, cols] + xs
    return out
