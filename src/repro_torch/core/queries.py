"""Per-kind weight variants (the part of the JAX package's
``repro.core.queries`` this slice needs).

bfs rides the minplus engine over unit weights, so the session partitions
the unit-weight variant of the graph; the query facades of the reference
(``run_sssp`` and friends) wait for later slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.graph import CSRGraph

#: weight variant per kind; every other kind runs the natural weights
WEIGHT_VARIANTS = {"bfs": "unit", "cc": "zero", "kreach": "shift"}


def reweight(g: CSRGraph, variant: str,
             stride: Optional[float] = None) -> CSRGraph:
    """The kind's weight transform, applied at the CSR level so every
    backend partitions the *same* structure (identical perm across
    variants) and only the block values differ.

      natural  the graph as loaded
      unit     w = 1 (bfs: levels = unit-weight sssp)
      zero     w = 0 (cc: minplus relaxation degenerates to min-label
               propagation)
      shift    w = f32(w + S) with S = ``stride`` (kreach); the default
               stride comes with the kreach port (ROADMAP A6), so here it
               must be given
    """
    if variant == "natural":
        return g
    if variant == "unit":
        w = np.ones_like(g.weights)
    elif variant == "zero":
        w = np.zeros_like(g.weights)
    elif variant == "shift":
        if stride is None:
            raise NotImplementedError(
                "the default kreach stride is not ported yet (ROADMAP A6); "
                "pass stride=")
        w = (g.weights.astype(np.float32) + np.float32(stride)).astype(
            np.float32)
    else:
        raise ValueError(f"unknown weight variant {variant!r}; one of "
                         f"natural/unit/zero/shift")
    return CSRGraph(indptr=g.indptr, indices=g.indices, weights=w,
                    n=g.n, m=g.m)
