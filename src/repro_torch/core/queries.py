"""Query-type facade: the FPP query kinds ForkGraph supports (paper §3).

The port of the JAX package's ``repro.core.queries``.  sssp and bfs ride
the minplus engine, ppr the push engine, cc the minplus engine over a
zero-weight variant with every-vertex label init, weighted k-reach over
hop-shifted weights (lexicographic (hops, dist) packing, see
``oracles.kreach_stride``).  Every function takes sources in the
*reordered* vertex id space of ``bg`` (``perm[old_id]`` from
``partition``); the weight-variant kinds expect ``bg`` built from the
matching :func:`reweight` of the CSR.  rw has its own buffered walker
loop (``core/randomwalk.py``) over the natural graph.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine import EngineResult, FPPEngine
from repro_torch.core.graph import BlockGraph, CSRGraph
from repro_torch.core.oracles import kreach_stride
from repro_torch.core.partition import partition
from repro_torch.core.randomwalk import WalkResult, run_random_walks
from repro_torch.core.yielding import YieldConfig, default_delta

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
      shift    w = f32(w + S) with S = ``stride`` (default
               ``oracles.kreach_stride``): packed minplus fixpoints become
               lexicographic (hops, dist) minima for kreach
    """
    if variant == "natural":
        return g
    if variant == "unit":
        w = np.ones_like(g.weights)
    elif variant == "zero":
        w = np.zeros_like(g.weights)
    elif variant == "shift":
        if stride is None:
            stride = kreach_stride(
                g.n, float(g.weights.max()) if g.m else 1.0)
        w = (g.weights.astype(np.float32) + np.float32(stride)).astype(
            np.float32)
    else:
        raise ValueError(f"unknown weight variant {variant!r}; one of "
                         f"natural/unit/zero/shift")
    return CSRGraph(indptr=g.indptr, indices=g.indices, weights=w,
                    n=g.n, m=g.m)


def run_sssp(bg: BlockGraph, sources: np.ndarray,
             yield_config: Optional[YieldConfig] = None,
             schedule: str = "priority", device=None,
             **run_kwargs) -> EngineResult:
    yc = yield_config or YieldConfig(
        delta=default_delta(float(np.nanmax(np.where(
            np.isfinite(bg.blocks), bg.blocks, np.nan)))))
    eng = FPPEngine(bg, mode="minplus", num_queries=len(sources),
                    yield_config=yc, schedule=schedule, device=device)
    return eng.run(np.asarray(sources), **run_kwargs)


def run_bfs(bg_unit: BlockGraph, sources: np.ndarray,
            yield_config: Optional[YieldConfig] = None,
            schedule: str = "priority", device=None,
            **run_kwargs) -> EngineResult:
    """bg_unit must be built from a unit-weight CSR (BFS = SSSP w=1).
    Returned values are float levels; +inf = unreachable."""
    yc = yield_config or YieldConfig(delta=1.0)  # Δ=1 == level-synchronous
    eng = FPPEngine(bg_unit, mode="minplus", num_queries=len(sources),
                    yield_config=yc, schedule=schedule, device=device)
    return eng.run(np.asarray(sources), **run_kwargs)


def run_ppr(bg: BlockGraph, sources: np.ndarray, alpha: float = 0.15,
            eps: float = 1e-4, yield_config: Optional[YieldConfig] = None,
            schedule: str = "priority", device=None,
            **run_kwargs) -> EngineResult:
    yc = yield_config or YieldConfig(mu_factor=100.0)  # paper's NCP setting
    eng = FPPEngine(bg, mode="push", num_queries=len(sources), alpha=alpha,
                    eps=eps, yield_config=yc, schedule=schedule,
                    device=device)
    return eng.run(np.asarray(sources), **run_kwargs)


def run_cc(bg_zero: BlockGraph, sources: np.ndarray,
           schedule: str = "priority", device=None,
           **run_kwargs) -> EngineResult:
    """bg_zero must be built from the "zero" weight variant.  Returned
    values are raw reordered-rep labels (every lane identical); callers
    canonicalize via ``fpp.backends.canonicalize_cc`` after mapping to
    original ids."""
    eng = FPPEngine(bg_zero, mode="cc", num_queries=len(sources),
                    schedule=schedule, device=device)
    return eng.run(np.asarray(sources), **run_kwargs)


def run_kreach(bg_shift: BlockGraph, sources: np.ndarray, k: int,
               stride: float, schedule: str = "priority", device=None,
               **run_kwargs) -> EngineResult:
    """bg_shift must be built from the "shift" variant with the same
    ``stride``.  values = dist of the hop-minimal path where hops <= k
    (+inf beyond the budget); residual carries the hop plane."""
    eng = FPPEngine(bg_shift, mode="kreach", num_queries=len(sources),
                    schedule=schedule, hop_budget=k, hop_stride=stride,
                    device=device)
    return eng.run(np.asarray(sources), **run_kwargs)


def run_rw(bg: BlockGraph, sources: np.ndarray, length: int = 32,
           seed: int = 0, device=None) -> WalkResult:
    return run_random_walks(bg, np.asarray(sources), length, seed=seed,
                            device=device)


def prepare(g: CSRGraph, block_size: int, method: str = "bfs",
            unit_weights: bool = False, weights: Optional[str] = None):
    """One-stop: (block graph, perm).  ``weights`` picks the variant
    (:func:`reweight`); ``unit_weights=True`` is the legacy spelling of
    ``weights="unit"``."""
    variant = weights or ("unit" if unit_weights else "natural")
    return partition(reweight(g, variant), block_size, method=method)
