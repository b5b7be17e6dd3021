"""Backend dispatch behind one result contract.

The port of the JAX package's ``repro.fpp.backends``.  This slice runs the
``engine`` backend for sssp, bfs and ppr; every other (backend, kind) pair
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
Whatever the backend, ``values`` is float32 ``[Q, n]`` in the *reordered* id
space (the session maps back to original ids) and ``edges_processed`` is
float64 ``[Q]`` holding exact integral counts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.engine import FPPEngine
from repro_torch.core.graph import BlockGraph
from repro_torch.core.yielding import YieldConfig

BACKENDS = ("engine", "distributed", "baselines")
KINDS = ("sssp", "bfs", "ppr", "cc", "kreach", "rw")

#: engine mode per ported kind
_ENGINE_MODE = {"sssp": "minplus", "bfs": "minplus", "ppr": "push"}

#: where the pairs this slice does not run are queued
_ROADMAP = {"baselines": "A5", "distributed": "A10", "cc": "A6",
            "kreach": "A6", "rw": "A8"}


@dataclasses.dataclass
class BackendResult:
    values: np.ndarray                 # [Q, n] float32, reordered id space
    residual: Optional[np.ndarray]     # [Q, n] float32 (push kinds) or None
    edges_processed: np.ndarray        # [Q] float64
    stats: dict                        # visits / rounds / syncs / bytes


def _normalize(values, residual, edges, stats) -> BackendResult:
    return BackendResult(
        values=np.ascontiguousarray(np.asarray(values, dtype=np.float32)),
        residual=(None if residual is None
                  else np.asarray(residual, dtype=np.float32)),
        edges_processed=np.asarray(edges, dtype=np.float64),
        stats=stats)


def check_supported(backend: str, kind: str) -> None:
    """Raise unless this slice runs ``kind`` on ``backend``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if kind not in KINDS:
        raise ValueError(f"unknown query kind {kind!r}; one of {KINDS}")
    if backend != "engine":
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet "
            f"(ROADMAP {_ROADMAP[backend]})")
    if kind not in _ENGINE_MODE:
        raise NotImplementedError(
            f"kind {kind!r} is not ported yet (ROADMAP {_ROADMAP[kind]})")


def run_query(backend: str, kind: str, bg: BlockGraph, sources: np.ndarray,
              *, schedule: str = "priority",
              yield_config: Optional[YieldConfig] = None,
              alpha: float = 0.15, eps: float = 1e-4,
              max_visits: Optional[int] = None,
              fused: bool = False, frontier_mode: str = "dense",
              device=None) -> BackendResult:
    """Run one query batch (sources in reordered ids) on one backend.
    bfs expects ``bg`` built from the unit-weight variant (the session's
    ``prepared`` does this).  ``fused=True`` (engine backend only) runs
    each K-visit chunk as one launch of the fused visit kernel;
    ``frontier_mode="sparse"`` (minplus kinds) lets it skip query rows whose
    sources are all +inf."""
    if fused and backend != "engine":
        raise ValueError(
            f"fused=True is an engine-backend flag; backend={backend!r} "
            f"runs its own visit bodies")
    check_supported(backend, kind)
    sources = np.asarray(sources)
    eng = FPPEngine(bg, mode=_ENGINE_MODE[kind], num_queries=len(sources),
                    yield_config=yield_config or YieldConfig(),
                    schedule=schedule, alpha=alpha, eps=eps, fused=fused,
                    frontier_mode=frontier_mode, device=device)
    res = eng.run(sources, max_visits=max_visits)
    return _normalize(res.values, res.residual, res.edges_processed, {
        "visits": res.stats.visits, "rounds": res.stats.rounds,
        "blocks_loaded": res.stats.blocks_loaded,
        "modeled_bytes": res.stats.modeled_bytes,
        "host_syncs": res.stats.host_syncs,
        "device_syncs": res.stats.device_syncs})
