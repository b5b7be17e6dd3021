"""Yielding heuristics (paper §5.1) in dense form.

A numpy copy of the JAX package's ``repro.core.yielding``.

Heuristic 1 — edge budget: a query yields inside a partition visit once it has
processed more than ``mu_factor * |E_P| / |Q|`` edges this visit (μ is the
theoretical threshold from Appendix A; the paper sweeps 0.25μ..4μ and uses
100μ for NCP).

Heuristic 2 — value window: a query only relaxes operations whose value is
within ``delta`` of α, the best value it applied when the visit started
(Δ-stepping style).

Both heuristics only *pause* work: yielded ops stay in the partition buffer and
are re-scheduled later, so results remain exact (paper §5.1).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class YieldConfig:
    # heuristic 1: per-query edge budget per visit = mu_factor * |E_P| / |Q|.
    # None disables the heuristic (budget = +inf).
    mu_factor: float | None = None
    # heuristic 2: absolute value window Δ. None disables.
    delta: float | None = None
    # hard cap on local relaxation rounds (correctness never depends on it —
    # pending ops survive in the buffer). Dense Bellman-Ford settles a B-vertex
    # partition in <= B rounds; PPR uses the cap as its only local limit.
    max_rounds: int = 0  # 0 => engine picks block_size for minplus / 64 for push

    def edge_budget(self, part_edges: np.ndarray, num_queries: int) -> np.ndarray:
        """Per-partition per-query edge budget (float32 [P])."""
        if self.mu_factor is None:
            return np.full(part_edges.shape, np.inf, dtype=np.float32)
        mu = part_edges.astype(np.float64) / max(1, num_queries)
        return np.maximum(1.0, self.mu_factor * mu).astype(np.float32)

    def window(self) -> float:
        return np.inf if self.delta is None else float(self.delta)


NO_YIELD = YieldConfig(mu_factor=None, delta=None)


def default_delta(weights_max: float) -> float:
    """Δ-stepping style default: the max edge weight (for synthetic
    uniform-[1, log n) weights w_max works)."""
    return float(max(1.0, weights_max))
