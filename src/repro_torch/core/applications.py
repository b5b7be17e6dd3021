"""FPP-based applications from the paper: BC, NCP, LL (§1, §6.1).

The port of the JAX package's ``repro.core.applications``.  Per the paper,
the FPP phase (the batched graph queries) dominates (>90%) and runs on the
buffered engine — on the card, through the port's kernels; the
per-application gather phases (Brandes accumulation, conductance sweeps,
label assembly) are host-side numpy, as in the reference.

The query phase goes through the ``FPPSession`` front door
(``fpp/session.py``); the gather phases are exposed standalone
(``bc_accumulate``, ``ncp_profile``) so the session's application methods
and these entry points share one implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.core.yielding import YieldConfig


def _session(g: CSRGraph, block_size: int, method: str,
             schedule: str, yield_config: Optional[YieldConfig],
             num_queries: int, device):
    from repro_torch.fpp.session import FPPSession   # lazy: import cycle
    return FPPSession(g, device=device).plan(
        num_queries=num_queries, block_size=block_size, method=method,
        schedule=schedule, yield_config=yield_config)


# ---------------------------------------------------------------------------
# Betweenness centrality (Brandes with sampled sources, Eppstein-style approx)


def _sigma_delta(g: CSRGraph, dist: np.ndarray):
    """Vectorized-by-level Brandes counting for one source's BFS ``dist``
    (int levels, -1 unreachable). Returns (sigma, delta)."""
    src, dst, _ = g.edges()
    sigma = np.zeros(g.n, dtype=np.float64)
    delta = np.zeros(g.n, dtype=np.float64)
    if (dist >= 0).sum() == 0:
        return sigma, delta
    root = int(np.flatnonzero(dist == 0)[0])
    sigma[root] = 1.0
    maxlev = int(dist.max())
    tree = (dist[src] >= 0) & (dist[dst] == dist[src] + 1)
    tsrc, tdst = src[tree], dst[tree]
    lev_of_edge = dist[tdst]  # level of the deeper endpoint
    for lev in range(1, maxlev + 1):
        sel = lev_of_edge == lev
        np.add.at(sigma, tdst[sel], sigma[tsrc[sel]])
    for lev in range(maxlev, 0, -1):
        sel = lev_of_edge == lev
        contrib = (sigma[tsrc[sel]] / np.maximum(sigma[tdst[sel]], 1.0)
                   * (1.0 + delta[tdst[sel]]))
        np.add.at(delta, tsrc[sel], contrib)
    return sigma, delta


def bc_accumulate(g: CSRGraph, sources: np.ndarray,
                  levels: np.ndarray) -> np.ndarray:
    """Brandes gather phase over per-source BFS levels (original ids).

    ``levels``: float [Q, n], +inf (or any non-finite) = unreachable.
    """
    bc = np.zeros(g.n, dtype=np.float64)
    for qi, s in enumerate(np.asarray(sources)):
        lev = levels[qi]
        lev = np.where(np.isfinite(lev), lev, -1).astype(np.int32)
        _, delta = _sigma_delta(g, lev)
        delta[s] = 0.0
        bc += delta
    return bc


def betweenness_centrality(g: CSRGraph, sources: np.ndarray,
                           block_size: int = 256, method: str = "bfs",
                           yield_config: Optional[YieldConfig] = None,
                           schedule: str = "priority", device=None):
    """Approximate BC by |sources| sampled BFS roots (paper: 100 random)."""
    sess = _session(g, block_size, method, schedule, yield_config,
                    len(np.asarray(sources)), device)
    bc, res = sess.bc(np.asarray(sources))
    return bc, res


# ---------------------------------------------------------------------------
# Landmark labeling


@dataclasses.dataclass
class LandmarkLabels:
    landmarks: np.ndarray   # [L]
    dists: np.ndarray       # [L, n] distances from each landmark

    def query(self, u, v) -> np.ndarray:
        """Upper-bound distance estimate via best landmark (paper's LL use)."""
        return np.min(self.dists[:, u] + self.dists[:, v], axis=0)


def landmark_labeling(g: CSRGraph, landmarks: np.ndarray,
                      block_size: int = 256, method: str = "bfs",
                      yield_config: Optional[YieldConfig] = None,
                      schedule: str = "priority", device=None):
    """Batch-of-SSSPs labeling (paper follows Akiba et al.: 16..1024 SSSPs)."""
    sess = _session(g, block_size, method, schedule, yield_config,
                    len(np.asarray(landmarks)), device)
    return sess.landmarks(np.asarray(landmarks))


# ---------------------------------------------------------------------------
# Network community profile (via many PPRs + sweep cuts)


def sweep_conductance(g: CSRGraph, p: np.ndarray):
    """Sweep cut over one PPR vector. Returns (sizes, conductances) along the
    sweep prefix order (deg-normalized, ACL standard)."""
    deg = g.out_degree().astype(np.float64)
    support = np.flatnonzero(p > 0)
    if support.size < 2:
        return np.array([], dtype=np.int64), np.array([])
    score = p[support] / np.maximum(deg[support], 1.0)
    order = support[np.argsort(-score, kind="stable")]
    rank = np.full(g.n, np.iinfo(np.int64).max, dtype=np.int64)
    rank[order] = np.arange(order.size)
    vol = np.cumsum(deg[order])
    src, dst, _ = g.edges()
    both = (rank[src] < order.size) & (rank[dst] < order.size)
    eranks = np.maximum(rank[src[both]], rank[dst[both]])
    internal = np.bincount(eranks, minlength=order.size).astype(np.float64)
    cut = vol - np.cumsum(internal)
    m2 = float(deg.sum())
    denom = np.minimum(vol, m2 - vol)
    keep = denom > 0
    cond = np.full(order.size, np.inf)
    cond[keep] = cut[keep] / denom[keep]
    sizes = np.arange(1, order.size + 1)
    return sizes, cond


def ncp_profile(g: CSRGraph, pvals: np.ndarray,
                max_size: Optional[int] = None) -> np.ndarray:
    """Min conductance per log2 cluster-size bin over PPR vectors [Q, n]."""
    max_size = max_size or g.n
    nbins = int(np.ceil(np.log2(max_size))) + 1
    best = np.full(nbins, np.inf)
    for qi in range(pvals.shape[0]):
        sizes, cond = sweep_conductance(g, pvals[qi])
        if sizes.size == 0:
            continue
        bins = np.minimum(np.log2(sizes).astype(np.int64), nbins - 1)
        np.minimum.at(best, bins, cond)
    return best


def ncp(g: CSRGraph, seeds: np.ndarray, alpha: float = 0.15,
        eps: float = 1e-4, block_size: int = 256, method: str = "bfs",
        yield_config: Optional[YieldConfig] = None,
        schedule: str = "priority", max_size: Optional[int] = None,
        device=None):
    """Network community profile: min conductance per cluster size (log bins).

    Paper setting: PPRs seeded from 0.01% random vertices (we take
    ``seeds``)."""
    sess = _session(g, block_size, method, schedule, yield_config,
                    len(np.asarray(seeds)), device)
    return sess.ncp(np.asarray(seeds), alpha=alpha, eps=eps,
                    max_size=max_size)
