"""Graph partitioning = vertex reordering + contiguous block-sized ranges.

A numpy copy of the JAX package's ``repro.core.partition``.  A partition
must be a *contiguous vertex range* so the adjacency block layout is dense
and a kernel addresses a block by one index.  Partitioning is therefore a
reordering problem:

  bfs        BFS-clustering order: grow clusters of ``block_size`` vertices by
             BFS from unvisited seeds — a cheap, dependency-free stand-in for
             METIS that minimizes cross-block edges on meshes and many webs
             (the default for road-like graphs).
  degree     hub-first order.
  random     the paper's fallback for social networks.
  natural    identity (whatever order the generator produced).
"""
from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np

from repro_torch.core.graph import BlockGraph, CSRGraph


def bfs_cluster_order(g: CSRGraph, block_size: int) -> np.ndarray:
    """perm[v] = new id of v.  Grows BFS clusters so blocks are locality tight."""
    n = g.n
    perm = np.full(n, -1, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    nxt = 0
    # seed scan order: by degree descending visits dense cores first which keeps
    # hub neighborhoods together; remaining singletons appended at the end.
    seeds = np.argsort(-g.out_degree(), kind="stable")
    dq: deque[int] = deque()
    for s in seeds:
        if visited[s]:
            continue
        dq.append(int(s))
        visited[s] = True
        while dq:
            u = dq.popleft()
            perm[u] = nxt
            nxt += 1
            for e in range(g.indptr[u], g.indptr[u + 1]):
                v = int(g.indices[e])
                if not visited[v]:
                    visited[v] = True
                    dq.append(v)
    if nxt != n:
        raise RuntimeError(
            f"BFS order covered {nxt} of {n} vertices — graph traversal "
            f"missed a component; CSR structure is inconsistent")
    return perm


def degree_order(g: CSRGraph) -> np.ndarray:
    order = np.argsort(-g.out_degree(), kind="stable")
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    return perm


def random_order(g: CSRGraph, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(g.n).astype(np.int64)


def partition(g: CSRGraph, block_size: int, method: str = "bfs",
              seed: int = 0) -> Tuple[BlockGraph, np.ndarray]:
    """Returns (block graph, perm) with ``perm[old_id] = new_id``."""
    if method == "bfs":
        perm = bfs_cluster_order(g, block_size)
    elif method == "degree":
        perm = degree_order(g)
    elif method == "random":
        perm = random_order(g, seed)
    elif method == "natural":
        perm = np.arange(g.n, dtype=np.int64)
    else:
        raise ValueError(f"unknown partition method {method!r}")
    gp = g.permute(perm) if method != "natural" else g
    return BlockGraph.from_csr(gp, block_size), perm


def edge_cut_fraction(bg: BlockGraph) -> float:
    """Fraction of edges crossing partition boundaries (lower = better)."""
    diag = bg.row_nnz[bg.diag_blk].sum()
    total = bg.row_nnz.sum()
    return float(1.0 - diag / max(1, total))
