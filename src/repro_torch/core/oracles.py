"""Sequential references: the kinds' answers computed one query at a time.

A numpy copy of the JAX package's ``repro.core.oracles`` (the port imports
nothing of that package): Dijkstra (binary heap) for sssp, deque BFS (and
its shortest-path counts for betweenness), Andersen-Chung-Lang push for
ppr, union-find and min-label propagation for cc, and the hop-shifted
Dijkstra with its decode for kreach; each also reports
``edges_processed``; :func:`dfs_order` labels a DFS preorder.  The
random-walk replay (:func:`random_walk`) draws through the port's
threefry stream (``core/prng``) on the CPU.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, Tuple

import numpy as np

from repro_torch.core import prng
from repro_torch.core.graph import CSRGraph


def dijkstra(g: CSRGraph, src: int) -> Tuple[np.ndarray, int]:
    dist = np.full(g.n, np.inf, dtype=np.float64)
    dist[src] = 0.0
    done = np.zeros(g.n, dtype=bool)
    heap = [(0.0, src)]
    edges = 0
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for e in range(g.indptr[u], g.indptr[u + 1]):
            v = int(g.indices[e])
            edges += 1
            nd = d + float(g.weights[e])
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist.astype(np.float32), edges


def bfs(g: CSRGraph, src: int) -> Tuple[np.ndarray, int]:
    dist = np.full(g.n, -1, dtype=np.int32)
    dist[src] = 0
    dq = deque([src])
    edges = 0
    while dq:
        u = dq.popleft()
        for e in range(g.indptr[u], g.indptr[u + 1]):
            v = int(g.indices[e])
            edges += 1
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                dq.append(v)
    return dist, edges


def bfs_sigma(g: CSRGraph, src: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """BFS distances + shortest-path counts (for Brandes BC)."""
    dist = np.full(g.n, -1, dtype=np.int32)
    sigma = np.zeros(g.n, dtype=np.float64)
    dist[src] = 0
    sigma[src] = 1.0
    dq = deque([src])
    edges = 0
    while dq:
        u = dq.popleft()
        for e in range(g.indptr[u], g.indptr[u + 1]):
            v = int(g.indices[e])
            edges += 1
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                dq.append(v)
            if dist[v] == dist[u] + 1:
                sigma[v] += sigma[u]
    return dist, sigma, edges


def ppr_push(g: CSRGraph, src: int, alpha: float = 0.15,
             eps: float = 1e-4) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sequential ACL push (the paper reuses Shun et al. [54]'s version).

    Invariant maintained: p + alpha-smoothed residual approximates the PPR
    vector; terminates when all residuals r[u] < eps * deg(u).
    """
    deg = np.maximum(g.out_degree(), 1).astype(np.float64)
    p = np.zeros(g.n, dtype=np.float64)
    r = np.zeros(g.n, dtype=np.float64)
    r[src] = 1.0
    edges = 0
    queue = deque([src])
    inq = np.zeros(g.n, dtype=bool)
    inq[src] = True
    while queue:
        u = queue.popleft()
        inq[u] = False
        ru = r[u]
        if ru < eps * deg[u]:
            continue
        p[u] += alpha * ru
        push = (1.0 - alpha) * ru / deg[u]
        r[u] = 0.0
        for e in range(g.indptr[u], g.indptr[u + 1]):
            v = int(g.indices[e])
            edges += 1
            r[v] += push
            if r[v] >= eps * deg[v] and not inq[v]:
                inq[v] = True
                queue.append(v)
    return p.astype(np.float32), r.astype(np.float32), edges


def connected_components(g: CSRGraph) -> np.ndarray:
    """Union-find component labels; label = min vertex id in the component.

    The differential anchor for the ``cc`` kind: min-label propagation over
    a symmetrized graph must converge to exactly these labels.
    """
    parent = np.arange(g.n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:           # path compression
            parent[x], x = root, int(parent[x])
        return root

    src, dst, _ = g.edges()
    for u, v in zip(src, dst):
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(int(v)) for v in range(g.n)], dtype=np.int64)


def label_prop(g: CSRGraph) -> Tuple[np.ndarray, int]:
    """Synchronous min-label propagation to fixpoint (labels, rounds).

    The sequential twin of the visit-algebra ``cc`` kind: every vertex
    starts labeled with its own id and repeatedly takes the min over its
    in-labels; on symmetrized graphs the fixpoint equals union-find.
    """
    labels = np.arange(g.n, dtype=np.int64)
    src, dst, _ = g.edges()
    rounds = 0
    while True:
        nxt = labels.copy()
        np.minimum.at(nxt, dst, labels[src])
        rounds += 1
        if (nxt == labels).all():
            return labels, rounds
        labels = nxt


def kreach_stride(n: int, weights_max: float) -> float:
    """The hop-packing stride S shared by every ``kreach`` backend and the
    oracle: the smallest power of two exceeding twice the largest possible
    path weight, so ``packed = hops * S + dist`` decodes exactly in f32
    (``hops * S`` is representable and ``dist < S / 2`` can never carry)."""
    hi = 2.0 * max(1.0, float(n)) * max(1.0, float(weights_max))
    s = 2.0
    while s <= hi:
        s *= 2.0
    return s


def decode_kreach(packed: np.ndarray, stride: float, k: int):
    """Unpack the lexicographic (hops, dist) plane: ``values`` is the dist
    of the hop-minimal path where ``hops <= k`` (else +inf), ``hops`` the
    hop count (+inf unreachable).  Shared by the engine finalize, the
    distributed/baseline decodes, and the oracle — the decode is part of
    the kind's contract, so it lives in exactly one place."""
    p64 = np.asarray(packed, np.float64)
    finite = np.isfinite(p64)
    hops = np.floor(np.where(finite, p64, 0.0) / float(stride))
    dist = p64 - hops * float(stride)
    values = np.where(finite & (hops <= k), dist, np.inf).astype(np.float32)
    hops = np.where(finite, hops, np.inf).astype(np.float32)
    return values, hops


def kreach(g: CSRGraph, src: int, k: int,
           stride: float | None = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sequential weighted k-reach: Dijkstra over the hop-shifted weights
    ``w' = f32(w + S)`` with f32 accumulation — expression-identical to the
    relaxations the block backends run, so parity is bitwise, not approximate.
    Returns (values, hops, edges) per :func:`decode_kreach`."""
    if stride is None:
        stride = kreach_stride(g.n, float(g.weights.max()) if g.m else 1.0)
    s32 = np.float32(stride)
    dist = np.full(g.n, np.inf, dtype=np.float32)
    dist[src] = np.float32(0.0)
    done = np.zeros(g.n, dtype=bool)
    heap = [(np.float32(0.0), src)]
    edges = 0
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for e in range(g.indptr[u], g.indptr[u + 1]):
            v = int(g.indices[e])
            edges += 1
            nd = np.float32(d + np.float32(np.float32(g.weights[e]) + s32))
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    values, hops = decode_kreach(dist, stride, k)
    return values, hops, edges


def random_walk(bg, src: int, length: int, seed: int = 0) -> np.ndarray:
    """Sequential replay of one walker's tape over the block layout.

    The randomness contract of the ``rw`` kind: at (source ``src``, step
    ``t``) the walker draws ``u = uniform(fold_in(fold_in(PRNGKey(seed),
    src), t))`` and takes the ``min(floor(u * deg), deg - 1)``-th finite
    entry of its block-layout adjacency row (diagonal columns first, then
    the ``nbr_blk`` slots in order).  Returns the visited positions (start
    included, at most ``length + 1``; a walk parked on a sink ends there,
    as the runtimes' occupancy planes count each visited position once).
    """
    base = prng.fold_in(prng.PRNGKey(seed), int(src))
    B = bg.block_size
    pos = int(src)
    out = [pos]
    for t in range(length):
        p, loc = pos // B, pos % B
        row = np.concatenate(
            [bg.blocks[bg.diag_blk[p]][loc]]
            + [np.where(bg.nbr_part[p, j] >= 0,
                        bg.blocks[bg.nbr_blk[p, j]][loc], np.inf)
               for j in range(bg.nbr_part.shape[1])])
        finite = np.isfinite(row)
        deg = int(finite.sum())
        if deg == 0:
            break
        u = np.float32(prng.uniform(prng.fold_in(base, t)).item())
        # f32 product, as the stepper computes it
        idx = min(int(np.floor(u * np.float32(deg))), deg - 1)
        col = int(np.flatnonzero(finite)[idx])
        slot, local = col // B, col % B
        dest_part = p if slot == 0 else int(bg.nbr_part[p, slot - 1])
        pos = dest_part * B + local
        out.append(pos)
    return np.asarray(out, dtype=np.int64)


def dfs_order(g: CSRGraph, src: int) -> np.ndarray:
    """Preorder DFS labels (int32, -1 unreachable): an explicit stack
    whose pushes run each vertex's edges last to first, so the first edge
    is visited first.  Host-only reference."""
    label = np.full(g.n, -1, dtype=np.int32)
    stack = [src]
    nxt = 0
    while stack:
        u = stack.pop()
        if label[u] >= 0:
            continue
        label[u] = nxt
        nxt += 1
        for e in range(g.indptr[u + 1] - 1, g.indptr[u] - 1, -1):
            v = int(g.indices[e])
            if label[v] < 0:
                stack.append(v)
    return label


def batch(fn, g: CSRGraph, sources) -> Dict[int, tuple]:
    return {int(s): fn(g, int(s)) for s in sources}
