"""GPS baselines the paper compares against, on the same block substrate.

The port of the JAX package's ``repro.core.baselines``: ``global_minplus``,
``global_push`` and ``global_random_walks``.  The first two are
synchronous global-frontier engines: every round
streams *every* active block of the whole graph — the behaviour of
Ligra/Gemini/GraphIt-style systems.  Two accounting modes mirror the
paper's threading schemes:

  t=10 (intra-query): queries run ONE AT A TIME, each round streams the
       blocks its frontier touches.  Traffic = sum over queries of their
       own streams.
  t=1  (inter-query): all queries run CONCURRENTLY; each round the union of
       frontiers is relaxed, but each query's accesses are uncoordinated,
       so modeled traffic counts blocks PER QUERY (no reuse across queries)
       — the cache-thrashing analogue of Table 1 / Figure 2.

Values are those of synchronous Bellman-Ford / Jacobi push; the results
keep the reference's fields and traffic model one for one.

Where the reference's round is a loop of one contraction per block, a round
here is ONE call of the gathered contraction (``kernels/minplus/ops``,
``xrow = blk_src``) over every block of the graph, then one combine into
the destination partitions: ``index_reduce_(..., "amin")`` for min-plus
(order-free, so exact) and ``index_add_`` for push (its float sums
reorder on the card, so baselines ppr is held at a tolerance).  Per round
the host reads only the ``[P, Q]`` partition-activity plane the traffic
model needs.  ``global_random_walks`` steps every live walker once per
round for ``length`` rounds, on the same tape as the engine's walks
(``core/randomwalk.py``), so its trajectories are the engine's bit for
bit; it reads nothing back until the end.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import DeviceGraph
from repro_torch.core.graph import BlockGraph
from repro_torch.core.randomwalk import (WalkGraph, WalkResult,
                                         init_walk_state, make_walk_stepper,
                                         walk_result)
from repro_torch.core.yielding import NO_YIELD
from repro_torch.kernels.minplus import ops as minplus_ops

INF = float("inf")


@dataclasses.dataclass
class BaselineResult:
    values: np.ndarray
    edges_processed: np.ndarray   # [Q]
    rounds: int
    modeled_bytes: float          # uncoordinated traffic model
    modeled_bytes_shared: float   # perfectly-shared traffic (lower bound)


def _block_state(dg: DeviceGraph, sources: np.ndarray) -> torch.Tensor:
    """[P, Q, B] +inf with 0 at each lane's source."""
    P, B = dg.num_parts, dg.block_size
    sources = np.asarray(sources)
    dist = torch.full((P, len(sources), B), INF, dtype=torch.float32,
                      device=dg.device)
    parts, locs = np.divmod(sources.astype(np.int64), B)
    lanes = np.arange(len(sources))
    dist[tuple(torch.from_numpy(a).to(dg.device)
               for a in (parts, lanes, locs))] = 0.0
    return dist


class _Traffic:
    """The reference's traffic model, fed one ``[P, Q]`` activity plane a
    round."""

    def __init__(self, bg: BlockGraph):
        self.bpd = float(bg.block_size * bg.block_size * 4)  # bytes a block
        self.out_blocks = 1 + (bg.nbr_blk >= 0).sum(axis=1)  # incl. diagonal
        self.unshared = self.shared = 0.0

    def add(self, part_active: np.ndarray) -> None:
        per_query_blocks = (part_active * self.out_blocks[:, None]).sum(
            axis=0)
        self.unshared += float(per_query_blocks.sum()) * self.bpd
        self.shared += float(
            (part_active.any(axis=1) * self.out_blocks).sum()) * self.bpd


def _graph(bg: BlockGraph, num_queries: int, device):
    """(device graph, every block's index, its source and destination
    partitions), int64 on the device."""
    dg = DeviceGraph.build(bg, NO_YIELD, num_queries, device)

    def put(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dg.device)

    return (dg, put(np.arange(bg.blocks.shape[0])), put(bg.blk_src),
            put(bg.blk_dst))


def make_minplus_round(dg: DeviceGraph, idx: torch.Tensor,
                       blk_src: torch.Tensor, blk_dst: torch.Tensor):
    """The synchronous Bellman-Ford round: (dist, frontier) -> (dist',
    improved, eq), eq the frontier rows' edges per query (int32, as the
    reference's; the run keeps an int64 total): one
    gathered min-plus launch over every block, then a min into each
    block's destination partition."""
    def round_fn(dist, frontier):
        srcs = torch.where(frontier, dist, INF)            # [P, Q, B]
        out = minplus_ops.minplus(srcs, dg.blocks, idx, dg.lists,
                                  xrow=blk_src)            # [nblk, Q, B]
        cand = torch.full_like(dist, INF).index_reduce_(0, blk_dst, out,
                                                        "amin")
        improved = cand < dist
        dist = torch.minimum(dist, cand)
        eq = torch.where(frontier, dg.deg[:, None, :], 0).sum(
            dim=(0, 2), dtype=torch.int32)
        return dist, improved, eq

    return round_fn


def global_minplus(bg: BlockGraph, sources: np.ndarray,
                   max_rounds: Optional[int] = None,
                   init_plane: Optional[np.ndarray] = None,
                   device=None) -> BaselineResult:
    """Synchronous global Bellman-Ford over all blocks (Ligra-like).

    ``init_plane`` ([P, B], +inf empty) replaces the one-hot source state
    for the every-vertex-is-a-source kinds: cc seeds each vertex with its
    own label and the synchronous rounds become min-label propagation
    (sources then only set the lane count).
    """
    Q = len(sources)
    dg, idx, blk_src, blk_dst = _graph(bg, Q, device)
    P, B = dg.num_parts, dg.block_size
    max_rounds = max_rounds or (bg.n + 1)
    round_fn = make_minplus_round(dg, idx, blk_src, blk_dst)
    if init_plane is not None:
        dist = torch.from_numpy(np.asarray(init_plane, dtype=np.float32)).to(
            dg.device)[:, None, :].expand(P, Q, B).contiguous()
    else:
        dist = _block_state(dg, sources)
    frontier = torch.isfinite(dist)
    edges = torch.zeros(Q, dtype=torch.int64, device=dg.device)
    traffic = _Traffic(bg)
    rounds = 0
    while rounds < max_rounds:
        # fppcheck: allow-host-read: the round's [P, Q] activity plane,
        # the traffic model's input and the exit test in one read
        part_active = frontier.any(dim=2).cpu().numpy()    # [P, Q]
        if not part_active.any():
            break
        traffic.add(part_active)
        dist, frontier, eq = round_fn(dist, frontier)
        edges += eq
        rounds += 1
    vals = dist.cpu().numpy().transpose(1, 0, 2).reshape(Q, -1)[:, :bg.n]
    return BaselineResult(vals, edges.cpu().numpy().astype(np.float64),
                          rounds, traffic.unshared, traffic.shared)


def make_push_round(dg: DeviceGraph, idx: torch.Tensor,
                    blk_src: torch.Tensor, blk_dst: torch.Tensor, *,
                    alpha: float):
    """The synchronous Jacobi push round: (p, r, active) -> (p', r', eq),
    eq int32 as the minplus round's: one gathered masked-matmul launch over every block, then a sum into
    each block's destination partition.  :func:`push_active` gives
    ``active``."""
    degc = torch.clamp(dg.deg, min=1).to(torch.float32)     # [P, B]

    def round_fn(p, r, active):
        af = active.to(r.dtype)
        p = p + alpha * r * af
        push = (1.0 - alpha) * r * af / degc[:, None, :]
        out = minplus_ops.masked_matmul(push, dg.blocks, idx, dg.lists,
                                        xrow=blk_src)       # [nblk, Q, B]
        spread = torch.zeros_like(r).index_add_(0, blk_dst, out)
        r = r * (1.0 - af) + spread
        eq = torch.where(active, dg.deg[:, None, :], 0).sum(
            dim=(0, 2), dtype=torch.int32)
        return p, r, eq

    return round_fn


def push_active(dg: DeviceGraph, r: torch.Tensor, eps: float) -> torch.Tensor:
    """[P, Q, B]: the cells whose residual reaches eps * deg (deg > 0)."""
    degc = torch.clamp(dg.deg, min=1).to(torch.float32)
    return (r >= eps * degc[:, None, :]) & (dg.deg > 0)[:, None, :]


def global_push(bg: BlockGraph, sources: np.ndarray, alpha: float = 0.15,
                eps: float = 1e-4, max_rounds: int = 10_000,
                device=None) -> BaselineResult:
    """Synchronous global Jacobi push PPR (GraphIt-like PageRankDelta).
    The active set is tested before each round, so the round that would
    find nothing to push is never launched."""
    Q = len(sources)
    dg, idx, blk_src, blk_dst = _graph(bg, Q, device)
    round_fn = make_push_round(dg, idx, blk_src, blk_dst, alpha=alpha)
    r = torch.where(torch.isfinite(_block_state(dg, sources)), 1.0, 0.0)
    p = torch.zeros_like(r)
    edges = torch.zeros(Q, dtype=torch.int64, device=dg.device)
    traffic = _Traffic(bg)
    rounds = 0
    while rounds < max_rounds:
        active = push_active(dg, r, eps)
        # fppcheck: allow-host-read: the round's [P, Q] activity plane,
        # the traffic model's input and the exit test in one read
        part_active = active.any(dim=2).cpu().numpy()      # [P, Q]
        if not part_active.any():
            break
        traffic.add(part_active)
        p, r, eq = round_fn(p, r, active)
        edges += eq
        rounds += 1
    vals = p.cpu().numpy().transpose(1, 0, 2).reshape(Q, -1)[:, :bg.n]
    return BaselineResult(vals, edges.cpu().numpy().astype(np.float64),
                          rounds, traffic.unshared, traffic.shared)


def make_walk_round(wg: WalkGraph, length: int, seed: int):
    """The synchronous random-walk round: one tape entry for every live
    walker at once (Ligra-style bulk stepping, no partition residency).
    Same per-(source, step) tape as the engine's walks, so trajectories
    are bitwise identical."""
    step = make_walk_stepper(wg, length, seed)

    def round_fn(pos, steps, part, src, thash, occ):
        return step(pos, steps, part, src, thash, occ, steps < length)

    return round_fn


def global_random_walks(bg: BlockGraph, sources: np.ndarray, length: int,
                        seed: int = 0, device=None) -> WalkResult:
    """Synchronous bulk random walks: every live walker steps once per round
    for ``length`` rounds — the inter-query baseline for the rw kind."""
    wg = WalkGraph.build(bg, device)
    round_fn = make_walk_round(wg, length, seed)
    pos, steps, part, src, thash, occ = init_walk_state(wg, sources)
    for _ in range(length):
        pos, steps, part, thash = round_fn(pos, steps, part, src, thash, occ)
    return walk_result(pos, steps, thash, occ, bg.n, visits=length,
                       rounds=length, syncs=0)
