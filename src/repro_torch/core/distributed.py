"""The distributed FPP runtime: buffered execution one level up.

The port of the JAX package's ``repro.core.distributed`` to
``torch.distributed``.  The buffered execution model is applied across
ranks:

* graph partitions are sharded over the ``model`` mesh axis: each rank
  holds its ``pl = P / model`` partitions and the blocks whose *source*
  partition it owns (its :class:`Slab`);
* queries are sharded over the ``data`` axis: query shards never talk;
* one superstep = every rank visits its best-priority partition and the
  boundary ops are exchanged in one ``all_to_all`` over ``model``
  (``core/visit.superstep``): Algorithm 2's line 16 *is* the collective.

Both algebras run through the same loop: minplus (sssp, bfs, cc, kreach)
and push (ppr).  The run stops when no rank holds a pending op (a max
all-reduce over the mesh) or after ``max_supersteps``.  Every rank returns
the same whole result, as the reference returns a replicated array: edges
are summed over ``model``, and the planes are all-gathered over ``model``,
then over the query axes.

Where the port differs from the reference: the superstep loop is a host
loop (the reference's is one ``lax.while_loop`` under ``shard_map``), so
its exit test and each relax round's exit test read the device
(``device_syncs``, this rank's count).  On the card a rank's slab is
staged as column lists only, which B1 and B2 walk; its dense blocks are
staged on the CPU, where the plain versions contract them.

Not ported: ``make_distributed_program`` and ``lower_distributed_sssp``,
the AOT lowering handles of the reference's dry run and static checks
(ROADMAP, out of scope).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import visit as _visit
from repro_torch.core.engine import column_lists, resolve_device
from repro_torch.core.graph import BlockGraph
from repro_torch.core.randomwalk import (WalkGraph, WalkResult,
                                         init_walk_state, make_walk_stepper,
                                         walk_result)
from repro_torch.core.visit import EDGE_SHIFT, VisitAlgebra
from repro_torch.core.yielding import YieldConfig


@dataclasses.dataclass
class ShardedGraph:
    """BlockGraph re-laid-out for P-way partition sharding.

    Every per-rank slab owns ``pl = P/ndev`` consecutive partitions and the
    dense blocks whose *source* partition it owns (it needs them to relax
    and emit); destinations may be remote.
    """
    blocks: np.ndarray     # [ndev, pl, 1+dmax, B, B]; slot 0 = diagonal
    dst_part: np.ndarray   # [ndev, pl, 1+dmax] global dst partition (-1 pad)
    row_nnz: np.ndarray    # [ndev, pl, 1+dmax, B]
    deg: np.ndarray        # [ndev, pl, B]
    edge_budget: np.ndarray  # [ndev, pl]
    ndev: int
    pl: int
    dmax: int
    block_size: int
    num_parts: int

    @staticmethod
    def build(bg: BlockGraph, ndev: int, yc: YieldConfig,
              num_queries: int) -> "ShardedGraph":
        B = bg.block_size
        P_ = bg.num_parts
        pl = -(-P_ // ndev)
        p_pad = pl * ndev
        dmax = bg.nbr_blk.shape[1]
        blocks = np.full((ndev, pl, 1 + dmax, B, B), np.inf, dtype=np.float32)
        dst_part = np.full((ndev, pl, 1 + dmax), -1, dtype=np.int32)
        row_nnz = np.zeros((ndev, pl, 1 + dmax, B), dtype=np.int32)
        deg = np.zeros((ndev, pl, B), dtype=np.int32)
        part_edges = np.zeros(p_pad, dtype=np.int64)
        np.add.at(part_edges, bg.blk_src, bg.row_nnz.sum(axis=1))
        for p in range(P_):
            d, l = divmod(p, pl)
            kd = bg.diag_blk[p]
            blocks[d, l, 0] = bg.blocks[kd]
            dst_part[d, l, 0] = p
            row_nnz[d, l, 0] = bg.row_nnz[kd]
            deg[d, l] = bg.deg[p]
            for s in range(dmax):
                k = bg.nbr_blk[p, s]
                if k >= 0:
                    blocks[d, l, 1 + s] = bg.blocks[k]
                    dst_part[d, l, 1 + s] = bg.nbr_part[p, s]
                    row_nnz[d, l, 1 + s] = bg.row_nnz[k]
        budget = yc.edge_budget(part_edges, num_queries).reshape(ndev, pl)
        return ShardedGraph(blocks, dst_part, row_nnz, deg, budget,
                            ndev, pl, dmax, B, P_)

    def stage(self, m: int, device=None) -> "Slab":
        """Rank ``m``'s slab (its coordinate on the partition axis) on
        ``device``: its ``[pl*(1+dmax), B, B]`` blocks as column lists
        (padding slots are all-+inf blocks with empty lists, whose
        contributions are the identity), and the dense blocks only on the
        CPU."""
        dev = resolve_device(device)
        B, pl, dmax = self.block_size, self.pl, self.dmax
        blocks = np.ascontiguousarray(
            self.blocks[m].reshape(pl * (1 + dmax), B, B))

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
                dev)

        col_ptr, col_u, col_w = column_lists(blocks)
        return Slab(
            blocks=put(blocks, np.float32) if dev.type == "cpu" else None,
            col_ptr=put(col_ptr, np.int32), col_u=put(col_u, np.int32),
            col_w=put(col_w, np.float32),
            dst_part=put(self.dst_part[m], np.int64),
            row_nnz=put(self.row_nnz[m], np.int32),
            deg=put(self.deg[m], np.int32),
            edge_budget=put(self.edge_budget[m], np.float32),
            ndev=self.ndev, pl=pl, dmax=dmax, device=dev)


@dataclasses.dataclass
class Slab:
    """One rank's shard on its device: what ``visit.superstep`` walks.
    Block ``l*(1+dmax) + s`` is slot ``s`` of local partition ``l`` (slot
    0 the diagonal); ``blocks``/``lists`` are what the algebra's
    contractions take, as a ``DeviceGraph``'s are."""
    blocks: Optional[torch.Tensor]  # [pl*(1+dmax), B, B] f32 (CPU; None
    #                                 on the card)
    col_ptr: torch.Tensor     # [pl*(1+dmax), B+1] i32
    col_u: torch.Tensor       # [nnz] i32
    col_w: torch.Tensor       # [nnz] f32
    dst_part: torch.Tensor    # [pl, 1+dmax] i64 global dst partition (-1 pad)
    row_nnz: torch.Tensor     # [pl, 1+dmax, B] i32
    deg: torch.Tensor         # [pl, B] i32
    edge_budget: torch.Tensor  # [pl] f32
    ndev: int
    pl: int
    dmax: int
    device: torch.device

    @property
    def lists(self):
        return self.col_ptr, self.col_u, self.col_w


@dataclasses.dataclass
class DistributedResult:
    values: np.ndarray          # [Q, n]
    supersteps: int
    edges_processed: np.ndarray  # [Q] float64, exact
    residual: Optional[np.ndarray] = None   # [Q, n] (push kinds)
    device_syncs: int = 0       # this rank's reads back to the host


def _check_query_sharding(Q: int, mesh, query_axes) -> int:
    nq_dev = int(np.prod([mesh.shape[a] for a in query_axes]))
    if Q % nq_dev != 0:
        raise ValueError(
            f"query batch of Q={Q} cannot shard evenly over query axes "
            f"{tuple(query_axes)} (total size {nq_dev}); pad the sources to "
            f"a multiple of {nq_dev} or re-mesh so the query-axes size "
            f"divides Q")
    return nq_dev


def _gather(mesh, x: torch.Tensor, axes: Sequence[str],
            dim: int) -> torch.Tensor:
    """Concatenate every shard of ``x`` along ``dim``, in row-major order
    of ``axes`` (the innermost axis gathered first)."""
    for a in reversed(tuple(axes)):
        x = torch.cat(list(mesh.all_gather(x, a)), dim=dim)
    return x


def _run_program(algebra: VisitAlgebra, bg: BlockGraph, sources: np.ndarray,
                 mesh, yc: YieldConfig, max_rounds: int,
                 max_supersteps: int, query_axes, part_axis: str,
                 num_queries: Optional[int] = None,
                 init_ops: Optional[np.ndarray] = None, device=None):
    """The shared loop: stage this rank's slab and query shard, run
    supersteps until no rank holds a pending op, gather the whole result.
    Returns (planes [nplanes, P_pad, Q, B], buf [P_pad, Q, B], edges [Q]
    float64, supersteps, device_syncs) on the host."""
    dev = resolve_device(device)
    query_axes = tuple(query_axes)
    ndev = int(mesh.shape[part_axis])
    Q = int(num_queries if num_queries is not None else len(sources))
    nq = _check_query_sharding(Q, mesh, query_axes)
    sg = ShardedGraph.build(bg, ndev, yc, Q)
    B, pl = sg.block_size, sg.pl
    p_pad = ndev * pl
    if init_ops is not None:
        io = np.full((p_pad, B), algebra.identity, dtype=np.float32)
        io[:bg.num_parts] = init_ops
        init_ops = io
    planes0, buf0 = _visit.init_dense_state(
        algebra, p_pad, Q, B, np.asarray(sources), init_ops=init_ops)
    m = mesh.coords[part_axis]
    Qs = Q // nq
    lanes = slice(mesh.index(query_axes) * Qs,
                  (mesh.index(query_axes) + 1) * Qs)
    rows = slice(m * pl, (m + 1) * pl)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows, lanes])).to(dev)

    slab = sg.stage(m, dev)
    planes = tuple(put(x) for x in planes0)
    buf = put(buf0[:p_pad])
    ehi = torch.zeros(Qs, dtype=torch.int32, device=dev)
    elo = torch.zeros(Qs, dtype=torch.int32, device=dev)
    steps = syncs = 0
    while steps < max_supersteps:
        eq, _, s = _visit.superstep(slab, planes, buf, algebra=algebra,
                                    max_rounds=max_rounds, mesh=mesh,
                                    part_axis=part_axis)
        elo += eq
        spill = elo >> EDGE_SHIFT
        ehi += spill
        elo -= spill << EDGE_SHIFT
        steps += 1
        local = algebra.pending(buf, planes, slab.deg).any().to(
            torch.int32).view(1)
        syncs += s + 1
        if not int(mesh.all_reduce_max(local).item()):
            break
    # each rank counted the edges of the partitions it owns: a query's
    # total is the sum over the partition axis
    ehi = mesh.all_reduce_sum(ehi, part_axis)
    elo = mesh.all_reduce_sum(elo, part_axis)
    state = torch.stack(planes + (buf,))               # [nplanes+1, pl, Qs, B]
    state = torch.cat(list(mesh.all_gather(state, part_axis)), dim=1)
    state = _gather(mesh, state, query_axes, dim=2).cpu().numpy()
    counts = _gather(mesh, torch.stack([ehi, elo]), query_axes, dim=1)
    ehi, elo = counts.cpu().numpy()
    edges = (np.asarray(ehi, dtype=np.float64) * float(1 << EDGE_SHIFT)
             + np.asarray(elo, dtype=np.float64))
    return state[:-1], state[-1], edges, steps, syncs


def _to_values(plane: np.ndarray, num_parts: int, Q: int, n: int):
    return plane[:num_parts].transpose(1, 0, 2).reshape(Q, -1)[:, :n]


def run_distributed_sssp(bg: BlockGraph, sources: np.ndarray, mesh,
                         yield_config: Optional[YieldConfig] = None,
                         max_supersteps: int = 100_000,
                         query_axes=("data",), part_axis: str = "model",
                         device=None) -> DistributedResult:
    """Batched SSSP on a (data, model) mesh; every rank of the mesh calls
    it with the same arguments and gets the same result.

    sources: [Q] in the reordered id space; Q must divide by the query
    axes' size.
    """
    yc = yield_config or YieldConfig()
    algebra = _visit.minplus_algebra(yc.window())
    vals, _, edges, steps, syncs = _run_program(
        algebra, bg, sources, mesh, yc,
        max_rounds=yc.max_rounds or bg.block_size,
        max_supersteps=max_supersteps, query_axes=query_axes,
        part_axis=part_axis, device=device)
    Q = len(sources)
    return DistributedResult(_to_values(vals[0], bg.num_parts, Q, bg.n),
                             steps, edges, device_syncs=syncs)


def run_distributed_cc(bg: BlockGraph, num_queries: int, mesh,
                       yield_config: Optional[YieldConfig] = None,
                       max_supersteps: int = 100_000,
                       query_axes=("data",), part_axis: str = "model",
                       device=None) -> DistributedResult:
    """Connected components: the minplus superstep program over a
    zero-weight block graph, seeded with every vertex's own label
    (``visit.cc_label_plane``); every lane converges to the same plane,
    ``num_queries`` only sets the lane count.  Strict pending: over zero
    weights an equal re-sent label would keep the loop pending forever."""
    yc = yield_config or YieldConfig()
    algebra = _visit.minplus_algebra(yc.window(), strict=True)
    vals, _, edges, steps, syncs = _run_program(
        algebra, bg, np.empty(0, dtype=np.int64), mesh, yc,
        max_rounds=yc.max_rounds or bg.block_size,
        max_supersteps=max_supersteps, query_axes=query_axes,
        part_axis=part_axis, num_queries=num_queries,
        init_ops=_visit.cc_label_plane(bg), device=device)
    return DistributedResult(
        _to_values(vals[0], bg.num_parts, num_queries, bg.n), steps, edges,
        device_syncs=syncs)


def run_distributed_ppr(bg: BlockGraph, sources: np.ndarray, mesh,
                        alpha: float = 0.15, eps: float = 1e-4,
                        yield_config: Optional[YieldConfig] = None,
                        max_supersteps: int = 100_000,
                        query_axes=("data",), part_axis: str = "model",
                        device=None) -> DistributedResult:
    """Batched PPR: the push instantiation of the same superstep loop.
    ``values`` is the PPR mass and ``residual`` the terminal residual with
    the buffered contributions folded in, so values + residual conserves
    mass."""
    yc = yield_config or YieldConfig()
    algebra = _visit.push_algebra(alpha, eps)
    vals, buf, edges, steps, syncs = _run_program(
        algebra, bg, sources, mesh, yc,
        max_rounds=yc.max_rounds or 64,
        max_supersteps=max_supersteps, query_axes=query_axes,
        part_axis=part_axis, device=device)
    Q = len(sources)
    pvals = _to_values(vals[0], bg.num_parts, Q, bg.n)
    rvals = _to_values(vals[1] + buf, bg.num_parts, Q, bg.n)
    return DistributedResult(pvals, steps, edges, residual=rvals,
                             device_syncs=syncs)


def run_distributed_walks(bg: BlockGraph, sources: np.ndarray, mesh,
                          length: int, seed: int = 0, walk_axes=None,
                          device=None) -> WalkResult:
    """Batched random walks sharded over every mesh axis (the graph on
    every rank).  Walkers are padded to the axes' size with clones of
    walker 0 (same tape id, same walk; sliced off on return).  Each rank
    steps its walkers ``length`` times with the port's stepper (one
    ``fg_threefry`` launch a step on the card); the only collective is the
    final gather.  The walks are those of every other rw runtime (the tape
    contract of ``core/randomwalk.py``)."""
    walk_axes = tuple(walk_axes or mesh.axis_names)
    nshard = int(np.prod([mesh.shape[a] for a in walk_axes]))
    srcs = np.asarray(sources)
    Q = srcs.size
    Qp = -(-max(Q, 1) // nshard) * nshard
    padded = np.concatenate([srcs, np.full(Qp - Q, srcs[0] if Q else 0,
                                           dtype=srcs.dtype)])
    Ws = Qp // nshard
    i = mesh.index(walk_axes)
    wg = WalkGraph.build(bg, device)
    step = make_walk_stepper(wg, length, seed)
    pos, steps, part, src, thash, occ = init_walk_state(
        wg, padded[i * Ws:(i + 1) * Ws])
    for _ in range(length):
        pos, steps, part, thash = step(pos, steps, part, src, thash, occ,
                                       steps < length)
    pos, steps, thash, occ = (_gather(mesh, x, walk_axes, dim=0)[:Q]
                              for x in (pos, steps, thash, occ))
    return walk_result(pos, steps, thash, occ, bg.n, visits=length,
                       rounds=length, syncs=0)
