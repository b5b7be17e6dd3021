"""The buffered execution engine — Algorithm 2 of the paper, on one device.

The port of the JAX package's ``repro.core.engine`` for modes ``minplus``
(sssp/bfs), ``push`` (ppr), ``cc`` and ``kreach``.  cc and kreach are
minplus instantiations over transformed weights (zero weights and a label
plane of every vertex's own id; hop-shifted weights), so only the state
init and the host-side finalize differ.  ``FPPEngine.run`` dispatches K-visit
megasteps (``core/visit.make_megastep``) whose scheduler decision is made on
the device, so the host harvests stats once per K visits
(``host_loop=True`` keeps the per-visit loop with the host scheduler as the
oracle).  On a CUDA device the visit's contractions run the hand-written
kernels of ``kernels/minplus``; on the CPU their plain versions.
``fused=True`` runs each K-visit chunk as one launch of the fused visit
kernel (``kernels/fused_visit``), with no read back to the host inside it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import visit as _visit
from repro_torch.core.graph import BlockGraph
from repro_torch.core.oracles import decode_kreach
from repro_torch.core.scheduler import PartitionScheduler
from repro_torch.core.visit import (VisitAlgebra, VisitState, minplus_algebra,
                                    push_algebra)
from repro_torch.core.yielding import YieldConfig

MODES = ("minplus", "push", "cc", "kreach")

#: guards the one lazy field of a :class:`DeviceGraph` (``dense_blocks``)
_DENSE_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or left as the default) and
    there is no card — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


class VisitStats(NamedTuple):
    visits: int
    rounds: int
    blocks_loaded: int
    modeled_bytes: float  # modeled block + state-tile traffic per visit
    host_syncs: int = 0   # host round trips of the reference's meaning
    #                       (megastep: one per K-visit chunk; host loop: one
    #                       per visit)
    device_syncs: int = 0  # loop exit tests read back to the host (eager
    #                        PyTorch's cost of the reference's while_loops)


# ---------------------------------------------------------------------------
# device-side graph bundle


def column_lists(blocks: np.ndarray):
    """Each block's finite entries as column lists, the fused visit's
    adjacency: ``(col_ptr [nblk, B+1] i32, col_u [nnz] i32, col_w [nnz]
    f32)``.  The entries of column v of block k are
    ``col_ptr[k, v] .. col_ptr[k, v+1]`` (``col_ptr[k, B]`` is where block
    k + 1 starts), in ascending u, with ``col_w == blocks[k, u, v]``
    bit for bit; +inf entries are left out."""
    nblk, B, _ = blocks.shape
    # flat indices of the finite entries in (k, v, u) order
    kv, u = np.divmod(
        np.flatnonzero(np.isfinite(blocks).transpose(0, 2, 1).ravel()), B)
    k, v = np.divmod(kv, B)
    starts = np.zeros(nblk * B + 1, dtype=np.int64)
    np.cumsum(np.bincount(kv, minlength=nblk * B), out=starts[1:])
    if starts[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"{starts[-1]} finite block entries overflow the "
                         f"column lists' int32 offsets")
    col_ptr = starts[np.arange(nblk)[:, None] * B + np.arange(B + 1)]
    return (col_ptr.astype(np.int32), u.astype(np.int32),
            blocks[k, u, v].astype(np.float32))


def blocks_from_lists(col_ptr: torch.Tensor, col_u: torch.Tensor,
                      col_w: torch.Tensor) -> torch.Tensor:
    """The dense blocks ``[nblk, B, B]`` f32 (+inf absent) that
    :func:`column_lists` made these lists of, bit for bit, on the lists'
    device."""
    nblk, B = col_ptr.shape[0], col_ptr.shape[1] - 1
    ptr = col_ptr.long()
    kv = torch.repeat_interleave(
        torch.arange(nblk * B, device=ptr.device),
        (ptr[:, 1:] - ptr[:, :-1]).reshape(-1))
    out = torch.full((nblk, B, B), float("inf"), dtype=torch.float32,
                     device=ptr.device)
    out[kv // B, col_u.long(), kv % B] = col_w
    return out


@dataclasses.dataclass
class DeviceGraph:
    """BlockGraph arrays staged onto one device once, plus per-partition
    neighbour tables the visit indexes without masking.  The blocks travel
    as column lists, which the kernels walk; the dense blocks are staged
    only on the CPU, where the plain versions contract them."""
    blocks: Optional[torch.Tensor]  # [nblk, B, B] f32, +inf absent (CPU;
    #                                 None on the card: see dense_blocks)
    col_ptr: torch.Tensor     # [nblk, B+1] i32 } the finite entries of each
    col_u: torch.Tensor       # [nnz] i32       } block by column
    col_w: torch.Tensor       # [nnz] f32       } (column_lists)
    row_nnz: torch.Tensor     # [nblk, B] i32
    nbr_blk: torch.Tensor     # [P, Dmax] i64 (-1 pad: identity contribution)
    nbr_dst: torch.Tensor     # [P, Dmax] i64 destination (P pad: trash row)
    nbr_src: torch.Tensor     # [P, Dmax] i64 destination (0 pad: a safe
    #                           gather index whose result lands in the trash)
    nbr_nnz: torch.Tensor     # [P, B] i32 row edges into all neighbour blocks
    diag_blk: torch.Tensor    # [P] i64
    deg: torch.Tensor         # [P, B] i32
    edge_budget: torch.Tensor  # [P] f32 per-query edge budget per visit
    num_parts: int
    block_size: int
    device: torch.device

    @property
    def lists(self):
        """``(col_ptr, col_u, col_w)``: what the contraction kernels walk."""
        return self.col_ptr, self.col_u, self.col_w

    def dense_blocks(self) -> torch.Tensor:
        """The dense blocks, for a plain version: the staged ones on the
        CPU; on the card rebuilt from the lists at the first call (only a
        comparison with a plain version asks) and kept.  The rebuild holds
        a lock: one device graph may serve several executors' threads."""
        if self.blocks is None:
            with _DENSE_LOCK:
                if self.blocks is None:
                    self.blocks = blocks_from_lists(*self.lists)
        return self.blocks

    @staticmethod
    def build(bg: BlockGraph, yc: YieldConfig, num_queries: int,
              device=None) -> "DeviceGraph":
        dev = resolve_device(device)
        P = bg.num_parts
        part_edges = np.zeros(P, dtype=np.int64)
        np.add.at(part_edges, bg.blk_src, bg.row_nnz.sum(axis=1))
        valid = bg.nbr_part >= 0
        nbr_nnz = np.where(valid[:, :, None],
                           bg.row_nnz[np.where(valid, bg.nbr_blk, 0)], 0)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
                dev)

        blocks = np.ascontiguousarray(bg.blocks, dtype=np.float32)
        col_ptr, col_u, col_w = column_lists(blocks)
        return DeviceGraph(
            blocks=put(blocks, np.float32) if dev.type == "cpu" else None,
            col_ptr=put(col_ptr, np.int32),
            col_u=put(col_u, np.int32),
            col_w=put(col_w, np.float32),
            row_nnz=put(bg.row_nnz, np.int32),
            nbr_blk=put(bg.nbr_blk, np.int64),
            nbr_dst=put(np.where(valid, bg.nbr_part, P), np.int64),
            nbr_src=put(np.where(valid, bg.nbr_part, 0), np.int64),
            nbr_nnz=put(nbr_nnz.sum(axis=1), np.int32),
            diag_blk=put(bg.diag_blk, np.int64),
            deg=put(bg.deg, np.int32),
            edge_budget=put(yc.edge_budget(part_edges, num_queries),
                            np.float32),
            num_parts=P,
            block_size=bg.block_size,
            device=dev,
        )


# ---------------------------------------------------------------------------
# host-driven engine (Alg. 2 outer loop)


@dataclasses.dataclass
class EngineResult:
    values: np.ndarray        # [Q, n] distances (minplus) or PPR mass (push)
    residual: Optional[np.ndarray]
    edges_processed: np.ndarray  # [Q] float64, exact (host-accumulated)
    stats: VisitStats
    visit_order: list


class FPPEngine:
    """Single-device ForkGraph engine.

    mode: "minplus" (SSSP/BFS), "push" (PPR), "cc" (over the zero-weight
    variant) or "kreach" (over the hop-shifted variant, ``hop_stride`` its
    shift S and ``hop_budget`` the hop limit k); ``device`` defaults to
    CUDA (see :func:`resolve_device`).  ``seed`` seeds the ``random``
    schedule: the megastep's threefry key ``PRNGKey(seed)``, carried
    across chunks, and the host loop's numpy stream (the two differ, as in
    the reference; scheduling never changes results).
    """

    def __init__(self, bg: BlockGraph, mode: str = "minplus",
                 yield_config: YieldConfig = YieldConfig(),
                 schedule: str = "priority", num_queries: int = 1,
                 alpha: float = 0.15, eps: float = 1e-4, seed: int = 0,
                 k_visits: int = 64, fused: bool = False,
                 frontier_mode: str = "dense", hop_budget: int = 8,
                 hop_stride: float = 1.0, device=None):
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r}; one of {MODES}")
        if k_visits < 1:
            raise ValueError(f"k_visits must be >= 1, got {k_visits}")
        if mode == "cc" and bg.n >= (1 << 24):
            raise ValueError(
                f"cc labels ride the f32 minplus planes, exact only below "
                f"2^24 vertices; got n={bg.n}")
        self.bg = bg
        self.mode = mode
        self.num_queries = num_queries
        self.hop_budget, self.hop_stride = int(hop_budget), float(hop_stride)
        self.seed = int(seed)
        self.k_visits = int(k_visits)
        self.fused = bool(fused)
        self.frontier_mode = frontier_mode
        self.dg = DeviceGraph.build(bg, yield_config, num_queries, device)
        self.device = self.dg.device
        self.scheduler = PartitionScheduler(schedule, bg.num_parts, seed)
        max_rounds = yield_config.max_rounds or (
            bg.block_size if mode != "push" else 64)
        self.max_rounds = max_rounds
        if mode == "push":
            self.algebra: VisitAlgebra = push_algebra(alpha, eps)
        else:
            # cc propagates over zero weights, where an equal re-sent label
            # would pend (and re-emit) forever under the default <= rule
            self.algebra = minplus_algebra(yield_config.window(),
                                           strict=(mode == "cc"))
        # the host loop keeps the unfused visit: it is the oracle of both
        # megastep arms
        self._visit = _visit.make_visit(self.dg, self.algebra, max_rounds)
        self._megastep = _visit.make_megastep(
            self.dg, self.algebra, max_rounds, policy=schedule,
            K=self.k_visits, fused=self.fused,
            frontier_mode=self.frontier_mode)
        # modeled traffic per visit: diagonal block + touched out-blocks +
        # two state tiles
        B = bg.block_size
        out_blocks = (bg.nbr_blk >= 0).sum(axis=1)
        self._visit_bytes = ((1 + out_blocks) * B * B * 4
                             + 2 * num_queries * B * 4).astype(np.float64)
        self._visit_blocks = (1 + out_blocks).astype(np.int64)

    def init_state(self, sources: np.ndarray) -> VisitState:
        if self.mode == "cc":
            # cc is one computation per graph: every vertex is a source and
            # every lane converges to the same label plane, so the one-hot
            # injection becomes a full init plane (sources set the lanes)
            return _visit.init_engine_state(
                self.algebra, self.dg, np.empty(0, dtype=np.int64),
                num_queries=self.num_queries,
                init_ops=_visit.cc_label_plane(self.bg))
        return _visit.init_engine_state(self.algebra, self.dg, sources)

    def run(self, sources: np.ndarray, max_visits: int | None = None,
            record_order: bool = False,
            host_loop: bool = False) -> EngineResult:
        """Run the engine to completion (or ``max_visits``).

        The default path dispatches K-visit megasteps and harvests once per
        chunk (``stats.host_syncs`` counts the chunks);
        ``stats.device_syncs`` counts the loop exit tests read back inside
        them.  ``host_loop=True`` keeps the one-sync-per-visit loop with the
        numpy :class:`PartitionScheduler`, the oracle of the megastep.
        """
        if len(sources) != self.num_queries:
            raise ValueError(
                f"got {len(sources)} sources for an engine planned for "
                f"num_queries={self.num_queries}; rebuild the engine (or the "
                f"session plan) with num_queries={len(sources)}")
        state = self.init_state(np.asarray(sources))
        max_visits = max_visits or 2000 * self.bg.num_parts
        if host_loop:
            return self._run_host_loop(state, max_visits, record_order)
        visits = rounds = syncs = dsyncs = 0
        order: list = []
        counts = np.zeros(self.dg.num_parts, dtype=np.int64)
        # edge counts leave the device as an exact (hi, lo) int32 pair per
        # chunk and accumulate here in float64
        edges = np.zeros(self.num_queries, dtype=np.float64)
        key = prng.PRNGKey(self.seed, self.device)
        while visits < max_visits:
            limit = min(self.k_visits, max_visits - visits)
            state, ms = self._megastep(state, visits, limit, key)
            syncs += 1
            dsyncs += ms.device_syncs
            v = ms.visits
            if v == 0:
                break
            key = ms.key
            hi, lo, cnt, ring = _visit.harvest_chunk(ms)
            edges += _visit.harvest_edges(hi, lo)
            counts += cnt.astype(np.int64)
            visits += v
            rounds += ms.rounds
            if record_order:
                order.extend(map(int, ring[:v]))
            if v < limit:
                # the loop exits below the limit only when no partition
                # holds a pending op: the run is complete
                break
        stats = VisitStats(
            visits=visits, rounds=rounds,
            blocks_loaded=int(counts @ self._visit_blocks),
            modeled_bytes=float(counts @ self._visit_bytes),
            host_syncs=syncs, device_syncs=dsyncs)
        return self._finalize(state, edges, stats, order)

    def _run_host_loop(self, state: VisitState, max_visits: int,
                       record_order: bool) -> EngineResult:
        """Per-visit loop: prio/stamp/ops read to the host, numpy selection,
        one visit per dispatch — O(visits) host synchronizations."""
        P = self.dg.num_parts
        visits = rounds = blocks = dsyncs = 0
        traffic = 0.0
        order: list = []
        edges = np.zeros(self.num_queries, dtype=np.float64)
        while visits < max_visits:
            # fppcheck: allow-host-read: the host loop is the megastep's
            # oracle, one host scheduling decision (and read) a visit
            p = self.scheduler.select(state.prio[:P].cpu().numpy(),
                                      state.stamp[:P].cpu().numpy(),
                                      state.ops_count[:P].cpu().numpy())
            if p is None:
                break
            pt = torch.tensor([p], dtype=torch.int64, device=self.device)
            state, (r, eq, s) = self._visit(state, pt, visits)
            # fppcheck: allow-host-read: the oracle's edges, a visit's
            edges += eq.cpu().numpy().astype(np.float64)
            visits += 1
            rounds += r
            dsyncs += s
            blocks += int(self._visit_blocks[p])
            traffic += float(self._visit_bytes[p])
            if record_order:
                order.append(p)
        stats = VisitStats(visits=visits, rounds=rounds, blocks_loaded=blocks,
                           modeled_bytes=traffic, host_syncs=visits,
                           device_syncs=dsyncs)
        return self._finalize(state, edges, stats, order)

    def _finalize(self, state: VisitState, edges: np.ndarray,
                  stats: VisitStats, order: list) -> EngineResult:
        n, Q = self.bg.n, self.num_queries

        def vertex_major(plane):               # [P, Q, B] -> [Q, n]
            return plane.cpu().numpy().transpose(1, 0, 2).reshape(Q, -1)[:, :n]

        if self.mode == "kreach":
            # the packed lex-(hops, dist) plane unpacks on the host; the hop
            # plane rides the residual slot of the result
            vals, hops = decode_kreach(vertex_major(state.planes[0]),
                                       self.hop_stride, self.hop_budget)
            return EngineResult(vals, hops, edges, stats, order)
        if self.mode != "push":
            return EngineResult(vertex_major(state.planes[0]), None, edges,
                                stats, order)
        # pending buffered contributions ARE residual mass that was never
        # consolidated (below-eps ops at termination): fold them in so
        # p + r conserves probability exactly
        rfull = state.planes[1] + state.buf[:self.bg.num_parts]
        return EngineResult(vertex_major(state.planes[0]),
                            vertex_major(rfull), edges, stats, order)
