"""The buffered execution engine — Algorithm 2 of the paper, on one device.

The port of the JAX package's ``repro.core.engine`` for modes ``minplus``
(sssp/bfs) and ``push`` (ppr).  ``FPPEngine.run`` dispatches K-visit
megasteps (``core/visit.make_megastep``) whose scheduler decision is made on
the device, so the host harvests stats once per K visits
(``host_loop=True`` keeps the per-visit loop with the host scheduler as the
oracle).  On a CUDA device the visit's contractions run the hand-written
kernels of ``kernels/minplus``; on the CPU their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import visit as _visit
from repro_torch.core.graph import BlockGraph
from repro_torch.core.scheduler import PartitionScheduler
from repro_torch.core.visit import (VisitAlgebra, VisitState, minplus_algebra,
                                    push_algebra)
from repro_torch.core.yielding import YieldConfig

MODES = ("minplus", "push")


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


@dataclasses.dataclass
class DeviceGraph:
    """BlockGraph arrays staged onto one device once, plus per-partition
    neighbour tables the visit indexes without masking."""
    blocks: torch.Tensor      # [nblk, B, B] f32, +inf absent
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

        return DeviceGraph(
            blocks=put(bg.blocks, np.float32),
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

    mode: "minplus" (SSSP/BFS) or "push" (PPR); ``device`` defaults to
    CUDA (see :func:`resolve_device`).
    """

    def __init__(self, bg: BlockGraph, mode: str = "minplus",
                 yield_config: YieldConfig = YieldConfig(),
                 schedule: str = "priority", num_queries: int = 1,
                 alpha: float = 0.15, eps: float = 1e-4,
                 k_visits: int = 64, device=None):
        if mode in ("cc", "kreach"):
            raise NotImplementedError(
                f"engine mode {mode!r} is not ported yet (ROADMAP A6)")
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r}; one of {MODES}")
        if k_visits < 1:
            raise ValueError(f"k_visits must be >= 1, got {k_visits}")
        self.bg = bg
        self.mode = mode
        self.num_queries = num_queries
        self.k_visits = int(k_visits)
        self.dg = DeviceGraph.build(bg, yield_config, num_queries, device)
        self.device = self.dg.device
        self.scheduler = PartitionScheduler(schedule, bg.num_parts)
        max_rounds = yield_config.max_rounds or (
            bg.block_size if mode != "push" else 64)
        self.max_rounds = max_rounds
        if mode == "push":
            self.algebra: VisitAlgebra = push_algebra(alpha, eps)
        else:
            self.algebra = minplus_algebra(yield_config.window())
        self._visit = _visit.make_visit(self.dg, self.algebra, max_rounds)
        self._megastep = _visit.make_megastep(
            self.dg, self.algebra, max_rounds, policy=schedule,
            K=self.k_visits)
        # modeled traffic per visit: diagonal block + touched out-blocks +
        # two state tiles
        B = bg.block_size
        out_blocks = (bg.nbr_blk >= 0).sum(axis=1)
        self._visit_bytes = ((1 + out_blocks) * B * B * 4
                             + 2 * num_queries * B * 4).astype(np.float64)
        self._visit_blocks = (1 + out_blocks).astype(np.int64)

    def init_state(self, sources: np.ndarray) -> VisitState:
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
        while visits < max_visits:
            limit = min(self.k_visits, max_visits - visits)
            state, ms = self._megastep(state, visits, limit)
            syncs += 1
            dsyncs += ms.device_syncs
            v = ms.visits
            if v == 0:
                break
            edges += _visit.harvest_edges(ms.eq_hi.cpu().numpy(),
                                          ms.eq_lo.cpu().numpy())
            counts += ms.visit_counts.cpu().numpy().astype(np.int64)
            visits += v
            rounds += ms.rounds
            if record_order:
                order.extend(ms.order[:v].tolist())
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
            p = self.scheduler.select(state.prio[:P].cpu().numpy(),
                                      state.stamp[:P].cpu().numpy(),
                                      state.ops_count[:P].cpu().numpy())
            if p is None:
                break
            pt = torch.tensor([p], dtype=torch.int64, device=self.device)
            state, (r, eq, s) = self._visit(state, pt, visits)
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

        if self.mode != "push":
            return EngineResult(vertex_major(state.planes[0]), None, edges,
                                stats, order)
        # pending buffered contributions ARE residual mass that was never
        # consolidated (below-eps ops at termination): fold them in so
        # p + r conserves probability exactly
        rfull = state.planes[1] + state.buf[:self.bg.num_parts]
        return EngineResult(vertex_major(state.planes[0]),
                            vertex_major(rfull), edges, stats, order)
