"""Partition-size planning for Hopper: the paper's "partition fits in the
LLC" rule as code.

The port of the JAX package's ``repro.fpp.planner`` with the memory model
derived again for an NVIDIA H100.  A visit's working set (the adjacency
block, double-buffered, plus a value tile and a buffer tile) must fit one
thread block's shared memory; the hub neighbourhood of one visit (the
diagonal block plus its estimated boundary blocks) must fit the L2 cache
that keeps hot blocks warm across visits; the state planes must fit HBM:

    argmax B  s.t.  working_set(B, Q) <= smem_bytes

At Q = 64 that gives B = 128 (2·128²·4 + 2·64·128·4 = 196,608 bytes of
232,448); B = 256 does not fit.  A fused plan must also fit the fused visit
kernel's shared-memory layout (:meth:`MemoryModel.fused_working_set`, the
bytes each CTA of its cluster asks for at launch); at Q = 64 that still
gives B = 128.

``FPPSession.plan(tune=True)`` measures the candidates the model admits on
a query sample instead (:func:`autotune_block_size`, through
:func:`measure_run`) and keeps the one with the least modeled traffic.

The serving layer sizes its lane pools and result cache with the same
model: :func:`pow2_bucket`, :func:`autoscale_capacity` and
:func:`result_cache_budget`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.core.yielding import YieldConfig, default_delta
from repro_torch.kernels.fused_visit.ops import smem_bytes

#: block-size candidates, smallest to largest
CANDIDATE_BLOCK_SIZES = (64, 128, 256, 512, 1024, 2048, 4096)

#: neighbour-slot budget of ``auto_fused``: past it the auto-select keeps
#: the unfused megastep (the reference's guard; here the fused visit
#: streams neighbour blocks one at a time, so dmax costs time, not memory)
FUSED_DMAX_BUDGET = 8

#: measured dispatch yardsticks (visits/s) keyed (kind, dispatch, K), read
#: by :func:`auto_fused`.  Empty until a benchmark measures both dispatches
#: on the card; the reference's rows are not carried over.
DISPATCH_YARDSTICKS: dict = {}

#: bfs runs the same minplus kernels as sssp, so it shares sssp's rows
_YARDSTICK_KIND = {"bfs": "sssp", "cc": "sssp", "kreach": "sssp"}


def auto_fused(kind: str, k_visits: int = 64,
               dmax: Optional[int] = None) -> bool:
    """True iff the committed yardsticks show a fused visit faster than the
    unfused megastep for ``kind`` at the nearest chunk size, and ``dmax``
    (the partitioning's neighbour slots, when known) is within
    :data:`FUSED_DMAX_BUDGET`.  With no rows, False for every kind."""
    if dmax is not None and int(dmax) > FUSED_DMAX_BUDGET:
        return False
    yk = _YARDSTICK_KIND.get(kind, kind)
    ks = sorted({k for (kk, _, k) in DISPATCH_YARDSTICKS if kk == yk})
    if not ks:
        return False
    k = min(ks, key=lambda c: abs(c - int(k_visits)))
    fused = DISPATCH_YARDSTICKS.get((yk, "fused", k))
    plain = DISPATCH_YARDSTICKS.get((yk, "megastep", k))
    return fused is not None and plain is not None and fused > plain


def pow2_bucket(demand: int, min_capacity: int = 1,
                max_capacity: int = 1024) -> int:
    """Snap a lane-count demand to its power-of-two bucket.

    Every capacity the serving layer builds comes through here (initial
    pool size, autoscale hints), so the set of built engine shapes stays
    logarithmic in demand and a resize lands on a warm engine bundle in
    the serving cache (keyed by this bucket) instead of a new build.
    """
    demand = max(int(demand), int(min_capacity), 1)
    cap = 1
    while cap < demand:
        cap *= 2
    return max(int(min_capacity), min(int(max_capacity), cap))


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """One H100 SXM's memory budget the plan must fit.

    Working set of one partition visit, held in one thread block's shared
    memory:
      adjacency block   B*B*dtype   (x2 when double-buffering the next block)
      value tile        Q*B*dtype
      buffer tile       Q*B*dtype
    ``l2_bytes`` bounds one visit's hub neighbourhood; HBM holds the
    block-sparse graph plus the [P, Q, B] state planes, and ``hbm_bytes``
    caps the state so Q and B cannot silently overflow the card.  A fused
    visit holds each CTA's slice of the rows, their masks and three stages
    of neighbour rows in shared memory: :meth:`fused_working_set`.
    """
    smem_bytes: int = 232_448            # per thread block (227 KB)
    l2_bytes: int = 50 * 1000 ** 2       # 50 MB
    hbm_bytes: int = 80 * 1000 ** 3      # 80 GB
    dtype_bytes: int = 4
    double_buffer: bool = True

    def working_set(self, block_size: int, num_queries: int) -> int:
        mult = 2 if self.double_buffer else 1
        return (mult * block_size * block_size * self.dtype_bytes
                + 2 * num_queries * block_size * self.dtype_bytes)

    def fused_working_set(self, block_size: int, num_queries: int,
                          num_planes: int = 2) -> int:
        """Dynamic shared-memory bytes each CTA of a fused launch asks for:
        the kernel's layout for ``num_planes`` value planes (1: minplus,
        2: push) at the cluster size ``num_queries`` picks — the CTA's
        ``[ceil(Q / C), B]`` slice of the visited rows' planes and masks,
        three stages of at most 8 neighbour rows, and the per-row,
        per-column and exchange scratch.  The blocks are column lists in
        global memory and neighbour rows stream through the stages, so
        neither ``dmax`` nor a block's density enters."""
        return smem_bytes(num_planes, num_queries, block_size)

    def state_bytes(self, n_vertices: int, num_queries: int,
                    block_size: int) -> int:
        """HBM-resident state planes (dist + buf + one spare), padded."""
        n_pad = -(-n_vertices // block_size) * block_size
        return 3 * n_pad * num_queries * self.dtype_bytes

    def fits(self, block_size: int, num_queries: int,
             n_vertices: Optional[int] = None, *,
             fused: bool = False) -> bool:
        """``fused=True`` also requires the fused kernel's launch to fit,
        for either algebra (a plan serves every kind)."""
        if self.working_set(block_size, num_queries) > self.smem_bytes:
            return False
        if fused and max(self.fused_working_set(block_size, num_queries, n)
                         for n in (1, 2)) > self.smem_bytes:
            return False
        if n_vertices is not None and self.state_bytes(
                n_vertices, num_queries, block_size) > self.hbm_bytes:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class Plan:
    """A resolved execution plan for one fork-processing pattern."""
    block_size: int
    method: str                 # partition/reorder method (partition.py)
    schedule: str               # inter-partition policy (scheduler.py)
    backend: str                # "engine" (the only one ported)
    num_queries: int
    mem: MemoryModel
    yield_config: Optional[YieldConfig] = None   # None => per-kind default
    #: visit-body dispatch: False = unfused megastep, True = the fused
    #: visit kernel, "auto" = per kind from the yardsticks
    #: (:func:`auto_fused`)
    fused: object = False
    #: True when ``block_size`` was measured (``plan(tune=True)``); the
    #: rows of that sweep, each a sorted tuple of (key, value) pairs
    tuned: bool = False
    tuning_rows: tuple = ()

    def resolve_fused(self, kind: str, k_visits: int = 64,
                      dmax: Optional[int] = None) -> bool:
        """The concrete visit body for one kind under this plan."""
        if self.fused == "auto":
            return auto_fused(kind, k_visits, dmax=dmax)
        return bool(self.fused)

    def working_set_bytes(self) -> int:
        """Shared memory one visit of this plan holds: the fused kernel's
        size per CTA (the larger algebra's) or the unfused working set."""
        if self.fused:
            return max(self.mem.fused_working_set(
                self.block_size, self.num_queries, n) for n in (1, 2))
        return self.mem.working_set(self.block_size, self.num_queries)


def default_method(g: CSRGraph) -> str:
    """Paper §7.1: METIS-like clustering for road/web graphs, random for
    power-law social graphs (where clustering quality collapses)."""
    deg = g.out_degree()
    mean = max(1.0, float(deg.mean()))
    if float(deg.max()) > 64.0 * mean:      # heavy-tailed hub structure
        return "random"
    return "bfs"


def est_dmax(g: CSRGraph, block_size: int) -> int:
    """Pessimistic neighbour-slot estimate for one partition of size B.

    If the ``B`` heaviest vertices land in one partition, their combined
    out-edges reach at best ``ceil(sum(top-B degrees) / B)`` distinct
    partitions — the floor on that partition's boundary-block count,
    clamped to ``P - 1``.  A planning estimate from the degree sequence
    alone, usable before any partitioning has run.
    """
    if g.n == 0:
        return 0
    deg = np.sort(g.out_degree())[::-1]
    top = float(deg[: int(block_size)].sum())
    num_parts = -(-g.n // int(block_size))
    return int(min(max(num_parts - 1, 0),
                   np.ceil(top / max(float(block_size), 1.0))))


def model_block_size(g: CSRGraph, num_queries: int, mem: MemoryModel,
                     candidates: Sequence[int] = CANDIDATE_BLOCK_SIZES,
                     min_parts: int = 8, fused: bool = False) -> int:
    """Largest candidate whose visit working set fits the memory model.

    Also keeps at least ``min_parts`` partitions alive (clamped to what the
    graph can support), so the scheduler has partitions to choose between.

    A skew guard for hub-heavy graphs: one visit's neighbourhood — the
    diagonal block plus :func:`est_dmax` boundary blocks — must stay
    inside the L2 cache.  ``fused=True`` also requires the fused visit
    kernel's shared memory to fit.
    """
    best = None
    for b in candidates:
        if -(-g.n // b) < max(2, min(min_parts, g.n // candidates[0])):
            break
        hood = (1 + est_dmax(g, b)) * b * b * mem.dtype_bytes
        if hood > mem.l2_bytes:
            continue   # hub neighbourhoods outgrow L2 at this B
        if mem.fits(b, num_queries, g.n, fused=fused):
            best = b
    if best is None:
        raise ValueError(
            f"no candidate block size fits the memory model for "
            f"Q={num_queries} (smallest candidate {candidates[0]} needs "
            f"{mem.working_set(candidates[0], num_queries)} B of "
            f"{mem.smem_bytes} B shared memory); shrink the query batch")
    return best


#: default serving result-cache budget, in units of one single-lane HBM
#: plane set (``MemoryModel.state_bytes`` at Q=1).  One cached entry costs
#: about a third of a plane set (values [n] f32; ppr adds a residual
#: plane), so 16 plane sets hold on the order of 25-50 hot answers.
RESULT_CACHE_PLANE_SETS = 16


def result_cache_budget(mem: MemoryModel, n_vertices: int, block_size: int,
                        plane_sets: int = RESULT_CACHE_PLANE_SETS) -> int:
    """Byte budget for the serving result cache: a small multiple
    (:data:`RESULT_CACHE_PLANE_SETS`) of one query lane's padded HBM
    plane set for this graph.  ``GraphServer`` takes the max over its
    registered graphs; an explicit ``GraphServer(cache_bytes=...)``
    replaces this default."""
    return int(plane_sets) * mem.state_bytes(int(n_vertices), 1,
                                             int(block_size))


def autoscale_capacity(queue_depth: int, active: int, *,
                       mem: MemoryModel, n_vertices: int, block_size: int,
                       min_capacity: int = 1,
                       max_capacity: int = 1024) -> int:
    """Suggest a lane-pool ``capacity`` from observed queue pressure.

    Demand is what is in flight plus what waits; the suggestion is the
    next power of two covering it, clamped to ``[min_capacity,
    max_capacity]`` and then halved until :meth:`MemoryModel.fits`
    accepts the visit working set and the HBM state planes at the pool's
    block size.  A pure function of its inputs: ``GraphServer`` calls it
    between chunks and applies a changed suggestion only to an idle pool.

    ``fits`` tests the dense working set (two B×B blocks and two Q×B
    tiles), which no kernel of the port holds: at B = 128 it caps a pool
    at 64 lanes (ROADMAP B5(a)).
    """
    cap = pow2_bucket(int(queue_depth) + int(active),
                      min_capacity=min_capacity, max_capacity=max_capacity)
    while cap > min_capacity and not mem.fits(block_size, cap, n_vertices):
        cap //= 2
    return int(cap)


def make_plan(g: CSRGraph, num_queries: int, *,
              mem: Optional[MemoryModel] = None,
              block_size: Optional[int] = None,
              method: Optional[str] = None,
              schedule: str = "priority",
              backend: str = "engine",
              yield_config: Optional[YieldConfig] = None,
              fused: object = False) -> Plan:
    """Resolve a plan without measuring (the model-only path)."""
    mem = mem or MemoryModel()
    if fused not in (False, True, "auto"):
        raise ValueError(f"fused must be True, False or 'auto', got "
                         f"{fused!r}")
    if block_size is None:
        block_size = model_block_size(g, num_queries, mem,
                                      fused=fused is True)
    method = method or default_method(g)
    return Plan(block_size=int(block_size), method=method, schedule=schedule,
                backend=backend, num_queries=int(num_queries), mem=mem,
                yield_config=yield_config, fused=fused)


def measure_run(session, kind: str, sources: np.ndarray,
                **overrides) -> dict:
    """Run one configuration through the session and report the sweep
    row: host wall seconds (the card synchronised by the run's read back),
    visits, host syncs, modeled traffic and mean edges per query.
    Partitioning is warmed outside the timed window — it is a one-time
    per-graph cost, not part of the execution being compared."""
    from repro_torch.core.queries import WEIGHT_VARIANTS
    session.prepared(block_size=overrides.get("block_size"),
                     method=overrides.get("method"),
                     weights=WEIGHT_VARIANTS.get(kind, "natural"))
    t0 = time.perf_counter()
    res = session.run(kind, sources, **overrides)
    secs = time.perf_counter() - t0
    return {
        "runtime_s": secs,
        "visits": res.stats.get("visits", 0),
        "host_syncs": res.stats.get("host_syncs", 0),
        "traffic_bytes": res.stats.get("modeled_bytes", 0.0),
        "edges_per_q": float(np.mean(res.edges_processed)),
    }


def autotune_block_size(session, kind: str, sources: np.ndarray,
                        mem: MemoryModel,
                        candidates: Sequence[int] = CANDIDATE_BLOCK_SIZES,
                        objective: str = "traffic_bytes",
                        num_queries: Optional[int] = None,
                        fused: bool = False):
    """Measure each memory-feasible candidate; return (best_B, rows).

    The objective defaults to modeled traffic — deterministic across
    machines, and the paper's Fig. 16 shows it tracks the runtime U-shape
    (visits x bytes per visit).  Ties break toward measured runtime.

    Feasibility is :meth:`MemoryModel.fits` at ``num_queries`` (the plan's
    real batch width) with the ``fused`` flag :func:`make_plan` passes,
    while measurement runs on the (smaller) ``sources`` sample.
    """
    g = session.graph
    nq = num_queries if num_queries is not None else len(sources)
    feasible = [b for b in candidates
                if b < max(2, g.n) and mem.fits(b, nq, g.n, fused=fused)]
    if not feasible:
        raise ValueError(
            f"no candidate block size fits the memory model for Q={nq}; "
            f"shrink the query batch")
    rows = []
    for b in feasible:
        row = measure_run(session, kind, sources, block_size=b)
        row["block_size"] = b
        rows.append(row)
    best = min(rows, key=lambda r: (r[objective], r["runtime_s"]))
    return int(best["block_size"]), rows


def default_yield_config(kind: str, bg) -> YieldConfig:
    """Per-query-kind yield defaults (paper Table 4 settings)."""
    if kind == "bfs":
        return YieldConfig(delta=1.0)          # Δ=1 == level-synchronous
    if kind == "ppr":
        return YieldConfig(mu_factor=100.0)    # paper's NCP setting
    if kind in ("cc", "kreach", "rw"):
        # transformed or no weights: a Δ-window derived from the block
        # values would be the wrong scale, so run the full-window fixpoint
        return YieldConfig()
    wmax = float(np.nanmax(np.where(np.isfinite(bg.blocks), bg.blocks,
                                    np.nan)))
    return YieldConfig(delta=default_delta(wmax))
