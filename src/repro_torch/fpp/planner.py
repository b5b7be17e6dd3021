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
232,448); B = 256 does not fit.  Measuring the candidates (the reference's
``tune=True``) waits for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.core.yielding import YieldConfig, default_delta

#: block-size candidates, smallest to largest
CANDIDATE_BLOCK_SIZES = (64, 128, 256, 512, 1024, 2048, 4096)

#: measured dispatch yardsticks (visits/s) keyed (kind, dispatch, K), read
#: by :func:`auto_fused`.  Empty until the port has a fused visit and a
#: benchmark measured on the card; the reference's rows are not carried over.
DISPATCH_YARDSTICKS: dict = {}

#: bfs runs the same minplus kernels as sssp, so it shares sssp's rows
_YARDSTICK_KIND = {"bfs": "sssp", "cc": "sssp", "kreach": "sssp"}


def auto_fused(kind: str, k_visits: int = 64) -> bool:
    """True iff the committed yardsticks show a fused visit faster than the
    unfused megastep for ``kind`` at the nearest chunk size.  With no rows,
    False for every kind."""
    yk = _YARDSTICK_KIND.get(kind, kind)
    ks = sorted({k for (kk, _, k) in DISPATCH_YARDSTICKS if kk == yk})
    if not ks:
        return False
    k = min(ks, key=lambda c: abs(c - int(k_visits)))
    fused = DISPATCH_YARDSTICKS.get((yk, "fused", k))
    plain = DISPATCH_YARDSTICKS.get((yk, "megastep", k))
    return fused is not None and plain is not None and fused > plain


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
    caps the state so Q and B cannot silently overflow the card.
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

    def state_bytes(self, n_vertices: int, num_queries: int,
                    block_size: int) -> int:
        """HBM-resident state planes (dist + buf + one spare), padded."""
        n_pad = -(-n_vertices // block_size) * block_size
        return 3 * n_pad * num_queries * self.dtype_bytes

    def fits(self, block_size: int, num_queries: int,
             n_vertices: Optional[int] = None) -> bool:
        if self.working_set(block_size, num_queries) > self.smem_bytes:
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
    #: visit-body dispatch: False = unfused megastep, "auto" = per kind
    #: from the yardsticks (:func:`auto_fused`); the fused visit itself is
    #: not ported yet (ROADMAP B5)
    fused: object = False

    def resolve_fused(self, kind: str, k_visits: int = 64) -> bool:
        """The concrete visit body for one kind under this plan."""
        if self.fused == "auto":
            return auto_fused(kind, k_visits)
        return bool(self.fused)


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
                     min_parts: int = 8) -> int:
    """Largest candidate whose visit working set fits the memory model.

    Also keeps at least ``min_parts`` partitions alive (clamped to what the
    graph can support), so the scheduler has partitions to choose between.

    A skew guard for hub-heavy graphs: one visit's neighbourhood — the
    diagonal block plus :func:`est_dmax` boundary blocks — must stay
    inside the L2 cache.
    """
    best = None
    for b in candidates:
        if -(-g.n // b) < max(2, min(min_parts, g.n // candidates[0])):
            break
        hood = (1 + est_dmax(g, b)) * b * b * mem.dtype_bytes
        if hood > mem.l2_bytes:
            continue   # hub neighbourhoods outgrow L2 at this B
        if mem.fits(b, num_queries, g.n):
            best = b
    if best is None:
        raise ValueError(
            f"no candidate block size fits the memory model for "
            f"Q={num_queries} (smallest candidate {candidates[0]} needs "
            f"{mem.working_set(candidates[0], num_queries)} B of "
            f"{mem.smem_bytes} B shared memory); shrink the query batch")
    return best


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
    if fused is True:
        raise NotImplementedError(
            "the fused visit is not ported yet (ROADMAP B5)")
    if fused not in (False, "auto"):
        raise ValueError(f"fused must be False or 'auto', got {fused!r}")
    if block_size is None:
        block_size = model_block_size(g, num_queries, mem)
    method = method or default_method(g)
    return Plan(block_size=int(block_size), method=method, schedule=schedule,
                backend=backend, num_queries=int(num_queries), mem=mem,
                yield_config=yield_config, fused=fused)


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
