"""FPPSession — the front door: plan → execute.

The port of the JAX package's ``repro.fpp.session`` for this slice:

    sess = FPPSession(g)                       # host CSR, original vertex ids
    sess.plan(num_queries=64)                  # Hopper memory-model plan
    res = sess.run("sssp", sources)            # original ids in AND out
    sess.plan(num_queries=64, fused=True)      # one kernel launch per chunk
    res = sess.run("cc", sources)              # canonical component labels
    res = sess.run("kreach", sources, k=8)     # residual = hop counts
    res = sess.run("rw", sources, length=32, seed=0)       # occupancy
    res = sess.run("sssp", sources, backend="baselines")   # same contract
    res = sess.run("ppr", sources, backend="distributed")  # every rank
    sess.plan(num_queries=64, tune=True)       # measured block size
    bc, res = sess.bc(sources)                 # the paper's applications
    labels, res = sess.landmarks(landmarks)
    profile, res = sess.ncp(seeds)
    walks = sess.random_walks(sources, 32, seed=0)         # WalkResult
    ex = sess.stream("sssp", capacity=64)      # queries arriving over time
    qids = ex.submit(batch); ex.pump(64); answers = ex.run()

The session runs on CUDA unless it is given ``device="cpu"``; with no card
and no explicit CPU device it raises.  Everything downstream (engine,
backends, streaming) speaks the *reordered* id space and partition-major
state; the session is the only layer that owns ``perm`` and hides it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.applications import (LandmarkLabels, bc_accumulate,
                                           ncp_profile)
from repro_torch.core.engine import resolve_device
from repro_torch.core.graph import BlockGraph, CSRGraph
from repro_torch.core.oracles import kreach_stride
from repro_torch.core.partition import partition
from repro_torch.core.queries import WEIGHT_VARIANTS, reweight, run_rw
from repro_torch.core.yielding import YieldConfig
from repro_torch.fpp import backends as _backends
from repro_torch.fpp import planner as _planner
from repro_torch.fpp.planner import MemoryModel, Plan


@dataclasses.dataclass
class SessionResult:
    """Backend-independent result, in the ORIGINAL vertex id space."""
    kind: str
    backend: str
    values: np.ndarray                # [Q, n] float32
    residual: Optional[np.ndarray]    # [Q, n] float32 (ppr) or None
    edges_processed: np.ndarray       # [Q] float64
    stats: dict
    sources: np.ndarray               # [Q] original ids as submitted


class FPPSession:
    """Plan → execute for fork-processing patterns on one graph."""

    def __init__(self, g: CSRGraph, *, device=None,
                 mem: Optional[MemoryModel] = None):
        self.graph = g
        self.device = resolve_device(device)
        self.mem = mem or MemoryModel()
        self._plan: Optional[Plan] = None
        # (block_size, method, weight_variant) -> (BlockGraph, perm)
        self._prepared: Dict[tuple, Tuple[BlockGraph, np.ndarray]] = {}
        self._kreach_stride: Optional[float] = None
        self._prepare_lock = threading.Lock()

    @property
    def kreach_stride(self) -> float:
        """The hop shift S of this graph's kreach packing (a per-graph
        constant: ``oracles.kreach_stride`` of n and the max weight),
        shared by the "shift" weight variant and the result decode so they
        cannot disagree."""
        if self._kreach_stride is None:
            g = self.graph
            self._kreach_stride = kreach_stride(
                g.n, float(g.weights.max()) if g.m else 1.0)
        return self._kreach_stride

    # ------------------------------------------------------------------ plan

    def plan(self, num_queries: int = 64, *,
             block_size: Optional[int] = None,
             method: Optional[str] = None,
             schedule: str = "priority",
             backend: str = "engine",
             yield_config: Optional[YieldConfig] = None,
             fused: object = False,
             tune: bool = False,
             tune_sources: Optional[np.ndarray] = None,
             tune_kind: str = "sssp") -> "FPPSession":
        """Resolve the execution plan from the memory model; chainable.

        ``fused`` may be True/False (a blanket visit-body choice) or
        ``"auto"``: each run then picks the body per kind from the
        committed dispatch yardsticks (``planner.auto_fused``).

        ``tune=True`` (without ``block_size``) runs ``tune_kind`` on a
        query sample (``tune_sources``, default: the first 8 vertices
        with out-edges) at every block size the memory model
        admits for this plan, and keeps the one with the least modeled
        traffic (``planner.autotune_block_size``); the plan records the
        rows."""
        p = _planner.make_plan(
            self.graph, num_queries, mem=self.mem, block_size=block_size,
            method=method, schedule=schedule, backend=backend,
            yield_config=yield_config, fused=fused)
        self._plan = p
        if tune and block_size is None:
            if tune_sources is None:
                cand = np.flatnonzero(self.graph.out_degree() > 0)
                tune_sources = cand[:min(8, cand.size)]
            best, rows = _planner.autotune_block_size(
                self, tune_kind, np.asarray(tune_sources), self.mem,
                num_queries=num_queries, fused=fused is True)
            self._plan = dataclasses.replace(
                p, block_size=best, tuned=True,
                tuning_rows=tuple(tuple(sorted(r.items())) for r in rows))
        return self

    @property
    def current_plan(self) -> Plan:
        if self._plan is None:
            self.plan()
        return self._plan

    # -------------------------------------------------------------- prepare

    def prepared(self, *, block_size: Optional[int] = None,
                 method: Optional[str] = None,
                 weights: Optional[str] = None):
        """(BlockGraph, perm) for the plan (or overrides), cached per
        weight variant (``core/queries.reweight``).  Reweighting never
        touches the structure, so every variant of one (block_size, method)
        shares the same perm."""
        p = self.current_plan
        bs = int(block_size or p.block_size)
        meth = method or p.method
        variant = weights or "natural"
        key = (bs, meth, variant)
        with self._prepare_lock:
            if key not in self._prepared:
                stride = self.kreach_stride if variant == "shift" else None
                g = reweight(self.graph, variant, stride=stride)
                self._prepared[key] = partition(g, bs, method=meth)
            return self._prepared[key]

    # ------------------------------------------------------------------ run

    def run(self, kind: str, sources: np.ndarray, *,
            backend: Optional[str] = None,
            schedule: Optional[str] = None,
            yield_config: Optional[YieldConfig] = None,
            block_size: Optional[int] = None,
            method: Optional[str] = None,
            alpha: float = 0.15, eps: float = 1e-4,
            max_visits: Optional[int] = None,
            fused: Optional[bool] = None,
            frontier_mode: str = "dense", k: int = 8, length: int = 32,
            seed: int = 0, mesh=None) -> SessionResult:
        """Execute one query batch.  Sources and values use original ids.

        ``fused`` defaults to the plan's setting (``plan(fused=True)``);
        pass it explicitly to override per run.  ``frontier_mode="sparse"``
        lets the fused kernel skip all-+inf source columns (minplus kinds
        only).

        The session resolves each kind's weight variant and decode: ``cc``
        values come back as canonical min-original-id component labels
        (identical across every lane and backend), ``kreach`` takes the hop
        budget ``k`` (values = dist of the hop-minimal path within the
        budget; residual = hop counts), ``rw`` takes ``length``/``seed``
        (values = occupancy counts; ``fused`` does not apply to it and is
        ignored: the walker loop has no megastep to fuse).  cc computes
        what the reference computes on every graph; it is the weak
        components only on symmetric input (on directed input it regroups
        forward min labels).  The ``random`` schedule draws from the
        engine's default seed, as the reference's session does; ``seed``
        is rw's.  ``backend="distributed"`` runs on ``mesh`` (default:
        ``fpp/backends.default_mesh``); every rank of the mesh makes the
        same call and gets the same result.
        """
        sources = np.asarray(sources)
        p = self.current_plan
        bk = backend or p.backend
        _backends.check_supported(bk, kind)
        bg, perm = self.prepared(block_size=block_size, method=method,
                                 weights=WEIGHT_VARIANTS.get(kind, "natural"))
        if fused is None:
            # the plan's default applies only where it can: other backends
            # run their own visit bodies (an explicit fused=True raises);
            # "auto" keeps the unfused megastep past the dmax budget
            fused = bk == "engine" and kind != "rw" and p.resolve_fused(
                kind, dmax=bg.nbr_blk.shape[1])
        yc = (yield_config if yield_config is not None else
              (p.yield_config or _planner.default_yield_config(kind, bg)))
        out = _backends.run_query(
            bk, kind, bg, perm[sources], schedule=schedule or p.schedule,
            yield_config=yc, alpha=alpha, eps=eps, max_visits=max_visits,
            fused=bool(fused) and kind != "rw", frontier_mode=frontier_mode,
            k=k, hop_stride=(self.kreach_stride if kind == "kreach" else 1.0),
            length=length, seed=seed, mesh=mesh, device=self.device)
        values = out.values[:, perm]          # back to original vertex ids
        if kind == "cc":
            values = _backends.canonicalize_cc(values)
        residual = None if out.residual is None else out.residual[:, perm]
        return SessionResult(kind=kind, backend=bk, values=values,
                             residual=residual,
                             edges_processed=out.edges_processed,
                             stats=out.stats, sources=sources)

    # --------------------------------------------------------------- stream

    def stream(self, kind: str = "sssp", capacity: int = 16, *,
               schedule: Optional[str] = None,
               yield_config: Optional[YieldConfig] = None,
               alpha: float = 0.15, eps: float = 1e-4,
               harvest_every: int = 1, k_visits: int = 64,
               fused: Optional[bool] = None, megastep=None, k: int = 8,
               length: int = 32, seed: int = 0):
        """A streaming executor (``fpp/streaming.py``): submit query batches
        as they arrive; the answers equal the one-shot run of the union.
        ``k_visits`` is the chunk size: admission and harvest happen at
        chunk boundaries, so it is also the lane-recycling latency.
        ``harvest_every`` only sets the per-visit ``step()`` path's
        cadence.  ``fused`` defaults to the plan's (per kind under
        ``fused="auto"``).  ``length`` and ``seed`` are rw's; the other
        kinds' ``random`` schedule draws from the executor's default seed,
        as in the reference.  ``megastep`` injects a prebuilt bundle
        (``fpp/streaming.build_stream_bundle``, served warm by
        ``serve/compile_cache.py``) so the executor builds no engine and
        no ``DeviceGraph``; for rw it is the walk bundle.

        ``kind="rw"`` returns a :class:`~repro_torch.fpp.streaming.
        WalkExecutor` (the same submit/pump/take_finished surface) whose
        walks are bit for bit those of ``run("rw", ...)`` at the
        executor's ``length`` and ``seed``; ``kind="kreach"`` streams at
        hop budget ``k``.
        """
        from repro_torch.fpp.streaming import StreamingExecutor, WalkExecutor
        if kind == "rw":
            return WalkExecutor(self, capacity=capacity, length=length,
                                seed=seed, k_visits=k_visits, visit=megastep)
        if fused is None:
            bg, _ = self.prepared(
                weights=WEIGHT_VARIANTS.get(kind, "natural"))
            fused = self.current_plan.resolve_fused(
                kind, k_visits, dmax=bg.nbr_blk.shape[1])
        return StreamingExecutor(
            self, kind=kind, capacity=capacity,
            schedule=schedule or self.current_plan.schedule,
            yield_config=yield_config, alpha=alpha, eps=eps,
            harvest_every=harvest_every, k_visits=k_visits,
            fused=bool(fused), megastep=megastep, k=k)

    # --------------------------------------------------- paper applications

    def bc(self, sources: np.ndarray, **run_kw):
        """Approximate betweenness centrality from sampled BFS roots:
        (bc [n] float64, the bfs run)."""
        res = self.run("bfs", sources, **run_kw)
        return bc_accumulate(self.graph, np.asarray(sources),
                             res.values), res

    def landmarks(self, landmarks: np.ndarray, **run_kw):
        """Landmark labeling: one sssp per landmark, labels in original
        ids."""
        res = self.run("sssp", landmarks, **run_kw)
        return LandmarkLabels(np.asarray(landmarks), res.values), res

    def ncp(self, seeds: np.ndarray, *, alpha: float = 0.15,
            eps: float = 1e-4, max_size: Optional[int] = None, **run_kw):
        """Network community profile from a fleet of pprs."""
        res = self.run("ppr", seeds, alpha=alpha, eps=eps, **run_kw)
        return ncp_profile(self.graph, res.values, max_size=max_size), res

    def random_walks(self, sources: np.ndarray, length: int = 32, *,
                     seed: int = 0, block_size: Optional[int] = None,
                     method: Optional[str] = None):
        """Buffered random walks (``core/randomwalk.py``), original ids in
        and out: the final ``positions`` map back through the inverse
        permutation; ``steps`` and ``trajectory_hash`` do not depend on the
        id space and pass through (the occupancy stays in the reordered
        padded space, as the reference's does)."""
        sources = np.asarray(sources)
        bg, perm = self.prepared(block_size=block_size, method=method)
        res = run_rw(bg, perm[sources], length, seed=seed,
                     device=self.device)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        return dataclasses.replace(res, positions=inv[res.positions])
