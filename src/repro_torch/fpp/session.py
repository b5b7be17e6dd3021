"""FPPSession — the front door: plan → execute.

The port of the JAX package's ``repro.fpp.session`` for this slice:

    sess = FPPSession(g)                       # host CSR, original vertex ids
    sess.plan(num_queries=64)                  # Hopper memory-model plan
    res = sess.run("sssp", sources)            # original ids in AND out

The session runs on CUDA unless it is given ``device="cpu"``; with no card
and no explicit CPU device it raises.  Everything downstream (engine,
backends) speaks the *reordered* id space and partition-major state; the
session is the only layer that owns ``perm`` and hides it.  ``stream``,
``bc``, ``landmarks``, ``ncp`` and ``random_walks`` wait for later slices.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.engine import resolve_device
from repro_torch.core.graph import BlockGraph, CSRGraph
from repro_torch.core.partition import partition
from repro_torch.core.queries import WEIGHT_VARIANTS, reweight
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
        self._prepare_lock = threading.Lock()

    # ------------------------------------------------------------------ plan

    def plan(self, num_queries: int = 64, *,
             block_size: Optional[int] = None,
             method: Optional[str] = None,
             schedule: str = "priority",
             backend: str = "engine",
             yield_config: Optional[YieldConfig] = None,
             fused: object = False) -> "FPPSession":
        """Resolve the execution plan from the memory model; chainable."""
        self._plan = _planner.make_plan(
            self.graph, num_queries, mem=self.mem, block_size=block_size,
            method=method, schedule=schedule, backend=backend,
            yield_config=yield_config, fused=fused)
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
                g = reweight(self.graph, variant)
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
            fused: Optional[bool] = None) -> SessionResult:
        """Execute one query batch.  Sources and values use original ids.

        ``fused`` defaults to the plan's setting, which resolves to the
        unfused megastep for every kind until the fused visit is ported
        (ROADMAP B5); ``fused=True`` raises.
        """
        sources = np.asarray(sources)
        p = self.current_plan
        bk = backend or p.backend
        _backends.check_supported(bk, kind)
        if fused is None:
            fused = p.resolve_fused(kind)
        if fused:
            raise NotImplementedError(
                "the fused visit is not ported yet (ROADMAP B5)")
        bg, perm = self.prepared(block_size=block_size, method=method,
                                 weights=WEIGHT_VARIANTS.get(kind, "natural"))
        yc = (yield_config if yield_config is not None else
              (p.yield_config or _planner.default_yield_config(kind, bg)))
        out = _backends.run_query(
            bk, kind, bg, perm[sources], schedule=schedule or p.schedule,
            yield_config=yc, alpha=alpha, eps=eps, max_visits=max_visits,
            device=self.device)
        residual = None if out.residual is None else out.residual[:, perm]
        return SessionResult(kind=kind, backend=bk,
                             values=out.values[:, perm], residual=residual,
                             edges_processed=out.edges_processed,
                             stats=out.stats, sources=sources)
