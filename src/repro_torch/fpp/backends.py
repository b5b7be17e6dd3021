"""Backend dispatch behind one result contract.

The port of the JAX package's ``repro.fpp.backends``.  Every kind (sssp,
bfs, ppr, cc, kreach, rw) runs on every backend:

  engine       the buffered engine (``core/engine.py``; rw the buffered
               walker loop, ``core/randomwalk.py``)
  distributed  the superstep runtime over ``torch.distributed``
               (``core/distributed.py``): partitions over the mesh's
               ``model`` axis, queries over ``data``; every rank of the
               mesh calls it with the same arguments
  baselines    the global-frontier engines (``core/baselines.py``)

Whatever the backend, ``values`` is float32 ``[Q, n]`` in the *reordered*
id space (the session maps back to original ids) and ``edges_processed``
is float64 ``[Q]`` holding exact integral counts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import distributed as _dist
from repro_torch.core.baselines import (global_minplus, global_push,
                                       global_random_walks)
from repro_torch.core.engine import FPPEngine
from repro_torch.core.graph import BlockGraph
from repro_torch.core.oracles import decode_kreach
from repro_torch.core.randomwalk import run_random_walks
from repro_torch.core.visit import cc_label_plane
from repro_torch.core.yielding import YieldConfig
from repro_torch.launch.mesh import Mesh, world_size

BACKENDS = ("engine", "distributed", "baselines")
KINDS = ("sssp", "bfs", "ppr", "cc", "kreach", "rw")

#: engine mode per ported kind
_ENGINE_MODE = {"sssp": "minplus", "bfs": "minplus", "ppr": "push",
                "cc": "cc", "kreach": "kreach"}

#: the default mesh, built once per default process group (building a mesh
#: is collective: see launch/mesh.py)
_DEFAULT_MESH: dict = {}


@dataclasses.dataclass
class BackendResult:
    values: np.ndarray                 # [Q, n] float32, reordered id space
    residual: Optional[np.ndarray]     # [Q, n] float32 (push kinds) or None
    edges_processed: np.ndarray        # [Q] float64
    stats: dict                        # visits / rounds / syncs / bytes


def _normalize(values, residual, edges, stats) -> BackendResult:
    return BackendResult(
        values=np.ascontiguousarray(np.asarray(values, dtype=np.float32)),
        residual=(None if residual is None
                  else np.asarray(residual, dtype=np.float32)),
        edges_processed=np.asarray(edges, dtype=np.float64),
        stats=stats)


def canonicalize_cc(values: np.ndarray) -> np.ndarray:
    """Rewrite raw cc label rows (reordered-rep ids) into the canonical
    min-original-id-per-component labels.

    ``values``: [Q, n] rows in the ORIGINAL vertex order whose cells hold
    the backend's reordered representative ids.  Two vertices share a
    label iff they share a cell value, so grouping by value and taking the
    min row index (= min original id) gives labels independent of the
    partitioning permutation — the form union-find
    (``oracles.connected_components``) produces on symmetric input.

    A row that still holds +inf (a vertex no label reached yet: a cc run cut
    by ``max_visits`` before it converged) has no canonical labels; it
    raises a ``ValueError``.  (The reference casts the +inf to int64 and
    fails with an ``IndexError`` there, ROADMAP C6; no answer changes.)
    """
    values = np.asarray(values)
    if not np.isfinite(values).all():
        raise ValueError(
            "cc: a label row still holds +inf, so the run stopped before its "
            "labels converged (cut by max_visits?); cc has canonical labels "
            "only for a converged run: raise max_visits or leave it unset")
    n = values.shape[1]
    out = np.empty_like(values, dtype=np.float32)
    done: dict = {}
    for q in range(values.shape[0]):
        key = values[q].tobytes()       # cc lanes are identical; decode once
        if key not in done:
            reps = values[q].astype(np.int64)
            min_orig = np.full(n, n, dtype=np.int64)
            np.minimum.at(min_orig, reps, np.arange(n))
            done[key] = min_orig[reps].astype(np.float32)
        out[q] = done[key]
    return out


def check_supported(backend: str, kind: str) -> None:
    """Raise unless ``backend`` and ``kind`` are known."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if kind not in KINDS:
        raise ValueError(f"unknown query kind {kind!r}; one of {KINDS}")


def default_mesh() -> Mesh:
    """``(data=1, model=world)`` over the initialised default process
    group, or the one-rank mesh when there is none."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh((1, 1))
    world = dist.group.WORLD
    if _DEFAULT_MESH.get("group") is not world:
        _DEFAULT_MESH.update(group=world, mesh=Mesh((1, world_size())))
    return _DEFAULT_MESH["mesh"]


def _rw_result(res, stats: dict) -> BackendResult:
    """WalkResult -> the uniform backend contract: values = occupancy
    counts [Q, n] (start + each step's position), edges = steps taken."""
    return _normalize(res.occupancy, None,
                      np.asarray(res.steps, dtype=np.float64), stats)


def run_query(backend: str, kind: str, bg: BlockGraph, sources: np.ndarray,
              *, schedule: str = "priority",
              yield_config: Optional[YieldConfig] = None,
              alpha: float = 0.15, eps: float = 1e-4,
              max_visits: Optional[int] = None,
              fused: bool = False, frontier_mode: str = "dense",
              k: int = 8, hop_stride: float = 1.0,
              length: int = 32, seed: int = 0, mesh=None,
              device=None) -> BackendResult:
    """Run one query batch (sources in reordered ids) on one backend.

    ``fused=True`` (engine backend only) runs each K-visit chunk as one
    launch of the fused visit kernel; ``frontier_mode="sparse"`` (minplus
    kinds) lets it skip query rows whose sources are all +inf.

    The transformed-weight kinds expect ``bg`` already built from the
    matching weight variant (the session's ``prepared`` does this): bfs a
    unit-weight graph, cc a zero-weight one, kreach the hop-shifted
    weights with ``hop_stride`` = the shift S (``oracles.kreach_stride``)
    and ``k`` the hop budget.  Raw cc values are reordered-rep labels —
    callers canonicalize with :func:`canonicalize_cc` after mapping back
    to original ids.  kreach's residual is its hop plane.  ``rw`` takes
    the natural graph plus ``length``/``seed``; its values are occupancy
    counts and its walks are the same on both backends (the tape contract
    of ``core/randomwalk.py``); ``fused`` does not apply to it.
    ``mesh`` (distributed backend only) defaults to :func:`default_mesh`;
    the distributed stats are the reference's ``supersteps`` plus this
    rank's ``device_syncs``.
    """
    if fused and backend != "engine":
        raise ValueError(
            f"fused=True is an engine-backend flag; backend={backend!r} "
            f"runs its own visit bodies")
    check_supported(backend, kind)
    sources = np.asarray(sources)
    if kind == "rw":
        if backend == "engine":
            res = run_random_walks(bg, sources, length, seed=seed,
                                   device=device)
            return _rw_result(res, {"visits": res.visits,
                                    "rounds": res.rounds,
                                    "device_syncs": res.device_syncs})
        if backend == "distributed":
            res = _dist.run_distributed_walks(
                bg, sources, mesh or default_mesh(), length, seed=seed,
                device=device)
            return _rw_result(res, {"supersteps": res.visits,
                                    "device_syncs": res.device_syncs})
        res = global_random_walks(bg, sources, length, seed=seed,
                                  device=device)
        return _rw_result(res, {"rounds": res.visits})
    if backend == "engine":
        eng = FPPEngine(bg, mode=_ENGINE_MODE[kind],
                        num_queries=len(sources),
                        yield_config=yield_config or YieldConfig(),
                        schedule=schedule, alpha=alpha, eps=eps, fused=fused,
                        frontier_mode=frontier_mode, hop_budget=k,
                        hop_stride=hop_stride, device=device)
        res = eng.run(sources, max_visits=max_visits)
        return _normalize(res.values, res.residual, res.edges_processed, {
            "visits": res.stats.visits, "rounds": res.stats.rounds,
            "blocks_loaded": res.stats.blocks_loaded,
            "modeled_bytes": res.stats.modeled_bytes,
            "host_syncs": res.stats.host_syncs,
            "device_syncs": res.stats.device_syncs})

    if backend == "distributed":
        mesh = mesh or default_mesh()
        if kind == "ppr":
            res = _dist.run_distributed_ppr(bg, sources, mesh, alpha=alpha,
                                            eps=eps, yield_config=yield_config,
                                            device=device)
        elif kind == "cc":
            res = _dist.run_distributed_cc(bg, len(sources), mesh,
                                           yield_config=yield_config,
                                           device=device)
        else:
            res = _dist.run_distributed_sssp(bg, sources, mesh,
                                             yield_config=yield_config,
                                             device=device)
        values, residual = res.values, res.residual
        if kind == "kreach":
            values, residual = decode_kreach(values, hop_stride, k)
        return _normalize(values, residual, res.edges_processed, {
            "supersteps": res.supersteps,
            "device_syncs": res.device_syncs})

    # baselines: the global-frontier engines
    if kind == "ppr":
        res = global_push(bg, sources, alpha=alpha, eps=eps, device=device)
        residual = np.zeros_like(res.values)  # Jacobi push drains below eps
    elif kind == "cc":
        res = global_minplus(bg, sources, init_plane=cc_label_plane(bg),
                             device=device)
        residual = None
    else:
        res = global_minplus(bg, sources, device=device)
        residual = None
    values = res.values
    if kind == "kreach":
        values, residual = decode_kreach(values, hop_stride, k)
    return _normalize(values, residual, res.edges_processed, {
        "rounds": res.rounds, "modeled_bytes": res.modeled_bytes,
        "modeled_bytes_shared": res.modeled_bytes_shared})
