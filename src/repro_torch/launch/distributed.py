"""Run the distributed backend on a world of local ranks.

    PYTHONPATH=src python -m repro_torch.launch.distributed --world 4 \\
        --backend gloo --device cpu --side 16 --block-size 32 \\
        --mesh 1x4 --mesh 2x2 --kinds sssp,bfs,ppr,cc,kreach,rw

starts ``--world`` ranks (``launch/mesh.spawn``), joined by ``--backend``:
``gloo`` where ranks share one card or run on the CPU, ``nccl`` for one
rank per card.  Without ``--device`` every rank runs on the card
``rank % device_count``.  Each rank builds the same ``grid2d`` graph and
session, and every rank runs every (mesh, kind) case through
``FPPSession.run(kind, sources, backend="distributed", mesh=...)``.  One
JSON line per case follows: the mesh, the kind, supersteps, total edges,
and each rank's device syncs, wall seconds and kernel launches; the
command fails unless every rank returned the same answer bit for bit.

:func:`run_cases` is the rank-side body (a test or a smoke run spawns it
with its own cases); :func:`decode_inputs` makes the seeded inputs of a
partitioned-decode case.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def decode_inputs(shape, seed: int, dtype: str = "float32"):
    """Seeded ``(q [B, H, hd] float32, k, v [B, S, Hkv, hd] in dtype)`` on
    the CPU, the same in every process; ``shape = (B, S, H, Hkv, hd)``."""
    B, S, H, Hkv, hd = shape
    gen = torch.Generator().manual_seed(int(seed))
    q = torch.randn((B, H, hd), generator=gen)
    k = torch.randn((B, S, Hkv, hd), generator=gen).to(getattr(torch, dtype))
    v = torch.randn((B, S, Hkv, hd), generator=gen).to(getattr(torch, dtype))
    return q, k, v


def _launches() -> dict:
    from repro_torch.kernels.minplus import ops as mops
    from repro_torch.kernels.threefry import ops as tfops
    return {**mops.LAUNCHES, **tfops.LAUNCHES}


def _reset_launches() -> None:
    from repro_torch.kernels.minplus import ops as mops
    from repro_torch.kernels.threefry import ops as tfops
    mops.reset_launches()
    tfops.reset_launches()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _decode_case(case: dict, mesh, dev) -> dict:
    from repro_torch.models.attention import decode_attend_partitioned
    B, S = case["shape"][:2]
    q, k, v = decode_inputs(case["shape"], case["seed"], case["dtype"])
    nb, ns = mesh.shape["data"], mesh.shape["model"]
    if B % nb or S % ns:
        raise ValueError(f"decode batch {B} and cache {S} must divide by "
                         f"the mesh {mesh.shape}")
    b_loc, s_loc = B // nb, S // ns
    rows = slice(mesh.coords["data"] * b_loc, (mesh.coords["data"] + 1)
                 * b_loc)
    cols = slice(mesh.coords["model"] * s_loc, (mesh.coords["model"] + 1)
                 * s_loc)
    length = torch.as_tensor(np.asarray(case["lengths"], dtype=np.int32))
    q, length = q[rows].to(dev), length[rows].to(dev)
    k, v = (x[rows, cols].contiguous().to(dev) for x in (k, v))
    _sync(dev)
    t = time.perf_counter()
    out = decode_attend_partitioned(q, k, v, length, mesh,
                                    window=case.get("window"))
    out = torch.cat(list(mesh.all_gather(out, "data")), dim=0)
    _sync(dev)
    return {"out": out.float().cpu().numpy(),
            "wall_s": time.perf_counter() - t}


def run_cases(rank: int, cases: list, device=None) -> list:
    """Run ``cases`` on this rank; every rank of the world runs the same
    list (building a mesh is collective).  A case is a dict:

    * a query: ``graph`` ``(generator name, kwargs)`` of
      ``graphs/generators``, ``mesh`` ``(data, model)`` (None: the default
      mesh), ``kind``, ``sources`` (original ids), ``num_queries``,
      ``block_size`` (None: the planner's), and optional ``k``,
      ``length``, ``seed``, ``eps`` as ``FPPSession.run`` takes them;
    * a partitioned decode: ``decode`` True, ``mesh``, ``shape`` ``(B, S,
      H, Hkv, hd)``, ``seed``, ``dtype``, ``lengths`` and an optional
      ``window`` (inputs from :func:`decode_inputs`).

    Returns one dict per case: the answer (``values``, ``residual``,
    ``edges``, ``stats``; or ``out``), ``wall_s`` and this rank's kernel
    ``launches`` during the case."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.fpp import FPPSession
    from repro_torch.fpp.backends import default_mesh
    from repro_torch.graphs import generators
    from repro_torch.launch.mesh import make_host_mesh

    dev = resolve_device(device)
    meshes: dict = {}
    sessions: dict = {}
    out = []
    for case in cases:
        shape = case.get("mesh")
        key = None if shape is None else tuple(shape)
        if key not in meshes:
            meshes[key] = default_mesh() if key is None else \
                make_host_mesh(*key)
        mesh = meshes[key]
        _reset_launches()
        if case.get("decode"):
            res = _decode_case(case, mesh, dev)
            res["launches"] = _launches()
            out.append(res)
            continue
        name, kw = case["graph"]
        skey = (name, tuple(sorted(kw.items())), case["num_queries"],
                case.get("block_size"))
        if skey not in sessions:
            g = getattr(generators, name)(**kw)
            sessions[skey] = FPPSession(g, device=dev).plan(
                num_queries=case["num_queries"],
                block_size=case.get("block_size"))
        sess = sessions[skey]
        opts = {k: case[k] for k in ("k", "length", "seed", "eps")
                if k in case}
        _sync(dev)
        t = time.perf_counter()
        res = sess.run(case["kind"], np.asarray(case["sources"]),
                       backend="distributed", mesh=mesh, **opts)
        _sync(dev)
        out.append({"values": res.values, "residual": res.residual,
                    "edges": res.edges_processed, "stats": res.stats,
                    "wall_s": time.perf_counter() - t,
                    "launches": _launches()})
    return out


def same_answers(per_rank: list) -> bool:
    """Every rank's answers bit for bit equal to rank 0's (values,
    residual, edges, supersteps; a decode's output)."""
    def key(r):
        if "out" in r:
            return (r["out"].tobytes(),)
        return (r["values"].tobytes(), None if r["residual"] is None
                else r["residual"].tobytes(), r["edges"].tobytes(),
                r["stats"]["supersteps"])
    first = [key(r) for r in per_rank[0]]
    return all([key(r) for r in rank] == first for rank in per_rank[1:])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--side", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--mesh", action="append", default=None,
                    help="DATAxMODEL; repeatable (default: 1xWORLD)")
    ap.add_argument("--kinds", default="sssp,bfs,ppr,cc,kreach,rw")
    ap.add_argument("--timeout", type=float, default=60.0)
    return ap.parse_args(argv)


def main(argv=None) -> list:
    from repro_torch.launch.mesh import spawn

    args = parse_args(argv)
    n = args.side * args.side
    srcs = np.random.default_rng(args.seed).choice(n, args.queries,
                                                   replace=False)
    meshes = [tuple(int(x) for x in m.split("x"))
              for m in (args.mesh or [f"1x{args.world}"])]
    cases = [{"graph": ("grid2d", {"rows": args.side, "cols": args.side,
                                   "seed": args.seed}),
              "mesh": m, "kind": kind, "sources": srcs.tolist(),
              "num_queries": args.queries, "block_size": args.block_size}
             for m in meshes for kind in args.kinds.split(",")]
    per_rank = spawn(run_cases, args.world, args.backend,
                     args=(cases, args.device), timeout_s=args.timeout)
    if not same_answers(per_rank):
        raise RuntimeError("the ranks returned different answers")
    for i, case in enumerate(cases):
        r0 = per_rank[0][i]
        print(json.dumps({
            "mesh": list(case["mesh"]), "backend": args.backend,
            "kind": case["kind"], "supersteps": r0["stats"]["supersteps"],
            "edges": float(r0["edges"].sum()),
            "device_syncs": [r[i]["stats"]["device_syncs"]
                             for r in per_rank],
            "wall_s": [r[i]["wall_s"] for r in per_rank],
            "launches": [r[i]["launches"] for r in per_rank]}))
    return per_rank


if __name__ == "__main__":
    main()
