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
partitioned-decode case.  :func:`run_lm_cases` is the rank-side body of
the LM on a mesh: a model's prefill, decode, forward and
``ContinuousBatcher`` on a rank's shards of its params.
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


def _kernel_modules() -> tuple:
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.frontier import ops as fops
    from repro_torch.kernels.fused_visit import ops as fvops
    from repro_torch.kernels.minplus import ops as mops
    from repro_torch.kernels.ppr_push import ops as pops
    from repro_torch.kernels.threefry import ops as tfops
    return mops, fops, pops, fvops, faops, tfops


def _launches() -> dict:
    """Every kernel wrapper's launch count on this rank."""
    return {k: v for m in _kernel_modules() for k, v in m.LAUNCHES.items()}


def _reset_launches() -> None:
    for m in _kernel_modules():
        m.reset_launches()


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


# ---------------------------------------------------------------------------
# the LM on a mesh


def _lm_params(model, case: dict, rules, dev):
    """A rank's shards of the case's params: the whole ``arrays`` (numpy,
    the reference's tree) cut by ``convert.lm_params_from_arrays``, or
    ``Model.init`` from the generator seeded ``seed`` on ``dev``, built
    whole by one rank at a time (a barrier between ranks), so that only
    one whole copy is ever on a card that the ranks share."""
    import torch.distributed as dist

    from repro_torch.convert import lm_params_from_arrays
    if "arrays" in case:
        return lm_params_from_arrays(case["arrays"], model.cfg, dev, rules)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = None
    for r in range(world):
        if r == rank:
            gen = torch.Generator(device=dev).manual_seed(case["seed"])
            mine = model.shard_params(model.init(gen, dev), rules)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if world > 1:
            dist.barrier()
    return mine


def _lm_batch(tokens, extras, dev) -> dict:
    batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int64),
                                       device=dev)}
    for k, v in (extras or {}).items():
        batch[k] = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    return batch


def _whole_rows(x: torch.Tensor, batch: int, mesh) -> np.ndarray:
    """A rank's rows of a ``[batch, ...]`` result -> every row (an
    all-gather over ``"data"`` when the rows are split), float32 numpy."""
    if x.shape[0] < batch:
        x = torch.cat(list(mesh.all_gather(x, "data")))
    return x.float().cpu().numpy()


def _lm_teacher(model, params, t: dict, mesh, rules, dev) -> dict:
    """A prefill of the batch ``t["tokens"] [B, S]`` (and ``extras``) at
    ``max_len`` (``chunk``: the transformer's prefill chunk), then one
    decode step for each ``t["steps"]`` row ``[B]`` of tokens, fed as
    given (teacher forcing).  Every row's logits."""
    from repro_torch.models import transformer as tfm

    batch = _lm_batch(t["tokens"], t.get("extras"), dev)
    B = batch["tokens"].shape[0]
    if "chunk" in t:
        logits, state = tfm.prefill(params, model.cfg, batch["tokens"],
                                    max_len=t["max_len"], chunk=t["chunk"],
                                    rules=rules)
    else:
        logits, state = model.prefill(params, batch, max_len=t["max_len"],
                                      rules=rules)
    out = {"prefill": _whole_rows(logits, B, mesh), "decode": []}
    calls = []
    for row in t.get("steps", ()):
        tok = torch.as_tensor(np.asarray(row, np.int64)[:, None], device=dev)
        c0 = mesh.calls
        logits, state = model.decode(params, tok, state, mesh=mesh,
                                     rules=rules)
        calls.append(mesh.calls - c0)
        out["decode"].append(_whole_rows(logits, B, mesh))
    out["decode"] = np.stack(out["decode"]) if out["decode"] else None
    out["collectives_per_decode_step"] = calls
    return out


def _lm_serve(model, params, s: dict, mesh, rules, dev) -> dict:
    """``ContinuousBatcher(mesh=, rules=)`` over ``s["prompts"]`` (and
    ``extras``, one per prompt) at ``batch`` and ``max_len``, ``new`` tokens
    each: the tokens, and this rank's walls, prefill times, collectives a
    decode step (the model's, without the batcher's gather and check of
    the tokens) and kernel launches."""
    from repro_torch.serve.engine import (ContinuousBatcher, Request,
                                          make_decode_step,
                                          make_prefill_step)
    prefill = make_prefill_step(model, max_len=s["max_len"], rules=rules)
    decode = make_decode_step(model, mesh=mesh, rules=rules)
    prefill_s, decode_calls = [], []

    def timed_prefill(p, batch):
        _sync(dev)
        t0 = time.perf_counter()
        out = prefill(p, batch)
        _sync(dev)
        prefill_s.append(time.perf_counter() - t0)
        return out

    def counted_decode(p, tokens, state):
        c0 = mesh.calls
        out = decode(p, tokens, state)
        decode_calls.append(mesh.calls - c0)
        return out

    b = ContinuousBatcher(model, params, s["batch"], s["max_len"], device=dev,
                          mesh=mesh, rules=rules, prefill_fn=timed_prefill,
                          decode_fn=counted_decode)
    extras = s.get("extras") or [None] * len(s["prompts"])
    for rid, (p, ex) in enumerate(zip(s["prompts"], extras)):
        b.submit(Request(rid=rid, prompt=np.asarray(p, np.int32),
                         max_new_tokens=s["new"],
                         extras=None if ex is None else dict(ex)))
    _reset_launches()
    calls0 = mesh.calls
    _sync(dev)
    t = time.perf_counter()
    tokens = b.run()
    _sync(dev)
    wall = time.perf_counter() - t
    decode_tokens = b.tokens_out - len(s["prompts"])
    return {"tokens": tokens, "wall_s": wall, "prefill_s": prefill_s,
            "decode_s": wall - sum(prefill_s), "decode_steps": b.steps,
            "decode_tok_per_s": decode_tokens / (wall - sum(prefill_s)),
            "collectives_per_decode_step": (
                sum(decode_calls) / max(len(decode_calls), 1)),
            "collectives": mesh.calls - calls0, "launches": _launches()}


def run_lm_cases(rank: int, cases: list, device=None) -> list:
    """Run LM ``cases`` on this rank of a world (every rank the same list:
    building a mesh is collective).  A case is a dict:

    * ``arch``, optional ``reduced`` (``ArchConfig.reduced()``) and
      ``config`` (fields replaced after it, e.g. ``{"compute_dtype":
      "float32"}``), optional ``overrides`` (extra rules, e.g.
      ``{"manual_tp": True}``) and ``mesh`` ``(data, model)``; the rules
      are ``launch/steps.rules_for(cfg, mesh, overrides)``;
    * the weights: ``arrays`` (the reference's numpy tree) or ``seed``
      (:func:`_lm_params`);
    * any of ``teacher`` (:func:`_lm_teacher`), ``logits`` (``{"tokens",
      "extras"}``: ``Model.logits`` of that batch, with its own
      ``overrides`` on top of the case's, every ``stride``-th position's
      row) and ``serve`` (:func:`_lm_serve`), run in that order on the
      same params.

    Returns one dict per case with each part's result (logits as float32
    numpy with every row of the batch), ``wall_s``, this rank's kernel
    ``launches`` over the parts before ``serve`` (which counts its own) and
    its card's ``peak_mem_bytes`` over the case."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import rules_for
    from repro_torch.models.factory import build_model

    dev = resolve_device(device)
    meshes: dict = {}
    out = []
    for case in cases:
        key = tuple(case["mesh"])
        if key not in meshes:
            meshes[key] = make_host_mesh(*key)
        mesh = meshes[key]
        cfg = get_config(case["arch"])
        cfg = cfg.reduced() if case.get("reduced") else cfg
        cfg = dataclasses.replace(cfg, **case.get("config", {}))
        model = build_model(cfg)
        rules = rules_for(cfg, mesh, case.get("overrides"))
        _reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t = time.perf_counter()
        params = _lm_params(model, case, rules, dev)
        _sync(dev)
        res = {"params_s": time.perf_counter() - t}
        with torch.inference_mode():
            if "teacher" in case:
                res["teacher"] = _lm_teacher(model, params, case["teacher"],
                                             mesh, rules, dev)
            if "logits" in case:
                lg = case["logits"]
                batch = _lm_batch(lg["tokens"], lg.get("extras"), dev)
                lrules = rules_for(cfg, mesh, {**case.get("overrides", {}),
                                               **lg.get("overrides", {})})
                logits, _ = model.logits(params, batch, rules=lrules,
                                         remat=False)
                res["logits"] = _whole_rows(
                    logits[:, ::lg.get("stride", 1)], len(lg["tokens"]), mesh)
                del logits
            res["launches"] = _launches()
            if "serve" in case:
                res["serve"] = _lm_serve(model, params, case["serve"], mesh,
                                         rules, dev)
        res["wall_s"] = time.perf_counter() - t
        res["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(res)
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
