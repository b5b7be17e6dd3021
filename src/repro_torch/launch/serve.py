"""End-to-end serving driver: continuous batching over batched requests.

The port of the JAX package's ``repro.launch.serve``.  Two workloads, on
the card unless ``--device cpu`` is given:

  lm     token serving through ``ContinuousBatcher``
  graph  graph-query serving: a multi-tenant ``GraphServer`` multiplexes an
         arrival stream of requests onto per-(graph, kind) lane pools over
         the streaming executors

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --no-reduced --requests 8 --batch 4 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
        --device cpu --requests 4 --batch 2 --max-new 4
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --no-reduced     # also falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --no-reduced     # phi3.5-moe: reduced only
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch paligemma-3b --no-reduced          # also whisper-base
    PYTHONPATH=src python -m repro_torch.launch.serve --workload graph \\
        --graph road-ca --kind mixed --requests 32 --batch 8 --tenants 2

``--reduced`` (the default) serves the config's CPU-test variant;
``--no-reduced`` the published widths.  A vlm request brings
``num_image_tokens`` random image embeddings and an encdec request 1,500
random frames (the stub frontends' outputs), as the reference's
``launch/serve.py`` makes them.  The graph workload's partition size
is the port's planner's choice unless ``--block-size`` is given (the
reference's default of 256 was sized for a TPU's memory).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

#: prompts are 4 to MAX_PROMPT - 1 random tokens, as in the reference's
#: ``launch/serve.py``
MAX_PROMPT = 12


def serve_lm(args):
    """Serve ``args.requests`` random prompts; returns ``{rid: tokens}``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.models.encdec import N_FRAMES
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import ContinuousBatcher, Request

    dev = resolve_device(getattr(args, "device", None))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(args.seed)

    # a hybrid's decode reads its whole attention window (ROADMAP C5); a
    # vlm's cache holds the image prefix, the prompt and the new tokens
    max_len = args.max_len or max(
        96, cfg.hybrid.window if cfg.hybrid else 0,
        cfg.num_image_tokens + MAX_PROMPT + args.max_new)
    batcher = ContinuousBatcher(model, params, batch_size=args.batch,
                                max_len=max_len, device=dev)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              rng.integers(4, MAX_PROMPT)).astype(np.int32)
        extras = None
        if cfg.family == "vlm":
            extras = {"image_embeds": rng.normal(size=(
                cfg.num_image_tokens, cfg.d_model)).astype(np.float32)}
        if cfg.family == "encdec":
            extras = {"frames": 0.1 * rng.normal(size=(
                N_FRAMES, cfg.d_model)).astype(np.float32)}
        batcher.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=args.max_new, extras=extras))
    t0 = time.perf_counter()
    out = batcher.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {dev}: {len(out)} requests, "
          f"{batcher.tokens_out} tokens in {batcher.steps} decode steps, "
          f"{dt:.2f}s ({batcher.tokens_out / dt:.1f} tok/s)")
    for rid in sorted(out)[:4]:
        print(f"  req {rid}: {out[rid]}")
    return out


def serve_graph(args):
    """Multi-tenant graph-query serving through the running lanes; returns
    the response table.  Raises if a request gets no terminal response."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.graphs.generators import build_suite
    from repro_torch.serve import GraphRequest, GraphServer

    dev = resolve_device(getattr(args, "device", None))
    g = build_suite(args.graph)
    rng = np.random.default_rng(args.seed)
    cand = np.flatnonzero(g.out_degree() > 0)
    sources = rng.choice(cand, size=args.requests, replace=True)
    kinds = (("sssp", "ppr") if args.kind == "mixed" else (args.kind,))
    # tenant 0 is the hot tenant (most of the offered load); equal weights,
    # so fair admission alone must keep the cold tenants served
    tenants = [f"tenant{i}" for i in range(args.tenants)]

    server = GraphServer(capacity=args.batch, k_visits=args.pump_visits,
                         seed=args.seed, device=dev)
    server.register_graph(args.graph, g, num_queries=args.batch,
                          block_size=args.block_size)

    def arrivals():
        # one submission batch per arrival, interleaved with the running
        # lanes' chunks
        for lo in range(0, len(sources), args.batch):
            yield [GraphRequest(kind=kinds[i % len(kinds)], source=int(s),
                                graph=args.graph,
                                tenant=(tenants[0] if i % 4 else
                                        tenants[(i // 4) % len(tenants)]))
                   for i, s in enumerate(sources[lo: lo + args.batch],
                                         start=lo)]

    t0 = time.perf_counter()
    out = server.serve_forever(arrivals())
    dt = time.perf_counter() - t0
    ok = [r for r in out.values() if r.status == "ok"]
    if len(out) != len(sources):
        raise RuntimeError(
            f"server answered {len(out)} of {len(sources)} requests — "
            f"every submitted request must get a terminal response")
    lat = np.array([r.stats["latency_s"] for r in ok]) * 1e3
    print(f"[serve] graph={args.graph} |V|={g.n} kinds={'/'.join(kinds)} "
          f"tenants={args.tenants} on {dev}: {len(ok)}/{len(out)} ok in "
          f"{server.rounds} rounds, {dt:.2f}s "
          f"({len(ok) / max(dt, 1e-9):.1f} q/s, capacity={args.batch}, "
          f"B={server._sessions[args.graph].current_plan.block_size}, "
          f"K={args.pump_visits})")
    if len(lat):
        syncs = [r.stats["host_syncs"] for r in ok]
        print(f"  latency p50/p99: {np.percentile(lat, 50):.1f}/"
              f"{np.percentile(lat, 99):.1f} ms; per-request host syncs "
              f"p50: {np.percentile(syncs, 50):.0f}")
    return out


def main(argv=None):
    from repro_torch.graphs.generators import SUITES

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "graph"), default="lm")
    # lm workload
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the config's reduced variant (default); "
                         "--no-reduced serves the published widths")
    ap.add_argument("--max-len", type=int, default=None,
                    help="decode cache length (default 96, or the "
                         "attention window for the hybrid family, or what "
                         "a vlm's image prefix, prompt and new tokens "
                         "need)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    # graph workload
    ap.add_argument("--graph", default="road-ca", choices=sorted(SUITES))
    ap.add_argument("--kind", choices=("sssp", "bfs", "ppr", "mixed"),
                    default="sssp")
    ap.add_argument("--block-size", type=int, default=None,
                    help="partition size (default: the planner's choice)")
    ap.add_argument("--pump-visits", type=int, default=8,
                    help="megastep chunk size K: visits per serving round")
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenant count for the graph workload (tenant0 hot)")
    # shared
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.workload == "graph":
        return serve_graph(args)
    return serve_lm(args)


if __name__ == "__main__":
    main()
