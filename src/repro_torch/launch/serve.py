"""End-to-end serving driver: continuous batching over batched requests.

The port of the JAX package's ``repro.launch.serve`` for the ``lm``
workload: token serving through ``ContinuousBatcher``, on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
        --no-reduced --requests 8 --batch 4 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \\
        --device cpu --requests 4 --batch 2 --max-new 4

``--reduced`` (the default) serves the config's CPU-test variant;
``--no-reduced`` the published widths.  The ``graph`` workload waits for
the graph server (ROADMAP A11).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serve_lm(args):
    """Serve ``args.requests`` random prompts; returns ``{rid: tokens}``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import ContinuousBatcher, Request

    dev = resolve_device(getattr(args, "device", None))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(args.seed)

    batcher = ContinuousBatcher(model, params, batch_size=args.batch,
                                max_len=args.max_len, device=dev)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              rng.integers(4, 12)).astype(np.int32)
        batcher.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=args.max_new))
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "graph"), default="lm")
    # lm workload
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the config's reduced variant (default); "
                         "--no-reduced serves the published widths")
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    # shared
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.workload == "graph":
        raise NotImplementedError("the graph workload waits for the port of "
                                  "the graph server (ROADMAP A11)")
    return serve_lm(args)


if __name__ == "__main__":
    main()
