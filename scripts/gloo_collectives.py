#!/usr/bin/env python3
"""Time gloo's collectives among four ranks that share one card.

    python3 scripts/gloo_collectives.py [--world 4]

Spawns a world of ``--world`` gloo ranks (``launch/mesh.spawn``) on a
``(1, world)`` mesh and times, on CUDA tensors and on CPU tensors, the
collectives the LM on a mesh makes: a decode step's float32 sum of
``[4, 4608]`` (starcoder2-7b's d_model at batch 4), also as an all-gather
summed on each rank, its bf16 all-gather of ``[4, 1, 1280]`` (the q, k, v
of a rank), and a prefill chunk's float32 sum of ``[4096, 4608]`` (75 MB).
Prints each one's ms per call on every rank.  Without a card it times the
CPU tensors only.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("sum [4, 4608] f32", (4, 4608), "float32", "sum", 100),
         ("sum [4, 4608] f32 as gather", (4, 4608), "float32", "gather_sum",
          100),
         ("gather [4, 1, 1280] bf16", (4, 1, 1280), "bfloat16", "gather",
          100),
         ("sum [4096, 4608] f32", (4096, 4608), "float32", "sum", 4))


def _bench(rank: int, world: int) -> dict:
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, world)
    ops = {"sum": lambda x: mesh.all_reduce_sum(x, "model"),
           "gather": lambda x: mesh.all_gather(x, "model"),
           "gather_sum": lambda x: mesh.all_gather(x, "model").sum(0)}
    out = {}
    for devname in (("cuda", "cpu") if torch.cuda.is_available()
                    else ("cpu",)):
        dev = torch.device(devname)
        for name, shape, dtype, op, n in CASES:
            x = torch.randn(shape, device=dev).to(getattr(torch, dtype))
            ops[op](x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                ops[op](x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[f"{devname} {name}"] = 1e3 * (time.perf_counter() - t) / n
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import spawn
    res = spawn(_bench, args.world, "gloo", args=(args.world,),
                timeout_s=120)
    for key in res[0]:
        print(f"gloo {key}: " + " ".join(f"{r[key]:.3f}" for r in res)
              + " ms a call, by rank", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
