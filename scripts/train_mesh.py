#!/usr/bin/env python3
"""Run the smoke's training-on-a-mesh phase (8e) alone on one card.

    python3 scripts/train_mesh.py [--layers 12] [--seq 4096] [--steps 2]

Builds the kernels, then runs ``chip_smoke.phase_train_mesh``'s cases on
four gloo ranks sharing the card (``launch/distributed.run_train_cases``:
starcoder2-7b at full width through ``launch/train.run`` on a (2, 2) mesh,
and the reduced config's checks c and d) and holds them to its checks.
By default it runs 8e uncut: 8d's 12 layers, batch 4 x 4096, the
config's 4 microbatches cut to 2 by ``launch/steps.effective_microbatches``
at a data axis of 2, and prints the ``train mesh`` lines (one a rank) and
the checks.  ``--layers 2 --seq 1024`` is the smoke's cut.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import distributed as launcher
    from repro_torch.launch.mesh import spawn
    from repro_torch.launch.steps import effective_microbatches

    if not torch.cuda.is_available():
        print("train_mesh: no CUDA device", file=sys.stderr)
        return 2
    cs.TRAIN_MESH_LAYERS, cs.TRAIN_MESH_SEQ = args.layers, args.seq
    cs.TRAIN_MESH_STEPS = args.steps
    cs.TRAIN_MESH_MICRO = effective_microbatches(
        get_config(cs.LM_ARCH),
        ShapeConfig("t", "train", args.seq, cs.TRAIN_MESH_BATCH),
        dict(zip(("data", "model"), cs.TRAIN_MESH)))
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    cs.log(card)
    cases, ctx = cs.train_mesh_cases(torch)
    t = time.perf_counter()
    both = spawn(launcher.run_mesh_cases, 4, "gloo", args=([], cases, None),
                 timeout_s=600)
    cs.log(f"world: {time.perf_counter() - t:.1f} s "
           f"({args.layers} layers, batch {cs.TRAIN_MESH_BATCH} x "
           f"{args.seq}, {cs.TRAIN_MESH_MICRO} microbatches)")
    t = time.perf_counter()
    cs.phase_train_mesh(torch, [tr for _, tr in both], ctx, card)
    cs.log(f"phase 8e checks: {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
