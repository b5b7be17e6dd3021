#!/usr/bin/env python3
"""Run the smoke's LM-on-a-mesh phase alone on one card.

    python3 scripts/lm_mesh.py [--prompts 512,1000,2048,8192] [--new 8]

Builds the kernels, runs ``chip_smoke.phase_lm`` for starcoder2-7b (phase 7:
the one-card run that phase 7e's checks are held to) and then
``chip_smoke.phase_lm_mesh`` (phase 7e: four gloo ranks sharing the card),
with the served prompts and new tokens given (default: the smoke's
``MESH_PROMPTS`` and ``MESH_NEW``), and prints the ``lm mesh run`` line.  ``scripts/gloo_collectives.py``
times gloo's collectives among four ranks on the card on its own.
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
    ap.add_argument("--prompts", default=None,
                    help="comma-separated prompt lengths of phase 7's")
    ap.add_argument("--new", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    if args.prompts:
        cs.MESH_PROMPTS = tuple(int(x) for x in args.prompts.split(","))
    if args.new:
        cs.MESH_NEW = args.new
    from repro_torch.kernels import _build
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    cs.log(card)
    lm = cs.phase_lm(torch, cs.Counters())
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cs.phase_lm_mesh(torch, lm["mesh_ref"], card)
    cs.log(f"phase 7e: {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
