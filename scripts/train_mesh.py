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

``--whole-carry`` also runs the full-width case a second time in the same
world, after the others, under ``rules_for(..., overrides={"act_seq":
None})`` (every layer-boundary carry whole, where ``"act_seq"`` keeps the
rank's S / 2 sequence rows of it), prints its ``train mesh`` lines and
fails unless its loss and grad-norm bits and every rank's state digests
equal the first run's.  Both runs' peak GB a rank (allocated and
reserved) and step walls are in their lines.

The four ranks share one card, so what each rank's caching allocator
holds beyond its live tensors adds up on it: the script runs them with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` (unless the variable
is set).  With the default allocator the 12-layer run under
``"act_seq"`` runs out of an 80 GB card, though its allocated peak is
below the whole carry's, which fits.
"""
from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--whole-carry", action="store_true")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    if args.whole_carry:
        cases.append({**cases[0], "overrides": cs.TRAIN_MESH_WHOLE_CARRY})
    t = time.perf_counter()
    both = spawn(launcher.run_mesh_cases, 4, "gloo", args=([], cases, None),
                 timeout_s=900)
    cs.log(f"world: {time.perf_counter() - t:.1f} s "
           f"({args.layers} layers, batch {cs.TRAIN_MESH_BATCH} x "
           f"{args.seq}, {cs.TRAIN_MESH_MICRO} microbatches)")
    ranks = [tr for _, tr in both]
    whole = [r.pop() for r in ranks] if args.whole_carry else None
    t = time.perf_counter()
    cs.phase_train_mesh(torch, ranks, ctx, card)
    cs.log(f"phase 8e checks: {time.perf_counter() - t:.1f} s")
    if whole:
        _check_whole_carry(cs, [r[0] for r in ranks], whole, card)
    return 0


def _check_whole_carry(cs, full: list, whole: list, card: str) -> None:
    """The full-width case with the carry whole against the default
    run (``"act_seq"``): the same loss and grad-norm bits and state
    digests on every rank; one ``train mesh whole carry`` line a rank."""
    tokens = cs.TRAIN_MESH_BATCH * cs.TRAIN_MESH_SEQ
    for i, (a, b) in enumerate(zip(full, whole)):
        line = {"rank": i, "card": card, "layers": cs.TRAIN_MESH_LAYERS,
                "step_s": b["step_s"],
                "tokens_per_s": [tokens / t for t in b["step_s"]],
                "collectives_per_step": b["calls"],
                "collective_s_per_step": b["collective_s"],
                "peak_gb": (b["peak_mem_bytes"] or 0) / 1e9,
                "act_seq_peak_gb": (a["peak_mem_bytes"] or 0) / 1e9,
                "peak_reserved_gb": (b["peak_reserved_bytes"] or 0) / 1e9,
                "act_seq_peak_reserved_gb": (a["peak_reserved_bytes"] or 0)
                / 1e9,
                "act_seq_step_s": a["step_s"],
                "carry": b["carries"][0], "act_seq_carry": a["carries"][0]}
        cs.log("train mesh whole carry: " + json.dumps(line))
        if a["bits"] != b["bits"] or a["digests"] != b["digests"]:
            raise AssertionError(f"rank {i}: the whole carry's run differs "
                                 f"from the act_seq run's")
    cs.log("train mesh whole carry: bit for bit equal on every rank")


if __name__ == "__main__":
    sys.exit(main())
