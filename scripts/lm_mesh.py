#!/usr/bin/env python3
"""Run the smoke's LM-on-a-mesh phase alone on one card.

    python3 scripts/lm_mesh.py [--layers 32] [--prompts 512,1000,2048,8192] \\
        [--new 8]
    python3 scripts/lm_mesh.py --arch qwen3-moe-30b-a3b [--layers 24] \\
        [--prompts ...] [--new 32]
    python3 scripts/lm_mesh.py --arch recurrentgemma-2b|falcon-mamba-7b \\
        [--layers 26] [--prompts ...] [--new 32] [--full-attention]

Builds the kernels, then for starcoder2-7b (the default) runs
``chip_smoke.phase_lm`` (phase 7: the one-card run that phase 7e's checks
are held to) and ``chip_smoke.phase_lm_mesh`` (phase 7e: four gloo ranks
sharing the card, the model cut to ``--layers``, default the smoke's
``MESH_LAYERS``, and held to one card's run of that cut), with the served
prompts and new tokens given (default: the smoke's ``MESH_PROMPTS`` and
``MESH_NEW``), and prints the ``lm mesh run`` line.  With ``--arch qwen3-moe-30b-a3b`` it runs phase 7f alone
instead: the model at full width cut to ``--layers`` layers (default the
smoke's ``MOE_MESH_LAYERS``) on one card (``chip_smoke.moe_mesh_reference``),
then on four gloo ranks, expert parallel over "model"
(``chip_smoke.moe_mesh_cases`` and ``phase_lm_moe_mesh``), serving the
prompts given (default ``MOE_MESH_PROMPTS``, ``MOE_MESH_NEW``).  With
``--arch recurrentgemma-2b`` or ``falcon-mamba-7b`` it runs phase 7g for
that model alone: cut to ``--layers`` (default the smoke's
``RECURRENT_MESH_LAYERS``; the float32 checks stay at that cut) on one card
(``chip_smoke.recurrent_mesh_reference``), then on four gloo ranks,
channel parallel over "model" (``chip_smoke.recurrent_mesh_cases`` and
``phase_lm_recurrent_mesh``), serving the prompts given (default
``MESH_PROMPTS``, ``MESH_NEW``); its ``lm mesh run`` line gives each
attention block's layout (``"seq"``: each rank every head on its quarter
of the query rows) and each prompt's prefill collectives, and
``--full-attention`` runs every attention block ``"full"`` instead (the
A/B of the ``"seq"`` policy, in separate runs).
``scripts/gloo_collectives.py`` times gloo's collectives among four ranks
on the card on its own.
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
    ap.add_argument("--arch", default="starcoder2-7b",
                    choices=("starcoder2-7b", "qwen3-moe-30b-a3b",
                             "recurrentgemma-2b", "falcon-mamba-7b"))
    ap.add_argument("--layers", type=int, default=None,
                    help="the depth cut of starcoder2-7b (of 32), "
                         "qwen3-moe-30b-a3b (of 48), recurrentgemma-2b (of "
                         "26) or falcon-mamba-7b (of 64)")
    ap.add_argument("--prompts", default=None,
                    help="comma-separated prompt lengths of phase 7's")
    ap.add_argument("--new", type=int, default=None)
    ap.add_argument("--full-attention", action="store_true",
                    help="recurrentgemma-2b with every attention block "
                         "computed whole on every rank (rules_for(..., "
                         "overrides={'seq': None})), against the default "
                         "\"seq\" policy")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    cs.log(card)
    prompts = (tuple(int(x) for x in args.prompts.split(","))
               if args.prompts else None)
    if args.arch in cs.LM_RECURRENT:
        from repro_torch.launch import distributed as launcher
        from repro_torch.launch.mesh import spawn

        t = time.perf_counter()
        ref = cs.recurrent_mesh_reference(
            torch, args.layers or cs.RECURRENT_MESH_LAYERS, (args.arch,))
        cs.log(f"phase 7g one-card reference: {time.perf_counter() - t:.1f} s")
        cases, ctx = cs.recurrent_mesh_cases(
            torch, ref, prompts or cs.MESH_PROMPTS, args.new or cs.MESH_NEW,
            cs.RECURRENT_MESH_FULL if args.full_attention else None)
        t = time.perf_counter()
        ranks = spawn(launcher.run_lm_cases, cs.MESH_WORLD, "gloo",
                      args=(cases, None), timeout_s=600)
        cs.log(f"phase 7g world: {time.perf_counter() - t:.1f} s")
        cs.phase_lm_recurrent_mesh(torch, ranks, ctx, card)
        return 0
    if args.arch == cs.MOE_ARCH:
        from repro_torch.launch import distributed as launcher
        from repro_torch.launch.mesh import spawn

        t = time.perf_counter()
        ref = cs.moe_mesh_reference(torch, args.layers or cs.MOE_MESH_LAYERS)
        cs.log(f"phase 7f one-card reference: {time.perf_counter() - t:.1f} s")
        cases, ctx = cs.moe_mesh_cases(torch, ref,
                                       prompts or cs.MOE_MESH_PROMPTS,
                                       args.new or cs.MOE_MESH_NEW)
        t = time.perf_counter()
        ranks = spawn(launcher.run_lm_cases, cs.MESH_WORLD, "gloo",
                      args=(cases, None), timeout_s=600)
        cs.log(f"phase 7f world: {time.perf_counter() - t:.1f} s")
        cs.phase_lm_moe_mesh(torch, ranks, ctx, card)
        return 0
    if args.layers:
        cs.MESH_LAYERS = args.layers
    if prompts:
        cs.MESH_PROMPTS = prompts
    if args.new:
        cs.MESH_NEW = args.new
    lm = cs.phase_lm(torch, cs.Counters())
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cs.phase_lm_mesh(torch, lm["mesh_ref"], card)
    cs.log(f"phase 7e: {time.perf_counter() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
