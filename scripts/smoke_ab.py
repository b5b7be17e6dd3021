#!/usr/bin/env python3
"""Compare B6's times and the LM-on-a-mesh decode step across source trees,
on one card, in turns.

    python3 scripts/smoke_ab.py OLD_TREE NEW_TREE [--calls 2000]

Each tree is the root of a checkout of this repository (for example one
unpacked from ``git archive <commit>`` into a git-ignored directory such
as ``build/``).  The script first builds every tree's kernels into its own
``build/repro_torch/`` (all trees at once), then runs each tree in a
fresh process, in the order given and then reversed (A, B, B, A for two
trees):

  * ``chip_smoke.phase_flash`` (phase 6 of the smoke): every model's B6
    card milliseconds, bf16 and float32, at its timed shape;
  * the host's microseconds a B6 call, no gradient, from ``--calls``
    calls of ``kernels/flash_attention/ops.flash_attention`` at a shape
    whose kernel takes less than the host does (one query row of one
    head, 64 keys), timed between two synchronizations: the wrapper's
    dispatch and launch cost;
  * ``chip_smoke.phase_lm`` and ``phase_lm_mesh`` (phases 7 and 7e:
    starcoder2-7b served at full width on one card, then cut to the
    smoke's ``MESH_LAYERS`` on four gloo ranks sharing the card): each
    rank's prefill seconds and seconds a decode step, and its collectives
    a decode step.

Each run prints one ``ab`` JSON line; the card's name and power limit
come first.  Every run's whole output goes to ``chiprun_out/smoke_ab/``.
Decode on the mesh is paced by the host and gloo: compare two trees only
within one run of this script.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BUILD = ("import sys; sys.path.insert(0, 'src'); "
          "from repro_torch.kernels import _build; _build.build_all()")

_RUN = r'''
import json, subprocess, sys, time
sys.path.insert(0, "."); sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as faops
_build.build_all()
flash = cs.phase_flash(torch)
b6 = {"starcoder2-7b": {"bf16_ms": flash["ms"],
                        "f32_ms": flash["f32"]["ms"]}}
for key in cs.FLASH_ROW_KEYS:
    b6[flash[key]["arch"]] = {"bf16_ms": flash[key]["ms"],
                              "f32_ms": flash[key]["f32"]["ms"]}
dev = torch.device("cuda")
q = torch.randn(1, 1, 1, 64, device=dev, dtype=torch.bfloat16)
k = torch.randn(1, 64, 1, 64, device=dev, dtype=torch.bfloat16)
v = torch.randn(1, 64, 1, 64, device=dev, dtype=torch.bfloat16)
host_us = []
with torch.inference_mode():
    for _ in range(3):
        for _ in range(100):
            faops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CALLS):
            faops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        host_us.append(1e6 * (time.perf_counter() - t) / CALLS)
lm = cs.phase_lm(torch, cs.Counters())
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
mesh = cs.phase_lm_mesh(torch, lm["mesh_ref"], card)
ranks = [{"rank": r["rank"], "prefill_s": r["prefill_s"],
          "decode_step_s": r["decode_s"] / max(r["decode_steps"], 1),
          "decode_steps": r["decode_steps"],
          "collectives_per_decode_step": r["collectives_per_decode_step"]}
         for r in mesh["ranks"]]
print("ab " + json.dumps({"b6": b6, "b6_host_us_a_call": host_us,
                          "mesh_layers": mesh["layers"],
                          "mesh_world_s": mesh["world_s"],
                          "mesh_ranks": ranks}), flush=True)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    out_dir = os.path.join(ROOT, "chiprun_out", "smoke_ab")
    os.makedirs(out_dir, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    def build(tree):
        return tree, subprocess.run([sys.executable, "-c", _BUILD], cwd=tree,
                                    capture_output=True, text=True)

    with ThreadPoolExecutor(len(trees)) as pool:
        for tree, out in pool.map(build, trees):
            if out.returncode:
                print(f"{tree}: build failed\n{out.stderr[-4000:]}")
                return 1
    for i, tree in enumerate(trees + trees[::-1]):
        code = _RUN.replace("CALLS", str(args.calls))
        out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        with open(os.path.join(out_dir, f"run{i}.log"), "w") as f:
            f.write(f"{tree}\n{out.stdout}\n{out.stderr}")
        for line in out.stdout.splitlines():
            if line.startswith("ab "):
                print(f"{tree}: {line}", flush=True)
        if out.returncode:
            print(f"{tree}: failed\n{out.stderr[-4000:]}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
