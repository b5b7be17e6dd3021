#!/usr/bin/env python3
"""Compare the contraction kernels' launch times across source trees, on
one card, in turns.

    python3 scripts/contract_ab.py OLD_TREE NEW_TREE [MORE_TREES ...]

Each argument is the root of a checkout of this repository (for example
one unpacked from ``git archive <commit>``).  The script compiles each
tree's ``src/repro_torch/kernels/csrc/minplus.cu`` into that tree's own
``build/repro_torch/`` (all compiles in parallel), then runs
``chip_smoke.phase_kernels`` (phase 3 of the smoke) of each tree in a
fresh process, in the order given and then reversed (A, B, B, A for two
trees), and prints one line per run: card microseconds per launch of
``fg_minplus`` (B1) and ``fg_masked_matmul`` (B2) at the road density,
S = 1 and batched (S = 5), on fully finite blocks, and the empty launch's
time, each from a CUDA graph of the launches.  Compare two trees only
within one run of this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_BUILD = r'''
import subprocess, sys
sys.path.insert(0, "src")
from repro_torch.kernels import _build
src = _build.CSRC / "minplus.cu"
_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
subprocess.run([_build._nvcc(), *_build._flags(src), "-o",
                str(_build._target(src)), str(src)], check=True,
               capture_output=True)
'''

_RUN = r'''
import contextlib, io, json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke
from repro_torch.kernels.minplus import ops
with contextlib.redirect_stdout(io.StringIO()):
    rows = chip_smoke.phase_kernels(torch, ops, np.random.default_rng(0))
print(json.dumps({name: {"road": r["single"]["ms"],
                         "batched": r["batched"]["ms"],
                         "full": r["single"]["ms_by_density"]["full"],
                         "floor": r["single"]["floor_ms"]}
                  for name, r in rows.items()}))
'''


def main(trees) -> int:
    if len(trees) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in trees]
    with ThreadPoolExecutor(len(trees)) as ex:
        for done in ex.map(lambda t: subprocess.run(
                [sys.executable, "-c", _BUILD], cwd=t), trees):
            if done.returncode:
                return done.returncode
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                             check=True, capture_output=True, text=True)
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        us = {f"{name} {k}": round(1e3 * v, 3)
              for name, r in rows.items() for k, v in r.items()
              if not (name == "masked_matmul" and k == "floor")}
        print(os.path.relpath(tree), json.dumps(us), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
