#!/usr/bin/env python3
"""Compare one LM serving path across source trees, on one card, in turns.

    python3 scripts/lm_ab.py OLD_TREE NEW_TREE [--arch starcoder2-7b]

Each tree is the root of a checkout of this repository (for example one
unpacked from ``git archive <commit>`` into a git-ignored directory such
as ``build/``).  The script runs ``chip_smoke.phase_lm`` (phase 7 of the
smoke: the model at full width and depth through ``ContinuousBatcher``,
then its decode profile and checks) of each tree in a fresh process, in
the order given and then reversed (A, B, B, A for two trees), each tree's
kernels built into its own ``build/repro_torch/``, and prints each run's
``lm run`` and ``lm decode profile`` lines.  Decode is paced by the host,
so its wall varies from run to run; compare two trees only within one run
of this script.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

_RUN = ("import sys, torch; sys.path.insert(0, '.'); sys.path.insert(0, "
        "'src'); import chip_smoke as cs; from repro_torch.kernels import "
        "_build; _build.build_all(); cs.phase_lm(torch, cs.Counters(), "
        "{arch!r})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--arch", default="starcoder2-7b")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, "-c", _RUN.format(
            arch=args.arch)], cwd=tree, capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith(("lm run", "lm decode profile")):
                print(f"{tree}: {line}", flush=True)
        if out.returncode:
            print(f"{tree}: failed\n{out.stderr[-4000:]}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
