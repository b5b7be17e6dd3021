"""Network community profile (paper application NCP, §6.1) on the
PyTorch/CUDA port.

Runs a fleet of personalized PageRanks from random seeds (the paper seeds
0.01% of vertices; tens of thousands at LiveJournal scale) through the
session front door, sweeps each PPR vector for its best conductance cut,
and reports min conductance per cluster-size bin — the NCP curve.  The
push rounds' contractions run on the card (``fg_masked_matmul``) unless
``--device cpu`` is given.

    python examples/torch/ncp.py [--device cpu] [--graph social-lj]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.graphs.generators import SUITES, build_suite  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--graph", default="social-lj", choices=sorted(SUITES))
    ap.add_argument("--block-size", type=int, default=256)
    args = ap.parse_args(argv)

    g = build_suite(args.graph)
    rng = np.random.default_rng(2)
    n_seeds = max(8, g.n // 10_000)      # paper: 0.01% of |V|, min 8 here
    seeds = rng.choice(g.n, n_seeds, replace=False)
    sess = FPPSession(g, device=args.device).plan(
        num_queries=n_seeds, block_size=args.block_size)
    profile, res = sess.ncp(seeds, eps=1e-3)
    print(f"NCP on |V|={g.n} |E|={g.m} with {n_seeds} PPR seeds: "
          f"{res.stats['visits']} partition visits, "
          f"{res.edges_processed.sum():.0f} edges total")
    print("cluster-size bin -> best conductance:")
    for b, c in enumerate(profile):
        if np.isfinite(c):
            print(f"  2^{b:<2d} .. {2 ** (b + 1) - 1:>6}: {c:.4f}")
    assert np.isfinite(profile).any(), "no finite conductance found"
    print("NCP OK")


if __name__ == "__main__":
    main()
