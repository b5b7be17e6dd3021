"""Approximate betweenness centrality (paper application BC, §6.1) on the
PyTorch/CUDA port.

BFS-fleet from sampled roots (Eppstein-style approximation; the paper
samples 100 roots) + the Brandes accumulation.  The BFS fleet's min-plus
contractions run on the card (``fg_minplus``) unless ``--device cpu`` is
given.

    python examples/torch/betweenness.py [--device cpu] [--graph web-wk]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.applications import betweenness_centrality  # noqa
from repro_torch.graphs.generators import SUITES, build_suite  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--graph", default="web-wk", choices=sorted(SUITES))
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=256)
    args = ap.parse_args(argv)

    g = build_suite(args.graph)
    rng = np.random.default_rng(3)
    roots = rng.choice(g.n, args.roots, replace=False)
    bc, res = betweenness_centrality(g, roots, block_size=args.block_size,
                                     device=args.device)
    top = np.argsort(-bc)[:10]
    print(f"BC on |V|={g.n} with {len(roots)} sampled roots "
          f"({res.stats['visits']} partition visits)")
    print("top-10 central vertices:")
    for v in top:
        print(f"  v={v:6d}  bc={bc[v]:10.2f}")
    assert bc.max() > 0
    print("betweenness OK")


if __name__ == "__main__":
    main()
