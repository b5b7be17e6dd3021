"""Landmark labeling (paper application LL, §6.1) on the PyTorch/CUDA
port.

Pre-computes shortest-path labels from a batch of landmark vertices — one
fork-processing pattern of SSSPs — then answers point-to-point distance
queries from the labels.  The SSSP fleet's min-plus contractions run on
the card (``fg_minplus``) unless ``--device cpu`` is given.

    python examples/torch/landmark_labeling.py [--device cpu] \\
        [--graph road-ca]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import oracles  # noqa: E402
from repro_torch.core.applications import landmark_labeling  # noqa: E402
from repro_torch.graphs.generators import SUITES, build_suite  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--graph", default="road-ca", choices=sorted(SUITES))
    ap.add_argument("--landmarks", type=int, default=32)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=256)
    args = ap.parse_args(argv)

    g = build_suite(args.graph)
    rng = np.random.default_rng(1)
    landmarks = rng.choice(g.n, args.landmarks, replace=False)
    labels, res = landmark_labeling(g, landmarks,
                                    block_size=args.block_size,
                                    device=args.device)
    print(f"labeled {len(landmarks)} landmarks on |V|={g.n}: "
          f"{res.stats['visits']} partition visits, "
          f"{res.edges_processed.mean():.0f} edges/landmark")

    # distance estimates are upper bounds that tighten with more landmarks
    us = rng.choice(g.n, args.pairs)
    vs = rng.choice(g.n, args.pairs)
    exact = []
    for u, v in zip(us, vs):
        d, _ = oracles.dijkstra(g, int(u))
        exact.append(d[v])
    est = [float(labels.query(int(u), int(v))) for u, v in zip(us, vs)]
    for (u, v, e, x) in zip(us, vs, est, exact):
        ratio = e / x if np.isfinite(x) and x > 0 else float("nan")
        print(f"  d({u:5d},{v:5d})  exact={x:8.2f}  landmark<={e:8.2f} "
              f"({ratio:4.2f}x)")
        assert e >= x - 1e-5, "landmark bound must be an upper bound"
    print("landmark labeling OK")


if __name__ == "__main__":
    main()
