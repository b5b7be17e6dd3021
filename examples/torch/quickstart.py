"""Quickstart on the PyTorch/CUDA port: fork-processing on a graph.

Builds a weighted road-like graph and runs a *fork-processing pattern* —
many independent SSSP + PPR queries from random sources — through the
unified session front door (``FPPSession``: plan → execute → stream),
validating against sequential oracles.  The engine's contractions run on
the card (``fg_minplus`` for sssp, ``fg_masked_matmul`` for ppr) unless
``--device cpu`` is given.

    python examples/torch/quickstart.py [--device cpu] [--side 64]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import oracles  # noqa: E402
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.graphs.generators import grid2d  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--side", type=int, default=64)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=256)
    args = ap.parse_args(argv)
    nq = args.queries

    # 1. a weighted graph (64x64 road grid, ~4k vertices)
    g = grid2d(args.side, args.side, seed=0)
    print(f"graph: |V|={g.n} |E|={g.m}")

    # 2. one session owns the whole pattern: the planner sizes the
    #    partition and the session hides the vertex reordering — original
    #    ids in AND out
    sess = FPPSession(g, device=args.device).plan(
        num_queries=nq, block_size=args.block_size)
    plan = sess.current_plan
    print(f"plan: B={plan.block_size} method={plan.method} "
          f"schedule={plan.schedule} "
          f"working_set={plan.working_set_bytes() / 1e6:.1f} MB")

    # 3. fork independent SSSPs (one FPP)
    rng = np.random.default_rng(0)
    sources = rng.choice(g.n, nq, replace=False)
    res = sess.run("sssp", sources)
    print(f"SSSP fleet: {res.stats['visits']} partition visits, "
          f"{res.edges_processed.mean():.0f} edges/query, "
          f"{res.stats['modeled_bytes'] / 1e6:.1f} MB modeled traffic")

    # 4. exactness vs Dijkstra (values already in original vertex ids)
    for qi in sorted({0, nq // 2 - 1, nq - 1}):
        want, _ = oracles.dijkstra(g, int(sources[qi]))
        got = res.values[qi]
        assert np.allclose(np.where(np.isfinite(got), got, -1),
                           np.where(np.isfinite(want), want, -1)), qi
    print("SSSP results match Dijkstra exactly")

    # 5. the same queries through the global-frontier baseline — one word,
    #    same result contract (the paper's comparison system)
    base = sess.run("sssp", sources, backend="baselines")
    print(f"baseline traffic {base.stats['modeled_bytes'] / 1e6:.1f} MB vs "
          f"ForkGraph {res.stats['modeled_bytes'] / 1e6:.1f} MB "
          f"({base.stats['modeled_bytes'] / res.stats['modeled_bytes']:.1f}x"
          " reduction)")

    # 6. fork PPRs (the NCP workload)
    resp = sess.run("ppr", sources, eps=1e-4)
    p0 = resp.values[0]
    want_p, want_r, _ = oracles.ppr_push(g, int(sources[0]), eps=1e-4)
    print(f"PPR fleet: {resp.stats['visits']} visits; "
          f"query0 |support|={np.sum(p0 > 0)}, "
          f"max|p - oracle| = {np.max(np.abs(p0 - want_p)):.2e} "
          "(both are eps-approximations)")

    # 7. queries that arrive over time: stream them into the same engine
    half = nq // 2
    stream = sess.stream("sssp", capacity=half)
    first = stream.submit(sources[:half])
    stream.pump(20)                       # work begins before batch 2 exists
    second = stream.submit(sources[half:])
    answers = stream.run()
    for i, qid in enumerate(first + second):
        assert np.array_equal(answers[qid], res.values[i]), qid
    print(f"streaming: staggered arrivals match one-shot exactly "
          f"({stream.visits} visits)")
    print("quickstart OK")


if __name__ == "__main__":
    main()
