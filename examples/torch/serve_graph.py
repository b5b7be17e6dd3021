"""Multi-tenant graph serving on the PyTorch/CUDA port: mixed sssp/ppr
traffic through GraphServer.

The serving twin of examples/torch/quickstart.py: two tenants — one hot,
one light — submit a mixed stream of SSSP and PPR requests against two
registered graphs, and the server multiplexes them onto per-(graph, kind)
lane pools with weighted-fair admission at megastep chunk boundaries.
Shown both ways: the continuous engine (start / submit / result /
shutdown, the production path) and the synchronous pump (serve(), the
scripting path) — plus both reuse tiers: a warm repeat of an
already-answered source hits the result cache (cached=True, zero billed
work), while twin in-flight requests on a fresh source coalesce onto one
lane (coalesced=True).  The lanes' contractions run on the card
(``fg_minplus``, ``fg_masked_matmul``: the server's default
``fused="auto"`` dispatch) unless ``--device cpu`` is given.

    python examples/torch/serve_graph.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.graphs.generators import grid2d, rmat  # noqa: E402
from repro_torch.serve import GraphRequest, GraphServer  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--road-side", type=int, default=24)
    ap.add_argument("--social-scale", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=64)
    args = ap.parse_args(argv)

    road = grid2d(args.road_side, args.road_side, seed=0)  # road-like grid
    social = rmat(args.social_scale, 6, seed=1)  # power-law social graph
    rng = np.random.default_rng(0)

    server = GraphServer(capacity=4, k_visits=16, device=args.device)
    server.register_graph("road", road, num_queries=4,
                          block_size=args.block_size)
    server.register_graph("social", social, num_queries=4,
                          block_size=args.block_size)
    # the hot tenant offers most of the load; equal weights mean fair
    # admission alone keeps the light tenant's queue wait bounded
    server.register_tenant("hot", weight=1.0)
    server.register_tenant("light", weight=1.0)

    road_src = rng.choice(np.flatnonzero(road.out_degree() > 0), 12)
    soc_src = rng.choice(np.flatnonzero(social.out_degree() > 0), 4)
    for s in road_src:
        server.submit(GraphRequest(kind="sssp", source=int(s), graph="road",
                                   tenant="hot"))
    for i, s in enumerate(soc_src):
        server.submit(GraphRequest(kind="ppr", source=int(s), graph="social",
                                   tenant="light",
                                   priority=-1.0 if i == 0 else 0.0))

    out = server.serve()                 # synchronous pump until drained
    ok = [r for r in out.values() if r.status == "ok"]
    assert len(ok) == len(out)
    print(f"served {len(ok)}/{len(out)} requests in {server.rounds} rounds")
    for tenant in ("hot", "light"):
        rs = [r for r in ok if r.tenant == tenant]
        wait = np.array([r.stats["queue_wait_rounds"] for r in rs])
        lat = np.array([r.stats["latency_s"] for r in rs]) * 1e3
        print(f"  {tenant:5s}: {len(rs):2d} ok | queue-wait rounds "
              f"p50/p99 {np.percentile(wait, 50):.0f}/"
              f"{np.percentile(wait, 99):.0f} | latency p50/p99 "
              f"{np.percentile(lat, 50):.1f}/{np.percentile(lat, 99):.1f} ms")
    # per-request accounting is exact: integral edge work, billed host syncs
    r = next(iter(ok))
    print(f"  e.g. rid={r.rid} kind={r.kind} graph={r.graph}: "
          f"visits={r.stats['visits']} edges={r.stats['edges']:.0f} "
          f"host_syncs={r.stats['host_syncs']}")

    # --- the continuous engine: same server, background lanes -----------
    # submit() returns immediately from any thread; result() blocks until
    # the delivery lane hands the response over.
    server.start()
    try:
        # a warm repeat: road_src[0] was already answered above, so this
        # hit comes from the result cache — same bits, zero billed work,
        # no lane
        s = int(road_src[0])
        cold = next(r for r in ok if r.kind == "sssp" and r.source == s)
        warm = server.result(server.submit(GraphRequest(
            kind="sssp", source=s, graph="road", tenant="light")),
            timeout=60)
        np.testing.assert_array_equal(warm.values, cold.values)
        print(f"continuous: rid={warm.rid} cached="
              f"{bool(warm.stats.get('cached'))} visits billed="
              f"{warm.stats['visits']} latency="
              f"{warm.stats['latency_s'] * 1e3:.1f} ms")

        # twin *in-flight* requests on a never-served source instead
        # coalesce onto one lane (the follower's response carries
        # coalesced=True)
        fresh = int(np.setdiff1d(np.flatnonzero(road.out_degree() > 0),
                                 road_src)[0])
        r1 = server.submit(GraphRequest(kind="sssp", source=fresh,
                                        graph="road", tenant="hot"))
        r2 = server.submit(GraphRequest(kind="sssp", source=fresh,
                                        graph="road", tenant="light"))
        a, b = server.result(r1, timeout=60), server.result(r2, timeout=60)
        np.testing.assert_array_equal(a.values, b.values)
        print(f"continuous: rid={b.rid} "
              f"coalesced={bool(b.stats.get('coalesced'))} "
              f"latency={b.stats['latency_s'] * 1e3:.1f} ms")
        st = server.stats()
        print(f"reuse: cache_hits={st['cache_hits']} "
              f"coalesced={st['coalesced']} "
              f"cache_bytes={st['cache_bytes']}")
    finally:
        server.shutdown()
    print("serve_graph OK")


if __name__ == "__main__":
    main()
