"""GraphServer of the port against its own session runs and against the JAX
package's GraphServer, on the CPU.

What serving must never change: answers.  A request served through lane
pools, weighted-fair admission and chunked megasteps returns the values of
``FPPSession.run`` of the same query, bit for bit, for every kind (ppr
too when its lanes are co-resident as in the one-shot run).  What serving
adds, pinned here as in the reference's tests: a hot tenant cannot starve
another; deadline-expired requests get an explicit response; two graphs
serve interleaved traffic with no state bleed; request priorities reach
pool arbitration (``prefer_older_ties``); submitters on other threads get
the same answers; identical in-flight requests coalesce and are each
billed; warm engine bundles are reused across pow2 resizes and servers,
and a pool built from one builds no ``DeviceGraph``; a lane's exception
reaches the caller.

The differential tests drive one scripted arrival stream, under an
injected clock, through the reference's server and the port's on the same
graph and plan, and compare every response: status, values and residual
(bitwise but ppr, which is held at the masked-matmul tolerance, ROADMAP
C2), the billed visits, edges and host syncs, queue waits, latencies, the
coalesced/fanout/cached marks, and the server's rounds.
"""
import functools
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.scheduler import PartitionScheduler as JScheduler  # noqa
from repro.fpp import planner as jplanner  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.serve import GraphRequest as JRequest  # noqa: E402
from repro.serve import GraphServer as JServer  # noqa: E402
from repro_torch.core import engine as _engine  # noqa: E402
from repro_torch.core.scheduler import PartitionScheduler  # noqa: E402
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.fpp import planner  # noqa: E402
from repro_torch.fpp.planner import (FUSED_DMAX_BUDGET,  # noqa: E402
                                     MemoryModel, auto_fused,
                                     autoscale_capacity, pow2_bucket)
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.graphs.generators import grid2d, rmat  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import (GraphRequest, GraphServer,  # noqa: E402
                               MegastepCache, build_warm_megastep)

#: ppr against the reference: the masked-matmul tolerance (ROADMAP C2)
PPR_TOL = dict(rtol=1e-5, atol=2e-6)
KINDS = ("sssp", "bfs", "ppr", "cc", "kreach", "rw")

Server = functools.partial(GraphServer, device="cpu")


def _sources(g, k, seed=0):
    cand = np.flatnonzero(g.out_degree() > 0)
    return np.random.default_rng(seed).choice(cand, size=k, replace=False)


def _session(g, q, b, **kw):
    return FPPSession(g, device="cpu").plan(num_queries=q, block_size=b,
                                            **kw)


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("kind,fused", [(k, f) for k in KINDS
                                        for f in (False, True)
                                        if not (k == "rw" and f)])
def test_served_results_bit_identical_to_session_run(kind, fused):
    g = grid2d(12, 12, seed=3)
    srcs = _sources(g, 4, seed=1)
    sess = _session(g, len(srcs), 32)
    one = sess.run(kind, srcs, fused=fused)
    # registering the session itself guarantees the served plan is the
    # same plan the one-shot run used
    server = Server(capacity=len(srcs), k_visits=16, fused=fused)
    server.register_graph("g", sess)
    rids = [server.submit(GraphRequest(kind=kind, source=int(s), graph="g"))
            for s in srcs]
    server.serve()
    for i, rid in enumerate(rids):
        r = server.poll(rid)
        assert r is not None and r.status == "ok"
        np.testing.assert_array_equal(r.values, one.values[i], err_msg=kind)
        if one.residual is not None:
            np.testing.assert_array_equal(r.residual, one.residual[i])
        # per-request stats: exact integral edge work, billed host syncs
        assert r.stats["edges"] == round(r.stats["edges"])
        assert r.stats["edges"] == one.edges_processed[i]
        assert r.stats["host_syncs"] >= 1
        assert r.stats["visits"] >= 1


def test_mixed_two_tenant_two_graph_workload_end_to_end():
    """Mixed sssp+ppr, two tenants, two graphs, interleaved submissions:
    every request answered with its stats, every answer bit-identical to
    the session run."""
    road = grid2d(10, 10, seed=6)
    social = rmat(7, 4, seed=7)
    road_s = _sources(road, 3, seed=2)
    soc_s = _sources(social, 3, seed=3)
    sess = {"road": _session(road, 3, 32), "social": _session(social, 3, 32)}
    want = {("road", "sssp"): sess["road"].run("sssp", road_s),
            ("social", "ppr"): sess["social"].run("ppr", soc_s)}
    server = Server(capacity=3, k_visits=16)
    server.register_graph("road", sess["road"])
    server.register_graph("social", sess["social"])
    rids = []
    for i in range(3):      # interleave graphs, kinds, and tenants
        rids.append((("road", "sssp"), i, server.submit(GraphRequest(
            kind="sssp", source=int(road_s[i]), graph="road",
            tenant="alice" if i % 2 else "bob"))))
        rids.append((("social", "ppr"), i, server.submit(GraphRequest(
            kind="ppr", source=int(soc_s[i]), graph="social",
            tenant="bob" if i % 2 else "alice"))))
    out = server.serve()
    assert len(out) == len(rids)        # nothing dropped, nothing extra
    for key, i, rid in rids:
        r = out[rid]
        assert r.status == "ok"
        np.testing.assert_array_equal(r.values, want[key].values[i])
        for stat in ("visits", "edges", "host_syncs", "queue_wait_s",
                     "queue_wait_rounds", "latency_s"):
            assert stat in r.stats, (key, stat)


# --------------------------------------------------------------- fairness


def test_hot_tenant_cannot_starve_cold_tenant():
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 10, seed=5)
    # dedup=False: the hot tenant reuses sources, and coalescing them
    # would dissolve the very backlog this test measures
    server = Server(capacity=2, k_visits=16, autoscaler=None, dedup=False)
    server.register_graph("g", g, num_queries=2, block_size=16)
    hot = [server.submit(GraphRequest(kind="sssp", source=int(srcs[i % 10]),
                                      graph="g", tenant="hot"))
           for i in range(20)]
    cold = [server.submit(GraphRequest(kind="sssp", source=int(s),
                                       graph="g", tenant="cold"))
            for s in srcs[:2]]
    out = server.serve()
    assert all(out[r].status == "ok" for r in hot + cold)
    cold_wait = max(out[r].stats["queue_wait_rounds"] for r in cold)
    hot_wait = max(out[r].stats["queue_wait_rounds"] for r in hot)
    assert cold_wait <= 4, (cold_wait, hot_wait)
    assert hot_wait > cold_wait


def test_late_joining_tenant_neither_starved_nor_monopolist():
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 10, seed=15)
    # result cache off: a cache hit would skip admission entirely
    server = Server(capacity=1, k_visits=16, autoscaler=None,
                    result_cache=False)
    server.register_graph("g", g, num_queries=1, block_size=16)
    hot = [server.submit(GraphRequest(kind="sssp", source=int(srcs[i % 10]),
                                      graph="g", tenant="hot"))
           for i in range(8)]
    while len(server.responses) < 4:     # hot accrues vtime mid-serve
        assert server.step()
    join_round = server.rounds
    cold = [server.submit(GraphRequest(kind="sssp", source=int(s),
                                       graph="g", tenant="cold"))
            for s in srcs[:4]]
    out = server.serve()
    assert all(out[r].status == "ok" for r in hot + cold)

    def admit_round(r):
        return ((0 if r in hot else join_round)
                + out[r].stats["queue_wait_rounds"])

    after = sorted((r for r in hot + cold if admit_round(r) >= join_round),
                   key=admit_round)
    tags = ["cold" if r in cold else "hot" for r in after]
    for k in range(1, len(tags) + 1):
        c, h = tags[:k].count("cold"), tags[:k].count("hot")
        assert abs(c - h) <= 2, tags


def test_tenant_weights_shape_admission_order():
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 8, seed=6)
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=16)
    server.register_tenant("heavy", weight=2.0)
    server.register_tenant("light", weight=1.0)
    rids = {}
    for i in range(8):
        t = "heavy" if i < 4 else "light"
        rids[server.submit(GraphRequest(kind="sssp", source=int(srcs[i]),
                                        graph="g", tenant=t))] = t
    out = server.serve()
    order = sorted(rids, key=lambda r: out[r].stats["queue_wait_rounds"])
    admitted = [rids[r] for r in order]
    for k in range(1, len(admitted) + 1):
        heavy = admitted[:k].count("heavy")
        assert heavy <= (2 * k) // 3 + 1, admitted


# --------------------------------------------------------------- deadlines


def test_deadline_expired_rejected_not_silently_dropped():
    tick = [0.0]
    g = grid2d(8, 8, seed=4)
    server = Server(capacity=2, k_visits=16, clock=lambda: tick[0],
                    autoscaler=None)
    server.register_graph("g", g, num_queries=2, block_size=16)
    srcs = _sources(g, 2, seed=7)
    keep = server.submit(GraphRequest(kind="sssp", source=int(srcs[0]),
                                      graph="g"))
    doomed = server.submit(GraphRequest(kind="sssp", source=int(srcs[1]),
                                        graph="g", deadline_s=5.0))
    tick[0] = 10.0                       # deadline lapses while queued
    out = server.serve()
    assert len(out) == 2                 # both answered — nothing dropped
    assert out[doomed].status == "expired"
    assert out[doomed].values is None
    assert out[doomed].stats["queue_wait_s"] == pytest.approx(10.0)
    assert out[keep].status == "ok" and out[keep].values is not None


def test_deadline_never_expires_admitted_requests():
    tick = [0.0]
    g = grid2d(8, 8, seed=4)
    server = Server(capacity=1, k_visits=4, clock=lambda: tick[0],
                    autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=16)
    rid = server.submit(GraphRequest(kind="sssp",
                                     source=int(_sources(g, 1, seed=8)[0]),
                                     graph="g", deadline_s=5.0))
    assert server.step()                 # admitted at t=0
    tick[0] = 10.0                       # lapses while in flight
    out = server.serve()
    assert out[rid].status == "ok"


# --------------------------------------------------------------- isolation


def test_multi_graph_isolation_no_state_bleed():
    a, b = grid2d(9, 9, seed=9), grid2d(12, 12, seed=10)    # 81 vs 144
    sa, sb = _sources(a, 3, seed=11), _sources(b, 3, seed=12)
    sess = {"a": _session(a, 3, 32), "b": _session(b, 3, 32)}
    one = {"a": sess["a"].run("sssp", sa), "b": sess["b"].run("sssp", sb)}
    server = Server(capacity=3, k_visits=8)
    server.register_graph("a", sess["a"])
    server.register_graph("b", sess["b"])
    rids = []
    for i in range(3):
        rids.append(("a", i, server.submit(GraphRequest(
            kind="sssp", source=int(sa[i]), graph="a"))))
        rids.append(("b", i, server.submit(GraphRequest(
            kind="sssp", source=int(sb[i]), graph="b"))))
    out = server.serve()
    for name, i, rid in rids:
        r = out[rid]
        assert r.values.shape == (sess[name].graph.n,)
        np.testing.assert_array_equal(r.values, one[name].values[i])


# ------------------------------------------------- priorities + arbitration


def test_request_priority_picks_pool_first():
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 2, seed=13)
    server = Server(capacity=1, k_visits=8, autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=16)
    server.submit(GraphRequest(kind="sssp", source=int(srcs[0]), graph="g"))
    urgent = server.submit(GraphRequest(kind="bfs", source=int(srcs[1]),
                                        graph="g", priority=-1.0))
    server.step()                        # one round serves exactly one pool
    bfs_pool = server._pools[("g", "bfs")]
    sssp_pool = server._pools[("g", "sssp")]
    assert bfs_pool.exec.visits > 0      # urgent pool won arbitration
    assert sssp_pool.exec is None        # never served, never built
    out = server.serve()
    assert out[urgent].status == "ok"


def test_scheduler_prefer_older_ties():
    sched = PartitionScheduler("priority", 3)
    prio = np.array([1.0, 1.0, 2.0], dtype=np.float32)
    stamp = np.array([7, 2, 0], dtype=np.int64)
    ops = np.array([1, 1, 1])
    assert sched.select(prio, stamp, ops) == 0                  # device rule
    assert sched.select(prio, stamp, ops, prefer_older_ties=True) == 1
    inf = np.full(3, np.inf, dtype=np.float32)
    assert sched.select(inf, stamp, ops, prefer_older_ties=True) is None


@settings(max_examples=80, deadline=None)
@given(st.lists(st.tuples(st.sampled_from([np.inf, 0.0, 1.0, 2.5]),
                          st.integers(0, 9), st.integers(0, 5)),
                min_size=1, max_size=9),
       st.sampled_from(["priority", "fifo", "max_ops"]), st.booleans())
def test_prefer_older_ties_equals_reference(rows, policy, older):
    prio = np.array([r[0] for r in rows], dtype=np.float32)
    stamp = np.array([r[1] for r in rows], dtype=np.int64)
    ops = np.array([r[2] for r in rows], dtype=np.int64)
    got = PartitionScheduler(policy, len(rows)).select(
        prio, stamp, ops, prefer_older_ties=older)
    want = JScheduler(policy, len(rows)).select(prio, stamp, ops,
                                                prefer_older_ties=older)
    assert got == want


# -------------------------------------------------------------- autoscale


def test_autoscale_capacity_hint_is_memory_clamped():
    mem = MemoryModel()
    kw = dict(mem=mem, n_vertices=1024, block_size=64)
    assert autoscale_capacity(0, 0, **kw) == 1           # idle shrinks
    assert autoscale_capacity(5, 1, **kw) == 8           # next pow2 >= 6
    assert autoscale_capacity(100, 0, max_capacity=16, **kw) == 16
    # a small shared-memory budget caps the suggestion below raw demand
    tiny = MemoryModel(smem_bytes=(2 * 64 * 64 + 2 * 8 * 64) * 4)
    got = autoscale_capacity(100, 0, mem=tiny, n_vertices=1024,
                             block_size=64)
    assert got <= 8 and tiny.fits(64, got, 1024)
    # the dense working set caps a pool at 64 lanes at B = 128 (B5(a))
    assert autoscale_capacity(1000, 0, mem=mem, n_vertices=36_864,
                              block_size=128) == 64


@settings(max_examples=80, deadline=None)
@given(st.integers(0, 3000), st.integers(0, 300), st.integers(1, 8),
       st.integers(0, 12), st.sampled_from([16, 32, 64, 128, 256]),
       st.integers(1, 50_000))
def test_planner_helpers_equal_reference(queued, active, lo, hi_exp, b, n):
    """pow2_bucket, autoscale_capacity and result_cache_budget against the
    reference's functions; the memory-model clamp is the port's
    ``MemoryModel`` on both sides (the reference's functions only call
    ``fits`` and ``state_bytes``), so what is compared is the logic."""
    hi = max(lo, 1 << hi_exp)
    assert pow2_bucket(queued, lo, hi) == jplanner.pow2_bucket(queued, lo,
                                                                hi)
    mem = MemoryModel()
    kw = dict(mem=mem, n_vertices=n, block_size=b, min_capacity=lo,
              max_capacity=hi)
    assert (autoscale_capacity(queued, active, **kw)
            == jplanner.autoscale_capacity(queued, active, **kw))
    assert (planner.result_cache_budget(mem, n, b)
            == jplanner.result_cache_budget(mem, n, b))
    assert planner.RESULT_CACHE_PLANE_SETS == jplanner.RESULT_CACHE_PLANE_SETS


def test_server_grows_pool_capacity_under_backlog():
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 6, seed=14)
    server = Server(capacity=1, k_visits=16, max_capacity=8)
    server.register_graph("g", g, num_queries=1, block_size=16)
    rids = [server.submit(GraphRequest(kind="sssp", source=int(s),
                                       graph="g")) for s in srcs]
    out = server.serve()
    assert all(out[r].status == "ok" for r in rids)
    assert server._pools[("g", "sssp")].capacity == 8


# -------------------------------------------------- continuous batching


def test_concurrent_submitters_bit_identical_and_result_blocks():
    g = grid2d(12, 12, seed=3)
    srcs = _sources(g, 12, seed=21)
    sess = _session(g, 4, 32)
    one = sess.run("sssp", srcs)
    server = Server(capacity=4, k_visits=16, autoscaler=None)
    server.register_graph("g", sess)
    server.start()
    try:
        rids, lock = {}, threading.Lock()

        def client(lo):
            for i in range(lo, lo + 4):
                rid = server.submit(GraphRequest(
                    kind="sssp", source=int(srcs[i]), graph="g",
                    tenant=f"t{lo}"))
                with lock:
                    rids[i] = rid
        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in (0, 4, 8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, rid in rids.items():
            r = server.result(rid, timeout=120)
            assert r.status == "ok"
            np.testing.assert_array_equal(r.values, one.values[i])
        with pytest.raises(KeyError):
            server.result(10_000, timeout=1)
    finally:
        server.shutdown()


@pytest.mark.parametrize("fused", [False, True])
def test_serve_forever_matches_synchronous_serve(fused):
    """The same mixed workload (every kind) through the concurrent lanes
    and through the synchronous pump: the min-plus kinds and rw bitwise,
    ppr within the eps its one-shot run carries (lane co-residency, and so
    the visit order, differs across the two)."""
    g = grid2d(10, 10, seed=6)
    srcs = _sources(g, 12, seed=22)
    sess = _session(g, 2, 32)
    reqs = [GraphRequest(kind=KINDS[i % len(KINDS)], source=int(srcs[i]),
                         graph="g", tenant="a" if i % 3 else "b")
            for i in range(12)]
    sync = Server(capacity=2, k_visits=16, autoscaler=None, fused=fused)
    sync.register_graph("g", sess)
    sync_rids = sync.submit_all(reqs)
    sync_out = sync.serve()

    conc = Server(capacity=2, k_visits=16, autoscaler=None, fused=fused)
    conc.register_graph("g", sess)
    conc_out = conc.serve_forever(iter([reqs[:6], reqs[6:]]))
    assert not conc._running                 # lanes stopped after drain

    assert len(conc_out) == len(sync_out) == len(reqs)
    by_src_sync = {(sync_out[r].kind, sync_out[r].source): sync_out[r]
                   for r in sync_rids}
    deg = np.maximum(g.out_degree(), 1)
    for r in conc_out.values():
        assert r.status == "ok"
        want = by_src_sync[(r.kind, r.source)].values
        if r.kind == "ppr":
            assert (np.abs(r.values - want) / deg).max() <= 4 * 1e-4
        else:
            np.testing.assert_array_equal(r.values, want)
        for stat in ("visits", "edges", "host_syncs", "latency_s"):
            assert stat in r.stats


def test_many_submitter_threads_stress():
    """More submitter threads than cores against the running lanes, with a
    short switch interval: every request gets one response, no rid is
    reused, every bill of coalesced twins is booked once, nothing stays
    outstanding, and every answer equals the synchronous server's."""
    import sys
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 6, seed=32)
    reqs = [GraphRequest(kind=("sssp", "bfs", "cc")[i % 3],
                         source=int(srcs[i % 6]), graph="g",
                         tenant=f"t{i % 5}") for i in range(96)]
    server = Server(capacity=2, k_visits=4, max_capacity=4)
    server.register_graph("g", g, num_queries=2, block_size=16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        server.start()
        rids, lock = [], threading.Lock()

        def client(lo):
            for r in reqs[lo::12]:
                rid = server.submit(r)
                with lock:
                    rids.append((rid, r))
        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert server.wait_drained(timeout=120)
    finally:
        sys.setswitchinterval(old)
        server.shutdown()
    assert len({rid for rid, _ in rids}) == len(reqs) == len(server.responses)
    st_ = server.stats()
    assert st_["outstanding"] == 0 and st_["coalesced"] == st_["fanout"]
    want = Server(capacity=2, k_visits=4)
    want.register_graph("g", server._sessions["g"])
    sync = {}
    for r in reqs:
        key = (r.kind, r.source)
        if key not in sync:
            sync[key] = want.submit(r)
    done = want.serve()
    for rid, r in rids:
        got = server.responses[rid]
        assert got.status == "ok" and got.tenant == r.tenant
        np.testing.assert_array_equal(got.values,
                                      done[sync[(r.kind, r.source)]].values)


def test_dedup_coalesces_in_flight_twins_and_bills_everyone():
    g = grid2d(10, 10, seed=6)
    src = int(_sources(g, 1, seed=23)[0])
    sess = _session(g, 1, 32)
    one = sess.run("sssp", np.array([src]))
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    server.register_graph("g", sess)
    rids = [server.submit(GraphRequest(kind="sssp", source=src, graph="g",
                                       tenant=t))
            for t in ("a", "b", "c")]
    out = server.serve()
    assert len(out) == 3
    primary, followers = out[rids[0]], [out[r] for r in rids[1:]]
    assert primary.stats["fanout"] == 2
    assert all(f.stats["coalesced"] for f in followers)
    for r in [primary] + followers:
        assert r.status == "ok"
        np.testing.assert_array_equal(r.values, one.values[0])
        assert r.stats["visits"] == primary.stats["visits"] >= 1
        assert r.stats["edges"] == one.edges_processed[0]
    assert server._pools[("g", "sssp")].exec._next_qid == 1


def test_dedup_off_serves_twins_separately():
    g = grid2d(8, 8, seed=4)
    src = int(_sources(g, 1, seed=24)[0])
    server = Server(capacity=2, k_visits=16, autoscaler=None, dedup=False)
    server.register_graph("g", g, num_queries=2, block_size=16)
    rids = [server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
            for _ in range(2)]
    out = server.serve()
    assert all(out[r].status == "ok" for r in rids)
    assert not any(out[r].stats.get("coalesced") for r in rids)
    assert server._pools[("g", "sssp")].exec._next_qid == 2


def test_expired_dedup_primary_promotes_live_follower():
    tick = [0.0]
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 2, seed=25)
    server = Server(capacity=1, k_visits=16, clock=lambda: tick[0],
                    autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=16)
    blocker = server.submit(GraphRequest(kind="sssp", source=int(srcs[0]),
                                         graph="g"))
    doomed = server.submit(GraphRequest(kind="sssp", source=int(srcs[1]),
                                        graph="g", deadline_s=5.0))
    saved = server.submit(GraphRequest(kind="sssp", source=int(srcs[1]),
                                       graph="g", tenant="other"))
    tick[0] = 10.0
    out = server.serve()
    assert out[doomed].status == "expired"
    assert out[saved].status == "ok" and out[saved].values is not None
    assert out[blocker].status == "ok"


def test_expired_primary_promotion_same_tenant_not_dropped():
    tick = [0.0]
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 3, seed=27)
    server = Server(capacity=1, k_visits=16, clock=lambda: tick[0],
                    autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=16)
    blocker = server.submit(GraphRequest(kind="sssp", source=int(srcs[0]),
                                         graph="g"))
    doomed, saved = [], []
    for s in srcs[1:]:
        doomed.append(server.submit(GraphRequest(
            kind="sssp", source=int(s), graph="g", deadline_s=5.0)))
        saved.append(server.submit(GraphRequest(
            kind="sssp", source=int(s), graph="g")))
    tick[0] = 10.0
    out = server.serve()
    for rid in doomed:
        assert out[rid].status == "expired"
    for rid in saved:
        assert out[rid].status == "ok" and out[rid].values is not None
    assert out[blocker].status == "ok"
    assert server.pending == 0


def test_register_graph_invalid_prewarm_has_no_effect():
    g = grid2d(8, 8, seed=4)
    server = Server(capacity=1, k_visits=16)
    with pytest.raises(ValueError, match="prewarm kind"):
        server.register_graph("g", g, prewarm=("sssp", "pagerank"),
                              num_queries=1, block_size=16)
    assert "g" not in server._sessions
    server.register_graph("g", g, prewarm=("sssp",),
                          num_queries=1, block_size=16)


def test_warm_cache_shared_across_servers_and_resizes():
    g = grid2d(8, 8, seed=4)
    srcs = _sources(g, 6, seed=26)
    server = Server(capacity=1, k_visits=16, max_capacity=8)
    server.register_graph("g", g, num_queries=1, block_size=16)
    rids = [server.submit(GraphRequest(kind="sssp", source=int(s),
                                       graph="g")) for s in srcs]
    out = server.serve()
    assert all(out[r].status == "ok" for r in rids)
    assert server._pools[("g", "sssp")].capacity == 8
    built = server.cache.stats()["misses"]

    twin = Server(capacity=1, k_visits=16, max_capacity=8,
                  cache=server.cache)
    twin.register_graph("g", server._sessions["g"])
    rids = [twin.submit(GraphRequest(kind="sssp", source=int(s),
                                     graph="g")) for s in srcs]
    out = twin.serve()
    assert all(out[r].status == "ok" for r in rids)
    stats = twin.cache.stats()
    assert stats["misses"] == built, stats      # no new builds
    assert stats["hits"] >= 1, stats
    assert all(k[3] == pow2_bucket(k[3]) for k in server.cache._cache)


def test_warm_cache_keys_by_session_not_graph_name():
    g1 = grid2d(8, 8, seed=1)
    g2 = grid2d(8, 8, seed=2)           # same shape, different weights
    src = int(_sources(g1, 1, seed=28)[0])
    cache = MegastepCache()
    s1 = Server(capacity=2, k_visits=16, autoscaler=None, cache=cache)
    s1.register_graph("default", g1, num_queries=2, block_size=16)
    s1._warm_executable(s1._pool("default", "sssp"), 2)   # warm g1's key
    s2 = Server(capacity=2, k_visits=16, autoscaler=None, cache=cache)
    s2.register_graph("default", g2, num_queries=2, block_size=16)
    rid = s2.submit(GraphRequest(kind="sssp", source=src, graph="default"))
    out = s2.serve()
    expected = _session(g2, 2, 16).run("sssp", [src])
    np.testing.assert_array_equal(out[rid].values, expected.values[0])
    s2._warm_executable(s2._pool("default", "sssp"), 2)
    assert cache.stats()["size"] == 2


@pytest.mark.parametrize("prewarm", [False, True])
def test_warm_pool_builds_no_device_graph(monkeypatch, prewarm):
    """A pool whose bundle is warm builds no ``DeviceGraph`` (nor column
    lists); a cold pool builds exactly one, in its pump lane."""
    builds = []
    real = _engine.DeviceGraph.build

    def counting(*a, **kw):
        builds.append(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(_engine.DeviceGraph, "build",
                        staticmethod(counting))
    g = grid2d(10, 10, seed=6)
    srcs = _sources(g, 4, seed=29)
    server = Server(capacity=4, k_visits=16, autoscaler=None,
                    prewarm=("sssp",) if prewarm else ())
    server.register_graph("g", g, num_queries=4, block_size=32)
    if prewarm:
        server.cache.warm_async(server._sessions["g"], "g", "sssp", 4,
                                **server._warm_params(server._sessions["g"],
                                                      "sssp")).join()
        assert len(builds) == 1
        builds.clear()
    out = server.serve_forever(iter([[GraphRequest(
        kind="sssp", source=int(s), graph="g") for s in srcs]]))
    assert all(r.status == "ok" for r in out.values())
    assert builds == ([] if prewarm else ["pump-g-sssp"])


@pytest.mark.parametrize("kind", ["sssp", "ppr", "rw"])
def test_shared_bundle_executors_equal_fresh_ones(kind):
    """Two executors built from one shared bundle, pumped in turn, answer
    what two freshly built executors answer, bit for bit (the bundle is
    read-only; every mutable array is the executor's own)."""
    g = grid2d(12, 12, seed=3)
    srcs = _sources(g, 8, seed=30)
    sess = _session(g, 4, 32)
    bundle = build_warm_megastep(sess, kind, 4, k_visits=4, eps=1e-3)

    def drive(pair):
        qids = [ex.submit(srcs[i::2][:2]) for i, ex in enumerate(pair)]
        for _ in range(3):
            for ex in pair:
                ex.pump(4)
        for i, ex in enumerate(pair):
            qids[i] += ex.submit(srcs[i::2][2:])
        while any(ex.queue or ex.active for ex in pair):
            for ex in pair:
                ex.pump(4)
        return [[(ex.result(q).values, ex.result(q).residual,
                  ex.result(q).edges) for q in qs]
                for ex, qs in zip(pair, qids)]

    shared = [sess.stream(kind, capacity=4, k_visits=4, eps=1e-3,
                          megastep=bundle) for _ in range(2)]
    fresh = [sess.stream(kind, capacity=4, k_visits=4, eps=1e-3)
             for _ in range(2)]
    if kind != "rw":
        assert shared[0].engine is shared[1].engine is bundle.engine
        assert fresh[0].engine is not fresh[1].engine
    for a, b in zip(drive(shared), drive(fresh)):
        for (va, ra, ea), (vb, rb, eb) in zip(a, b):
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(ra, rb)
            assert ea == eb


def test_injected_bundle_must_match_the_executor():
    g = grid2d(8, 8, seed=4)
    sess = _session(g, 2, 16)
    bundle = build_warm_megastep(sess, "sssp", 2, k_visits=8)
    with pytest.raises(ValueError, match="injected bundle"):
        sess.stream("sssp", capacity=4, k_visits=8, megastep=bundle)
    with pytest.raises(ValueError, match="injected bundle"):
        sess.stream("bfs", capacity=2, k_visits=8, megastep=bundle)


# ------------------------------------------------------------ lane failure


@pytest.mark.parametrize("where", ["pump", "build", "delivery"])
def test_lane_exception_reaches_result_and_wait_drained(where):
    """An exception in a pump lane (its chunk, or its build of the
    executor) or in the delivery lane halts the lanes and reaches every
    waiter, chained to the lane's error; no request waits forever and the
    server does not start again."""
    g = grid2d(8, 8, seed=4)
    src = int(_sources(g, 1, seed=31)[0])
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=16)

    def broken(*args):
        raise FloatingPointError("injected fault")

    if where == "pump":
        server._ensure_exec(server._pool("g", "sssp"))
        server._pools[("g", "sssp")].exec.pump = broken
    elif where == "build":
        server._warm_executable = broken
    else:
        server.result_cache.put = broken
    server.start()
    try:
        rid = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
        with pytest.raises(RuntimeError, match="serving lane failed") as ei:
            server.result(rid, timeout=60)
        assert isinstance(ei.value.__cause__, FloatingPointError)
        with pytest.raises(RuntimeError, match="injected fault"):
            server.wait_drained(timeout=5)
        with pytest.raises(RuntimeError, match="injected fault"):
            server.start()
    finally:
        server.shutdown()
    fresh = Server(capacity=1, k_visits=16, autoscaler=None)
    fresh.register_graph("g", g, num_queries=1, block_size=16)
    fresh._warm_executable = broken
    with pytest.raises(RuntimeError, match="injected fault"):
        fresh.serve_forever(iter([[GraphRequest(kind="sssp", source=src,
                                                graph="g")]]),
                            drain_timeout=60)
    assert not fresh._running and fresh._workers == []


# ------------------------------------------------------- planner dispatch


def test_pow2_bucket_snaps_and_clamps():
    assert pow2_bucket(0) == 1
    assert pow2_bucket(1) == 1
    assert pow2_bucket(5) == 8
    assert pow2_bucket(8) == 8
    assert pow2_bucket(9) == 16
    assert pow2_bucket(10_000, max_capacity=64) == 64
    assert pow2_bucket(2, min_capacity=4) == 4


def test_auto_fused_has_no_yardsticks_yet():
    """The port commits no dispatch yardsticks (a benchmark's job), so
    ``fused="auto"`` resolves to the unfused megastep for every kind and
    the server follows it; an explicit choice is never overridden."""
    assert planner.DISPATCH_YARDSTICKS == {}
    assert not any(auto_fused(k, K) for k in KINDS for K in (8, 64))
    g = grid2d(8, 8, seed=4)
    sess = _session(g, 2, 16, fused="auto")
    server = Server(capacity=2, k_visits=8)
    server.register_graph("g", sess)
    for kind in KINDS:
        assert server._warm_params(sess, kind)["fused"] is False
    forced = Server(capacity=2, k_visits=8, fused=True)
    forced.register_graph("g", sess)
    assert forced._warm_params(sess, "sssp")["fused"] is True
    assert forced._warm_params(sess, "rw")["fused"] is False


def test_auto_fused_guards_dense_block_graphs(monkeypatch):
    """Past the dmax budget the auto-select keeps the unfused megastep even
    where a yardstick would pick fused."""
    monkeypatch.setitem(planner.DISPATCH_YARDSTICKS, ("sssp", "fused", 64),
                        2.0)
    monkeypatch.setitem(planner.DISPATCH_YARDSTICKS,
                        ("sssp", "megastep", 64), 1.0)
    assert auto_fused("sssp", 64, dmax=FUSED_DMAX_BUDGET)
    assert not auto_fused("sssp", 64, dmax=FUSED_DMAX_BUDGET + 1)
    g = gen.erdos_renyi(n=1024, avg_deg=4.0, seed=3)
    sess = _session(g, 2, 32, fused="auto")
    bg, _ = sess.prepared()
    assert bg.nbr_blk.shape[1] > FUSED_DMAX_BUDGET
    server = Server(capacity=2, k_visits=64)
    server.register_graph("er", sess)
    assert server._warm_params(sess, "sssp")["fused"] is False


def test_plan_fused_auto_resolves_per_kind(monkeypatch):
    monkeypatch.setitem(planner.DISPATCH_YARDSTICKS, ("sssp", "fused", 64),
                        2.0)
    monkeypatch.setitem(planner.DISPATCH_YARDSTICKS,
                        ("sssp", "megastep", 64), 1.0)
    g = grid2d(8, 8, seed=4)
    sess = _session(g, 2, 16, fused="auto")
    p = sess.current_plan
    assert p.fused == "auto"
    assert p.resolve_fused("sssp") is True
    assert p.resolve_fused("bfs") is True     # shares sssp's rows
    assert p.resolve_fused("ppr") is False    # no rows for ppr
    with pytest.raises(ValueError):
        FPPSession(g, device="cpu").plan(num_queries=2, fused="sometimes")


# ------------------------------------------------------------------ misc


def test_submit_validation_and_empty_serve():
    g = grid2d(6, 6, seed=15)
    server = Server(capacity=2)
    server.register_graph("g", g, num_queries=2, block_size=16)
    with pytest.raises(ValueError):
        server.submit(GraphRequest(kind="dfs", source=0, graph="g"))
    with pytest.raises(ValueError):
        server.submit(GraphRequest(kind="sssp", source=0, graph="nope"))
    with pytest.raises(ValueError):
        server.submit(GraphRequest(kind="sssp", source=g.n, graph="g"))
    with pytest.raises(ValueError):
        server.register_graph("g", g)    # duplicate name
    assert server.serve() == {}
    assert server.pending == 0


def test_raw_graphs_are_planned_on_the_server_device(monkeypatch):
    """A raw graph is planned on the server's device: CUDA unless asked
    for the CPU, and with no card that raises instead of running here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = grid2d(6, 6, seed=15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphServer(capacity=2).register_graph("g", g, num_queries=2,
                                               block_size=16)
    server = Server(capacity=2)
    server.register_graph("g", g, num_queries=2, block_size=16)
    assert server._sessions["g"].device.type == "cpu"


def test_launch_serve_graph_workload_on_cpu(capsys):
    out = launch_serve.main(["--workload", "graph", "--device", "cpu",
                             "--graph", "snap-tiny", "--kind", "mixed",
                             "--requests", "8", "--batch", "4",
                             "--block-size", "64"])
    assert len(out) == 8
    assert all(r.status == "ok" for r in out.values())
    assert {r.kind for r in out.values()} == {"sssp", "ppr"}
    assert "8/8 ok" in capsys.readouterr().out


# ------------------------------------------- differential: the reference


def _stream(side_ref, tick, scenario):
    """Run ``scenario`` on the reference's server (``side_ref``) or the
    port's; returns (server, [rid ...] in submission order)."""
    Srv = JServer if side_ref else Server
    Req = JRequest if side_ref else GraphRequest
    grid = jgen.grid2d if side_ref else gen.grid2d
    kw = dict(clock=lambda: tick[0], fused=scenario.get("fused", False),
              k_visits=scenario.get("K", 8), max_capacity=4)
    kw.update(scenario.get("server", {}))
    server = Srv(**kw)
    g = grid(10, 10, seed=6)
    server.register_graph("g", g, num_queries=2, block_size=32)
    cand = np.flatnonzero(g.out_degree() > 0)
    rids = []
    tick[0] = 0.0
    for op in scenario["script"]:
        name, *args = op
        if name == "submit":
            kind, si, tenant, *rest = args
            prio = rest[0] if rest else 0.0
            dl = rest[1] if len(rest) > 1 else None
            rids.append(server.submit(Req(
                kind=kind, source=int(cand[si % cand.size]), graph="g",
                tenant=tenant, priority=prio, deadline_s=dl)))
        elif name == "tick":
            tick[0] = float(args[0])
        elif name == "step":
            for _ in range(args[0]):
                server.step()
        elif name == "serve":
            server.serve()
        elif name == "tenant":
            server.register_tenant(*args)
        elif name == "update":
            server.update_graph("g", grid(10, 10, seed=args[0]),
                                num_queries=2, block_size=32)
    server.serve()
    return server, rids


MIXED = [("submit", KINDS[i % 6], i, "hot") for i in range(8)]
SCENARIOS = {
    "fair": dict(server=dict(dedup=False), script=[
        ("tenant", "cold", 2.0), *MIXED, ("step", 3),
        *[("submit", "sssp", 20 + i, "cold") for i in range(3)],
        ("step", 2), *[("submit", "bfs", i, "hot") for i in range(4)]]),
    "fair_fused": dict(fused=True, script=[
        *[("submit", k, i, "ab"[i % 2]) for i, k in enumerate(
            ["sssp", "ppr", "bfs", "kreach", "cc", "sssp", "ppr"])],
        ("step", 2), ("submit", "sssp", 30, "b")]),
    "deadlines": dict(server=dict(autoscaler=None), script=[
        ("submit", "sssp", 0, "a"),
        ("submit", "sssp", 1, "a", 0.0, 5.0),       # doomed primary
        ("submit", "sssp", 1, "b"),                 # promoted follower
        ("submit", "ppr", 2, "a", 0.0, 5.0),
        ("submit", "ppr", 2, "a"),                  # same-tenant twin
        ("submit", "bfs", 3, "b", -1.0, 50.0),      # urgent, in time
        ("step", 1), ("tick", 10.0),
        ("submit", "sssp", 4, "a", 0.0, 1.0), ("step", 1), ("tick", 12.0)]),
    "dedup": dict(script=[
        *[("submit", "sssp", 5, t) for t in "abc"],
        *[("submit", "ppr", 6, t) for t in "ab"],
        ("submit", "rw", 7, "a"), ("submit", "rw", 7, "b"),
        ("step", 1), ("submit", "sssp", 5, "d"), ("submit", "kreach", 8,
                                                   "a")]),
    "cache": dict(script=[
        *[("submit", k, i, "a") for i, k in enumerate(("sssp", "ppr", "rw",
                                                       "kreach"))],
        ("serve",), ("tick", 3.0),
        *[("submit", k, i, "b") for i, k in enumerate(("sssp", "ppr", "rw",
                                                       "kreach"))],
        ("submit", "sssp", 9, "a"), ("submit", "sssp", 9, "b"),
        ("serve",), ("submit", "sssp", 9, "c")]),
    "epochs": dict(script=[
        *[("submit", k, i, "a") for i, k in enumerate(("sssp", "ppr",
                                                       "rw"))],
        ("serve",), ("update", 60),
        *[("submit", k, i, "a") for i, k in enumerate(("sssp", "ppr",
                                                       "rw"))],
        ("serve",),
        *[("submit", k, i, "b") for i, k in enumerate(("sssp", "ppr",
                                                       "rw"))]]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_served_stream_equals_reference(name):
    """One scripted stream through both servers: every response equal
    (ppr at the C2 tolerance), every bill equal, the same rounds."""
    sc = SCENARIOS[name]
    ref, ref_rids = _stream(True, [0.0], sc)
    got, rids = _stream(False, [0.0], sc)
    assert len(rids) == len(ref_rids) and got.rounds == ref.rounds
    keys = ("visits", "edges", "host_syncs", "queue_wait_s",
            "queue_wait_rounds", "latency_s", "coalesced", "fanout",
            "cached")
    seen = set()
    for rid, jrid in zip(rids, ref_rids):
        a, b = got.responses[rid], ref.responses[jrid]
        assert (a.status, a.kind, a.source, a.tenant) == (
            b.status, b.kind, b.source, b.tenant)
        assert {k: a.stats.get(k) for k in keys} == {
            k: b.stats.get(k) for k in keys}, (name, rid)
        seen.update(k for k in ("coalesced", "fanout", "cached")
                    if a.stats.get(k))
        seen.add(a.status)
        if a.values is None:
            assert b.values is None
            continue
        if a.kind == "ppr":
            np.testing.assert_allclose(a.values, np.asarray(b.values),
                                       **PPR_TOL)
            np.testing.assert_allclose(a.residual, np.asarray(b.residual),
                                       **PPR_TOL)
        else:
            np.testing.assert_array_equal(a.values, np.asarray(b.values))
            if b.residual is not None:
                np.testing.assert_array_equal(a.residual,
                                              np.asarray(b.residual))
    want = {"deadlines": {"expired"},
            "dedup": {"coalesced", "fanout"},
            "cache": {"cached", "coalesced"}, "epochs": {"cached"}}
    assert want.get(name, set()) <= seen, seen
    st_got, st_ref = got.stats(), ref.stats()
    for k in ("rounds", "epochs", "cache_hits", "cache_misses",
              "cache_bytes", "coalesced", "fanout"):
        assert st_got[k] == st_ref[k], k
