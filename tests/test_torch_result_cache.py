"""The serving result-cache tier of the port (``serve/result_cache.py``),
on the CPU, and the warm bundle cache's bounds.

A cache hit returns the *same* plane the populating response carried, so
it is bit-identical to a fresh ``FPPSession.run`` for every kind.  Hits
are billed honestly (``cached: True``, zero visits, edges and host syncs,
exact queue wait); ``update_graph`` bumps the name's epoch so planes of
the replaced graph are never served; the byte budget holds (exact
accounting, LRU order, oversize entries refused).  ``ResultCache`` is pure
numpy, so it is held against the reference's class op for op on
hypothesis-drawn sequences; ``result_key`` against the reference's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.serve.result_cache import ResultCache as JResultCache  # noqa
from repro.serve.result_cache import result_key as jresult_key  # noqa
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.fpp.planner import result_cache_budget  # noqa: E402
from repro_torch.graphs.generators import grid2d, rmat  # noqa: E402
from repro_torch.serve import (GraphRequest, GraphServer,  # noqa: E402
                               MegastepCache, ResultCache, result_key)

Server = functools.partial(GraphServer, device="cpu")


def _sources(g, k, seed=0):
    cand = np.flatnonzero(g.out_degree() > 0)
    return np.random.default_rng(seed).choice(cand, size=k, replace=False)


def _session(g, q, b):
    return FPPSession(g, device="cpu").plan(num_queries=q, block_size=b)


def _entry_arrays(nbytes, seed=0):
    """A float64 plane of exactly ``nbytes`` bytes."""
    return np.random.default_rng(seed).random(nbytes // 8)


# ------------------------------------------------------------ unit: cache


def test_lru_eviction_order_and_recency_refresh():
    cache = ResultCache(budget_bytes=3 * 800)
    for i in range(3):
        assert cache.put(("s", 0, "sssp", i, 0.15, 1e-4),
                         _entry_arrays(800, seed=i))
    assert cache.get(("s", 0, "sssp", 0, 0.15, 1e-4)) is not None
    assert cache.put(("s", 0, "sssp", 3, 0.15, 1e-4), _entry_arrays(800))
    assert cache.get(("s", 0, "sssp", 1, 0.15, 1e-4)) is None   # evicted
    assert cache.get(("s", 0, "sssp", 0, 0.15, 1e-4)) is not None
    assert cache.get(("s", 0, "sssp", 2, 0.15, 1e-4)) is not None
    s = cache.stats()
    assert s["evictions"] == 1 and s["entries"] == 3
    assert s["bytes"] == 3 * 800 <= s["budget_bytes"]


def test_byte_budget_exact_accounting_and_oversize_refused():
    cache = ResultCache(budget_bytes=1000)
    vals, res = _entry_arrays(400), _entry_arrays(400, seed=1)
    assert cache.put(("a",), vals, res)
    assert cache.bytes == vals.nbytes + res.nbytes == 800
    assert not cache.put(("b",), _entry_arrays(1600))
    assert cache.get(("a",)) is not None
    assert cache.put(("a",), _entry_arrays(800, seed=2))
    assert cache.bytes == 800 and len(cache) == 1


def test_invalidate_session_frees_bytes():
    cache = ResultCache(budget_bytes=10_000)
    cache.put(result_key(7, 0, "sssp", 1, 0.15, 1e-4), _entry_arrays(160))
    cache.put(result_key(7, 0, "sssp", 2, 0.15, 1e-4), _entry_arrays(160))
    cache.put(result_key(8, 0, "sssp", 1, 0.15, 1e-4), _entry_arrays(160))
    assert cache.invalidate_session(7) == 2
    assert cache.bytes == 160 and len(cache) == 1
    assert cache.get(result_key(8, 0, "sssp", 1, 0.15, 1e-4)) is not None
    assert cache.stats()["invalidations"] == 2


def test_cached_arrays_are_frozen():
    cache = ResultCache(budget_bytes=10_000)
    vals = _entry_arrays(160)
    cache.put(("k",), vals)
    hit = cache.get(("k",))
    assert hit.values is vals          # reuse, not a copy
    with pytest.raises(ValueError):
        hit.values[0] = 99.0           # mutation fails loudly


def test_reserve_grows_never_shrinks():
    cache = ResultCache(budget_bytes=100)
    assert cache.reserve(500) == 500
    assert cache.reserve(50) == 500


OPS = st.lists(st.one_of(
    st.tuples(st.just("put"), st.integers(0, 5), st.integers(1, 40),
              st.booleans()),
    st.tuples(st.just("get"), st.integers(0, 5)),
    st.tuples(st.just("reserve"), st.integers(0, 600)),
    st.tuples(st.just("invalidate"), st.integers(0, 2))), max_size=40)


@settings(max_examples=80, deadline=None)
@given(st.integers(0, 400), OPS)
def test_result_cache_equals_reference(budget, ops):
    """The port's cache and the reference's answer every operation alike:
    hits, refusals, evictions, bytes and counters."""
    got, want = ResultCache(budget), JResultCache(budget)
    for op in ops:
        if op[0] == "put":
            _, src, words, res = op
            key = result_key(src % 3, 0, "ppr", src, 0.15, 1e-4)
            v = np.arange(words, dtype=np.float64)
            r = v + 1 if res else None
            assert got.put(key, v.copy(), None if r is None else r.copy()) \
                == want.put(key, v, r)
        elif op[0] == "get":
            key = result_key(op[1] % 3, 0, "ppr", op[1], 0.15, 1e-4)
            a, b = got.get(key), want.get(key)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.values, b.values)
                assert a.nbytes == b.nbytes
        elif op[0] == "reserve":
            assert got.reserve(op[1]) == want.reserve(op[1])
        else:
            assert got.invalidate_session(op[1]) \
                == want.invalidate_session(op[1])
        assert got.stats() == want.stats() and len(got) == len(want)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**40), st.integers(0, 9),
       st.sampled_from(["sssp", "bfs", "ppr", "cc", "kreach", "rw"]),
       st.integers(0, 10**6), st.floats(0.01, 0.99), st.floats(1e-8, 1e-2),
       st.lists(st.integers(0, 64), max_size=2))
def test_result_key_equals_reference(uid, epoch, kind, src, alpha, eps,
                                     params):
    assert result_key(uid, epoch, kind, src, alpha, eps, tuple(params)) \
        == jresult_key(uid, epoch, kind, src, alpha, eps, tuple(params))


# --------------------------------------------------------- server: parity


@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr", "cc", "kreach",
                                  "rw"])
def test_cached_hit_bit_identical_to_fresh_run(kind):
    g = grid2d(12, 12, seed=3)
    srcs = _sources(g, 3, seed=11)
    sess = _session(g, 3, 32)
    one = sess.run(kind, srcs)
    server = Server(capacity=3, k_visits=16)
    server.register_graph("g", sess)
    cold = [server.submit(GraphRequest(kind=kind, source=int(s), graph="g"))
            for s in srcs]
    server.serve()
    warm = [server.submit(GraphRequest(kind=kind, source=int(s), graph="g"))
            for s in srcs]
    out = server.serve()
    for i, (c, w) in enumerate(zip(cold, warm)):
        assert out[w].status == "ok"
        assert out[w].stats.get("cached") is True
        assert not out[c].stats.get("cached")
        np.testing.assert_array_equal(out[w].values, one.values[i],
                                      err_msg=kind)
        np.testing.assert_array_equal(out[w].values, out[c].values)
        if one.residual is not None:
            np.testing.assert_array_equal(out[w].residual, one.residual[i])
        assert out[w].stats["visits"] == 0
        assert out[w].stats["edges"] == 0.0
        assert out[w].stats["host_syncs"] == 0
        assert out[w].stats["queue_wait_s"] >= 0.0
    s = server.stats()
    assert s["cache_hits"] == 3 and s["cache_misses"] == 3
    assert s["cache_bytes"] > 0


def test_hit_skips_the_lane_entirely():
    g = grid2d(10, 10, seed=6)
    src = int(_sources(g, 1, seed=12)[0])
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=32)
    r1 = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    r2 = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    assert server.poll(r2).stats.get("cached") is True
    np.testing.assert_array_equal(server.poll(r2).values,
                                  server.poll(r1).values)
    assert server._pools[("g", "sssp")].exec._next_qid == 1


def test_result_and_poll_parity_on_hits_through_running_lanes():
    g = grid2d(10, 10, seed=6)
    src = int(_sources(g, 1, seed=13)[0])
    server = Server(capacity=2, k_visits=16, autoscaler=None)
    server.register_graph("g", g, num_queries=2, block_size=32)
    server.start()
    try:
        cold = server.result(server.submit(
            GraphRequest(kind="sssp", source=src, graph="g")), timeout=120)
        rid = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
        warm = server.result(rid, timeout=120)
        assert warm.status == "ok" and warm.stats.get("cached") is True
        np.testing.assert_array_equal(warm.values, cold.values)
        assert server.poll(rid) is warm
        assert server.wait_drained(timeout=10)
    finally:
        server.shutdown()


def test_result_cache_off_recomputes():
    g = grid2d(8, 8, seed=4)
    src = int(_sources(g, 1, seed=14)[0])
    server = Server(capacity=1, k_visits=16, autoscaler=None,
                    result_cache=False)
    server.register_graph("g", g, num_queries=1, block_size=16)
    server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    r2 = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    assert not server.poll(r2).stats.get("cached")
    assert server._pools[("g", "sssp")].exec._next_qid == 2
    assert server.stats()["cache_hits"] == 0


# ----------------------------------------------------- server: invalidation


def test_update_graph_epoch_invalidates_and_serves_new_answers():
    g_old = grid2d(10, 10, seed=6)
    g_new = grid2d(10, 10, seed=60)     # same n, different weights
    src = int(_sources(g_old, 1, seed=15)[0])
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    server.register_graph("g", g_old, num_queries=1, block_size=32)
    r1 = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    old_vals = server.poll(r1).values

    server.update_graph("g", g_new, num_queries=1, block_size=32)
    assert server.stats()["epochs"]["g"] == 1
    r2 = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    fresh = server.poll(r2)
    assert not fresh.stats.get("cached")
    want = _session(g_new, 1, 32).run("sssp", np.array([src]))
    np.testing.assert_array_equal(fresh.values, want.values[0])
    assert not np.array_equal(fresh.values, old_vals)
    r3 = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    assert server.poll(r3).stats.get("cached") is True
    np.testing.assert_array_equal(server.poll(r3).values, want.values[0])
    assert server.stats()["result_cache"]["invalidations"] >= 1


def test_update_graph_same_session_epoch_still_invalidates():
    g = grid2d(8, 8, seed=4)
    src = int(_sources(g, 1, seed=16)[0])
    sess = _session(g, 1, 16)
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    server.register_graph("g", sess)
    server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    server.update_graph("g", sess)
    r2 = server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    assert not server.poll(r2).stats.get("cached")


def test_update_graph_validation():
    g = grid2d(8, 8, seed=4)
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    with pytest.raises(ValueError, match="not registered"):
        server.update_graph("nope", g, num_queries=1, block_size=16)
    server.register_graph("g", g, num_queries=1, block_size=16)
    src = int(_sources(g, 1, seed=17)[0])
    server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    with pytest.raises(RuntimeError, match="drain first"):
        server.update_graph("g", g, num_queries=1, block_size=16)
    server.serve()
    server.update_graph("g", g, num_queries=1, block_size=16)
    assert server.stats()["epochs"]["g"] == 1


# ----------------------------------------------------- server: byte budget


def test_server_cache_bytes_budget_enforced():
    g = grid2d(10, 10, seed=6)
    srcs = _sources(g, 2, seed=18)
    sess = _session(g, 1, 32)
    one_plane = sess.run("sssp", srcs[:1]).values[0].nbytes
    server = Server(capacity=1, k_visits=16, autoscaler=None,
                    cache_bytes=int(one_plane * 1.5))
    server.register_graph("g", sess)
    for s in srcs:
        server.submit(GraphRequest(kind="sssp", source=int(s), graph="g"))
        server.serve()
    s = server.stats()
    assert s["result_cache"]["entries"] == 1
    assert s["cache_evictions"] == 1
    assert s["cache_bytes"] <= int(one_plane * 1.5)
    r_hit = server.submit(GraphRequest(kind="sssp", source=int(srcs[1]),
                                       graph="g"))
    server.serve()
    assert server.poll(r_hit).stats.get("cached") is True


def test_default_budget_comes_from_planner():
    g = rmat(7, 4, seed=7)
    sess = _session(g, 2, 32)
    server = Server(capacity=2, k_visits=16)
    server.register_graph("g", sess)
    want = result_cache_budget(sess.mem, sess.graph.n,
                               sess.current_plan.block_size)
    assert server.result_cache.budget_bytes == want
    assert want == 16 * sess.mem.state_bytes(sess.graph.n, 1,
                                             sess.current_plan.block_size)


def test_shared_result_cache_across_servers():
    g = grid2d(10, 10, seed=6)
    src = int(_sources(g, 1, seed=19)[0])
    sess = _session(g, 1, 32)
    shared = ResultCache()
    s1 = Server(capacity=1, k_visits=16, autoscaler=None,
                result_cache=shared)
    s1.register_graph("g", sess)
    s1.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    s1.serve()
    s2 = Server(capacity=1, k_visits=16, autoscaler=None,
                result_cache=shared)
    s2.register_graph("g", sess)        # same session -> same uid
    r = s2.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    s2.serve()
    assert s2.poll(r).stats.get("cached") is True
    other = _session(grid2d(10, 10, seed=61), 1, 32)
    s3 = Server(capacity=1, k_visits=16, autoscaler=None,
                result_cache=shared)
    s3.register_graph("g", other)
    r3 = s3.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    s3.serve()
    assert not s3.poll(r3).stats.get("cached")


# ------------------------------------------------------- server: counters


def test_stats_surface_cache_and_dedup_counters():
    g = grid2d(10, 10, seed=6)
    src = int(_sources(g, 1, seed=20)[0])
    server = Server(capacity=1, k_visits=16, autoscaler=None)
    server.register_graph("g", g, num_queries=1, block_size=32)
    for t in ("a", "b", "c"):
        server.submit(GraphRequest(kind="sssp", source=src, graph="g",
                                   tenant=t))
    server.serve()
    server.submit(GraphRequest(kind="sssp", source=src, graph="g"))
    server.serve()
    s = server.stats()
    assert s["coalesced"] == 2 and s["fanout"] == 2
    assert s["cache_hits"] == 1
    assert s["cache_misses"] >= 1
    assert s["cache_evictions"] == 0
    assert s["cache_bytes"] == s["result_cache"]["bytes"] > 0
    assert s["compile_cache"]["max_entries"] >= 1
    assert s["cache"] == s["compile_cache"]
    pool = s["pools"]["g/sssp"]
    assert pool["visits_total"] >= pool["visits"] >= 1
    assert pool["host_syncs_total"] >= pool["host_syncs"] >= 1


# ------------------------------------------------ bundle cache bounding


def test_megastep_cache_lru_eviction():
    cache = MegastepCache(max_entries=2)
    g = grid2d(6, 6, seed=1)
    sess = _session(g, 1, 16)
    for cap in (1, 2):
        cache.get_or_build(sess, "g", "sssp", cap, k_visits=8)
    assert len(cache) == 2
    k1 = cache.get_or_build(sess, "g", "sssp", 1, k_visits=8)
    cache.get_or_build(sess, "g", "sssp", 4, k_visits=8)
    st_ = cache.stats()
    assert st_["size"] == 2 and st_["evictions"] == 1
    assert cache.get_or_build(sess, "g", "sssp", 1, k_visits=8) is k1
    before = st_["misses"]
    cache.get_or_build(sess, "g", "sssp", 2, k_visits=8)
    assert cache.stats()["misses"] == before + 1
    assert cache.stats()["compile_s"] > 0.0


def test_megastep_cache_rejects_bad_max_entries():
    with pytest.raises(ValueError, match="max_entries"):
        MegastepCache(max_entries=0)
