"""The port's fused visit (``plan(fused=True)``) against the JAX package's
fused visit, on the CPU at small sizes.

On the CPU each launch of the port's fused kernel is its plain version
(``kernels/fused_visit/ref.fused_step_ref``); the JAX side runs its Pallas
fused visit in interpret mode, as tests/test_fused_visit.py runs it.  Both
packages get the same graph (each package's own generator and partition,
checked equal in tests/test_torch_engine.py) and the same sources.

* sssp and bfs are bitwise: values, ``edges_processed``, visits, rounds
  and the visit order, under every deterministic policy and chunk size;
  the sparse frontier is bitwise equal to the dense one.
* ppr is held within 4·eps, deg-normalised, and keeps the residual bound
  and p + r mass conservation.
* Inside the port, fused equals unfused bitwise for all three kinds.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import visit as jvisit  # noqa: E402
from repro.core.graph import CSRGraph as JCSRGraph  # noqa: E402
from repro.core.partition import partition as jpartition  # noqa: E402
from repro.core.yielding import YieldConfig as JYieldConfig  # noqa: E402
from repro.fpp import FPPSession as JSession  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import visit  # noqa: E402
from repro_torch.core.engine import DeviceGraph, FPPEngine  # noqa: E402
from repro_torch.core.graph import CSRGraph  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.core.yielding import YieldConfig  # noqa: E402
from repro_torch.fpp import FPPSession, backends, planner  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels.fused_visit import ops as fvops  # noqa: E402

POLICIES = ["priority", "fifo", "max_ops"]


def _unit(g, cls):
    return cls(indptr=g.indptr, indices=g.indices,
               weights=np.ones_like(g.weights), n=g.n, m=g.m)


def _minplus_setup(kind):
    """grid2d(12, 12), B=32, three sources (as tests/test_fused_visit.py);
    bfs runs the unit-weight graph with the Δ=1 window."""
    jg, g = jgen.grid2d(12, 12, seed=0), gen.grid2d(12, 12, seed=0)
    if kind == "bfs":
        jg, g = _unit(jg, JCSRGraph), _unit(g, CSRGraph)
    jbg, jperm = jpartition(jg, 32, method="bfs")
    bg, perm = partition(g, 32, method="bfs")
    np.testing.assert_array_equal(perm, jperm)
    delta = 1.0 if kind == "bfs" else 2.0
    return jbg, bg, perm[np.array([0, 70, 143])], delta


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    if want.residual is not None:
        np.testing.assert_array_equal(got.residual,
                                      np.asarray(want.residual))
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert got.visit_order == list(want.visit_order)
    assert (got.stats.visits, got.stats.rounds) == (want.stats.visits,
                                                    want.stats.rounds)


@pytest.mark.parametrize("kind", ["sssp", "bfs"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("K", [1, 8, 64])
def test_fused_engine_bitwise_equals_reference_fused(kind, policy, K):
    jbg, bg, srcs, delta = _minplus_setup(kind)
    kw = dict(mode="minplus", num_queries=len(srcs), schedule=policy,
              k_visits=K, fused=True)
    want = jengine.FPPEngine(jbg, yield_config=JYieldConfig(delta=delta),
                             **kw).run(srcs, record_order=True)
    got = FPPEngine(bg, yield_config=YieldConfig(delta=delta),
                    device="cpu", **kw).run(srcs, record_order=True)
    _assert_bitwise(got, want)
    assert got.stats.host_syncs == want.stats.host_syncs
    # one stats read per chunk: the loop's exit tests stay on the device
    assert got.stats.device_syncs == got.stats.host_syncs


@pytest.mark.parametrize("kind", ["sssp", "bfs"])
def test_sparse_frontier_bitwise_equals_dense(kind):
    _, bg, srcs, delta = _minplus_setup(kind)
    kw = dict(mode="minplus", num_queries=len(srcs), fused=True,
              yield_config=YieldConfig(delta=delta), device="cpu")
    dense = FPPEngine(bg, frontier_mode="dense", **kw).run(
        srcs, record_order=True)
    sparse = FPPEngine(bg, frontier_mode="sparse", **kw).run(
        srcs, record_order=True)
    _assert_bitwise(sparse, dense)


def test_fused_ppr_within_eps_of_reference_fused():
    jg, g = jgen.rmat(8, 6, seed=5), gen.rmat(8, 6, seed=5)
    jbg, _ = jpartition(jg, 64, method="bfs")
    bg, perm = partition(g, 64, method="bfs")
    deg = g.out_degree()
    srcs_o = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 3,
                                             replace=False)
    srcs, eps = perm[srcs_o], 1e-3
    kw = dict(mode="push", num_queries=3, eps=eps, fused=True)
    want = jengine.FPPEngine(jbg, **kw).run(srcs)
    got = FPPEngine(bg, device="cpu", **kw).run(srcs)
    degp = np.maximum(deg, 1)[np.argsort(perm)]     # reordered ids
    diff = np.abs(got.values - np.asarray(want.values)) / degp
    assert diff.max() <= 4 * eps, diff.max()
    assert (got.residual <= eps * degp + 1e-6).all()
    np.testing.assert_allclose(got.values.sum(1) + got.residual.sum(1), 1.0,
                               atol=1e-3)


@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr"])
def test_fused_bitwise_equals_unfused_in_the_port(kind):
    g = gen.grid2d(12, 12, seed=3, weighted=(kind != "bfs"))
    bg, perm = partition(g, 16)
    srcs = perm[np.array([0, 5, 77, 143])]
    mode = "push" if kind == "ppr" else "minplus"
    kw = dict(mode=mode, num_queries=4, k_visits=8, eps=1e-3, device="cpu",
              yield_config=planner.default_yield_config(kind, bg))
    fused = FPPEngine(bg, fused=True, **kw).run(srcs, record_order=True)
    mega = FPPEngine(bg, **kw).run(srcs, record_order=True)
    _assert_bitwise(fused, mega)
    host = FPPEngine(bg, fused=True, **kw).run(srcs, record_order=True,
                                                host_loop=True)
    _assert_bitwise(fused, host)


@pytest.mark.parametrize("kind", ["sssp", "bfs"])
def test_fused_session_bitwise_equals_reference_session(kind):
    jg, g = jgen.grid2d(12, 12, seed=3), gen.grid2d(12, 12, seed=3)
    srcs = np.array([0, 5, 77, 143])
    want = JSession(jg).plan(num_queries=4, block_size=16,
                             fused=True).run(kind, srcs)
    sess = FPPSession(g, device="cpu").plan(num_queries=4, block_size=16,
                                            fused=True)
    fvops.reset_launches()
    got = sess.run(kind, srcs)
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert {k: got.stats[k] for k in want.stats} == want.stats
    assert got.stats["device_syncs"] == got.stats["host_syncs"]
    # on the CPU the fused visit is the plain version: no kernel launch
    assert fvops.LAUNCHES == {"fused_visit": 0}


def test_one_fused_chunk_from_a_mid_run_state():
    """Both packages' fused megasteps start from the same mid-run state
    (the reference's, carried across by ``convert``) and run one chunk."""
    jg = jgen.grid2d(12, 12, seed=3)
    jbg, jperm = jpartition(jg, 16)
    srcs, Q, K, rounds = jperm[np.array([0, 5, 77, 143])], 4, 8, 16
    window = 3.0
    jdg = jengine.DeviceGraph.build(jbg, JYieldConfig(delta=window), Q)
    jalg = jvisit.minplus_algebra(window)
    jmega = jvisit.make_megastep(jdg, jalg, rounds, K=K, fused=True)
    key = jax.random.PRNGKey(0)
    jstate, _ = jmega(jvisit.init_engine_state(jalg, jdg, srcs),
                      jnp.int32(0), jnp.int32(K), key)

    bg = convert.block_graph_from_arrays(**dataclasses.asdict(jbg))
    dg = DeviceGraph.build(bg, YieldConfig(delta=window), Q, device="cpu")
    state = convert.state_from_arrays(
        [np.asarray(x) for x in jstate.planes], np.asarray(jstate.buf),
        np.asarray(jstate.prio), np.asarray(jstate.ops_count),
        np.asarray(jstate.stamp), device="cpu")
    mega = visit.make_megastep(dg, visit.minplus_algebra(window), rounds,
                               K=K, fused=True)

    jstate, jms = jmega(jstate, jnp.int32(K), jnp.int32(K), key)
    state, ms = mega(state, K, K)
    assert ms.visits == int(jms.visits) == K
    assert ms.rounds == int(jms.rounds)
    assert ms.device_syncs == 1
    for a, b in ((ms.eq_hi, jms.eq_hi), (ms.eq_lo, jms.eq_lo),
                 (ms.visit_counts, jms.visit_counts), (ms.order, jms.order),
                 (state.planes[0], jstate.planes[0]),
                 (state.buf, jstate.buf), (state.prio[:-1], jstate.prio),
                 (state.ops_count[:-1], jstate.ops_count),
                 (state.stamp[:-1], jstate.stamp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _grid_engine(**kw):
    g = gen.grid2d(12, 12, seed=3)
    bg, _ = partition(g, 16)
    return bg, dict(num_queries=4, device="cpu", **kw)


def test_guards_raise():
    bg, kw = _grid_engine()
    with pytest.raises(ValueError, match="sparse"):
        FPPEngine(bg, mode="push", fused=True, frontier_mode="sparse", **kw)
    with pytest.raises(ValueError, match="fused-kernel switch"):
        FPPEngine(bg, frontier_mode="sparse", **kw)
    with pytest.raises(ValueError, match="frontier_mode"):
        FPPEngine(bg, fused=True, frontier_mode="thin", **kw)
    with pytest.raises(ValueError, match="engine-backend flag"):
        backends.run_query("baselines", "sssp", bg, np.arange(4),
                           fused=True, device="cpu")
    with pytest.raises(ValueError, match="engine-backend flag"):
        backends.run_query("distributed", "sssp", bg, np.arange(4),
                           fused=True, device="cpu")


@pytest.mark.parametrize("fault", ["duplicate", "self"])
def test_fused_visit_rejects_bad_neighbour_lists(fault):
    bg, _ = _grid_engine()
    dg = DeviceGraph.build(bg, YieldConfig(), 4, device="cpu")
    row = int(np.flatnonzero((bg.nbr_part >= 0).sum(axis=1) >= 2)[0])
    dg.nbr_dst[row, 1] = dg.nbr_dst[row, 0] if fault == "duplicate" else row
    alg = visit.minplus_algebra(2.0)
    with pytest.raises(ValueError, match="duplicate" if fault == "duplicate"
                       else "self-edges"):
        fvops.make_fused_visit(dg, alg, 8)
    visit.make_megastep(dg, alg, 8)      # the unfused arm does not check


def test_fused_plan_picks_b128_at_q64_and_fits_shared_memory():
    mem = planner.MemoryModel()
    # per CTA of a cluster of 8 (8 query rows each)
    for n, want in ((1, 38_528), (2, 47_184)):
        assert mem.fused_working_set(128, 64, n) == want <= mem.smem_bytes
    assert mem.fits(128, 64, fused=True)
    plan = planner.make_plan(gen.grid2d(256, 256), 64, fused=True)
    assert (plan.block_size, plan.fused) == (128, True)
    assert plan.working_set_bytes() == 47_184
    assert plan.resolve_fused("ppr")
    assert not planner.make_plan(gen.grid2d(64, 64), 64,
                                 fused="auto").resolve_fused("sssp")
    assert not planner.auto_fused("sssp", dmax=planner.FUSED_DMAX_BUDGET + 1)
