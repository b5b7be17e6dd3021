"""The port's slice (sssp, bfs, ppr through ``FPPSession`` on the engine
backend) against the JAX package, on the CPU at small sizes.

Both packages get the same graph (each package's generator from the same
seed, checked equal below) and the same sources.  The JAX side runs its
default ``use_pallas=False`` path, which the Pallas kernels match (see
tests/test_torch_kernels.py).

* sssp and bfs are bitwise: values, ``edges_processed``, visits, rounds,
  ``host_syncs`` and the visit order, under every deterministic policy.
* ppr is held within 4·eps, deg-normalised (each run sits within 2·eps of
  the truth), and keeps the residual bound and p + r mass conservation.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import visit as jvisit  # noqa: E402
from repro.core.partition import partition as jpartition  # noqa: E402
from repro.core.yielding import YieldConfig as JYieldConfig  # noqa: E402
from repro.fpp import FPPSession as JSession  # noqa: E402
from repro.fpp import planner as jplanner  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import visit  # noqa: E402
from repro_torch.core.engine import DeviceGraph, FPPEngine  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.core.yielding import YieldConfig  # noqa: E402
from repro_torch.fpp import FPPSession, planner  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

POLICIES = ["priority", "fifo", "max_ops"]
SRCS = np.array([0, 5, 77, 143])


def _graphs(name):
    """(reference graph, port graph) from each package's own generator."""
    if name == "snap-tiny":
        return jgen.build_suite("snap-tiny"), gen.build_suite("snap-tiny")
    if name == "rmat":
        return jgen.rmat(8, 6, seed=5), gen.rmat(8, 6, seed=5)
    return jgen.grid2d(12, 12, seed=3), gen.grid2d(12, 12, seed=3)


@pytest.mark.parametrize("name,method", [("grid", "bfs"), ("snap-tiny", "bfs"),
                                         ("rmat", "random")])
def test_partition_matches_reference(name, method):
    jg, g = _graphs(name)
    for f in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    jbg, jperm = jpartition(jg, 32, method=method)
    bg, perm = partition(g, 32, method=method)
    np.testing.assert_array_equal(perm, jperm)
    for f, want in dataclasses.asdict(jbg).items():
        np.testing.assert_array_equal(getattr(bg, f), want, err_msg=f)


def _order(engine_cls, bg, perm, kind, policy, planner_mod, **kw):
    yc = planner_mod.default_yield_config(kind, bg)
    eng = engine_cls(bg, mode="minplus", num_queries=len(SRCS),
                     yield_config=yc, schedule=policy, **kw)
    return eng.run(perm[SRCS], record_order=True).visit_order


@pytest.mark.parametrize("kind", ["sssp", "bfs"])
@pytest.mark.parametrize("policy", POLICIES)
def test_minplus_session_bitwise_equals_reference(kind, policy):
    jg, g = _graphs("grid")
    js = JSession(jg).plan(num_queries=4, block_size=16, schedule=policy)
    ts = FPPSession(g, device="cpu").plan(num_queries=4, block_size=16,
                                          schedule=policy)
    want, got = js.run(kind, SRCS), ts.run(kind, SRCS)
    assert got.values.dtype == np.float32
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert {k: got.stats[k] for k in want.stats} == want.stats
    # the visit order, through each package's engine on its session's graph
    variant = "unit" if kind == "bfs" else "natural"
    jbg, jperm = js.prepared(weights=variant)
    bg, perm = ts.prepared(weights=variant)
    jorder = _order(jengine.FPPEngine, jbg, jperm, kind, policy, jplanner)
    torder = _order(FPPEngine, bg, perm, kind, policy, planner, device="cpu")
    assert torder == jorder and len(torder) == want.stats["visits"]


def test_snap_tiny_sssp_bitwise_equals_reference():
    """The hub-heavy fixture gives a larger dmax (more neighbour slots)."""
    jg, g = _graphs("snap-tiny")
    srcs = np.array([0, 1, 500, 959])
    want = JSession(jg).plan(num_queries=4, block_size=32).run("sssp", srcs)
    sess = FPPSession(g, device="cpu").plan(num_queries=4, block_size=32)
    got = sess.run("sssp", srcs)
    assert sess.prepared()[0].nbr_blk.shape[1] > 8
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert {k: got.stats[k] for k in want.stats} == want.stats


def test_ppr_within_eps_of_reference_and_keeps_invariants():
    jg, g = jgen.grid2d(10, 10, seed=11), gen.grid2d(10, 10, seed=11)
    srcs = np.array([0, 33, 55, 99])
    eps = 1e-3
    want = JSession(jg).plan(num_queries=4, block_size=32).run(
        "ppr", srcs, eps=eps)
    got = FPPSession(g, device="cpu").plan(num_queries=4, block_size=32).run(
        "ppr", srcs, eps=eps)
    deg = g.out_degree()
    diff = np.abs(got.values - want.values) / np.maximum(deg, 1)
    assert diff.max() <= 4 * eps, diff.max()
    assert (got.residual <= eps * np.maximum(deg, 1) + 1e-6).all()
    np.testing.assert_allclose(got.values.sum(1) + got.residual.sum(1), 1.0,
                               atol=1e-3)


@pytest.mark.parametrize("mode", ["minplus", "push"])
def test_megastep_equals_host_loop(mode):
    """The device-side scheduler is the host scheduler, bit for bit; K=8
    forces several chunks."""
    _, g = _graphs("grid")
    bg, perm = partition(g, 16)
    kind = "sssp" if mode == "minplus" else "ppr"
    eng = FPPEngine(bg, mode=mode, num_queries=4, k_visits=8, eps=1e-3,
                    yield_config=planner.default_yield_config(kind, bg),
                    device="cpu")
    mega = eng.run(perm[SRCS], record_order=True)
    host = eng.run(perm[SRCS], record_order=True, host_loop=True)
    np.testing.assert_array_equal(mega.values, host.values)
    if mode == "push":
        np.testing.assert_array_equal(mega.residual, host.residual)
    np.testing.assert_array_equal(mega.edges_processed, host.edges_processed)
    assert mega.visit_order == host.visit_order
    assert (mega.stats.visits, mega.stats.rounds) == (host.stats.visits,
                                                      host.stats.rounds)
    assert mega.stats.host_syncs == -(-mega.stats.visits // 8)
    assert host.stats.host_syncs == host.stats.visits


def test_convert_mid_run_state_one_megastep_chunk():
    """Both packages start from the same mid-run state (the reference's,
    carried across by ``convert``) and run one K-visit chunk."""
    jg, _ = _graphs("grid")
    jbg, jperm = jpartition(jg, 16)
    srcs, Q, K, rounds = jperm[SRCS], len(SRCS), 8, 16
    window = float(jplanner.default_yield_config("sssp", jbg).window())
    jdg = jengine.DeviceGraph.build(jbg, JYieldConfig(delta=window), Q)
    jalg = jvisit.minplus_algebra(window)
    jmega = jvisit.make_megastep(jdg, jalg, rounds, K=K)
    key = jax.random.PRNGKey(0)
    jstate, _ = jmega(jvisit.init_engine_state(jalg, jdg, srcs),
                      jnp.int32(0), jnp.int32(K), key)

    bg = convert.block_graph_from_arrays(**dataclasses.asdict(jbg))
    dg = DeviceGraph.build(bg, YieldConfig(delta=window), Q, device="cpu")
    alg = visit.minplus_algebra(window)
    init = visit.init_engine_state(alg, dg, srcs)
    jinit = jvisit.init_engine_state(jalg, jdg, srcs)
    for f in ("prio", "ops_count", "stamp"):
        np.testing.assert_array_equal(getattr(init, f)[:-1].numpy(),
                                      np.asarray(getattr(jinit, f)))
    state = convert.state_from_arrays(
        [np.asarray(x) for x in jstate.planes], np.asarray(jstate.buf),
        np.asarray(jstate.prio), np.asarray(jstate.ops_count),
        np.asarray(jstate.stamp), device="cpu")
    mega = visit.make_megastep(dg, alg, rounds, K=K)

    jstate, jms = jmega(jstate, jnp.int32(K), jnp.int32(K), key)
    state, ms = mega(state, K, K)
    assert ms.visits == int(jms.visits) == K
    assert ms.rounds == int(jms.rounds)
    for a, b in ((ms.eq_hi, jms.eq_hi), (ms.eq_lo, jms.eq_lo),
                 (ms.visit_counts, jms.visit_counts), (ms.order, jms.order),
                 (state.planes[0], jstate.planes[0]),
                 (state.buf, jstate.buf), (state.prio[:-1], jstate.prio),
                 (state.ops_count[:-1], jstate.ops_count),
                 (state.stamp[:-1], jstate.stamp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("call,roadmap", [
    (lambda s: s.run("cc", SRCS), "A6"),
    (lambda s: s.run("kreach", SRCS), "A6"),
    (lambda s: s.run("rw", SRCS), "A8"),
    (lambda s: s.run("sssp", SRCS, backend="baselines"), "A5"),
    (lambda s: s.run("sssp", SRCS, backend="distributed"), "A10"),
    (lambda s: s.run("sssp", SRCS, schedule="random"), "A8"),
    (lambda s: s.run("sssp", SRCS, fused=True), "B5"),
])
def test_unported_paths_raise_naming_their_roadmap_item(call, roadmap):
    _, g = _graphs("grid")
    sess = FPPSession(g, device="cpu").plan(num_queries=4, block_size=16)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {roadmap}\\b"):
        call(sess)


def test_hopper_plan_picks_b128_at_q64():
    """2·128²·4 + 2·64·128·4 = 196,608 B fits one block's 232,448 B of
    shared memory; B=256 does not."""
    mem = planner.MemoryModel()
    assert mem.working_set(128, 64) == 196_608
    assert mem.fits(128, 64) and not mem.fits(256, 64)
    g = gen.grid2d(256, 256)
    plan = planner.make_plan(g, 64)
    assert (plan.block_size, plan.method, plan.fused) == (128, "bfs", False)
    assert not plan.resolve_fused("sssp")
    assert planner.DISPATCH_YARDSTICKS == {}
