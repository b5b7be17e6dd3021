"""cc and kreach on the port's engine backend against the JAX package, on
the CPU at small sizes.

Both packages get the same graph (each package's generator from the same
seed) and the same sources, through ``FPPSession``, unfused and fused (the
fused dispatch runs its plain version on the CPU).

* cc is bitwise equal to the reference in values, ``edges_processed`` and
  every reference stat, and equal to union-find
  (``oracles.connected_components``) on symmetric graphs; on directed
  input it is still the reference's answer bit for bit (the port neither
  rejects nor symmetrises it).
* kreach is bitwise equal to the reference in values, hops (the residual)
  and ``edges_processed`` at hop budgets 1, 3 and 8, and to the port's
  sequential ``oracles.kreach``.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import oracles as joracles  # noqa: E402
from repro.core import queries as jqueries  # noqa: E402
from repro.fpp import FPPSession as JSession  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import oracles, queries  # noqa: E402
from repro_torch.core.engine import FPPEngine  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

SRCS = np.array([0, 5, 77, 143])

#: symmetric graphs: a hub-heavy one, one of many components, a lattice
GRAPHS = {
    "rmat": lambda m: m.rmat(8, 6, seed=5),
    "er": lambda m: m.erdos_renyi(300, avg_deg=1.5, seed=1),
    "grid": lambda m: m.grid2d(14, 14, seed=3),
}


@pytest.fixture(scope="module")
def sessions():
    """(reference session, port session) per (graph, fused), made once."""
    made = {}

    def get(name, fused):
        if (name, fused) not in made:
            jg, g = GRAPHS[name](jgen), GRAPHS[name](gen)
            made[name, fused] = (
                JSession(jg).plan(num_queries=4, block_size=32, fused=fused),
                FPPSession(g, device="cpu").plan(num_queries=4,
                                                 block_size=32, fused=fused))
        return made[name, fused]

    return get


def _same_run(got, want):
    np.testing.assert_array_equal(got.values, want.values)
    if want.residual is None:
        assert got.residual is None
    else:
        np.testing.assert_array_equal(got.residual, want.residual)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert {k: got.stats[k] for k in want.stats} == want.stats


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_cc_bitwise_equals_reference_and_union_find(sessions, name, fused):
    js, ts = sessions(name, fused)
    got = ts.run("cc", SRCS)
    _same_run(got, js.run("cc", SRCS))
    labels = oracles.connected_components(ts.graph).astype(np.float32)
    assert (got.values == labels[None]).all()
    if name == "er":
        assert np.unique(labels).size > 10      # many components


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_kreach_bitwise_equals_reference_and_oracle(sessions, name, fused):
    js, ts = sessions(name, fused)
    got = ts.run("kreach", SRCS, k=8)
    _same_run(got, js.run("kreach", SRCS, k=8))
    for i, s in enumerate(SRCS):
        vals, hops, _ = oracles.kreach(ts.graph, int(s), 8)
        np.testing.assert_array_equal(got.values[i], vals)
        np.testing.assert_array_equal(got.residual[i], hops)


@pytest.mark.parametrize("k", [1, 3])
def test_kreach_hop_budgets_bitwise_equal_reference(sessions, k):
    """Below the graph's depth the budget cuts paths off: +inf values where
    the hop-minimal path is longer than k, the hops kept."""
    js, ts = sessions("grid", False)
    got = ts.run("kreach", SRCS, k=k)
    _same_run(got, js.run("kreach", SRCS, k=k))
    assert np.isinf(got.values).any() and np.isfinite(got.residual).all()
    for i, s in enumerate(SRCS):
        vals, hops, _ = oracles.kreach(ts.graph, int(s), k)
        np.testing.assert_array_equal(got.values[i], vals)
        np.testing.assert_array_equal(got.residual[i], hops)


def test_cc_on_directed_input_equals_reference():
    """C1: on a directed graph cc is the reference's answer bit for bit,
    whatever union-find says."""
    jg = jgen.rmat(8, 6, seed=5, symmetrize=False)
    g = gen.rmat(8, 6, seed=5, symmetrize=False)
    want = JSession(jg).plan(num_queries=4, block_size=32).run("cc", SRCS)
    got = FPPSession(g, device="cpu").plan(num_queries=4,
                                           block_size=32).run("cc", SRCS)
    _same_run(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_cc_cut_by_max_visits_raises_a_value_error(fused):
    """C6: five visits leave cc's labels unconverged (+inf cells), which have
    no canonical form.  The port raises a ValueError naming cc and
    max_visits; the reference fails in ``canonicalize_cc`` with an
    IndexError (the +inf cast to int64).  Neither returns an answer."""
    srcs = np.array([0, 40, 98])
    kw = dict(num_queries=3, block_size=16, fused=fused)
    with pytest.raises(IndexError):
        JSession(jgen.grid2d(9, 11)).plan(**kw).run("cc", srcs, max_visits=5)
    sess = FPPSession(gen.grid2d(9, 11), device="cpu").plan(**kw)
    with pytest.raises(ValueError, match="cc.*max_visits"):
        sess.run("cc", srcs, max_visits=5)
    got = sess.run("cc", srcs)
    np.testing.assert_array_equal(
        got.values, JSession(jgen.grid2d(9, 11)).plan(**kw).run(
            "cc", srcs).values)


def test_cc_refuses_graphs_of_2_24_vertices():
    bg, _ = partition(gen.grid2d(6, 6), 16)
    with pytest.raises(ValueError, match="2\\^24"):
        FPPEngine(dataclasses.replace(bg, n=1 << 24), mode="cc",
                  num_queries=1, device="cpu")
    FPPEngine(dataclasses.replace(bg, n=(1 << 24) - 1), mode="kreach",
              num_queries=1, device="cpu")


@pytest.mark.parametrize("mode", ["cc", "kreach"])
def test_megastep_equals_host_loop(mode):
    """The device-side scheduler under the strict (cc) and the shifted
    (kreach) instantiations, against the host scheduler, K=4."""
    g = gen.grid2d(12, 12, seed=3)
    variant = {"cc": "zero", "kreach": "shift"}[mode]
    stride = oracles.kreach_stride(g.n, float(g.weights.max()))
    bg, perm = partition(queries.reweight(g, variant, stride=stride), 16)
    eng = FPPEngine(bg, mode=mode, num_queries=4, k_visits=4,
                    hop_budget=5, hop_stride=stride, device="cpu")
    mega = eng.run(perm[SRCS], record_order=True)
    host = eng.run(perm[SRCS], record_order=True, host_loop=True)
    np.testing.assert_array_equal(mega.values, host.values)
    np.testing.assert_array_equal(mega.edges_processed, host.edges_processed)
    assert mega.visit_order == host.visit_order
    assert (mega.stats.visits, mega.stats.rounds) == (host.stats.visits,
                                                      host.stats.rounds)


@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr", "cc", "kreach"])
def test_query_facades_equal_reference(kind):
    """``core/queries.run_*`` on the same block graph as the reference's
    facades: bitwise for the minplus kinds, ppr within 4·eps per unit of
    degree."""
    jg, g = jgen.grid2d(10, 10, seed=4), gen.grid2d(10, 10, seed=4)
    stride = oracles.kreach_stride(g.n, float(g.weights.max()))
    assert stride == joracles.kreach_stride(jg.n, float(jg.weights.max()))
    variant = queries.WEIGHT_VARIANTS.get(kind, "natural")
    jbg, jperm = jqueries.prepare(jg, 16, weights=variant)
    bg, perm = queries.prepare(g, 16, weights=variant)
    np.testing.assert_array_equal(perm, jperm)
    src = perm[np.array([0, 41, 99])]
    if kind == "kreach":
        want = jqueries.run_kreach(jbg, src, 4, stride)
        got = queries.run_kreach(bg, src, 4, stride, device="cpu")
    else:
        want = getattr(jqueries, f"run_{kind}")(jbg, src)
        got = getattr(queries, f"run_{kind}")(bg, src, device="cpu")
    if kind == "ppr":
        deg = np.maximum(g.out_degree(), 1)[np.argsort(perm)]
        diff = np.abs(got.values - want.values) / deg
        assert diff.max() <= 4 * 1e-4
        return
    np.testing.assert_array_equal(got.values, want.values)
    if kind == "kreach":
        np.testing.assert_array_equal(got.residual, want.residual)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert (got.stats.visits, got.stats.rounds) == (want.stats.visits,
                                                    want.stats.rounds)


def test_oracles_equal_reference():
    """The port's numpy copy of the sequential references gives the
    reference's answers."""
    jg, g = jgen.erdos_renyi(200, avg_deg=2.0, seed=7), \
        gen.erdos_renyi(200, avg_deg=2.0, seed=7)
    np.testing.assert_array_equal(oracles.connected_components(g),
                                  joracles.connected_components(jg))
    for a, b in zip(oracles.label_prop(g), joracles.label_prop(jg)):
        np.testing.assert_array_equal(a, b)
    for fn in ("dijkstra", "bfs", "bfs_sigma", "ppr_push"):
        for a, b in zip(getattr(oracles, fn)(g, 3),
                        getattr(joracles, fn)(jg, 3)):
            np.testing.assert_array_equal(a, b)
    for n, w in ((1, 0.5), (200, 9.0), (10 ** 6, 3.0)):
        assert oracles.kreach_stride(n, w) == joracles.kreach_stride(n, w)
    packed = np.array([[0.0, 3.5, 2048.0 + 7.0, 5 * 2048.0 + 1.0, np.inf]],
                      dtype=np.float32)
    for a, b in zip(oracles.decode_kreach(packed, 2048.0, 4),
                    joracles.decode_kreach(packed, 2048.0, 4)):
        np.testing.assert_array_equal(a, b)
