"""The paper's applications (BC, LL, NCP) on the port against the JAX
package, on the CPU at small sizes.

Their query phase runs through ``FPPSession.run`` (bfs, sssp, ppr) and
their gather phase is host numpy in both packages:

* ``bc`` and ``landmarks`` are bitwise equal to the reference session's
  (bfs and sssp are bitwise, and the gather is the same numpy);
* ``ncp_profile`` is bitwise equal on the same ppr vectors, and the
  session's ``ncp`` within ``NCP_RTOL`` of the reference's (its ppr
  vectors agree to a tolerance, ROADMAP C2).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import applications as japps  # noqa: E402
from repro.fpp import FPPSession as JSession  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import applications as apps  # noqa: E402
from repro_torch.core import oracles  # noqa: E402
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

SRCS = np.array([0, 5, 77, 143])
#: the session's ncp against the reference's: the ppr vectors differ by
#: the spread's summation order (~1e-8 here), and a conductance is a ratio
#: of sums of them
NCP_RTOL = 1e-5

GRAPHS = {
    "grid": lambda m: m.grid2d(16, 16, seed=3),
    "rmat": lambda m: m.rmat(8, 6, seed=5),
}


@pytest.fixture(scope="module")
def sessions():
    made = {}

    def get(name, fused=False):
        if (name, fused) not in made:
            made[name, fused] = (
                JSession(GRAPHS[name](jgen)).plan(num_queries=4,
                                                  block_size=32, fused=fused),
                FPPSession(GRAPHS[name](gen), device="cpu").plan(
                    num_queries=4, block_size=32, fused=fused))
        return made[name, fused]

    return get


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_bc_bitwise_equals_reference(sessions, name, fused):
    js, ts = sessions(name, fused)
    (want, wres), (got, gres) = js.bc(SRCS), ts.bc(SRCS)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gres.values, wres.values)


def test_bc_accumulate_equals_brandes_on_exact_levels():
    """The gather phase on the oracle's BFS levels equals the reference's
    bit for bit, and a plain Brandes accumulation over ``bfs_sigma`` up to
    the order of its float sums."""
    g, jg = gen.rmat(8, 5, seed=2), jgen.rmat(8, 5, seed=2)
    levels = np.stack([np.where(d >= 0, d, np.inf).astype(np.float32)
                       for d in (oracles.bfs(g, int(s))[0] for s in SRCS)])
    got = apps.bc_accumulate(g, SRCS, levels)
    np.testing.assert_array_equal(got, japps.bc_accumulate(jg, SRCS, levels))
    src, dst, _ = g.edges()
    want = np.zeros(g.n)
    for s in SRCS:
        dist, sigma, _ = oracles.bfs_sigma(g, int(s))
        delta = np.zeros(g.n)
        for v in np.argsort(-dist, kind="stable"):
            if dist[v] < 0:
                continue
            out = dst[(src == v)]
            succ = out[dist[out] == dist[v] + 1]
            delta[v] = (sigma[v] / sigma[succ] * (1.0 + delta[succ])).sum()
        delta[s] = 0.0
        want += delta
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got.max() > 0


@pytest.mark.parametrize("name", list(GRAPHS))
def test_landmarks_bitwise_equal_reference(sessions, name):
    js, ts = sessions(name)
    (want, _), (got, _) = js.landmarks(SRCS), ts.landmarks(SRCS)
    np.testing.assert_array_equal(got.landmarks, want.landmarks)
    np.testing.assert_array_equal(got.dists, want.dists)
    u, v = np.array([1, 40, 200]), np.array([3, 90, 10])
    np.testing.assert_array_equal(got.query(u, v), want.query(u, v))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_ncp_profile_bitwise_on_the_same_ppr_vectors(sessions, name):
    js, ts = sessions(name)
    _, wres = js.ncp(SRCS)
    for max_size in (None, 50):
        np.testing.assert_array_equal(
            apps.ncp_profile(ts.graph, wres.values, max_size=max_size),
            japps.ncp_profile(js.graph, wres.values, max_size=max_size))
    sizes, cond = apps.sweep_conductance(ts.graph, wres.values[0])
    jsizes, jcond = japps.sweep_conductance(js.graph, wres.values[0])
    np.testing.assert_array_equal(sizes, jsizes)
    np.testing.assert_array_equal(cond, jcond)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_session_ncp_within_tolerance_of_reference(sessions, name):
    js, ts = sessions(name)
    (want, wres), (got, gres) = js.ncp(SRCS), ts.ncp(SRCS)
    deg = np.maximum(ts.graph.out_degree(), 1)
    assert (np.abs(gres.values - wres.values) / deg).max() <= 4 * 1e-4
    np.testing.assert_allclose(got, want, rtol=NCP_RTOL)


def test_module_entry_points_equal_session_methods():
    """``betweenness_centrality``, ``landmark_labeling`` and ``ncp`` build
    their own session on the given device."""
    g = gen.grid2d(12, 12, seed=1)
    sess = FPPSession(g, device="cpu").plan(num_queries=4, block_size=32)
    bc, _ = apps.betweenness_centrality(g, SRCS, block_size=32,
                                        device="cpu")
    np.testing.assert_array_equal(bc, sess.bc(SRCS)[0])
    ll, _ = apps.landmark_labeling(g, SRCS, block_size=32, device="cpu")
    np.testing.assert_array_equal(ll.dists, sess.landmarks(SRCS)[0].dists)
    prof, _ = apps.ncp(g, SRCS, block_size=32, device="cpu")
    np.testing.assert_array_equal(prof, sess.ncp(SRCS)[0])
