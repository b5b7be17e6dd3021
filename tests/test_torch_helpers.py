"""The port's host helpers ``core/queries.prepare`` and
``core/oracles.dfs_order`` against the JAX package's, on the CPU: the same
graphs (each package's generators from one seed, which build the same CSR
bit for bit) give the same block graph arrays and permutation, and the
same preorder labels, bit for bit."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import oracles as joracles  # noqa: E402
from repro.core import queries as jqueries  # noqa: E402
from repro.core.graph import CSRGraph as JCSRGraph  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import oracles, queries  # noqa: E402
from repro_torch.core.graph import BlockGraph, CSRGraph  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402


def _directed(module, csr):
    """A directed graph of 40 vertices: a chain 0 -> .. -> 19 with chords
    forward and back, a cycle 20 -> .. -> 29 -> 20 that the chain enters
    once, and 30..39 with edges among themselves and into the chain,
    which nothing reaches from 0."""
    rng = np.random.default_rng(7)
    src = list(range(19)) + list(range(20, 30)) + [5] + \
        rng.integers(0, 20, 12).tolist() + rng.integers(30, 40, 10).tolist()
    dst = list(range(1, 20)) + list(range(21, 30)) + [20, 24] + \
        rng.integers(0, 20, 12).tolist() + rng.integers(0, 40, 10).tolist()
    w = rng.uniform(1, 5, len(src)).astype(np.float32)
    return csr.from_edges(40, np.array(src), np.array(dst), w)


GRAPHS = {
    "grid2d": lambda m, c: m.grid2d(12, 12, seed=3),
    "rmat": lambda m, c: m.rmat(7, 4, seed=2, symmetrize=False),
    "directed": lambda m, c: _directed(m, c),
    "snap_tiny": lambda m, c: m.snap_fixture(),
}


def _pair(name):
    return (GRAPHS[name](jgen, JCSRGraph), GRAPHS[name](gen, CSRGraph))


def _same_csr(jg, g):
    for f in ("indptr", "indices", "weights"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    assert (g.n, g.m) == (jg.n, jg.m)


#: (weights, unit_weights) of prepare's calls: each variant, the default,
#: and the legacy unit spelling
PREPARE = [(None, False), ("natural", False), ("unit", False),
           ("zero", False), ("shift", False), (None, True)]


@pytest.mark.parametrize("weights,unit", PREPARE,
                         ids=[f"{w}-{'unit' if u else 'flag-off'}"
                              for w, u in PREPARE])
@pytest.mark.parametrize("name,method", [("grid2d", "bfs"),
                                         ("rmat", "degree"),
                                         ("snap_tiny", "bfs")])
def test_prepare_matches_reference(name, method, weights, unit):
    """``queries.prepare`` of each weight variant: every array of the
    block graph, its sizes and the permutation equal the reference's."""
    jg, g = _pair(name)
    _same_csr(jg, g)
    jbg, jperm = jqueries.prepare(jg, 16, method=method, unit_weights=unit,
                                  weights=weights)
    bg, perm = queries.prepare(g, 16, method=method, unit_weights=unit,
                               weights=weights)
    np.testing.assert_array_equal(perm, jperm)
    assert perm.dtype == jperm.dtype
    for f in dataclasses.fields(BlockGraph):
        got, want = getattr(bg, f.name), getattr(jbg, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert got == want, f.name


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dfs_order_matches_reference(name):
    """``oracles.dfs_order`` from several sources: int32 preorder labels,
    -1 where unreachable, equal to the reference's."""
    jg, g = _pair(name)
    _same_csr(jg, g)
    srcs = sorted({0, g.n // 3, g.n - 1})
    unreachable = 0
    for s in srcs:
        got, want = oracles.dfs_order(g, s), joracles.dfs_order(jg, s)
        assert got.dtype == np.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=str(s))
        assert got[s] == 0
        reached = np.flatnonzero(got >= 0)
        assert sorted(got[reached]) == list(range(len(reached)))
        unreachable += int((got < 0).sum())
    if name == "directed":
        assert unreachable > 0
