"""Random walks (rw) of the port against the JAX package on the CPU, bit
for bit.

Both packages get the same graph (each package's generator from the same
seed) and the same sources.  The engine backend (the buffered walker
loop) and the baselines backend (synchronous rounds) must give the
reference's positions, steps, trajectory hashes, occupancy and visit
count exactly; so must the port's sequential ``oracles.random_walk``
(the tape replay) and ``FPPSession.random_walks``/``run("rw")``, in
original ids.  Also: sinks park walkers, zero length is the identity,
different seeds diverge.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import oracles as joracles  # noqa: E402
from repro.core.graph import CSRGraph as JCSR  # noqa: E402
from repro.core.partition import partition as jpartition  # noqa: E402
from repro.core.randomwalk import run_random_walks as jrun  # noqa: E402
from repro.fpp import FPPSession as JSession  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import oracles  # noqa: E402
from repro_torch.core.baselines import global_random_walks  # noqa: E402
from repro_torch.core.graph import CSRGraph  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.core.randomwalk import (run_random_walks,  # noqa: E402
                                         walk_lists)
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

GRAPHS = {
    "grid": lambda m: m.grid2d(14, 14, seed=3),
    "rmat": lambda m: m.rmat(8, 6, seed=5),
    "er": lambda m: m.erdos_renyi(300, avg_deg=6, seed=1),
    "sparse_er": lambda m: m.erdos_renyi(300, avg_deg=1.5, seed=1),
}
PICKS = np.array([0, 5, 77, 143, 150, 3, 60, 100])
FIELDS = ("positions", "steps", "trajectory_hash", "occupancy")


def _both(name, block_size=16):
    jbg, jperm = jpartition(GRAPHS[name](jgen), block_size)
    bg, perm = partition(GRAPHS[name](gen), block_size)
    np.testing.assert_array_equal(perm, jperm)
    return jbg, bg, perm


def _assert_walks_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.visits == want.visits


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("length,seed", [(20, 3), (32, 0)])
def test_engine_walks_bitwise_equal_reference(name, length, seed):
    jbg, bg, perm = _both(name)
    srcs = perm[PICKS]
    _assert_walks_equal(run_random_walks(bg, srcs, length, seed=seed,
                                         device="cpu"),
                        jrun(jbg, srcs, length, seed=seed))


@pytest.mark.parametrize("name", ["grid", "sparse_er"])
def test_baselines_walks_bitwise_equal_reference_and_engine(name):
    jbg, bg, perm = _both(name)
    srcs = perm[PICKS]
    got = global_random_walks(bg, srcs, 24, seed=2, device="cpu")
    _assert_walks_equal(got, jbaselines.global_random_walks(jbg, srcs, 24,
                                                            seed=2))
    eng = run_random_walks(bg, srcs, 24, seed=2, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(eng, f))


def test_walk_lists_are_the_reference_rows_finite_entries():
    """Every vertex's list is its dense tape-order row's finite entries,
    mapped to destinations as the reference's stepper maps them."""
    _, bg, _ = _both("rmat")
    wptr, wdst = walk_lists(bg)
    B, D = bg.block_size, bg.nbr_blk.shape[1]
    for v in range(0, bg.n_padded, 7):
        p, loc = divmod(v, B)
        rows = [bg.blocks[bg.diag_blk[p]][loc]] + [
            bg.blocks[bg.nbr_blk[p, j]][loc] if bg.nbr_blk[p, j] >= 0
            else np.full(B, np.inf) for j in range(D)]
        parts = [p] + [max(int(x), 0) for x in bg.nbr_part[p]]
        want = [parts[s] * B + c for s, r in enumerate(rows)
                for c in np.flatnonzero(np.isfinite(r))]
        assert wdst[wptr[v]:wptr[v + 1]].tolist() == want


@pytest.mark.parametrize("name", ["grid", "rmat", "sparse_er"])
def test_oracle_replay_equals_reference_oracle_and_engine(name):
    jbg, bg, perm = _both(name)
    srcs = perm[PICKS[:5]]
    eng = run_random_walks(bg, srcs, 16, seed=9, device="cpu")
    for i, s in enumerate(srcs):
        path = oracles.random_walk(bg, int(s), 16, seed=9)
        np.testing.assert_array_equal(
            path, joracles.random_walk(jbg, int(s), 16, seed=9))
        assert path[-1] == eng.positions[i]
        occ = np.bincount(path, minlength=bg.n)[:bg.n]
        np.testing.assert_array_equal(occ, eng.occupancy[i])


@pytest.mark.parametrize("backend", ["engine", "baselines"])
def test_session_run_rw_equals_reference(backend):
    jg, g = GRAPHS["grid"](jgen), GRAPHS["grid"](gen)
    js = JSession(jg).plan(num_queries=8, block_size=16, fused=True)
    ts = FPPSession(g, device="cpu").plan(num_queries=8, block_size=16,
                                          fused=True)
    want = js.run("rw", PICKS, backend=backend, length=12, seed=4)
    got = ts.run("rw", PICKS, backend=backend, length=12, seed=4)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert got.residual is None and want.residual is None
    for k, v in want.stats.items():
        assert got.stats[k] == v, k
    # occupancy rows count the start and each step: length + 1 in all
    np.testing.assert_array_equal(got.values.sum(axis=1), np.full(8, 13))


def test_session_random_walks_original_ids():
    jg, g = GRAPHS["rmat"](jgen), GRAPHS["rmat"](gen)
    want = JSession(jg).plan(num_queries=8, block_size=16).random_walks(
        PICKS, 10, seed=5)
    got = FPPSession(g, device="cpu").plan(
        num_queries=8, block_size=16).random_walks(PICKS, 10, seed=5)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, int):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
    assert got.positions.max() < g.n


def test_sink_walkers_park_in_place():
    """0 -> 1 -> 2 with no out-edges at 2: the walker reaches the sink in
    two steps and parks there with steps = length, as the reference's."""
    kw = dict(indptr=np.array([0, 1, 2, 2], dtype=np.int64),
              indices=np.array([1, 2], dtype=np.int32),
              weights=np.ones(2, dtype=np.float32), n=3, m=2)
    jbg, jperm = jpartition(JCSR(**kw), 2)
    bg, perm = partition(CSRGraph(**kw), 2)
    got = run_random_walks(bg, perm[[0, 2]], 10, seed=0, device="cpu")
    _assert_walks_equal(got, jrun(jbg, jperm[[0, 2]], 10, seed=0))
    np.testing.assert_array_equal(got.steps, [10, 10])
    np.testing.assert_array_equal(got.positions, perm[[2, 2]])


def test_zero_length_is_the_identity():
    jbg, bg, perm = _both("grid")
    srcs = perm[PICKS[:3]]
    got = run_random_walks(bg, srcs, 0, seed=0, device="cpu")
    _assert_walks_equal(got, jrun(jbg, srcs, 0, seed=0))
    np.testing.assert_array_equal(got.positions, srcs)
    assert got.visits == 0 and got.occupancy.sum() == 3


def test_different_seeds_diverge():
    _, bg, perm = _both("er")
    srcs = perm[PICKS]
    a = run_random_walks(bg, srcs, 24, seed=0, device="cpu")
    b = run_random_walks(bg, srcs, 24, seed=1, device="cpu")
    assert not np.array_equal(a.trajectory_hash, b.trajectory_hash)
