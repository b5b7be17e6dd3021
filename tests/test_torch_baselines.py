"""The baselines backend, the gathered contraction and ``plan(tune=True)``
against the JAX package, on the CPU at small sizes.

* ``global_minplus`` / ``global_push`` and the session's baselines arm for
  sssp, bfs, cc, kreach and ppr: ``rounds``, ``edges_processed``,
  ``modeled_bytes`` and ``modeled_bytes_shared`` exactly; values bitwise
  for the minplus kinds and within the masked-matmul tolerance for ppr
  (ROADMAP C2: the spread's sums reorder across implementations); the
  minplus kinds also bitwise equal to the port's own engine.
* A round is one call of the gathered contraction (``xrow``), whose plain
  version equals S single calls bitwise.
* ``plan(tune=True)``: the tuned B is the argmin of its rows, and each row
  the reference also measures has the reference's visits, traffic and
  edges.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import visit as jvisit  # noqa: E402
from repro.core.partition import partition as jpartition  # noqa: E402
from repro.fpp import FPPSession as JSession  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import baselines, visit  # noqa: E402
from repro_torch.core.engine import column_lists  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.fpp import FPPSession, planner  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402

SRCS = np.array([0, 5, 77, 143])
#: masked matmul against a float32 sum in another order (ROADMAP C2)
MM_TOL = dict(rtol=1e-5, atol=2e-6)
STAT_KEYS = ("rounds", "modeled_bytes", "modeled_bytes_shared")

GRAPHS = {
    "grid": lambda m: m.grid2d(14, 14, seed=3),
    "er": lambda m: m.erdos_renyi(300, avg_deg=1.5, seed=1),
}


@pytest.fixture(scope="module")
def sessions():
    made = {}

    def get(name):
        if name not in made:
            made[name] = (
                JSession(GRAPHS[name](jgen)).plan(num_queries=4,
                                                  block_size=32),
                FPPSession(GRAPHS[name](gen), device="cpu").plan(
                    num_queries=4, block_size=32))
        return made[name]

    return get


@pytest.mark.parametrize("kind", ["sssp", "bfs", "cc", "kreach", "ppr"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_baselines_arm_equals_reference(sessions, name, kind):
    js, ts = sessions(name)
    want = js.run(kind, SRCS, backend="baselines")
    got = ts.run(kind, SRCS, backend="baselines")
    assert got.stats == {k: want.stats[k] for k in STAT_KEYS}
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    if kind == "ppr":
        np.testing.assert_allclose(got.values, want.values, **MM_TOL)
        np.testing.assert_array_equal(got.residual, want.residual)
        return
    np.testing.assert_array_equal(got.values, want.values)
    if kind == "kreach":
        np.testing.assert_array_equal(got.residual, want.residual)
    # the global-frontier fixpoint is the buffered engine's, bit for bit
    eng = ts.run(kind, SRCS)
    np.testing.assert_array_equal(got.values, eng.values)
    if kind == "kreach":
        np.testing.assert_array_equal(got.residual, eng.residual)


def test_baselines_ppr_within_4_eps_of_engine(sessions):
    _, ts = sessions("grid")
    got = ts.run("ppr", SRCS, backend="baselines")
    eng = ts.run("ppr", SRCS)
    deg = np.maximum(ts.graph.out_degree(), 1)
    assert (np.abs(got.values - eng.values) / deg).max() <= 4 * 1e-4


@pytest.mark.parametrize("max_rounds", [1, 3, None])
@pytest.mark.parametrize("cc", [False, True])
def test_global_minplus_equals_reference(max_rounds, cc):
    """The core entry, cut after a few rounds too, with and without the cc
    label plane."""
    jg, g = jgen.grid2d(12, 12, seed=2), gen.grid2d(12, 12, seed=2)
    jbg, jperm = jpartition(jg, 16)
    bg, perm = partition(g, 16)
    np.testing.assert_array_equal(perm, jperm)
    kw = dict(max_rounds=max_rounds)
    jkw = dict(kw)
    if cc:
        kw["init_plane"] = visit.cc_label_plane(bg)
        jkw["init_plane"] = jvisit.cc_label_plane(jbg)
        np.testing.assert_array_equal(kw["init_plane"], jkw["init_plane"])
    want = jbaselines.global_minplus(jbg, perm[SRCS], **jkw)
    got = baselines.global_minplus(bg, perm[SRCS], device="cpu", **kw)
    for f in ("values", "edges_processed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.rounds, got.modeled_bytes, got.modeled_bytes_shared) == (
        want.rounds, want.modeled_bytes, want.modeled_bytes_shared)


@pytest.mark.parametrize("max_rounds", [2, 10_000])
def test_global_push_equals_reference(max_rounds):
    jg, g = jgen.grid2d(12, 12, seed=2), gen.grid2d(12, 12, seed=2)
    jbg, jperm = jpartition(jg, 16)
    bg, perm = partition(g, 16)
    want = jbaselines.global_push(jbg, perm[SRCS], eps=1e-3,
                                  max_rounds=max_rounds)
    got = baselines.global_push(bg, perm[SRCS], eps=1e-3,
                                max_rounds=max_rounds, device="cpu")
    np.testing.assert_allclose(got.values, want.values, **MM_TOL)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert (got.rounds, got.modeled_bytes, got.modeled_bytes_shared) == (
        want.rounds, want.modeled_bytes, want.modeled_bytes_shared)


@pytest.mark.parametrize("kind", ["sssp", "ppr"])
def test_a_round_is_one_gathered_contraction(monkeypatch, kind):
    """No loop over blocks on the host: each round makes exactly one call of
    its contraction, over every block, gathered by ``blk_src``."""
    g = gen.grid2d(12, 12, seed=2)
    bg, perm = partition(g, 16)
    name = "masked_matmul" if kind == "ppr" else "minplus"
    calls = []
    real = getattr(ops, name)

    def counted(x, blocks, idx, lists, xrow=None):
        calls.append((tuple(x.shape), idx.shape[0], xrow))
        return real(x, blocks, idx, lists, xrow=xrow)

    monkeypatch.setattr(ops, name, counted)
    if kind == "ppr":
        res = baselines.global_push(bg, perm[SRCS], eps=1e-3, device="cpu")
    else:
        res = baselines.global_minplus(bg, perm[SRCS], device="cpu")
    assert len(calls) == res.rounds > 1
    nblk = bg.blocks.shape[0]
    for shape, s, xrow in calls:
        assert shape == (bg.num_parts, len(SRCS), 16) and s == nblk
        np.testing.assert_array_equal(xrow.numpy(), bg.blk_src)


@pytest.mark.parametrize("name", ["minplus", "masked_matmul"])
def test_gathered_entry_equals_single_calls(name):
    """The plain version of the gathered form equals one ungathered call per
    s, bit for bit, -1 indices included."""
    rng = np.random.default_rng(3)
    X, Q, B, nblk = 5, 6, 16, 7
    w = np.where(rng.random((nblk, B, B)) < 0.2,
                 rng.uniform(1, 5, (nblk, B, B)), np.inf).astype(np.float32)
    if name == "minplus":
        x = np.where(rng.random((X, Q, B)) < 0.4, np.inf,
                     rng.uniform(0, 10, (X, Q, B)))
    else:
        x = np.where(rng.random((X, Q, B)) < 0.4, 0.0,
                     rng.uniform(0, 1, (X, Q, B)))
    x = torch.tensor(x, dtype=torch.float32)
    blocks = torch.from_numpy(w)
    lists = tuple(torch.from_numpy(a) for a in column_lists(w))
    idx = torch.tensor([3, 0, 6, -1, 2, 3, 5, 1])
    xrow = torch.tensor([0, 4, 2, 1, 2, 3, 0, 4])
    got = getattr(ops, name)(x, blocks, idx, lists, xrow=xrow)
    assert got.shape == (8, Q, B)
    for s in range(8):
        one = getattr(ops, name)(x[xrow[s]], blocks, idx[s:s + 1], lists)
        assert torch.equal(got[s], one[0]), s


@pytest.mark.parametrize("bad,match", [
    (lambda xrow: xrow.to(torch.int32), "xrow must be int64"),
    (lambda xrow: xrow[:2], "xrow must be int64"),
    (lambda xrow: xrow.clone().fill_(5), "xrow must lie in"),
    (lambda xrow: xrow.clone().fill_(-1), "xrow must lie in"),
    (lambda xrow: torch.stack([xrow, xrow], 1)[:, 0], "contiguous"),
])
def test_check_rejects_a_bad_xrow(bad, match):
    X, Q, B = 5, 4, 16
    w = np.full((2, B, B), np.inf, dtype=np.float32)
    lists = tuple(torch.from_numpy(a) for a in column_lists(w))
    x = torch.zeros((X, Q, B))
    idx = torch.tensor([0, 1, 1])
    xrow = torch.tensor([0, 4, 2])
    with pytest.raises(ValueError, match=match):
        ops.minplus(x, torch.from_numpy(w), idx, lists, xrow=bad(xrow))
    with pytest.raises(ValueError, match="float32 \\[X, Q, B\\]"):
        ops.minplus(x[0], torch.from_numpy(w), idx, lists, xrow=xrow)


def _rows(plan):
    return {dict(r)["block_size"]: dict(r) for r in plan.tuning_rows}


@pytest.mark.parametrize("fused", [False, True])
def test_tune_picks_the_argmin_of_rows_equal_to_reference(fused):
    jg, g = jgen.grid2d(16, 16, seed=3), gen.grid2d(16, 16, seed=3)
    ts = FPPSession(g, device="cpu").plan(num_queries=4, tune=True,
                                          fused=fused)
    js = JSession(jg).plan(num_queries=4, tune=True)
    tp, jp = ts.current_plan, js.current_plan
    rows = _rows(tp)
    assert tp.tuned and rows
    best = min(rows.values(), key=lambda r: (r["traffic_bytes"],
                                             r["runtime_s"]))
    assert tp.block_size == best["block_size"]
    # feasibility is the port's own memory model, fused flag included
    assert sorted(rows) == [b for b in planner.CANDIDATE_BLOCK_SIZES
                            if b < g.n and ts.mem.fits(b, 4, g.n,
                                                       fused=fused)]
    common = set(rows) & set(_rows(jp))
    assert common
    for b in common:
        for k in ("visits", "traffic_bytes", "edges_per_q"):
            assert rows[b][k] == _rows(jp)[b][k], (b, k)


def test_untuned_plan_keeps_the_model_choice():
    g = gen.grid2d(16, 16, seed=3)
    sess = FPPSession(g, device="cpu")
    model = sess.plan(num_queries=4).current_plan
    assert not model.tuned and model.tuning_rows == ()
    pinned = sess.plan(num_queries=4, block_size=32, tune=True).current_plan
    assert (pinned.block_size, pinned.tuned) == (32, False)
