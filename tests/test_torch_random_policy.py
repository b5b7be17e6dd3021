"""The ``random`` scheduling policy of the port against the JAX package on
the CPU.

The reference draws the policy's choice on the device from a threefry key
split once per visit; the port draws the same bits (``core/prng``), so:

* ``device_select("random")`` picks the reference's partition under the
  same key sequence (the trials of ``tests/test_megastep.py``);
* ``FPPEngine(schedule="random", seed=s)``, unfused and fused (the fused
  kernel's plain version on the CPU), visits in the reference's order and
  gives its sssp/bfs values, edges and stats bit for bit; ppr's values
  within the masked-matmul tolerance (ROADMAP C2) and its order exactly;
* the order does not depend on the chunk size (K = 1, 8, 64): the key is
  split only when a partition is pending.
"""
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
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import prng, visit  # noqa: E402
from repro_torch.core.engine import DeviceGraph, FPPEngine  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.core.scheduler import (PartitionScheduler,  # noqa: E402
                                        device_select)
from repro_torch.core.yielding import YieldConfig  # noqa: E402
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

SRCS = np.array([0, 5, 77, 143])
#: ppr against the reference: float32 sums in another order (C2)
PPR_TOL = dict(rtol=1e-5, atol=2e-6)


def test_device_select_random_equals_reference_under_one_key_stream():
    rng = np.random.default_rng(3)
    jkey, key = jax.random.PRNGKey(0), prng.PRNGKey(0)
    for trial in range(20):
        P = int(rng.integers(2, 17))
        prio = np.where(rng.random(P) < 0.4, np.inf,
                        rng.integers(0, 4, P)).astype(np.float32)
        if not np.isfinite(prio).any():
            prio[int(rng.integers(P))] = 1.0
        stamp = np.where(np.isfinite(prio), rng.integers(0, 3, P),
                         np.iinfo(np.int32).max - 1).astype(np.int32)
        ops = np.where(np.isfinite(prio), rng.integers(1, 4, P),
                       0).astype(np.int32)
        for policy in ("priority", "fifo", "max_ops"):
            want = PartitionScheduler(policy, P).select(prio, stamp, ops)
            got = device_select(policy, *(torch.from_numpy(a) for a in
                                          (prio, stamp, ops)))
            assert int(got) == want, (trial, policy)
        jkey, jsub = jax.random.split(jkey)
        key, sub = prng.split(key)
        want = int(jvisit.device_select("random", jnp.asarray(prio),
                                        jnp.asarray(stamp),
                                        jnp.asarray(ops), jsub))
        got = device_select("random", *(torch.from_numpy(a) for a in
                                        (prio, stamp, ops)), sub)
        assert int(got) == want and np.isfinite(prio[want]), trial
    with pytest.raises(ValueError, match="threefry key"):
        device_select("random", torch.from_numpy(prio),
                      torch.from_numpy(stamp), torch.from_numpy(ops))


def _setup(name, kind):
    mk = {"grid": lambda m: m.grid2d(12, 12, seed=3,
                                     weighted=(kind != "bfs")),
          "rmat": lambda m: m.rmat(8, 6, seed=5)}[name]
    jbg, jperm = jpartition(mk(jgen), 16)
    bg, _ = partition(mk(gen), 16)
    return jbg, bg, jperm[SRCS]


@pytest.mark.parametrize("name", ["grid", "rmat"])
@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr"])
@pytest.mark.parametrize("fused", [False, True])
def test_random_engine_equals_reference(name, kind, fused):
    jbg, bg, srcs = _setup(name, kind)
    mode = "push" if kind == "ppr" else "minplus"
    delta = {"sssp": 2.0, "bfs": 1.0, "ppr": None}[kind]
    kw = dict(mode=mode, num_queries=len(srcs), schedule="random", seed=5,
              k_visits=8, fused=fused, eps=1e-3)
    want = jengine.FPPEngine(jbg, yield_config=JYieldConfig(delta=delta),
                             **kw).run(srcs, record_order=True)
    got = FPPEngine(bg, yield_config=YieldConfig(delta=delta), device="cpu",
                    **kw).run(srcs, record_order=True)
    assert got.visit_order == list(want.visit_order)
    assert (got.stats.visits, got.stats.rounds, got.stats.host_syncs) == (
        want.stats.visits, want.stats.rounds, want.stats.host_syncs)
    if kind == "ppr":
        np.testing.assert_allclose(got.values, np.asarray(want.values),
                                   **PPR_TOL)
        return
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)


@pytest.mark.parametrize("fused", [False, True])
def test_random_order_does_not_depend_on_chunk_size(fused):
    _, bg, srcs = _setup("grid", "sssp")
    runs = [FPPEngine(bg, num_queries=len(srcs), schedule="random", seed=2,
                      k_visits=K, fused=fused,
                      yield_config=YieldConfig(delta=2.0),
                      device="cpu").run(srcs, record_order=True)
            for K in (1, 8, 64)]
    for r in runs[1:]:
        assert r.visit_order == runs[0].visit_order
        np.testing.assert_array_equal(r.values, runs[0].values)
    # the random order is not the priority order, and its values are
    prio = FPPEngine(bg, num_queries=len(srcs), k_visits=64, fused=fused,
                     yield_config=YieldConfig(delta=2.0),
                     device="cpu").run(srcs, record_order=True)
    assert prio.visit_order != runs[0].visit_order
    np.testing.assert_array_equal(prio.values, runs[0].values)


@pytest.mark.parametrize("fused", [False, True])
def test_megastep_carries_the_key_and_leaves_its_argument(fused):
    """Each visit splits the key once; a chunk that finds nothing pending
    returns it unsplit; the caller's key tensor is never written."""
    _, bg, srcs = _setup("grid", "sssp")
    dg = DeviceGraph.build(bg, YieldConfig(delta=2.0), len(srcs),
                           device="cpu")
    alg = visit.minplus_algebra(2.0)
    mega = visit.make_megastep(dg, alg, 16, policy="random", K=3,
                               fused=fused)
    state = visit.init_engine_state(alg, dg, srcs)
    key = prng.PRNGKey(9)
    state, ms = mega(state, 0, 3, key)
    assert ms.visits == 3 and torch.equal(key, prng.PRNGKey(9))
    want = prng.PRNGKey(9)
    for _ in range(3):
        want = prng.split(want)[0]
    assert torch.equal(ms.key, want)
    empty = visit.init_engine_state(alg, dg, np.empty(0, dtype=np.int64),
                                    num_queries=len(srcs))
    _, ms2 = mega(empty, 3, 3, ms.key)
    assert ms2.visits == 0 and torch.equal(ms2.key, want)
    with pytest.raises(ValueError, match="threefry key"):
        mega(empty, 0, 3)


def test_session_random_schedule_equals_reference():
    """The session runs the random schedule at the engine's default seed,
    as the reference's does; fused and unfused."""
    jg, g = jgen.rmat(8, 6, seed=5), gen.rmat(8, 6, seed=5)
    for fused in (False, True):
        js = JSession(jg).plan(num_queries=4, block_size=16,
                               schedule="random", fused=fused)
        ts = FPPSession(g, device="cpu").plan(num_queries=4, block_size=16,
                                              schedule="random", fused=fused)
        for kind in ("sssp", "kreach", "cc"):
            want, got = js.run(kind, SRCS), ts.run(kind, SRCS)
            np.testing.assert_array_equal(got.values,
                                          np.asarray(want.values))
            assert got.stats["visits"] == want.stats["visits"]
