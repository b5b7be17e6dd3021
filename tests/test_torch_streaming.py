"""Streaming (``FPPSession.stream``) of the port against the JAX package
and against its own one-shot runs, on the CPU.

A staggered stream (a few sources, some chunks, then the rest) must answer
what the one-shot run of the union answers: bit for bit for the min-plus
kinds (sssp, bfs, cc, kreach) and rw, ppr within its eps tolerance; and
what the reference's stream answers under the same arrivals, bit for bit
for the min-plus kinds and rw (values, edges, visit and sync counts), ppr
within the masked-matmul tolerance (ROADMAP C2).  Unfused and fused (the
fused kernel's plain version on the CPU).  The per-visit ``step()`` path
must agree with the chunked pump, and ``WalkExecutor`` with
``run("rw")``.
"""
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.fpp import FPPSession as JSession  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.fpp import FPPSession  # noqa: E402
from repro_torch.fpp.streaming import StreamingExecutor  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402

SRCS = np.array([0, 40, 80, 120, 143, 7])
EPS = 1e-3
PPR_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(scope="module")
def sessions():
    jg, g = jgen.grid2d(12, 12, seed=6), gen.grid2d(12, 12, seed=6)
    return (JSession(jg).plan(num_queries=len(SRCS), block_size=32),
            FPPSession(g, device="cpu").plan(num_queries=len(SRCS),
                                             block_size=32), g)


def _staggered(sess, kind, fused, K, **kw):
    ex = sess.stream(kind, capacity=4, eps=EPS, k_visits=K, fused=fused,
                     **kw)
    qids = ex.submit(SRCS[:3])
    ex.pump(3)                      # in-flight work between arrivals
    qids += ex.submit(SRCS[3:])
    out = ex.run()
    return ex, [out[q] for q in qids], [ex.result(q) for q in qids]


@pytest.mark.parametrize("kind,K", [("sssp", 1), ("sssp", 8), ("bfs", 8),
                                    ("ppr", 8), ("cc", 8), ("kreach", 4)])
@pytest.mark.parametrize("fused", [False, True])
def test_staggered_stream_equals_one_shot_and_reference(sessions, kind, K,
                                                        fused):
    js, ts, g = sessions
    ex, got, res = _staggered(ts, kind, fused, K)
    jex, want, jres = _staggered(js, kind, fused, K)
    one = ts.run(kind, SRCS, eps=EPS, fused=fused)
    assert len(got) == len(SRCS)
    assert ex.host_syncs <= -(-ex.visits // K) + 4
    assert (ex.visits, ex.host_syncs) == (jex.visits, jex.host_syncs)
    deg = np.maximum(g.out_degree(), 1)
    for i in range(len(SRCS)):
        if kind == "ppr":
            assert (np.abs(got[i] - one.values[i]) / deg).max() <= 4 * EPS
            np.testing.assert_allclose(got[i], want[i], **PPR_TOL)
            continue
        np.testing.assert_array_equal(got[i], one.values[i])
        np.testing.assert_array_equal(got[i], want[i])
        assert res[i].edges == jres[i].edges
        if kind == "kreach":
            np.testing.assert_array_equal(res[i].residual, one.residual[i])


@pytest.mark.parametrize("fused", [False, True])
def test_step_path_equals_chunked_pump(sessions, fused):
    _, ts, _ = sessions
    chunked = ts.stream("sssp", capacity=3, fused=fused)
    chunked.submit(SRCS)
    out_pump = chunked.run()
    stepped = ts.stream("sssp", capacity=3, harvest_every=2, fused=fused)
    stepped.submit(SRCS)
    while stepped.step():
        pass
    stepped._harvest()
    out_step = {qid: q.values for qid, q in stepped.queries.items()
                if q.done}
    assert set(out_pump) == set(out_step) == set(range(len(SRCS)))
    for qid in out_pump:
        np.testing.assert_array_equal(out_pump[qid], out_step[qid])
    done = stepped.take_finished()
    assert sorted(done) == sorted(out_step) and stepped.take_finished() == []
    assert [stepped.result(q).finished_visit for q in done] == sorted(
        stepped.result(q).finished_visit for q in done)


def test_walk_executor_equals_run_rw_and_reference(sessions):
    """Six walkers through three lanes (lanes recycle) walk the one-shot
    run's walks, bit for bit, and the reference executor's."""
    js, ts, _ = sessions
    ex = ts.stream("rw", capacity=3, length=10, seed=2)
    jex = js.stream("rw", capacity=3, length=10, seed=2)
    qids = ex.submit(SRCS[:2])
    jqids = jex.submit(SRCS[:2])
    ex.pump(2)
    jex.pump(2)
    qids += ex.submit(SRCS[2:])
    jqids += jex.submit(SRCS[2:])
    out, jout = ex.run(), jex.run()
    one = ts.run("rw", SRCS, length=10, seed=2)
    for i, (q, jq) in enumerate(zip(qids, jqids)):
        np.testing.assert_array_equal(out[q], one.values[i])
        np.testing.assert_array_equal(out[q], jout[jq])
        assert ex.result(q).edges == jex.result(jq).edges == 10
    assert (ex.visits, ex.host_syncs) == (jex.visits, jex.host_syncs)


def test_random_schedule_stream_equals_one_shot(sessions):
    _, ts, _ = sessions
    ex = ts.stream("sssp", capacity=4, schedule="random", k_visits=4,
                   fused=True)
    qids = ex.submit(SRCS)
    out = ex.run()
    one = ts.run("sssp", SRCS)
    for i, q in enumerate(qids):
        np.testing.assert_array_equal(out[q], one.values[i])


def test_empty_run_and_bad_kind(sessions):
    _, ts, _ = sessions
    ex = ts.stream("sssp", capacity=2)
    assert ex.run() == {} and ex.visits == 0
    with pytest.raises(ValueError, match="WalkExecutor"):
        StreamingExecutor(ts, kind="rw")


def test_foreign_thread_submits_join_at_chunk_boundaries(sessions):
    """Submitters on other threads while one thread pumps: every query is
    answered with its one-shot values."""
    _, ts, _ = sessions
    ex = ts.stream("sssp", capacity=2, k_visits=4)
    qids, errors = [], []

    def submit(batch):
        try:
            qids.extend(zip(batch, ex.submit(batch)))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=submit, args=(SRCS[i::3],))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    out = ex.run()
    assert errors == [] and len(qids) == len(SRCS)
    one = ts.run("sssp", SRCS)
    for s, q in qids:
        i = int(np.flatnonzero(SRCS == s)[0])
        np.testing.assert_array_equal(out[q], one.values[i])
