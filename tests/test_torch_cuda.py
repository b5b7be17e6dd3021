"""Tests of the port that need a CUDA device; each skips without one.

On the card: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs on a machine without it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import FPPEngine  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.fpp import planner  # noqa: E402
from repro_torch.graphs.generators import grid2d  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402

pytestmark = pytest.mark.cuda

#: masked matmul against a float32 sum in another order
MM_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("q,b", [(64, 128), (7, 32), (130, 16)])
def test_kernels_match_plain_versions(card, q, b):
    """Both kernels launch, count one launch each, and agree with their
    plain versions (min-plus bitwise), negative indices included."""
    rng = np.random.default_rng(q + b)
    d = np.where(rng.random((q, b)) < 0.4, np.inf, rng.uniform(0, 10, (q, b)))
    x = np.where(rng.random((q, b)) < 0.4, 0.0, rng.uniform(0, 1, (q, b)))
    w = np.where(rng.random((4, b, b)) < 0.8, np.inf,
                 rng.uniform(1, 5, (4, b, b)))
    d, x, w = (torch.tensor(a, dtype=torch.float32) for a in (d, x, w))
    idx = torch.tensor([3, -1, 0])
    ops.reset_launches()
    got = ops.minplus(d.to(card), w.to(card), idx.to(card))
    assert torch.equal(got.cpu(), ops.minplus(d, w, idx))
    got = ops.masked_matmul(x.to(card), w.to(card), idx.to(card))
    torch.testing.assert_close(got.cpu(), ops.masked_matmul(x, w, idx),
                               **MM_TOL)
    assert ops.LAUNCHES == {"minplus": 1, "masked_matmul": 1}


@pytest.mark.parametrize("weighted", [True, False])
def test_engine_on_card_bitwise_equals_cpu(card, weighted):
    """sssp (weighted) and bfs (unit weights) on the card equal the CPU
    run in values, edges, stats and visit order."""
    g = grid2d(16, 16, seed=2, weighted=weighted)
    bg, perm = partition(g, 32)
    srcs = perm[np.array([0, 17, 130, 255])]
    yc = planner.default_yield_config("sssp" if weighted else "bfs", bg)
    res = [FPPEngine(bg, num_queries=4, yield_config=yc, k_visits=8,
                     device=dev).run(srcs, record_order=True)
           for dev in (card, "cpu")]
    a, b = res
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.edges_processed, b.edges_processed)
    assert a.stats == b.stats and a.visit_order == b.visit_order
