"""The port's contraction kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX side runs
the Pallas kernels in interpret mode, as the JAX package's own tests do.
Inputs are made with numpy from a seed and handed to both.

Tolerances: min-plus is bitwise (every candidate is the same f32 add and
min is order-free).  The masked matmul is a float32 sum in another order,
held at ``rtol=1e-5, atol=2e-6``: the reference's own two paths differ by up
to 1.9e-6 (ROADMAP C2).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.kernels.minplus import ops as jops  # noqa: E402
from repro_torch.kernels.minplus import ops, ref  # noqa: E402

MM_TOL = dict(rtol=1e-5, atol=2e-6)


def _inputs(seed, q, b, nblk=3):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((q, b)) < 0.4, np.inf,
                 rng.uniform(0, 10, (q, b))).astype(np.float32)
    x = np.where(rng.random((q, b)) < 0.4, 0.0,
                 rng.uniform(0, 1, (q, b))).astype(np.float32)
    w = np.where(rng.random((nblk, b, b)) < 0.8, np.inf,
                 rng.uniform(1, 5, (nblk, b, b))).astype(np.float32)
    return d, x, w


# ragged Q (not a multiple of 8, and past the reference's 128-row q tile)
SHAPES = [(4, 16), (7, 32), (8, 64), (130, 16)]


@pytest.mark.parametrize("q,b", SHAPES)
def test_minplus_ref_bitwise_equals_pallas(q, b):
    d, _, w = _inputs(q * 31 + b, q, b)
    want = np.asarray(jops.minplus_pallas(d, w[0]))
    got = ref.minplus_ref(torch.from_numpy(d), torch.from_numpy(w[0]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q,b", SHAPES)
def test_masked_matmul_ref_matches_pallas(q, b):
    _, x, w = _inputs(q * 17 + b, q, b)
    want = np.asarray(jops.masked_matmul_pallas(x, w[0]))
    got = ref.masked_matmul_ref(torch.from_numpy(x), torch.from_numpy(w[0]))
    np.testing.assert_allclose(got.numpy(), want, **MM_TOL)


@pytest.mark.parametrize("name", ["minplus", "masked_matmul"])
def test_batched_entry_equals_single_calls(name):
    """The batched form over S indices is S single calls stacked, and a
    negative index (neighbour-list padding) gives the identity plane."""
    d, x, w = _inputs(5, 6, 32, nblk=4)
    fn = getattr(ops, name)
    inp = torch.from_numpy(d if name == "minplus" else x)
    blocks = torch.from_numpy(w)
    idx = torch.tensor([2, 0, -1, 3, 2])
    out = fn(inp, blocks, idx)
    assert out.shape == (5, 6, 32) and out.dtype == torch.float32
    for s, k in enumerate(idx.tolist()):
        single = fn(inp, blocks, torch.tensor([k]))[0]
        assert torch.equal(out[s], single), s
    ident = float("inf") if name == "minplus" else 0.0
    assert torch.equal(out[2], torch.full((6, 32), ident))
    plain = (ref.minplus_ref if name == "minplus"
             else ref.masked_matmul_ref)(inp, blocks[3])
    assert torch.equal(out[3], plain)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    d, x, w = _inputs(9, 4, 16)
    ops.reset_launches()
    ops.minplus(torch.from_numpy(d), torch.from_numpy(w), torch.tensor([1]))
    ops.masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                      torch.tensor([1]))
    assert ops.LAUNCHES == {"minplus": 0, "masked_matmul": 0}


def test_wrappers_reject_what_the_kernel_does_not_take():
    d, _, w = _inputs(3, 4, 16)
    dt, wt = torch.from_numpy(d), torch.from_numpy(w)
    idx = torch.tensor([0])
    with pytest.raises(ValueError, match="float32"):
        ops.minplus(dt.double(), wt.double(), idx)
    with pytest.raises(ValueError, match="int64"):
        ops.minplus(dt, wt, idx.int())
    with pytest.raises(ValueError, match="nblk"):
        ops.minplus(dt, wt[:, :8, :8].contiguous(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        ops.minplus(dt.t().contiguous().t(), wt, idx)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.masked_matmul(dt.to("meta"), wt.to("meta"), idx.to("meta"))
