"""The port's kernels' plain versions against the JAX package's Pallas
kernels: the contractions, the frontier and the push round.

On the CPU the port's wrappers run their plain versions; the JAX side runs
the Pallas kernels in interpret mode, as the JAX package's own tests do.
Inputs are made with numpy from a seed and handed to both.

Tolerances: min-plus and the frontier are bitwise (every candidate is the
same f32 add, and min and compare are exact).  The masked matmul, and the
push round that spreads through it, are float32 sums in another order, held
at ``rtol=1e-5, atol=2e-6``: the reference's own two paths differ by up to
1.9e-6 (ROADMAP C2).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.frontier import ops as jfops  # noqa: E402
from repro.kernels.frontier.frontier import frontier_tile  # noqa: E402
from repro.kernels.minplus import ops as jops  # noqa: E402
from repro.kernels.ppr_push import ops as jpops  # noqa: E402
from repro.kernels.ppr_push.push import push_tile  # noqa: E402
from repro_torch.core.engine import (blocks_from_lists,  # noqa: E402
                                     column_lists)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier import ops as fops  # noqa: E402
from repro_torch.kernels.frontier.ref import frontier_ref  # noqa: E402
from repro_torch.kernels.minplus import ops, ref  # noqa: E402
from repro_torch.kernels.ppr_push import ops as pops  # noqa: E402
from repro_torch.kernels.ppr_push.ref import push_ref  # noqa: E402

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


def _lists(w):
    """The blocks ``w`` as the kernels' column lists, torch tensors."""
    return tuple(torch.from_numpy(a) for a in column_lists(w))


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
    blocks, lists = torch.from_numpy(w), _lists(w)
    idx = torch.tensor([2, 0, -1, 3, 2])
    out = fn(inp, blocks, idx, lists)
    assert out.shape == (5, 6, 32) and out.dtype == torch.float32
    for s, k in enumerate(idx.tolist()):
        single = fn(inp, blocks, torch.tensor([k]), lists)[0]
        assert torch.equal(out[s], single), s
    ident = float("inf") if name == "minplus" else 0.0
    assert torch.equal(out[2], torch.full((6, 32), ident))
    plain = (ref.minplus_ref if name == "minplus"
             else ref.masked_matmul_ref)(inp, blocks[3])
    assert torch.equal(out[3], plain)


def test_cpu_wrappers_take_the_plain_version_and_count_no_launch():
    d, x, w = _inputs(9, 4, 16)
    blocks, lists, idx = torch.from_numpy(w), _lists(w), torch.tensor([1, -1])
    ops.reset_launches()
    for name, inp in (("minplus", d), ("masked_matmul", x)):
        inp = torch.from_numpy(inp)
        got = getattr(ops, name)(inp, blocks, idx, lists)
        assert torch.equal(got, ops.plain(name, inp, blocks, idx))
    assert ops.LAUNCHES == {"minplus": 0, "masked_matmul": 0}


@pytest.mark.parametrize("name", ["minplus", "masked_matmul"])
def test_wrappers_take_no_call_without_lists(name):
    """The lists have no default: a caller cannot leave them out."""
    d, _, w = _inputs(4, 4, 16)
    with pytest.raises(TypeError, match="lists"):
        getattr(ops, name)(torch.from_numpy(d), torch.from_numpy(w),
                           torch.tensor([0]))


def test_wrappers_reject_what_the_kernel_does_not_take():
    d, _, w = _inputs(3, 4, 16)
    dt, wt, lists = torch.from_numpy(d), torch.from_numpy(w), _lists(w)
    idx = torch.tensor([0])
    with pytest.raises(ValueError, match="float32"):
        ops.minplus(dt.double(), wt.double(), idx, lists)
    with pytest.raises(ValueError, match="int64"):
        ops.minplus(dt, wt, idx.int(), lists)
    with pytest.raises(ValueError, match="nblk"):
        ops.minplus(dt, wt[:, :8, :8].contiguous(), idx, lists)
    with pytest.raises(ValueError, match="contiguous"):
        ops.minplus(dt.t().contiguous().t(), wt, idx, lists)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.masked_matmul(dt.to("meta"), wt.to("meta"), idx.to("meta"),
                          tuple(a.to("meta") for a in lists))


def _bad_lists(case, lists):
    col_ptr, col_u, col_w = lists
    return {
        "col_ptr int64": (col_ptr.long(), col_u, col_w),
        "col_u int64": (col_ptr, col_u.long(), col_w),
        "col_w float64": (col_ptr, col_u, col_w.double()),
        "col_ptr rows": (col_ptr[1:], col_u, col_w),
        "col_ptr width": (col_ptr[:, 1:].contiguous(), col_u, col_w),
        "col_w length": (col_ptr, col_u, col_w[1:]),
        "on another device": (col_ptr, col_u.to("meta"), col_w),
        "not contiguous": (col_ptr.t().contiguous().t(), col_u, col_w),
        "two lists": (col_ptr, col_u),
    }[case]


@pytest.mark.parametrize("case,match", [
    ("col_ptr int64", "int32, int32 and float32"),
    ("col_u int64", "int32, int32 and float32"),
    ("col_w float64", "int32, int32 and float32"),
    ("col_ptr rows", r"blocks must be float32 \[nblk, B, B\] = "
                     r"\(2, 16, 16\) to match the lists"),
    ("col_ptr width", r"col_ptr must be \[nblk, B\+1\] with B = 16"),
    ("col_w length", r"\[nnz\] each"),
    ("on another device", "share a device"),
    ("not contiguous", "contiguous"),
    ("two lists", r"\(col_ptr, col_u, col_w\)"),
])
def test_wrappers_reject_lists_the_kernel_does_not_take(case, match):
    """Checked before the device branch, so the CPU path rejects them
    too."""
    d, x, w = _inputs(8, 4, 16)
    bad = _bad_lists(case, _lists(w))
    for name, inp in (("minplus", d), ("masked_matmul", x)):
        with pytest.raises(ValueError, match=match):
            getattr(ops, name)(torch.from_numpy(inp), torch.from_numpy(w),
                               torch.tensor([0, -1]), bad)


@pytest.mark.parametrize("name", ["minplus", "masked_matmul"])
def test_cpu_wrappers_need_the_dense_blocks(name):
    """The plain version contracts the dense blocks; only a card call may
    leave them out."""
    d, _, w = _inputs(5, 4, 16)
    with pytest.raises(ValueError, match="CPU path contracts the dense"):
        getattr(ops, name)(torch.from_numpy(d), None, torch.tensor([0]),
                           _lists(w))


@pytest.mark.parametrize("density", [0.0, 4.0 / 30, 0.25, 1.0])
def test_blocks_from_lists_bitwise_equals_blocks(density):
    """The dense blocks rebuilt from their column lists (what a plain
    version on the card contracts) are the blocks bit for bit, empty
    columns and a fully finite block included."""
    rng = np.random.default_rng(int(density * 100))
    w = np.where(rng.random((5, 30, 30)) < density,
                 rng.uniform(0, 10, (5, 30, 30)), np.inf).astype(np.float32)
    w[1] = np.inf
    w[3] = rng.uniform(0, 10, (30, 30))
    got = blocks_from_lists(*_lists(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  w.view(np.int32))


def _frontier_inputs(seed, q, b):
    """Buffered ops over a half-settled distance row, with ties buf == dist
    (where strict and non-strict pending differ)."""
    rng = np.random.default_rng(seed)
    dist = np.where(rng.random((q, b)) < 0.4, np.inf,
                    rng.integers(0, 12, (q, b))).astype(np.float32)
    buf = np.where(rng.random((q, b)) < 0.5, np.inf,
                   rng.integers(0, 12, (q, b))).astype(np.float32)
    tie = rng.random((q, b)) < 0.1
    buf[tie] = dist[tie]
    return buf, dist


@pytest.mark.parametrize("q,b", SHAPES)
def test_frontier_ref_bitwise_equals_pallas(q, b):
    buf, dist = _frontier_inputs(q * 13 + b, q, b)
    want = jfops.frontier_pallas(buf, dist, delta=3.0)
    d1, srcs, alpha, _, _ = frontier_ref(torch.from_numpy(buf),
                                         torch.from_numpy(dist), delta=3.0)
    for got, w in zip((d1, srcs, alpha[:, 0]), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("strict", [False, True])
def test_frontier_ref_bitwise_equals_frontier_tile(strict):
    buf, dist = _frontier_inputs(11, 9, 32)
    want = frontier_tile(jnp.asarray(buf), jnp.asarray(dist), delta=2.0,
                         strict=strict)
    got = frontier_ref(torch.from_numpy(buf), torch.from_numpy(dist),
                       delta=2.0, strict=strict)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _push_inputs(seed, q, b):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1e-2, (q, b)).astype(np.float32)
    r = np.where(rng.random((q, b)) < 0.5, 0.0,
                 rng.uniform(0, 2e-3, (q, b))).astype(np.float32)
    acc = rng.uniform(0, 1e-3, (q, b)).astype(np.float32)
    w = np.where(rng.random((b, b)) < 0.8, np.inf,
                 rng.uniform(1, 5, (b, b))).astype(np.float32)
    deg = rng.integers(0, 6, b).astype(np.int32)
    return p, r, acc, w, deg


@pytest.mark.parametrize("q,b", SHAPES)
def test_push_ref_matches_pallas(q, b):
    p, r, acc, w, deg = _push_inputs(q * 5 + b, q, b)
    want = jpops.ppr_push_pallas(p, r, acc, w, deg.astype(np.float32),
                                 alpha=0.15, eps=1e-4)
    got = push_ref(*(torch.from_numpy(x) for x in (p, r, acc, w, deg)),
                   alpha=0.15, eps=1e-4)
    for g, w_ in zip(got[:3], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **MM_TOL)


def test_push_ref_lane_mask_matches_push_tile():
    p, r, acc, w, deg = _push_inputs(3, 8, 32)
    lane = np.random.default_rng(4).random((8, 1)) < 0.5
    want = push_tile(*(jnp.asarray(x) for x in (p, r, acc, w, deg)),
                     alpha=0.15, eps=1e-4, lane_mask=jnp.asarray(lane))
    got = push_ref(*(torch.from_numpy(x) for x in (p, r, acc, w, deg)),
                   alpha=0.15, eps=1e-4, lane_mask=torch.from_numpy(lane))
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **MM_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert not got[3][~torch.from_numpy(lane)[:, 0]].any()


def test_tile_wrappers_on_cpu_take_the_plain_version():
    """On a CPU tensor the frontier and push wrappers run their plain
    versions, count no launch, and return the standalone kernels'
    outputs."""
    buf, dist = (torch.from_numpy(x) for x in _frontier_inputs(2, 5, 16))
    fops.reset_launches()
    pops.reset_launches()
    d1, srcs, prio = fops.frontier(buf, dist, delta=1.0)
    want = frontier_ref(buf, dist, delta=1.0)
    assert torch.equal(d1, want[0]) and torch.equal(srcs, want[1])
    assert torch.equal(prio, want[2][:, 0])
    p, r, acc, w, deg = (torch.from_numpy(x)
                         for x in _push_inputs(6, 5, 16))
    out = pops.ppr_push(p, r, acc, w, deg[None], alpha=0.15, eps=1e-4)
    want = push_ref(p, r, acc, w, deg.float(), alpha=0.15, eps=1e-4)
    assert len(out) == 3
    for g, w_ in zip(out, want[:3]):
        assert torch.equal(g, w_)
    assert fops.LAUNCHES == {"frontier": 0}
    assert pops.LAUNCHES == {"ppr_push": 0}
    with pytest.raises(ValueError, match="float32"):
        fops.frontier(buf.double(), dist.double(), delta=1.0)
    with pytest.raises(ValueError, match=r"w must be \[16, 16\]"):
        pops.ppr_push(p, r, acc, w[:8], deg, alpha=0.15, eps=1e-4)


@pytest.mark.parametrize("same_header", [True, False])
def test_build_target_hashes_the_headers(tmp_path, same_header):
    """An edited header gives the library another name, so it is rebuilt;
    no compiler is run."""
    names = []
    for i in range(2):
        d = tmp_path / f"csrc{i}"
        d.mkdir()
        (d / "k.cu").write_text('#include "t.cuh"\nint f() { return X; }\n')
        (d / "t.cuh").write_text(
            "#define X 1\n" if same_header or i == 0 else "#define X 2\n")
        names.append(_build._target(d / "k.cu").name)
    assert (names[0] == names[1]) == same_header
    assert names[0].startswith("libk-")


def test_build_target_hashes_a_sources_own_flags(tmp_path, monkeypatch):
    """A source's extra flags (``EXTRA_FLAGS``) rename its library and no
    other's; no compiler is run."""
    for stem in ("k", "j"):
        (tmp_path / f"{stem}.cu").write_text("int f() { return 1; }\n")
    monkeypatch.setattr(_build, "EXTRA_FLAGS", {})
    before = {s: _build._target(tmp_path / f"{s}.cu").name for s in "kj"}
    monkeypatch.setattr(_build, "EXTRA_FLAGS", {"k": ("-DFG_EXTRA",)})
    after = {s: _build._target(tmp_path / f"{s}.cu").name for s in "kj"}
    assert after["k"] != before["k"] and after["j"] == before["j"]
    assert _build._flags(tmp_path / "k.cu")[-1] == "-DFG_EXTRA"
