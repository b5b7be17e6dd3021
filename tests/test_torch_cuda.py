"""Tests of the port that need a CUDA device; each skips without one.

On the card: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs on a machine without it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import FPPEngine, column_lists  # noqa: E402
from repro_torch.core.partition import partition  # noqa: E402
from repro_torch.fpp import planner  # noqa: E402
from repro_torch.graphs.generators import grid2d  # noqa: E402
from repro_torch.kernels.minplus import ops  # noqa: E402
from repro_torch.kernels.minplus.ref import list_contract_ref  # noqa: E402

pytestmark = pytest.mark.cuda

#: masked matmul against a float32 sum in another order
MM_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("density", ["road", "hub", "full"])
@pytest.mark.parametrize("q,b", [(64, 128), (7, 32), (130, 16), (9, 256)])
def test_kernels_match_plain_versions(card, q, b, density):
    """Both kernels launch, count one launch each, and agree with their
    plain versions on the dense blocks (min-plus bitwise, the masked matmul
    at MM_TOL and bitwise with the list order the fused visit shares), at
    ~4 finite entries a column, 25 % and every entry finite; a -1 index
    gives the identity plane and an index past nblk a NaN plane.  At
    B = 256 fully finite, a CTA's list segment (8,192 entries) exceeds
    what it stages, so the kernel walks the lists in global memory."""
    rng = np.random.default_rng(q + b)
    dens = {"road": 4.0 / b, "hub": 0.25, "full": 1.0}[density]
    d = np.where(rng.random((q, b)) < 0.4, np.inf, rng.uniform(0, 10, (q, b)))
    x = np.where(rng.random((q, b)) < 0.4, 0.0, rng.uniform(0, 1, (q, b)))
    w = np.where(rng.random((4, b, b)) < dens, rng.uniform(1, 5, (4, b, b)),
                 np.inf)
    d, x, w = (torch.tensor(a, dtype=torch.float32) for a in (d, x, w))
    lists = tuple(torch.from_numpy(a) for a in column_lists(w.numpy()))
    on_card = tuple(a.to(card) for a in lists)
    idx = torch.tensor([3, -1, 0])
    ops.reset_launches()
    got = ops.minplus(d.to(card), w.to(card), idx.to(card), on_card)
    assert torch.equal(got.cpu(), ops.minplus(d, w, idx, lists))
    got = ops.masked_matmul(x.to(card), w.to(card), idx.to(card), on_card)
    torch.testing.assert_close(got.cpu(), ops.masked_matmul(x, w, idx, lists),
                               **MM_TOL)
    assert torch.equal(got.cpu(),
                       list_contract_ref("masked_matmul", x, *lists, idx))
    assert ops.LAUNCHES == {"minplus": 1, "masked_matmul": 1}
    bad = torch.tensor([4, -1], device=card)
    for name, inp, ident in (("minplus", d, float("inf")),
                             ("masked_matmul", x, 0.0)):
        out = getattr(ops, name)(inp.to(card), w.to(card), bad, on_card)
        assert out[0].isnan().all() and (out[1] == ident).all()


@pytest.mark.parametrize("fused", [False, True])
def test_card_graph_stages_no_dense_blocks(card, fused):
    """On the card the device graph holds the blocks as column lists only:
    a run, unfused or fused, reads no dense block, and the blocks a plain
    comparison rebuilds from the lists are the CPU's bit for bit."""
    g = grid2d(16, 16, seed=2)
    bg, perm = partition(g, 32)
    srcs = perm[np.array([0, 17, 130, 255])]
    yc = planner.default_yield_config("sssp", bg)
    eng = FPPEngine(bg, num_queries=4, yield_config=yc, k_visits=8,
                    fused=fused, device=card)
    assert eng.dg.blocks is None
    eng.run(srcs)
    assert eng.dg.blocks is None
    cpu = FPPEngine(bg, num_queries=4, yield_config=yc, device="cpu").dg
    assert torch.equal(eng.dg.dense_blocks().cpu(), cpu.blocks)


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


def _frontier_inputs(rng, q, b):
    buf = np.where(rng.random((q, b)) < 0.5, np.inf,
                   rng.uniform(0, 20, (q, b)))
    dist = np.where(rng.random((q, b)) < 0.3, np.inf,
                    rng.uniform(0, 20, (q, b)))
    return (torch.tensor(a, dtype=torch.float32) for a in (buf, dist))


@pytest.mark.parametrize("q,b", [(64, 128), (7, 32), (130, 16), (5, 30)])
def test_frontier_and_push_kernels_match_plain_versions(card, q, b):
    """fg_frontier is bitwise equal to its plain version; fg_ppr_push
    agrees with its float32-matmul plain version at the masked-matmul
    tolerance.  Each counts one launch."""
    from repro_torch.kernels.frontier import ops as fops
    from repro_torch.kernels.ppr_push import ops as pops
    rng = np.random.default_rng(q * 7 + b)
    buf, dist = _frontier_inputs(rng, q, b)
    fops.reset_launches()
    pops.reset_launches()
    got = fops.frontier(buf.to(card), dist.to(card), delta=3.0)
    want = fops.frontier(buf, dist, delta=3.0)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    p, r, acc = (torch.tensor(rng.uniform(0, 1e-2, (q, b)) * (rng.random(
        (q, b)) < 0.5), dtype=torch.float32) for _ in range(3))
    w = torch.tensor(np.where(rng.random((b, b)) < 0.8, np.inf,
                              rng.uniform(1, 5, (b, b))), dtype=torch.float32)
    deg = torch.tensor(rng.integers(0, 6, b), dtype=torch.int32)
    got = pops.ppr_push(*(x.to(card) for x in (p, r, acc, w, deg)),
                        alpha=0.15, eps=1e-4)
    want = pops.ppr_push(p, r, acc, w, deg, alpha=0.15, eps=1e-4)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g.cpu(), w_, **MM_TOL)
    assert fops.LAUNCHES == {"frontier": 1}
    assert pops.LAUNCHES == {"ppr_push": 1}


def _fused_setup(kind, ragged=False):
    """grid2d(16, 16), B=32 and 4 sources; ``ragged``: B=30 and 7 sources,
    so neither the query rows nor the block's columns fill the kernel's
    4x4 tiles."""
    g = grid2d(16, 16, seed=2, weighted=(kind == "sssp"))
    bg, perm = partition(g, 30 if ragged else 32)
    picks = [0, 17, 130, 255, 40, 99, 201] if ragged else [0, 17, 130, 255]
    return bg, perm[np.array(picks)], planner.default_yield_config(kind, bg)


def _run(bg, srcs, yc, kind, dev, **kw):
    mode = "push" if kind == "ppr" else "minplus"
    return FPPEngine(bg, mode=mode, num_queries=len(srcs), yield_config=yc,
                     k_visits=8, eps=1e-3, device=dev, **kw).run(
                         srcs, record_order=True)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr"])
def test_fused_on_card_bitwise_equals_unfused_on_card(card, kind, ragged):
    """One launch of fg_fused_visit per K-visit chunk gives the unfused
    card run's bits: values (and ppr residuals), edges, visits, rounds,
    order; the fused run reads the device once per chunk."""
    from repro_torch.kernels.fused_visit import ops as fvops
    bg, srcs, yc = _fused_setup(kind, ragged)
    want = _run(bg, srcs, yc, kind, card)
    fvops.reset_launches()
    got = _run(bg, srcs, yc, kind, card, fused=True)
    np.testing.assert_array_equal(got.values, want.values)
    if kind == "ppr":
        np.testing.assert_array_equal(got.residual, want.residual)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert got.visit_order == want.visit_order
    assert (got.stats.visits, got.stats.rounds) == (want.stats.visits,
                                                    want.stats.rounds)
    assert got.stats.device_syncs == got.stats.host_syncs
    assert fvops.LAUNCHES["fused_visit"] == got.stats.host_syncs
    if kind != "ppr":
        sparse = _run(bg, srcs, yc, kind, card, fused=True,
                      frontier_mode="sparse")
        np.testing.assert_array_equal(sparse.values, want.values)
        assert sparse.visit_order == want.visit_order


@pytest.mark.parametrize("q,b", [(12, 32), (64, 32), (60, 30)])
@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr"])
def test_fused_cluster_on_card_bitwise_equals_unfused(card, kind, q, b):
    """Clusters of 4 (Q=12: 3 rows per CTA) and 8 (Q=64; Q=60 at B=30:
    ragged rows, a CTA with none, copies by the threads instead of bulk
    copies) give the unfused card run's bits, one launch per chunk."""
    from repro_torch.kernels.fused_visit import ops as fvops
    g = grid2d(16, 16, seed=2, weighted=(kind == "sssp"))
    bg, perm = partition(g, b)
    srcs = perm[np.random.default_rng(q).choice(g.n, q, replace=False)]
    yc = planner.default_yield_config(kind, bg)
    want = _run(bg, srcs, yc, kind, card)
    fvops.reset_launches()
    got = _run(bg, srcs, yc, kind, card, fused=True)
    np.testing.assert_array_equal(got.values, want.values)
    if kind == "ppr":
        np.testing.assert_array_equal(got.residual, want.residual)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert got.visit_order == want.visit_order
    assert (got.stats.visits, got.stats.rounds) == (want.stats.visits,
                                                    want.stats.rounds)
    assert fvops.LAUNCHES["fused_visit"] == got.stats.host_syncs


@pytest.mark.parametrize("cluster", [1, 4, 8])
@pytest.mark.parametrize("kind", ["sssp", "ppr"])
def test_fused_launch_at_each_cluster_size_matches_plain(card, kind,
                                                         cluster):
    """One launch of up to K=8 visits at every compiled cluster size, from
    a mid-run state at Q=12 (a cluster of 8 leaves two CTAs without
    rows): min-plus bitwise against 8 visits of the plain version on the
    card; push bitwise against 8 visits of the unfused card megastep, and
    one visit within the masked-matmul tolerance of the plain version."""
    from repro_torch.core.visit import VisitState, make_megastep
    from repro_torch.kernels.fused_visit import ops as fvops
    g = grid2d(16, 16, seed=2)
    bg, perm = partition(g, 32)
    srcs = perm[np.random.default_rng(1).choice(g.n, 12, replace=False)]
    mode = "push" if kind == "ppr" else "minplus"
    eng = FPPEngine(bg, mode=mode, num_queries=12, k_visits=8, eps=1e-3,
                    fused=True, device=card,
                    yield_config=planner.default_yield_config(kind, bg))
    state, _ = eng._megastep(eng.init_state(srcs), 0, 8)
    fv = fvops.make_fused_visit(eng.dg, eng.algebra, eng.max_rounds, K=8)
    P = eng.dg.num_parts

    def clone(s):
        return VisitState(tuple(x.clone() for x in s.planes), s.buf.clone(),
                          s.prio.clone(), s.ops_count.clone(),
                          s.stamp.clone())

    def rows(s):        # the fused visit never touches the trash slot P
        return (*s.planes, s.buf[:P], s.prio[:P], s.ops_count[:P],
                s.stamp[:P])

    a, b = clone(state), clone(state)
    sa = fv.new_stats(a)
    fv.launch(a, sa, 8, 8, cluster)
    if mode == "minplus":
        sb = fv.new_stats(b)
        for _ in range(8):
            fv.ref(b, sb, 8)
        torch.cuda.synchronize()
        assert int(sa[0]) == 8 and torch.equal(sa, sb)
        for x, y in zip(rows(a), rows(b)):
            assert torch.equal(x, y)
        return
    unfused = make_megastep(eng.dg, eng.algebra, eng.max_rounds, K=8)
    b, ms = unfused(b, 8, 8)
    assert int(sa[0]) == ms.visits == 8 and int(sa[1]) == ms.rounds
    for x, y in zip(rows(a), rows(b)):
        assert torch.equal(x, y)
    a, b = clone(state), clone(state)
    sa, sb = fv.new_stats(a), fv.new_stats(b)
    fv.launch(a, sa, 8, 1, cluster)
    fv.ref(b, sb, 8)
    torch.cuda.synchronize()
    assert torch.equal(sa, sb)
    for x, y in zip(rows(a), rows(b)):
        if x.is_floating_point():
            torch.testing.assert_close(x, y, **MM_TOL)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr"])
def test_fused_on_card_equals_fused_on_cpu(card, kind):
    """sssp and bfs bitwise; ppr at the masked-matmul tolerance (the CPU's
    spread is a float32 matmul in another order)."""
    bg, srcs, yc = _fused_setup(kind)
    got = _run(bg, srcs, yc, kind, card, fused=True)
    want = _run(bg, srcs, yc, kind, "cpu", fused=True)
    if kind == "ppr":
        np.testing.assert_allclose(got.values, want.values, **MM_TOL)
        np.testing.assert_allclose(got.residual, want.residual, **MM_TOL)
        return
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.edges_processed, want.edges_processed)
    assert got.visit_order == want.visit_order
    assert got.stats == want.stats


@pytest.mark.parametrize("q,b,s", [(64, 128, 40), (7, 32, 9),
                                   (1, 16, 70_000)])
def test_gathered_kernels_match_plain_versions(card, q, b, s):
    """The gathered form (``xrow``: block idx[s] contracts x[xrow[s]]),
    one launch each, against its plain version: min-plus bitwise, the
    masked matmul bitwise with the list order; past 65,535 slices the CTAs
    walk s in a loop; an xrow outside [0, X) gives a NaN plane."""
    rng = np.random.default_rng(s)
    X, nblk = 6, 5
    d = np.where(rng.random((X, q, b)) < 0.4, np.inf,
                 rng.uniform(0, 10, (X, q, b)))
    x = np.where(rng.random((X, q, b)) < 0.4, 0.0,
                 rng.uniform(0, 1, (X, q, b)))
    w = np.where(rng.random((nblk, b, b)) < 4.0 / b,
                 rng.uniform(1, 5, (nblk, b, b)), np.inf)
    d, x, w = (torch.tensor(a, dtype=torch.float32) for a in (d, x, w))
    lists = tuple(torch.from_numpy(a) for a in column_lists(w.numpy()))
    on_card = tuple(a.to(card) for a in lists)
    idx = torch.from_numpy(rng.integers(-1, nblk, s))
    xrow = torch.from_numpy(rng.integers(0, X, s))
    ops.reset_launches()
    got = ops.minplus(d.to(card), None, idx.to(card), on_card,
                      xrow=xrow.to(card))
    if s < 1000:
        assert torch.equal(got.cpu(), ops.minplus(d, w, idx, lists,
                                                  xrow=xrow))
    else:
        # the plain version's per-row loop, on the first and last slices
        for t in (0, 1, s - 2, s - 1):
            assert torch.equal(got[t].cpu(), ops.minplus(
                d[xrow[t]], w, idx[t:t + 1], lists)[0])
    got = ops.masked_matmul(x.to(card), None, idx.to(card), on_card,
                            xrow=xrow.to(card))
    for t in (range(s) if s < 1000 else (0, 1, s - 2, s - 1)):
        assert torch.equal(got[t].cpu(), list_contract_ref(
            "masked_matmul", x[xrow[t]], *lists, idx[t:t + 1])[0])
    assert ops.LAUNCHES == {"minplus": 1, "masked_matmul": 1}
    if s > ops.MAX_GRID_Z:
        # the ungathered form past gridDim.z's limit: the wrapper sends it
        # through the gathered form, still one launch
        got = ops.minplus(d[0].to(card), None, idx.to(card), on_card)
        for t in (0, s - 1):
            assert torch.equal(got[t].cpu(), ops.minplus(
                d[0], w, idx[t:t + 1], lists)[0])
        assert ops.LAUNCHES["minplus"] == 2
    bad = torch.tensor([0, X, -1], device=card)
    out = ops.minplus(d.to(card), None, torch.tensor([0, 1, 2], device=card),
                      on_card, xrow=bad)
    assert out[1].isnan().all() and not out[0].isnan().any()


@pytest.mark.parametrize("kind", ["sssp", "bfs", "ppr", "cc", "kreach"])
def test_baselines_on_card_equal_cpu(card, kind):
    """One gathered launch per round; the minplus kinds bitwise equal to
    the CPU and to the engine, ppr at the masked-matmul tolerance."""
    from repro_torch.fpp import FPPSession
    from repro_torch.kernels.minplus import ops as mops
    g = grid2d(16, 16, seed=2)
    srcs = np.array([0, 17, 130, 255])
    runs, launches = {}, {}
    for dev in ("cuda", "cpu"):
        sess = FPPSession(g, device=dev).plan(num_queries=4, block_size=32)
        mops.reset_launches()
        runs[dev] = sess.run(kind, srcs, backend="baselines")
        launches[dev] = dict(mops.LAUNCHES)
    a, b = runs["cuda"], runs["cpu"]
    assert a.stats == b.stats
    need = "masked_matmul" if kind == "ppr" else "minplus"
    assert launches["cuda"][need] == a.stats["rounds"]
    assert sum(launches["cuda"].values()) == a.stats["rounds"]
    assert launches["cpu"] == {"minplus": 0, "masked_matmul": 0}
    np.testing.assert_array_equal(a.edges_processed, b.edges_processed)
    if kind == "ppr":
        np.testing.assert_allclose(a.values, b.values, **MM_TOL)
        return
    np.testing.assert_array_equal(a.values, b.values)
    eng = FPPSession(g, device=card).plan(num_queries=4,
                                          block_size=32).run(kind, srcs)
    np.testing.assert_array_equal(a.values, eng.values)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["cc", "kreach"])
def test_cc_kreach_on_card_bitwise_equal_cpu(card, kind, fused):
    """cc (on a graph of many components) and kreach on the card equal the
    CPU run in values, hops, edges and stats, unfused and fused."""
    from repro_torch.fpp import FPPSession
    from repro_torch.graphs.generators import erdos_renyi
    g = erdos_renyi(400, avg_deg=1.5, seed=3)
    srcs = np.array([0, 17, 130, 255])
    a, b = (FPPSession(g, device=dev).plan(num_queries=4, block_size=32,
                                           fused=fused).run(kind, srcs, k=5)
            for dev in (card, "cpu"))
    np.testing.assert_array_equal(a.values, b.values)
    if kind == "kreach":
        np.testing.assert_array_equal(a.residual, b.residual)
    np.testing.assert_array_equal(a.edges_processed, b.edges_processed)
    assert a.stats == b.stats


#: flash attention on the card against its plain version on the card.
#: bf16 (tensor-core kernel): p rounded to bf16 for p.v moves an output by
#: at most 2^-9 max|v|, on top of one bf16 ulp of the unit-scale output (a
#: value near a rounding boundary can round either way); the plain-torch
#: emulation in test_torch_flash.py holds this tolerance on the CPU.
#: float32 (FP32-core kernel): sums in another order
FLASH_TOL = {torch.bfloat16: dict(rtol=8e-3, atol=8e-3),
             torch.float32: dict(rtol=0, atol=2e-6)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,hd,q_offset,causal,window,kv_len", [
    (1, 200, 200, 36, 4, 128, 0, True, None, None),    # GQA 9, ragged tiles
    (2, 64, 192, 8, 2, 128, 128, True, None, None),    # chunk with offset
    (1, 100, 100, 4, 1, 64, 0, True, 32, None),        # window
    (2, 33, 90, 4, 4, 16, 0, False, None, 70),         # kv_len padding
    (1, 40, 40, 2, 2, 160, 0, True, None, None),       # head_dim 160
    # one per kept head dim: Sq not a multiple of the 128-row tile, kv_len
    # ending mid-chunk (the tensor-core kernel's 128-key chunks)
    (1, 77, 300, 4, 2, 16, 0, False, None, 190),
    (1, 130, 300, 4, 1, 64, 100, True, None, 290),
    (2, 200, 450, 36, 4, 128, 250, True, None, 400),
    (1, 300, 300, 4, 2, 160, 0, True, None, 190),
    # head_dim 256 (recurrentgemma-2b: MQA, a group of 10, the window; the
    # tensor-core kernel's 64-key chunks): window edges mid-chunk, kv_len
    # mid-chunk with an offset, and the path's full window of 2048
    (1, 300, 300, 10, 1, 256, 0, True, 100, None),
    (2, 130, 300, 10, 1, 256, 100, True, None, 290),
    (1, 2200, 2200, 10, 1, 256, 0, True, 2048, None),
    # qwen3-moe-30b-a3b: 32 query heads over 4 key/value heads (groups of
    # 8), whole and as a second chunk of a strided cache
    (1, 300, 300, 32, 4, 128, 0, True, None, None),
    (2, 130, 390, 32, 4, 128, 260, True, None, None),
])
def test_flash_kernel_matches_plain_version(card, dtype, B, Sq, Skv, H, Hkv,
                                            hd, q_offset, causal, window,
                                            kv_len):
    """One launch per call, GQA in the kernel, masks by absolute position;
    a strided cache prefix as k and v gives the same bits as a copy."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_gqa_ref
    gen = torch.Generator(device=card).manual_seed(Sq + Skv)
    q = torch.randn((B, Sq, H, hd), generator=gen, device=card).to(dtype)
    cache = torch.randn((2, B, Skv + 16, Hkv, hd), generator=gen,
                        device=card).to(dtype)
    k, v = cache[0, :, :Skv], cache[1, :, :Skv]
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    faops.reset_launches()
    got = faops.flash_attention(q, k, v, **kw)
    assert faops.LAUNCHES == {"flash_attention": 1}
    want = flash_attention_gqa_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, **FLASH_TOL[dtype])
    again = faops.flash_attention(q, k.contiguous(), v.contiguous(), **kw)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,Hkv,hd,q_offset,causal,kv_len,prefix_len", [
        # paligemma-3b (8 query heads on one of 256): the prefix-LM mask
        # ending mid-chunk, and its 256 image positions over two q tiles
        (1, 300, 300, 8, 1, 256, 0, True, None, 100),
        (1, 600, 600, 8, 1, 256, 0, True, None, 256),
        # hd 16: a prefix past the queries' offset, and one covering all
        (2, 90, 200, 4, 2, 16, 110, True, None, 150),
        (1, 50, 50, 4, 4, 16, 0, True, None, 50),
        # whisper-base (8 heads of 64): the encoder and the cross-attention
        # non-causal over 1,536 padded frames of which 1,500 are seen, and
        # the decoder's causal self-attention
        (2, 1536, 1536, 8, 8, 64, 0, False, 1500, None),
        (2, 224, 1536, 8, 8, 64, 0, False, 1500, None),
        (1, 224, 224, 8, 8, 64, 0, True, None, None),
    ])
def test_flash_kernel_prefix_and_padded_keys_match_plain_version(
        card, dtype, B, Sq, Skv, H, Hkv, hd, q_offset, causal, kv_len,
        prefix_len):
    """The vlm's and encdec's masks: one launch per call against the plain
    version; a prefix makes the causal tiles walk the keys below it."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_gqa_ref
    gen = torch.Generator(device=card).manual_seed(Sq + Skv + hd)
    q = torch.randn((B, Sq, H, hd), generator=gen, device=card).to(dtype)
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=gen,
                        device=card).to(dtype) for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              prefix_len=prefix_len)
    faops.reset_launches()
    got = faops.flash_attention(q, k, v, **kw)
    assert faops.LAUNCHES == {"flash_attention": 1}
    torch.testing.assert_close(got, flash_attention_gqa_ref(q, k, v, **kw),
                               **FLASH_TOL[dtype])
    if kv_len is not None:
        # a padded key takes exactly zero probability
        v2 = v.clone()
        v2[:, kv_len:] = 1e4
        assert torch.equal(faops.flash_attention(q, k, v2, **kw), got)


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
def test_threefry_kernel_matches_plain_version(card, seed):
    """fg_threefry, one launch per draw, bitwise against the plain version
    on the CPU: the raw hash, fold_in, split, uniform over 2^16 counters
    and over a batch of keys, and the walk tape's draw."""
    from repro_torch.core import prng
    from repro_torch.kernels.threefry import ops as tfops
    rng = np.random.default_rng(seed % 1000)
    words = [torch.from_numpy(rng.integers(0, 2**32, 1000)) for _ in range(4)]
    src = torch.from_numpy(rng.integers(0, 40_000, 300))
    step = torch.from_numpy(rng.integers(0, 64, 300))
    k = prng.PRNGKey(seed)
    kc = k.to(card)
    tfops.reset_launches()
    pairs = [
        (prng.threefry2x32(*(w.to(card) for w in words)),
         prng.threefry2x32(*words)),
        (prng.fold_in(kc, 12345), prng.fold_in(k, 12345)),
        (prng.split(kc, 3), prng.split(k, 3)),
        (prng.uniform(kc, (1 << 16,)), prng.uniform(k, (1 << 16,))),
        (prng.uniform(prng.fold_in(kc.expand(300, 2), src.to(card))),
         prng.uniform(prng.fold_in(k.expand(300, 2), src))),
        (prng.tape_uniform(kc, src.to(card), step.to(card)),
         prng.tape_uniform(k, src, step)),
    ]
    torch.cuda.synchronize()
    assert tfops.LAUNCHES == {"threefry": 7}
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kind", ["sssp", "ppr"])
def test_fused_random_policy_on_card_equals_unfused(card, kind):
    """The fused kernel's random selection (threefry in the kernel, the key
    carried across launches) visits in the unfused card run's order, with
    its bits, at K = 8 and K = 64; sssp's order is also the CPU's."""
    bg, srcs, yc = _fused_setup(kind)

    def run(dev, fused, K):
        return FPPEngine(bg, mode="push" if kind == "ppr" else "minplus",
                         num_queries=len(srcs), yield_config=yc, eps=1e-3,
                         schedule="random", seed=11, k_visits=K,
                         fused=fused, device=dev).run(srcs,
                                                      record_order=True)

    runs = {(f, k): run(card, f, k) for f in (False, True) for k in (8, 64)}
    want = runs[False, 8]
    if kind == "sssp":      # ppr's CPU spread sums in another order (C2)
        assert want.visit_order == run("cpu", False, 8).visit_order
    for got in runs.values():
        assert got.visit_order == want.visit_order
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.edges_processed,
                                      want.edges_processed)


def test_random_walks_on_card_equal_cpu(card):
    """rw on the engine and baselines backends: positions, steps, hashes
    and occupancy bitwise equal on the card and the CPU, one threefry
    launch per step round."""
    from repro_torch.core.baselines import global_random_walks
    from repro_torch.core.randomwalk import run_random_walks
    from repro_torch.kernels.threefry import ops as tfops
    g = grid2d(16, 16, seed=2)
    bg, perm = partition(g, 32)
    srcs = perm[np.array([0, 17, 130, 255, 40, 99])]
    for fn in (run_random_walks, global_random_walks):
        tfops.reset_launches()
        a = fn(bg, srcs, 20, seed=4, device=card)
        b = fn(bg, srcs, 20, seed=4, device="cpu")
        assert tfops.LAUNCHES["threefry"] == (a.rounds or a.visits)
        for f in ("positions", "steps", "trajectory_hash", "occupancy"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _serve_requests(g, n=12, seed=21):
    from repro_torch.serve import GraphRequest
    cand = np.flatnonzero(g.out_degree() > 0)
    srcs = np.random.default_rng(seed).choice(cand, size=n, replace=False)
    kinds = ("sssp", "kreach", "rw", "bfs")
    return [GraphRequest(kind=kinds[i % len(kinds)], source=int(s),
                         graph="g", tenant=f"t{i % 3}")
            for i, s in enumerate(srcs)]


@pytest.mark.parametrize("fused", [False, True])
def test_serve_forever_threads_on_card_equal_serve(card, fused):
    """Three submitter threads against the running lanes on the card: every
    answer (sssp, kreach, rw, bfs) equals the synchronous ``serve()`` on
    the card and ``serve()`` on the CPU bit for bit, hop counts too."""
    import threading

    from repro_torch.fpp import FPPSession
    from repro_torch.serve import GraphServer
    g = grid2d(12, 12, seed=3)
    reqs = _serve_requests(g)

    def server(dev):
        s = GraphServer(capacity=16, max_capacity=16, k_visits=8,
                        fused=fused, autoscaler=None, eps=1e-3)
        s.register_graph("g", FPPSession(g, device=dev).plan(
            num_queries=16, block_size=32))
        return s

    sync = {}
    for dev in ("cuda", "cpu"):
        s = server(dev)
        rids = s.submit_all(reqs)
        out = s.serve()
        sync[dev] = [out[r] for r in rids]
    conc = server("cuda").start()
    try:
        got, lock = {}, threading.Lock()

        def client(lo):
            for i in range(lo, len(reqs), 3):
                rid = conc.submit(reqs[i])
                with lock:
                    got[i] = rid
        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = {i: conc.result(rid, timeout=300) for i, rid in got.items()}
    finally:
        conc.shutdown()
    assert len(got) == len(reqs)
    for i, r in got.items():
        a, b = sync["cuda"][i], sync["cpu"][i]
        assert r.status == a.status == b.status == "ok"
        for x in (a, b):
            np.testing.assert_array_equal(r.values, x.values)
            np.testing.assert_array_equal(r.residual, x.residual)


def test_pump_lane_exception_on_card_reaches_result(card):
    """An exception raised in a pump lane on the card halts the lanes and
    reaches ``result()`` and ``wait_drained()``; nothing is swallowed."""
    from repro_torch.fpp import FPPSession
    from repro_torch.serve import GraphRequest, GraphServer
    g = grid2d(12, 12, seed=3)
    s = GraphServer(capacity=4, k_visits=8, fused=True, autoscaler=None)
    s.register_graph("g", FPPSession(g, device=card).plan(
        num_queries=4, block_size=32))
    s._ensure_exec(s._pool("g", "sssp"))

    def broken(max_visits):
        raise FloatingPointError("injected fault")

    s._pools[("g", "sssp")].exec.pump = broken
    s.start()
    try:
        rid = s.submit(GraphRequest(kind="sssp", source=5, graph="g"))
        with pytest.raises(RuntimeError, match="serving lane failed") as ei:
            s.result(rid, timeout=120)
        assert isinstance(ei.value.__cause__, FloatingPointError)
        with pytest.raises(RuntimeError, match="injected fault"):
            s.wait_drained(timeout=5)
    finally:
        s.shutdown()


@pytest.mark.parametrize("B,S,cf", [(3, 40, 0.5), (4, 1, 1.25), (1, 96, 1.25)])
def test_apply_moe_on_card_equals_cpu(card, B, S, cf):
    """The MoE layer on the card against its CPU result in float32 at a
    reduced width (16 experts, top-4): the same routing and dropped entries
    (exactly), y and the aux loss within 1e-5 (cuBLAS sums in another
    order).  S = 1 at batch 4 is a decode step's shape."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    cfg = MoEConfig(num_experts=16, top_k=4, expert_d_ff=64,
                    capacity_factor=cf)
    gen = torch.Generator().manual_seed(B * S)
    p = moe.init_moe(gen, 64, cfg, torch.float32)
    x = torch.randn((B, S, 64), generator=gen)
    got = moe.apply_moe({k: v.to(card) for k, v in p.items()}, x.to(card),
                        cfg)
    want = moe.apply_moe(p, x, cfg)
    C = moe.moe_capacity(S, cfg)
    idx = [moe.top_k(torch.softmax(xx @ pp["router"], -1), 4)[1]
           for xx, pp in ((x.to(card), {"router": p["router"].to(card)}),
                          (x, p))]
    slots = [moe.route(i, C, 16).cpu() for i in idx]
    assert torch.equal(slots[0], slots[1])
    if cf < 1:
        assert (slots[1] == 16 * C).any()
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-5)


def test_moe_model_on_card_serves_the_cpu_tokens(card):
    """Reduced qwen3-moe-30b-a3b in float32 through ContinuousBatcher on the
    card and on the CPU from the same weights: the same tokens, and every
    prefill attention call launched the flash kernel."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import ContinuousBatcher, Request
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, T) for T in (9, 30, 17)]
    out = {}
    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    for dev in (card, torch.device("cpu")):
        b = ContinuousBatcher(model, to(cpu, dev), 2, 64, device=dev)
        for rid, p in enumerate(prompts):
            b.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
        faops.reset_launches()
        out[dev.type] = b.run()
        if dev.type == "cuda":
            assert faops.LAUNCHES == {"flash_attention": 3 * cfg.n_layers}
    assert out["cuda"] == out["cpu"]


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-base"])
def test_vlm_and_encdec_on_card_serve_the_cpu_tokens(card, arch):
    """Reduced paligemma-3b and whisper-base in float32 through
    ContinuousBatcher on the card and on the CPU from the same weights and
    extras (image embeddings, 1,500 frames): the same tokens, and every
    prefill attention call launched the flash kernel (vlm: one a layer;
    encdec: the encoder's layers and the decoder's self and cross
    attention)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.models.factory import build_model
    from repro_torch.serve.engine import ContinuousBatcher, Request
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    if cfg.family == "vlm":
        shape, key = (cfg.num_image_tokens, cfg.d_model), "image_embeds"
        per_prefill = cfg.n_layers
    else:
        shape, key = (1500, cfg.d_model), "frames"
        per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    reqs = [(rng.integers(0, cfg.vocab, T),
             (0.1 * rng.normal(size=shape)).astype(np.float32))
            for T in (9, 30, 17)]
    out = {}

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    for dev in (card, torch.device("cpu")):
        b = ContinuousBatcher(model, to(cpu, dev), 2, 64, device=dev)
        for rid, (p, x) in enumerate(reqs):
            b.submit(Request(rid=rid, prompt=p, max_new_tokens=6,
                             extras={key: x}))
        faops.reset_launches()
        out[dev.type] = b.run()
        if dev.type == "cuda":
            assert faops.LAUNCHES == {"flash_attention": 3 * per_prefill}
    assert out["cuda"] == out["cpu"]
