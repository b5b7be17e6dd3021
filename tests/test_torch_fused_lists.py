"""The fused visit's column lists and its one-launch chunk, on the CPU.

The card's fused visit (``csrc/fused_visit.cu``) contracts over the column
lists of each block's finite entries (``core/engine.column_lists``) and
runs a whole K-visit chunk per launch.  Here, at small sizes:

* the lists rebuild every block of a graph carried across from the JAX
  package bit for bit (ascending u, every finite entry and no other);
* the plain emulation of the list contraction that the fused visit and
  ``fg_minplus`` / ``fg_masked_matmul`` share, in its per-cell order
  (``kernels/minplus/ref.list_contract_ref``), is bitwise equal to the
  dense plain contraction: min-plus to ``kernels/minplus/ref.minplus_ref``,
  push to the dense u = 0..B-1 ``fmaf`` order (and within the
  masked-matmul tolerance of ``masked_matmul_ref``'s float32 matmul);
* whole visits on the lists equal visits on the dense blocks, bitwise;
* one ``FusedVisit.chunk`` of K visits (one launch on the card) equals K
  one-visit steps.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.partition import partition as jpartition  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import visit  # noqa: E402
from repro_torch.core.engine import (DeviceGraph, FPPEngine,  # noqa: E402
                                     blocks_from_lists,
                                     column_lists)
from repro_torch.fpp import planner  # noqa: E402
from repro_torch.kernels.fused_visit import ops as fvops  # noqa: E402
from repro_torch.kernels.fused_visit.ref import (  # noqa: E402
    fused_step_ref, split_stats)
from repro_torch.kernels.minplus import ops as mops  # noqa: E402
from repro_torch.kernels.minplus.ref import list_contract_ref  # noqa: E402

#: masked matmul against a float32 matmul summing in another order
MM_TOL = dict(rtol=1e-5, atol=2e-6)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def _rebuild(col_ptr, col_u, col_w, k, B):
    """Block k, dense, from its lists; checks ascending u per column."""
    dense = np.full((B, B), np.inf, dtype=np.float32)
    for v in range(B):
        e0, e1 = col_ptr[k, v], col_ptr[k, v + 1]
        u = col_u[e0:e1]
        assert (np.diff(u) > 0).all(), (k, v, u)
        dense[u, v] = col_w[e0:e1]
    return dense


@pytest.mark.parametrize("B", [16, 30])
def test_column_lists_rebuild_every_block(B):
    """On a block graph carried across from the reference (ragged B=30 is
    not a multiple of 4; the grid's partitions have padded neighbour
    slots), with an all-+inf block appended: the lists give back every
    block bit for bit, and count exactly its finite entries."""
    jg = jgen.grid2d(12, 12, seed=4)
    jbg, _ = jpartition(jg, B)
    bg = convert.block_graph_from_arrays(**dataclasses.asdict(jbg))
    assert (bg.nbr_blk < 0).any()            # padded slots exist
    blocks = np.concatenate([bg.blocks.astype(np.float32),
                             np.full((1, B, B), np.inf, np.float32)])
    col_ptr, col_u, col_w = column_lists(blocks)
    nblk = blocks.shape[0]
    assert col_ptr.shape == (nblk, B + 1) and col_ptr.dtype == np.int32
    assert (col_ptr[1:, 0] == col_ptr[:-1, B]).all()
    assert col_ptr[0, 0] == 0 and col_ptr[-1, B] == col_u.size
    assert col_u.size == col_w.size == int(np.isfinite(blocks).sum())
    for k in range(nblk):
        np.testing.assert_array_equal(_bits(_rebuild(col_ptr, col_u, col_w,
                                                     k, B)),
                                      _bits(blocks[k]))
    assert col_ptr[-1, 0] == col_ptr[-1, B]   # the empty block: no entries
    # DeviceGraph.build carries the same lists onto its device
    dg = DeviceGraph.build(bg, planner.default_yield_config("sssp", bg), 4,
                           device="cpu")
    want = column_lists(bg.blocks.astype(np.float32))
    for got, w in zip((dg.col_ptr, dg.col_u, dg.col_w), want):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
    # on the CPU it stages the dense blocks too, for the plain versions
    assert dg.dense_blocks() is dg.blocks
    np.testing.assert_array_equal(_bits(blocks_from_lists(*dg.lists)),
                                  _bits(bg.blocks))


def _ordered_masked_matmul(x, blocks, idx):
    """The dense spread's order: u = 0..B-1, fmaf(x, finite(w), acc) from
    +0 (x * m is exact for m in {0, 1}, so one add rounds as fmaf does)."""
    Q, B = x.shape
    out = torch.zeros((idx.shape[0], Q, B), dtype=x.dtype)
    for s, k in enumerate(idx.tolist()):
        if k < 0:
            continue
        m = torch.isfinite(blocks[k]).to(x.dtype)
        acc = out[s]
        for u in range(B):
            acc += x[:, u:u + 1] * m[u][None, :]
    return out


def _sparse_blocks(rng, nblk, B):
    """Road-like density (~4 entries per column), with one empty column
    in every block and one all-+inf block."""
    w = np.where(rng.random((nblk, B, B)) < 4.0 / B,
                 rng.uniform(1.0, 11.0, (nblk, B, B)), np.inf)
    w[:, :, B // 2] = np.inf
    w[nblk - 1] = np.inf
    return w.astype(np.float32)


@pytest.mark.parametrize("B", [16, 30])
@pytest.mark.parametrize("name", ["minplus", "masked_matmul"])
def test_list_contraction_bitwise_equals_dense(name, B):
    rng = np.random.default_rng(B + len(name))
    Q, nblk = 7, 5
    blocks = _sparse_blocks(rng, nblk, B)
    if name == "minplus":
        x = np.where(rng.random((Q, B)) < 0.4, rng.uniform(0, 50, (Q, B)),
                     np.inf)
    else:
        x = np.where(rng.random((Q, B)) < 0.4, rng.uniform(0, 1e-2, (Q, B)),
                     0.0)
    x = torch.tensor(x, dtype=torch.float32)
    bt = torch.tensor(blocks)
    idx = torch.tensor([2, -1, 0, nblk - 1, 3])
    lists = [torch.from_numpy(a) for a in column_lists(blocks)]
    got = list_contract_ref(name, x, *lists, idx)
    dense = mops.plain(name, x, bt, idx)
    if name == "minplus":
        assert torch.equal(got, dense)
    else:
        assert torch.equal(got, _ordered_masked_matmul(x, bt, idx))
        torch.testing.assert_close(got, dense, **MM_TOL)
        assert not torch.signbit(got).any()   # never -0


def _blocks_at(rng, density, nblk, B):
    """``nblk`` blocks at ``density``: ``"road"`` ~4 finite entries per
    column, ``"hub"`` ~25 %, ``"full"`` every entry finite.  Every block
    but the last has an empty column; the last is fully finite."""
    p = {"road": 4.0 / B, "hub": 0.25, "full": 1.0}[density]
    w = np.where(rng.random((nblk, B, B)) < p,
                 rng.uniform(1.0, 11.0, (nblk, B, B)), np.inf)
    w[:-1, :, B // 3] = np.inf
    w[-1] = rng.uniform(1.0, 11.0, (B, B))
    return w.astype(np.float32)


@pytest.mark.parametrize("density", ["road", "hub", "full"])
@pytest.mark.parametrize("name", ["minplus", "masked_matmul"])
def test_list_contract_ref_batched_bitwise_equals_dense(name, density):
    """At a ragged Q=5, B=30 and S=6 with -1 padding (the identity plane):
    min-plus bitwise equal to the dense plain version, the masked matmul
    bitwise equal to the dense u = 0..B-1 fmaf order and within the
    masked-matmul tolerance of the float32 matmul; an index past nblk
    gives a NaN plane, as the kernels do."""
    rng = np.random.default_rng(len(name) * 7 + len(density))
    Q, B, nblk = 5, 30, 4
    blocks = _blocks_at(rng, density, nblk, B)
    live = rng.random((Q, B)) < 0.5
    x = np.where(live, rng.uniform(0, 50 if name == "minplus" else 1e-2,
                                   (Q, B)),
                 np.inf if name == "minplus" else 0.0)
    x = torch.tensor(x, dtype=torch.float32)
    bt = torch.tensor(blocks)
    idx = torch.tensor([1, -1, 3, 0, -1, 2])
    lists = [torch.from_numpy(a) for a in column_lists(blocks)]
    got = list_contract_ref(name, x, *lists, idx)
    dense = mops.plain(name, x, bt, idx)
    if name == "minplus":
        assert torch.equal(got, dense)
    else:
        assert torch.equal(got, _ordered_masked_matmul(x, bt, idx))
        torch.testing.assert_close(got, dense, **MM_TOL)
    ident = float("inf") if name == "minplus" else 0.0
    assert (got[[1, 4]] == ident).all()
    bad = list_contract_ref(name, x, *lists, torch.tensor([nblk, 0]))
    assert bad[0].isnan().all() and torch.equal(bad[1], got[3])


@pytest.mark.parametrize("kind", ["sssp", "ppr"])
def test_unfused_visit_hands_the_lists_to_both_contractions(kind,
                                                            monkeypatch):
    """Every relax and emission of the unfused megastep calls its wrapper
    with the device graph's blocks and its column lists, and one run on
    the CPU gives the same bits as before."""
    from repro_torch.core.partition import partition
    from repro_torch.graphs.generators import grid2d
    g = grid2d(12, 12, seed=3)
    bg, perm = partition(g, 16)
    srcs = perm[np.array([0, 5, 77, 143])]
    mode = "push" if kind == "ppr" else "minplus"
    eng = FPPEngine(bg, mode=mode, num_queries=4, k_visits=8, eps=1e-3,
                    device="cpu",
                    yield_config=planner.default_yield_config(kind, bg))
    calls = []
    run = mops._run

    def spy(name, x, blocks, idx, lists, xrow=None):
        calls.append((name, idx.shape[0]))
        assert blocks is eng.dg.blocks and xrow is None
        assert all(a is b for a, b in zip(lists, eng.dg.lists))
        return run(name, x, blocks, idx, lists)

    monkeypatch.setattr(mops, "_run", spy)
    res = eng.run(srcs)
    want = "masked_matmul" if kind == "ppr" else "minplus"
    dmax = eng.dg.nbr_blk.shape[1]
    assert dmax > 1                   # so the two call sites differ in S
    assert {n for n, _ in calls} == {want}
    relax = sum(1 for _, s in calls if s == 1)
    emit = sum(1 for _, s in calls if s == dmax)
    assert (relax, emit) == (res.stats.rounds, res.stats.visits)
    assert len(calls) == relax + emit


def _mid_run(kind, strict=False):
    """A mid-run state of the fused sssp / ppr engine on grid2d(12, 12),
    B=16, Q=4, after one K=8 chunk."""
    from repro_torch.core.partition import partition
    from repro_torch.graphs.generators import grid2d
    g = grid2d(12, 12, seed=3)
    bg, perm = partition(g, 16)
    srcs = perm[np.array([0, 5, 77, 143])]
    mode = "push" if kind == "ppr" else "minplus"
    eng = FPPEngine(bg, mode=mode, num_queries=4, k_visits=8, fused=True,
                    eps=1e-3, device="cpu",
                    yield_config=planner.default_yield_config(kind, bg))
    state, _ = eng._megastep(eng.init_state(srcs), 0, 8)
    alg = eng.algebra
    if strict:
        alg = visit.minplus_algebra(alg.param("window"), strict=True)
    return eng, alg, state


def _clone(state):
    return visit.VisitState(tuple(x.clone() for x in state.planes),
                            state.buf.clone(), state.prio.clone(),
                            state.ops_count.clone(), state.stamp.clone())


def _tensors(state, stats):
    return (*state.planes, state.buf, state.prio, state.ops_count,
            state.stamp, stats)


@pytest.mark.parametrize("variant", ["minplus", "minplus-strict", "ppr"])
def test_visits_on_lists_bitwise_equal_visits_on_dense_blocks(variant,
                                                               monkeypatch):
    """Eight visits from the same mid-run state with the kernel's list
    contraction and with the dense contraction (push: in the dense
    u = 0..B-1 fmaf order), each in place of the plain version's
    contraction, leave the same bits in every plane, the metadata and
    the stats."""
    kind = "ppr" if variant == "ppr" else "sssp"
    eng, alg, state = _mid_run(kind, strict=variant.endswith("strict"))
    dg = eng.dg
    fv = fvops.make_fused_visit(dg, alg, eng.max_rounds, K=8)

    def lists(name, x, blocks, idx):
        return list_contract_ref(name, x, dg.col_ptr, dg.col_u, dg.col_w,
                                 idx)

    def dense(name, x, blocks, idx):
        if name == "minplus":
            return plain(name, x, blocks, idx)
        return _ordered_masked_matmul(x, blocks, idx)

    plain = mops.plain
    runs = []
    for contract in (lists, dense):
        monkeypatch.setattr(mops, "plain", contract)
        st = _clone(state)
        stats = fv.new_stats(st)
        for _ in range(8):
            fused_step_ref(dg, fv.spec, st, stats, 8)
        runs.append(_tensors(st, stats))
    assert int(runs[0][-1][0]) == 8
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["sssp", "ppr"])
def test_one_chunk_equals_k_one_visit_steps(kind):
    """The fused megastep's chunk (one launch on the card) gives the same
    MegastepStats and state as K one-visit steps, and reads the device
    once."""
    eng, alg, state = _mid_run(kind)
    K = 8
    fv = fvops.make_fused_visit(eng.dg, alg, eng.max_rounds, K=K)
    mega = visit.make_megastep(eng.dg, alg, eng.max_rounds, K=K, fused=True)
    chunk_state, ms = mega(_clone(state), K, K)
    steps = _clone(state)
    stats = fv.new_stats(steps)
    for _ in range(K):
        fv.step(steps, stats, K)
    hi, lo, counts, order = split_stats(stats, 4, eng.dg.num_parts)
    assert (ms.visits, ms.rounds, ms.device_syncs) == (int(stats[0]),
                                                       int(stats[1]), 1)
    for a, b in ((ms.eq_hi, hi), (ms.eq_lo, lo), (ms.visit_counts, counts),
                 (ms.order, order)):
        assert torch.equal(a, b)
    for a, b in zip(_tensors(chunk_state, stats)[:-1],
                    _tensors(steps, stats)[:-1]):
        assert torch.equal(a, b)
    assert fvops.LAUNCHES["fused_visit"] == 0     # the CPU launches nothing


def test_cluster_size_and_shared_memory_depend_on_q_and_b_only():
    """The wrapper picks the cluster from Q; each CTA's shared memory is a
    function of (algebra, Q, B, cluster) that fits one block at the main
    path's shapes, for every compiled cluster size and a ragged Q."""
    assert [fvops.cluster_size(q) for q in (1, 4, 8, 9, 16, 32, 33, 60, 64)
            ] == [1, 1, 1, 4, 4, 4, 8, 8, 8]
    for c in fvops.CLUSTER_SIZES:
        for q in (60, 64):
            for n in (1, 2):
                assert fvops.smem_bytes(n, q, 128, c) <= fvops.MAX_SMEM_BYTES
    # a CTA's slice shrinks with the cluster; the stages do not grow with Q
    assert (fvops.smem_bytes(1, 64, 128, 1) > fvops.smem_bytes(1, 64, 128, 4)
            > fvops.smem_bytes(1, 64, 128, 8))
    assert fvops.smem_bytes(2, 64, 128) == fvops.smem_bytes(2, 64, 128, 8)
    with pytest.raises(ValueError, match="cluster size"):
        fvops.smem_bytes(1, 64, 128, 2)


def test_ctypes_arguments_mirror_the_kernel_struct():
    """``_Args`` lists FusedArgs's fields in the source's order."""
    src = (pathlib.Path(fvops.__file__).resolve().parents[1] / "csrc"
           / "fused_visit.cu").read_text()
    body = src[src.index("struct FusedArgs {"):]
    body = body[:body.index("};")]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [re.sub(r"^.*[\s*]", "", n.strip())
                      for n in decl.split(",")]
    assert names == [n for n, _ in fvops._Args._fields_]
