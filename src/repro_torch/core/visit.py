"""The visit algebra — one Algorithm-2 skeleton, in eager PyTorch.

The port of the JAX package's ``repro.core.visit`` for the single-device
engine.  A visit of partition ``p`` is

    apply buffered ops   (consolidate into the resident partition's state)
    relax locally        (until converged, yielded, or out of rounds)
    emit boundary ops    (one contribution per neighbour partition)

The mode-specific operators live in a :class:`VisitAlgebra`:
:func:`minplus_algebra` (sssp/bfs: ops combine by ``min``, the relax is a
tropical product) and :func:`push_algebra` (ppr: ops combine by ``+``, the
relax is a masked residual push).  Both contraction slots go through
``kernels/minplus/ops``, which launches the hand-written kernels on a CUDA
tensor and runs their plain versions on a CPU tensor.

Where eager PyTorch differs from the traced reference:

* **Loop exits read the device.**  The reference's relax loop and K-visit
  loop are ``lax.while_loop``s whose exit tests (``any(active)``,
  ``any(isfinite(prio))``) never leave the device.  Here each exit test is
  one read back to the host; the count of those reads is reported as
  ``device_syncs``, apart from ``host_syncs`` (one per K-visit chunk, the
  reference's meaning).  The relax loop runs over all query rows at once, so
  ``rounds`` counts the same global iterations as the reference.
* **State is updated in place.**  A visit writes the partition's rows,
  buffers and metadata into the state tensors it was given.
* **Dropped scatters get a trash slot.**  The reference writes the padded
  entries of a neighbour list to index ``P`` with ``mode="drop"``.  Here
  ``buf`` keeps its trash row ``P`` and the metadata planes (``prio``,
  ``ops_count``, ``stamp``) carry a trash slot ``P`` too, so those writes
  land somewhere harmless without a data-dependent mask.
* **Segment-combine is gather-combine-write.**  The real destinations of a
  neighbour list are distinct (``BlockGraph.from_csr`` makes one block per
  partition pair), so ``buf[jj] = combine(buf[jj], cands)`` is exact; only
  the trash row repeats, and it only ever receives the identity.
* **Partition ids stay on the device.**  ``p`` is a ``[1]`` int64 tensor and
  every read or write at ``p`` is an ``index_select`` / ``index_copy_``, so
  choosing a partition does not sync.
* **Integer widths.**  Edge counts stay int32 (``sum(..., dtype=int32)``);
  ``argmin``/``argmax`` return the first index on ties, as the host
  scheduler does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import POLICIES
from repro_torch.kernels.minplus import ops as minplus_ops

INF = float("inf")
_BIG_STAMP = np.iinfo(np.int32).max - 1
_INT32_MAX = np.iinfo(np.int32).max

#: edge counters carry (hi, lo) int32 lanes; lo spills into hi in units of
#: 2**EDGE_SHIFT so totals stay exact up to ~2^51 edges per query.
EDGE_SHIFT = 20


# ---------------------------------------------------------------------------
# algebra: the mode-specific operators of Algorithm 2


class MinplusCarry(NamedTuple):
    d: torch.Tensor        # [Q, B] tentative values
    pending: torch.Tensor  # [Q, B] ops not yet relaxed this visit
    emit: torch.Tensor     # [Q, B] rows relaxed this visit (emission sources)
    alpha: torch.Tensor    # [Q, 1] best applied value (Δ-window anchor)


class PushCarry(NamedTuple):
    p: torch.Tensor        # [Q, B] PPR mass
    r: torch.Tensor        # [Q, B] residual (buffered ops consolidated in)
    acc: torch.Tensor      # [Q, B] accumulated pushed mass (emission payload)


@dataclasses.dataclass(frozen=True)
class VisitAlgebra:
    """Mode-specific operators; everything else is the shared skeleton.

    ``planes`` is a tuple of ``[..., Q, B]`` value planes — ``(dist,)`` for
    minplus, ``(p, r)`` for push.  ``deg`` is ``[..., B]`` and broadcasts
    over the query axis, so ``pending`` and ``prio_of`` work on one
    partition's rows and on a batch of partitions alike.
    """
    name: str
    identity: float                  # empty-buffer cell (+inf / 0)
    source_value: float              # buffered op injected per query source
    plane_init: Tuple[float, ...]    # initial plane fill values
    combine: Callable                # consolidate ops: (buf, contrib) -> buf
    begin: Callable                  # (planes_row, buf_row, deg_row) -> carry
    active: Callable                 # (carry, deg_row, eq, budget) -> [Q, B]
    step: Callable                   # (carry, active, blocks, kd, deg_row)
    #                                  -> carry; kd [1] is the diagonal block
    emit_payload: Callable           # (carry) -> [Q, B] boundary payload
    emit_mask: Callable              # (carry) -> [Q, B] rows that cost edges
    contrib: Callable                # (payload, blocks, idx [S]) -> [S, Q, B]
    pending: Callable                # (buf, planes, deg) -> bool [..., Q, B]
    prio_of: Callable                # (buf, planes, deg) -> ([...] f32
    #                                  priority, [...] i32 op count)
    finish: Callable                 # (carry, deg_row) -> (planes_row', keep)


def _sum2(x: torch.Tensor) -> torch.Tensor:
    """int32 count over the last two axes (torch.sum widens to int64
    unless told otherwise)."""
    return x.sum(dim=(-2, -1), dtype=torch.int32)


def minplus_algebra(window: float, strict: bool = False) -> VisitAlgebra:
    """SSSP/BFS family: ops combine by ``min``, relax is min-plus.

    ``strict=True`` makes an op pend only when it *strictly* improves the
    plane value (``buf < d`` instead of ``buf <= d``), the rule the
    zero-weight cc instantiation needs to terminate.
    """
    relax = minplus_ops.minplus
    lt = torch.lt if strict else torch.le

    def pending(buf, planes, deg):
        (d,) = planes
        return torch.isfinite(buf) & lt(buf, d)

    def prio_of(buf, planes, deg):
        pend = pending(buf, planes, deg)
        return torch.where(pend, buf, INF).amin(dim=(-2, -1)), _sum2(pend)

    def begin(planes_row, buf_row, deg_row):
        (d0,) = planes_row
        pending0 = torch.isfinite(buf_row) & lt(buf_row, d0)
        d1 = torch.minimum(d0, torch.where(pending0, buf_row, INF))
        alpha = torch.where(pending0, d1, INF).amin(dim=1, keepdim=True)
        return MinplusCarry(d=d1, pending=pending0,
                            emit=torch.zeros_like(pending0), alpha=alpha)

    def active(carry, deg_row, eq, budget):
        # alpha + window stays f32 (window may be inf), as does eq < budget
        return (carry.pending & (carry.d <= carry.alpha + window)
                & (eq.to(torch.float32) < budget)[:, None])

    def step(carry, act, blocks, kd, deg_row):
        srcs = torch.where(act, carry.d, INF)
        nd = relax(srcs, blocks, kd)[0]
        improved = nd < carry.d
        return MinplusCarry(d=torch.minimum(carry.d, nd),
                            pending=(carry.pending & ~act) | improved,
                            emit=carry.emit | act, alpha=carry.alpha)

    def finish(carry, deg_row):
        return (carry.d,), torch.where(carry.pending, carry.d, INF)

    return VisitAlgebra(
        name="minplus", identity=INF, source_value=0.0, plane_init=(INF,),
        combine=torch.minimum, begin=begin, active=active, step=step,
        emit_payload=lambda carry: torch.where(carry.emit, carry.d, INF),
        emit_mask=lambda carry: carry.emit,
        contrib=relax, pending=pending, prio_of=prio_of, finish=finish)


def push_algebra(alpha: float, eps: float) -> VisitAlgebra:
    """PPR family: residual contributions combine by ``+``, relax is a masked
    ACL push round, priority is the most negative residual ratio."""
    spread = minplus_ops.masked_matmul

    def _thresh(deg):
        return eps * torch.clamp(deg, min=1).to(torch.float32)

    def pending(buf, planes, deg):
        _, r = planes
        return (((r + buf) >= _thresh(deg)[..., None, :])
                & (deg > 0)[..., None, :])

    def prio_of(buf, planes, deg):
        _, r = planes
        ratio = (r + buf) / _thresh(deg)[..., None, :]
        has_edges = (deg > 0)[..., None, :]
        ready = (ratio >= 1.0) & has_edges
        best = torch.where(has_edges, ratio, -INF).amax(dim=(-2, -1))
        any_ready = ready.flatten(-2).any(dim=-1)
        return torch.where(any_ready, -best, INF), _sum2(ready)

    def begin(planes_row, buf_row, deg_row):
        p0, r0 = planes_row
        return PushCarry(p=p0, r=r0 + buf_row, acc=torch.zeros_like(r0))

    def active(carry, deg_row, eq, budget):
        return ((carry.r >= _thresh(deg_row)[None, :])
                & (deg_row > 0)[None, :]
                & (eq.to(torch.float32) < budget)[:, None])

    def step(carry, act, blocks, kd, deg_row):
        degc = torch.clamp(deg_row, min=1).to(torch.float32)
        af = act.to(carry.r.dtype)
        pushed = (1.0 - alpha) * carry.r * af / degc[None, :]
        return PushCarry(p=carry.p + alpha * carry.r * af,
                         r=carry.r * (1.0 - af) + spread(pushed, blocks,
                                                         kd)[0],
                         acc=carry.acc + pushed)

    def finish(carry, deg_row):
        return (carry.p, carry.r), torch.zeros_like(carry.r)

    return VisitAlgebra(
        name="push", identity=0.0, source_value=1.0, plane_init=(0.0, 0.0),
        combine=torch.add, begin=begin, active=active, step=step,
        emit_payload=lambda carry: carry.acc,
        emit_mask=lambda carry: carry.acc > 0,
        contrib=spread, pending=pending, prio_of=prio_of, finish=finish)


# ---------------------------------------------------------------------------
# shared state container + initialization


class VisitState(NamedTuple):
    """Engine-side buffered state; the algebra defines what the planes mean.

    Unlike the reference's ``[P]`` metadata, ``prio``/``ops_count``/
    ``stamp`` are ``[P+1]``: slot ``P`` is the trash slot that padded
    neighbour entries write to.  Only ``[:P]`` is ever read."""
    planes: Tuple[torch.Tensor, ...]  # mode value planes, each [P, Q, B]
    buf: torch.Tensor                 # [P+1, Q, B] pending ops (row P = trash)
    prio: torch.Tensor                # [P+1] f32 best pending priority
    ops_count: torch.Tensor           # [P+1] i32 pending op count
    stamp: torch.Tensor               # [P+1] i32 visit counter when buf
    #                                   became non-empty


def init_dense_state(algebra: VisitAlgebra, num_parts: int, num_queries: int,
                     block_size: int, sources: np.ndarray):
    """Host-side (planes, buf) with one source op buffered per query lane.

    ``sources``: [k] reordered vertex ids, k <= num_queries — lane ``i``
    gets ``sources[i]``; remaining lanes start empty.  ``buf`` carries the
    trash row ``P``.
    """
    P, Q, B = num_parts, num_queries, block_size
    planes = tuple(np.full((P, Q, B), v, dtype=np.float32)
                   for v in algebra.plane_init)
    buf = np.full((P + 1, Q, B), algebra.identity, dtype=np.float32)
    sources = np.asarray(sources)
    if sources.size:
        parts, locs = np.divmod(sources, B)
        buf[parts, np.arange(sources.size), locs] = algebra.source_value
    return planes, buf


def state_meta(algebra: VisitAlgebra, planes, buf, deg):
    """(prio, ops_count, stamp), each [P+1] with the trash slot last, from
    the algebra's own priority operator; non-empty buffers get stamp 0."""
    P = deg.shape[0]
    prio, ops = algebra.prio_of(buf[:P], planes, deg)
    stamp = torch.where(torch.isfinite(prio), 0, _BIG_STAMP).to(torch.int32)
    return (torch.cat([prio, prio.new_full((1,), INF)]),
            torch.cat([ops, ops.new_zeros(1)]),
            torch.cat([stamp, stamp.new_full((1,), _BIG_STAMP)]))


def init_engine_state(algebra: VisitAlgebra, dg,
                      sources: np.ndarray) -> VisitState:
    """Device state for the engine, on ``dg.device``: one query lane per
    source."""
    planes_np, buf_np = init_dense_state(
        algebra, dg.num_parts, len(sources), dg.block_size, sources)
    planes = tuple(torch.from_numpy(x).to(dg.device) for x in planes_np)
    buf = torch.from_numpy(buf_np).to(dg.device)
    prio, ops, stamp = state_meta(algebra, planes, buf, dg.deg)
    return VisitState(planes, buf, prio, ops, stamp)


# ---------------------------------------------------------------------------
# the visit body


def make_visit(dg, algebra: VisitAlgebra, max_rounds: int) -> Callable:
    """The visit body (Alg. 2 lines 6-16): apply + relax until yield, then
    emit one combined contribution per neighbour partition.  The megastep
    runs it K times per chunk; ``host_loop=True`` dispatches it per visit.

    ``visit(state, p, counter) -> (state, (rounds, eq, syncs))`` with ``p`` a
    ``[1]`` int64 device tensor and ``counter`` the global visit counter.
    ``rounds`` and ``syncs`` (exit-test reads) are host ints; ``eq`` is
    this visit's per-query edge count (int32 [Q], exact, on the device).
    The state tensors are updated in place.
    """
    def visit(state: VisitState, p: torch.Tensor, counter: int):
        kd = dg.diag_blk.index_select(0, p)                       # [1]
        nnz_pp = dg.row_nnz.index_select(0, kd)[0]                # [B]
        deg_p = dg.deg.index_select(0, p)[0]                      # [B]
        budget = dg.edge_budget.index_select(0, p)                # [1]
        planes_row = tuple(x.index_select(0, p)[0] for x in state.planes)
        buf_row = state.buf.index_select(0, p)[0]
        carry = algebra.begin(planes_row, buf_row, deg_p)

        # relax rounds; the exit test is a device read (see module doc)
        eq = torch.zeros(buf_row.shape[0], dtype=torch.int32,
                         device=buf_row.device)
        rounds = syncs = 0
        while rounds < max_rounds:
            act = algebra.active(carry, deg_p, eq, budget)
            syncs += 1
            if not bool(act.any()):
                break
            eq += torch.where(act, nnz_pp, 0).sum(dim=1, dtype=torch.int32)
            carry = algebra.step(carry, act, dg.blocks, kd, deg_p)
            rounds += 1

        # emission to neighbour partitions (Alg. 2 line 16): one batched
        # contrib over all neighbour blocks, read in place by the kernel
        payload = algebra.emit_payload(carry)
        emask = algebra.emit_mask(carry)
        nbr_blk = dg.nbr_blk.index_select(0, p)[0]                # [dmax]
        jj = dg.nbr_dst.index_select(0, p)[0]     # [dmax], P = trash slot
        j0 = dg.nbr_src.index_select(0, p)[0]     # [dmax], clamped to 0
        cands = algebra.contrib(payload, dg.blocks, nbr_blk)      # [dmax,Q,B]
        eq += torch.where(emask, dg.nbr_nnz.index_select(0, p), 0).sum(
            dim=1, dtype=torch.int32)
        was_empty = ~torch.isfinite(state.prio)                   # [P+1]
        vals = algebra.combine(state.buf.index_select(0, jj), cands)
        state.buf.index_copy_(0, jj, vals)
        # vals is buf[jj] after the write (real destinations are distinct),
        # so the metadata refresh reads it without a second gather
        newprio, newops = algebra.prio_of(
            vals, tuple(x.index_select(0, j0) for x in state.planes),
            dg.deg.index_select(0, j0))
        newstamp = torch.where(
            was_empty.index_select(0, jj) & torch.isfinite(newprio),
            counter, state.stamp.index_select(0, jj))
        state.prio.index_copy_(0, jj, newprio)
        state.ops_count.index_copy_(0, jj, newops)
        state.stamp.index_copy_(0, jj, newstamp)

        # write back own planes, keep yielded ops, refresh own priority
        new_rows, keep_row = algebra.finish(carry, deg_p)
        state.buf.index_copy_(0, p, keep_row[None])
        own_prio, own_ops = algebra.prio_of(keep_row, new_rows, deg_p)
        state.prio.index_copy_(0, p, own_prio.view(1))
        state.ops_count.index_copy_(0, p, own_ops.view(1))
        state.stamp.index_copy_(0, p, torch.where(
            torch.isfinite(own_prio), counter, _BIG_STAMP).to(
                torch.int32).view(1))
        for x, nr in zip(state.planes, new_rows):
            x.index_copy_(0, p, nr[None])
        return state, (rounds, eq, syncs)

    return visit


# ---------------------------------------------------------------------------
# device-resident scheduling: the K-visit megastep


def device_select(policy: str, prio: torch.Tensor, stamp: torch.Tensor,
                  ops_count: torch.Tensor) -> torch.Tensor:
    """On-device mirror of ``PartitionScheduler.select`` (the host oracle).

    Takes the ``[P]`` metadata (no trash slot) and returns the selected
    partition as a ``[1]`` int64 tensor.  The caller guarantees at least one
    finite-priority partition.  The deterministic policies reproduce the
    host argmin/argmax bit for bit, first-index tie-breaking included.
    """
    if policy == "priority":
        return torch.argmin(prio).view(1)
    nonempty = torch.isfinite(prio)
    if policy == "fifo":
        return torch.argmin(torch.where(nonempty, stamp, _INT32_MAX)).view(1)
    if policy == "max_ops":
        return torch.argmax(torch.where(nonempty, ops_count, -1)).view(1)
    if policy == "random":
        raise NotImplementedError(
            "the random policy needs the threefry port (ROADMAP A8)")
    raise ValueError(f"unknown scheduling policy {policy!r}")


class MegastepStats(NamedTuple):
    """Per-chunk accumulators, harvested once per host dispatch."""
    visits: int                 # visits executed this chunk (<= K)
    rounds: int                 # total relaxation rounds
    eq_hi: torch.Tensor         # [Q] i32: per-query edge count, high lane
    eq_lo: torch.Tensor         # [Q] i32: low lane (< 2**EDGE_SHIFT)
    visit_counts: torch.Tensor  # [P] i32: visits per partition
    order: torch.Tensor         # [K] i32 visit-order ring (-1 = unused slot)
    device_syncs: int           # exit-test reads this chunk


def make_megastep(dg, algebra: VisitAlgebra, max_rounds: int,
                  policy: str = "priority", K: int = 64) -> Callable:
    """Scheduling loop: up to K visits per host dispatch, the scheduler's
    choice made on the device from the ``[P]`` prio/stamp/ops planes.

    Returns ``megastep(state, counter, limit) -> (state, stats)``:
    ``counter`` is the global visit counter at chunk start, ``limit`` caps
    this chunk at ``min(limit, K)`` visits, and the loop exits early when no
    partition holds a pending op — ``stats.visits < limit`` is the host's
    termination signal.  Edge counters carry an exact ``(hi, lo)`` int32
    pair per query.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown scheduling policy {policy!r}; "
                         f"one of {POLICIES}")
    if policy == "random":
        raise NotImplementedError(
            "the random policy needs the threefry port (ROADMAP A8)")
    if K < 1:
        raise ValueError(f"megastep chunk size K must be >= 1, got {K}")
    P = dg.num_parts
    visit = make_visit(dg, algebra, max_rounds)

    def megastep(state: VisitState, counter: int, limit: int):
        limit_k = min(int(limit), K)
        Q, dev = state.buf.shape[1], state.buf.device
        hi = torch.zeros(Q, dtype=torch.int32, device=dev)
        lo = torch.zeros(Q, dtype=torch.int32, device=dev)
        counts = torch.zeros(P, dtype=torch.int32, device=dev)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        order = torch.full((K,), -1, dtype=torch.int32, device=dev)
        prio, stamp, ops = state.prio[:P], state.stamp[:P], state.ops_count[:P]
        k = rounds = syncs = 0
        while k < limit_k:
            syncs += 1                     # the K-loop exit test, read back
            if not bool(torch.isfinite(prio).any()):
                break
            p = device_select(policy, prio, stamp, ops)
            state, (r, eq, s) = visit(state, p, counter + k)
            rounds += r
            syncs += s
            lo += eq
            spill = lo >> EDGE_SHIFT
            hi += spill
            lo -= spill << EDGE_SHIFT
            counts.index_add_(0, p, one)
            order[k:k + 1].copy_(p)
            k += 1
        return state, MegastepStats(visits=k, rounds=rounds, eq_hi=hi,
                                    eq_lo=lo, visit_counts=counts,
                                    order=order, device_syncs=syncs)

    return megastep


def harvest_edges(eq_hi: np.ndarray, eq_lo: np.ndarray) -> np.ndarray:
    """Fold a harvested (hi, lo) int32 pair into exact float64 edge counts."""
    return (np.asarray(eq_hi, dtype=np.float64) * float(1 << EDGE_SHIFT)
            + np.asarray(eq_lo, dtype=np.float64))
