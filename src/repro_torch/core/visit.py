"""The visit algebra — one Algorithm-2 skeleton, in eager PyTorch.

The port of the JAX package's ``repro.core.visit``: the single-device
engine's visit and megastep, and the distributed runtime's
:func:`superstep`.  A visit of partition ``p`` is

    apply buffered ops   (consolidate into the resident partition's state)
    relax locally        (until converged, yielded, or out of rounds)
    emit boundary ops    (one contribution per neighbour partition)

The mode-specific operators live in a :class:`VisitAlgebra`:
:func:`minplus_algebra` (sssp/bfs: ops combine by ``min``, the relax is a
tropical product) and :func:`push_algebra` (ppr: ops combine by ``+``, the
relax is a masked residual push).  Both contraction slots go through
``kernels/minplus/ops`` with the device graph's column lists and dense
blocks: on a CUDA tensor the hand-written kernels walk the lists (the
dense blocks are not staged there), on a CPU tensor the plain versions
contract the dense blocks.

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
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.scheduler import POLICIES, device_select
from repro_torch.kernels.fused_visit.ops import make_fused_visit
from repro_torch.kernels.fused_visit.ref import split_stats
from repro_torch.kernels.minplus import ops as minplus_ops

INF = float("inf")
_BIG_STAMP = np.iinfo(np.int32).max - 1

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
    step: Callable                   # (carry, active, dg, kd, deg_row)
    #                                  -> carry; dg the DeviceGraph, kd [1]
    #                                  its diagonal block
    emit_payload: Callable           # (carry) -> [Q, B] boundary payload
    emit_mask: Callable              # (carry) -> [Q, B] rows that cost edges
    contrib: Callable                # (payload, dg, idx [S]) -> [S, Q, B]
    pending: Callable                # (buf, planes, deg) -> bool [..., Q, B]
    prio_of: Callable                # (buf, planes, deg) -> ([...] f32
    #                                  priority, [...] i32 op count)
    finish: Callable                 # (carry, deg_row) -> (planes_row', keep)
    #: the scalars the operators close over (``window``/``strict`` or
    #: ``alpha``/``eps``), as (name, value) pairs: what the fused kernel
    #: is handed instead of the closures
    params: Tuple[Tuple[str, float], ...] = ()

    def param(self, name: str) -> float:
        return dict(self.params)[name]


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
    def relax(x, dg, idx):
        return minplus_ops.minplus(x, dg.blocks, idx, dg.lists)

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

    def step(carry, act, dg, kd, deg_row):
        srcs = torch.where(act, carry.d, INF)
        nd = relax(srcs, dg, kd)[0]
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
        contrib=relax, pending=pending, prio_of=prio_of, finish=finish,
        params=(("window", float(window)), ("strict", float(strict))))


def push_algebra(alpha: float, eps: float) -> VisitAlgebra:
    """PPR family: residual contributions combine by ``+``, relax is a masked
    ACL push round, priority is the most negative residual ratio."""
    def spread(x, dg, idx):
        return minplus_ops.masked_matmul(x, dg.blocks, idx, dg.lists)

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

    def step(carry, act, dg, kd, deg_row):
        degc = torch.clamp(deg_row, min=1).to(torch.float32)
        af = act.to(carry.r.dtype)
        pushed = (1.0 - alpha) * carry.r * af / degc[None, :]
        return PushCarry(p=carry.p + alpha * carry.r * af,
                         r=carry.r * (1.0 - af) + spread(pushed, dg,
                                                         kd)[0],
                         acc=carry.acc + pushed)

    def finish(carry, deg_row):
        return (carry.p, carry.r), torch.zeros_like(carry.r)

    return VisitAlgebra(
        name="push", identity=0.0, source_value=1.0, plane_init=(0.0, 0.0),
        combine=torch.add, begin=begin, active=active, step=step,
        emit_payload=lambda carry: carry.acc,
        emit_mask=lambda carry: carry.acc > 0,
        contrib=spread, pending=pending, prio_of=prio_of, finish=finish,
        params=(("alpha", float(alpha)), ("eps", float(eps))))


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
                     block_size: int, sources: np.ndarray,
                     init_ops: Optional[np.ndarray] = None):
    """Host-side (planes, buf) with one source op buffered per query lane.

    ``sources``: [k] reordered vertex ids, k <= num_queries — lane ``i``
    gets ``sources[i]``; remaining lanes start empty.  ``buf`` carries the
    trash row ``P``.

    ``init_ops``: optional ``[P, B]`` plane of buffered ops broadcast to
    every query lane before the sources are injected — cc starts from its
    label plane (:func:`cc_label_plane`) instead of a one-hot source.
    Cells holding ``algebra.identity`` stay empty.
    """
    P, Q, B = num_parts, num_queries, block_size
    planes = tuple(np.full((P, Q, B), v, dtype=np.float32)
                   for v in algebra.plane_init)
    buf = np.full((P + 1, Q, B), algebra.identity, dtype=np.float32)
    if init_ops is not None:
        buf[:P] = np.asarray(init_ops, dtype=np.float32)[:, None, :]
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


def cc_label_plane(bg) -> np.ndarray:
    """[P, B] initial cc label ops: every real vertex seeds its own
    reordered id as an f32 minplus op; padding slots hold the identity
    (+inf).  Shared by every cc backend, so the propagated fixpoint is the
    same plane bit for bit (integer-valued f32 mins, exact below 2^24
    vertices)."""
    P, B = bg.num_parts, bg.block_size
    ids = np.arange(P * B, dtype=np.float32).reshape(P, B)
    return np.where(np.asarray(bg.vmask), ids, np.float32(np.inf))


def init_engine_state(algebra: VisitAlgebra, dg, sources: np.ndarray,
                      num_queries: Optional[int] = None,
                      init_ops: Optional[np.ndarray] = None) -> VisitState:
    """Device state for the engine, on ``dg.device``: one query lane per
    source, or ``num_queries`` lanes (``init_ops``: see
    :func:`init_dense_state`)."""
    Q = int(num_queries if num_queries is not None else len(sources))
    planes_np, buf_np = init_dense_state(
        algebra, dg.num_parts, Q, dg.block_size, sources, init_ops=init_ops)
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
            # fppcheck: allow-host-read: the relax loop's exit test
            # (counted in syncs)
            if not bool(act.any()):
                break
            eq += torch.where(act, nnz_pp, 0).sum(dim=1, dtype=torch.int32)
            carry = algebra.step(carry, act, dg, kd, deg_p)
            rounds += 1

        # emission to neighbour partitions (Alg. 2 line 16): one batched
        # contrib over all neighbour blocks, whose lists the kernel walks in
        # place
        payload = algebra.emit_payload(carry)
        emask = algebra.emit_mask(carry)
        nbr_blk = dg.nbr_blk.index_select(0, p)[0]                # [dmax]
        jj = dg.nbr_dst.index_select(0, p)[0]     # [dmax], P = trash slot
        j0 = dg.nbr_src.index_select(0, p)[0]     # [dmax], clamped to 0
        cands = algebra.contrib(payload, dg, nbr_blk)             # [dmax,Q,B]
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


class MegastepStats(NamedTuple):
    """Per-chunk accumulators, harvested once per host dispatch."""
    visits: int                 # visits executed this chunk (<= K)
    rounds: int                 # total relaxation rounds
    eq_hi: torch.Tensor         # [Q] i32: per-query edge count, high lane
    eq_lo: torch.Tensor         # [Q] i32: low lane (< 2**EDGE_SHIFT)
    visit_counts: torch.Tensor  # [P] i32: visits per partition
    order: torch.Tensor         # [K] i32 visit-order ring (-1 = unused slot)
    device_syncs: int           # reads back to the host this chunk
    lane_pending: Optional[torch.Tensor]  # [Q] bool on the host: the query
    #                             lane still has a pending op anywhere
    #                             (harvest_mask=True only, else None)
    key: Optional[torch.Tensor]  # threefry key to carry into the next chunk


def _lane_pending(dg, algebra: VisitAlgebra, state: VisitState):
    """[Q] bool on the state's device: lanes with a pending op anywhere."""
    P = dg.num_parts
    return algebra.pending(state.buf[:P], state.planes, dg.deg).any(
        dim=2).any(dim=0)


def make_megastep(dg, algebra: VisitAlgebra, max_rounds: int,
                  policy: str = "priority", K: int = 64,
                  harvest_mask: bool = False, fused: bool = False,
                  frontier_mode: str = "dense") -> Callable:
    """Scheduling loop: up to K visits per host dispatch, the scheduler's
    choice made on the device from the ``[P]`` prio/stamp/ops planes.

    Returns ``megastep(state, counter, limit, key=None) -> (state,
    stats)``: ``counter`` is the global visit counter at chunk start,
    ``limit`` caps this chunk at ``min(limit, K)`` visits, and the loop
    exits early when no partition holds a pending op — ``stats.visits <
    limit`` is the host's termination signal.  Edge counters carry an exact
    ``(hi, lo)`` int32 pair per query.

    ``key`` is the threefry key (``core/prng``, int64 ``[2]`` on the
    state's device) the ``random`` policy draws from; it is split once per
    visit, and only under ``random`` (``key, sub = split(key)``, as the
    reference's loop body), so a chunk that finds nothing pending leaves
    it as it was and the order does not depend on K.  ``stats.key`` is the
    key to carry into the next chunk; the argument is not changed.  Other
    policies ignore it.

    ``harvest_mask=True`` also reduces the per-query pending-lane mask of
    the chunk-end state into ``stats.lane_pending`` (the streaming
    executor's harvest): on the fused path it is read back in the same
    transfer as the chunk's stats.

    ``fused=True`` runs the whole loop as one launch of the fused visit
    kernel (``kernels/fused_visit``): selection, up to ``min(limit, K)``
    visits and the stats stay on the device, and the host reads the stats
    once per chunk (``device_syncs`` is 1).  On the CPU each visit is the
    kernel's plain version.  Bit-identical to the unfused loop for
    minplus, and for push on the same device (the spread sums in one order
    on each).  ``frontier_mode="sparse"`` (minplus only) lets the kernel
    skip query rows whose sources are all +inf: identical bits, less work
    on thin frontiers.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown scheduling policy {policy!r}; "
                         f"one of {POLICIES}")
    if K < 1:
        raise ValueError(f"megastep chunk size K must be >= 1, got {K}")
    P = dg.num_parts
    if fused:
        return _make_fused_megastep(dg, algebra, max_rounds, policy, K,
                                    frontier_mode, harvest_mask)
    if frontier_mode != "dense":
        raise ValueError(
            "frontier_mode is a fused-kernel switch; the unfused megastep "
            "always runs the dense frontier math")
    visit = make_visit(dg, algebra, max_rounds)
    rand = policy == "random"

    def megastep(state: VisitState, counter: int, limit: int,
                 key: Optional[torch.Tensor] = None):
        if rand and key is None:
            raise ValueError("the random policy draws from a threefry key; "
                             "pass key=")
        limit_k = min(int(limit), K)
        Q, dev = state.buf.shape[1], state.buf.device
        hi = torch.zeros(Q, dtype=torch.int32, device=dev)
        lo = torch.zeros(Q, dtype=torch.int32, device=dev)
        counts = torch.zeros(P, dtype=torch.int32, device=dev)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        order = torch.full((K,), -1, dtype=torch.int32, device=dev)
        prio, stamp, ops = state.prio[:P], state.stamp[:P], state.ops_count[:P]
        k = rounds = syncs = 0
        sub = None
        while k < limit_k:
            syncs += 1
            # fppcheck: allow-host-read: the K-visit loop's exit test
            # (counted in syncs)
            if not bool(torch.isfinite(prio).any()):
                break
            if rand:                       # only the random policy
                key, sub = prng.split(key)  # consumes entropy
            p = device_select(policy, prio, stamp, ops, sub)
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
        pending = None
        if harvest_mask:
            pending = _lane_pending(dg, algebra, state).cpu()
            syncs += 1
        return state, MegastepStats(visits=k, rounds=rounds, eq_hi=hi,
                                    eq_lo=lo, visit_counts=counts,
                                    order=order, device_syncs=syncs,
                                    lane_pending=pending, key=key)

    return megastep


def _make_fused_megastep(dg, algebra: VisitAlgebra, max_rounds: int,
                         policy: str, K: int, frontier_mode: str,
                         harvest_mask: bool) -> Callable:
    """The fused arm of :func:`make_megastep`: one kernel launch and one
    read per chunk (the stats, with the pending-lane mask behind them)."""
    P = dg.num_parts
    fv = make_fused_visit(dg, algebra, max_rounds, policy=policy,
                          frontier_mode=frontier_mode, K=K)

    def megastep(state: VisitState, counter: int, limit: int,
                 key: Optional[torch.Tensor] = None):
        Q = state.buf.shape[1]
        # the kernel's carry (fv.chunk rejects a missing key under random)
        key = None if key is None else key.clone()
        stats = fv.chunk(state, counter, min(int(limit), K), key=key)
        pending = None
        if harvest_mask:
            stats = torch.cat([stats, _lane_pending(dg, algebra, state).to(
                torch.int32)])
        stats = stats.cpu()                # the chunk's one read
        if harvest_mask:
            stats, pending = stats[:-Q], stats[-Q:].bool()
        hi, lo, counts, order = split_stats(stats, Q, P)
        return state, MegastepStats(
            visits=int(stats[0]), rounds=int(stats[1]), eq_hi=hi, eq_lo=lo,
            visit_counts=counts, order=order, device_syncs=1,
            lane_pending=pending, key=key)

    return megastep


def harvest_chunk(ms: MegastepStats):
    """``(eq_hi, eq_lo, visit_counts, order)`` of a chunk as int32 numpy
    arrays, in one read (the fused path's are on the host already)."""
    Q, P = ms.eq_hi.shape[0], ms.visit_counts.shape[0]
    host = torch.cat([ms.eq_hi, ms.eq_lo, ms.visit_counts,
                      ms.order]).cpu().numpy()
    return (host[:Q], host[Q:2 * Q], host[2 * Q:2 * Q + P],
            host[2 * Q + P:])


def harvest_edges(eq_hi: np.ndarray, eq_lo: np.ndarray) -> np.ndarray:
    """Fold a harvested (hi, lo) int32 pair into exact float64 edge counts."""
    return (np.asarray(eq_hi, dtype=np.float64) * float(1 << EDGE_SHIFT)
            + np.asarray(eq_lo, dtype=np.float64))


# ---------------------------------------------------------------------------
# the superstep of the distributed runtime (core/distributed.py)


def superstep(slab, planes, buf, *, algebra: VisitAlgebra, max_rounds: int,
              mesh, part_axis: str = "model"):
    """One superstep on one rank's shard: visit the rank's best-priority
    partition, then exchange boundary ops with one ``all_to_all`` over
    ``part_axis``.

    ``slab`` is the rank's :class:`~repro_torch.core.distributed.Slab`;
    ``planes`` (each ``[pl, Qs, B]``) and ``buf`` (``[pl, Qs, B]``, no
    trash row) are updated in place.  Returns ``(eq int32 [Qs], rounds,
    syncs)``: this superstep's edges per query lane, relax rounds and
    reads back to the host (one per relax exit test, one for the arriving
    slot destinations).

    When every priority is +inf it still visits partition 0, a no-op, as
    the reference's argmin does, so supersteps and edges match it.  The
    relax goes through ``algebra.step`` (B1 or B2 on the diagonal block),
    the emissions are one ``algebra.contrib`` call over the ``dmax``
    neighbour slots, and what arrives is applied in the reference's order,
    ``i = 0 .. ndev*dmax - 1`` (ppr's summation order).
    """
    pl, dmax, ndev = slab.pl, slab.dmax, slab.ndev
    prio, _ = algebra.prio_of(buf, planes, slab.deg)              # [pl]
    p = torch.argmin(prio).view(1)       # first minimum; all +inf -> 0
    kd = p * (1 + dmax)                  # the diagonal block's slab index
    nnz_all = slab.row_nnz.index_select(0, p)[0]                  # [1+dmax,B]
    nnz_pp = nnz_all[0]
    deg_p = slab.deg.index_select(0, p)[0]
    budget = slab.edge_budget.index_select(0, p)                  # [1]
    planes_row = tuple(x.index_select(0, p)[0] for x in planes)
    buf_row = buf.index_select(0, p)[0]
    carry = algebra.begin(planes_row, buf_row, deg_p)
    Qs, B = buf_row.shape

    eq = torch.zeros(Qs, dtype=torch.int32, device=buf.device)
    rounds = syncs = 0
    while rounds < max_rounds:
        act = algebra.active(carry, deg_p, eq, budget)
        syncs += 1
        # fppcheck: allow-host-read: the relax loop's exit test (counted
        # in syncs)
        if not bool(act.any()):
            break
        eq += torch.where(act, nnz_pp, 0).sum(dim=1, dtype=torch.int32)
        carry = algebra.step(carry, act, slab, kd, deg_p)
        rounds += 1

    # emissions: one contribution per (padded) out-slot, routed to the
    # owner rank of its destination partition; row ndev is a trash row for
    # the padding slots
    pay = torch.full((ndev + 1, dmax, Qs, B), algebra.identity,
                     dtype=buf.dtype, device=buf.device)
    slot_dst = torch.full((ndev + 1, dmax), -1, dtype=torch.int64,
                          device=buf.device)
    if dmax:
        payload = algebra.emit_payload(carry)
        emask = algebra.emit_mask(carry)
        slots = torch.arange(dmax, device=buf.device)
        cands = algebra.contrib(payload, slab, kd + 1 + slots)   # [dmax,Qs,B]
        eq += torch.where(emask, nnz_all[1:].sum(dim=0), 0).sum(
            dim=1, dtype=torch.int32)
        dsts = slab.dst_part.index_select(0, p)[0, 1:]           # [dmax]
        valid = dsts >= 0
        owner = torch.where(valid, dsts // pl, ndev)
        pay[owner, slots] = cands
        slot_dst[owner, slots] = torch.where(valid, dsts % pl, -1)
    recv = mesh.all_to_all(pay[:ndev], part_axis)
    recv_dst = mesh.all_to_all(slot_dst[:ndev], part_axis)

    # write back own planes and yielded ops, then apply what arrived
    new_rows, keep_row = algebra.finish(carry, deg_p)
    buf.index_copy_(0, p, keep_row[None])
    for x, nr in zip(planes, new_rows):
        x.index_copy_(0, p, nr[None])
    flat = recv.reshape(ndev * dmax, Qs, B)
    syncs += 1
    # fppcheck: allow-host-read: the arriving slots' destinations, one read
    # a superstep (counted in syncs): ppr applies them in the reference's
    # order, which a device scatter would not keep
    for i, l in enumerate(recv_dst.reshape(-1).tolist()):
        if l >= 0:
            buf[l] = algebra.combine(buf[l], flat[i])
    return eq, rounds, syncs
