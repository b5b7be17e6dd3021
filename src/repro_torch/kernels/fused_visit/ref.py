"""Plain PyTorch version of the fused visit kernel
(``csrc/fused_visit.cu``), one visit at a time.

One visit is one iteration of the engine's K-visit loop, which one launch
of the kernel runs up to K times: select a partition on the ``[P]``
metadata (nothing happens when no priority is finite), run its whole
visit, and update the chunk's stats.  :func:`fused_step_ref` runs the same
steps with torch ops, on any device, built from ``frontier_ref``,
``push_ref``, the batched contraction entry of ``kernels/minplus``, the
scheduler's ``device_select`` and the algebra's ``combine`` and
``prio_of``: what the CPU path runs per visit and what the kernel is held
against on the card.  Unlike the unfused visit it never touches the trash
slot ``P``: a padded neighbour slot is skipped, as the kernel skips it.

The kernel contracts over the column lists of each block's finite entries
(``core/engine.column_lists``) with the tile of ``csrc/minplus.cu``; its
per-cell order is ``kernels/minplus/ref.list_contract_ref``.

State (duck-typed ``core.visit.VisitState``): ``planes`` ``[P, Q, B]`` each,
``buf [P+1, Q, B]``, ``prio``/``ops_count``/``stamp`` ``[P+1]``.  The chunk's
stats are one int32 vector, laid out by :func:`new_stats`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.scheduler import device_select
from repro_torch.kernels.frontier.ref import frontier_ref
from repro_torch.kernels.minplus import ops as minplus_ops
from repro_torch.kernels.ppr_push.ref import push_ref

INF = float("inf")
#: mirror core.visit's empty-buffer stamp and edge-counter spill unit
#: (core.visit imports this package, so it cannot be imported here)
_BIG_STAMP = np.iinfo(np.int32).max - 1
EDGE_SHIFT = 20
POLICIES = ("priority", "fifo", "max_ops", "random")


class FusedSpec(NamedTuple):
    """What one launch is compiled and called for."""
    algebra: Any        # core.visit.VisitAlgebra (minplus or push)
    policy: str         # one of POLICIES
    max_rounds: int
    sparse: bool        # min-plus only: skip all-+inf source columns
    K: int              # chunk size (length of the order ring)


def new_stats(num_queries: int, num_parts: int, K: int,
              device) -> torch.Tensor:
    """A chunk's stats, one int32 vector ``[2 + 2Q + P + K]``:
    ``[k, rounds, eq_hi[Q], eq_lo[Q], visit_counts[P], order[K]]``, with
    the order ring at -1."""
    head = 2 + 2 * num_queries + num_parts
    s = torch.zeros(head + K, dtype=torch.int32, device=device)
    s[head:] = -1
    return s


def split_stats(stats: torch.Tensor, num_queries: int, num_parts: int):
    """``(eq_hi, eq_lo, visit_counts, order)`` views of ``stats``."""
    q, p = num_queries, num_parts
    return (stats[2:2 + q], stats[2 + q:2 + 2 * q],
            stats[2 + 2 * q:2 + 2 * q + p], stats[2 + 2 * q + p:])


def fused_step_ref(dg, spec: FusedSpec, state, stats: torch.Tensor,
                   counter: int, key: torch.Tensor | None = None,
                   on_contract=None) -> None:
    """One visit, in place on ``state`` and ``stats``.

    ``dg`` is the engine's ``DeviceGraph`` (duck-typed), ``counter`` the
    global visit counter at the chunk's start; the visit stamps
    ``counter + k``.  Under the ``random`` policy ``key`` (int64 ``[2]``,
    ``core/prng``) is split in place when a partition is pending: it
    becomes the split's first key and the draw takes the second, as the
    kernel carries it.  ``on_contract(x, idx)``, if given, sees every
    contraction's sources and block indices (a work count for a bound).
    """
    P = dg.num_parts
    Q = state.buf.shape[1]
    alg = spec.algebra
    k = int(stats[0])
    if k >= spec.K or not bool(torch.isfinite(state.prio[:P]).any()):
        return
    sub = None
    if spec.policy == "random":
        keys = prng.split(key)
        key.copy_(keys[0])
        sub = keys[1]
    p = int(device_select(spec.policy, state.prio[:P], state.stamp[:P],
                          state.ops_count[:P], sub))
    cnt = counter + k
    kd = dg.diag_blk[p:p + 1]
    nnz = dg.row_nnz[int(kd)]
    deg_p = dg.deg[p]
    budget = dg.edge_budget[p]
    minplus = alg.name == "minplus"
    name = "minplus" if minplus else "masked_matmul"

    def contract(x, idx):
        if on_contract is not None:
            on_contract(x, idx)
        return minplus_ops.plain(name, x, dg.dense_blocks(), idx)

    eq = torch.zeros(Q, dtype=torch.int32, device=state.buf.device)
    rounds = 0
    if minplus:
        window = alg.param("window")
        d, _, alpha, pending, _ = frontier_ref(
            state.buf[p], state.planes[0][p], delta=window,
            strict=bool(alg.param("strict")))
        emit = torch.zeros_like(pending)
        while rounds < spec.max_rounds:
            act = (pending & (d <= alpha + window)
                   & (eq.to(torch.float32) < budget)[:, None])
            if not bool(act.any()):
                break
            eq += torch.where(act, nnz, 0).sum(dim=1, dtype=torch.int32)
            nd = contract(torch.where(act, d, INF), kd)[0]
            improved = nd < d
            d = torch.minimum(d, nd)
            pending = (pending & ~act) | improved
            emit = emit | act
            rounds += 1
        payload, emask = torch.where(emit, d, INF), emit
        new_planes, keep = (d,), torch.where(pending, d, INF)
    else:
        alpha, eps = alg.param("alpha"), alg.param("eps")
        pv, rv = state.planes[0][p], state.planes[1][p] + state.buf[p]
        av = torch.zeros_like(rv)
        degc = torch.clamp(deg_p, min=1).to(torch.float32)
        while rounds < spec.max_rounds:
            lane = (eq.to(torch.float32) < budget)[:, None]
            act = (rv >= eps * degc) & (deg_p > 0) & lane
            if not bool(act.any()):
                break
            eq += torch.where(act, nnz, 0).sum(dim=1, dtype=torch.int32)
            pv, rv, av, _ = push_ref(
                pv, rv, av, None, deg_p, alpha=alpha, eps=eps,
                lane_mask=lane, spread=lambda x: contract(x, kd)[0])
            rounds += 1
        payload, emask = av, av > 0
        new_planes, keep = (pv, rv), torch.zeros_like(rv)

    # emission: one batched contraction over the neighbour list (padded
    # slots give the identity plane), then each valid slot in turn
    eq += torch.where(emask, dg.nbr_nnz[p], 0).sum(dim=1, dtype=torch.int32)
    cands = contract(payload, dg.nbr_blk[p])
    blks, dsts = dg.nbr_blk[p].tolist(), dg.nbr_dst[p].tolist()
    for s, (blk, j) in enumerate(zip(blks, dsts)):
        if blk < 0:
            continue
        vals = alg.combine(state.buf[j], cands[s])
        state.buf[j] = vals
        newprio, newops = alg.prio_of(vals, tuple(x[j] for x in state.planes),
                                      dg.deg[j])
        was_empty = not bool(torch.isfinite(state.prio[j]))
        state.prio[j] = newprio
        state.ops_count[j] = newops
        if was_empty and bool(torch.isfinite(newprio)):
            state.stamp[j] = cnt

    # write back the row, keep its unrelaxed ops, refresh its metadata
    for x, nr in zip(state.planes, new_planes):
        x[p] = nr
    state.buf[p] = keep
    own_prio, own_ops = alg.prio_of(keep, new_planes, deg_p)
    state.prio[p] = own_prio
    state.ops_count[p] = own_ops
    state.stamp[p] = cnt if bool(torch.isfinite(own_prio)) else _BIG_STAMP

    hi, lo, counts, order = split_stats(stats, Q, P)
    lo += eq
    spill = lo >> EDGE_SHIFT
    hi += spill
    lo -= spill << EDGE_SHIFT
    counts[p] += 1
    order[k] = p
    stats[1] += rounds
    stats[0] = k + 1
