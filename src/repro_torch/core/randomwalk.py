"""Buffered random walks (the paper's RW query type).

The port of the JAX package's ``repro.core.randomwalk``.  Walkers are FPP
queries: a visit of partition ``p`` steps every walker resident in ``p``
until it leaves, finishes, or the visit's round cap, and the host picks
the partition holding the most live walkers next.

Randomness contract (the ``rw`` kind's invariant, held bit for bit
against the reference and ``oracles.random_walk``): walker ``src`` at
step ``t`` draws

    u = uniform(fold_in(fold_in(PRNGKey(seed), src), t))

(``core/prng``; on the card one launch of the threefry kernel for every
walker of a round, ``prng.tape_uniform``) and takes the
``min(floor(u * deg), deg - 1)``-th finite entry of its block-layout
adjacency row: the diagonal block's row first, then the ``nbr_blk``
slots in order.  The trajectory is a function of (graph, seed, source,
length) only, so the engine's visit loop, the baselines' synchronous
rounds and the streaming lanes walk the same walks.

Where the reference gathers each walker's whole dense row (the diagonal
block's and every neighbour block's) and scans it for the
``(idx+1)``-th finite entry, the port lays the rows out once, on the
host, as per-vertex lists of their finite entries' destinations in that
same order (:class:`WalkGraph`): a step reads ``deg`` and one
destination per walker, and picks the same entry.  The card's
``DeviceGraph`` stages no dense blocks, so this is also what lets a step
run there without them.

Where eager PyTorch differs from the traced reference: the visit's round
loop reads its exit test back to the host once a round, and the host
reads the walkers' partitions and steps once a visit to choose the next
one; ``WalkResult.device_syncs`` counts both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.engine import resolve_device
from repro_torch.core.graph import BlockGraph
from repro_torch.kernels.threefry.ref import M32

#: the trajectory hash's multiplier (uint32 arithmetic)
HASH_MUL = 1000003


@dataclasses.dataclass
class WalkResult:
    positions: np.ndarray        # [Q] int32 final vertex (reordered padded ids)
    steps: np.ndarray            # [Q] int32
    trajectory_hash: np.ndarray  # [Q] uint32 order-sensitive hash
    visits: int
    occupancy: Optional[np.ndarray] = None  # [Q, n] f32 visit counts
    #                                         (start + each step's position)
    rounds: int = 0              # steps of the walker loop, all visits
    device_syncs: int = 0        # reads back to the host


def walk_lists(bg: BlockGraph):
    """Every padded vertex's adjacency row in tape order, as lists of its
    finite entries' destinations: ``(wptr [P*B + 1] int64, wdst [nnz]
    int64)``, vertex ``v``'s entries ``wdst[wptr[v]:wptr[v + 1]]``.  Row
    ``l`` of partition ``p`` is block ``diag_blk[p]``'s row ``l``, then
    block ``nbr_blk[p, j]``'s row ``l`` for each slot ``j`` with
    ``nbr_blk >= 0`` (the reference's mask), each in ascending column; an
    entry in column ``c`` of slot ``j`` leads to ``part * B + c`` with
    ``part`` = ``p`` on the diagonal, else ``nbr_part[p, j]`` (0 where
    that is padding, as the reference's stepper maps it)."""
    P, B = bg.num_parts, bg.block_size
    blocks = np.asarray(bg.blocks)
    nblk = blocks.shape[0]
    # each block's finite entries by row, ascending column (C order)
    kk, uu, vv = np.nonzero(np.isfinite(blocks))
    row_cnt = np.bincount(kk * B + uu, minlength=nblk * B).reshape(nblk, B)
    row_start = np.zeros(nblk * B, dtype=np.int64)
    np.cumsum(row_cnt.reshape(-1)[:-1], out=row_start[1:])
    row_start = row_start.reshape(nblk, B)
    # segments in tape order: vertex (p, l) major, then slot s
    blk = np.concatenate([np.asarray(bg.diag_blk)[:, None],
                          np.asarray(bg.nbr_blk)], axis=1)          # [P, S]
    dest = np.concatenate([np.arange(P)[:, None],
                           np.where(np.asarray(bg.nbr_part) >= 0,
                                    bg.nbr_part, 0)], axis=1)       # [P, S]
    valid = blk >= 0
    safe = np.where(valid, blk, 0)
    cnt = np.where(valid[:, None, :],
                   row_cnt[safe].transpose(0, 2, 1), 0)             # [P, B, S]
    st = row_start[safe].transpose(0, 2, 1)                         # [P, B, S]
    cnt, st = cnt.reshape(-1), st.reshape(-1)
    dst = np.broadcast_to(dest[:, None, :], (P, B, dest.shape[1])).reshape(-1)
    seg_off = np.zeros(cnt.size, dtype=np.int64)
    np.cumsum(cnt[:-1], out=seg_off[1:])
    total = int(cnt.sum())
    within = np.arange(total, dtype=np.int64) - np.repeat(seg_off, cnt)
    flat = np.repeat(st, cnt) + within
    wdst = np.repeat(dst, cnt).astype(np.int64) * B + vv[flat]
    deg = cnt.reshape(P * B, -1).sum(axis=1)
    wptr = np.zeros(P * B + 1, dtype=np.int64)
    np.cumsum(deg, out=wptr[1:])
    return wptr, wdst.astype(np.int64)


@dataclasses.dataclass
class WalkGraph:
    """The walk lists (:func:`walk_lists`) staged on one device."""
    wptr: torch.Tensor      # [P*B + 1] int64
    wdst: torch.Tensor      # [nnz] int64
    num_parts: int
    block_size: int
    device: torch.device

    @staticmethod
    def build(bg: BlockGraph, device=None) -> "WalkGraph":
        dev = resolve_device(device)
        wptr, wdst = walk_lists(bg)
        return WalkGraph(torch.from_numpy(wptr).to(dev),
                         torch.from_numpy(wdst).to(dev), bg.num_parts,
                         bg.block_size, dev)


def stepper_from_arrays(wptr: torch.Tensor, wdst: torch.Tensor,
                        block_size: int, length: int,
                        key0: torch.Tensor) -> Callable:
    """The one-step transition shared by every rw runtime.

    ``step(pos, steps, part, src, thash, occ, mask) -> (pos', steps',
    part', thash')`` advances every walker in ``mask`` by one tape entry
    (walkers on sinks park with ``steps = length``) and adds each move to
    ``occ [Q, P*B]`` in place.  ``steps`` is int32 ``[Q]``, the other
    arrays int64 ``[Q]``; ``src`` is the walker's tape id (its source
    vertex, reordered ids) and ``thash`` holds uint32 values (int64 masked
    to 32 bits: torch's uint32 arithmetic is partial).
    """
    B = int(block_size)
    last = max(int(wdst.shape[0]) - 1, 0)
    dsts = wdst if wdst.numel() else torch.zeros(1, dtype=torch.int64,
                                                  device=wptr.device)

    def step(pos, steps, part, src, thash, occ, mask):
        start = wptr.index_select(0, pos)
        deg = wptr.index_select(0, pos + 1) - start
        u = prng.tape_uniform(key0, src, steps)                    # [Q] f32
        idx = torch.floor(u * deg.to(torch.float32)).to(torch.int64)
        idx = torch.minimum(idx.clamp(min=0), (deg - 1).clamp(min=0))
        new_pos = dsts.index_select(0, (start + idx).clamp(max=last))
        has_nbr = deg > 0
        move = mask & has_nbr
        steps = torch.where(mask & ~has_nbr, length, steps)
        pos = torch.where(move, new_pos, pos)
        part = torch.where(move, new_pos // B, part)
        steps = torch.where(move, steps + 1, steps)
        thash = torch.where(move, (thash * HASH_MUL + new_pos) & M32, thash)
        rows = torch.arange(pos.shape[0], device=pos.device)
        occ.index_put_((rows, torch.where(move, new_pos, pos)),
                       move.to(occ.dtype), accumulate=True)
        return pos, steps, part, thash

    return step


def make_walk_stepper(wg: WalkGraph, length: int, seed: int) -> Callable:
    """:func:`stepper_from_arrays` over a staged :class:`WalkGraph`."""
    return stepper_from_arrays(wg.wptr, wg.wdst, wg.block_size, length,
                               prng.PRNGKey(seed, wg.device))


def make_walk_visit(wg: WalkGraph, length: int, seed: int,
                    max_rounds: int = 64) -> Callable:
    """The rw visit: steps all walkers resident in partition ``p`` until
    they leave it, finish, or ``max_rounds``.

    ``visit(pos, steps, part, src, thash, occ, p) -> (pos, steps, part,
    thash, rounds, syncs)``: ``p`` a host int, ``occ`` updated in place,
    ``rounds`` the steps taken and ``syncs`` the exit tests read back.
    """
    step = make_walk_stepper(wg, length, seed)

    def visit(pos, steps, part, src, thash, occ, p: int):
        rounds = syncs = 0
        while rounds < max_rounds:
            here = (part == p) & (steps < length)
            syncs += 1
            # fppcheck: allow-host-read: the round loop's exit test
            # (counted in syncs)
            if not bool(here.any()):
                break
            pos, steps, part, thash = step(pos, steps, part, src, thash,
                                           occ, here)
            rounds += 1
        return pos, steps, part, thash, rounds, syncs

    return visit


def init_walk_state(wg: WalkGraph, sources: np.ndarray):
    """(pos, steps, part, src, thash, occ) on ``wg.device``; occupancy
    starts with the source position counted once per lane.  ``steps`` is
    the int32 step counter (the reference's); the others are int64."""
    srcs = np.asarray(sources, dtype=np.int64)
    Q, dev = srcs.size, wg.device
    occ = torch.zeros((Q, wg.num_parts * wg.block_size), dtype=torch.float32,
                      device=dev)
    s = torch.from_numpy(srcs).to(dev)
    occ[torch.arange(Q, device=dev), s] = 1.0
    return (s.clone(), torch.zeros(Q, dtype=torch.int32, device=dev),
            s // wg.block_size, s.clone(), s.clone(), occ)


def walk_result(pos, steps, thash, occ, n: int, visits: int, rounds: int,
                syncs: int) -> WalkResult:
    """The device state as a :class:`WalkResult` (the reference's
    dtypes), read back in one transfer per tensor."""
    return WalkResult(pos.cpu().numpy().astype(np.int32),
                      steps.cpu().numpy().astype(np.int32),
                      thash.cpu().numpy().astype(np.uint32), visits,
                      occupancy=occ[:, :n].cpu().numpy(), rounds=rounds,
                      device_syncs=syncs)


def run_random_walks(bg: BlockGraph, sources: np.ndarray, length: int,
                     seed: int = 0, max_rounds_per_visit: int = 64,
                     device=None) -> WalkResult:
    """Walk ``length`` steps from each source; walkers at sink vertices
    stop.  The host picks the partition with the most live walkers (the
    cache-greedy choice, right for walks: they do no redundant work)."""
    wg = WalkGraph.build(bg, device)
    P, Q = wg.num_parts, len(sources)
    visit = make_walk_visit(wg, length, seed, max_rounds=max_rounds_per_visit)
    pos, steps, part, src, thash, occ = init_walk_state(wg, sources)
    visits = rounds = syncs = 0
    while True:
        # fppcheck: allow-host-read: the host picks the next partition
        # from every walker's partition and steps, one read a visit
        part_np, steps_np = torch.stack([part, steps]).cpu().numpy()
        syncs += 1
        live = steps_np < length
        if not live.any():
            break
        p = int(np.argmax(np.bincount(part_np[live], minlength=P)))
        pos, steps, part, thash, r, s = visit(pos, steps, part, src, thash,
                                              occ, p)
        visits += 1
        rounds += r
        syncs += s
        if visits > Q * length + P:  # safety; unreachable in practice
            break
    return walk_result(pos, steps, thash, occ, bg.n, visits, rounds, syncs)
