"""Streaming FPP execution: queries that arrive over time.

The port of the JAX package's ``repro.fpp.streaming``.  The engine state
carries ``capacity`` query lanes, and between K-visit chunks the executor

  * **admits** queued queries into free lanes by buffering their source op
    (how a one-shot run starts, so a late arrival is indistinguishable
    from an early one), and
  * **harvests** lanes whose queries have no pending op anywhere (queries
    are independent, so per-lane completion is exact), records their
    values, and recycles the lane.

The visits between those boundaries are the engine's megastep
(``core/visit.make_megastep``, built with ``harvest_mask=True``): the
pending-lane mask comes back with the chunk's stats.  On the fused path
the mask is reduced on the card after the launch and read in the same
transfer as the stats, so a chunk stays one launch and one read.  Because
scheduling and yielding never change results and admission only adds ops
a one-shot run starts with, a staggered run gives the min-plus kinds' and
rw's answers of the one-shot run of the union bit for bit, and ppr's
within its eps tolerance.

Concurrency contract: every public entry point — ``submit``, ``step``,
``pump``, ``run``, ``take_finished`` — takes one executor lock, and
``pump`` holds it for whole chunks, so a submitter on another thread joins
exactly at a chunk boundary, the only point where touching lanes is legal.

Where eager PyTorch differs from the traced reference: admission updates
the state tensors in place and on the device (the stamp of a partition
that comes alive is set by a ``where``, not after a read back), and a
harvest reads the finished lanes' planes in one transfer.  Nothing is
traced or compiled, so what the reference's ``megastep=``/``visit=``
injection hands over (a compiled executable) is here a built bundle: a
:class:`StreamBundle` (the engine, whose ``DeviceGraph`` holds the staged
graph and its column lists, and its streaming megastep) or a
:class:`WalkBundle`.  An executor given one builds nothing; one bundle
may serve several executors at once (``serve/compile_cache.py``), so an
executor keeps every mutable array in its own state and lane tensors and
only reads the bundle.
"""
from __future__ import annotations

import abc
import collections
import dataclasses
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import visit as _visit
from repro_torch.core.engine import FPPEngine
from repro_torch.core.oracles import decode_kreach
from repro_torch.core.queries import WEIGHT_VARIANTS
from repro_torch.core.randomwalk import WalkGraph, make_walk_visit
from repro_torch.core.scheduler import PartitionScheduler
from repro_torch.core.yielding import YieldConfig
from repro_torch.fpp import planner as _planner
from repro_torch.fpp.backends import _ENGINE_MODE, canonicalize_cc

STREAM_KINDS = ("sssp", "bfs", "ppr", "cc", "kreach")


def build_stream_engine(session, kind: str, capacity: int, *,
                        schedule: str = "priority",
                        yield_config: Optional[YieldConfig] = None,
                        alpha: float = 0.15, eps: float = 1e-4,
                        seed: int = 0, k_visits: int = 64,
                        fused: bool = False,
                        k: int = 8) -> Tuple[FPPEngine, object, np.ndarray]:
    """(engine, bg, perm) as a :class:`StreamingExecutor` for the same
    arguments builds them, on the session's device: the graph staging
    (``session.prepared``, cached per session), yield config, algebra
    parameters and chunk size all come from here.  ``k`` is the kreach hop
    budget (ignored by other kinds); the stride comes from the session so
    the shift variant and the decode cannot disagree."""
    bg, perm = session.prepared(weights=WEIGHT_VARIANTS.get(kind, "natural"))
    yc = (yield_config if yield_config is not None
          else _planner.default_yield_config(kind, bg))
    engine = FPPEngine(bg, mode=_ENGINE_MODE[kind], num_queries=int(capacity),
                       yield_config=yc, schedule=schedule, alpha=alpha,
                       eps=eps, seed=seed, k_visits=int(k_visits),
                       fused=bool(fused), hop_budget=int(k),
                       hop_stride=(session.kreach_stride
                                   if kind == "kreach" else 1.0),
                       device=session.device)
    return engine, bg, perm


def build_stream_megastep(engine: FPPEngine, schedule: str) -> Callable:
    """The streaming pump's megastep for ``engine``: the K-visit chunk with
    the ``[Q]`` pending-lane mask harvested in the same read
    (``harvest_mask=True``)."""
    return _visit.make_megastep(
        engine.dg, engine.algebra, engine.max_rounds, policy=schedule,
        K=engine.k_visits, harvest_mask=True, fused=engine.fused,
        frontier_mode=engine.frontier_mode)


class StreamBundle(NamedTuple):
    """A built streaming engine and its megastep, as
    :class:`StreamingExecutor` would build them for the same arguments."""
    engine: FPPEngine
    megastep: Callable


class WalkBundle(NamedTuple):
    """The walk lists staged on the device and the walk visit, as
    :class:`WalkExecutor` would build them for the same arguments."""
    wg: WalkGraph
    visit: Callable


def build_stream_bundle(session, kind: str, capacity: int, *,
                        schedule: str = "priority",
                        yield_config: Optional[YieldConfig] = None,
                        alpha: float = 0.15, eps: float = 1e-4,
                        seed: int = 0, k_visits: int = 64,
                        fused: bool = False, k: int = 8, length: int = 32,
                        walk_seed: int = 0):
    """The bundle an executor of these arguments builds: a
    :class:`WalkBundle` for ``kind="rw"`` (``length`` and ``walk_seed``),
    else a :class:`StreamBundle`."""
    if kind == "rw":
        bg, _ = session.prepared()
        wg = WalkGraph.build(bg, session.device)
        return WalkBundle(wg, make_walk_visit(wg, int(length),
                                              int(walk_seed)))
    engine, _, _ = build_stream_engine(
        session, kind, int(capacity), schedule=schedule,
        yield_config=yield_config, alpha=alpha, eps=eps, seed=seed,
        k_visits=k_visits, fused=fused, k=k)
    return StreamBundle(engine, build_stream_megastep(engine, schedule))


@dataclasses.dataclass
class StreamQuery:
    """One admitted-or-queued query and, eventually, its answer.

    The ``*_visit`` fields snapshot the executor's visit counter (queue
    wait = admitted - submitted, in-flight latency = finished - admitted,
    in visits the whole executor ran); the ``*_sync`` fields snapshot
    ``host_syncs`` the same way."""
    qid: int
    source: int                 # original vertex id
    slot: int = -1
    submitted_visit: int = -1
    admitted_visit: int = -1
    finished_visit: int = -1
    admitted_sync: int = -1
    finished_sync: int = -1
    values: Optional[np.ndarray] = None      # [n] original ids, on completion
    residual: Optional[np.ndarray] = None    # push (and kreach: hops)
    edges: float = 0.0
    done: bool = False


class _Lanes(abc.ABC):
    """The admission queue and lane bookkeeping both executors share; a
    subclass buffers a query into a lane (``_inject``), finishes lanes
    (``_harvest``) and advances its loop (``pump``)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self.finished: collections.deque = collections.deque()
        self.queue: collections.deque = collections.deque()
        self.queries: Dict[int, StreamQuery] = {}
        self.free_slots: List[int] = list(range(self.capacity))
        self.slot_qid = np.full(self.capacity, -1, dtype=np.int64)
        self.visits = 0
        self.modeled_bytes = 0.0
        self.host_syncs = 0
        self._next_qid = 0

    def submit(self, sources: np.ndarray) -> List[int]:
        """Enqueue a batch of sources (original ids); returns their qids.
        A submit racing a ``pump`` on another thread waits for the chunk's
        boundary and is admitted there."""
        with self._lock:
            qids = []
            for s in np.atleast_1d(np.asarray(sources)):
                q = StreamQuery(qid=self._next_qid, source=int(s),
                                submitted_visit=self.visits)
                self._next_qid += 1
                self.queries[q.qid] = q
                self.queue.append(q.qid)
                qids.append(q.qid)
            self._admit()
            return qids

    def _admit(self):
        while self.free_slots and self.queue:
            q = self.queries[self.queue.popleft()]
            slot = self.free_slots.pop(0)
            self._inject(q, slot)
            q.slot = slot
            q.admitted_visit = self.visits
            q.admitted_sync = self.host_syncs
            self.slot_qid[slot] = q.qid

    @abc.abstractmethod
    def _inject(self, q: StreamQuery, slot: int):
        """Start query ``q`` in lane ``slot``."""

    @abc.abstractmethod
    def _harvest(self):
        """Finish every lane whose query is done."""

    @abc.abstractmethod
    def pump(self, max_visits: int) -> int:
        """Advance up to ``max_visits`` visits; returns the visits run."""

    def _finish(self, slot: int, values, residual, edges: float):
        q = self.queries[int(self.slot_qid[slot])]
        q.values, q.residual, q.edges = values, residual, float(edges)
        q.finished_visit = self.visits
        q.finished_sync = self.host_syncs
        q.done = True
        self.finished.append(q.qid)
        self.slot_qid[slot] = -1
        self.free_slots.append(int(slot))

    @property
    def active(self) -> int:
        return int((self.slot_qid >= 0).sum())

    @property
    def queue_depth(self) -> int:
        """Submitted but not yet admitted queries."""
        return len(self.queue)

    def take_finished(self) -> List[int]:
        """The qids harvested since the last call, in completion order."""
        with self._lock:
            out = list(self.finished)
            self.finished.clear()
            return out

    def run(self, max_visits: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drain queue and lanes; returns {qid: values} (original ids)."""
        budget = max_visits or 2000 * self.bg.num_parts
        while (self.queue or self.active) and self.visits < budget:
            if self.pump(budget - self.visits) == 0:
                break
        with self._lock:
            self._harvest()
            return {qid: q.values
                    for qid, q in self.queries.items() if q.done}

    def result(self, qid: int) -> StreamQuery:
        return self.queries[qid]


class StreamingExecutor(_Lanes):
    """Admission queue and slot-recycling loop over the buffered engine.

    ``submit`` enqueues work, ``step`` runs one partition visit (admitting
    and harvesting around it), ``pump(n)`` advances up to ``n`` visits in
    chunks of up to ``k_visits``, and ``run`` drains everything submitted
    so far.  Admission and harvest happen only at chunk boundaries, so K
    is both the host-sync amortisation and the lane-recycling latency.

    ``megastep`` injects a prebuilt :class:`StreamBundle` for the same
    arguments (``serve/compile_cache.py``): the executor then builds no
    engine, ``DeviceGraph`` or column lists, only its own state.
    """

    def __init__(self, session, kind: str = "sssp", capacity: int = 16, *,
                 schedule: str = "priority",
                 yield_config: Optional[YieldConfig] = None,
                 alpha: float = 0.15, eps: float = 1e-4,
                 harvest_every: int = 1, seed: int = 0,
                 k_visits: int = 64, fused: bool = False,
                 megastep: Optional[StreamBundle] = None, k: int = 8):
        if kind not in STREAM_KINDS:
            raise ValueError(f"streaming supports {'/'.join(STREAM_KINDS)} "
                             f"(rw streams via WalkExecutor), got {kind!r}")
        super().__init__(capacity)
        self.session = session
        self.kind = kind
        self.alpha, self.eps = alpha, eps
        self.k = int(k)
        # the per-visit cadence of the step() path; pump()/run() harvest
        # at chunk boundaries instead
        self.harvest_every = max(1, int(harvest_every))
        bg, perm = session.prepared(
            weights=WEIGHT_VARIANTS.get(kind, "natural"))
        if megastep is None:
            megastep = build_stream_bundle(
                session, kind, self.capacity, schedule=schedule,
                yield_config=yield_config, alpha=alpha, eps=eps, seed=seed,
                k_visits=k_visits, fused=fused, k=k)
        eng = megastep.engine
        if (eng.bg is not bg or eng.mode != _ENGINE_MODE[kind]
                or eng.num_queries != self.capacity
                or eng.k_visits != int(k_visits)
                or eng.fused != bool(fused)):
            raise ValueError(
                f"the injected bundle was built for another graph, kind, "
                f"capacity, chunk size or dispatch than this {kind} "
                f"executor (capacity {self.capacity}, K {k_visits}, fused "
                f"{bool(fused)})")
        self.engine, self._megastep = megastep
        self.bg, self.perm = bg, perm
        self.mode = self.engine.mode
        self.algebra = self.engine.algebra
        self.scheduler = PartitionScheduler(schedule, bg.num_parts, seed)
        self.state = _visit.init_engine_state(
            self.algebra, self.engine.dg, np.empty(0, dtype=np.int64),
            num_queries=self.capacity)
        self._key = prng.PRNGKey(seed, self.engine.device)
        self._lane_pending: Optional[np.ndarray] = None  # set by _chunk
        self._drained = False                            # set by _chunk
        # per-lane edge counts: exact int32 per visit, float64 on the host
        self._edges = np.zeros(self.capacity, dtype=np.float64)
        if self.mode == "cc":
            self._cc_plane = torch.from_numpy(
                _visit.cc_label_plane(bg)).to(self.engine.device)

    # ----------------------------------------------------------- admission

    def _inject(self, q: StreamQuery, slot: int):
        """Buffer the query's source op (cc: the whole label plane) and
        refresh the priority of every partition it touched, on the
        device."""
        st, alg, dg = self.state, self.algebra, self.engine.dg
        P = self.bg.num_parts
        if self.mode == "cc":
            # a cc lane starts from the label plane over every partition,
            # as the one-shot run's init_ops: same buffer, same fixpoint
            rows = torch.arange(P, device=dg.device)
            st.buf[:P, slot, :] = alg.combine(st.buf[:P, slot, :],
                                              self._cc_plane)
            newprio, newops = alg.prio_of(st.buf[:P], st.planes, dg.deg)
        else:
            src = int(self.perm[q.source])
            pv, lv = divmod(src, dg.block_size)
            rows = torch.tensor([pv], device=dg.device)
            cell = st.buf[pv, slot, lv:lv + 1]
            cell.copy_(alg.combine(cell, torch.full_like(
                cell, alg.source_value)))
            newprio, newops = alg.prio_of(
                st.buf[pv], tuple(x[pv] for x in st.planes), dg.deg[pv])
            newprio, newops = newprio.view(1), newops.view(1)
        came_alive = (~torch.isfinite(st.prio.index_select(0, rows))
                      & torch.isfinite(newprio))
        st.stamp.index_copy_(0, rows, torch.where(
            came_alive, self.visits, st.stamp.index_select(0, rows)).to(
                torch.int32))
        st.prio.index_copy_(0, rows, newprio)
        st.ops_count.index_copy_(0, rows, newops)

    # ------------------------------------------------------------- harvest

    def _harvest(self, pending: Optional[np.ndarray] = None):
        """Finish every active lane with no pending op anywhere.

        ``pending`` is the ``[capacity]`` lane mask when the caller has one
        (the megastep reads it with the chunk's stats); without it one
        reduction and one read run here (the ``step()`` cadence)."""
        active = self.slot_qid >= 0
        if not active.any():
            return
        st, n, P = self.state, self.bg.n, self.bg.num_parts
        if pending is None:
            self.host_syncs += 1
            pending = _visit._lane_pending(self.engine.dg, self.algebra,
                                           st).cpu().numpy()
        done = np.flatnonzero(active & ~pending)
        if done.size == 0:
            return
        idx = torch.from_numpy(done).to(self.engine.device)
        planes = [x.index_select(1, idx) for x in st.planes]
        if self.mode == "push":
            planes[1] = planes[1] + st.buf[:P].index_select(1, idx)
        # [P, S, B] -> [S, n] per plane, one read each
        lanes = [x.transpose(0, 1).reshape(done.size, -1)[:, :n].cpu()
                 .numpy() for x in planes]
        for i, slot in enumerate(done):
            vals = lanes[0][i]
            residual = None
            if self.mode == "push":
                residual = lanes[1][i][self.perm].astype(np.float32)
            if self.mode == "kreach":
                # elementwise, so decode-then-perm equals perm-then-decode
                dv, dh = decode_kreach(vals[None, :], self.engine.hop_stride,
                                       self.engine.hop_budget)
                values = dv[0][self.perm].astype(np.float32)
                residual = dh[0][self.perm].astype(np.float32)
            elif self.mode == "cc":
                # raw reordered-rep labels -> canonical min-original-id
                # labels, after the perm mapping (as session.run)
                values = canonicalize_cc(vals[self.perm][None, :])[0]
            else:
                values = vals[self.perm].astype(np.float32)
            self._finish(int(slot), values, residual, self._edges[slot])
            self._reset_slot(int(slot))

    def _reset_slot(self, slot: int):
        st = self.state
        for x, v in zip(st.planes, self.algebra.plane_init):
            x[:, slot, :] = v
        st.buf[:, slot, :] = self.algebra.identity
        self._edges[slot] = 0.0

    # ---------------------------------------------------------------- loop

    def step(self) -> bool:
        """One partition visit (admit before, harvest after), chosen by the
        host scheduler.  False when nothing is pending anywhere and no
        query waits."""
        with self._lock:
            self._admit()
            st, P = self.state, self.bg.num_parts
            self.host_syncs += 1
            p = self.scheduler.select(st.prio[:P].cpu().numpy(),
                                      st.stamp[:P].cpu().numpy(),
                                      st.ops_count[:P].cpu().numpy())
            if p is None:
                self._harvest()
                self._admit()
                return bool(self.queue) or self.active > 0
            pt = torch.tensor([p], dtype=torch.int64,
                              device=self.engine.device)
            self.state, (_, eq, _) = self.engine._visit(st, pt, self.visits)
            self._edges += eq.cpu().numpy().astype(np.float64)
            self.visits += 1
            self.modeled_bytes += float(self.engine._visit_bytes[p])
            if self.visits % self.harvest_every == 0:
                self._harvest()
            return True

    def _chunk(self, limit: int) -> int:
        """One megastep of up to ``min(limit, K)`` visits; the chunk's
        stats and the pending-lane mask come back in its one read.
        Returns the visits run."""
        limit = min(int(limit), self.engine.k_visits)
        if limit <= 0:
            self._lane_pending = None   # a stale mask is never harvested
            return 0
        self.state, ms = self._megastep(self.state, self.visits, limit,
                                        self._key)
        self.host_syncs += 1
        v = ms.visits
        # the mask is the chunk-end state's even when v == 0; a chunk that
        # stops below its limit proves nothing is pending
        self._lane_pending = ms.lane_pending.numpy()
        self._drained = v < limit
        if v == 0:
            return 0
        self._key = ms.key
        self._edges += _visit.harvest_edges(ms.eq_hi.cpu().numpy(),
                                            ms.eq_lo.cpu().numpy())
        counts = ms.visit_counts.cpu().numpy().astype(np.int64)
        self.modeled_bytes += float(counts @ self.engine._visit_bytes)
        self.visits += v
        return v

    def pump(self, max_visits: int) -> int:
        """Advance up to ``max_visits`` visits in chunks of up to the
        engine's K, admitting and harvesting at the chunk boundaries.
        Returns the visits run.  Takes the lock per chunk, so foreign
        submits join at chunk boundaries."""
        start = self.visits
        while True:
            with self._lock:
                if self.visits - start >= max_visits:
                    break
                self._admit()
                did = self._chunk(max_visits - (self.visits - start))
                self._harvest(pending=self._lane_pending)
                if did == 0 or self._drained:
                    # nothing pending on the device: every unfinished lane
                    # was just harvested; refill from the queue or stop
                    self._admit()
                    if not self.queue and self.active == 0:
                        break
        return self.visits - start


class WalkExecutor(_Lanes):
    """Slot-recycling random-walk lanes: the :class:`StreamingExecutor`
    surface (submit / pump / run / take_finished / result) over the
    buffered walker loop (``core/randomwalk.py``).

    A lane holds one walker; free lanes park with ``steps = length`` so
    the visit's liveness mask skips them.  The rw tape is keyed by
    (source, step), never by lane or visit order, so a walker admitted
    into a recycled lane walks the trajectory ``session.run("rw", ...)``
    walks, and its occupancy row is the session's bit for bit.
    ``length`` and ``seed`` are executor-wide.  Values are occupancy
    counts ``[n]`` in original ids (start and each step); ``edges`` bills
    the steps taken.  ``visit`` injects a prebuilt :class:`WalkBundle`
    for the same ``length`` and ``seed``: the executor then builds no
    walk lists.
    """

    def __init__(self, session, capacity: int = 16, *, length: int = 32,
                 seed: int = 0, k_visits: int = 64,
                 visit: Optional[WalkBundle] = None):
        super().__init__(capacity)
        self.session = session
        self.kind = "rw"
        self.length, self.seed = int(length), int(seed)
        self.k_visits = int(k_visits)
        bg, perm = session.prepared()
        self.bg, self.perm = bg, perm
        if visit is None:
            visit = build_stream_bundle(session, "rw", self.capacity,
                                        length=self.length,
                                        walk_seed=self.seed)
        elif (visit.wg.block_size != bg.block_size
              or visit.wg.num_parts != bg.num_parts
              or visit.wg.device != session.device):
            raise ValueError("the injected walk bundle was built for "
                             "another graph or device")
        self.wg, self._visit = visit
        B = bg.block_size
        # one visit streams the diagonal block and every boundary block
        self._visit_bytes = float((1 + bg.nbr_blk.shape[1]) * B * B * 4)
        Q, dev = self.capacity, self.wg.device
        self._pos = torch.zeros(Q, dtype=torch.int64, device=dev)
        self._steps = torch.full((Q,), self.length, dtype=torch.int64,
                                 device=dev)                # parked
        self._part = torch.zeros(Q, dtype=torch.int64, device=dev)
        self._src = torch.zeros(Q, dtype=torch.int64, device=dev)
        self._thash = torch.zeros(Q, dtype=torch.int64, device=dev)
        self._occ = torch.zeros((Q, bg.num_parts * B), dtype=torch.float32,
                                device=dev)

    def _inject(self, q: StreamQuery, slot: int):
        """``randomwalk.init_walk_state``, for one lane."""
        src = int(self.perm[q.source])
        self._pos[slot] = src
        self._steps[slot] = 0
        self._part[slot] = src // self.bg.block_size
        self._src[slot] = src
        self._thash[slot] = src
        self._occ[slot] = 0.0
        self._occ[slot, src] = 1.0

    def _harvest(self):
        active = self.slot_qid >= 0
        if not active.any():
            return
        self.host_syncs += 1
        steps = self._steps.cpu().numpy()
        done = np.flatnonzero(active & (steps >= self.length))
        if done.size == 0:
            return
        idx = torch.from_numpy(done).to(self.wg.device)
        occ = self._occ.index_select(0, idx)[:, :self.bg.n].cpu().numpy()
        for i, slot in enumerate(done):
            self._finish(int(slot), occ[i][self.perm].astype(np.float32),
                         None, steps[slot])
            self._steps[int(slot)] = self.length   # park the lane

    def pump(self, max_visits: int) -> int:
        """Advance up to ``max_visits`` walk visits, admitting and
        harvesting around each (the visit choice reads the walkers'
        partitions every visit anyway).  Returns the visits run."""
        start = self.visits
        while True:
            with self._lock:
                if self.visits - start >= int(max_visits):
                    break
                self._admit()
                self.host_syncs += 1
                part, steps = torch.stack([self._part,
                                           self._steps]).cpu().numpy()
                live = (self.slot_qid >= 0) & (steps < self.length)
                if not live.any():
                    self._harvest()
                    self._admit()
                    if not self.queue and self.active == 0:
                        break
                    continue    # freshly admitted (or length-0) lanes
                # the partition with the most live walkers
                p = int(np.argmax(np.bincount(part[live],
                                              minlength=self.bg.num_parts)))
                (self._pos, self._steps, self._part, self._thash, _,
                 _) = self._visit(self._pos, self._steps, self._part,
                                  self._src, self._thash, self._occ, p)
                self.visits += 1
                self.modeled_bytes += self._visit_bytes
                self._harvest()
        return self.visits - start
