"""GraphServer: multi-tenant serving of graph queries over streaming lanes.

The port of the JAX package's ``repro.serve.graph_server``.  The paper's
fork-processing pattern — many independent queries sharing one graph — is
the shape of a serving workload.  A :class:`GraphServer` accepts a stream
of :class:`GraphRequest`\\ s — mixed kinds (sssp/bfs/ppr/cc/kreach/rw),
priorities, registered graphs and tenants — and multiplexes them onto
per-(graph, kind) **lane pools**, each a ``StreamingExecutor`` over the
K-visit megastep (on the card: one launch of the fused visit kernel a
chunk with ``fused=True``, the list-contraction kernels unfused), or for
rw a ``WalkExecutor`` (one threefry launch a step round);
``k``/``length``/``walk_seed`` parameterise the kreach and rw pools
server-wide, as ``alpha``/``eps`` do ppr.

Serving runs as a continuous-batching engine with three lanes
(``serve/dispatch.py``):

  * **admission** — ``submit`` is thread-safe and never touches a device:
    it books the request, coalesces duplicates and parks it in the pool's
    backlog (weighted-fair start-time queueing over per-tenant virtual
    time: admitting one request of tenant *t* advances ``vtime[t] +=
    1/weight[t]``, so a hot tenant gets at most its weight's share);
  * **pumping** — one thread per pool builds the pool's executor (from
    the warm cache when it can) and drives ``pump``, refilling free lanes
    from the backlog at every chunk boundary, the only points where
    admission and harvest are legal;
  * **delivery** — one thread turns finished lanes into
    :class:`GraphResponse`\\ s and wakes ``result(rid, timeout=...)``.

Host builds never sit on the serving path when they can be avoided: a
:class:`MegastepCache` (``serve/compile_cache.py``) keeps built engine
bundles (the ``DeviceGraph`` with its column lists and the megastep) keyed
by ``(graph, kind, K, capacity, ...)``, warmed at ``register_graph``
(``prewarm=``) and on every pool resize; pool capacities snap to pow2
buckets (``planner.pow2_bucket``) so autoscaling revisits a logarithmic
set of bundles.  A pool whose bundle is not warm builds it in its own pump
lane, never under the server lock.

Identical in-flight requests — same ``(graph, kind, source, alpha, eps)``
and per-kind parameters — coalesce onto one lane at admission and fan the
answer out at delivery, with the lane's visits, edges and host syncs
billed to *every* requester (``dedup=False`` disables it).  Requests whose
deadline lapses while queued get an explicit ``status="expired"``
response; an expired coalescing primary promotes its oldest live follower.

*Completed* answers are reused too: a byte-budgeted LRU of finished result
planes (``serve/result_cache.py``) is checked in ``submit`` **before** the
dedup window; a hit is answered through the delivery lane (``cached:
True``, zero billed visits, edges and host syncs).  ``update_graph``
re-registers a name with new data and bumps its **epoch**, part of every
cache key, so planes of the replaced graph are never served.

    server = GraphServer(capacity=8, prewarm=("sssp",))
    server.register_graph("road", road_csr)   # planned on the card
    server.start()                            # spin up the lanes
    rid = server.submit(GraphRequest(kind="sssp", source=7, graph="road"))
    resp = server.result(rid, timeout=30)     # block for the answer
    server.shutdown()

Raw graphs are planned on ``device`` (CUDA unless ``device="cpu"``); a
registered :class:`FPPSession` keeps its own.  The synchronous ``serve()``
pumps rounds inline with ``PartitionScheduler`` pool arbitration (request
priorities feed it; ``prefer_older_ties`` rotates equal-priority pools) and
is the oracle the concurrent lanes are held against; ``serve_forever``
feeds an arrival stream to the running lanes and blocks until drained.

Nothing falls back: an exception in a pump or delivery lane halts every
lane, and ``result``, ``wait_drained`` and ``serve_forever`` raise it to
the caller instead of leaving a request waiting.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.queries import WEIGHT_VARIANTS
from repro_torch.core.scheduler import PartitionScheduler
from repro_torch.fpp import planner as _planner
from repro_torch.fpp.session import FPPSession
from repro_torch.serve.compile_cache import (MegastepCache, session_uid,
                                             warm_key)
from repro_torch.serve.result_cache import CacheEntry, ResultCache, result_key

SERVABLE_KINDS = ("sssp", "bfs", "ppr", "cc", "kreach", "rw")

#: stamp value for pools with nothing queued or in flight (never selected —
#: their priority is +inf — but keeps the stamp array total)
_IDLE_STAMP = np.iinfo(np.int64).max - 1


@dataclasses.dataclass
class GraphRequest:
    """One graph query as a tenant submits it (original vertex ids).

    ``priority`` follows the engine's convention: lower is more urgent
    (it orders admission within a pool and feeds the synchronous path's
    pool arbitration).  ``deadline_s`` is a time-to-live from submission:
    a request still *queued* when it lapses is rejected with
    ``status="expired"``; once admitted to a lane it always runs to
    completion.  A coalesced follower shares its primary's fate.
    """
    kind: str
    source: int
    graph: str = "default"
    tenant: str = "default"
    priority: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class GraphResponse:
    """The server's answer: values on success, always an explicit status.

    ``status`` is ``"ok"`` or ``"expired"``.  ``stats`` carries the
    per-request accounting: ``visits`` (executor visits while the request
    was in flight), ``edges`` (exact integral edge work of this lane),
    ``host_syncs`` (device->host round trips billed to the request's
    in-flight window), ``queue_wait_s``/``queue_wait_rounds`` (time and
    scheduling rounds spent waiting for a lane), ``latency_s`` (submit to
    response).  A coalesced follower carries ``coalesced: True`` plus the
    *same* visit/edge/host-sync bill as the lane it rode (per-request
    attribution, not divided); its primary carries ``fanout: n``.
    """
    rid: int
    tenant: str
    graph: str
    kind: str
    source: int
    status: str
    values: Optional[np.ndarray]
    residual: Optional[np.ndarray]
    stats: dict


@dataclasses.dataclass
class _Ticket:
    """Server-side lifecycle record for one request."""
    rid: int
    req: GraphRequest
    submit_t: float
    submit_round: int
    admit_t: float = -1.0
    admit_round: int = -1


class _LanePool:
    """One (graph, kind) lane pool: a streaming executor plus its backlog.

    The executor is built from a bundle (``build``): at creation when the
    warm cache already holds one, else by the pool's pump lane (or the
    synchronous ``step``), so a cold build never runs under the server
    lock in ``submit``.  ``exec`` is None until then."""

    def __init__(self, graph: str, kind: str, session: FPPSession,
                 capacity: int, k_visits: int, alpha: float, eps: float,
                 *, fused: bool = False, megastep=None,
                 lock: Optional[threading.RLock] = None,
                 k: int = 8, length: int = 32, walk_seed: int = 0):
        self.graph = graph
        self.kind = kind
        self.session = session
        self.capacity = int(capacity)
        self.k_visits = int(k_visits)
        self.alpha, self.eps = alpha, eps
        self.k = int(k)
        self.length, self.walk_seed = int(length), int(walk_seed)
        self.fused = bool(fused)
        self.exec = None
        # work of the executors a resize replaced (stats' *_total)
        self.past_visits = self.past_syncs = 0
        # tenant -> heap of (priority, seq, rid): priority then arrival
        self.queues: Dict[str, List[Tuple[float, int, int]]] = {}
        self.qid_rid: Dict[int, int] = {}      # executor qid -> server rid
        self.stamp: int = _IDLE_STAMP          # round backlog became non-empty
        self.retired = False                   # set by update_graph; the
        #                                        pool's worker exits on sight
        # the pump worker parks here while idle; submit() notifies.
        # Shares the server lock so wait/notify and backlog state agree.
        self.cv = threading.Condition(lock or threading.RLock())
        if megastep is not None:
            self.build(megastep)

    def build(self, megastep):
        """Create the executor at the pool's capacity from a built bundle
        (``serve/compile_cache.build_warm_megastep``); builds nothing."""
        self.exec = self.session.stream(self.kind, capacity=self.capacity,
                                        k_visits=self.k_visits,
                                        alpha=self.alpha, eps=self.eps,
                                        fused=self.fused, megastep=megastep,
                                        k=self.k, length=self.length,
                                        seed=self.walk_seed)
        self.qid_rid = {}

    # ------------------------------------------------------------- backlog

    def enqueue(self, tenant: str, prio: float, seq: int, rid: int):
        heapq.heappush(self.queues.setdefault(tenant, []),
                       (float(prio), int(seq), int(rid)))

    @property
    def queued(self) -> int:
        return sum(len(h) for h in self.queues.values())

    @property
    def active(self) -> int:
        return len(self.qid_rid)

    @property
    def totals(self) -> Tuple[int, int]:
        """(visits, host syncs) of every executor this pool has run."""
        ex = self.exec
        return (self.past_visits + (ex.visits if ex else 0),
                self.past_syncs + (ex.host_syncs if ex else 0))

    def best_priority(self, tickets: Dict[int, _Ticket]) -> float:
        """Most urgent request priority across backlog + in-flight lanes."""
        best = np.inf
        for heap in self.queues.values():
            if heap:
                best = min(best, heap[0][0])
        for rid in self.qid_rid.values():
            best = min(best, tickets[rid].req.priority)
        return best

    def resize(self, capacity: int, megastep=None):
        """Rebuild the executor at a new capacity.  Only legal when idle
        (no in-flight lane state to move); the backlog is server-side, so
        nothing else changes.  ``megastep`` injects the warm bundle for the
        new capacity; without one the executor is left for the pump lane
        to build."""
        if self.active:
            raise RuntimeError("cannot resize a pool with in-flight lanes")
        self.past_visits, self.past_syncs = self.totals
        self.capacity = int(capacity)
        self.exec = None
        self.qid_rid = {}
        if megastep is not None:
            self.build(megastep)


def default_autoscaler(pool_stats: dict) -> int:
    """Planner-backed capacity hint: demand snapped to a pow2 bucket,
    clamped by the memory model."""
    return _planner.autoscale_capacity(
        pool_stats["queued"], pool_stats["active"],
        mem=pool_stats["mem"], n_vertices=pool_stats["n_vertices"],
        block_size=pool_stats["block_size"],
        min_capacity=pool_stats["min_capacity"],
        max_capacity=pool_stats["max_capacity"])


class GraphServer:
    """Multi-tenant continuous-batching front end over lane pools.

    ``capacity`` seeds every pool's lane count, snapped to a pow2 bucket
    (the autoscaler revises it between chunks, bounded by
    ``max_capacity`` and the memory model); ``k_visits`` is each pool's
    megastep chunk size — the scheduling quantum of the whole server,
    since admission, harvest and deadline checks all happen at chunk
    boundaries; ``schedule`` picks the synchronous path's pool-arbitration
    policy (any ``core/scheduler.py`` policy; request priorities feed
    it); ``alpha``/``eps`` parameterize the push (ppr) pools exactly as
    they do ``FPPSession.run``; ``autoscaler`` replaces the default
    capacity hint (callable: pool-stats dict -> suggested capacity, or
    ``None`` to disable resizing); ``clock`` is injectable for
    deterministic deadline tests.

    Continuous-batching knobs: ``fused`` selects each pool's visit body —
    ``"auto"`` (default) picks per kind from the committed dispatch
    yardsticks (``planner.auto_fused``; the port has none yet, so "auto"
    is the unfused megastep for every kind), or True/False to force;
    ``dedup`` coalesces identical in-flight requests (see module
    docstring); ``cache`` shares a :class:`MegastepCache` across servers;
    ``prewarm`` is the default set of kinds whose engine bundles
    ``register_graph`` builds in the background; ``idle_wait_s`` is how
    long an idle pump worker parks between deadline checks; ``device`` is
    where raw graphs registered here are planned (CUDA unless "cpu"; a
    registered session keeps its own).

    Result-cache knobs: ``result_cache`` is True (default — a private
    :class:`ResultCache`), False/None (disable the tier), or a
    :class:`ResultCache` instance to share completed planes across
    servers; ``cache_bytes`` fixes its byte budget — by default each
    ``register_graph`` grows the budget to
    ``planner.result_cache_budget`` for the largest graph served (a
    small multiple of one query lane's plane set).
    """

    def __init__(self, *, capacity: int = 8, max_capacity: int = 64,
                 k_visits: int = 64, schedule: str = "priority",
                 alpha: float = 0.15, eps: float = 1e-4,
                 k: int = 8, length: int = 32, walk_seed: int = 0,
                 autoscaler: Optional[Callable[[dict], int]]
                 = default_autoscaler,
                 clock: Callable[[], float] = time.monotonic,
                 seed: int = 0,
                 fused: object = "auto", dedup: bool = True,
                 cache: Optional[MegastepCache] = None,
                 result_cache: object = True,
                 cache_bytes: Optional[int] = None,
                 prewarm: Iterable[str] = (),
                 idle_wait_s: float = 0.05, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if fused not in (True, False, "auto"):
            raise ValueError(f"fused must be True, False or 'auto', "
                             f"got {fused!r}")
        self.capacity = int(capacity)
        self.max_capacity = int(max_capacity)
        self.k_visits = int(k_visits)
        self.alpha, self.eps = float(alpha), float(eps)
        # per-kind answer parameters, server-wide like alpha/eps: the
        # kreach hop budget, the rw walk length and tape seed
        self.k = int(k)
        self.length, self.walk_seed = int(length), int(walk_seed)
        self.autoscaler = autoscaler
        self.clock = clock
        self.fused = fused
        self.dedup = bool(dedup)
        self.cache = cache if cache is not None else MegastepCache()
        if isinstance(result_cache, ResultCache):
            self.result_cache: Optional[ResultCache] = result_cache
        elif result_cache:
            self.result_cache = ResultCache()
        else:
            self.result_cache = None
        self.cache_bytes = None if cache_bytes is None else int(cache_bytes)
        if self.result_cache is not None and self.cache_bytes is not None:
            self.result_cache.reserve(self.cache_bytes)
        self.prewarm = tuple(prewarm)
        self.idle_wait_s = float(idle_wait_s)
        self.device = device
        self.rounds = 0
        self.responses: Dict[int, GraphResponse] = {}
        self._sessions: Dict[str, FPPSession] = {}
        self._pools: Dict[Tuple[str, str], _LanePool] = {}
        self._pool_order: List[_LanePool] = []
        self._weights: Dict[str, float] = {}
        self._vtime: Dict[str, float] = {}
        self._tickets: Dict[int, _Ticket] = {}
        self._epochs: Dict[str, int] = {}      # graph name -> update epoch
        self._coalesced_total = 0              # follower rides booked
        self._fanout_total = 0                 # follower responses fanned out
        self._arb = PartitionScheduler(schedule, 0, seed)
        self._next_rid = 0
        self._seq = 0
        # --- continuous-batching state (serve/dispatch.py) ---
        # ONE lock guards all server-side state; pool cvs and the
        # response cv are views of it.  Executor locks nest strictly
        # inside it (server lock -> executor lock, never the reverse).
        self._lock = threading.RLock()
        self._resp_cv = threading.Condition(self._lock)
        self._running = False
        self._workers: List[threading.Thread] = []
        self._delivery = None
        self._outstanding = 0                  # requests without a response
        self._round_budget: Optional[int] = None
        self._error: Optional[BaseException] = None   # a lane's failure
        # in-flight dedup: coalesce key -> primary rid; primary rid ->
        # follower rids (fan-out happens at delivery)
        self._dedup: Dict[tuple, int] = {}
        self._followers: Dict[int, List[int]] = {}

    # ---------------------------------------------------------- registration

    def register_graph(self, name: str, graph_or_session,
                       prewarm: Optional[Iterable[str]] = None, **plan_kw):
        """Register a graph under ``name``; requests address it by name.

        Accepts a host CSR graph (a session is planned for it with
        ``plan_kw`` forwarded) or a ready :class:`FPPSession` — passing the
        session a test already ran ``session.run`` on guarantees the served
        plan is identical, which is how the bit-parity tests pin the
        contract.  ``prewarm`` (default: the server's ``prewarm`` set)
        names kinds whose engine bundles are built in the background so
        the first request never pays the build.  Chainable.
        """
        if name in self._sessions:
            raise ValueError(f"graph {name!r} already registered")
        # validate everything before mutating server state or kicking off
        # warm threads: a rejected register_graph must have no effect, so
        # the caller's corrected retry doesn't hit "already registered"
        kinds = self.prewarm if prewarm is None else tuple(prewarm)
        for kind in kinds:
            if kind not in SERVABLE_KINDS:
                raise ValueError(f"prewarm kind must be one of "
                                 f"{SERVABLE_KINDS}, got {kind!r}")
        session = self._build_session(graph_or_session, plan_kw)
        self._sessions[name] = session
        self._epochs.setdefault(name, 0)
        self._reserve_cache_budget(session)
        cap0 = _planner.pow2_bucket(self.capacity,
                                    max_capacity=max(self.max_capacity,
                                                     self.capacity))
        for kind in kinds:
            self.cache.warm_async(session, name, kind, cap0,
                                  **self._warm_params(session, kind))
        return self

    def _build_session(self, graph_or_session, plan_kw: dict) -> FPPSession:
        if isinstance(graph_or_session, FPPSession):
            if plan_kw:
                raise ValueError("plan_kw only applies when registering a "
                                 "raw graph, not a planned FPPSession")
            return graph_or_session
        plan_kw.setdefault("num_queries", self.capacity)
        return FPPSession(graph_or_session, device=self.device).plan(
            **plan_kw)

    def _reserve_cache_budget(self, session: FPPSession):
        """Grow the result cache's byte budget for this graph: the explicit
        ``cache_bytes`` if given, else the planner's plane-set default."""
        if self.result_cache is None:
            return
        budget = (self.cache_bytes if self.cache_bytes is not None
                  else _planner.result_cache_budget(
                      session.mem, session.graph.n,
                      session.current_plan.block_size))
        self.result_cache.reserve(budget)

    def update_graph(self, name: str, graph_or_session,
                     prewarm: Optional[Iterable[str]] = None, **plan_kw):
        """Re-register ``name`` with new graph data; requests keep the name.

        The dynamic-graph path: the registered name's **epoch** is bumped,
        and since the epoch is part of every result-cache key, planes
        computed against the replaced graph can never be served again —
        staleness is bounded by the update, not by TTL guesswork (the old
        session's entries are also dropped eagerly to free their bytes).
        The name's lane pools are retired (their workers exit; fresh pools
        build from the new session on the next request) and the new
        session's engine bundles prewarm exactly as at first registration.

        Only legal while the name has no queued or in-flight work — an
        update must never splice two different graphs into one answer, so
        drain (``wait_drained``) before updating.  Validation happens
        before any mutation: a rejected update leaves the old graph
        serving.  Chainable.
        """
        with self._lock:
            if name not in self._sessions:
                raise ValueError(f"graph {name!r} not registered "
                                 f"(have {sorted(self._sessions)}); use "
                                 f"register_graph for new names")
            kinds = self.prewarm if prewarm is None else tuple(prewarm)
            for kind in kinds:
                if kind not in SERVABLE_KINDS:
                    raise ValueError(f"prewarm kind must be one of "
                                     f"{SERVABLE_KINDS}, got {kind!r}")
            for (g, kind), pool in self._pools.items():
                if g == name and (pool.queued or pool.active):
                    raise RuntimeError(
                        f"cannot update graph {name!r} with requests "
                        f"queued or in flight on pool ({g}, {kind}); "
                        f"drain first (wait_drained)")
            session = self._build_session(graph_or_session, plan_kw)
            old = self._sessions[name]
            self._epochs[name] += 1
            if self.result_cache is not None:
                self.result_cache.invalidate_session(session_uid(old))
            self._sessions[name] = session
            self._reserve_cache_budget(session)
            for key in [k for k in self._pools if k[0] == name]:
                pool = self._pools.pop(key)
                pool.retired = True
                self._pool_order.remove(pool)
                pool.cv.notify_all()
            cap0 = _planner.pow2_bucket(
                self.capacity, max_capacity=max(self.max_capacity,
                                                self.capacity))
            for kind in kinds:
                self.cache.warm_async(session, name, kind, cap0,
                                      **self._warm_params(session, kind))
        return self

    def register_tenant(self, name: str, weight: float = 1.0):
        """Set a tenant's fair-share weight (admissions per unit virtual
        time).  Unknown tenants are auto-registered at weight 1 on first
        submit.  Chainable."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._lock:
            self._weights[name] = float(weight)
            self._vtime.setdefault(name, 0.0)
        return self

    def _resolve_fused(self, session: FPPSession, kind: str) -> bool:
        if kind == "rw":
            return False     # the walk visit has no megastep body to fuse
        if self.fused == "auto":
            bg, _ = session.prepared(
                weights=WEIGHT_VARIANTS.get(kind, "natural"))
            return _planner.auto_fused(kind, self.k_visits,
                                       dmax=bg.nbr_blk.shape[1])
        return bool(self.fused)

    def _warm_params(self, session: FPPSession, kind: str) -> dict:
        """kwargs completing a bundle cache key for one of our pools —
        everything beyond (graph, kind, capacity)."""
        return dict(k_visits=self.k_visits,
                    fused=self._resolve_fused(session, kind),
                    alpha=self.alpha, eps=self.eps,
                    schedule=session.current_plan.schedule, seed=0,
                    k=self.k, length=self.length, walk_seed=self.walk_seed)

    def _pool(self, graph: str, kind: str) -> _LanePool:
        key = (graph, kind)
        if key not in self._pools:
            session = self._sessions[graph]
            cap = _planner.pow2_bucket(
                self.capacity, max_capacity=max(self.max_capacity,
                                                self.capacity))
            params = self._warm_params(session, kind)
            # peek, don't build: pool creation happens under the server
            # lock (first submit), so a cold cache must not stall it —
            # the pump lane (or step) builds the executor instead
            megastep = self.cache.peek(warm_key(session, graph, kind,
                                                params["k_visits"], cap,
                                                **{k: v for k, v
                                                   in params.items()
                                                   if k != "k_visits"}))
            pool = _LanePool(graph, kind, session, cap, self.k_visits,
                             self.alpha, self.eps, fused=params["fused"],
                             megastep=megastep, lock=self._lock,
                             k=self.k, length=self.length,
                             walk_seed=self.walk_seed)
            self._pools[key] = pool
            self._pool_order.append(pool)
            if self._running:
                self._spawn_worker(pool)
        return self._pools[key]

    # --------------------------------------------------------------- submit

    def _kind_params(self, kind: str) -> tuple:
        """The per-kind answer identity beyond (kind, source, alpha, eps):
        whatever else changes what the lane computes.  Folded into both
        the dedup window and the result-cache key so a kreach answer at
        one hop budget (or a walk at one length/seed) can never be served
        for another."""
        if kind == "kreach":
            return (self.k,)
        if kind == "rw":
            return (self.length, self.walk_seed)
        return ()

    def _dedup_key(self, req: GraphRequest) -> tuple:
        return (req.graph, req.kind, int(req.source), self.alpha,
                self.eps) + self._kind_params(req.kind)

    def _result_key(self, req: GraphRequest) -> tuple:
        """The result-cache key for this request: the dedup identity with
        the graph name replaced by (session uid, epoch) — value identity
        that survives name reuse and bounds staleness across updates."""
        return result_key(session_uid(self._sessions[req.graph]),
                          self._epochs[req.graph], req.kind, req.source,
                          self.alpha, self.eps,
                          params=self._kind_params(req.kind))

    def submit(self, req: GraphRequest) -> int:
        """Book one request; returns its rid (``result``/``poll`` for the
        response).  Thread-safe and device-free: the heavy lifting happens
        on the pump lane at the next chunk boundary."""
        if req.kind not in SERVABLE_KINDS:
            raise ValueError(f"kind must be one of {SERVABLE_KINDS}, "
                             f"got {req.kind!r}")
        with self._lock:
            if req.graph not in self._sessions:
                raise ValueError(f"graph {req.graph!r} not registered "
                                 f"(have {sorted(self._sessions)})")
            n = self._sessions[req.graph].graph.n
            if not 0 <= int(req.source) < n:
                raise ValueError(f"source {req.source} out of range for "
                                 f"graph {req.graph!r} with {n} vertices")
            if req.tenant not in self._weights:
                self.register_tenant(req.tenant)
            rid = self._next_rid
            self._next_rid += 1
            t = _Ticket(rid=rid, req=req, submit_t=self.clock(),
                        submit_round=self.rounds)
            self._tickets[rid] = t
            self._outstanding += 1
            if self.result_cache is not None:
                # completed-answer reuse, checked BEFORE the dedup window:
                # cache covers finished hot sources, dedup the in-flight
                # gap.  A hit never touches a lane — it rides the delivery
                # lane so result()/poll() semantics are unchanged.
                entry = self.result_cache.get(self._result_key(req))
                if entry is not None:
                    self._queue_cached(rid, entry)
                    return rid
            if self.dedup:
                primary = self._dedup.get(self._dedup_key(req))
                if primary is not None:
                    # ride the in-flight twin's lane; answer fans out at
                    # delivery with this request billed the same work
                    self._followers.setdefault(primary, []).append(rid)
                    self._coalesced_total += 1
                    return rid
                self._dedup[self._dedup_key(req)] = rid
            pool = self._pool(req.graph, req.kind)
            if pool.queued == 0 and pool.active == 0:
                pool.stamp = self.rounds
            if not self._tenant_has_work(req.tenant):
                # a tenant returning from idle joins at the busy tenants'
                # pace instead of burning banked virtual time as a
                # monopoly burst
                busy = [self._vtime[tn] for tn in self._weights
                        if tn != req.tenant and self._tenant_has_work(tn)]
                if busy:
                    self._vtime[req.tenant] = max(self._vtime[req.tenant],
                                                  min(busy))
            pool.enqueue(req.tenant, req.priority, self._seq, rid)
            self._seq += 1
            pool.cv.notify_all()
            return rid

    def _tenant_has_work(self, tenant: str) -> bool:
        """True while the tenant has anything queued or in flight — the
        condition under which its virtual time is live rather than banked."""
        for p in self._pool_order:
            if p.queues.get(tenant):
                return True
            for rid in p.qid_rid.values():
                if self._tickets[rid].req.tenant == tenant:
                    return True
        return False

    def submit_all(self, reqs: Iterable[GraphRequest]) -> List[int]:
        return [self.submit(r) for r in reqs]

    # ------------------------------------------------------------ deadlines

    def _expired(self, t: _Ticket, now: float) -> bool:
        d = t.req.deadline_s
        return d is not None and (now - t.submit_t) >= d

    def _reject(self, t: _Ticket, now: float):
        self._finish(GraphResponse(
            rid=t.rid, tenant=t.req.tenant, graph=t.req.graph,
            kind=t.req.kind, source=t.req.source, status="expired",
            values=None, residual=None, stats={
                "queue_wait_s": now - t.submit_t,
                "queue_wait_rounds": self.rounds - t.submit_round,
                "latency_s": now - t.submit_t,
            }))
        key = self._dedup_key(t.req)
        if self._dedup.get(key) == t.rid:
            # an expired coalescing primary hands its lane claim to the
            # oldest follower still inside its own deadline
            del self._dedup[key]
            followers = self._followers.pop(t.rid, [])
            while followers:
                frid = followers.pop(0)
                ft = self._tickets[frid]
                if self._expired(ft, now):
                    self._reject(ft, now)
                    continue
                self._dedup[key] = frid
                if followers:
                    self._followers[frid] = followers
                pool = self._pool(ft.req.graph, ft.req.kind)
                if pool.queued == 0 and pool.active == 0:
                    pool.stamp = self.rounds
                pool.enqueue(ft.req.tenant, ft.req.priority, self._seq, frid)
                self._seq += 1
                pool.cv.notify_all()
                break

    def _police_pool(self, pool: _LanePool, now: float):
        """Reject every queued request in this pool whose deadline lapsed
        (explicit expired response — never a silent drop).

        Two phases: pull expired items out of every tenant heap *first*,
        then reject.  ``_reject`` on a coalescing primary promotes a
        follower via ``pool.enqueue`` — possibly into this very pool —
        which would corrupt a heap still being iterated and let the
        rebuild drop the promotion; rejecting only after the heaps are
        rebuilt makes the promotion an ordinary push."""
        expired: List[_Ticket] = []
        for tenant, heap in list(pool.queues.items()):
            keep = []
            for item in heap:
                t = self._tickets[item[2]]
                if self._expired(t, now):
                    expired.append(t)
                else:
                    keep.append(item)
            if len(keep) != len(heap):
                heapq.heapify(keep)
                pool.queues[tenant] = keep
        for t in expired:
            self._reject(t, now)

    def _police_deadlines(self, now: float):
        for pool in self._pool_order:
            self._police_pool(pool, now)

    # ------------------------------------------------------------ admission

    def _pick_tenant(self, pool: _LanePool) -> Optional[str]:
        """Lowest virtual time among tenants with backlog in this pool
        (name-ordered tie break for determinism)."""
        best = None
        for tenant, heap in pool.queues.items():
            if not heap:
                continue
            key = (self._vtime[tenant], tenant)
            if best is None or key < best[0]:
                best = (key, tenant)
        return None if best is None else best[1]

    def _admit(self, pool: _LanePool, now: float):
        """Fill free lanes by weighted-fair start-time order; expired
        requests discovered here are rejected without charging their
        tenant's virtual time."""
        ex = pool.exec
        while ex.free_slots and pool.queued:
            tenant = self._pick_tenant(pool)
            _, _, rid = heapq.heappop(pool.queues[tenant])
            t = self._tickets[rid]
            if self._expired(t, now):
                self._reject(t, now)
                continue
            qid = ex.submit([t.req.source])[0]
            if ex.queue_depth != 0:
                raise RuntimeError(
                    f"admission must be immediate: lane pool reported a "
                    f"free lane but submit left queue_depth="
                    f"{ex.queue_depth}")
            pool.qid_rid[qid] = rid
            t.admit_t = now
            t.admit_round = self.rounds
            self._vtime[tenant] += 1.0 / self._weights[tenant]

    # -------------------------------------------------------------- delivery

    def _finish(self, resp: GraphResponse):
        """Store a response and wake every ``result``/drain waiter."""
        self.responses[resp.rid] = resp
        self._outstanding = max(0, self._outstanding - 1)
        self._resp_cv.notify_all()

    def _queue_cached(self, rid: int, entry: CacheEntry):
        """Route a cache hit through the delivery lane (inline when the
        lanes aren't running — the synchronous path's fallback, matching
        ``_queue_delivery``)."""
        d = self._delivery
        if d is not None:
            d.put_cached(rid, entry)
        else:
            self._finish_cached(rid, entry, self.clock())

    def _finish_cached(self, rid: int, entry: CacheEntry, now: float):
        """Build and store the response for one cache hit (under the
        server lock).  Zero billed visits/edges/host_syncs — no lane ever
        ran — but exact queue wait: the time from submit until the
        delivery lane got to it."""
        t = self._tickets[rid]
        self._finish(GraphResponse(
            rid=rid, tenant=t.req.tenant, graph=t.req.graph,
            kind=t.req.kind, source=t.req.source, status="ok",
            values=entry.values, residual=entry.residual, stats={
                "visits": 0, "edges": 0.0, "host_syncs": 0,
                "queue_wait_s": now - t.submit_t,
                "queue_wait_rounds": self.rounds - t.submit_round,
                "latency_s": now - t.submit_t,
                "cached": True,
            }))

    def _deliver(self, pool: _LanePool, qids: Iterable[int], now: float):
        """Turn finished executor lanes into responses (+ dedup fan-out)."""
        for qid in qids:
            rid = pool.qid_rid.pop(qid, None)
            if rid is None:
                continue
            t = self._tickets[rid]
            q = pool.exec.queries[qid]
            stats = {
                "visits": q.finished_visit - q.admitted_visit,
                "edges": q.edges,
                "host_syncs": q.finished_sync - q.admitted_sync,
                "queue_wait_s": t.admit_t - t.submit_t,
                "queue_wait_rounds": t.admit_round - t.submit_round,
                "latency_s": now - t.submit_t,
            }
            key = self._dedup_key(t.req)
            if self._dedup.get(key) == rid:
                del self._dedup[key]
            followers = self._followers.pop(rid, [])
            if followers:
                stats["fanout"] = len(followers)
                self._fanout_total += len(followers)
            if (self.result_cache is not None
                    and self._sessions.get(pool.graph) is pool.session):
                # populate once per primary — fan-out followers below ride
                # the same planes; the session-identity guard means a pool
                # that somehow outlived an update_graph can never poison
                # the new epoch (update_graph refuses in-flight work, so
                # this is belt and braces)
                self.result_cache.put(self._result_key(t.req),
                                      q.values, q.residual)
            self._finish(GraphResponse(
                rid=rid, tenant=t.req.tenant, graph=pool.graph,
                kind=pool.kind, source=t.req.source, status="ok",
                values=q.values, residual=q.residual, stats=stats))
            for frid in followers:
                ft = self._tickets[frid]
                self._finish(GraphResponse(
                    rid=frid, tenant=ft.req.tenant, graph=pool.graph,
                    kind=pool.kind, source=ft.req.source, status="ok",
                    values=q.values, residual=q.residual, stats={
                        # the lane's work billed to every requester
                        "visits": stats["visits"], "edges": q.edges,
                        "host_syncs": stats["host_syncs"],
                        "queue_wait_s": max(0.0, t.admit_t - ft.submit_t),
                        "queue_wait_rounds": max(
                            0, t.admit_round - ft.submit_round),
                        "latency_s": now - ft.submit_t,
                        "coalesced": True,
                    }))

    def _queue_delivery(self, pool: _LanePool, qids: List[int]):
        """Hand finished lanes to the delivery thread (inline fallback
        during shutdown, when the delivery lane is already gone)."""
        d = self._delivery
        if d is not None:
            d.put(pool, qids)
        else:
            with self._lock:
                self._deliver(pool, qids, self.clock())

    # ------------------------------------------------------------ autoscale

    def _resize_hint(self, pool: _LanePool) -> Optional[int]:
        """A pow2-snapped target capacity, or None to leave the pool be.
        Only idle pools resize — no in-flight lane state ever moves."""
        if self.autoscaler is None or pool.active:
            return None
        plan = pool.session.current_plan
        hint = int(self.autoscaler({
            "queued": pool.queued, "active": pool.active,
            "capacity": pool.capacity, "mem": plan.mem,
            "n_vertices": pool.session.graph.n,
            "block_size": plan.block_size,
            "min_capacity": 1, "max_capacity": self.max_capacity,
        }))
        if hint < 1:
            return None
        hint = _planner.pow2_bucket(hint, max_capacity=self.max_capacity)
        return hint if hint != pool.capacity else None

    def _warm_executable(self, pool: _LanePool, capacity: int):
        """The warm bundle for this pool at ``capacity`` — built now if the
        cache misses (the lanes call it with the server lock released)."""
        return self.cache.get_or_build(
            pool.session, pool.graph, pool.kind, capacity,
            **self._warm_params(pool.session, pool.kind))

    def _apply_resize(self, pool: _LanePool, capacity: int, megastep):
        pool.resize(capacity, megastep=megastep)

    def _ensure_exec(self, pool: _LanePool):
        """Build the pool's executor if it has none (the synchronous path;
        the lanes build outside the server lock)."""
        if pool.exec is None:
            pool.build(self._warm_executable(pool, pool.capacity))

    # --------------------------------------------------- continuous batching

    def start(self):
        """Spin up the pump + delivery lanes; idempotent.  Chainable.
        Every graph kernel's library is loaded first, so no two lanes race
        to load one.  A server whose lane failed does not start again."""
        from repro_torch.serve.dispatch import DeliveryWorker, load_kernels
        with self._lock:
            self._raise_if_failed()
            if self._running:
                return self
            if any(s.device.type == "cuda"
                   for s in self._sessions.values()):
                load_kernels()
            self._running = True
            self._delivery = DeliveryWorker(self)
            self._delivery.start()
            for pool in self._pool_order:
                self._spawn_worker(pool)
        return self

    def _spawn_worker(self, pool: _LanePool):
        from repro_torch.serve.dispatch import PoolWorker
        w = PoolWorker(self, pool)
        self._workers.append(w)
        w.start()

    def _take_round(self) -> bool:
        """Charge one scheduling round against the budget; a spent budget
        halts the lanes (``serve_forever`` then returns what completed)."""
        if self._round_budget is not None and self.rounds >= self._round_budget:
            self._halt_locked()
            return False
        self.rounds += 1
        return True

    def _halt_locked(self):
        self._running = False
        for p in self._pool_order:
            p.cv.notify_all()
        self._resp_cv.notify_all()

    def _fail(self, exc: BaseException):
        """A lane raised: keep the first error and halt every lane, so each
        waiter wakes and raises it (no request is left waiting)."""
        with self._lock:
            if self._error is None:
                self._error = exc
            self._halt_locked()

    def _raise_if_failed(self):
        if self._error is not None:
            raise RuntimeError(f"a serving lane failed: {self._error!r}"
                               ) from self._error

    def shutdown(self) -> Dict[int, GraphResponse]:
        """Stop the lanes at their next chunk boundary and join them.
        Unserved requests stay booked — ``start()`` again to resume —
        and the response table so far is returned."""
        with self._lock:
            self._halt_locked()
            workers, self._workers = self._workers, []
            delivery, self._delivery = self._delivery, None
        for w in workers:
            w.join()
        if delivery is not None:
            delivery.stop()
            delivery.join()
        return self.responses

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until every booked request has a response (True), the
        lanes halt, or ``timeout`` elapses (False)."""
        with self._lock:
            self._resp_cv.wait_for(
                lambda: self._outstanding == 0 or not self._running, timeout)
            self._raise_if_failed()
            return self._outstanding == 0

    def result(self, rid: int, timeout: Optional[float] = None
               ) -> GraphResponse:
        """Block until ``rid``'s response is ready and return it.

        Requires running lanes (``start``/``serve_forever``) unless the
        response already exists; raises ``KeyError`` for unknown rids,
        ``TimeoutError`` on timeout, ``RuntimeError`` if the server halts
        first (chained to the lane's error when one failed)."""
        with self._lock:
            resp = self.responses.get(rid)
            if resp is not None:
                return resp
            if rid not in self._tickets:
                raise KeyError(f"unknown request id {rid}")
            self._raise_if_failed()
            if not self._running:
                raise RuntimeError(
                    f"request {rid} has no response and the serving lanes "
                    f"are stopped; start() the server or pump serve()")
            self._resp_cv.wait_for(
                lambda: rid in self.responses or not self._running, timeout)
            resp = self.responses.get(rid)
            if resp is None:
                self._raise_if_failed()
                if self._running:
                    raise TimeoutError(
                        f"request {rid} not served within {timeout}s")
                raise RuntimeError(
                    f"serving lanes halted before request {rid} completed")
            return resp

    # ----------------------------------------------------------------- pump

    @property
    def pending(self) -> int:
        """Requests without a response yet (queued, in flight, or riding
        a coalesced twin's lane)."""
        return self._outstanding

    def _arbitrate(self) -> Optional[_LanePool]:
        if not self._pool_order:
            return None
        prio = np.array([p.best_priority(self._tickets)
                         for p in self._pool_order], dtype=np.float64)
        stamp = np.array([p.stamp for p in self._pool_order], dtype=np.int64)
        ops = np.array([p.queued + p.active for p in self._pool_order],
                       dtype=np.int64)
        idx = self._arb.select(prio, stamp, ops, prefer_older_ties=True)
        return None if idx is None else self._pool_order[idx]

    def step(self) -> bool:
        """One synchronous serving round: police deadlines, arbitrate a
        pool, admit at the chunk boundary, pump one megastep chunk,
        deliver responses, revisit capacity.  Returns False when no pool
        holds work.  The parity oracle for the concurrent lanes — raises
        if they are running (one pump per pool at a time)."""
        with self._lock:
            if self._running:
                raise RuntimeError("step() is the synchronous pump; the "
                                   "background lanes are running — use "
                                   "submit/result, or shutdown() first")
            now = self.clock()
            self._police_deadlines(now)
            pool = self._arbitrate()
            if pool is None:
                return False
            hint = self._resize_hint(pool)
            if hint is not None:
                self._apply_resize(pool, hint,
                                   self._warm_executable(pool, hint))
            self._ensure_exec(pool)
            self._admit(pool, now)
            if pool.active:
                pool.exec.pump(self.k_visits)
                self._deliver(pool, pool.exec.take_finished(), self.clock())
            if pool.queued == 0 and pool.active == 0:
                pool.stamp = _IDLE_STAMP
            else:
                # refresh: the just-served pool becomes the youngest, so
                # equal-priority pools rotate least-recently-served
                # instead of the oldest stamp monopolizing every tie
                pool.stamp = self.rounds
            self.rounds += 1
            return True

    def serve(self, max_rounds: Optional[int] = None
              ) -> Dict[int, GraphResponse]:
        """Synchronously pump until everything submitted so far has a
        response (or the round budget runs out); returns the response
        table."""
        start = self.rounds
        while self.pending and (max_rounds is None
                                or self.rounds - start < max_rounds):
            if not self.step():
                break
        return self.responses

    def serve_forever(self, arrivals: Optional[
            Iterator[Iterable[GraphRequest]]] = None, *,
            max_rounds: int = 100_000,
            drain_timeout: Optional[float] = None
            ) -> Dict[int, GraphResponse]:
        """Continuous serving: start the lanes, feed the arrival stream
        (an iterator of request batches — iterating it paces the open
        loop; submissions interleave with chunk execution on the pump
        threads), block until drained, then stop the lanes and return the
        response table.  With ``arrivals=None`` the lanes stay up and
        this blocks until ``shutdown()`` is called from another thread.
        ``max_rounds`` bounds total pumped chunks across all pools — a
        spent budget halts the lanes and returns what completed."""
        with self._lock:
            self._round_budget = self.rounds + int(max_rounds)
        self.start()
        try:
            if arrivals is None:
                with self._lock:
                    self._resp_cv.wait_for(lambda: not self._running)
                    self._raise_if_failed()
                return self.responses
            for batch in arrivals:
                self.submit_all(batch)
            self.wait_drained(timeout=drain_timeout)
        finally:
            with self._lock:
                self._round_budget = None
            if arrivals is not None:
                self.shutdown()
        return self.responses

    def poll(self, rid: int) -> Optional[GraphResponse]:
        """The response for ``rid``, or None while it is still in the
        queue/in flight."""
        return self.responses.get(rid)

    def stats(self) -> dict:
        """A serving snapshot: per-pool occupancy, both cache tiers, and
        the flat reuse counters — ``cache_*`` (result-cache hits, misses,
        evictions, resident bytes), ``coalesced``/``fanout`` (dedup
        totals) — so benchmarks and operators read one dict
        instead of poking server internals."""
        with self._lock:
            rc = (self.result_cache.stats() if self.result_cache is not None
                  else {"entries": 0, "bytes": 0, "budget_bytes": 0,
                        "hits": 0, "misses": 0, "evictions": 0,
                        "invalidations": 0})
            return {
                "running": self._running,
                "rounds": self.rounds,
                "outstanding": self._outstanding,
                "pools": {f"{p.graph}/{p.kind}": {
                    "capacity": p.capacity, "active": p.active,
                    "queued": p.queued, "fused": p.fused,
                    "visits": p.exec.visits if p.exec else 0,
                    "host_syncs": p.exec.host_syncs if p.exec else 0,
                    # across every resize (each chunk a host sync)
                    "visits_total": p.totals[0],
                    "host_syncs_total": p.totals[1],
                } for p in self._pool_order},
                "epochs": dict(self._epochs),
                "cache_hits": rc["hits"],
                "cache_misses": rc["misses"],
                "cache_evictions": rc["evictions"],
                "cache_bytes": rc["bytes"],
                "coalesced": self._coalesced_total,
                "fanout": self._fanout_total,
                "result_cache": rc,
                "compile_cache": self.cache.stats(),
                # alias: the reference's callers read the compile cache
                # under "cache" too
                "cache": self.cache.stats(),
            }
