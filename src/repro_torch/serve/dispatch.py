"""Concurrent serving lanes: pump workers and the delivery lane.

The port of the JAX package's ``repro.serve.dispatch``.  The
continuous-batching :class:`~repro_torch.serve.graph_server.GraphServer`
splits serving into three lanes:

  * **admission** — caller threads in ``GraphServer.submit`` (backlog,
    dedup, fair-queueing bookkeeping; never touches an executor);
  * **pumping** — one :class:`PoolWorker` thread per lane pool, building
    the pool's executor when it has none, then driving
    ``StreamingExecutor.pump`` chunk after chunk and refilling lanes at
    every chunk boundary;
  * **delivery** — one :class:`DeliveryWorker` turning finished lanes into
    ``GraphResponse``\\ s and waking blocked ``result()`` callers.

This module owns the two background lanes; the server owns all shared
state and its one lock.  Every structure has exactly one lock: server-side
state (backlogs, tickets, virtual times, responses) is guarded by the
server lock, executor state by the executor's own lock, acquired strictly
after the server lock and never the other way around.  A worker admits
under the server lock, then pumps — and builds — *outside* it (the
executor lock serialises the chunk), so a chunk in flight never blocks
submissions.

On the card a worker first enters its pool's device (PyTorch's current
device is per thread).  Every lane launches on that device's default
stream, so launches of different pools serialise on the card; the lanes
overlap only their host work.  ``GraphServer.start`` loads the kernels'
libraries (:func:`load_kernels`) before any worker runs, so no two lanes
race to load one.  A worker that raises hands the error to the server
(``GraphServer._fail``), which halts every lane; callers waiting in
``result`` or ``wait_drained`` then raise it.
"""
from __future__ import annotations

import contextlib
import queue
import threading

import torch


def load_kernels() -> None:
    """Load (building if needed) the library of every kernel a graph lane
    may launch: the list contractions (unfused pools), the fused visit
    and the threefry stream (rw pools)."""
    from repro_torch.kernels.fused_visit import ops as fused_ops
    from repro_torch.kernels.minplus import ops as minplus_ops
    from repro_torch.kernels.threefry import ops as threefry_ops
    for ops in (minplus_ops, fused_ops, threefry_ops):
        ops.load()


def _device_scope(device: torch.device):
    """The pool's CUDA device as this thread's current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class PoolWorker(threading.Thread):
    """The pump lane for one (graph, kind) pool.

    Per iteration, under the server lock: police deadlines, take a resize
    hint (idle pools only; with nothing queued the pool just drops its
    executor), admit queued requests into free lanes.  Then *outside* the
    lock: either fetch a bundle through the warm cache (for a resize, or
    for a pool that has no executor yet) and apply it, or pump one
    megastep chunk and hand finished lanes to the delivery queue.
    Idle pools park on their condition variable (woken by ``submit``) with
    a short timeout so deadline policing and shutdown are still observed.
    """

    def __init__(self, server, pool):
        super().__init__(name=f"pump-{pool.graph}-{pool.kind}", daemon=True)
        self.server = server
        self.pool = pool

    def run(self):
        try:
            with _device_scope(self.pool.session.device):
                self._loop()
        except BaseException as exc:
            # handed to the callers waiting in result()/wait_drained();
            # an interrupt or exit propagates here as well
            self.server._fail(exc)
            if not isinstance(exc, Exception):
                raise

    def _loop(self):
        srv, pool = self.server, self.pool
        while True:
            with srv._lock:
                if not srv._running or pool.retired:
                    # retired: update_graph replaced this pool's graph —
                    # the pool was drained by contract, so exiting loses
                    # nothing; fresh pools get fresh workers
                    return
                now = srv.clock()
                srv._police_pool(pool, now)
                target = srv._resize_hint(pool)
                if target is not None and not pool.queued:
                    # nothing to serve at the new size yet: drop the
                    # executor, build when requests arrive
                    srv._apply_resize(pool, target, None)
                    target = None
                if target is None:
                    if pool.exec is None:
                        if not pool.queued:
                            pool.cv.wait(timeout=srv.idle_wait_s)
                            continue
                        target = pool.capacity      # build, don't resize
                    else:
                        srv._admit(pool, now)
                        if not pool.active:
                            pool.cv.wait(timeout=srv.idle_wait_s)
                            continue
                        if not srv._take_round():
                            return
            if target is not None:
                # build outside the lock: a cache miss (the DeviceGraph
                # and its column lists) must not stall other pools
                exe = srv._warm_executable(pool, target)
                with srv._lock:
                    if srv._running and not pool.retired and not pool.active:
                        if pool.capacity != target:
                            srv._apply_resize(pool, target, exe)
                        elif pool.exec is None:
                            pool.build(exe)
                continue
            pool.exec.pump(srv.k_visits)
            done = pool.exec.take_finished()
            if done:
                srv._queue_delivery(pool, done)


class DeliveryWorker(threading.Thread):
    """The delivery lane: a queue of (pool, finished qids) batches from
    the pump workers, turned into responses under the server lock.

    Decoupling delivery from pumping means a pool's next chunk dispatches
    while the previous chunk's answers are still being built and fanned
    out.  ``stop()`` enqueues a sentinel; the server joins pump workers
    first, so every delivery batch precedes the sentinel and none is
    dropped.
    """

    def __init__(self, server):
        super().__init__(name="serve-delivery", daemon=True)
        self.server = server
        self.q: queue.Queue = queue.Queue()

    def put(self, pool, qids):
        self.q.put(("lanes", pool, list(qids)))

    def put_cached(self, rid, entry):
        """Queue one result-cache hit: same delivery lane, same
        ``result()``/``poll()`` wake-up path as a lane-computed answer —
        a cached response is distinguishable only by its stats."""
        self.q.put(("cached", rid, entry))

    def stop(self):
        self.q.put(None)

    def run(self):
        srv = self.server
        try:
            while True:
                item = self.q.get()
                if item is None:
                    return
                tag, a, b = item
                with srv._lock:
                    if tag == "cached":
                        srv._finish_cached(a, b, srv.clock())
                    else:
                        srv._deliver(a, b, srv.clock())
        except BaseException as exc:
            srv._fail(exc)
            if not isinstance(exc, Exception):
                raise
