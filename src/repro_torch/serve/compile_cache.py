"""Warm engine bundles for the serving layer.

The port of the JAX package's ``repro.serve.compile_cache``.  There a
streaming executor's first ``pump`` pays a trace and compile, and the cache
compiles the megastep ahead.  Eager PyTorch traces and compiles nothing:
what a cold executor pays here is the host build of its engine, the
``DeviceGraph`` with its numpy column lists staged onto the device (or,
for rw, the walk lists), charged to whichever request arrived first after
a pool was created or resized, inside the pool's pump lane.  This module
moves that build to ``register_graph`` time, and makes every later pool of
the same shape reuse it:

  * :func:`build_warm_megastep` builds the bundle a
    :class:`~repro_torch.fpp.streaming.StreamingExecutor` (or
    ``WalkExecutor``) would build for the same parameters: both sides call
    ``streaming.build_stream_bundle``, so the injected bundle and the
    would-have-been-built one are the same function of the same staged
    graph (``session.prepared`` caches one (BlockGraph, perm) per session
    and weight variant).
  * :class:`MegastepCache` keeps those bundles under ``(graph, kind, K,
    capacity, fused, alpha, eps, schedule, seed, k, length, walk_seed,
    session_uid)`` — the uid (:func:`session_uid`) pins a bundle to the
    session whose graph it staged, so a cache shared across servers never
    hands one graph's engine to another graph under the same name.
    Capacity is the raw lane count; the server snaps demand to pow2
    buckets (``planner.pow2_bucket``) before asking.

A bundle is read-only once built: an executor keeps its state, key and
lane arrays to itself, so one bundle may serve several executors at once
(two servers sharing a cache, or a pool and its resized successor).

Builds run outside the cache lock (a per-key in-flight event dedupes
concurrent builds of one key), so a background warm thread never blocks
admission.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict

from repro_torch.fpp.streaming import build_stream_bundle

_uid_lock = threading.Lock()
_uid_counter = itertools.count()


def session_uid(session) -> int:
    """A process-unique token for this session, minted on first use.

    A bundle holds the session's staged graph, so cache keys identify the
    *session*, not its registered name: two servers sharing a
    :class:`MegastepCache` may both call a different graph ``"default"``.
    A stored attribute rather than ``id(session)``: ids are recycled after
    garbage collection, a minted uid never is.
    """
    uid = getattr(session, "_megastep_cache_uid", None)
    if uid is None:
        with _uid_lock:
            uid = getattr(session, "_megastep_cache_uid", None)
            if uid is None:
                uid = next(_uid_counter)
                session._megastep_cache_uid = uid
    return uid


def warm_key(session, graph: str, kind: str, k_visits: int, capacity: int, *,
             fused: bool = False, alpha: float = 0.15, eps: float = 1e-4,
             schedule: str = "priority", seed: int = 0, k: int = 8,
             length: int = 32, walk_seed: int = 0) -> tuple:
    """The cache key: every parameter that reaches the built bundle, and
    the identity of the session whose graph it staged
    (:func:`session_uid`)."""
    return (str(graph), str(kind), int(k_visits), int(capacity),
            bool(fused), float(alpha), float(eps), str(schedule), int(seed),
            int(k), int(length), int(walk_seed), session_uid(session))


def build_warm_megastep(session, kind: str, capacity: int, *,
                        schedule: str = "priority", alpha: float = 0.15,
                        eps: float = 1e-4, seed: int = 0, k_visits: int = 64,
                        fused: bool = False, k: int = 8, length: int = 32,
                        walk_seed: int = 0):
    """Build the bundle a streaming executor of these parameters needs.

    A :class:`~repro_torch.fpp.streaming.StreamBundle` (the engine, with
    its ``DeviceGraph`` and column lists on the session's device, and the
    streaming megastep ``(state, counter, limit, key) -> (state,
    MegastepStats)``), or for ``kind="rw"`` a ``WalkBundle`` (the walk
    lists and the walk visit for ``length`` and ``walk_seed``).  Injected
    through ``StreamingExecutor(megastep=...)`` / ``WalkExecutor(visit=
    ...)`` (or ``session.stream(megastep=...)``) it replaces the build the
    executor would otherwise do.  Nothing is traced or compiled: the
    kernels are the prebuilt libraries of ``kernels/csrc``.
    """
    return build_stream_bundle(
        session, kind, int(capacity), schedule=schedule, alpha=alpha,
        eps=eps, seed=seed, k_visits=k_visits, fused=fused, k=k,
        length=length, walk_seed=walk_seed)


class MegastepCache:
    """Thread-safe LRU memo of warm engine bundles.

    ``get_or_build`` is the one entry point: a hit returns at once, a miss
    builds *outside* the lock while other keys stay available, and two
    threads racing on one key build once (the loser waits on the winner's
    in-flight event).  ``warm_async`` wraps it in a daemon thread for
    register-time prewarming that must not block registration.

    ``max_entries`` bounds the memo; every hit and peek refreshes recency,
    so what is dropped is the bundle nothing asked for longest
    (``evictions`` in ``stats()``).  ``compile_s`` keeps the reference's
    name for the seconds spent building.
    """

    def __init__(self, max_entries: int = 256):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self._lock = threading.Lock()
        self._cache: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._inflight: Dict[tuple, threading.Event] = {}
        self.max_entries = int(max_entries)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_s = 0.0      # total seconds spent building bundles

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def peek(self, key: tuple):
        """The bundle if already warm, else None; never builds.  A found
        key is refreshed: a peeked bundle is about to be injected."""
        with self._lock:
            exe = self._cache.get(key)
            if exe is not None:
                self._cache.move_to_end(key)
            return exe

    def get_or_build(self, session, graph: str, kind: str, capacity: int, *,
                     k_visits: int = 64, fused: bool = False,
                     alpha: float = 0.15, eps: float = 1e-4,
                     schedule: str = "priority", seed: int = 0,
                     k: int = 8, length: int = 32, walk_seed: int = 0):
        key = warm_key(session, graph, kind, k_visits, capacity, fused=fused,
                       alpha=alpha, eps=eps, schedule=schedule, seed=seed,
                       k=k, length=length, walk_seed=walk_seed)
        while True:
            with self._lock:
                if key in self._cache:
                    self.hits += 1
                    self._cache.move_to_end(key)
                    return self._cache[key]
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = ev = threading.Event()
                    self.misses += 1
                    building = True
                else:
                    building = False
            if not building:
                ev.wait()
                continue        # the winner published (or failed): re-check
            try:
                t0 = time.perf_counter()
                exe = build_warm_megastep(
                    session, kind, capacity, schedule=schedule, alpha=alpha,
                    eps=eps, seed=seed, k_visits=k_visits, fused=fused,
                    k=k, length=length, walk_seed=walk_seed)
                with self._lock:
                    self._cache[key] = exe
                    self._cache.move_to_end(key)
                    while len(self._cache) > self.max_entries:
                        self._cache.popitem(last=False)
                        self.evictions += 1
                    self.compile_s += time.perf_counter() - t0
                return exe
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                ev.set()

    def warm_async(self, session, graph: str, kind: str, capacity: int,
                   **params) -> threading.Thread:
        """Fire-and-forget prewarm; returns the (daemon) thread for callers
        that want to join it."""
        t = threading.Thread(
            target=self.get_or_build,
            args=(session, graph, kind, capacity), kwargs=params,
            name=f"warm-{graph}-{kind}-{capacity}", daemon=True)
        t.start()
        return t

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._cache), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "max_entries": self.max_entries,
                    "compile_s": round(self.compile_s, 3)}
