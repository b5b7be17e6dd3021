"""Hot-source result cache: an LRU of *completed* result planes.

The port of the JAX package's ``repro.serve.result_cache`` (pure numpy,
no device).  Admission-time dedup coalesces identical **in-flight**
requests, but the workloads the paper motivates (NCP fires tens of
thousands of pprs whose source popularity is Zipf-skewed) repeat the same
hot sources long after the first answer finished.  This module is the
serving layer's answer-reuse tier: a byte-budgeted LRU of finished result
planes, keyed like the dedup window —

    (session_uid, epoch, kind, source, alpha, eps) + per-kind params

``session_uid`` (``serve/compile_cache.py``) pins an entry to the session
whose graph produced it, so a cache shared across servers never serves one
graph's plane for another graph under the same registered name; ``epoch``
is the staleness bound for dynamic graphs — ``GraphServer.update_graph``
bumps the registered name's epoch, so planes computed against the replaced
graph miss by construction even if the same session object is reused.

The byte budget comes from the planner's :class:`MemoryModel`:
``fpp/planner.result_cache_budget`` prices the default as a small multiple
of one query lane's HBM plane set, and ``GraphServer(cache_bytes=...)``
overrides it.  Per-entry accounting is exact (``values.nbytes`` plus the
residual plane when present); inserting past the budget evicts
least-recently-used entries, and an entry larger than the whole budget is
not cached — one giant plane must not flush every hot one.

Cached arrays are marked read-only: a hit hands out the *same* plane the
populating response carried (no copy), so a client mutating a response in
place fails loudly rather than poisoning every later hit.

``GraphServer.submit`` checks this cache **before** the dedup window, and
a hit is delivered through the ordinary delivery lane with ``cached:
True`` and zero billed visits, edges and host syncs.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Optional

import numpy as np


def result_key(session_uid: int, epoch: int, kind: str, source: int,
               alpha: float, eps: float, params: tuple = ()) -> tuple:
    """The cache key: the dedup key's identity fields with the graph name
    replaced by (session_uid, epoch) — value identity, not name identity.

    ``params`` carries the extra per-kind answer identity beyond
    (kind, source, alpha, eps): the kreach hop budget, the rw
    (length, seed) pair.  It is part of the tuple, so two kinds whose
    other fields collide (e.g. a cc and an sssp request on the same
    source) still key distinctly through ``kind`` itself."""
    return (int(session_uid), int(epoch), str(kind), int(source),
            float(alpha), float(eps)) + tuple(params)


@dataclasses.dataclass(frozen=True)
class CacheEntry:
    """One completed query's planes (original vertex ids, read-only)."""
    values: np.ndarray
    residual: Optional[np.ndarray]
    nbytes: int


def _freeze(arr: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if arr is not None:
        arr.setflags(write=False)
    return arr


class ResultCache:
    """Thread-safe byte-budgeted LRU of :class:`CacheEntry` planes.

    ``budget_bytes`` may start at 0 and grow later (``reserve`` is
    grow-only): a server derives the default budget per registered graph
    from the planner's memory model, and a cache shared across servers
    keeps the largest budget any of them asked for.  ``get`` refreshes
    recency; ``put`` inserts (or refreshes) and evicts LRU entries until
    the budget holds.  ``invalidate_session`` drops every entry a retired
    session produced — ``update_graph`` calls it so replaced graphs free
    their bytes eagerly instead of waiting for LRU churn (the epoch in the
    key already guarantees they could never be *served*).
    """

    def __init__(self, budget_bytes: int = 0):
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[tuple, CacheEntry]" = \
            collections.OrderedDict()
        self.budget_bytes = int(budget_bytes)
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def reserve(self, budget_bytes: int) -> int:
        """Grow the byte budget (never shrinks); returns the live budget."""
        with self._lock:
            self.budget_bytes = max(self.budget_bytes, int(budget_bytes))
            return self.budget_bytes

    # --------------------------------------------------------------- lookup

    def get(self, key: tuple) -> Optional[CacheEntry]:
        """The entry for ``key`` (refreshing its recency), or None."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    # --------------------------------------------------------------- insert

    def put(self, key: tuple, values: np.ndarray,
            residual: Optional[np.ndarray] = None) -> bool:
        """Cache one completed query's planes; returns True if it stuck.

        The entry's exact byte cost is charged against the budget; LRU
        entries are evicted until it fits.  An entry that cannot fit even
        an empty cache is refused (False) rather than allowed to evict
        everything hot.
        """
        nbytes = int(values.nbytes) + (0 if residual is None
                                       else int(residual.nbytes))
        with self._lock:
            if nbytes > self.budget_bytes:
                return False
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            while self.bytes + nbytes > self.budget_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self.bytes -= evicted.nbytes
                self.evictions += 1
            self._entries[key] = CacheEntry(
                values=_freeze(values), residual=_freeze(residual),
                nbytes=nbytes)
            self.bytes += nbytes
            return True

    # ----------------------------------------------------------- invalidate

    def invalidate_session(self, session_uid: int) -> int:
        """Drop every entry produced by ``session_uid``; returns the count.

        Epoch keying already makes stale entries unservable — this frees
        their bytes at ``update_graph`` time instead of via LRU pressure.
        """
        uid = int(session_uid)
        with self._lock:
            doomed = [k for k in self._entries if k[0] == uid]
            for k in doomed:
                self.bytes -= self._entries.pop(k).nbytes
            self.invalidations += len(doomed)
            return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self.bytes,
                    "budget_bytes": self.budget_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "invalidations": self.invalidations}
