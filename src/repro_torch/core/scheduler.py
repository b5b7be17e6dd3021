"""Inter-partition scheduling (paper §5.2), host side.

A numpy copy of the JAX package's ``repro.core.scheduler``.  The scheduler
selects which partition to visit next:

  priority   partition holding the globally best-priority pending op
             (shortest tentative distance / highest PPR residual)
  fifo       order buffers first became non-empty
  random     arbitrary non-empty buffer
  max_ops    most pending ops first

In the hot path selection is on the device (:func:`device_select`, inside
the K-visit megastep and the fused visit's plain version); the host
implementation is the *oracle* the device policies are held against and
what ``FPPEngine.run(host_loop=True)`` calls.

The same selector arbitrates one level up: ``serve/graph_server.py``
treats its per-(graph, kind) lane pools as "partitions" (pool priority is
the best queued or in-flight request priority, the stamp the round the
pool last became non-empty or was served, ops its backlog).  Serving
breaks priority ties toward the *oldest* pool; ``prefer_older_ties=True``
opts into that host-only refinement without touching the device-oracle
contract.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng

POLICIES = ("priority", "fifo", "random", "max_ops")
_INT32_MAX = np.iinfo(np.int32).max


class PartitionScheduler:
    def __init__(self, policy: str, num_parts: int, seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.policy = policy
        self.num_parts = num_parts
        self._rng = np.random.default_rng(seed)

    def select(self, prio: np.ndarray, stamp: np.ndarray,
               ops_count: np.ndarray, *,
               prefer_older_ties: bool = False) -> int | None:
        """prio: [P] float32, lower=more urgent, +inf empty.  stamp: [P]
        int32 visit counter at which the buffer last became non-empty
        (empty rows carry the int32-max-1 sentinel from core/visit.py).
        ops_count: [P] pending op count.  Returns the partition id, or None
        when every buffer is drained (run complete).

        Deterministic policies here and in :func:`device_select`
        must agree bit-for-bit, first-index ties included.

        ``prefer_older_ties`` (default off, so the device contract is
        untouched) refines the ``priority`` policy only: among rows tied
        at the best priority, pick the smallest stamp (the serving
        tie-break of ``GraphServer``'s pool arbitration)."""
        nonempty = np.isfinite(prio)
        if not nonempty.any():
            return None
        if self.policy == "priority":
            if prefer_older_ties:
                ties = prio == prio[int(np.argmin(prio))]
                masked = np.where(ties, stamp, np.iinfo(np.int64).max)
                return int(np.argmin(masked))
            return int(np.argmin(prio))
        if self.policy == "fifo":
            masked = np.where(nonempty, stamp, np.iinfo(np.int32).max)
            return int(np.argmin(masked))
        if self.policy == "max_ops":
            masked = np.where(nonempty, ops_count, -1)
            return int(np.argmax(masked))
        # random
        choices = np.flatnonzero(nonempty)
        return int(self._rng.choice(choices))


def device_select(policy: str, prio: torch.Tensor, stamp: torch.Tensor,
                  ops_count: torch.Tensor,
                  key: torch.Tensor | None = None) -> torch.Tensor:
    """On-device mirror of ``PartitionScheduler.select`` (the host oracle).

    Takes the ``[P]`` metadata (no trash slot) and returns the selected
    partition as a ``[1]`` int64 tensor.  The caller guarantees at least one
    finite-priority partition.  The deterministic policies reproduce the
    host argmin/argmax bit for bit, first-index tie-breaking included;
    ``random`` draws a uniform per partition under the threefry ``key``
    (``core/prng``, the caller's sub-key) and takes the first argmax over
    the non-empty ones, as the reference does.  The host scheduler's numpy
    stream differs, but scheduling never changes results.
    """
    if policy == "priority":
        return torch.argmin(prio).view(1)
    nonempty = torch.isfinite(prio)
    if policy == "fifo":
        return torch.argmin(torch.where(nonempty, stamp, _INT32_MAX)).view(1)
    if policy == "max_ops":
        return torch.argmax(torch.where(nonempty, ops_count, -1)).view(1)
    if policy == "random":
        if key is None:
            raise ValueError("the random policy draws from a threefry key; "
                             "pass key=")
        u = prng.uniform(key, tuple(prio.shape))
        return torch.argmax(torch.where(nonempty, u, -1.0)).view(1)
    raise ValueError(f"unknown scheduling policy {policy!r}")
