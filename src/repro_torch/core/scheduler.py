"""Inter-partition scheduling (paper §5.2), host side.

A numpy copy of the JAX package's ``repro.core.scheduler``.  The scheduler
selects which partition to visit next:

  priority   partition holding the globally best-priority pending op
             (shortest tentative distance / highest PPR residual)
  fifo       order buffers first became non-empty
  random     arbitrary non-empty buffer
  max_ops    most pending ops first

In the hot path selection is on the device (``core/visit.device_select``,
inside the K-visit megastep); this host implementation is the *oracle* the
device policies are held against and what ``FPPEngine.run(host_loop=True)``
calls.
"""
from __future__ import annotations

import numpy as np

POLICIES = ("priority", "fifo", "random", "max_ops")


class PartitionScheduler:
    def __init__(self, policy: str, num_parts: int, seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.policy = policy
        self.num_parts = num_parts
        self._rng = np.random.default_rng(seed)

    def select(self, prio: np.ndarray, stamp: np.ndarray,
               ops_count: np.ndarray) -> int | None:
        """prio: [P] float32, lower=more urgent, +inf empty.  stamp: [P]
        int32 visit counter at which the buffer last became non-empty
        (empty rows carry the int32-max-1 sentinel from core/visit.py).
        ops_count: [P] pending op count.  Returns the partition id, or None
        when every buffer is drained (run complete).

        Deterministic policies here and in ``core/visit.device_select``
        must agree bit-for-bit, first-index ties included."""
        nonempty = np.isfinite(prio)
        if not nonempty.any():
            return None
        if self.policy == "priority":
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
