"""Training loop: restore -> step -> (async) checkpoint -> straggler watch.

The port of the JAX package's ``repro.train.loop``:

* restore on start from the newest intact checkpoint (CRC-verified); data
  is random-access by step, so a resumed run is bitwise the uninterrupted
  one;
* an async checkpoint every ``ckpt_every`` steps, and one at the end;
* straggler watch: a ring of step times; a step slower than
  ``straggler_factor`` times the ring's median fires ``on_straggler``
  (here it logs and counts);
* ``fault_hook(step)``, called before each step, may raise to simulate a
  node failure; a dying run still waits for its in-flight checkpoint.

A step's time runs until the card has finished it
(``torch.cuda.synchronize`` where the reference blocks on the loss).

On a mesh (``rules`` and the state's ``shardings``, the partition specs of
``train_step.state_shardings``) every rank runs the loop: each restores
its shards of the same checkpoint and checkpoints at the same steps, and
rank 0 writes (``checkpoint.AsyncCheckpointer(mesh=)``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import TrainState


@dataclasses.dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 32


@dataclasses.dataclass
class LoopStats:
    steps_run: int = 0
    restored_step: Optional[int] = None
    straggler_events: int = 0
    step_times: list = dataclasses.field(default_factory=list)
    history: list = dataclasses.field(default_factory=list)


def _block(metrics: dict) -> None:
    """Wait for the step's work: the card's, when it ran there."""
    loss = metrics["loss"]
    if loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)


def run_loop(train_step: Callable, state: TrainState, data_fn: Callable,
             cfg: LoopConfig, *, log: Callable = print,
             on_straggler: Callable = None,
             fault_hook: Callable = None, rules=None,
             shardings=None) -> tuple:
    """data_fn(step) -> batch.  Returns (state, LoopStats).  ``rules`` and
    ``shardings``: a state of shards on a mesh (module docstring)."""
    stats = LoopStats()
    mesh = rules.mesh if rules is not None else None
    ckpt = (ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, mesh=mesh)
            if cfg.ckpt_dir else None)
    start = 0
    if ckpt is not None and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
        state, start, _ = ckpt_lib.restore(cfg.ckpt_dir, target=state,
                                           shardings=shardings, rules=rules)
        stats.restored_step = start
        log(f"[loop] restored checkpoint at step {start}")
    ring = collections.deque(maxlen=cfg.straggler_window)
    save = None if ckpt is None else (
        lambda step, st: ckpt.save(step, st, specs=shardings))
    try:
        state = _step_loop(train_step, state, data_fn, cfg, stats, ring,
                           start, save, log, on_straggler, fault_hook)
    except BaseException:
        # a dying run must not abandon an in-flight async checkpoint: the
        # commit rename is what the restarted job restores from
        if ckpt is not None:
            try:
                ckpt.wait()
            except Exception:
                pass             # surface the original failure, not the writer's
        raise
    if ckpt is not None:
        ckpt.wait()
        save(cfg.n_steps, state)
        ckpt.wait()
    return state, stats


def _step_loop(train_step, state, data_fn, cfg, stats, ring, start, save,
               log, on_straggler, fault_hook):
    for step in range(start, cfg.n_steps):
        if fault_hook is not None:
            fault_hook(step)
        batch = data_fn(step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        _block(metrics)
        dt = time.perf_counter() - t0
        stats.step_times.append(dt)
        if len(ring) >= 8 and dt > cfg.straggler_factor * np.median(ring):
            stats.straggler_events += 1
            if on_straggler is not None:
                on_straggler(step, dt, float(np.median(ring)))
            else:
                log(f"[loop] straggler: step {step} took {dt:.3f}s "
                    f"(median {np.median(ring):.3f}s)")
        ring.append(dt)
        stats.steps_run += 1
        if step % cfg.log_every == 0 or step == cfg.n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            stats.history.append({"step": step, **m})
            log(f"[loop] step {step:5d} loss {m['loss']:.4f} "
                f"lr {m.get('lr', 0):.2e} {dt * 1e3:7.1f} ms")
        if save is not None and (step + 1) % cfg.ckpt_every == 0:
            save(step + 1, state)
    return state
